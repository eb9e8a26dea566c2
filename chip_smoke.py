#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmvid_tpu_torch``) on one GPU.

Drives the port's three sampling paths at full width on weights drawn from
a seed: flagship text-to-video mask-predict sampling (768 x 12-layer
backbone, 20 rounds, VQGAN decode of 8 frames at 128 px) through
``factories.flagship`` and ``generate.generate_videos``; the text+mask
visual-control recipe (scripts/mmvoxceleb/text_and_mask/test.sh: one
control frame through the cvae encoder and the nearest-code kernel, the
mask_8x8 erase, sequence 629) through ``factories.get_vae_model`` /
``get_dalle`` and ``MMVIDBert.generate_images``, with the fused LN+QKV
gate off and then on; and ART-V, the autoregressive sampler (the same
backbone from the text-to-video flags with ``--ar``: a prefill of the
115-position control prefix, then 511 KV-cached decode steps), through
``generate.generate_videos``, on the card's default path (the whole-step
decode kernel) and then with ``MMVID_ARTV_FUSED=0`` (the per-layer step);
then ART-V's exact speculative decode (``MMVID_ARTV_SPEC=8``) with a
control frame through the cvae; then int8 serving: the flagship calibrated by
``ops.int8.quantize_for_serving`` (w8a8 backbone and VQGAN decoder) under
``MMVID_ATTN_INT8=1`` (the int8 attention kernel), and ART-V's int8 decode
(``generate_images(int8=True)``); then training: the flagship
text-to-video recipe's MSM / REL / VID step at full width (fp32
parameters, bf16 compute, each block rematerialised, the frozen VQGAN
tokenizing targets and the warped frame inside the step) and one ART-V
step; then evaluation (FVD / PRD through ``eval.evaluate.evaluate`` at
batch 16 with a random I3D); then the recipes' drivers, ``python -m
mmvid_tpu_torch.train`` and ``.test`` through ``main_worker`` on the
released scripts' flags, over synthetic PNG clips: training, sampling,
the long-video modes, the PNAG debug grids, the shapes evaluation,
``evaluation.sh``'s FVD / PRD, and a full-size ViT-B/32-shaped CLIP
archive grafted into a training run and scoring through ``--eval_metric
clip``; and VQGAN finetuning, ``python -m mmvid_tpu_torch.train_vqgan``
through its ``main`` at full width.
The paths' models, inputs and batch-16 timings come from
``mmvid_tpu_torch.breakdown`` (``build``, ``inputs``, ``measure``,
``build_train``, ``train_batch``, ``measure_train``).
Phases, in order; any failure exits non-zero and prints no result line:

1. device: CUDA is required; prints the card's name and power limit.
2. build: compiles ``mmvid_tpu_torch/csrc`` with nvcc (sm_90a), one nvcc
   per source in parallel.
3. attention kernels vs their plain version, ``MMVID_ATTN_BF16`` off and
   on: fp32 (``csrc/attention_fp32_sm90.cu`` on the CUDA cores, TF32
   off) and bf16 (the tensor-core kernel) at each path's sequence and
   mask_prev rows: text+mask (L 629), flagship (L 565), tiny (L 139); both
   on q, k, v as packed strided views with mask_prev and causal masks, D
   64 and 32, and the share of bf16 outputs that differ from plain; times
   beside ``F.scaled_dot_product_attention`` with the same float mask on
   the packed views at L 629 and L 565, bf16 and fp32 (the released
   recipes' precision) each with its bound; the fp32 route at the CLIP
   scorer's shapes (B16 D64: L 50 H12 without a mask, L 77 H8 causal)
   against its plain version, timed beside SDPA in fp32.
   Then the int8 attention kernel (``MMVID_ATTN_INT8=1``) vs its plain
   version at L 565 and 629, B16 H12 D64 bf16 on the packed views, given
   the mask with its compact form as the models give it (the compact
   form equal to the dense mask): outputs differing, and by how many
   quantization steps; two calls bitwise equal, and equal to a call with
   the fp32 mask alone; two launches a call; timed with the compact mask
   and with the fp32 mask, beside its plain version (and SDPA's bf16
   time, as context only).
   Then attention's backward kernels (bf16 on wgmma, fp32 on wgmma in
   split TF32; ``FusedAttention``: the forward kernel with its row
   statistics, then the backward kernels) at B16 H12 D64, L 565 and 629
   mask_prev and causal, L 626 causal, L 516, B48 L 565 bf16 and the tiny
   D32, on the packed views, given the models' mask with its compact form
   (which the fp32 kernel reads): through autograd against the plain
   version, the kernels alone against ``attention_backward``
   (ATTN_BWD_TOL), two calls bitwise equal and equal to a call given the
   fp32 mask alone; timed beside the plain version and, at L 565 / 629
   and B48, ``F.scaled_dot_product_attention``'s forward and backward in
   the same dtype; with ``MMVID_BWD_OLD_SOURCE`` naming PR 20's two
   backward sources, those kernels in turns with the routes.
4. sample-head kernels vs their plain version: exact at temp 0 for Y
   given the chosen token (bf16 W and a genuinely fp32 W), token
   histograms in distribution (TV bounds); at temp 1 every route against
   the plain version fed the kernels' own noise (``philox_gumbel`` at
   one seed): bf16 W on the tensor cores and the CUDA cores, fp32 W on
   the split-TF32 route and the CUDA cores, each route against the other
   at one W, each tolerance against a control it must refuse (bf16
   logits; one TF32 pass); timed in turns per W, the fp32 route beside
   ``F.layer_norm`` + ``F.linear`` in fp32, its plain version and bound.
5. nearest-code kernel vs its plain version at M 512, 1024, 4096 and 8192
   (D 256, K 1024): ids equal on a randn codebook; within 1e-5 of the
   best score on the random-init codebook; kernel, plain and bound times
   at each M.
6. fused LN+QKV kernel vs its plain version at the text+mask and
   flagship shapes (M 16 x 629 and 16 x 565), bf16 (the kernel's only
   dtype; fp32 must raise on the card), timed beside the gate-off pair
   ``F.layer_norm`` + ``F.linear``.
7. ART-V decode-step kernels vs their plain version: both bf16 kernels
   (the phased one, the route, and the streaming one, forced) at full
   width (12 layers, W 626) at B 1, 5 and 64 (pos 0 and 1) beside the
   plain version's own move under a one-ulp move of x, and at B 16 (pos
   115, 370 and 625), cache rows >= pos NaN, two calls bitwise equal,
   timed in turns, and at B 64 timed; the streaming kernel's flags across
   layouts; fp32 and bf16 at a small shape; times and bounds per pos; the
   wrapper's host time a call.
8. grid-step probe vs its plain version: 64 chained calls at 1, 12 and
   192 launches a call, and the cost of one launch.
9. tiny models on the card vs the same weights on the CPU: the flagship,
   the text+mask model's cvae ids and forward logits, and ART-V's greedy
   tokens, each device on its default decode path; under the
   deterministic hook, a preserved ``interp`` call and the PNAG trace
   (``mask_predict_trace``): tokens and keep masks equal, the preserved
   slots holding their source; then ART-V's exact
   speculative decode on the card: greedy tokens equal to ``ar_sample``'s
   (decode kernel and per-layer step) at k 1, 4 and 8, forced
   acceptance's chunk counts, and the sampled distribution against the
   baseline's (chi^2 and TV, 800 lanes, CUDA generators); then the tiny
   training builds (flagship 3 steps, ART-V 1) on the card and on the CPU
   from the same weights, batch and draws, TF32 off: ids, losses and
   parameters agree, launch counts a step exact (the attention backward
   kernels once a backward call), the backward kernels on each step's
   own inputs against their plain version.
10. flagship path: 6 prompts at batch 4, launch counts, output checks,
    determinism by seed; then ``breakdown.measure`` of a batch of 16;
    then the flagship in fp32, the released recipes' precision: one batch
    of 16 after a warm-up (launch counts exact: the fp32 attention route
    240, the sample head's split-TF32 route 40, two a call), frames/s,
    and the attention kernel's share of the device time of a profiled
    batch.
11. text+mask path: one batch of 16, launch counts, output checks,
    determinism by seed, then ``breakdown.measure``; then again with
    MMVID_FUSED_LNQKV=1 (launch counts, tokens against the gate-off run,
    ``breakdown.measure``).
12. ART-V path: the 16 prompts in one batch on the card's default path
    (511 decode-kernel launches), then with MMVID_ARTV_FUSED=0 (no
    launch): output checks for each, determinism by seed on the default
    path, the host's time a token, the tokens that differ between the
    two, ``breakdown.measure``
    for each (one timed call of each for the per-layer path, seconds a
    batch).
13. ART-V's speculative decode at full width (MMVID_ARTV_SPEC=8, one
    control frame through the cvae and the nearest-code kernel): a greedy
    batch (launch counts, output checks, tokens a chunk), then
    ``breakdown.measure`` of the floor (determinism by seed) and of the
    forced ceiling, and the share of the greedy tokens equal to the
    per-layer baseline's (reported).
14. int8 serving, the flagship at full width: bf16 logits of one forward,
    then ``quantize_for_serving`` under MMVID_ATTN_INT8=1 and the JAX
    package's gates (logits cosine > 0.99, argmax agreement > 0.9; the
    decoder's int32 sums exact at every site, and each site alone within
    mean |d| < 0.02, max < 0.2; the whole decoder reported, see
    ``_int8_decoder_checks``); a batch of
    16 at 20 rounds: launch counts (int8 attention 480, two a call:
    the operand pass and the attention; sample head 20; the bf16
    attention kernel 0), output checks, determinism by seed,
    ``breakdown.measure``.
15. ART-V int8 at full width: a warm-up batch of 16 and one timed, output
    checks, the same tokens on one seed, no kernel launched.
16. training at full width, batch 16: the flagship's step through
    ``breakdown.measure_train`` (every loss finite; launches a step
    exact: attention 72, nearest code 2, and 36 calls of attention's
    backward, each one launch of its kernels, held against their plain
    version on the step's own inputs; the VQGAN unchanged), then 8 steps
    on a fixed batch with fixed draws at a constant lr (the loss falls);
    then one ART-V step (attention 12, nearest code 1, backward 12).
17. evaluation at full width: the flagship (bf16, 20 rounds) at batch
    16 through ``eval.evaluate.evaluate`` over 64 samples, random I3D
    (MMVID_ALLOW_RANDOM_I3D=1): launch counts exact, embeddings finite,
    FVD of a set against itself about 0, I3D on the card against the CPU
    on one clip (TF32 off; with TF32 reported); then
    ``bench_eval.measure_eval``: samples/s, the 2048-sample
    extrapolation, generation and ping-pong + I3D ms a batch, peak
    memory, I3D's ms a batch with and without TF32.
18. the training driver (``mmvid_tpu_torch.train.main_worker``) on
    ``text_to_video/train.sh``'s flags (``--bf16``, batch 48, 6
    iterations, checkpoints and grids every 3) over a synthetic tree of
    128 px PNG clips written by the port's writer through every filter
    type, a random VQGAN checkpoint as ``--vae_path``; ``--auto_resume``
    to 8 under the profiler; 3 steps of ``text_and_mask/train.sh``'s
    flags (vox, a cvae): finite losses, the resumed start, the VQGAN
    unchanged, the files written, attention's backward calls and kernel
    launches exact (the kernels on the run's own inputs against their
    plain version), the kernels launched; step ms, loader wait, idle
    share, save seconds and bytes, peak memory.  Then data parallelism
    (``mmvid_tpu_torch/parallel/``): the same training flags over NCCL
    at world size 1 (``--multiprocessing_distributed``'s rank in this
    process for iterations 0-2, resumed for 3 under the profiler, then
    resumed for 4 through the driver's own spawn), each iteration's
    metrics equal to the one-device run's, bit for bit; both steps' ms,
    peak memory, NCCL's device time in the profiled iteration.  Then two
    ranks pinned to the one card over gloo (asked for: NCCL refuses two
    ranks on a device): the flagship's training step at global batch 48,
    24 a rank, against the one-rank step at 48 on the same weights and
    generator, in fp32 (TF32 off) and in bf16 compute, within
    ``DDP_TOL`` at step 1 (the loss and its terms, grad_norm, the reduced
    gradient normwise); the ranks' parameters bit-identical after 3
    steps; the planted naive DDP (per-rank means averaged) out of the
    fp32 tolerance; each rank's launches those of 3 training steps (B1
    72, B3 2, B1-bwd 36 a step) and its captured backward held against
    the plain version at batch 24.  (``phase_train_ddp_cards``, which
    needs several cards and is not run here, takes the driver over NCCL
    on every visible card against one card.)  Then tensor parallelism at
    tp = 2 on the same card: the training step over two gloo ranks
    (``phase_train_tp_gloo``) and the driver's launcher path
    (``phase_train_driver_tp``).  Before each spawn ``free_card_memory``
    fails if another process holds the card or a loader thread of an
    earlier run is still alive.
19. the test driver (``mmvid_tpu_torch.test.main_worker``) on
    ``text_to_video/test.sh``'s flags, sampling the training run's latest
    checkpoint: videos finite in [0, 1], the grid written, the kernels
    launched; frames/s.  Then ``--eval_mode long`` on the same flags at
    batch 16, once a mode (``LONG_MODES``: ``long`` at t_repeat 3 and
    t_overlap 1 with ``--save_codebook``, 22 frames; ``interp`` at
    t_repeat 3, 32; ``interp_real`` at t_repeat 2, 15): videos finite in
    [0, 1] of those frames, ``long_{i}.png`` a sample,
    ``codebook_long.npy`` [16, 22 * 64], every preserved slot equal to
    its source, the kernels launched; frames/s and peak memory a mode.
    Then ``--debug`` with ``--n_sample 16``: the PNAG trace of the batch
    (each round's frames decoded alone), a step grid a sample, the keep
    counts on the schedule, peak memory.  Then the shapes evaluation: a
    ``shape_attr`` folder of 128 px clips, a full-width model with 3
    visual controls and a cvae saved as ``dalle.pt``, ``--dataset
    shape_attr --negvc --test_mode shapes``: a grid row a control slot,
    the kernels launched (nearest code through the cvae).  Then on
    ``text_to_video/evaluation.sh``'s flags
    (``--eval_num 64``, random I3D): every artifact written, FVD finite,
    the embeddings [64, 400], the kernels launched.
20. CLIP: a ViT-B/32-shaped torch.jit archive traced from the port's
    ``models/clip_full.py`` on random weights; the training driver on
    ``train.sh``'s flags with ``--openai_clip_model_path`` at it, one
    step (the backbone grafted equal to the archive's resblocks, a finite
    loss); the test driver with ``--eval_metric clip`` over 32 samples
    (``clip_score.txt``, the score in [-1, 1], attention launched).

21. the fixed language model: a synthetic roberta-large folder (the
    published shapes, N(0, 0.02) weights, a ``RobertaForMaskedLM``
    ``pytorch_model.bin``, a BPE vocabulary learned on the recipe's
    captions) through ``factories.get_fixed_language_model`` on the card
    and on the CPU: the features of 4 captions within ``ROBERTA_TOL``;
    ``encode``'s ms at batch 24 and 16, peak memory.
22. the text_augment recipe (``--fixed_language_model roberta-large``):
    ``train.sh``'s flags for 3 steps in fp32 at batch 24, ``ROBERTA_PATH``
    at that folder (finite losses, the LM once a step, attention's
    backward calls exact, the kernels launched; step ms, the LM's ms a
    step, peak memory), then ``test.sh``'s flags on the run with
    ``--description "A girl."`` (videos finite in [0, 1], the grid
    written, the LM once, attention and the sample head launched;
    frames/s).
23. VQGAN finetuning (``mmvid_tpu_torch.train_vqgan``): the tiny trainer
    (32 px) from one seed on the card and on the CPU, one g step and one
    d step each on camera-like frames and on uniform noise, every metric
    and gradient within ``VQGAN_METRIC_TOL`` / ``VQGAN_GRAD_TOL`` of the
    CPU's, TF32 off, and the control with TF32 on
    (``vqgan_tiny_tf32_control``); then the driver's ``main``
    at full width (``VQGanConfig()`` at 128 px, batch 8, fp32, LPIPS on
    seeded random VGG16 weights, ``NLayerDiscriminator(64, 3)``) over
    synthetic 128 px PNGs, 8 iterations, a save every 4: every metric
    finite, the nearest-code kernel launched exactly twice an iteration
    (M 512), the checkpoint read back by ``factories.taming_vqgan_state``
    into ``get_vae_model``'s VQGAN, encoding and decoding a batch; s an
    iteration, images/s, peak memory, and one profiled iteration's device
    time by kind and idle share, on a ``[vqgan train] path`` JSON line of
    their own.

Prints each phase's wall time (``[time]`` lines), the kernels' JSON line,
then as its last line ``{"ok": true, "device": {...}}``.  Run from the
repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

# TV-distance bounds for 65536 samples (expected TV under a correct
# sampler is about 0.02 one-sample and 0.03 two-sample for the peaked
# distribution below; a kernel that drops or reuses its noise moves most
# of the mass onto one token, TV > 0.5).
TV_EXACT_BOUND = 0.05
TV_TWO_SAMPLE_BOUND = 0.07
# attention kernels vs plain, max abs error, by (dtype, MMVID_ATTN_BF16):
# fp32 sums in another order; bf16 outputs rounded from fp32 sums in
# another order (online softmax), up to 2 bf16 ulps at |out| ~ 2; fp32
# with bf16 probabilities: the kernel rounds exp(logit - running max), the
# plain version exp(logit - row max), so a term moves by up to 2^-9 of
# itself
ATTN_TOL = {('float32', False): 1e-4, ('float32', True): 4e-3,
            ('bfloat16', False): 2e-2, ('bfloat16', True): 2e-2}
# the fp32 kernel's query tiles, in rows a thread (the tile is 16 x that):
# csrc/attention_fp32_sm90.cu's kTileRows, of which the route takes one by
# shape (ops/attention.py::fp32_tile_rows)
FP32_TILE_ROWS = (8, 6, 4)
# share of bf16 outputs of the default route (P_hi + P_lo) that may differ
# from the plain version's (about 0.2% expected; bf16 probabilities move
# about 40%)
ATTN_DIFFER_MAX = 0.02
# kernel Y vs the plain softmax probability of the kernel's token.  With a
# bf16 W the LN output is rounded to bf16 before the product; the kernel's
# and the plain LN statistics differ in the last fp32 bit, which flips the
# rounding of a few elements and moves a logit by ~1e-3.
Y_TOL = {'float32': 1e-5, 'bfloat16': 2e-3}
# a sample-head kernel vs the plain version fed the same Philox noise at
# temp 1: tokens equal on this share of rows at least (the logits' fp32
# sums run in another order, so near-ties may flip), and Y within this
# relative error on equal rows: the LN output's bf16 roundings flip on
# last-bit differences of the statistics (Y_TOL's reason), which moves a
# logit, so noised[tok] and the logsumexp, by ~1e-3.  At M8192 on the H100
# the tensor-core kernel read 2.535e-3 and the CUDA-core kernel 1.588e-3
# in one run, and the control, the plain version with its logits rounded
# to bf16, 4.420e-2; the bound lies between them
HEAD_TOKEN_SHARE = 0.999
HEAD_Y_REL_TOL = 4e-3
# the same for fp32 W on the split-TF32 route: no bf16 rounding, so only
# the fp32 sums in another order, the tensor cores' truncated sums and the
# split's 2^-22 move a logit.  At M8192 on the H100 the route read 1.437e-5
# (the CUDA-core kernel 6.716e-6), and the control, the plain version with
# h and W each rounded once to TF32 (one TF32 pass), 3.843e-3; the bound
# lies between them
HEAD_Y_REL_TOL_FP32 = 1e-4
# the sample head's launches a call on the split-TF32 route, the fp32
# paths' (the logits, then the sampling); one on every other route
TF32_HEAD_LAUNCHES = 2
# fused LN+QKV kernel (bf16) vs plain: |kernel - plain| <= tol * (1 +
# |plain|) elementwise (rtol = atol = tol, the CPU tests' form): h and the
# output are rounded to bf16, and a last-bit difference of the LN
# statistics can flip one rounding, one bf16 ulp (2^-8 relative; 0.03125
# at |qkv| in [4, 8))
LNQKV_TOL = 2e-2
# chosen code's score within this of the best (fp64) on the random-init
# codebook U(-1/1024, 1/1024), whose scores differ by ~1e-5 between codes
CODE_GAP_TOL = 1e-5
# the latent rows phase_codebook checks the nearest-code kernel at
CODEBOOK_ROWS = (192, 512, 1024, 4096, 6144, 8192)
# ART-V decode step vs plain: fp32 max abs (sums in another order); bf16
# y within tol * (1 + |plain|), k_new and v_new within one bf16 ulp of
# max(|plain|, 1): the kernel rounds h, the probabilities and the MLP
# activations at the plain version's places, and a last-bit difference of
# an fp32 sum flips one rounding, which moves later values by about 1e-4
DECODE_TOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# bf16 through 12 random blocks: such flips grow, and moving x by one fp32
# ulp alone moves the plain version's own y and k, v about as far as the
# kernels' whole step differs from it (phase_artv_decode prints both), so
# the whole step is held within this * (1 + |plain|) and each block (fed
# the plain version's input) within DECODE_TOL.  On the H100, at this
# script's seeds, the plain version's own move read up to 4.261e-2 at B <=
# 16 and 4.483e-2 at B 64, both kernels' whole step up to 4.497e-2 and
# 4.655e-2; at tests/test_torch_kernels.py's B 64, pos 0 case the
# streaming kernel's went beyond 5e-2.  So B 64 (the max over four times
# the rows) is held at half as much again
DECODE_DEEP_TOL = 5e-2
DECODE_DEEP_TOL_B64 = 7.5e-2
# grid-step probe vs plain, fp32 outputs of bf16 products summed in
# another order
PROBE_TOL = 1e-4
# attention's backward (FusedAttention: the forward kernel, then the
# backward kernels) vs autograd through attention_reference on the same
# packed views, and the backward kernels vs attention_backward:
# |got - want| <= tol * (1 + |want|) elementwise.  Both compute the same
# fp32 function in another order; bf16 gradients are rounded from it, so a
# last-bit difference can flip one rounding (one bf16 ulp, 2^-8
# relative).  On the H100 at this script's shapes and seeds, the kernels:
# at most 2.7e-6 in fp32, 5.1e-3 in bf16 (a flip at |x| in [2, 4)); the
# training runs' captured calls, their cotangents at unit RMS, 3.5e-5
# (text_augment's fp32 step) and 6.2e-3 (the driver's, which vary from
# run to run)
ATTN_BWD_TOL = {'float32': 1e-4, 'bfloat16': 1e-2}
# attention's backward kernels vs attention_backward, normwise: for each
# of dq, dk, dv, ||got - want|| / ||want|| within this, beside
# ATTN_BWD_TOL's elementwise check (which is absolute where |want| is
# small, and in bf16 allows a quarter of a typical |dq| at B16 L565).
# Rounding the same fp32 value to bf16 twice differs by at most one ulp,
# 2^-7 of |x|, on the elements where a last-bit difference flips it; a
# systematic error of a percent or more is beyond this limit
# (phase_attention_backward's planted faults must fail the two checks).  On the
# H100 at this script's shapes and seeds, the training runs' captured
# calls included: at most 2.7e-6 in fp32 (text_augment's step), 2.6e-4
# in bf16; the fault dq 2^-6 too large reads 1.55e-2
ATTN_BWD_NORM_TOL = {'float32': 1e-5, 'bfloat16': 2e-3}
# the tiny fp32 training steps on the card vs the CPU, TF32 off: every
# parameter within this after 3 Adam steps, except the key projection's
# bias, whose gradient is exactly 0 (softmax cancels a constant added to
# a query's logits): Adam moves it by up to the lr a step on each
# device's own rounding noise, so it is held to 3 x the lr summed over the
# steps (tests/test_torch_training.py::_hold_params).  On the H100: the
# flagship's parameters 2.2e-6 apart after 3 steps, ART-V's 5.2e-6 after
# one, the key biases 8.7e-5, the losses at most 9.5e-7
TRAIN_PARAM_TOL = 1e-5
TRAIN_LOSS_TOL = 1e-4
# the full-width step's launches: 3 forwards (MSM, REL's negative, VID's
# negative) x 12 blocks, each forward run again under remat; the nearest
# code twice (the 8 target frames, M = B * 512, and the warped frame, M = B
# * 64); ART-V: one causal forward of 12 blocks, no remat, and the targets
# tokenized once
TRAIN_LAUNCHES = {'train': {'attention': 72, 'codebook': 2},
                  'train_artv': {'attention': 12, 'codebook': 1}}
# attention's backward (FusedAttention.backward) a step: once for each
# block of each forward (remat reruns the forward, not the backward)
TRAIN_BACKWARD_CALLS = {'train': 3 * 12, 'train_artv': 12}
# steps on one fixed batch with fixed draws at a constant lr, over which
# the full-width loss must fall
FALL_STEPS = 8
# the CLIP scorer's attention (models/clip_full.py, fp32): ViT-B/32's
# visual tower (L 50, 12 heads, no mask) and text tower (L 77, 8 heads,
# causal), D 64, at the eval's 16 frames or captions a call
CLIP_ATTN_SHAPES = ((16, 50, 12, False), (16, 77, 8, True))
# eval at the evaluation script's batch 16: 4 batches (the driver's
# --eval_num 64); a batch of the flagship at 20 rounds launches attention
# 12 x 20 times and the sample head 20 times
EVAL_BATCH, EVAL_SAMPLES = 16, 64
EVAL_LAUNCHES = {'attention': 12 * 20, 'sample_head': 20}
# I3D on the card (fp32, TF32 off) vs the CPU on one clip: max abs error
# over the largest |activation|; fp32 convolutions summed in other orders
# through 57 layers
I3D_CARD_TOL = 1e-3
# FVD of a set against itself, over the trace of its covariance (the
# eigendecomposition's fp64 rounding)
FVD_SELF_TOL = 1e-6
# int8 attention kernel vs plain (disagreement below): the integers are
# the same, and only expf's last bit can move p * 127 across a rounding
# tie (one quantization step of one output over its row sum) or the row
# sum by an ulp.  On the H100, over the card tests' shapes (B16 L565/L629
# packed, L29, L139 D32, L1024; fp32 and bf16; three seeds each), the
# kernel read at most 0.405 steps, a mean of at most 0.00185 steps and, in
# bf16, at most 0.098 of the outputs differing; the unquantized function
# (and the bf16 kernel) on the same inputs read at least 0.535 steps, a
# mean of at least 0.0333 steps and 0.879 differing.  So a kernel passes
# within these limits, and the unquantized function, which the checks
# compute beside it, must not
INT8_MAX_STEPS = 0.5
INT8_MEAN_STEPS = 0.005
INT8_DIFFER_SHARE_BF16 = 0.25
# int8 serving vs the bf16 model (the JAX package's own gates,
# tests/test_int8.py): backbone logits on one forward, and the int8
# decoder against the unquantized one on the same ids (applied site by
# site: _int8_decoder_checks says why)
INT8_LOGITS_COS = 0.99
INT8_ARGMAX_AGREE = 0.9
INT8_DECODE_MEAN = 0.02
INT8_DECODE_MAX = 0.2

# NVIDIA H100 SXM peaks (data sheet, dense): the bounds of the kernels line
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bf16': 989e12, 'fp32': 67e12, 'int8': 1979e12,
              'tf32': 495e12}


def bound(nbytes: float, flops: float, kind: str):
    """(least ms the card could take, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def reset_counts():
    from mmvid_tpu_torch.breakdown import KERNELS
    for mod in KERNELS.values():
        mod.launches = 0
    KERNELS['attention'].backward_calls = 0
    KERNELS['attention'].backward_launches = 0


def backward_launches() -> int:
    """The attention backward kernels' launches since the last reset (one
    a backward call on the card)."""
    from mmvid_tpu_torch.breakdown import KERNELS
    return KERNELS['attention'].backward_launches


def read_counts():
    from mmvid_tpu_torch.breakdown import KERNELS
    return {name: mod.launches for name, mod in KERNELS.items()}


def expected(**launches):
    """Launch counts of a path: the given kernels, every other one 0."""
    from mmvid_tpu_torch.breakdown import KERNELS
    return dict(dict.fromkeys(KERNELS, 0), **launches)


def fail(msg: str):
    print(f'FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


# device cycles that a timed run waits behind (about 2.5 ms), so the host
# queues its calls meanwhile and their host time stays out of the reading
HOST_AHEAD_CYCLES = 5_000_000


def cuda_time_ms(fn, calls: int = 20, reps: int = 5,
                 warmup: int = 3) -> float:
    """Device time per call, in ms: CUDA events around ``calls``
    back-to-back calls queued behind a device-side wait (so the host's
    launch overhead stays out of the device time, also for a call shorter
    than its host work), over ``calls``; median of ``reps``."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False: this smoke test needs a '
             'CUDA device')
    smi = card()
    print(smi, flush=True)
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}',
          flush=True)
    return smi


def phase_build():
    from mmvid_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f'[build] {time.perf_counter() - t0:.2f} s', flush=True)


def _attention_inputs(b, l, h, d, dtype, packed, seed):
    """q, k, v [B, L, H, D] on the card: contiguous, or (packed) strided
    views of one [B, L, 3 * H * D] projection, the main path's layout
    (models/clip.py)."""
    import torch
    g = torch.Generator(device='cuda').manual_seed(seed)
    if packed:
        qkv = torch.randn((b, l, 3 * h * d), generator=g, device='cuda'
                          ).to(dtype)
        return [qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                for i in range(3)]
    return [torch.randn((b, l, h, d), generator=g, device='cuda').to(dtype)
            for _ in range(3)]


def disagreement(out, ref, v) -> dict:
    """How outputs ``out`` of the int8 attention differ from its plain
    version's ``ref`` on the same q, k, ``v``: the max abs difference, the
    share of outputs that differ at all, and in quantization steps the
    largest and the mean difference and the share beyond one step.  One
    step is what one p8 rounding can move an output by: vs = max|v| / 127
    of its (batch, head), over a row sum of at least 1, plus a rounding of
    the output dtype (eps * |ref|)."""
    import torch
    diff = (out.float() - ref.float()).abs()
    step = (v.float().abs().amax(dim=(1, 3), keepdim=True) / 127.0
            + torch.finfo(out.dtype).eps * ref.float().abs())
    steps = diff / step
    return {'max_abs_err': diff.max().item(),
            'differ_share': (diff > 0).float().mean().item(),
            'max_steps': steps.max().item(),
            'mean_steps': steps.mean().item(),
            'beyond_one_step_share': (steps > 1).float().mean().item()}


def int8_agrees(dis: dict, dtype) -> bool:
    """``disagreement``'s reading within the int8 limits: at most
    INT8_MAX_STEPS anywhere, INT8_MEAN_STEPS on average and, for bf16
    outputs, at most INT8_DIFFER_SHARE_BF16 of them differing (fp32
    outputs differ in their last bits wherever the row sums do)."""
    import torch
    return (dis['max_steps'] <= INT8_MAX_STEPS
            and dis['mean_steps'] <= INT8_MEAN_STEPS
            and (dtype != torch.bfloat16
                 or dis['differ_share'] <= INT8_DIFFER_SHARE_BF16))


def _set_attn_bf16(on: bool):
    if on:
        os.environ['MMVID_ATTN_BF16'] = '1'
    else:
        os.environ.pop('MMVID_ATTN_BF16', None)


def phase_attention():
    """The attention kernels against their plain version with
    MMVID_ATTN_BF16 off and on: fp32 (the CUDA-core kernel, TF32 off) and
    bf16 (the tensor-core kernel) on contiguous q, k, v at each path's
    sequence and mask_prev rows (text+mask L 629, flagship L 565, tiny L
    139), and on packed strided views with mask_prev and causal masks, D
    64 and 32.  Fails beyond ATTN_TOL, or where the default bf16 route
    differs from the plain version in more than ATTN_DIFFER_MAX of its
    outputs.  Times the bf16 kernel (both variants), the plain version and
    ``F.scaled_dot_product_attention`` with the same float mask on the
    main path's packed views at L 629 and L 565; then the fp32 route there
    (``_attention_fp32_route``) and at the CLIP shapes."""
    import torch
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain = fp32

    def check(tag, q, k, v, mask, bf16p):
        _set_attn_bf16(bf16p)
        d = q.shape[-1]
        out = A.fused_attention_blhd(q, k, v, mask)
        ref = A.attention_reference(q, k, v, mask, d ** -0.5, bf16p)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        differ = (out != ref).float().mean().item()
        name = str(q.dtype).split('.')[-1]
        tol = ATTN_TOL[(name, bf16p)]
        variant = 'bf16 probabilities' if bf16p else 'default'
        print(f'[attention] {tag} {name} {variant}: max abs err {err:.3e} '
              f'(tol {tol}), outputs differing from plain {differ:.4f}',
              flush=True)
        if not err <= tol:
            fail(f'attention {tag} {name} {variant}: max abs err {err} > '
                 f'{tol}')
        if name == 'bfloat16' and not bf16p and differ > ATTN_DIFFER_MAX:
            fail(f'attention {tag}: {differ} of the outputs differ from '
                 f'plain (> {ATTN_DIFFER_MAX})')
        return err, differ

    for b, l, h, d, idx in ((16, 629, 12, 64, (115, 116)),
                            (16, 565, 12, 64, (51, 52)),
                            (16, 139, 2, 32, (9, 10))):
        mask = build_attention_mask(l, 'mask_prev', index=idx, device='cuda')
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _attention_inputs(b, l, h, d, dtype, False, l)
            for bf16p in (False, True):
                check(f'B={b} L={l} H={h} D={d} contiguous', q, k, v, mask,
                      bf16p)
    for b, l, h, d, kind, idx in ((16, 629, 12, 64, 'mask_prev', (115, 116)),
                                  (16, 565, 12, 64, 'mask_prev', (51, 52)),
                                  (16, 626, 12, 64, 'causal', None),
                                  (16, 139, 2, 32, 'mask_prev', (9, 10)),
                                  (16, 139, 2, 32, 'causal', None)):
        mask = build_attention_mask(l, kind, index=idx, device='cuda')
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _attention_inputs(b, l, h, d, dtype, True, l + 1)
            for bf16p in (False, True):
                check(f'B={b} L={l} H={h} D={d} packed {kind}', q, k, v,
                      mask, bf16p)

    # times on the main path's inputs: packed bf16 views, mask_prev
    rows = {}
    for b, l, h, d, idx in ((16, 629, 12, 64, (115, 116)),
                            (16, 565, 12, 64, (51, 52))):
        mask = build_attention_mask(l, 'mask_prev', index=idx, device='cuda')
        q, k, v = _attention_inputs(b, l, h, d, torch.bfloat16, True, l + 2)
        # one PyTorch call for the same function: [B, H, L, D] views and
        # the same additive mask in q's dtype
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mt = mask.to(torch.bfloat16)
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mt))
        nbytes = 4 * b * l * h * d * 2 + l * l * 4
        bms, by = bound(nbytes, 4 * b * h * l * l * d, 'bf16')
        for bf16p in (False, True):
            err, differ = check(f'B={b} L={l} H={h} D={d} packed mask_prev '
                                f'(timed)', q, k, v, mask, bf16p)
            _set_attn_bf16(bf16p)
            ms = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v, mask))
            plain_ms = cuda_time_ms(lambda: A.attention_reference(
                q, k, v, mask, d ** -0.5, bf16p))
            rows[(l, bf16p)] = {'max_abs_err': err, 'differ_share': differ,
                                'ms': ms, 'plain_ms': plain_ms,
                                'library_ms': lib_ms, 'bound_ms': bms,
                                'bound_by': by}
            print(f'[attention] B={b} L={l} H={h} D={d} bfloat16 '
                  f'{"bf16 probabilities" if bf16p else "default"}: kernel '
                  f'{ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms '
                  f'bound {bms:.4f} ms ({by})', flush=True)
            if not ms < lib_ms:
                print(f'[attention] note: the kernel is not faster than '
                      f'sdpa at L={l}', flush=True)
    _set_attn_bf16(False)
    return rows, _attention_fp32_route(check), _attention_clip_shapes()


def _attention_fp32_route(check):
    """The fp32 route (csrc/attention_fp32_sm90.cu, the CUDA cores) on the
    main paths' layout in fp32, the released recipes' precision: packed
    views, B16 H12 D64, mask_prev rows, L 629 and 565, MMVID_ATTN_BF16 off
    and on (``check``: ATTN_TOL); timed beside the plain version,
    ``F.scaled_dot_product_attention`` in fp32 on the same float mask and
    the fp32 bound, with the query tile the route takes."""
    import torch
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.ops import attention as A

    out_rows = {}
    for b, l, h, d, idx in ((16, 629, 12, 64, (115, 116)),
                            (16, 565, 12, 64, (51, 52))):
        mask = build_attention_mask(l, 'mask_prev', index=idx, device='cuda')
        q, k, v = _attention_inputs(b, l, h, d, torch.float32, True, l + 4)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        bms, by = bound(4 * b * l * h * d * 4 + l * l * 4,
                        4 * b * h * l * l * d, 'fp32')
        row = {'tile_rows': A.fp32_tile_rows(b, l, h), 'library_ms': lib_ms,
               'bound_ms': bms, 'bound_by': by}
        for bf16p in (False, True):
            err, _ = check(f'B={b} L={l} H={h} D={d} packed mask_prev '
                           f'(timed)', q, k, v, mask, bf16p)
            _set_attn_bf16(bf16p)
            ms = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v, mask))
            if bf16p:
                row['bf16_probs'] = {'max_abs_err': err, 'ms': ms}
                continue
            row.update(max_abs_err=err, ms=ms, plain_ms=cuda_time_ms(
                lambda: A.attention_reference(q, k, v, mask, d ** -0.5)))
        _set_attn_bf16(False)
        out_rows[l] = row
        print(f'[attention] B={b} L={l} H={h} D={d} float32 packed '
              f'mask_prev, {16 * row["tile_rows"]}-row tiles: kernel '
              f'{row["ms"]:.4f} ms (bf16 probabilities '
              f'{row["bf16_probs"]["ms"]:.4f}) plain {row["plain_ms"]:.4f} '
              f'ms sdpa fp32 {lib_ms:.4f} ms bound {bms:.4f} ms ({by})',
              flush=True)
    return out_rows


def _attention_clip_shapes():
    """The fp32 route at the CLIP scorer's shapes (CLIP_ATTN_SHAPES), on
    packed views with the masks the towers pass (none for the visual
    tower, the causal ``AttentionMask`` for the text tower): max abs
    error against the plain version (ATTN_TOL fp32), kernel, plain and
    SDPA fp32 ms on the same float mask, and the fp32 bound."""
    import torch
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A

    out_rows = {}
    for b, l, h, causal in CLIP_ATTN_SHAPES:
        d = 64
        q, k, v = _attention_inputs(b, l, h, d, torch.float32, True, l + 3)
        mask = attention_mask(l, 'causal', device='cuda') if causal else None
        dense = (mask.dense if causal
                 else torch.zeros((l, l), device='cuda'))
        out = A.fused_attention_blhd(q, k, v, mask)
        ref = A.attention_reference(q, k, v, dense, d ** -0.5)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = ATTN_TOL[('float32', False)]
        tag = (f'B={b} L={l} H={h} D={d} fp32 '
               f'{"causal" if causal else "no mask"}')
        if not err <= tol:
            fail(f'attention (CLIP) {tag}: max abs err {err} > {tol}')
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib_ms = cuda_time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=dense))
        ms = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v, mask))
        plain_ms = cuda_time_ms(lambda: A.attention_reference(
            q, k, v, dense, d ** -0.5))
        bms, by = bound(4 * b * l * h * d * 4 + l * l * 4,
                        4 * b * h * l * l * d, 'fp32')
        out_rows[f'L{l}_H{h}'] = {
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'library_ms': lib_ms, 'bound_ms': bms, 'bound_by': by,
            'mask': 'causal' if causal else 'none'}
        print(f'[attention] CLIP {tag}: max abs err {err:.3e} (tol {tol}); '
              f'kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa fp32 '
              f'{lib_ms:.4f} ms bound {bms:.4f} ms ({by})', flush=True)
    return out_rows


def _packed_grads(fn, qkv, cot, mask):
    """d qkv of sum(fn(q, k, v, mask) * cot), q, k, v strided views of
    the packed projection qkv [B, L, 3 * H * D] (models/clip.py)."""
    import torch
    b, l, h, d = cot.shape
    x = qkv.detach().requires_grad_(True)
    q, k, v = (x[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
               for i in range(3))
    return torch.autograd.grad(fn(q, k, v, mask), x, cot)[0]


# attention's backward kernels' shapes in phase_attention_backward: (B, L,
# H, D, mask kind, mask_prev rows, dtypes): the flagship's L565 and
# text+mask's L629 (mask_prev and causal), ART-V's causal L626,
# text_augment's L516 (fp32, its recipe's precision, and bf16), the
# training driver's batch 48 (bf16, --bf16), the tiny models' D32
ATTN_BWD_SHAPES = (
    (16, 565, 12, 64, 'mask_prev', (51, 52), ('float32', 'bfloat16')),
    (16, 629, 12, 64, 'mask_prev', (115, 116), ('float32', 'bfloat16')),
    (16, 565, 12, 64, 'causal', None, ('float32', 'bfloat16')),
    (16, 629, 12, 64, 'causal', None, ('float32', 'bfloat16')),
    (16, 626, 12, 64, 'causal', None, ('float32', 'bfloat16')),
    (16, 516, 12, 64, 'mask_prev', (2, 3), ('float32', 'bfloat16')),
    (48, 565, 12, 64, 'mask_prev', (51, 52), ('bfloat16',)),
    (3, 139, 2, 32, 'mask_prev', (9, 10), ('float32', 'bfloat16')))
# the shapes timed beside SDPA's forward and backward (the others: the
# kernel and the plain version)
ATTN_BWD_SDPA_SHAPES = ((16, 565), (16, 629), (48, 565))


def attention_backward_bound(b, l, h, d, dtype):
    """(bound ms, what bounds it, the other bound) of one backward call:
    the bytes of q, k, v, the cotangent, the forward's output (and its
    rest in bf16) read once, the mask and the row statistics, dq, dk, dv
    written once; the operations the function needs, the five products'
    10 B H L^2 D, as the forward's bound counts its four.  bf16: at the
    bf16 peak; the third value counts the three more products of the
    kernel's hi/lo split (P and dS against their partner twice), 16 B H
    L^2 D, at the bf16 peak.  fp32: the five products in split TF32, 3 x
    10 B H L^2 D at the TF32 peak (the least time for fp32 accuracy on
    this card); the third value the same five products on the CUDA cores'
    fp32 FMAs, 10 B H L^2 D at 67 TFLOP/s."""
    bf16 = dtype == 'bfloat16'
    item = 2 if bf16 else 4
    tensors = 9 if bf16 else 8
    nbytes = tensors * b * l * h * d * item + l * l * 4 + b * h * l * 4
    flops = 10 * b * h * l * l * d
    if bf16:
        bms, by = bound(nbytes, flops, 'bf16')
        return bms, by, bound(nbytes, 16 * b * h * l * l * d, 'bf16')[0]
    bms, by = bound(nbytes, 3 * flops, 'tf32')
    return bms, by, bound(nbytes, flops, 'fp32')[0]


def _bwd_errors(got, want) -> tuple:
    """(max |got - want| / (1 + |want|), the largest of ||got - want|| /
    ||want||) over a tuple of gradients."""
    rel = max(((x.float() - w.float()).abs() / (1 + w.float().abs())
               ).max().item() for x, w in zip(got, want))
    norm = max(((x.float() - w.float()).norm()
                / w.float().norm().clamp_min(1e-30)).item()
               for x, w in zip(got, want))
    return rel, norm


def _bwd_ok(rel, norm, dtype) -> bool:
    return rel <= ATTN_BWD_TOL[dtype] and norm <= ATTN_BWD_NORM_TOL[dtype]


def _unit_rms(g):
    """The cotangent g rescaled to a root mean square of 1 (in g's dtype):
    the backward is linear in g, so this holds a training step's tiny
    cotangents at the scale ATTN_BWD_TOL was read at."""
    rms = g.float().pow(2).mean().sqrt()
    return (g.float() / rms).to(g.dtype) if rms > 0 else g


def _old_backward_in_turns():
    """With ``MMVID_BWD_OLD_SOURCE`` naming a directory that holds PR 20's
    two backward sources (attribution.py's ``--attention-bwd-source``):
    those kernels against the route and SDPA in turns
    (``attribution.attention_bwd``), {'ms': {shape: {call: ms}}, 'gap':
    ...}; else None (the old sources are not in the repository)."""
    import tempfile
    from pathlib import Path

    from mmvid_tpu_torch import attribution
    src = os.environ.get('MMVID_BWD_OLD_SOURCE')
    if not src:
        return None
    res = {'attention_bwd_ms': {}, 'attention_bwd_gap': {}}
    with tempfile.TemporaryDirectory() as tmp:
        fns = attribution.build(None, None, None, Path(tmp),
                                attention_bwd_source=Path(src))
        attribution.attention_bwd(fns[('old_bwd', 'as_is')], res)
    return {'ms': res['attention_bwd_ms'], 'gap': res['attention_bwd_gap']}


def phase_attention_backward():
    """Attention's backward on the card: the kernels of both routes (bf16
    on wgmma, csrc/attention_bwd_sm90.cu; fp32 on wgmma in split TF32,
    csrc/attention_bwd_fp32_sm90.cu) at ATTN_BWD_SHAPES, on the packed
    strided q, k, v views, given the models' mask (the fp32 mask and its
    compact form, which the fp32 kernel reads): through ``FusedAttention``
    (the forward kernel with its statistics, then the backward kernels
    once) against autograd through ``attention_reference``, d qkv within
    ATTN_BWD_TOL; the kernels alone (``attention_backward_kernel``)
    against their plain version ``attention_backward`` on the same inputs
    within ATTN_BWD_TOL, two calls equal bit for bit, and equal to a call
    given the fp32 mask alone.  Times each route at each shape (the
    backward alone, given the forward's output and statistics) beside the
    plain version, and at ATTN_BWD_SDPA_SHAPES beside
    ``F.scaled_dot_product_attention``'s forward and backward in the same
    dtype on the same float mask, the forward kernel with and without the
    statistics; the bound (``attention_backward_bound``).  Returns the
    kernels line's rows, by dtype."""
    import torch
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {'float32': {'shapes': {}}, 'bfloat16': {'shapes': {}}}
    for b, l, h, d, kind, idx, dtypes in ATTN_BWD_SHAPES:
        # the models' mask: the fp32 mask and its compact form
        both = attention_mask(l, kind, index=idx, device='cuda')
        mask, compact = both
        scale = d ** -0.5
        for name in dtypes:
            dtype = getattr(torch, name)
            g = torch.Generator(device='cuda').manual_seed(l + b)
            qkv = torch.randn((b, l, 3 * h * d), generator=g,
                              device='cuda').to(dtype)
            cot = torch.randn((b, l, h, d), generator=g,
                              device='cuda').to(dtype)
            before, bwd = A.launches, A.backward_launches
            got = _packed_grads(A.fused_attention_blhd, qkv, cot, both)
            launched = (A.launches - before, A.backward_launches - bwd)
            want = _packed_grads(lambda q, k, v, m: A.attention_reference(
                q, k, v, m, scale), qkv, cot, mask)
            fn_rel, fn_norm = _bwd_errors((got,), (want,))
            del got, want
            q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                       for i in range(3))
            out, lse, out_lo = A._launch(q, k, v, mask, scale, False,
                                         with_lse=True)
            args = (q, k, v, mask, scale, cot, out, lse, out_lo)

            def kernel():   # as FusedAttention calls it: with the bits
                return A.attention_backward_kernel(*args, compact=compact)

            kern = kernel()
            again = kernel()
            # fp32 reads the bits; the fp32 mask must give the same
            dense = A.attention_backward_kernel(*args)
            plain = A.attention_backward(q, k, v, mask, scale, cot)
            torch.cuda.synchronize()
            rel, norm = _bwd_errors(kern, plain)
            err = max((x.float() - w.float()).abs().max().item()
                      for x, w in zip(kern, plain))
            same = all(torch.equal(x, y) for x, y in zip(kern, again))
            same_dense = all(torch.equal(x, y) for x, y in zip(kern, dense))
            tol, norm_tol = ATTN_BWD_TOL[name], ATTN_BWD_NORM_TOL[name]
            # planted faults, which the checks must refuse: dq 2^-6 too
            # large (a systematic error, for the normwise check), and one
            # key's dk and dv zeroed (a lost mask column, for the
            # elementwise one): batch 0, head 0's key of the largest |dv|
            j = plain[2][0, :, 0].float().norm(dim=-1).argmax()
            dk_j, dv_j = kern[1].clone(), kern[2].clone()
            dk_j[0, j, 0] = 0
            dv_j[0, j, 0] = 0
            controls = {c: _bwd_errors(grads, plain) for c, grads in (
                ('dq_scaled', (kern[0] * (1 + 2 ** -6), *kern[1:])),
                ('key_zeroed', (kern[0], dk_j, dv_j)))}
            del kern, again, dense, plain, dk_j, dv_j
            ms = cuda_time_ms(kernel)
            plain_ms = cuda_time_ms(lambda: A.attention_backward(
                q, k, v, mask, scale, cot), calls=5, reps=3)
            bms, by, bms_other = attention_backward_bound(b, l, h, d, name)
            row = {'max_abs_err': err, 'max_rel_err': rel,
                   'max_norm_rel_err': norm,
                   'function_max_rel_err': fn_rel,
                   'function_max_norm_rel_err': fn_norm,
                   'controls': controls, 'bitwise_repeat': same,
                   'equal_with_fp32_mask': same_dense,
                   'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bms,
                   'bound_by': by}
            if name == 'float32':   # the fp32 mask instead of the bits
                row['ms_fp32_mask'] = cuda_time_ms(
                    lambda: A.attention_backward_kernel(*args))
            row['bound_split_products_ms' if name == 'bfloat16'
                else 'bound_fp32_fma_ms'] = bms_other
            if (b, l) in ATTN_BWD_SDPA_SHAPES and kind == 'mask_prev':
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                              for t in (q, k, v))
                mt, ct = mask.to(dtype), cot.transpose(1, 2)

                def sdpa():
                    o = torch.nn.functional.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mt)
                    return torch.autograd.grad(o, (qt, kt, vt), ct)

                with torch.no_grad():
                    row['forward_kernel_ms'] = cuda_time_ms(
                        lambda: A._launch(q, k, v, mask, scale, False))
                    row['forward_kernel_stats_ms'] = cuda_time_ms(
                        lambda: A._launch(q, k, v, mask, scale, False,
                                          with_lse=True))
                row['library_ms'] = cuda_time_ms(sdpa)
                del qt, kt, vt
            key = f'B{b}_L{l}_H{h}_D{d}_{kind}'
            rows[name]['shapes'][key] = row
            print(f'[attention bwd] {key} {name}: kernels vs plain max abs '
                  f'err {err:.3e}, max err / (1 + |plain|) {rel:.3e}, '
                  f'through FusedAttention {fn_rel:.3e} (tol {tol}); '
                  f'normwise {norm:.3e}, through FusedAttention '
                  f'{fn_norm:.3e} (tol {norm_tol}); planted faults, which '
                  'must fail: ' + ', '.join(
                      f'{c} {cr:.3e} / {cn:.3e}'
                      for c, (cr, cn) in controls.items())
                  + f'; two calls equal {same}, equal with the fp32 mask '
                  f'{same_dense}; launches (forward, backward) {launched}; '
                  f'kernel {ms:.4f} ms'
                  + (f' (with the fp32 mask {row["ms_fp32_mask"]:.4f})'
                     if 'ms_fp32_mask' in row else '')
                  + f', plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; '
                  + ("the split's products at the bf16 peak"
                     if name == 'bfloat16' else 'on the fp32 FMAs')
                  + f' {bms_other:.4f})'
                  + (f', sdpa forward+backward {row["library_ms"]:.4f} ms, '
                     f'forward kernel {row["forward_kernel_ms"]:.4f} ms, '
                     f'with statistics {row["forward_kernel_stats_ms"]:.4f} '
                     f'ms' if 'library_ms' in row else ''), flush=True)
            if not (_bwd_ok(rel, norm, name) and _bwd_ok(fn_rel, fn_norm,
                                                          name)):
                fail(f'attention backward {key} {name}: {rel} / {fn_rel} > '
                     f'{tol} or {norm} / {fn_norm} > {norm_tol}')
            for c, (cr, cn) in controls.items():
                if _bwd_ok(cr, cn, name):
                    fail(f'attention backward {key} {name}: the planted '
                         f'fault {c} passed the checks ({cr}, {cn})')
            if not same:
                fail(f'attention backward {key} {name}: two calls differ')
            if not same_dense:
                fail(f'attention backward {key} {name}: the compact mask '
                     'and the fp32 mask give different gradients')
            if launched != (1, 1):
                fail(f'attention backward {key} {name}: launches (forward, '
                     f'backward) {launched}, not (1, 1)')
            del qkv, cot, q, k, v, out, lse, out_lo, args
        torch.cuda.empty_cache()
    rows['in_turns'] = _old_backward_in_turns()
    for name in ('float32', 'bfloat16'):
        r = rows[name]
        r['max_abs_err'] = max(x['max_abs_err'] for x in r['shapes'].values())
        r['max_rel_err'] = max(x['max_rel_err'] for x in r['shapes'].values())
        r['max_norm_rel_err'] = max(x['max_norm_rel_err']
                                    for x in r['shapes'].values())
    return rows


def _set_attn_int8(on: bool):
    if on:
        os.environ['MMVID_ATTN_INT8'] = '1'
    else:
        os.environ.pop('MMVID_ATTN_INT8', None)


def phase_attention_int8():
    """MMVID_ATTN_INT8=1: the s8 kernel against attention_int8_reference
    at the main paths' shapes, B16 H12 D64 bf16 on the packed strided
    views with mask_prev rows (flagship L 565, text+mask L 629), given the
    mask as the models give it (``models/clip.py::attention_mask``: the
    fp32 mask and its compact form, which the kernel reads): the compact
    form equal to the dense mask; within the int8 limits
    (``int8_agrees``), while two controls on the same inputs, the
    unquantized function (``attention_reference``) and the bf16 kernel,
    must fall outside them; two calls bitwise equal, and equal to the call
    that reads the fp32 mask; two launches a call (the operand pass and
    the attention); kernel (with the compact mask, and with the fp32 mask
    alone), plain and, as context only (it computes the bf16 function, not
    this one), ``F.scaled_dot_product_attention`` on the same views and
    mask."""
    import torch
    from mmvid_tpu_torch.models.clip import attention_mask
    from mmvid_tpu_torch.ops import attention as A
    from mmvid_tpu_torch.ops import attention_int8 as A8

    rows = {}
    try:
        for b, l, h, d, idx in ((16, 565, 12, 64, (51, 52)),
                                (16, 629, 12, 64, (115, 116))):
            masks = attention_mask(l, 'mask_prev', index=idx, device='cuda')
            mask = masks.dense
            if not torch.equal(masks.compact.dense(), mask):
                fail(f'the compact mask differs from the dense one at L={l}')
            q, k, v = _attention_inputs(b, l, h, d, torch.bfloat16, True,
                                        l + 3)
            bf16_kernel = A.fused_attention_blhd(q, k, v, mask)
            _set_attn_int8(True)
            before = (A.launches, A8.launches)
            out = A.fused_attention_blhd(q, k, v, masks)
            again = A.fused_attention_blhd(q, k, v, masks)
            launched = (A.launches - before[0], A8.launches - before[1])
            dense_read = A.fused_attention_blhd(q, k, v, mask)
            ref = A8.attention_int8_reference(q, k, v, mask, d ** -0.5)
            torch.cuda.synchronize()
            same = torch.equal(out, again)
            same_dense = torch.equal(out, dense_read)
            dis = disagreement(out, ref, v)
            controls = {
                'unquantized': disagreement(A.attention_reference(
                    q, k, v, mask, d ** -0.5), ref, v),
                'bf16_kernel': disagreement(bf16_kernel, ref, v)}
            ms = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v, masks))
            ms_dense = cuda_time_ms(lambda: A.fused_attention_blhd(q, k, v,
                                                                   mask))
            plain_ms = cuda_time_ms(lambda: A8.attention_int8_reference(
                q, k, v, mask, d ** -0.5), calls=5, reps=3)
            _set_attn_int8(False)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mt = mask.to(torch.bfloat16)
            sdpa_ms = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mt))
            # q, k, v read once, out written once, the mask once
            nbytes = 4 * b * l * h * d * 2 + l * l * 4
            bms, by = bound(nbytes, 4 * b * h * l * l * d, 'int8')
            rows[l] = dict(dis, bitwise_repeat=same,
                           equal_with_fp32_mask=same_dense, ms=ms,
                           ms_fp32_mask=ms_dense, plain_ms=plain_ms,
                           library_ms=None, sdpa_bf16_ms_context=sdpa_ms,
                           bound_ms=bms, bound_by=by, controls=controls)
            print(f'[attention_int8] B={b} L={l} H={h} D={d} bfloat16 '
                  f'packed mask_prev: max abs err {dis["max_abs_err"]:.3e}, '
                  f'max {dis["max_steps"]:.4f} steps (bound '
                  f'{INT8_MAX_STEPS}), mean {dis["mean_steps"]:.3e} steps '
                  f'(bound {INT8_MEAN_STEPS}), outputs differing '
                  f'{dis["differ_share"]:.6f} (bound '
                  f'{INT8_DIFFER_SHARE_BF16}); controls, which must fall '
                  'outside: ' + ', '.join(
                      f'{n} max {c["max_steps"]:.4f} mean '
                      f'{c["mean_steps"]:.4f} differing '
                      f'{c["differ_share"]:.4f}'
                      for n, c in controls.items())
                  + f'; two calls bitwise equal {same}, equal to the fp32 '
                  f'mask\'s call {same_dense}; launches (bf16, int8) '
                  f'{launched}; kernel {ms:.4f} ms (fp32 mask read: '
                  f'{ms_dense:.4f} ms) plain {plain_ms:.4f} ms (sdpa bf16, '
                  f'another function: {sdpa_ms:.4f} ms) bound {bms:.4f} ms '
                  f'({by})', flush=True)
            if launched != (0, 4):
                fail(f'int8 attention launches {launched} != (0, 4)')
            if not (same and same_dense and int8_agrees(dis, out.dtype)):
                fail(f'int8 attention kernel disagrees with plain at L={l}')
            if any(int8_agrees(c, out.dtype) for c in controls.values()):
                fail(f'the int8 limits pass an unquantized control at L={l}')
    finally:
        _set_attn_int8(False)
    return rows


def _tv(p, q):
    return 0.5 * (p - q).abs().sum().item()


def phase_sample_head():
    import torch
    import torch.nn.functional as F
    from mmvid_tpu_torch.ops import sample_head as S

    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain = fp32
    dev = torch.device('cuda')
    m, d, v = 8192, 768, 1024
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((m, d), generator=g, device=dev) * 2 + 0.5
    ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
    ln_b = 0.1 * torch.randn((d,), generator=g, device=dev)
    # logit std about 3: a peaked distribution with tens of likely tokens
    w = (0.108 * torch.randn((d, v), generator=g, device=dev)).bfloat16()
    b = 0.1 * torch.randn((v,), generator=g, device=dev)
    # a genuinely fp32 W (all 23 mantissa bits), for the fp32-W routes: a
    # W rounded from bf16 has its low 16 bits zero, and could not tell a
    # kernel that drops W's low bits from one that keeps them
    w32 = 0.108 * torch.randn((d, v), generator=g, device=dev)
    w32t = S.prepare_head_weight(w32)   # W^T, once a sampling call
    if S.kernel_route(w32) != 'tf32x3' or S.kernel_route(w) != 'wgmma':
        fail('sample head: the full-width W does not take the tensor cores')

    # temp 0: Y must be the plain softmax probability of the chosen token
    y_errs = {}
    for wd in (w32, w):
        y, tok = S.fused_sample_head(x, ln_w, ln_b, wd, b, 0.0, g,
                                     w_prepared=S.prepare_head_weight(wd))
        probs = torch.softmax(S.head_logits(x, ln_w, ln_b, wd, b), -1)
        y_ref = probs.gather(1, tok[:, None])[:, 0]
        torch.cuda.synchronize()
        if not (tok.min() >= 0 and tok.max() < v):
            fail('sample head: token out of range')
        y_err = (y - y_ref).abs().max().item()
        tol = Y_TOL[str(wd.dtype).split('.')[-1]]
        print(f'[sample_head] M={m} D={d} V={v} W {wd.dtype} '
              f'({S.kernel_route(wd)}) temp=0: max |Y - p(tok)| '
              f'{y_err:.3e} (tol {tol})', flush=True)
        if not y_err <= tol:
            fail(f'sample head Y error {y_err} > {tol}')
        y_errs[wd.dtype] = y_err

    # distribution over 65536 rows that share one logits row
    n = 65536
    xr = x[:1].expand(n, d).contiguous()
    p_row = probs[0]
    hists = {}
    for temp in (0.0, 1.0):
        _, tk = S.fused_sample_head(xr, ln_w, ln_b, w, b, temp, g)
        g1 = S.gumbel((n, v), g, dev)
        g2 = S.gumbel((n, v), g, dev)
        _, tp = S.sample_head_reference(xr, ln_w, ln_b, w, b, temp, g1, g2)
        hists[temp] = (torch.bincount(tk, minlength=v).float() / n,
                       torch.bincount(tp, minlength=v).float() / n)
    tv0 = _tv(hists[0.0][0], p_row)
    tv0_plain = _tv(hists[0.0][1], p_row)
    tv1 = _tv(hists[1.0][0], hists[1.0][1])
    print(f'[sample_head] TV(kernel, softmax) at temp 0: {tv0:.4f} '
          f'(plain {tv0_plain:.4f}, bound {TV_EXACT_BOUND}); '
          f'TV(kernel, plain) at temp 1: {tv1:.4f} '
          f'(bound {TV_TWO_SAMPLE_BOUND})', flush=True)
    if not (tv0 <= TV_EXACT_BOUND and tv1 <= TV_TWO_SAMPLE_BOUND):
        fail('sample head token distribution out of bounds')

    # temp 1 against the plain version fed the kernels' own noise (the
    # plain Philox at the same seed): every route at its W, the CUDA-core
    # kernel at both, and the routes of one W against each other
    seed = torch.tensor([20260516], dtype=torch.int64, device=dev)
    g1, g2 = S.philox_gumbel(int(seed), m, v, dev)
    toks, philox = {}, {}
    for wd, route, tol in ((w, 'wgmma', HEAD_Y_REL_TOL),
                           (w, 'cuda_cores', HEAD_Y_REL_TOL),
                           (w32, 'tf32x3', HEAD_Y_REL_TOL_FP32),
                           (w32, 'cuda_cores', HEAD_Y_REL_TOL_FP32)):
        key = f'{route}_{str(wd.dtype).split(".")[-1]}'
        y_ref, tok_ref = S.sample_head_reference(x, ln_w, ln_b, wd, b, 1.0,
                                                 g1, g2)
        y, toks[key] = S.sample_head_kernel(x, ln_w, ln_b, wd, b, 1.0, seed,
                                            route, w_prepared=w32t)
        same = toks[key] == tok_ref
        share = same.float().mean().item()
        y_rel = ((y - y_ref).abs() / y_ref)[same].max().item()
        philox[key] = {'tokens_equal_share': share, 'y_rel_err': y_rel}
        print(f'[sample_head] M={m} temp 1, {route} kernel, W {wd.dtype}, '
              f'vs plain fed philox_gumbel at one seed: tokens equal on '
              f'{share:.6f} of rows (bound {HEAD_TOKEN_SHARE}), Y relative '
              f'error {y_rel:.3e} on those (tol {tol})', flush=True)
        if not (share >= HEAD_TOKEN_SHARE and y_rel <= tol):
            fail(f'sample head {route} kernel disagrees with plain Philox '
                 f'sampling')
    # the controls, each tolerance's Y error must lie below: bf16 W, the
    # plain version with its logits rounded to bf16 (what a kernel that
    # kept bf16 logits would give); fp32 W, the plain version with h and
    # W each rounded once to TF32 (what a kernel that skipped the split
    # would give)
    h = S.layer_norm_fp32(x, ln_w, ln_b)
    controls = {}
    for name, logits, wd, tol in (
            ('bf16_logits', S.head_logits(x, ln_w, ln_b, w, b).bfloat16()
             .float(), w, HEAD_Y_REL_TOL),
            ('one_pass_tf32', S.round_tf32(h) @ S.round_tf32(w32) + b, w32,
             HEAD_Y_REL_TOL_FP32)):
        y_ref, tok_ref = S.sample_head_reference(x, ln_w, ln_b, wd, b, 1.0,
                                                 g1, g2)
        noised = logits + g1
        y_ctrl = torch.exp(noised.gather(1, tok_ref[:, None])[:, 0]
                           - torch.logsumexp(noised, -1))
        controls[name] = ((y_ctrl - y_ref).abs() / y_ref).max().item()
        del noised
        print(f'[sample_head] M={m} temp 1, control ({name}): Y relative '
              f'error {controls[name]:.3e} (must exceed {tol})', flush=True)
        if not controls[name] > tol:
            fail(f'the sample head\'s Y tolerance does not tell the '
                 f'{name} control apart')
    del h
    cross = {'bf16': (toks['wgmma_bfloat16'] == toks['cuda_cores_bfloat16']
                      ).float().mean().item(),
             'fp32': (toks['tf32x3_float32'] == toks['cuda_cores_float32']
                      ).float().mean().item()}
    print(f'[sample_head] tensor-core vs CUDA-core kernel at one seed: '
          f'tokens equal on {cross["bf16"]:.6f} (bf16 W) and '
          f'{cross["fp32"]:.6f} (fp32 W, split TF32) of rows', flush=True)
    if not min(cross.values()) >= HEAD_TOKEN_SHARE:
        fail('the sample-head kernels disagree at one seed')

    # in turns: tensor cores, CUDA cores, CUDA cores, tensor cores, for
    # each W
    t = {}
    for wd, route in ((w, 'wgmma'), (w, 'cuda_cores'), (w, 'cuda_cores'),
                      (w, 'wgmma'), (w32, 'tf32x3'), (w32, 'cuda_cores'),
                      (w32, 'cuda_cores'), (w32, 'tf32x3')):
        key = f'{route}_{str(wd.dtype).split(".")[-1]}'
        t.setdefault(key, []).append(cuda_time_ms(
            lambda: S.sample_head_kernel(x, ln_w, ln_b, wd, b, 1.0, seed,
                                         route, w_prepared=w32t)))
    ms, ms_cores = min(t['wgmma_bfloat16']), min(t['cuda_cores_bfloat16'])
    ms32, ms32_cores = min(t['tf32x3_float32']), min(t['cuda_cores_float32'])

    def plain(wd):
        g1, g2 = S.philox_gumbel(int(seed), m, v, dev)
        return S.sample_head_reference(x, ln_w, ln_b, wd, b, 1.0, g1, g2)

    plain_ms = cuda_time_ms(lambda: plain(w), calls=5, reps=3)
    plain32_ms = cuda_time_ms(lambda: plain(w32), calls=5, reps=3)
    # the product alone in fp32 (TF32 off), another function: the fp32
    # pair a model without the fused head would run
    w32t = w32.t().contiguous()
    ln_linear_ms = cuda_time_ms(lambda: F.linear(
        F.layer_norm(x, (d,), ln_w, ln_b), w32t, b))
    prepare_ms = cuda_time_ms(lambda: S.prepare_head_weight(w32))
    print(f'[sample_head] M={m} bf16 W: tensor-core kernel {ms:.4f} ms '
          f'({t["wgmma_bfloat16"]}), CUDA-core kernel {ms_cores:.4f} ms '
          f'({t["cuda_cores_bfloat16"]}), plain (Philox noise included) '
          f'{plain_ms:.4f} ms', flush=True)
    # the fp32-W route, which every fp32 batch takes (the released
    # recipes' precision): x and W fp32 read once, Y and tok written once;
    # 3 x 2 M D V TF32 operations, the bound; the same product in fp32
    # FMAs beside it
    b32_ms, b32_by = bound(m * d * 4 + d * v * 4 + (2 * d + v) * 4
                           + m * (4 + 8), 3 * 2 * m * d * v, 'tf32')
    ffma_ms, _ = bound(0, 2 * m * d * v, 'fp32')
    print(f'[sample_head] M={m} fp32 W: split-TF32 kernel {ms32:.4f} ms '
          f'({t["tf32x3_float32"]}), CUDA-core kernel {ms32_cores:.4f} ms '
          f'({t["cuda_cores_float32"]}), plain {plain32_ms:.4f} ms, '
          f'F.layer_norm + F.linear fp32 {ln_linear_ms:.4f} ms, W^T '
          f'{prepare_ms:.4f} ms a sampling call; bound {b32_ms:.4f} ms '
          f'({b32_by}: TF32 at {PEAK_FLOPS["tf32"] / 1e12:.0f} TFLOP/s; '
          f'the product in fp32 FMAs {ffma_ms:.4f} ms)', flush=True)
    # x fp32 read once, W bf16 read once, Y and tok written once
    nbytes = m * d * 4 + d * v * 2 + (2 * d + v) * 4 + m * (4 + 8)
    extra = {'philox': philox, 'controls_y_rel_err': controls,
             'fp32_w_route': {
                 'source': 'mmvid_tpu_torch/csrc/sample_head_tf32_sm90.cu',
                 'max_abs_err': y_errs[torch.float32], 'ms': ms32,
                 'ms_all': t['tf32x3_float32'], 'plain_ms': plain32_ms,
                 'library_ms': None, 'bound_ms': b32_ms,
                 'bound_by': b32_by, 'ffma_bound_ms': ffma_ms,
                 'layer_norm_linear_fp32_ms': ln_linear_ms,
                 'prepare_ms': prepare_ms,
                 'cuda_cores_route': {
                     'source': 'mmvid_tpu_torch/csrc/sample_head.cu',
                     'ms': ms32_cores,
                     'ms_all': t['cuda_cores_float32']}},
             'kernels_tokens_equal_share': cross,
             'cuda_cores_route': {'source':
                                  'mmvid_tpu_torch/csrc/sample_head.cu',
                                  'ms': ms_cores,
                                  'ms_all': t['cuda_cores_bfloat16']},
             'ms_all': t['wgmma_bfloat16']}
    return (y_errs[torch.bfloat16], ms, plain_ms, None) + bound(
        nbytes, 2 * m * d * v, 'bf16'), extra


def phase_codebook():
    """Nearest-code kernel vs plain at the paths' shapes, D 256, K 1024:
    M 192 (the shapes model's 3 control frames x 64 latents, one sample),
    512 (VQGAN finetuning's batch of 8 images x 64 latents), 1024 (16
    control frames x 64 latents: text+mask, ART-V's speculative path),
    4096 (the image_and_video recipe's 4 control frames), 6144 (the last
    128-frame chunk of ``--save_codebook``'s 352 frames, 96 x 64) and 8192
    (one video's 8 frames: recon_images, the VQGAN's training encode).
    Returns the M 1024 row and the times at every other M."""
    import torch
    from mmvid_tpu_torch.ops import codebook as C

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    d, k = 256, 1024
    at_m = {}
    for m in CODEBOOK_ROWS:
        g = torch.Generator(device=dev).manual_seed(11)
        z = torch.randn((m, d), generator=g, device=dev)
        spread = torch.randn((k, d), generator=g, device=dev)
        init = (torch.rand((k, d), generator=g, device=dev) * 2 - 1) / k

        def gap(cb, idx):
            """best score - chosen score, in fp64, per row."""
            s = z.double() @ cb.double().t() - 0.5 * cb.double().square(
            ).sum(-1)[None]
            return s.max(-1).values - s.gather(1, idx[:, None])[:, 0]

        idx = C.nearest_codebook_indices(z, spread)
        ref = C.nearest_codebook_reference(z, spread)
        torch.cuda.synchronize()
        n_diff = int((idx != ref).sum())
        idx0 = C.nearest_codebook_indices(z, init)
        gaps = torch.cat([gap(spread, idx), gap(init, idx0)])
        err = gaps.max().item()
        ms = cuda_time_ms(lambda: C.nearest_codebook_indices(z, init))
        plain_ms = cuda_time_ms(
            lambda: C.nearest_codebook_reference(z, init))
        nbytes = (m * d + k * d) * 4 + m * 8
        b_ms, b_by = bound(nbytes, 2 * m * k * d, 'fp32')
        print(f'[codebook] M={m} D={d} K={k} fp32: randn codebook ids '
              f'differing from plain {n_diff}; max score gap to the best '
              f'(randn and random-init codebooks) {err:.3e} (tol '
              f'{CODE_GAP_TOL}); kernel {ms:.4f} ms plain {plain_ms:.4f} '
              f'ms bound {b_ms:.4f} ms ({b_by})', flush=True)
        if n_diff or not (idx.min() >= 0 and idx.max() < k):
            fail(f'codebook kernel ids differ from plain in {n_diff} rows '
                 f'at M={m}')
        if not err <= CODE_GAP_TOL:
            fail(f'codebook kernel score gap {err} > {CODE_GAP_TOL} at '
                 f'M={m}')
        at_m[m] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': b_ms, 'bound_by': b_by}
    row = at_m[1024]
    return ((row['max_abs_err'], row['ms'], row['plain_ms'], None,
             row['bound_ms'], row['bound_by']),
            {f'M{m}': at_m[m] for m in CODEBOOK_ROWS if m != 1024})


def phase_ln_qkv():
    """Fused LN+QKV kernel vs plain at the text+mask and flagship
    backbones' shapes (M = 16 x 629 and 16 x 565 rows, D 768, packed W
    [2304, 768]), bf16, timed beside the gate-off pair ``F.layer_norm`` +
    ``F.linear``; fp32 must raise on the card without a launch.  Returns
    the kernels-line row at M 16 x 629 and the readings at both."""
    import torch
    import torch.nn.functional as F
    from mmvid_tpu_torch.ops import fused_ln_qkv as Q

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    d = 768
    at = {}
    for m in (16 * 629, 16 * 565):
        g = torch.Generator(device=dev).manual_seed(13)
        x = torch.randn((m, d), generator=g, device=dev) * 2 + 0.5
        ln_w = 1 + 0.1 * torch.randn((d,), generator=g, device=dev)
        ln_b = 0.1 * torch.randn((d,), generator=g, device=dev)
        w = torch.randn((3 * d, d), generator=g, device=dev) * d ** -0.5
        b = 0.1 * torch.randn((3 * d,), generator=g, device=dev)
        before = Q.launches
        try:
            Q.fused_ln_qkv(x, ln_w, ln_b, w, b)
            fail('LN+QKV kernel accepted fp32 on the card')
        except ValueError:
            pass
        if Q.launches != before:
            fail('LN+QKV counted a launch for a refused fp32 call')
        xd, wd, bd = x.bfloat16(), w.bfloat16(), b.bfloat16()
        out = Q.fused_ln_qkv(xd, ln_w, ln_b, wd, bd)
        ref = Q.ln_qkv_reference(xd, ln_w, ln_b, wd, bd)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        tol = LNQKV_TOL
        within = bool((diff <= tol * (1 + ref.float().abs())).all())
        ms = cuda_time_ms(lambda: Q.fused_ln_qkv(xd, ln_w, ln_b, wd, bd))
        plain_ms = cuda_time_ms(lambda: Q.ln_qkv_reference(xd, ln_w, ln_b,
                                                           wd, bd))
        # what the backbone runs with the gate off
        unfused_ms = cuda_time_ms(lambda: F.linear(F.layer_norm(
            xd.float(), (d,), ln_w, ln_b, 1e-5).bfloat16(), wd, bd))
        nbytes = (m * d + 3 * d * d + 3 * d + 3 * m * d) * 2 + 2 * d * 4
        bms, by = bound(nbytes, 2 * m * d * 3 * d, 'bf16')
        at[m] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                 'layer_norm_linear_ms': unfused_ms, 'bound_ms': bms,
                 'bound_by': by}
        print(f'[ln_qkv] M={m} D={d} bfloat16: max abs err {err:.3e} '
              f'(|plain| max {ref.float().abs().max().item():.3f}; within '
              f'{tol} * (1 + |plain|): {within}) kernel {ms:.4f} ms plain '
              f'{plain_ms:.4f} ms unfused F.layer_norm+F.linear '
              f'{unfused_ms:.4f} ms bound {bms:.4f} ms ({by}); fp32 '
              f'refused', flush=True)
        if not within:
            fail(f'LN+QKV: error beyond {tol} * (1 + |plain|) at M={m}')
        if not ms < unfused_ms:
            print(f'[ln_qkv] note: the kernel is not faster than '
                  f'F.layer_norm + F.linear at M={m}', flush=True)
    r = at[16 * 629]
    row = (r['max_abs_err'], r['ms'], r['plain_ms'], None, r['bound_ms'],
           r['bound_by'])
    return row, at


def decode_bound(n_layers, b, d, pos, itemsize=2):
    """(ms, 'bytes'|'operations') of one ART-V step: every weight read
    once, the live cache rows < pos read once, x read and y, k_new, v_new
    written once; the products and the attention's operations."""
    nbytes = (n_layers * (12 * d * d * itemsize + 2 * b * pos * d * itemsize
                          + 2 * b * d * itemsize + 14 * d * 4)
              + 2 * b * d * 4)
    flops = n_layers * (2 * b * 12 * d * d + 4 * b * (pos + 1) * d)
    return bound(nbytes, flops, 'bf16' if itemsize == 2 else 'fp32')


def _decode_errs(got, want):
    """(max |dy|, max |dy| / (1 + |plain y|), max k/v error in bf16 ulps of
    max(|plain|, 1), max k/v error / (1 + |plain|), max |dk|, |dv|)."""
    import torch
    dy = (got[0] - want[0]).abs()
    ulps = rel = kv = 0.0
    for g, w in zip(got[1:], want[1:]):
        g, w = g.float(), w.float()
        ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1.0)))
                         - 7)
        ulps = max(ulps, ((g - w).abs() / ulp).max().item())
        rel = max(rel, ((g - w).abs() / (1 + w.abs())).max().item())
        kv = max(kv, (g - w).abs().max().item())
    return (dy.max().item(), (dy / (1 + want[0].abs())).max().item(), ulps,
            rel, kv)


def _decode_ok(errs, dtype):
    err, rel, ulps, kv_rel, kv = errs
    if dtype == 'float32':
        return max(err, kv) <= DECODE_TOL['float32']
    return rel <= DECODE_TOL['bfloat16'] and ulps <= 1.0


def _nan_rows(ck, cv, pos):
    """The caches with every row >= pos set to NaN (the kernels must not
    read them)."""
    ck, cv = ck.clone(), cv.clone()
    ck[:, :, pos:] = float('nan')
    cv[:, :, pos:] = float('nan')
    return ck, cv


def _decode_full_width(AD, x, p, ck, cv, pos, heads, ws, kernel):
    """(whole-step errors, worst block-by-block errors, bitwise equal over
    two calls, within tolerance) of a bf16 kernel at full width against
    the plain version, the caches' rows >= pos NaN."""
    import torch
    ckn, cvn = _nan_rows(ck, cv, pos)
    want = AD.decode_token_step_reference(x, p, ckn, cvn, pos, heads)
    got = [t.clone() for t in AD.decode_token_step(
        x, p, ckn, cvn, pos, heads, ws, kernel)]
    again = AD.decode_token_step(x, p, ckn, cvn, pos, heads, ws, kernel)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    whole = _decode_errs(got, want)
    blocks, xi = [], x
    for i in range(p.w_qkv.shape[0]):
        args = (AD.layer_params(p, i), ckn[i:i + 1], cvn[i:i + 1], pos,
                heads)
        ref = AD.decode_token_step_reference(xi, *args)
        blocks.append(_decode_errs(AD.decode_token_step(
            xi, *args, kernel=kernel), ref))
        xi = ref[0]
    torch.cuda.synchronize()
    worst = tuple(max(e[j] for e in blocks) for j in range(5))
    ok = (max(whole[1], whole[3]) <= _deep_tol(x.shape[0])
          and all(_decode_ok(e, 'bfloat16') for e in blocks) and same)
    return whole, worst, same, ok


def _deep_tol(b):
    return DECODE_DEEP_TOL_B64 if b > 16 else DECODE_DEEP_TOL


def _plain_own(AD, x, p, ck, cv, pos, heads):
    """How far the plain version moves itself, by _decode_errs, when x
    moves by at most one fp32 ulp (what DECODE_DEEP_TOL allows for)."""
    want = AD.decode_token_step_reference(x, p, ck, cv, pos, heads)
    return _decode_errs(AD.decode_token_step_reference(
        x * (1 + 1e-7), p, ck, cv, pos, heads), want)


def phase_artv_decode():
    """The ART-V decode step's kernels vs the plain version: fp32 and bf16
    at a small shape (2 layers, D 128, 2 heads, B 2, W 256) at pos 1, 64
    and 200 on the default kernel (the phased one); at full width (12
    layers, D 768, 12 heads, caches W 626 from a seed) fp32 at pos 370;
    both bf16 kernels (the phased one, the route, and the streaming one,
    forced) at B 1, 5 and 64 at pos 0 and 1, beside the plain version's
    own move under a one-ulp move of x, and at B 16, pos 115 (the first
    step), 370 (the mean) and 625 (the last); block by block and whole,
    with the cache rows >= pos NaN and two calls bitwise equal, timed in
    turns at B 16; both at B 64, pos 370, timed."""
    import torch
    from mmvid_tpu_torch.ops import artv_decode as AD

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    cases = [(2, 2, 256, 128, 2, dt, pos)
             for dt in (torch.float32, torch.bfloat16) for pos in (1, 64, 200)]
    cases.append((12, 16, 626, 768, 12, torch.float32, 370))
    for n_layers, b, w, d, heads, dtype, pos in cases:
        g = torch.Generator(device=dev).manual_seed(pos)
        x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, dtype, g, dev)
        got = AD.decode_token_step(x, p, ck, cv, pos, heads)
        want = AD.decode_token_step_reference(x, p, ck, cv, pos, heads)
        torch.cuda.synchronize()
        errs = _decode_errs(got, want)
        name = str(dtype).split('.')[-1]
        ok = _decode_ok(errs, name)
        print(f'[artv_decode] L{n_layers} B{b} W{w} D{d} H{heads} {name} pos '
              f'{pos} (phased kernel): max abs err y {errs[0]:.3e} '
              f'({errs[1]:.3e} of 1 + |plain|), k/v {errs[4]:.3e} '
              f'({errs[2]:.2f} bf16 ulps) (within tolerance: {ok})',
              flush=True)
        if not ok:
            fail(f'ART-V decode L{n_layers} {name} pos {pos} beyond '
                 f'tolerance')
    n_layers, w, d, heads = 12, 626, 768, 12
    edge = {}
    for b in (1, 5, 64):
        g = torch.Generator(device=dev).manual_seed(100 + b)
        x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, torch.bfloat16,
                                        g, dev)
        ws = AD.DecodeWorkspace(p, b, heads)
        for pos in (0, 1):
            own = _plain_own(AD, x, p, ck, cv, pos, heads)
            row = {'plain_own_rel_err': own[1],
                   'plain_own_kv_rel_err': own[3]}
            for kernel in AD.KERNELS:
                whole, worst, same, ok = _decode_full_width(
                    AD, x, p, ck, cv, pos, heads, ws, kernel)
                row[kernel] = {'rel_err': whole[1], 'kv_rel_err': whole[3],
                               'block_kv_ulps': worst[2],
                               'bitwise_repeat': same}
                print(f'[artv_decode] L12 B{b} W626 D768 H12 bfloat16 pos '
                      f'{pos} ({kernel} kernel, rows >= pos NaN): whole step '
                      f'y {whole[1]:.3e}, k/v {whole[3]:.3e} of 1 + |plain| '
                      f'(tol {_deep_tol(b)}; the plain version with x '
                      f'moved by one fp32 ulp: y {own[1]:.3e}, k/v '
                      f'{own[3]:.3e}); block by block y {worst[1]:.3e}, k/v '
                      f'{worst[2]:.2f} bf16 ulps; two calls bitwise equal: '
                      f'{same} (within tolerance: {ok})', flush=True)
                if not ok:
                    fail(f'ART-V decode bf16 {kernel} B{b} pos {pos} beyond '
                         f'tolerance or not repeatable')
            edge[f'B{b}_pos{pos}'] = row
    g = torch.Generator(device=dev).manual_seed(17)
    b = 16
    x, p, ck, cv = AD.random_inputs(n_layers, b, w, d, torch.bfloat16, g,
                                    dev)
    ws = AD.DecodeWorkspace(p, b, heads)
    by_pos = {}
    for pos in (115, 370, 625):
        own = _plain_own(AD, x, p, ck, cv, pos, heads)
        whole, worst, same, ok = _decode_full_width(AD, x, p, ck, cv, pos,
                                                    heads, ws, 'stream')
        pwhole, pworst, psame, pok = _decode_full_width(
            AD, x, p, ck, cv, pos, heads, ws, 'phased')
        # in turns: streaming, phased, phased, streaming
        t = {'stream': [], 'phased': []}
        for kernel in ('stream', 'phased', 'phased', 'stream'):
            t[kernel].append(cuda_time_ms(lambda: AD.decode_token_step(
                x, p, ck, cv, pos, heads, ws, kernel)))
        ms, ms_phased = min(t['stream']), min(t['phased'])
        plain_ms = cuda_time_ms(lambda: AD.decode_token_step_reference(
            x, p, ck, cv, pos, heads), calls=5, reps=3)
        bms, by = decode_bound(n_layers, b, d, pos)
        print(f'[artv_decode] L12 B16 W626 D768 H12 bfloat16 pos {pos}: '
              f'streaming kernel: block by block max abs err y '
              f'{worst[0]:.3e} ({worst[1]:.3e} of 1 + |plain|), k/v '
              f'{worst[2]:.2f} bf16 ulps; whole step y {whole[0]:.3e} '
              f'({whole[1]:.3e}), k/v {whole[3]:.3e} of 1 + |plain|, '
              f'bitwise repeat {same} (within tolerance: {ok}); phased '
              f'kernel: whole y {pwhole[1]:.3e}, blocks {pworst[2]:.2f} '
              f'ulps ({pok}); the plain version with x moved by one fp32 '
              f'ulp: y {own[1]:.3e} of 1 + |plain|, k/v {own[2]:.2f} bf16 '
              f'ulps; streaming {ms:.4f} ms ({t["stream"]}) phased '
              f'{ms_phased:.4f} ms ({t["phased"]}) plain {plain_ms:.4f} ms '
              f'bound {bms:.4f} ms ({by})', flush=True)
        if not (ok and pok):
            fail(f'ART-V decode bf16 full width pos {pos} beyond tolerance '
                 f'or not repeatable')
        # the main path takes the phased kernel: its numbers lead, the
        # streaming kernel's stand beside them
        by_pos[pos] = {'max_abs_err': pwhole[0], 'rel_err': pwhole[1],
                       'block_max_abs_err': pworst[0],
                       'block_kv_ulps': pworst[2], 'bitwise_repeat': psame,
                       'plain_own_rel_err': own[1],
                       'plain_own_kv_ulps': own[2], 'ms': ms_phased,
                       'plain_ms': plain_ms, 'library_ms': None,
                       'bound_ms': bms, 'bound_by': by,
                       'stream': {'ms': ms, 'max_abs_err': whole[0],
                                  'rel_err': whole[1],
                                  'block_kv_ulps': worst[2],
                                  'bitwise_repeat': same}}
    # B 64 at pos 370, where the streaming kernel measured faster (PERF.md;
    # no path runs it there), in turns
    g = torch.Generator(device=dev).manual_seed(64)
    x64, p64, ck64, cv64 = AD.random_inputs(n_layers, 64, w, d,
                                            torch.bfloat16, g, dev)
    ws64 = AD.DecodeWorkspace(p64, 64, heads)
    t = {'stream': [], 'phased': []}
    for kernel in ('stream', 'phased', 'phased', 'stream'):
        t[kernel].append(cuda_time_ms(lambda: AD.decode_token_step(
            x64, p64, ck64, cv64, 370, heads, ws64, kernel)))
    b64 = {'stream_ms': min(t['stream']), 'phased_ms': min(t['phased']),
           'bound_ms': decode_bound(n_layers, 64, d, 370)[0]}
    print(f'[artv_decode] L12 B64 W626 D768 H12 bfloat16 pos 370: streaming '
          f'{b64["stream_ms"]:.4f} ms ({t["stream"]}) phased '
          f'{b64["phased_ms"]:.4f} ms ({t["phased"]}) bound '
          f'{b64["bound_ms"]:.4f} ms', flush=True)
    del x64, p64, ck64, cv64, ws64
    # the wrapper's host time a call (200 launches enqueued, no sync):
    # through a workspace (checked and allocated once, as ar_sample calls
    # it) and without one (checks and allocations every call)
    host = {}
    for tag, wsp in (('workspace', ws), ('no_workspace', None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            AD.decode_token_step(x, p, ck, cv, 370, heads, wsp)
        host[tag] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
    print(f'[artv_decode] wrapper host time a call at pos 370: '
          f'{host["workspace"]:.4f} ms through a workspace, '
          f'{host["no_workspace"]:.4f} ms without', flush=True)
    mid = by_pos[370]
    return (max(e['max_abs_err'] for e in by_pos.values()), mid['ms'],
            mid['plain_ms'], None, mid['bound_ms'], mid['bound_by']), \
        {'at_pos': by_pos, 'edge_cases': edge, 'b64_pos370': b64,
         'host_ms_per_call': host}


def phase_gridstep():
    """The grid-step probe vs its plain version, and 64 chained calls at
    1, 12 and 192 launches a call: the cost of a launch on this card."""
    import torch
    from mmvid_tpu_torch.ops import gridstep as G

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    g = torch.Generator(device=dev).manual_seed(19)
    x, w = G.probe_inputs(g, dev)
    wt = G.prepare_weights(w)

    def plain():
        y = x
        for _ in range(G.CALLS):
            y = G.probe_call_reference(y, wt)
        return y

    want = plain()
    outs, times = {}, {}
    for n in G.LAUNCHES_PER_CALL:
        outs[n] = G.probe(x, wt, n)
        times[n] = cuda_time_ms(lambda: G.probe(x, wt, n), calls=3)
    torch.cuda.synchronize()
    err = max((o - want).abs().max().item() for o in outs.values())
    same = all(torch.equal(o, outs[1]) for o in outs.values())
    plain_ms = cuda_time_ms(plain, calls=3)
    n1, n12, n192 = G.LAUNCHES_PER_CALL
    per_launch = (times[n192] - times[n12]) / (G.CALLS * (n192 - n12)) * 1e3
    per_barrier = (times[n12] - times[n1]) / (G.CALLS * (n12 - n1)) * 1e3
    d, layers = G.DIM, G.LAYERS
    nbytes = layers * d * d * 2 + 2 * G.BATCH * d * 4
    bms, by = bound(nbytes, 2 * G.BATCH * d * d * layers * G.CALLS, 'bf16')
    print(f'[gridstep] {G.CALLS} chained calls of {layers} layers, x '
          f'[{G.BATCH}, {d}]: max abs err vs plain {err:.3e} (tol '
          f'{PROBE_TOL}), launch structures bitwise equal: {same}; '
          f'1 launch a call {times[n1]:.4f} ms, {n12} {times[n12]:.4f} ms, '
          f'{n192} {times[n192]:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{bms:.4f} ms ({by}); {per_launch:.3f} us per launch, '
          f'{per_barrier:.3f} us per layer launch over a grid barrier',
          flush=True)
    if not (err <= PROBE_TOL and same):
        fail('grid-step probe disagrees with its plain version')
    return (err, times[n1], plain_ms, None, bms, by), {
        'ms_12_launches': times[n12], 'ms_192_launches': times[n192],
        'us_per_launch': per_launch, 'us_per_layer_launch_vs_barrier':
        per_barrier}


def phase_tiny_reference():
    """The tiny model on the card (kernels) against the same weights on the
    CPU (plain versions, the path the CPU tests hold against JAX)."""
    import torch
    from mmvid_tpu_torch import factories

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu, _ = factories.flagship(tiny=True, device='cpu', seed=3)
    gpu, _ = factories.flagship(tiny=True, device='cuda', seed=3)
    cfg = cpu.cfg
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 100, (2, cfg.text_seq_len), generator=g)
    tgt = torch.randint(0, 1025, (2, cfg.target_seq_len), generator=g)
    with torch.no_grad():
        ref = cpu.core(text, None, tgt)
        out = gpu.core(text.cuda(), None, tgt.cuda())
        img_ref = cpu.decode_video(tgt.clamp_max(1023))
        img = gpu.decode_video(tgt.clamp_max(1023).cuda())
    errs = [(a.cpu() - r).abs().max().item()
            for a, r in zip(out[:3], ref[:3])]
    img_err = (img.cpu() - img_ref).abs().max().item()
    print(f'[tiny] logits/rel/vid max abs err {errs}, decode {img_err:.3e} '
          f'(tol 1e-3, fp32, TF32 off)', flush=True)
    if not (max(errs) <= 1e-3 and img_err <= 1e-3):
        fail('tiny model on the card disagrees with the CPU')
    _tiny_preserve_and_trace(cpu, gpu, text, g)

    # the tiny text+mask model: cvae ids (codebook with spread, in both)
    # and the forward logits with the visual segment
    cpu, _ = factories.flagship(tiny=True, device='cpu', seed=4,
                                use_cvae=True)
    gpu, _ = factories.flagship(tiny=True, device='cuda', seed=4,
                                use_cvae=True)
    spread = torch.randn((1024, 64), generator=g)
    frames = torch.rand((2, 1, 16, 16, 3), generator=g)
    with torch.no_grad():
        for model in (cpu, gpu):
            model.cvae.model.quantize.embedding.weight.copy_(spread)
        ids = cpu.get_image_tokens(frames, which_vae='cvae')
        ids_gpu = gpu.get_image_tokens(frames.cuda(), which_vae='cvae')
        vis = cpu.prepare_visual_tokens(g, frames, vc_mode='mask_8x8',
                                        face_mode='mask')
        ref = cpu.core(text, vis, tgt)
        out = gpu.core(text.cuda(), vis.cuda(), tgt.cuda())
    n_diff = int((ids_gpu.cpu() != ids).sum())
    errs = [(a.cpu() - r).abs().max().item()
            for a, r in zip(out[:3], ref[:3])]
    print(f'[tiny] text+mask: cvae ids differing {n_diff} of '
          f'{ids.numel()}; logits/rel/vid max abs err {errs} (tol 1e-3)',
          flush=True)
    torch.backends.cudnn.allow_tf32 = True
    if n_diff or not max(errs) <= 1e-3:
        fail('tiny text+mask model on the card disagrees with the CPU')


def _tiny_preserve_and_trace(cpu, gpu, text, g):
    """Under the deterministic hook (argmax sampling, the most confident
    tokens kept), card against CPU: one ``interp`` call preserving a
    source's first frame, and the PNAG trace (``mask_predict_trace``):
    tokens and keep masks equal, the preserved slots holding their
    source."""
    import torch
    from mmvid_tpu_torch.models import mmvid as pm
    from mmvid_tpu_torch.models import sampler as ps

    cfg = cpu.cfg
    src = torch.randint(0, 1024, (2, cfg.target_seq_len), generator=g)
    pmask, N = ps.preserve_layout(cfg, 'long', 1, False)
    spec = dataclasses.replace(ps.build_spec(pm.DEFAULT_MP_CONFIG, N,
                                             steps=6, dynamic=False),
                               deterministic=True)
    build = pm.build_spec
    pm.build_spec = lambda *a, **k: dataclasses.replace(build(*a, **k),
                                                        deterministic=True)
    out = {}
    try:
        with torch.no_grad():
            for model, dev in ((cpu, 'cpu'), (gpu, 'cuda')):
                _, toks = model.generate_images(
                    torch.Generator(device=dev), text.to(dev),
                    preserve=src.to(dev), long_mode='interp',
                    mask_predict_steps=6, dynamic=False, decode=False)
                trace = ps.mask_predict_trace(
                    model.core, model.core.control_embedding(text.to(dev)),
                    torch.Generator(device=dev), spec, pmask)
                out[dev] = [toks.cpu()] + [t.cpu() for t in trace]
    finally:
        pm.build_spec = build
    imask, _ = ps.preserve_layout(cfg, 'interp', 1, True)
    want = ps.arrange_preserve_tokens(cfg, src, 'interp', 1)
    same = [torch.equal(a, b) for a, b in zip(out['cpu'], out['cuda'])]
    held = torch.equal(out['cuda'][0][:, imask], want[:, imask])
    print(f'[tiny] deterministic hook, card vs CPU: interp tokens equal '
          f'{same[0]}, preserved slots held {held}; trace tokens / keep '
          f'masks / final equal {same[1:]}', flush=True)
    if not (all(same) and held):
        fail('tiny preserved interp call or PNAG trace: the card differs '
             'from the CPU')


def phase_tiny_artv():
    """The tiny fp32 ART-V on the card against the same weights on the
    CPU, each on its default decode path (the card: the stacked step
    through the decode kernel; the CPU: the per-layer step the CPU tests
    hold against JAX): greedy tokens equal."""
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.ops import artv_decode as AD

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, _ = factories.artv_tiny(device='cpu', seed=3)
    gpu, _ = factories.artv_tiny(device='cuda', seed=3)
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 50, (2, cpu.cfg.text_seq_len), generator=g)
    before = AD.launches
    _, want = cpu.generate_images(torch.Generator().manual_seed(0), text,
                                  temperature=1e-6, decode=False)
    cpu_steps = AD.launches - before
    _, got = gpu.generate_images(
        torch.Generator(device='cuda').manual_seed(0), text.cuda(),
        temperature=1e-6, decode=False)
    steps = AD.launches - before
    n_diff = int((got.cpu() != want).sum())
    print(f'[tiny] ART-V fp32 greedy, default paths: tokens differing card '
          f'vs CPU {n_diff} of {want.numel()} ({steps} decode-kernel steps '
          f'on the card, {cpu_steps} counted on the CPU)', flush=True)
    if n_diff or cpu_steps or steps != cpu.cfg.target_seq_len - 1:
        fail('tiny ART-V on the card disagrees with the CPU')


def _spread_codebook(models, seed):
    """One randn codebook (spread: the random-init one has near-ties) in
    each model's vae."""
    import torch
    with torch.no_grad():
        w = models[0].vae.model.quantize.embedding.weight
        cb = torch.randn(w.shape, generator=torch.Generator().manual_seed(
            seed))
        for m in models:
            m.vae.model.quantize.embedding.weight.copy_(cb)


def _param_gap(a, b, dim, lr_sum):
    """(max |a - b| over the parameters, the key biases' elements apart;
    the key biases' max), ``_hold_params``' split."""
    import torch
    gap, key_gap = 0.0, 0.0
    for (name, p), q in zip(a.items(), b.values()):
        d = (p.detach().cpu() - q.detach().cpu()).abs()
        if name.endswith('attn.in_proj_bias'):
            key_gap = max(key_gap, d[dim:2 * dim].max().item())
            d = torch.cat([d[:dim], d[2 * dim:]])
        gap = max(gap, d.max().item())
    return gap, key_gap


def phase_tiny_train():
    """The tiny fp32 training build takes 3 steps on the card (the
    attention kernel's forward, the nearest-code kernel) and on the CPU
    (the plain versions) from the same weights, batch and draws (drawn on
    the CPU), TF32 off for matmuls and cuDNN convolutions: token ids
    equal, losses within TRAIN_LOSS_TOL, parameters within
    TRAIN_PARAM_TOL (the key biases within 3 x the summed lr); launch
    counts a step exact.  Then ART-V's tiny build one step the same
    way."""
    import torch
    from mmvid_tpu_torch import breakdown, factories, training
    from mmvid_tpu_torch.models.masking import sample_msm_mask
    from mmvid_tpu_torch.models.warp import warp_draws

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = training.TrainConfig(lr_scheduler='none', learning_rate=1e-3,
                              rel_no_fully_masked=True, dropout_vc=0.0)
    models = [factories.flagship_train(tiny=True, dtype=torch.float32,
                                       device=dev, seed=5, remat=True)[0]
              for dev in ('cpu', 'cuda')]
    _spread_codebook(models, 5)
    cfg = models[0].cfg
    batch = breakdown.train_batch(models[0], 4, 'cpu')
    g = torch.Generator().manual_seed(6)
    draws = [{'keep': k, 'nfm': n,
              'warp': warp_draws(g, 4, cfg.num_targets,
                                 tc.vid_strategy_prob)}
             for k, n in (sample_msm_mask(g, cfg, tc.msm_strategy_prob,
                                          tc.msm_bernoulli_prob, batch=4)
                          for _ in range(3))]
    ids = [m.get_image_tokens(batch['target'].to(dev)).cpu()
           for m, dev in zip(models, ('cpu', 'cuda'))]
    n_diff = int((ids[0] != ids[1]).sum())
    runs = []
    reset_counts()
    with _LaunchCapture(BACKWARD_SITES) as cap:
        for model, dev in zip(models, ('cpu', 'cuda')):
            state = training.create_train_state(model, tc)
            step = training.make_train_step(model, tc)
            to = (lambda t: t.to(dev)) if dev == 'cuda' else (lambda t: t)
            mv = lambda d: {k: (to(v) if torch.is_tensor(v) else
                                {kk: to(vv) for kk, vv in v.items()})
                            for k, v in d.items()}
            losses = []
            for i in range(3):
                state, m = step(state, {k: to(v) for k, v in batch.items()},
                                None, draws=mv(draws[i]))
                losses.append(m['loss'].item())
            runs.append((state, losses))
    counts = read_counts()
    bl = backward_launches()
    want = expected(attention=3 * 3 * cfg.clip.layers * 2, codebook=3 * 2)
    # the card's backward calls: 3 forwards x the layers, a step
    want_bl = 3 * 3 * cfg.clip.layers
    loss_gap = max(abs(a - b) for a, b in zip(runs[0][1], runs[1][1]))
    gap, key_gap = _param_gap(runs[0][0].params, runs[1][0].params,
                              cfg.dim, 3 * tc.learning_rate)
    print(f'[tiny train] flagship fp32, 3 steps card vs CPU: target ids '
          f'differing {n_diff} of {ids[0].numel()}; losses {runs[1][1]} '
          f'(CPU {runs[0][1]}), max gap {loss_gap:.3e} (tol '
          f'{TRAIN_LOSS_TOL}); parameters max gap {gap:.3e} (tol '
          f'{TRAIN_PARAM_TOL}), key biases {key_gap:.3e} (bound '
          f'{9 * tc.learning_rate:.1e}); launches {counts} (expected '
          f'{want}), attention backward kernel launches {bl} (expected '
          f'{want_bl})', flush=True)
    if n_diff or not loss_gap <= TRAIN_LOSS_TOL:
        fail('tiny training step on the card disagrees with the CPU')
    if not (gap <= TRAIN_PARAM_TOL and key_gap <= 9 * tc.learning_rate):
        fail('tiny training step: parameters on the card disagree with '
             'the CPU')
    if counts != want or bl != want_bl:
        fail(f'tiny training launches {counts}, backward {bl} != {want}, '
             f'{want_bl}')
    check_captured('tiny train', cap, {'attention_backward': bl})

    models = [factories.artv_train(tiny=True, dtype=torch.float32,
                                   device=dev, seed=5)[0]
              for dev in ('cpu', 'cuda')]
    _spread_codebook(models, 6)
    tca = training.TrainConfig(beta_msm=1.0, lr_scheduler='none',
                               learning_rate=1e-3, dropout_vc=0.0)
    batch = breakdown.train_batch(models[0], 2, 'cpu')
    out = []
    reset_counts()
    with _LaunchCapture(BACKWARD_SITES) as cap:
        for model, dev in zip(models, ('cpu', 'cuda')):
            state = training.create_train_state(model, tca)
            state, m = training.make_train_step(model, tca)(
                state, {k: v.to(dev) for k, v in batch.items()}, None)
            out.append((state, m['loss'].item()))
    counts = read_counts()
    bl = backward_launches()
    want = expected(attention=models[0].cfg.clip.layers, codebook=1)
    gap, key_gap = _param_gap(out[0][0].params, out[1][0].params,
                              models[0].cfg.dim, tca.learning_rate)
    loss_gap = abs(out[0][1] - out[1][1])
    print(f'[tiny train] ART-V fp32, 1 step card vs CPU: loss {out[1][1]} '
          f'(CPU {out[0][1]}), gap {loss_gap:.3e}; parameters max gap '
          f'{gap:.3e}, key biases {key_gap:.3e}; launches {counts} '
          f'(expected {want}), attention backward kernel launches {bl} '
          f'(expected {models[0].cfg.clip.layers})', flush=True)
    if not (loss_gap <= TRAIN_LOSS_TOL and gap <= TRAIN_PARAM_TOL
            and key_gap <= 3 * tca.learning_rate):
        fail('tiny ART-V training step on the card disagrees with the CPU')
    torch.backends.cudnn.allow_tf32 = True
    if counts != want or bl != models[0].cfg.clip.layers:
        fail(f'tiny ART-V training launches {counts}, backward {bl} != '
             f'{want}, {models[0].cfg.clip.layers}')
    check_captured('tiny train ART-V', cap, {'attention_backward': bl})


SPEC_KS = (1, 4, 8)
# the sampled-distribution test of tests/test_artv_spec.py (800 lanes, a
# 32-token vocabulary): the pooled two-sample chi^2 of each position's
# counts (31 degrees of freedom, alpha about 1e-4) and the max TV
# within max(1.3 x the baseline's split-half TV, 0.10)
SPEC_LANES, SPEC_CHI2, SPEC_TV_FACTOR, SPEC_TV_FLOOR = 800, 66.6, 1.3, 0.10


def _marginals(tokens, vocab):
    """[R, N] tokens -> [N, vocab] counts a position."""
    import torch
    return torch.stack([torch.bincount(tokens[:, p], minlength=vocab)
                        for p in range(tokens.shape[1])]).double()


def _chi2(c1, c2):
    """Max over positions of the pooled two-sample chi^2 statistic."""
    n1, n2 = c1.sum(1, keepdim=True), c2.sum(1, keepdim=True)
    pooled = (c1 + c2) / (n1 + n2)
    e1, e2 = n1 * pooled, n2 * pooled
    keep = pooled > 0
    stat = (((c1 - e1) ** 2 / e1.clamp_min(1e-30))
            + ((c2 - e2) ** 2 / e2.clamp_min(1e-30))) * keep
    return stat.sum(1).max().item()


def _tv_counts(c1, c2):
    p, q = c1 / c1.sum(1, keepdim=True), c2 / c2.sum(1, keepdim=True)
    return (0.5 * (p - q).abs().sum(1)).max().item()


def phase_tiny_artv_spec():
    """ART-V's exact speculative decode (``ar_sample_spec``) with the tiny
    fp32 model on the card: greedy tokens equal to ``ar_sample``'s on the
    card's default step (the decode kernel) and with MMVID_ARTV_FUSED=0,
    for k 1, 4 and 8; forced acceptance commits ceil(127 / (k + 1)) chunks
    a lane; and at temperature 1, on a 32-token vocabulary, 800 lanes of
    the speculative path against 800 of the baseline, each drawn from a
    CUDA generator (the chi^2 and TV bounds above)."""
    import dataclasses
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.models import artv as partv
    from mmvid_tpu_torch.models.artv_spec import ar_sample_spec
    from mmvid_tpu_torch.ops import artv_decode as AD

    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = factories.artv_tiny(device='cuda', seed=3)
    cfg = model.cfg
    g = torch.Generator().manual_seed(3)
    text = torch.randint(1, 50, (2, cfg.text_seq_len), generator=g).cuda()
    visual = torch.randint(0, cfg.num_image_tokens, (2, cfg.visual_seq_len),
                           generator=g).cuda()
    n_loop = cfg.target_seq_len - 1
    base = {}
    for tag, gate in (('kernel', None), ('per-layer', '0')):
        if gate:
            os.environ['MMVID_ARTV_FUSED'] = gate
        try:
            before = AD.launches
            base[tag] = partv.ar_sample(
                model.core, text, visual,
                torch.Generator(device='cuda').manual_seed(1),
                temperature=1e-6)
            steps = AD.launches - before
        finally:
            os.environ.pop('MMVID_ARTV_FUSED', None)
        if steps != (n_loop if gate is None else 0):
            fail(f'tiny ART-V baseline ({tag}) ran {steps} decode-kernel '
                 f'steps')
    diffs = {}
    for k in SPEC_KS:
        toks, steps = ar_sample_spec(
            model.core, text, visual,
            torch.Generator(device='cuda').manual_seed(2), k,
            temperature=1e-6)
        diffs[k] = {tag: int((toks != b).sum()) for tag, b in base.items()}
        os.environ['MMVID_ARTV_SPEC_FORCE'] = '1'
        try:
            _, forced = ar_sample_spec(
                model.core, text, visual,
                torch.Generator(device='cuda').manual_seed(2), k)
        finally:
            os.environ.pop('MMVID_ARTV_SPEC_FORCE', None)
        want = -(-n_loop // (k + 1))
        print(f'[tiny spec] k={k} fp32 greedy: tokens differing from '
              f'ar_sample {diffs[k]} of {toks.numel()}; chunks {steps.tolist()}'
              f'; forced acceptance {forced.tolist()} chunks (expected '
              f'{want})', flush=True)
        if any(diffs[k].values()):
            fail(f'speculative greedy tokens differ from ar_sample at k={k}')
        if forced.tolist() != [want] * 2:
            fail(f'forced acceptance ran {forced.tolist()} chunks, not {want}')

    # the sampled distribution: 32 tokens, 4 x 4 a frame, 2 frames
    pcfg = dataclasses.replace(cfg, num_image_tokens=32, image_fmap_size=4,
                               image_size=16)
    small = partv.ArtvModel(pcfg, vae=None)
    factories.init_weights(small, torch.Generator().manual_seed(0))
    small = small.cuda().eval()
    g = torch.Generator().manual_seed(7)
    text = torch.randint(1, 50, (1, pcfg.text_seq_len), generator=g).expand(
        SPEC_LANES, -1).cuda()
    visual = torch.randint(0, 32, (1, pcfg.visual_seq_len), generator=g
                           ).expand(SPEC_LANES, -1).cuda()
    os.environ['MMVID_ARTV_FUSED'] = '0'   # 800 lanes: past B5's batch
    try:
        base = partv.ar_sample(small.core, text, visual,
                               torch.Generator(device='cuda').manual_seed(5))
    finally:
        os.environ.pop('MMVID_ARTV_FUSED', None)
    spec, steps = ar_sample_spec(small.core, text, visual,
                                 torch.Generator(device='cuda').manual_seed(6),
                                 4)
    c_base, c_spec = _marginals(base, 32), _marginals(spec, 32)
    chi2 = _chi2(c_base, c_spec)
    half = _tv_counts(_marginals(base[:SPEC_LANES // 2], 32),
                      _marginals(base[SPEC_LANES // 2:], 32))
    cross = _tv_counts(c_base, c_spec)
    tv_bound = max(SPEC_TV_FACTOR * half, SPEC_TV_FLOOR)
    print(f'[tiny spec] k=4 temperature 1, {SPEC_LANES} lanes, 32 tokens: '
          f'chi2 {chi2:.2f} (< {SPEC_CHI2}), TV {cross:.4f} (< {tv_bound:.4f}'
          f', split-half {half:.4f}); tokens a chunk '
          f'{(pcfg.target_seq_len - 1) / steps.double().mean().item():.3f}',
          flush=True)
    if not (chi2 < SPEC_CHI2 and cross < tv_bound):
        fail('the speculative path drifted from the baseline distribution')
    return {'greedy_tokens_differing': diffs, 'chi2': chi2, 'tv': cross,
            'tv_split_half': half}


def report(tag: str, res: dict):
    """Print ``breakdown.measure``'s result: a summary and its JSON."""
    print(f'[{tag}] batch {res["batch"]}, {res["steps"]} steps: '
          f'{res["s_per_batch"]:.4f} s per batch (median of '
          f'{len(res["s_all"])}: {[round(t, 4) for t in res["s_all"]]}), '
          f'{res["frames_per_s"]:.2f} frames/s, peak memory '
          f'{res["peak_memory_bytes"]} B, device idle '
          f'{res["idle_share"]:.4f}', flush=True)
    print(f'[{tag}] breakdown {json.dumps(res)}', flush=True)


def phase_main_path():
    import torch
    from mmvid_tpu_torch import breakdown, generate
    from mmvid_tpu_torch.tokenizer import SimpleTokenizer

    t0 = time.perf_counter()
    model = breakdown.build('flagship')
    tokenizer = SimpleTokenizer()
    torch.cuda.synchronize()
    print(f'[main] flagship built in {time.perf_counter() - t0:.2f} s',
          flush=True)
    cfg = model.cfg
    prompts = breakdown.PROMPTS[:6]
    steps, batch = 20, 4

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = list(generate.generate_videos(model, tokenizer, prompts, batch,
                                            gen, mask_predict_steps=steps,
                                            dynamic=False))
        torch.cuda.synchronize()
        return out

    reset_counts()
    out = run()
    counts = read_counts()
    n_batches = -(-len(prompts) // batch)
    want = expected(attention=cfg.clip.layers * steps * n_batches,
                    sample_head=steps * n_batches)
    print(f'[main] launches {counts} (expected {want})', flush=True)
    if counts != want:
        fail(f'launch counts {counts} != {want}')

    sizes = [len(bt.prompts) for bt in out]
    for bt in out:
        vshape = (len(bt.prompts), cfg.num_targets, cfg.image_size,
                  cfg.image_size, 3)
        if tuple(bt.videos.shape) != vshape:
            fail(f'videos {tuple(bt.videos.shape)} != {vshape}')
        vid = bt.videos.float()
        if not (torch.isfinite(vid).all() and vid.min() >= 0
                and vid.max() <= 1):
            fail('videos not finite or outside [0, 1]')
        if not (bt.tokens.min() >= 0
                and bt.tokens.max() < cfg.num_image_tokens):
            fail('tokens outside the codebook')
    again = run()
    same = all(torch.equal(a.tokens, b.tokens) for a, b in zip(out, again))
    print(f'[main] batches {sizes}, videos {tuple(out[0].videos.shape)}, '
          f'finite in [0,1], tokens < {cfg.num_image_tokens}, same seed '
          f'same tokens: {same}', flush=True)
    if not same:
        fail('the same seed gave different tokens')
    report('main', breakdown.measure(model, 'flagship'))
    del model
    torch.cuda.empty_cache()
    return counts, _flagship_fp32(steps)


def _flagship_fp32(steps: int) -> dict:
    """The flagship in fp32, the released recipes' precision (no script
    passes --bf16): one batch of 16 after a warm-up, through the fp32
    attention route (12 x 20 launches) and the sample head's split-TF32
    route (TF32_HEAD_LAUNCHES x 20); frames/s on the host clock, launch
    counts exact, videos finite in [0, 1]; then one profiled batch:
    device time by kind and the attention kernel's share of the busy
    time."""
    import torch
    from mmvid_tpu_torch import breakdown

    model = breakdown.build('flagship', dtype=torch.float32)
    cfg = model.cfg
    text, _ = breakdown.inputs(model, 'flagship')

    def batch():
        gen = torch.Generator(device='cuda').manual_seed(1)
        out = model.generate_images(gen, text, mask_predict_steps=steps,
                                    dynamic=False)
        torch.cuda.synchronize()
        return out

    batch()
    reset_counts()
    t0 = time.perf_counter()
    videos, seq = batch()[:2]
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = expected(attention=cfg.clip.layers * steps,
                    sample_head=TF32_HEAD_LAUNCHES * steps)
    vid = videos.float()
    if counts != want:
        fail(f'fp32 flagship launch counts {counts} != {want}')
    if not (torch.isfinite(vid).all() and vid.min() >= 0 and vid.max() <= 1
            and seq.min() >= 0 and seq.max() < cfg.num_image_tokens):
        fail('fp32 flagship: videos or tokens out of range')
    prof = breakdown.profile_run(batch)
    attn = prof['device_ms_by_kind'].get('attention kernel, CUDA cores', 0.0)
    res = {'batch': text.shape[0], 'steps': steps, 's_per_batch': dt,
           'frames_per_s': text.shape[0] * cfg.num_targets / dt,
           'launches': counts,
           'attention_share_of_busy': attn / prof['device_busy_ms'],
           **prof}
    print(f'[main fp32] batch {res["batch"]}, {steps} steps: {dt:.4f} s '
          f'per batch, {res["frames_per_s"]:.2f} frames/s; launches '
          f'{counts}; attention kernel {attn:.3f} of '
          f'{prof["device_busy_ms"]:.3f} ms busy '
          f'({res["attention_share_of_busy"]:.4f}), device idle '
          f'{prof["idle_share"]:.4f}', flush=True)
    print(f'[main fp32] breakdown {json.dumps(res)}', flush=True)
    del model
    torch.cuda.empty_cache()
    return res


def phase_text_mask():
    """The text+mask recipe at full width: cvae encode of one control frame,
    nearest code, mask_8x8 erase (face_mode 'mask', as utils/viz.py sets
    it at test time), the separate visual embedding, 20 rounds of
    mask-predict over L = 629, VQGAN decode; then the same with
    MMVID_FUSED_LNQKV=1."""
    import torch
    from mmvid_tpu_torch import breakdown

    os.environ.pop('MMVID_FUSED_LNQKV', None)
    t0 = time.perf_counter()
    model = breakdown.build('text_mask')
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f'[text+mask] built in {time.perf_counter() - t0:.2f} s: sequence '
          f'{cfg.total_seq_len}, [ST1]/[VID] at {cfg.st1_tok_index}/'
          f'{cfg.vid_tok_index}, separate visual_emb '
          f'{cfg.use_separate_visual_emb}', flush=True)
    if (cfg.total_seq_len, cfg.st1_tok_index) != (629, 115):
        fail(f'text+mask layout: L {cfg.total_seq_len}, [ST1] at '
             f'{cfg.st1_tok_index}')
    b, steps = breakdown.BATCH, breakdown.STEPS
    text, control = breakdown.inputs(model, 'text_mask', b)

    def run(seed=0):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        out = model.generate_images(gen, text, mask_predict_steps=steps,
                                    dynamic=False, **control)
        torch.cuda.synchronize()
        return out

    reset_counts()
    videos, tokens = run()
    counts = read_counts()
    want = expected(attention=cfg.clip.layers * steps, sample_head=steps,
                    codebook=1)
    print(f'[text+mask] launches {counts} (expected {want})', flush=True)
    if counts != want:
        fail(f'text+mask launch counts {counts} != {want}')
    vid = videos.float()
    vshape = (b, cfg.num_targets, cfg.image_size, cfg.image_size, 3)
    if tuple(vid.shape) != vshape:
        fail(f'text+mask videos {tuple(vid.shape)} != {vshape}')
    if not (torch.isfinite(vid).all() and vid.min() >= 0 and vid.max() <= 1):
        fail('text+mask videos not finite or outside [0, 1]')
    if not (tokens.min() >= 0 and tokens.max() < cfg.num_image_tokens):
        fail('text+mask tokens outside the codebook')
    # the control: cvae ids inside the 6x6 window, [MASK] around it
    vis = model.prepare_visual_tokens(None, **control).view(b, 8, 8)
    inner = vis[:, 1:7, 1:7]
    ring_masked = int((vis == cfg.mask_token).sum()) == b * (64 - 36)
    if not (ring_masked and inner.max() < cfg.num_image_tokens):
        fail('text+mask control tokens are not the mask_8x8 pattern')
    _, again = run()
    same = torch.equal(tokens, again)
    print(f'[text+mask] videos {vshape}, finite in [0,1], tokens < '
          f'{cfg.num_image_tokens}, control = mask_8x8 window, same seed '
          f'same tokens: {same}', flush=True)
    if not same:
        fail('text+mask: the same seed gave different tokens')
    report('text+mask', breakdown.measure(model, 'text_mask'))

    os.environ['MMVID_FUSED_LNQKV'] = '1'
    try:
        reset_counts()
        _, ftokens = run()
        fcounts = read_counts()
        fwant = dict(want, fused_ln_qkv=cfg.clip.layers * steps)
        n_diff = int((ftokens != tokens).sum())
        print(f'[text+mask fused] launches {fcounts} (expected {fwant}); '
              f'tokens differing from the gate-off run: {n_diff} of '
              f'{tokens.numel()} (bf16 roundings of h may flip)', flush=True)
        if fcounts != fwant:
            fail(f'fused launch counts {fcounts} != {fwant}')
        if not (ftokens.min() >= 0 and ftokens.max() < cfg.num_image_tokens):
            fail('fused path tokens outside the codebook')
        report('text+mask fused', breakdown.measure(model, 'text_mask'))
    finally:
        os.environ.pop('MMVID_FUSED_LNQKV', None)
    return counts, fcounts


def _check_videos(tag, cfg, videos, tokens):
    import torch
    vid = videos.float()
    vshape = (tokens.shape[0], cfg.num_targets, cfg.image_size,
              cfg.image_size, 3)
    if tuple(vid.shape) != vshape:
        fail(f'{tag} videos {tuple(vid.shape)} != {vshape}')
    if not (torch.isfinite(vid).all() and vid.min() >= 0 and vid.max() <= 1):
        fail(f'{tag} videos not finite or outside [0, 1]')
    if not (tokens.min() >= 0 and tokens.max() < cfg.num_image_tokens):
        fail(f'{tag} tokens outside the codebook')


def _artv_host_per_token(model):
    """The ART-V sampler's time a token on the host clock: from a
    synchronised start until ``generate_images(decode=False)`` returns
    (the host has enqueued every token; it waits only when the launch
    queue is full), and until the device is done."""
    import torch
    from mmvid_tpu_torch import breakdown
    text, _ = breakdown.inputs(model, 'artv', breakdown.BATCH)
    steps = model.cfg.target_seq_len - 1
    gen = torch.Generator(device='cuda').manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.generate_images(gen, text, decode=False)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {'enqueue_ms_per_token': (t1 - t0) / steps * 1e3,
            'wall_ms_per_token': (t2 - t0) / steps * 1e3}


def phase_artv():
    """ART-V at full width (the text-to-video flags with --ar: 768 x 12
    layers, control prefix 115, 511 decode steps, cache widths 179 ..
    626): the 16 prompts in one batch through generate.generate_videos,
    first on the card's default path (the stacked step through the decode
    kernel), then with MMVID_ARTV_FUSED=0 (the per-layer step in plain
    torch ops)."""
    import torch
    from mmvid_tpu_torch import breakdown, generate
    from mmvid_tpu_torch.tokenizer import SimpleTokenizer

    t0 = time.perf_counter()
    model = breakdown.build('artv')
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f'[artv] built in {time.perf_counter() - t0:.2f} s: sequence '
          f'{cfg.total_seq_len}, control prefix {cfg.control_seq_len + 1}, '
          f'vocabulary {cfg.total_tokens}', flush=True)
    if (cfg.total_seq_len, cfg.control_seq_len + 1,
            cfg.total_tokens) != (626, 115, 51570):
        fail('ART-V layout differs from the text-to-video recipe with --ar')
    tokenizer = SimpleTokenizer()
    steps = cfg.target_seq_len - 1

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = list(generate.generate_videos(model, tokenizer,
                                            breakdown.PROMPTS,
                                            breakdown.BATCH, gen))
        torch.cuda.synchronize()
        return out[0]

    counts, tokens = {}, {}
    for tag, gate in (('artv', None), ('artv per-layer', '0')):
        if gate is None:
            os.environ.pop('MMVID_ARTV_FUSED', None)
        else:
            os.environ['MMVID_ARTV_FUSED'] = gate
        try:
            reset_counts()
            t0 = time.perf_counter()
            out = run()
            dt = time.perf_counter() - t0
            counts[tag] = read_counts()
            want = expected(artv_decode=steps if gate is None else 0)
            print(f'[{tag}] launches {counts[tag]} (expected {want}); first '
                  f'batch {dt:.3f} s', flush=True)
            if counts[tag] != want:
                fail(f'{tag} launch counts {counts[tag]} != {want}')
            _check_videos(tag, cfg, out.videos, out.tokens)
            tokens[tag] = out.tokens
            if gate is None:
                same = torch.equal(out.tokens, run().tokens)
                print(f'[{tag}] videos {tuple(out.videos.shape)}, finite in '
                      f'[0,1], tokens < {cfg.num_image_tokens}, same seed '
                      f'same tokens: {same}', flush=True)
                if not same:
                    fail(f'{tag}: the same seed gave different tokens')
                host = _artv_host_per_token(model)
                print(f'[{tag}] a batch of 16 without decode: '
                      f'{host["enqueue_ms_per_token"]:.4f} ms a token on the '
                      f'host clock until the last launch is enqueued, '
                      f'{host["wall_ms_per_token"]:.4f} ms a token until '
                      f'the device is done', flush=True)
                report(tag, breakdown.measure(model, 'artv'))
            else:
                # host-bound at seconds a batch: one timed call of each,
                # the batch above its warm-up
                print(f'[{tag}] videos {tuple(out.videos.shape)}, finite in '
                      f'[0,1], tokens < {cfg.num_image_tokens}', flush=True)
                report(tag, breakdown.measure(model, 'artv', reps=1,
                                              warm=False))
        finally:
            os.environ.pop('MMVID_ARTV_FUSED', None)
    n_diff = int((tokens['artv'] != tokens['artv per-layer']).sum())
    print(f'[artv] tokens differing between the kernel and the per-layer '
          f'runs under one seed: {n_diff} of {tokens["artv"].numel()} (bf16 '
          f'roundings flip near-ties, and a flipped token changes every '
          f'later step of its row)', flush=True)
    return counts['artv'], counts['artv per-layer']


def phase_artv_spec():
    """ART-V's exact speculative decode at full width (``MMVID_ARTV_SPEC=8``,
    bf16, batch 16), with one control frame a prompt through the cvae, so
    the nearest-code kernel runs on the path, and its tokens draft frame
    0: one greedy batch through ``ArtvModel.generate_images(visual=frames,
    temperature=1e-6, spec_stats=True)`` (launch counts: the codebook
    kernel once, the decode kernel never, as in JAX; output checks; the
    tokens a chunk), then ``breakdown.measure`` of the floor at
    temperature 1 (random weights accept almost no draft; one timed batch,
    whose runs under one seed must give the same tokens) and of the
    ceiling under MMVID_ARTV_SPEC_FORCE=1; and the share of the greedy
    tokens equal to the per-layer baseline's (MMVID_ARTV_FUSED=0),
    reported, not gated: near-ties of random weights in bf16 flip."""
    import torch
    from mmvid_tpu_torch import breakdown

    t0 = time.perf_counter()
    model = breakdown.build('artv_spec')
    torch.cuda.synchronize()
    cfg = model.cfg
    print(f'[artv spec] built in {time.perf_counter() - t0:.2f} s: k '
          f'{breakdown.SPEC_K}, control prefix {cfg.control_seq_len + 1}, '
          f'a cvae: {model.cvae is not None}', flush=True)
    text, control = breakdown.inputs(model, 'artv_spec', breakdown.BATCH)
    frames = control['visual']
    n_loop = cfg.target_seq_len - 1

    def greedy(**kw):
        gen = torch.Generator(device='cuda').manual_seed(0)
        out = model.generate_images(gen, text, visual=frames,
                                    temperature=1e-6, **kw)
        torch.cuda.synchronize()
        return out

    os.environ['MMVID_ARTV_SPEC'] = str(breakdown.SPEC_K)
    try:
        reset_counts()
        t0 = time.perf_counter()
        videos, tokens, steps = greedy(spec_stats=True)
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = expected(codebook=1)
        tpc = n_loop / steps.double().mean().item()
        print(f'[artv spec] launches {counts} (expected {want}); greedy batch '
              f'{dt:.3f} s; spec acceptance {tpc:.3f} tokens/chunk (ceiling '
              f'{breakdown.SPEC_K + 1})', flush=True)
        if counts != want:
            fail(f'artv spec launch counts {counts} != {want}')
        _check_videos('artv spec', cfg, videos, tokens)
        print(f'[artv spec] videos {tuple(videos.shape)}, finite in [0,1], '
              f'tokens < {cfg.num_image_tokens}', flush=True)
        # temperature 1, seconds a batch: one timed batch
        floor = breakdown.measure(model, 'artv_spec', reps=1, warm=False)
        report('artv spec floor', floor)
        if not floor['same_tokens_across_runs']:
            fail('artv spec: the same seed gave different tokens')
        os.environ['MMVID_ARTV_SPEC_FORCE'] = '1'
        try:
            ceiling = breakdown.measure(model, 'artv_spec')
        finally:
            os.environ.pop('MMVID_ARTV_SPEC_FORCE', None)
        report('artv spec ceiling', ceiling)
    finally:
        os.environ.pop('MMVID_ARTV_SPEC', None)
    print(f'[artv spec] temperature 1: {floor["tokens_per_chunk"]:.4f} tokens '
          f'a chunk at the floor, {ceiling["tokens_per_chunk"]:.4f} forced; '
          f'same seed same tokens: {floor["same_tokens_across_runs"]}',
          flush=True)
    os.environ['MMVID_ARTV_FUSED'] = '0'
    try:
        base = greedy(decode=False)[1]
    finally:
        os.environ.pop('MMVID_ARTV_FUSED', None)
    equal = tokens == base
    first = (int((~equal).any(0).nonzero()[0]) if not equal.all()
             else None)
    print(f'[artv spec] greedy bf16: share of tokens equal to the per-layer '
          f'baseline {equal.double().mean().item():.4f}, first differing '
          f'position {first} (not gated: bf16 near-ties of random weights)',
          flush=True)
    return counts, {'floor': floor, 'ceiling': ceiling,
                    'greedy_equal_share': equal.double().mean().item(),
                    'greedy_first_difference': first}


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def phase_int8_serving():
    """The slice's path at full width: the flagship (bf16, seed 0)
    calibrated by ``ops.int8.quantize_for_serving`` (w8a8 backbone and
    VQGAN decoder) under MMVID_ATTN_INT8=1, batch 16, 20 rounds,
    ``dynamic=False``: the JAX package's gates against the bf16 model
    (logits of one forward; the decoder, ``_int8_decoder_checks``), launch
    counts, output checks, determinism by seed, then
    ``breakdown.measure``."""
    import torch
    from mmvid_tpu_torch import breakdown
    from mmvid_tpu_torch.ops.int8 import quantize_for_serving

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    model = breakdown.build('flagship')
    cfg = model.cfg
    g = torch.Generator(device='cuda').manual_seed(21)
    text4, _ = breakdown.inputs(model, 'flagship', 4)
    target = torch.randint(0, cfg.num_image_tokens,
                           (4, cfg.target_seq_len), generator=g,
                           device='cuda')
    ids = torch.randint(0, cfg.num_image_tokens, (8, cfg.image_seq_len),
                        generator=g, device='cuda')
    with torch.no_grad():
        logits_bf16 = model.core(text4, None, target)[0]
    _set_attn_int8(True)
    try:
        qmodel = quantize_for_serving(
            model, generator=torch.Generator(device='cuda').manual_seed(0))
        torch.cuda.synchronize()
        print(f'[int8] flagship built and calibrated in '
              f'{time.perf_counter() - t0:.2f} s: backbone scales '
              f'{qmodel.cfg.clip.int8_scales[0]} (layer 0) .. '
              f'{qmodel.cfg.clip.int8_scales[-1]} (layer '
              f'{cfg.clip.layers - 1}), {len(qmodel.vae.cfg.int8_scales)} '
              f'decoder sites', flush=True)
        with torch.no_grad():
            logits_int8 = qmodel.core(text4, None, target)[0]
        cos = _cosine(logits_int8, logits_bf16)
        agree = (logits_int8.argmax(-1) == logits_bf16.argmax(-1)
                 ).float().mean().item()
        print(f'[int8] one full-width forward (4 x {cfg.total_seq_len}), int8 '
              f'vs bf16 logits: cosine {cos:.6f} (> {INT8_LOGITS_COS}), '
              f'argmax agreement {agree:.4f} (> {INT8_ARGMAX_AGREE})',
              flush=True)
        if not (cos > INT8_LOGITS_COS and agree > INT8_ARGMAX_AGREE):
            fail('int8 backbone logits too far from the bf16 model\'s')
        decoder = _int8_decoder_checks(model, qmodel, ids)
        b, steps = breakdown.BATCH, breakdown.STEPS
        text, _ = breakdown.inputs(qmodel, 'flagship', b)

        def run(seed=0):
            gen = torch.Generator(device='cuda').manual_seed(seed)
            out = qmodel.generate_images(gen, text, mask_predict_steps=steps,
                                         dynamic=False)
            torch.cuda.synchronize()
            return out

        reset_counts()
        videos, tokens = run()
        counts = read_counts()
        # two int8 launches a call: the operand pass and the attention
        want = expected(attention_int8=2 * cfg.clip.layers * steps,
                        sample_head=steps)
        print(f'[int8] launches {counts} (expected {want})', flush=True)
        if counts != want:
            fail(f'int8 serving launch counts {counts} != {want}')
        _check_videos('int8', cfg, videos, tokens)
        _, again = run()
        same = torch.equal(tokens, again)
        n_diff = int((tokens != run_bf16_tokens(model, text, steps)).sum())
        print(f'[int8] videos {tuple(videos.shape)}, finite in [0,1], tokens '
              f'< {cfg.num_image_tokens}, same seed same tokens: {same}; '
              f'tokens differing from the bf16 model at one seed: {n_diff} '
              f'of {tokens.numel()}', flush=True)
        if not same:
            fail('int8 serving: the same seed gave different tokens')
        res = breakdown.measure(qmodel, 'flagship')
        res['decoder'] = decoder
        res['logits_cosine'], res['argmax_agreement'] = cos, agree
        report('int8', res)
    finally:
        _set_attn_int8(False)
    return counts


# the JAX package's decoder test config (tests/test_int8.py:207-227)
VQ_JAX_TEST = dict(resolution=64, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                   z_channels=64, embed_dim=64, n_embed=256,
                   attn_resolutions=(32,))


def _int8_decoder_checks(model, qmodel, ids):
    """The int8 decoder's checks, on 8 frames of random ids.

    Gated:
    1. Exactness: at every full-width site, the int32 sums of
       ``int8_conv`` on the card (``torch._int_mm`` over gathered windows)
       equal an fp64 convolution of the same int8 values (exact below
       2^53), on the site's own input of one frame.
    2. Each site alone quantized moves the bf16 decoder's [0, 1] images by
       less than the JAX package's bounds (INT8_DECODE_MEAN / _MAX,
       tests/test_int8.py).
    Reported, not gated (PERF.md, section 6): the decoder with every site
    quantized at once against bf16, the same scales on an fp32 copy of
    the weights against fp32, the share of activations beyond their scale,
    and the JAX test's own decoder config (fp32, random calibration, two
    random sequences).  At random weights the method's noise summed over
    the 58 full-width sites passes the JAX bounds in the JAX package too:
    tests/int8_decoder_witness.py runs both packages' quantize_vae_decoder
    on the same full-width weights and ids on the CPU, and the JAX
    package's own int8 decoder reads mean 0.0224-0.0238 against its fp32
    one there, as the port does (PERF.md, section 6)."""
    import torch
    import torch.nn.functional as F
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.models.vqgan import SiteConv, VQGanConfig, VQGanVAE
    from mmvid_tpu_torch.ops.int8 import (int8_conv, quantize_activation,
                                          quantize_vae_decoder, quantized_vae)

    def diff(a, b):
        d = (a.float() - b.float()).abs()
        return d.mean().item(), d.max().item()

    sites = {m.site: m for m in qmodel.vae.modules()
             if isinstance(m, SiteConv) and m.a_scale is not None}
    inputs, saturated = {}, {}

    def hook(mod, args):
        x = args[0]
        inputs[mod.site] = x[:1].clone()
        saturated[mod.site] = (x.float().abs() * (127.0 / mod.a_scale)
                               > 127.5).float().mean().item()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        img_bf16 = model.vae.decode(ids)
        handles = [m.register_forward_pre_hook(hook) for m in sites.values()]
        whole = diff(qmodel.vae.decode(ids), img_bf16)
        for h in handles:
            h.remove()
        inexact = []
        with torch.no_grad():
            for site, conv in sites.items():
                o, c, kh, kw = conv.weight.shape
                # the int8 weights the serving copy froze, and runs
                w_mat = conv.w8[0]
                x_q = quantize_activation(inputs[site], conv.a_scale)
                acc = int8_conv(x_q.permute(0, 2, 3, 1), w_mat, kh, kw)
                ref = F.conv2d(x_q.double(), w_mat.view(o, kh, kw, c).permute(
                    0, 3, 1, 2).double(), padding=(kh // 2, kw // 2))
                if not torch.equal(acc.double(), ref.permute(0, 2, 3, 1)):
                    inexact.append(site)
        per_site = {p: diff(quantized_vae(model.vae, ((p, v),)).decode(ids),
                            img_bf16) for p, v in qmodel.vae.cfg.int8_scales}
        vae32 = VQGanVAE(image_size=model.vae.image_size,
                         cfg=dataclasses.replace(model.vae.cfg,
                                                 int8_scales=None)).cuda()
        vae32.load_state_dict(model.vae.state_dict())
        whole_fp32 = diff(quantized_vae(vae32, qmodel.vae.cfg.int8_scales
                                        ).decode(ids), vae32.decode(ids))
        small = VQGanVAE(image_size=64, cfg=VQGanConfig(**VQ_JAX_TEST)).cuda()
        factories.init_weights(small, torch.Generator().manual_seed(3))
        g = torch.Generator(device='cuda').manual_seed(4)
        qsmall = quantize_vae_decoder(small, generator=g)
        seq = torch.randint(0, 256, (2, small.image_seq_len), generator=g,
                            device='cuda')
        jax_test = diff(qsmall.decode(seq), small.decode(seq))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    worst = max(per_site.items(), key=lambda kv: kv[1][0])
    worst_max = max(per_site.items(), key=lambda kv: kv[1][1])
    print(f'[int8] decoder: int32 sums equal to an fp64 conv at '
          f'{len(sites) - len(inexact)} of {len(sites)} full-width sites; '
          f'each site alone vs bf16: worst mean {worst[1][0]:.5f} '
          f'({worst[0]}), worst max {worst_max[1][1]:.5f} ({worst_max[0]}) '
          f'(bounds {INT8_DECODE_MEAN}, {INT8_DECODE_MAX}); reported: all '
          f'sites at once vs bf16 mean {whole[0]:.5f} max {whole[1]:.5f}, on '
          f'fp32 weights vs fp32 mean {whole_fp32[0]:.5f} max '
          f'{whole_fp32[1]:.5f}, saturated share max '
          f'{max(saturated.values()):.3e}; the JAX test\'s decoder config '
          f'(fp32, random calibration) mean {jax_test[0]:.5f} max '
          f'{jax_test[1]:.5f}', flush=True)
    if inexact:
        fail(f'int8 decoder sums differ from the exact product at {inexact}')
    if not all(m < INT8_DECODE_MEAN and x < INT8_DECODE_MAX
               for m, x in per_site.values()):
        fail('an int8 decoder site moves the full-width decoder too far')
    return {'sites_exact': len(sites) - len(inexact), 'sites': len(sites),
            'per_site_worst_mean': worst, 'per_site_worst_max': worst_max,
            'all_sites_vs_bf16': whole,
            'all_sites_fp32_weights_vs_fp32': whole_fp32,
            'saturated_share_max': max(saturated.values()),
            'jax_test_config': jax_test}


def run_bf16_tokens(model, text, steps):
    """The unquantized model's tokens at seed 0 (MMVID_ATTN_INT8 off)."""
    import torch
    flag = os.environ.pop('MMVID_ATTN_INT8', None)
    try:
        gen = torch.Generator(device='cuda').manual_seed(0)
        return model.generate_images(gen, text, mask_predict_steps=steps,
                                     dynamic=False, decode=False)[1]
    finally:
        if flag is not None:
            os.environ['MMVID_ATTN_INT8'] = flag


def phase_artv_int8():
    """ART-V's int8 decode at full width (``generate_images(int8=True)``:
    int8 weights, head and K/V caches, the per-layer step in torch ops, no
    kernel, as in JAX): one batch of 16 as the warm-up, one timed; output
    checks, the same tokens on one seed, no launch of any kernel."""
    import torch
    from mmvid_tpu_torch import breakdown

    t0 = time.perf_counter()
    model = breakdown.build('artv')
    cfg = model.cfg
    text, _ = breakdown.inputs(model, 'artv', breakdown.BATCH)
    torch.cuda.synchronize()
    print(f'[artv int8] built in {time.perf_counter() - t0:.2f} s',
          flush=True)

    def run():
        gen = torch.Generator(device='cuda').manual_seed(0)
        t0 = time.perf_counter()
        out = model.generate_images(gen, text, int8=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_counts()
    (videos, tokens), warm = run()
    counts = read_counts()
    if counts != expected():
        fail(f'ART-V int8 launched kernels: {counts}')
    _check_videos('artv int8', cfg, videos, tokens)
    torch.cuda.reset_peak_memory_stats()
    (_, again), dt = run()
    peak = torch.cuda.max_memory_allocated()
    same = torch.equal(tokens, again)
    fps = breakdown.BATCH * cfg.num_targets / dt
    print(f'[artv int8] batch 16, 511 steps: {dt:.4f} s a batch (warm-up '
          f'{warm:.4f} s), {fps:.2f} frames/s, peak memory {peak} B; '
          f'launches {counts}; videos finite in [0,1], same seed same '
          f'tokens: {same}', flush=True)
    if not same:
        fail('ART-V int8: the same seed gave different tokens')
    return {'s_per_batch': dt, 'frames_per_s': fps, 'peak_memory_bytes': peak,
            'warmup_s': warm}, counts


def _train_report(tag, res):
    print(f'[{tag}] batch {res["batch"]}: {res["ms"]:.2f} ms a step (mean '
          f'of {res["steps"]} after a warm-up step of {res["warmup_s"]:.2f} '
          f's), {res["videos_s"]:.2f} videos/s, {res["frames_s"]:.2f} '
          f'frames/s, peak memory {res["peak_memory_bytes"]} B, device idle '
          f'{res["idle_share"]:.4f}; losses {res["losses"]}; launches a '
          f'step {res["launches_per_step"]}, attention backward calls a '
          f'step {res["attention_backward_calls_per_step"]} (kernel '
          f'launches {res["attention_backward_launches_per_step"]})',
          flush=True)
    print(f'[{tag}] breakdown {json.dumps(res)}', flush=True)


def _check_train(tag, path, res):
    import math
    if not all(math.isfinite(x) for x in res['losses'] + [res['grad_norm']]):
        fail(f'{tag}: a loss or the gradient norm is not finite')
    want = expected(**TRAIN_LAUNCHES[path])
    if res['launches_per_step'] != want:
        fail(f'{tag}: launches a step {res["launches_per_step"]} != {want}')
    calls = res['attention_backward_calls_per_step']
    if calls != TRAIN_BACKWARD_CALLS[path]:
        fail(f'{tag}: attention backward calls a step {calls} != '
             f'{TRAIN_BACKWARD_CALLS[path]}')
    bl = res['attention_backward_launches_per_step']
    if bl != TRAIN_BACKWARD_CALLS[path]:
        fail(f'{tag}: attention backward kernel launches a step {bl} != '
             f'{TRAIN_BACKWARD_CALLS[path]}')


def phase_train():
    """The flagship's training step at full width (the text-to-video
    recipe: BERT 768 x 12 x 12, sequence 565, the full VQGAN, beta 7 / 0.5
    / 0.5, rel_no_fully_masked, bf16 compute on fp32 parameters, each
    block rematerialised), batch 16, through ``breakdown.measure_train``:
    every loss finite, the launches a step exact (TRAIN_LAUNCHES) and
    attention's backward calls too (TRAIN_BACKWARD_CALLS), the
    VQGAN unchanged; then FALL_STEPS steps on one fixed batch with fixed
    draws at a constant lr: the loss falls.  Then one full-width ART-V
    step the same way (B1 under the causal mask, no remat)."""
    import torch
    from mmvid_tpu_torch import breakdown, training
    from mmvid_tpu_torch.models.masking import sample_msm_mask
    from mmvid_tpu_torch.models.warp import warp_draws

    t0 = time.perf_counter()
    model = breakdown.build_train('train')
    torch.cuda.synchronize()
    print(f'[train] flagship training build in '
          f'{time.perf_counter() - t0:.2f} s', flush=True)
    vae = [p.detach().clone() for p in model.vae.parameters()]
    with _LaunchCapture(BACKWARD_SITES) as cap:
        res = breakdown.measure_train(model, 'train', breakdown.BATCH)
    _train_report('train', res)
    _check_train('train', 'train', res)
    res['checked'] = check_captured(
        'train', cap, {'attention_backward': res[
            'attention_backward_launches_per_step']})

    cfg = model.cfg
    tc = breakdown.train_config('train', lr_scheduler='none')
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc)
    data = breakdown.train_batch(model, breakdown.BATCH)
    g = torch.Generator(device='cuda').manual_seed(11)
    keep, nfm = sample_msm_mask(g, cfg, tc.msm_strategy_prob,
                                tc.msm_bernoulli_prob, batch=breakdown.BATCH,
                                device='cuda')
    draws = {'keep': keep, 'nfm': nfm,
             'warp': warp_draws(g, breakdown.BATCH, cfg.num_targets,
                                tc.vid_strategy_prob, 'cuda')}
    losses = []
    for _ in range(FALL_STEPS):
        state, m = step(state, data, None, draws=draws)
        losses.append(m['loss'])
    losses = [x.item() for x in losses]
    print(f'[train] fixed batch and draws, lr {tc.learning_rate} constant, '
          f'{FALL_STEPS} steps: losses {losses}', flush=True)
    if not losses[-1] < losses[0]:
        fail(f'train: the loss did not fall on a fixed batch: {losses}')
    same = all(torch.equal(a, b) for a, b in zip(vae, model.vae.parameters()))
    print(f'[train] VQGAN unchanged: {same}', flush=True)
    if not same:
        fail('train: the frozen VQGAN changed')
    del model, state, step, vae, data
    torch.cuda.empty_cache()

    model = breakdown.build_train('train_artv')
    with _LaunchCapture(BACKWARD_SITES) as cap:
        res_artv = breakdown.measure_train(model, 'train_artv',
                                           breakdown.BATCH, steps=1)
    _train_report('train artv', res_artv)
    _check_train('train artv', 'train_artv', res_artv)
    res_artv['checked'] = check_captured(
        'train artv', cap, {'attention_backward': res_artv[
            'attention_backward_launches_per_step']})
    del model
    torch.cuda.empty_cache()
    return res, res_artv


def recipe_argv(recipe: str, script: str, paths: dict) -> list:
    """The flags ``scripts/mmvoxceleb/<recipe>/<script>`` passes to its
    driver, each flag in ``paths`` given that value instead (the data
    folder, the VQGAN checkpoints, the run to sample)."""
    import shlex
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        'scripts', 'mmvoxceleb', recipe, script)
    with open(path) as f:
        text = f.read().replace('\\\n', ' ')
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith('python3'))
    words = shlex.split(line)[2:]
    return [paths.get(words[i - 1], w) if i else w
            for i, w in enumerate(words)]


def _smooth_frames(rng, n, size):
    """n uint8 RGB frames [size, size, 3]: a moving gradient and noise
    (PNG-compressible as camera frames are)."""
    import numpy as np
    y, x = np.mgrid[:size, :size]
    base = rng.randint(0, 256, 3)
    out = []
    for t in range(n):
        img = (x[..., None] * (1 + base % 3) + y[..., None] * 2 + 3 * t
               + base + rng.randint(0, 24, (size, size, 3)))
        out.append((img % 256).astype(np.uint8))
    return out


def write_driver_data(root: str, clips: int, frames: int, size: int = 128,
                      vox: bool = False, distinct: int = 0) -> str:
    """A synthetic dataset tree of ``clips`` clips under ``root`` written by
    the port's PNG writer, the five filter types in turn:
    ``video/<key>/*.png`` and ``txt/<key>.txt`` (the video_text layout),
    with ``vox`` also ``label/<key>.txt`` (40 attributes) and
    ``mask/<key>/*.png``.  Keys ``id<p>#v<p>#<n>``, two clips an
    identity.  With ``distinct`` (< clips), clip i's frame files are hard
    links to clip (i mod distinct)'s: each is read and decoded all the
    same."""
    import numpy as np
    from mmvid_tpu_torch.data import png
    rng = np.random.RandomState(0)
    captions = ['A man with a beard is talking. He is young.',
                'A woman with wavy hair is talking. She wears earrings.',
                'A person with glasses is speaking.']
    ft = 0
    distinct = distinct or clips
    keys = [f'id{i // 2}#v{i // 2}#{i % 2:03d}' for i in range(clips)]
    for i, key in enumerate(keys):
        subs = [('video', frames)] + ([('mask', 2)] if vox else [])
        for sub, n in subs:
            d = os.path.join(root, sub, key)
            os.makedirs(d)
            if i >= distinct:
                src = os.path.join(root, sub, keys[i % distinct])
                for name in os.listdir(src):
                    os.link(os.path.join(src, name), os.path.join(d, name))
                continue
            for j, img in enumerate(_smooth_frames(rng, n, size)):
                png.write_png(os.path.join(d, f'{j:04d}.png'), img, ft)
                ft = (ft + 1) % 5
        os.makedirs(os.path.join(root, 'txt'), exist_ok=True)
        with open(os.path.join(root, 'txt', f'{key}.txt'), 'w') as f:
            f.write(captions[i % 3] + '\n' + captions[(i + 1) % 3] + '\n')
        if vox:
            os.makedirs(os.path.join(root, 'label'), exist_ok=True)
            with open(os.path.join(root, 'label', f'{key}.txt'), 'w') as f:
                f.write(','.join('1' if (i + a) % 7 == 0 else '0'
                                 for a in range(40)))
    return root


def write_vqgan_ckpt(path: str, seed: int, image_size: int = 128):
    """A taming-format VQGAN checkpoint (``state_dict``) of the recipes'
    vqgan1024 at ``image_size``, weights from ``factories.init_weights``
    at ``seed``; returns the state dict."""
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE
    vae = VQGanVAE(image_size, VQGanConfig(resolution=image_size))
    factories.init_weights(vae, torch.Generator().manual_seed(seed))
    sd = vae.model.state_dict()
    torch.save({'state_dict': sd}, path)
    return sd


# the captions of the text_augment recipe (test.sh and its NOTE), and of
# the synthetic driver data (write_driver_data)
ROBERTA_CAPTIONS = (
    'A girl.', 'A person has no hair.', 'A person wears spectacles.',
    'A person is youthful.',
    'A man with a beard is talking. He is young.',
    'A woman with wavy hair is talking. She wears earrings.',
    'A person with glasses is speaking.')


def learn_merges(captions, n: int) -> list:
    """``n`` byte-level BPE merges learned on ``captions`` by greedy pair
    counting (the most frequent adjacent pair, the smallest on a tie),
    over the pieces of the port's RoBERTa pre-tokenizer."""
    from collections import Counter

    from mmvid_tpu_torch.roberta_tokenizer import pre_tokenize
    from mmvid_tpu_torch.tokenizer import byte_unicode_table
    table = byte_unicode_table()
    words = Counter(tuple(table[b] for b in piece.encode('utf-8'))
                    for text in captions for piece in pre_tokenize(text))
    merges = []
    while len(merges) < n:
        pairs = Counter()
        for w, c in words.items():
            for pair in zip(w[:-1], w[1:]):
                pairs[pair] += c
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        merged = Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i < len(w) - 1 and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


def write_roberta_archive(folder: str, cfg=None, seed: int = 0,
                          captions=ROBERTA_CAPTIONS, merges: int = 50):
    """A RoBERTa model folder as the hub lays out roberta-large's, on
    synthetic weights: ``config.json`` (``cfg``, default the published
    roberta-large shapes; its vocabulary the one written), ``vocab.json``
    (the specials, the 256 byte symbols, ``merges`` merges learned on
    ``captions``, placeholder entries up to ``cfg.vocab_size``, ``<mask>``
    last) and ``merges.txt``, and a ``pytorch_model.bin`` of a
    ``RobertaForMaskedLM``: every weight under the ``roberta.`` prefix with
    an ``lm_head``, drawn N(0, 0.02) from ``seed`` (LayerNorm weights
    1 + N(0, 0.02)).  Returns (the config, the encoder's state dict)."""
    import dataclasses as dc

    import torch
    from mmvid_tpu_torch.models.roberta import ROBERTA_LARGE, RobertaModel
    from mmvid_tpu_torch.tokenizer import byte_unicode_table
    os.makedirs(folder, exist_ok=True)
    pairs = learn_merges(captions, merges)
    tokens = (['<s>', '<pad>', '</s>', '<unk>']
              + list(byte_unicode_table().values())
              + [a + b for a, b in pairs])
    if cfg is None:
        cfg = ROBERTA_LARGE
        tokens += [f'<extra_{i}>' for i in
                   range(cfg.vocab_size - len(tokens) - 1)]
    tokens.append('<mask>')
    cfg = dc.replace(cfg, vocab_size=len(tokens))
    with open(os.path.join(folder, 'vocab.json'), 'w',
              encoding='utf-8') as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(folder, 'merges.txt'), 'w',
              encoding='utf-8') as f:
        f.write('#version: 0.2\n' + ''.join(f'{a} {b}\n' for a, b in pairs))
    with open(os.path.join(folder, 'config.json'), 'w') as f:
        json.dump({'model_type': 'roberta',
                   'architectures': ['RobertaForMaskedLM'],
                   'bos_token_id': 0, 'eos_token_id': 2,
                   **dc.asdict(cfg)}, f, indent=1)
    gen = torch.Generator().manual_seed(seed)
    with torch.device('meta'):
        shapes = RobertaModel(cfg).state_dict()
    sd = {}
    for k, v in shapes.items():
        w = torch.randn(v.shape, generator=gen) * 0.02
        sd[k] = w + 1 if k.endswith('LayerNorm.weight') else w
    h = cfg.hidden_size
    archive = {f'roberta.{k}': v for k, v in sd.items()}
    archive.update({
        'lm_head.dense.weight': torch.randn((h, h), generator=gen) * 0.02,
        'lm_head.dense.bias': torch.zeros(h),
        'lm_head.layer_norm.weight': torch.ones(h),
        'lm_head.layer_norm.bias': torch.zeros(h),
        'lm_head.decoder.weight': sd['embeddings.word_embeddings.weight'],
        'lm_head.bias': torch.zeros(cfg.vocab_size)})
    torch.save(archive, os.path.join(folder, 'pytorch_model.bin'))
    return cfg, sd


# the training driver's runs: the text-to-video recipe at its batch 48
# (iterations 0-5, then resumed to 8) and the text+mask recipe at its 20
DRIVER_ITERS, DRIVER_RESUME_ITERS, DRIVER_SAVE_EVERY = 6, 8, 3
DRIVER_MASK_ITERS = 3
DRIVER_CLIP_FRAMES = 32   # the recipes' frame_num 8 at frame_step 4 need 29
DRIVER_EPOCH_BATCHES = 8


def _driver_losses(log_dir):
    import math
    with open(os.path.join(log_dir, 'log.txt')) as f:
        lines = [ln.split() for ln in f if ln.startswith('iter ')]
    losses = {int(w[1]): float(w[3]) for w in lines}
    if not all(math.isfinite(v) for v in losses.values()):
        fail(f'train driver: a loss is not finite: {losses}')
    return losses


def _backward_calls(args, iters: int) -> int:
    """Attention's backward calls in ``iters`` training steps of ``args``:
    one a layer for each forward of the step (MSM, and REL's and VID's
    negatives where their betas are on), no remat."""
    from mmvid_tpu_torch import factories
    layers = factories.build_clip_config(args.which_transformer).layers
    return iters * layers * (1 + (args.beta_rel > 0) + (args.beta_vid > 0))


def _steady(record):
    """(step ms, loader wait ms) a step: means over the iterations after
    the first, each step ending in its loss read (--log_every 1)."""
    its = record['iters'][1:]
    return (1e3 * statistics.mean(r['step_s'] for r in its),
            1e3 * statistics.mean(r['wait_s'] for r in its))


def loader_alone(args, batches: int = DRIVER_EPOCH_BATCHES - 2) -> dict:
    """The driver's loader by itself on ``args``' dataset: seconds a batch
    (mean over ``batches`` after the first, within one epoch, taken back
    to back: the rate the threads make batches at), and one
    thread's ms a frame to read and resize (``png.read_rgb`` +
    ``transforms.resize_exact``) over one clip's files."""
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch.data import png, transforms
    from mmvid_tpu_torch.data.loader import DataLoader, infinite_batches
    dataset = factories.get_dataset(args, factories.get_tokenizer(args))
    key = dataset.keys[0]
    paths = [os.path.join(dataset.root, f) for f in dataset.videos[key]]
    png.read_rgb(paths[0])   # the frame core built (g++) at first use
    t0 = time.perf_counter()
    for p in paths:
        transforms.resize_exact(png.read_rgb(p),
                                (dataset.image_size, dataset.image_size))
    per_frame = (time.perf_counter() - t0) / len(paths) * 1e3
    it = infinite_batches(DataLoader(
        dataset, batch_size=args.batch_size,
        num_workers=min(args.num_workers, 16), seed=args.seed))
    next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    per_batch = (time.perf_counter() - t0) / batches
    it.close()
    return {'batch_s': per_batch, 'frame_ms': per_frame,
            'workers': min(args.num_workers, 16), 'cpus': os.cpu_count()}


def phase_train_driver(batch: int = 48):
    """``python -m mmvid_tpu_torch.train`` through ``main_worker`` on
    ``text_to_video/train.sh``'s flags verbatim but the data and log
    paths, ``--iters 6 --save_every_n_steps 3 --sample_every 3
    --log_every 1 --bf16``, at the recipe's batch 48, on a synthetic
    video_text tree of 128 px PNG clips and a random VQGAN checkpoint;
    then ``--auto_resume`` to iter 8 under ``torch.profiler`` (the idle
    share over its iterations); then 3 steps of ``text_and_mask/
    train.sh``'s flags (vox, ``mask+text_dropout``, a cvae).  Gates:
    finite losses, the resumed start iteration, the frozen VQGAN
    unchanged in the checkpoints, checkpoint and grid files written,
    attention's backward calls exact (36 a step: 12 layers x 3
    forwards, no remat), the kernels launched, each run's backward kernel
    held against its plain version on its first inputs at each shape
    (:func:`check_captured`)."""
    import tempfile

    import torch
    from mmvid_tpu_torch import breakdown
    from mmvid_tpu_torch import train as driver
    from mmvid_tpu_torch.config import process_args

    tmp = tempfile.mkdtemp(prefix='mmvid_driver_')
    try:
        t0 = time.perf_counter()
        # DRIVER_EPOCH_BATCHES batches an epoch: the loader prefetches
        # within an epoch only, as JAX's does
        tree = write_driver_data(os.path.join(tmp, 'vox_text'),
                                 batch * DRIVER_EPOCH_BATCHES,
                                 DRIVER_CLIP_FRAMES, distinct=batch)
        vox = write_driver_data(os.path.join(tmp, 'vox'),
                                20 * DRIVER_EPOCH_BATCHES,
                                DRIVER_CLIP_FRAMES, vox=True, distinct=20)
        vae_sd = write_vqgan_ckpt(os.path.join(tmp, 'vae.ckpt'), 7)
        shutil.copyfile(os.path.join(tmp, 'vae.ckpt'),
                        os.path.join(tmp, 'cvae.ckpt'))
        print(f'[train driver] data and VQGAN checkpoints written in '
              f'{time.perf_counter() - t0:.2f} s', flush=True)
        logs = os.path.join(tmp, 'logs')
        argv = recipe_argv('text_to_video', 'train.sh', {
            '--image_text_folder': tree,
            '--vae_path': os.path.join(tmp, 'vae.ckpt')}) + [
            '--log_root', logs, '--iters', str(DRIVER_ITERS),
            '--save_every_n_steps', str(DRIVER_SAVE_EVERY),
            '--sample_every', str(DRIVER_SAVE_EVERY), '--log_every', '1',
            '--bf16', '--batch_size', str(batch), '--deterministic']
        args = process_args(train=True, argv=argv)
        run_dir = os.path.join(logs, args.name)
        alone = loader_alone(args)
        print(f'[train driver] the loader alone: {alone["batch_s"]:.4f} s '
              f'a batch of {batch} with {alone["workers"]} threads on '
              f'{alone["cpus"]} CPUs; {alone["frame_ms"]:.3f} ms a 128 px '
              f'frame read and resized on one thread', flush=True)

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _LaunchCapture(BACKWARD_SITES) as cap:
            record = driver.main_worker(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        calls = breakdown.KERNELS['attention'].backward_calls
        bl = backward_launches()
        losses = _driver_losses(run_dir)
        step_ms, wait_ms = _steady(record)
        save = next(r for r in record['iters'] if 'save_s' in r)
        viz_s = next(r['viz_s'] for r in record['iters'] if 'viz_s' in r)
        print(f'[train driver] batch {batch}: {DRIVER_ITERS} iterations in '
              f'{wall:.2f} s (model build included); step {step_ms:.2f} ms '
              f'(mean of iterations 1-{DRIVER_ITERS - 1}, to the loss '
              f'read), {batch / ((step_ms + wait_ms) / 1e3):.2f} videos/s '
              f'with the loader; loader wait {wait_ms:.3f} ms a step; '
              f'save {save["save_s"]:.3f} s, {save["save_bytes"]} B '
              f'(and weights/last); final save '
              f'{record["final_save"]["s"]:.3f} s; sample grids '
              f'{viz_s:.2f} s; peak memory {peak} B; losses {losses}; '
              f'launches {counts}, attention backward calls {calls} '
              f'(kernel launches {bl}); '
              f'each iteration\'s wait and step '
              f'{[(r["wait_s"], r["step_s"]) for r in record["iters"]]}',
              flush=True)
        want_calls = _backward_calls(args, DRIVER_ITERS)
        if calls != want_calls or bl != want_calls:
            fail(f'train driver: attention backward calls {calls}, kernel '
                 f'launches {bl} != {want_calls}')
        checked = check_captured('train driver', cap,
                                 {'attention_backward': bl})
        for name in ('attention', 'codebook', 'sample_head'):
            if counts[name] <= 0:
                fail(f'train driver: {name} launched no time')
        for rel in (f'weights/{DRIVER_SAVE_EVERY}/dalle.pt',
                    f'weights/{DRIVER_ITERS}/dalle.pt',
                    'weights/last/dalle.pt', 'web/index.html',
                    f'samples/{DRIVER_SAVE_EVERY:07d}_0.png'):
            if not os.path.isfile(os.path.join(run_dir, rel)):
                fail(f'train driver: {rel} not written')
        ck = torch.load(os.path.join(run_dir, 'weights', 'last', 'dalle.pt'),
                        map_location='cpu', weights_only=False)
        # each weight as loaded: bf16 (the codebook stays fp32)
        same = all(torch.equal(ck['weights'][f'vae.model.{k}'], v) or
                   torch.equal(ck['weights'][f'vae.model.{k}'],
                               v.to(torch.bfloat16).float())
                   for k, v in vae_sd.items())
        print(f'[train driver] VQGAN unchanged (the checkpoint against '
              f'vae.ckpt as loaded): {same}', flush=True)
        if not same:
            fail('train driver: the frozen VQGAN changed')
        del ck

        resume = process_args(train=True, argv=argv + ['--auto_resume'])
        resume.iters = DRIVER_RESUME_ITERS
        from torch.profiler import ProfilerActivity, profile
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rec2 = driver.main_worker(resume)
            torch.cuda.synchronize()
        # the iterations after the first (which waits for the loader's
        # first batch), each from its batch fetch to its loss read
        idle = breakdown.idle_share(prof, 'mmvid_train_iter', skip=1)
        resumed = _driver_losses(run_dir)
        its = rec2['iters']
        print(f'[train driver] --auto_resume started at iter '
              f'{rec2["start_iter"]}, losses {resumed}; device idle '
              f'{idle["idle_share"]:.4f} over {idle["windows"]} '
              f'iteration(s) after its first (busy {idle["busy_ms"]:.3f} '
              f'of {idle["span_ms"]:.3f} ms, under the profiler; '
              f'iterations {[r["step_s"] + r["wait_s"] for r in its]} s)',
              flush=True)
        if rec2['start_iter'] != DRIVER_ITERS:
            fail(f'train driver: resumed at {rec2["start_iter"]}, not '
                 f'{DRIVER_ITERS}')
        if sorted(resumed) != list(range(DRIVER_RESUME_ITERS)):
            fail(f'train driver: iterations logged {sorted(resumed)}')
        for it in (DRIVER_SAVE_EVERY, DRIVER_ITERS):   # disk: keep 8, last
            shutil.rmtree(os.path.join(run_dir, 'weights', str(it)))

        margv = recipe_argv('text_and_mask', 'train.sh', {
            '--image_text_folder': vox,
            '--vae_path': os.path.join(tmp, 'vae.ckpt'),
            '--cvae_path': os.path.join(tmp, 'cvae.ckpt')}) + [
            '--log_root', logs, '--iters', str(DRIVER_MASK_ITERS),
            '--log_every', '1', '--bf16']
        margs = process_args(train=True, argv=margv)
        reset_counts()
        with _LaunchCapture(BACKWARD_SITES) as mcap:
            rec3 = driver.main_worker(margs)
            torch.cuda.synchronize()
        mcounts = read_counts()
        mcalls = breakdown.KERNELS['attention'].backward_calls
        mbl = backward_launches()
        mlosses = _driver_losses(os.path.join(logs, margs.name))
        mstep, mwait = _steady(rec3)
        print(f'[train driver] text+mask (vox, {margs.attr_mode}, cvae) '
              f'batch {margs.batch_size}: step {mstep:.2f} ms, loader wait '
              f'{mwait:.3f} ms (iterations 1-{DRIVER_MASK_ITERS - 1}); '
              f'losses {mlosses}; launches {mcounts}, attention backward '
              f'calls {mcalls}', flush=True)
        if not (mcalls == mbl == _backward_calls(margs, DRIVER_MASK_ITERS)):
            fail(f'train driver text+mask: attention backward calls '
                 f'{mcalls}, kernel launches {mbl} != '
                 f'{_backward_calls(margs, DRIVER_MASK_ITERS)}')
        mchecked = check_captured('train driver text+mask', mcap,
                                  {'attention_backward': mbl})
        for name in ('attention', 'codebook'):
            if mcounts[name] <= 0:
                fail(f'train driver text+mask: {name} launched no time')
        res = {'batch': batch, 'step_ms': step_ms,
               'loader_wait_ms': wait_ms,
               'videos_s': batch / ((step_ms + wait_ms) / 1e3),
               'idle_share': idle['idle_share'],
               'save_s': save['save_s'], 'save_bytes': save['save_bytes'],
               'peak_memory_bytes': peak, 'launches': counts,
               'metrics': {**_driver_metrics(record),
                           **_driver_metrics(rec2)},
               'step_s': [r['step_s'] for r in record['iters']],
               'attention_backward_calls': calls,
               'attention_backward_launches': bl, 'checked': checked,
               'loader_alone': alone,
               'text_mask': {'batch': margs.batch_size, 'step_ms': mstep,
                             'loader_wait_ms': mwait, 'launches': mcounts,
                             'attention_backward_launches': mbl,
                             'checked': mchecked}}
        print(f'[train driver] {json.dumps(res)}', flush=True)
        return res, run_dir, tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# Data parallelism (``mmvid_tpu_torch/parallel/``).  The training driver
# over NCCL at world size 1: iterations 0-5 in this process, 6 resumed
# under the profiler, 7 resumed through --multiprocessing_distributed's
# spawn, against phase_train_driver's one-device run of the same flags
# (0-5, resumed 6-7), iteration by iteration (a one-rank sum changes no
# value: exactly equal)
DDP_NCCL_ITERS = (DRIVER_ITERS, DRIVER_ITERS + 1, DRIVER_RESUME_ITERS)
DDP_ALL_REDUCE_CALLS = 5
# two ranks on the one card over gloo (asked for: NCCL refuses two ranks
# on one device), the flagship's training step at global batch 48
DDP_RANKS, DDP_BATCH, DDP_STEPS = 2, 48, 3
# The two-rank step against the one-rank step at batch 48, step 1, on the
# same weights and generator: the relative gaps of the loss and of each of
# its terms, of grad_norm, and the reduced gradient's normwise gap
# (through Adam's first moment, 0.1 x the clipped gradient).  Written with
# the predicted readings before the run that reads them:
# * fp32 (train.sh's own precision; TF32 off in the ranks): each row's
#   arithmetic is the one-rank step's and only the batch's sums run in
#   another order: about 1e-7 for the losses and grad_norm, 1e-6 for the
#   gradient;
# * bf16 compute: each rank's weight gradients round to bf16 before the
#   ranks' fp32 sum, about 2^-9 an element: the gradient about 3e-3
#   normwise, grad_norm 1e-4, the losses 1e-6 (the forward rows are the
#   one-rank step's).
DDP_TOL = {'float32': {'loss': 1e-5, 'grad_norm': 1e-5, 'gradient': 1e-4},
           'bfloat16': {'loss': 1e-3, 'grad_norm': 2e-3, 'gradient': 2e-2}}
# The planted fault, a naive DDP (every normaliser a rank's own count, the
# ranks' mean losses averaged), must leave the fp32 tolerances: predicted
# about 3e-3 on the gradient normwise and 2e-5 on the loss (this
# configuration at the tiny size on the CPU read 2.96e-3 and 2.0e-5).  At
# random init the ranks' halves of the batch pull alike, so bf16's
# rounding of the gradient would hide it: the fault runs in fp32.
DDP_METRICS = ('loss', 'loss_msm', 'loss_rel', 'loss_vid')
DDP_TIMEOUT_S = 900


def _driver_metrics(record) -> dict:
    """iteration -> the metrics a driver run logged there."""
    return {r['iter']: r['metrics'] for r in record['iters']
            if 'metrics' in r}


def _all_reduce_ms(dp, shapes) -> dict:
    """``dp.all_reduce_`` over fp32 tensors of the trainable parameters'
    ``shapes``, as the step sums its gradients: ms a call (CUDA events
    around DDP_ALL_REDUCE_CALLS calls after a warm-up), the values, the
    bytes and the tensors."""
    import torch
    ts = [torch.ones(shape, device=dp.device) for shape in shapes]
    dp.all_reduce_(ts)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(DDP_ALL_REDUCE_CALLS):
        dp.all_reduce_(ts)
    end.record()
    torch.cuda.synchronize()
    n = sum(t.numel() for t in ts)
    return {'ms': start.elapsed_time(end) / DDP_ALL_REDUCE_CALLS,
            'values': n, 'bytes': 4 * n, 'tensors': len(ts)}


def _nccl_ms(prof, annotation: str) -> dict:
    """NCCL's device time inside the ``annotation`` windows of a finished
    profile, the windows' span (ms) and the NCCL kernels' names."""
    from torch.autograd import DeviceType

    from mmvid_tpu_torch import breakdown
    events = prof.profiler.kineto_results.events()
    wins = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.name() == annotation and e.device_type() == DeviceType.CPU]
    nccl = [d for d in breakdown.device_events(events, annotation)
            if 'nccl' in d[2].lower()]
    return {'nccl_ms': sum(breakdown.busy_ns(nccl, lo, hi)
                           for lo, hi in wins) / 1e6,
            'span_ms': sum(hi - lo for lo, hi in wins) / 1e6,
            'windows': len(wins),
            'nccl_kernels': sorted({d[2] for d in nccl})}


def phase_train_ddp_nccl(tmp: str, one_device: dict):
    """The training driver over NCCL at world size 1, on
    phase_train_driver's flags (``text_to_video/train.sh``, ``--bf16``,
    batch 48, ``--deterministic``), tree and VQGAN: the rank that
    ``--multiprocessing_distributed`` spawns run in this process
    (``mesh.init`` and ``main_worker``, as ``train.spawned_rank`` runs
    them) for iterations 0-5, resumed for iteration 6 under the profiler,
    then ``train.launch`` with ``--multiprocessing_distributed
    --auto_resume`` (one spawned rank a visible GPU) for iteration 7
    (DDP_NCCL_ITERS).  Gates: every iteration's metrics equal
    ``one_device``'s (iteration -> metrics of phase_train_driver's run)
    exactly, the last's logged line equal; the resumed starts;
    attention's backward launches exact and the kernels launched.
    Reports both steps' ms (and each iteration's), the peak memory, the
    gradient all-reduce's ms a step (CUDA events over ``dp.all_reduce_``
    on the core's shapes) and NCCL's device time in the profiled
    iteration (none at world size 1: a one-rank all-reduce launches no
    kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mmvid_tpu_torch import train as driver
    from mmvid_tpu_torch import training
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.parallel import mesh

    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    logs = os.path.join(tmp, 'ddp_logs')
    argv = recipe_argv('text_to_video', 'train.sh', {
        '--image_text_folder': os.path.join(tmp, 'vox_text'),
        '--vae_path': os.path.join(tmp, 'vae.ckpt')}) + [
        '--log_root', logs, '--log_every', '1', '--bf16',
        '--batch_size', str(DDP_BATCH), '--deterministic',
        '--save_every_n_steps', '100000', '--sample_every', '100000',
        '--multiprocessing_distributed']

    def args_for(iters, *extra):
        store = os.path.join(tmp, f'ddp_store_{iters}')
        return process_args(train=True, argv=argv + [
            '--iters', str(iters), '--dist_url', f'file://{store}', *extra])

    a0 = args_for(DDP_NCCL_ITERS[0])
    run_dir = os.path.join(logs, a0.name)
    shapes = []
    create = training.create_train_state

    def create_and_see(model, tc):   # the trainable parameters' shapes
        state = create(model, tc)
        shapes[:] = [p.shape for p in state.params.values()]
        return state

    dp = mesh.init('nccl', torch.device('cuda', 0), 0, 1, a0.dist_url)
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        training.create_train_state = create_and_see
        try:
            rec = driver.main_worker(a0, dp)
        finally:
            training.create_train_state = create
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        bl = backward_launches()
        reduce = _all_reduce_ms(dp, shapes)
        torch.cuda.empty_cache()
        shutil.rmtree(os.path.join(run_dir, 'weights',
                                   str(DDP_NCCL_ITERS[0])))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rec_p = driver.main_worker(
                args_for(DDP_NCCL_ITERS[1], '--auto_resume'), dp)
            torch.cuda.synchronize()
    finally:
        mesh.shutdown()
    shutil.rmtree(os.path.join(run_dir, 'weights', str(DDP_NCCL_ITERS[1])))
    torch.cuda.empty_cache()
    nccl = _nccl_ms(prof, 'mmvid_train_iter')
    del prof
    t0 = time.perf_counter()
    driver.launch(args_for(DDP_NCCL_ITERS[2], '--auto_resume'))
    spawn_s = time.perf_counter() - t0
    got = _driver_metrics(rec)
    got.update(_driver_metrics(rec_p))
    logged = _driver_losses(run_dir)
    shutil.rmtree(os.path.join(run_dir, 'weights'))
    step_ms, wait_ms = _steady(rec)
    res = {'batch': DDP_BATCH, 'step_ms': step_ms, 'loader_wait_ms': wait_ms,
           'one_device_step_ms': one_device['step_ms'],
           'peak_memory_bytes': peak,
           'one_device_peak_memory_bytes': one_device['peak_memory_bytes'],
           'launches': counts, 'attention_backward_launches': bl,
           'profiled_iteration': nccl, 'gradient_all_reduce': reduce,
           'spawned_resume_s': spawn_s,
           'step_s': [r['step_s'] for r in rec['iters']],
           'one_device_step_s': one_device['step_s'],
           'starts': [rec['start_iter'], rec_p['start_iter']]}
    print(f'[train ddp nccl] world size 1 over NCCL at batch {DDP_BATCH}: '
          f'step {step_ms:.2f} ms (iterations 1-{DDP_NCCL_ITERS[0] - 1}; '
          f'the one-device driver {one_device["step_ms"]:.2f} ms), loader '
          f'wait {wait_ms:.3f} ms; peak memory {peak} B (one device '
          f'{one_device["peak_memory_bytes"]} B); the gradient\'s '
          f'all-reduce {reduce["ms"]:.3f} ms a step ({reduce["bytes"]} B '
          f'in {reduce["tensors"]} tensors); the profiled iteration '
          f'{nccl["span_ms"]:.3f} ms, NCCL kernels {nccl["nccl_ms"]:.3f} '
          f'ms of it ({nccl["nccl_kernels"]}); the spawned resume '
          f'{spawn_s:.2f} s (the process, the model and one step); each '
          f'iteration\'s step {res["step_s"]} s (one device '
          f'{one_device["step_s"]}); launches {counts}, '
          f'attention backward launches {bl}; metrics {got}; logged '
          f'losses {logged}', flush=True)
    print(f'[train ddp nccl] {json.dumps(res)}', flush=True)
    want = one_device['metrics']
    for it in range(DDP_NCCL_ITERS[1]):
        if got.get(it) != want.get(it):
            fail(f'train ddp nccl: iteration {it} metrics {got.get(it)} != '
                 f'the one-device run\'s {want.get(it)}')
    last = DDP_NCCL_ITERS[2] - 1
    if sorted(logged) != list(range(DDP_NCCL_ITERS[2])) or \
            f'{logged[last]:.4f}' != f'{want[last]["loss"]:.4f}':
        fail(f'train ddp nccl: the spawned resume logged {logged}, the '
             f'one-device run {want.get(last)} at iteration {last}')
    if res['starts'] != [0, DDP_NCCL_ITERS[0]]:
        fail(f'train ddp nccl: starts {res["starts"]}')
    if bl != _backward_calls(a0, DDP_NCCL_ITERS[0]):
        fail(f'train ddp nccl: attention backward launches {bl} != '
             f'{_backward_calls(a0, DDP_NCCL_ITERS[0])}')
    for name in ('attention', 'codebook'):
        if counts[name] <= 0:
            fail(f'train ddp nccl: {name} launched no time')
    return res


def _naive_ddp(device, group=None):
    """The planted fault: a DataParallel whose every normaliser is the
    rank's own count, so the gradients' sum over the ranks descends the
    mean of the ranks' mean losses, as a naive DDP does."""
    from mmvid_tpu_torch.parallel import mesh

    class NaiveDDP(mesh.DataParallel):
        def total(self, t):
            return t.detach() * self.world

    return NaiveDDP(device, group)


def _ddp_gaps(a, b) -> dict:
    """(metrics, flat first moment) a against b: the relative gap of each
    metric and the moment's normwise gap."""
    import torch
    (ma, mua), (mb, mub) = a, b
    gaps = {k: abs(ma[k] - mb[k]) / abs(mb[k]) for k in DDP_METRICS
            + ('grad_norm',)}
    gaps['gradient'] = (torch.linalg.vector_norm(mua - mub)
                        / torch.linalg.vector_norm(mub)).item()
    return gaps


def _ddp_out_of_tol(gaps, dtype) -> list:
    tol = DDP_TOL[dtype]
    return [k for k, v in gaps.items()
            if v > tol['loss' if k in DDP_METRICS else k]]


def _ddp_hold(dp, dtype_name: str, planted: bool) -> dict:
    """One rank of phase_train_ddp_gloo: the flagship's training build in
    ``dtype_name`` from seed 0 (a spread codebook), the recipe's
    TrainConfig at a constant lr, the global batch 48 of
    ``breakdown.train_batch``, this rank's rows.  Step 1 on the ranks; with
    ``planted`` then steps 2-3 (launches counted, attention's backward
    captured and held against its plain version), the ranks' parameters
    compared bit for bit (all-reduced max against min), and step 1 again
    from the same weights under the naive DDP.  Then rank 0 alone takes
    the one-rank step at batch 48 from the same weights; it returns the
    gaps."""
    import torch
    import torch.distributed as dist

    from mmvid_tpu_torch import breakdown, factories, training
    from mmvid_tpu_torch.parallel import mesh
    dev = dp.device
    dtype = getattr(torch, dtype_name)
    model, _ = factories.flagship_train(dtype=dtype, device=dev, seed=0)
    _spread_codebook([model], 3)
    tc = breakdown.train_config('train', lr_scheduler='none')
    data = breakdown.train_batch(model, DDP_BATCH, dev)
    local = {k: dp.rows(v) for k, v in data.items()}
    params = list(training.trainable_parameters(model).values())
    init = [p.detach().clone() for p in params]

    def gen(i):
        return torch.Generator(device=dev).manual_seed(i)

    def first_step(dpx, batch):
        with torch.no_grad():
            for p, q in zip(params, init):
                p.copy_(q)
        state = training.create_train_state(model, tc)
        step = training.make_train_step(model, tc, dpx)
        state, m = step(state, batch, gen(0))
        mu = torch.cat([t.reshape(-1) for t in state.opt_state['mu'].values()])
        return ({k: float(v) for k, v in m.items()}, mu), state, step

    out = {'params': sum(p.numel() for p in params)}
    reset_counts()
    t0 = time.perf_counter()
    with _LaunchCapture(BACKWARD_SITES) as cap:
        two, state, step = first_step(dp, local)
        if planted:
            for i in range(1, DDP_STEPS):
                state, _ = step(state, local, gen(i))
        torch.cuda.synchronize()
    out['steps_s'] = time.perf_counter() - t0
    if planted:
        out['launches'] = read_counts()
        out['attention_backward_launches'] = backward_launches()
        out['checked'] = check_captured(
            f'train ddp rank {dp.rank}', cap,
            {'attention_backward': out['attention_backward_launches']})
        bits = torch.cat([p.detach().reshape(-1) for p in params]).view(
            torch.int32)
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        out['bit_identical'] = torch.equal(hi, lo)
        del bits, hi, lo
        naive, _, _ = first_step(_naive_ddp(dev), local)
    del state, step, cap
    torch.cuda.empty_cache()
    dp.barrier()
    if dp.rank == 0:
        one, _, _ = first_step(mesh.LOCAL, data)
        out['metrics'] = {'two_ranks': two[0], 'one_rank': one[0]}
        out['gaps'] = _ddp_gaps(two, one)
        if planted:
            out['metrics']['naive'] = naive[0]
            out['naive_gaps'] = _ddp_gaps(naive, one)
    del model, init, params
    torch.cuda.empty_cache()
    dp.barrier()
    return out


def _ddp_rank(rank: int, world: int, store: str, results):
    """A rank of phase_train_ddp_gloo (a spawned process): on cuda:0 over
    gloo, fp32 with the planted fault, then bf16; TF32 off."""
    import traceback
    os.environ['GLOO_SOCKET_IFNAME'] = 'lo'
    try:
        import torch

        from mmvid_tpu_torch.ops.precision import fp32_exact
        from mmvid_tpu_torch.parallel import mesh
        dp = mesh.init('gloo', torch.device('cuda', 0), rank, world,
                       f'file://{store}')
        try:
            with fp32_exact():
                out = {'float32': _ddp_hold(dp, 'float32', planted=True),
                       'bfloat16': _ddp_hold(dp, 'bfloat16', planted=False)}
        finally:
            mesh.shutdown()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def phase_train_ddp_gloo():
    """Two ranks on the one card over gloo, each pinned to cuda:0 on
    purpose (NCCL refuses two ranks on one device; the backend is asked
    for, never fallen back to): the flagship's training step at global
    batch 48 (24 a rank) against the one-rank step at 48 on the same
    weights and generator, in fp32 and in bf16 compute (:func:`_ddp_hold`).
    Gates: at step 1 every gap within ``DDP_TOL``; after 3 steps the
    ranks' parameters bit-identical; the planted naive DDP out of the fp32
    tolerance; each rank's launches over the 3 steps those of 3 flagship
    training steps (B1 forward 72, B3 2, B1-bwd 36 a step, at batch 24),
    its captured backward held against its plain version.  The times go
    through host memory under gloo and are no scaling number."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix='mmvid_ddp_')
    free_card_memory('train ddp gloo')
    t0 = time.perf_counter()
    try:
        outs = _spawn_ranks(_ddp_rank, DDP_RANKS,
                            (os.path.join(tmp, 'store'),))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = outs[0]
    res = {'wall_s': wall, 'params': r0['float32']['params'],
           'gradient_bytes': 4 * r0['float32']['params'],
           'float32': {k: r0['float32'][k] for k in (
               'metrics', 'gaps', 'naive_gaps', 'steps_s', 'launches',
               'attention_backward_launches', 'bit_identical')},
           'bfloat16': {k: r0['bfloat16'][k] for k in (
               'metrics', 'gaps', 'steps_s')},
           'rank1': {k: outs[1]['float32'][k] for k in (
               'launches', 'attention_backward_launches', 'bit_identical',
               'steps_s')},
           'tol': DDP_TOL}
    print(f'[train ddp gloo] {DDP_RANKS} ranks on cuda:0 over gloo, global '
          f'batch {DDP_BATCH}: {res["params"]} trainable parameters, '
          f'{res["gradient_bytes"]} B of fp32 gradient all-reduced a step; '
          f'step 1 against the one-rank step, relative gaps: fp32 '
          f'{res["float32"]["gaps"]}, bf16 {res["bfloat16"]["gaps"]} '
          f'(tolerances {DDP_TOL}); the planted naive DDP (fp32) '
          f'{res["float32"]["naive_gaps"]}; parameters bit-identical '
          f'after {DDP_STEPS} steps: rank 0 {res["float32"]["bit_identical"]}'
          f', rank 1 {res["rank1"]["bit_identical"]}; launches a rank over '
          f'{DDP_STEPS} steps: {res["float32"]["launches"]} / '
          f'{res["rank1"]["launches"]}, attention backward '
          f'{res["float32"]["attention_backward_launches"]} / '
          f'{res["rank1"]["attention_backward_launches"]}; {DDP_STEPS} '
          f'fp32 steps {res["float32"]["steps_s"]:.2f} s, one bf16 step '
          f'{res["bfloat16"]["steps_s"]:.2f} s on rank 0 (gloo through host '
          f'memory: no scaling number); wall {wall:.1f} s', flush=True)
    print(f'[train ddp gloo] {json.dumps(res)}', flush=True)
    for dtype in ('float32', 'bfloat16'):
        bad = _ddp_out_of_tol(res[dtype]['gaps'], dtype)
        if bad:
            fail(f'train ddp gloo: {dtype} step 1 off the one-rank step in '
                 f'{bad}: {res[dtype]["gaps"]}')
    if not _ddp_out_of_tol(res['float32']['naive_gaps'], 'float32'):
        fail(f'train ddp gloo: the planted naive DDP passed the hold: '
             f'{res["float32"]["naive_gaps"]}')
    if not (res['float32']['bit_identical'] and
            res['rank1']['bit_identical']):
        fail('train ddp gloo: the ranks\' parameters differ after '
             f'{DDP_STEPS} steps')
    per_step = TRAIN_LAUNCHES['train']
    want = expected(**{k: DDP_STEPS * v for k, v in per_step.items()})
    want_bwd = DDP_STEPS * TRAIN_BACKWARD_CALLS['train']
    for tag, o in (('rank 0', res['float32']), ('rank 1', res['rank1'])):
        if o['launches'] != want or \
                o['attention_backward_launches'] != want_bwd:
            fail(f'train ddp gloo: {tag} launched {o["launches"]}, '
                 f'backward {o["attention_backward_launches"]}; want '
                 f'{want}, {want_bwd}')
    return res


DDP_CARD_ITERS = 4
# four cards against one at iteration 0, each metric's relative gap (bf16:
# at 12 rows a rank the GEMMs take other kernels than at 48, so the
# forward is not the one-card forward bit for bit); the loss read 1.1e-4,
# grad_norm 7.6e-4 under this bound on four H100s
DDP_CARDS_TOL = 1e-3


def _ddp_card_rank(local: int, nprocs: int, args, results):
    """A rank of phase_train_ddp_cards: ``train.spawned_rank``, as
    ``--multiprocessing_distributed`` spawns it; its metrics, step ms and
    peak memory to ``results``."""
    import torch

    from mmvid_tpu_torch import train
    rec = train.spawned_rank(local, nprocs, args)
    results.put((local, {'metrics': _driver_metrics(rec),
                         'step_ms': _steady(rec)[0],
                         'peak': torch.cuda.max_memory_allocated(local)}))


def phase_train_ddp_cards():
    """The training driver over NCCL on every visible card (run alone, on
    a machine of several cards: ``python -c "import chip_smoke as c;
    c.phase_device(); c.phase_build(); c.phase_train_ddp_cards()"``),
    ``text_to_video/train.sh``'s flags with ``--bf16 --deterministic`` at
    global batch 48, against one rank on one card at 48: every rank's
    metrics equal, iteration 0 within ``DDP_CARDS_TOL`` of one card's;
    step ms and peak memory a rank (one call's reading, not a scaling
    number)."""
    return _train_cards('train ddp cards', ())


def phase_train_tp_cards(mesh_shape: str = 'dp=2,tp=2'):
    """:func:`phase_train_ddp_cards` with ``--mesh_shape dp=2,tp=2
    --seq_parallel``: the backbone split over each pair of cards, the
    batch over the pairs (run alone on four cards: ``python -c "import
    chip_smoke as c; c.phase_device(); c.phase_build();
    c.phase_train_tp_cards()"``)."""
    return _train_cards('train tp cards', ('--mesh_shape', mesh_shape,
                                           '--seq_parallel'))


def _train_cards(tag: str, extra) -> dict:
    """The driver over NCCL, one rank a visible card with the flags
    ``extra``, against one card (the two phases above)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from mmvid_tpu_torch import train
    from mmvid_tpu_torch.config import process_args
    os.environ.setdefault('NCCL_SOCKET_IFNAME', 'lo')
    print(f'[{tag}] on {card()}', flush=True)
    tmp = tempfile.mkdtemp(prefix='mmvid_cards_')
    try:
        tree = write_driver_data(os.path.join(tmp, 'vox_text'), 48 * 4,
                                 DRIVER_CLIP_FRAMES, distinct=48)
        write_vqgan_ckpt(os.path.join(tmp, 'vae.ckpt'), 7)
        base = recipe_argv('text_to_video', 'train.sh', {
            '--image_text_folder': tree,
            '--vae_path': os.path.join(tmp, 'vae.ckpt')}) + [
            '--iters', str(DDP_CARD_ITERS), '--log_every', '1', '--bf16',
            '--batch_size', str(DDP_BATCH), '--deterministic',
            '--save_every_n_steps', '100000', '--sample_every', '100000']
        args = process_args(train=True, argv=base + [
            '--log_root', os.path.join(tmp, 'cards'),
            '--multiprocessing_distributed',
            '--dist_url', f'file://{tmp}/store', *extra])
        nprocs = train.spawn_count(args)
        results = mp.get_context('spawn').Queue()
        mp.start_processes(_ddp_card_rank, args=(nprocs, args, results),
                           nprocs=nprocs, start_method='spawn')
        ranks = dict(results.get() for _ in range(nprocs))
        torch.cuda.reset_peak_memory_stats(0)
        rec = train.main_worker(process_args(train=True, argv=base + [
            '--log_root', os.path.join(tmp, 'one')]))
        one = {'metrics': _driver_metrics(rec), 'step_ms': _steady(rec)[0],
               'peak': torch.cuda.max_memory_allocated(0)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gaps = {i: {k: abs(ranks[0]['metrics'][i][k] - v) / abs(v)
                for k, v in m.items()} for i, m in one['metrics'].items()}
    same = all(r['metrics'] == ranks[0]['metrics'] for r in ranks.values())
    res = {'ranks': nprocs, 'flags': list(extra), 'rank_results': ranks,
           'one_card': one, 'relative_gaps': gaps,
           'same_metrics_on_every_rank': same}
    print(f'[{tag}] {nprocs} ranks over NCCL {" ".join(extra)} at global '
          f'batch {DDP_BATCH}: every rank logged the same metrics: {same}; '
          f'against one card, iteration 0\'s relative gaps {gaps[0]}; step '
          f'{[r["step_ms"] for r in ranks.values()]} ms a rank (one card '
          f'{one["step_ms"]:.2f} ms), peak {ranks[0]["peak"]} B a rank '
          f'(one card {one["peak"]} B): one call, no scaling number',
          flush=True)
    print(f'[{tag}] {json.dumps(res)}', flush=True)
    if not same or max(gaps[0].values()) > DDP_CARDS_TOL:
        fail(f'{tag}: the ranks disagree, or differ from one card')
    return res

# the shards' attention in phase_attention_tp: B16 H6 / H3 (the 12 heads
# over tp 2 / 4) D64 on the packed views of a [B, L, 3 D / tp] projection,
# at the flagship's L565 and text+mask's L629 (mask_prev) and ART-V's
# L626 (causal); timed at L565, the flagship training step's shape
ATTN_TP_HEADS = (6, 3)
ATTN_TP_SHAPES = ((565, 'mask_prev', (51, 52)), (629, 'mask_prev', (115, 116)),
                  (626, 'causal', None))
ATTN_TP_TIMED_L = 565

def phase_attention_tp():
    """B1 and B1-bwd at a tp rank's heads (ATTN_TP_HEADS, ATTN_TP_SHAPES),
    bf16 and fp32: the forward kernel against ``attention_reference``
    within ATTN_TOL; through ``FusedAttention`` (the forward with its
    statistics, then the backward kernels) against autograd through the
    plain version, and the backward kernels alone against
    ``attention_backward``, within ATTN_BWD_TOL and ATTN_BWD_NORM_TOL.  At
    L565: the forward kernel, its plain version and SDPA's forward timed;
    the backward kernels, their plain version and SDPA's forward and
    backward timed; the bounds (4 B H L^2 D and 10 B H L^2 D operations at
    the shard's H).  Returns rows by dtype and heads."""
    import torch
    from mmvid_tpu_torch.models.clip import build_attention_mask
    from mmvid_tpu_torch.ops import attention as A

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f'[attention tp] on {card()}', flush=True)
    b, d = 16, 64
    rows = {}
    for h in ATTN_TP_HEADS:
        for l, kind, idx in ATTN_TP_SHAPES:
            mask = build_attention_mask(l, kind, index=idx, device='cuda')
            scale = d ** -0.5
            for name in ('bfloat16', 'float32'):
                dtype = getattr(torch, name)
                g = torch.Generator(device='cuda').manual_seed(l * h)
                qkv = torch.randn((b, l, 3 * h * d), generator=g,
                                  device='cuda').to(dtype)
                cot = torch.randn((b, l, h, d), generator=g,
                                  device='cuda').to(dtype)
                q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(
                    b, l, h, d) for i in range(3))
                before = A.launches
                out = A.fused_attention_blhd(q, k, v, mask)
                ref = A.attention_reference(q, k, v, mask, scale)
                fwd_err = (out.float() - ref.float()).abs().max().item()
                got = _packed_grads(A.fused_attention_blhd, qkv, cot, mask)
                want = _packed_grads(lambda q_, k_, v_, m: A.
                                     attention_reference(q_, k_, v_, m,
                                                         scale),
                                     qkv, cot, mask)
                fn_rel, fn_norm = _bwd_errors((got,), (want,))
                o, lse, out_lo = A._launch(q, k, v, mask, scale, False,
                                           with_lse=True)
                args = (q, k, v, mask, scale, cot, o, lse, out_lo)
                kern = A.attention_backward_kernel(*args)
                plain = A.attention_backward(q, k, v, mask, scale, cot)
                torch.cuda.synchronize()
                launched = A.launches - before
                rel, norm = _bwd_errors(kern, plain)
                bwd_err = max((x.float() - w.float()).abs().max().item()
                              for x, w in zip(kern, plain))
                key = f'B{b}_L{l}_H{h}_D{d}_{kind}'
                row = {'forward': {'max_abs_err': fwd_err},
                       'backward': {'max_abs_err': bwd_err,
                                    'max_rel_err': rel,
                                    'max_norm_rel_err': norm,
                                    'function_max_rel_err': fn_rel,
                                    'function_max_norm_rel_err': fn_norm}}
                del got, want, kern, plain, out, ref
                if l == ATTN_TP_TIMED_L:
                    kind_ = 'bf16' if name == 'bfloat16' else 'fp32'
                    item = 2 if name == 'bfloat16' else 4
                    fb, fby = bound(4 * b * l * h * d * item + l * l * 4,
                                    4 * b * h * l * l * d, kind_)
                    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                    mt = mask.to(dtype)
                    with torch.no_grad():
                        row['forward'].update(
                            ms=cuda_time_ms(lambda: A.fused_attention_blhd(
                                q, k, v, mask)),
                            plain_ms=cuda_time_ms(lambda: A.
                                                  attention_reference(
                                                      q, k, v, mask, scale),
                                                  calls=5, reps=3),
                            library_ms=cuda_time_ms(
                                lambda: torch.nn.functional.
                                scaled_dot_product_attention(
                                    qt, kt, vt, attn_mask=mt)),
                            bound_ms=fb, bound_by=fby)
                    bb, bby, _ = attention_backward_bound(b, l, h, d, name)
                    qg, kg, vg = (t.detach().requires_grad_(True)
                                  for t in (qt, kt, vt))
                    ct = cot.transpose(1, 2)

                    def sdpa():
                        y = torch.nn.functional.scaled_dot_product_attention(
                            qg, kg, vg, attn_mask=mt)
                        return torch.autograd.grad(y, (qg, kg, vg), ct)

                    row['backward'].update(
                        ms=cuda_time_ms(lambda: A.attention_backward_kernel(
                            *args)),
                        plain_ms=cuda_time_ms(lambda: A.attention_backward(
                            q, k, v, mask, scale, cot), calls=5, reps=3),
                        library_ms=cuda_time_ms(sdpa),
                        bound_ms=bb, bound_by=bby)
                    del qg, kg, vg
                rows.setdefault(name, {})[key] = row
                f, w = row['forward'], row['backward']
                print(f'[attention tp] {key} {name}: forward max abs err '
                      f'{fwd_err:.3e} (tol {ATTN_TOL[(name, False)]}); '
                      f'backward kernels vs plain {rel:.3e} / normwise '
                      f'{norm:.3e}, through FusedAttention {fn_rel:.3e} / '
                      f'{fn_norm:.3e} (tol {ATTN_BWD_TOL[name]} / '
                      f'{ATTN_BWD_NORM_TOL[name]}); forward launches '
                      f'{launched}' + (
                          f'; forward kernel {f["ms"]:.4f} ms plain '
                          f'{f["plain_ms"]:.4f} sdpa {f["library_ms"]:.4f} '
                          f'bound {f["bound_ms"]:.4f} ({f["bound_by"]}); '
                          f'backward kernels {w["ms"]:.4f} ms plain '
                          f'{w["plain_ms"]:.4f} sdpa forward+backward '
                          f'{w["library_ms"]:.4f} bound {w["bound_ms"]:.4f} '
                          f'({w["bound_by"]})' if 'ms' in f else ''),
                      flush=True)
                if not fwd_err <= ATTN_TOL[(name, False)]:
                    fail(f'attention tp {key} {name}: forward max abs err '
                         f'{fwd_err}')
                if not (_bwd_ok(rel, norm, name)
                        and _bwd_ok(fn_rel, fn_norm, name)):
                    fail(f'attention tp {key} {name}: backward {rel} / '
                         f'{fn_rel}, normwise {norm} / {fn_norm}')
                if launched != 3:
                    fail(f'attention tp {key} {name}: {launched} forward '
                         'launches, not 3')
                del qkv, cot, q, k, v, o, lse, out_lo, args
            torch.cuda.empty_cache()
    return rows


# two ranks on the one card over gloo at tp = 2: the flagship's training
# step at batch 16 (both ranks hold all 16 rows) against the one-rank step
# on the same weights (the backbone's biases drawn nonzero, so that a bias
# added twice shows) and generator, held to DDP_TOL.  The tp step's
# arithmetic is the one-rank step's but for the partial sums over the two
# ranks in fp32: a row product keeps its fp32 result on each rank
# (``parallel.tensor.row_product``), so the sum rounds once, as the
# one-rank product does; the column products' input gradients are the
# ranks' bf16 products summed.  Readings on the H100: fp32 losses 1.4e-7,
# the gradient 2.9e-7; bf16 with each rank's row product rounded to bf16
# before the sum, loss_vid 1.13e-3 (the reason for row_product); the
# planted faults (fp32; predicted: grad_norm a fifth off, losses 1e-2,
# the gradient a third off) read grad_norm 9.4e-2 (the norm counting the
# replicated parameters twice), loss_rel 3.4e-2 (a row bias added on both
# ranks), the gradient 2.4e-2 (the seq_parallel partial gradients left
# unreduced), each out of DDP_TOL['float32'].
TP_RANKS, TP_BATCH, TP_STEPS = 2, 16, 3
# the three steps and the planted faults run on the batch's first rows
# (each of the step's collectives moves a [B, L, D] tensor through host
# memory under gloo: about 50 ms at batch 16)
TP_EXTRA_BATCH = 4
TP_FAULTS = (('norm', False), ('bias', False), ('seq_grads', True))


def _tp_fault(kind):
    """A TensorParallel class with one planted fault (tests/
    test_torch_tensor_parallel.py's)."""
    import torch
    from mmvid_tpu_torch.parallel import tensor

    class Fault(tensor.TensorParallel):
        if kind == 'norm':
            def norm_sq(self, split_sq, repl_sq):
                return self.sum(split_sq + repl_sq)
        elif kind == 'bias':
            def leave(self, y, bias, dtype):
                return super().leave(y + bias.to(y.dtype),
                                     torch.zeros_like(bias), dtype)
        else:
            def reduce_seq_grads_(self, grads):
                pass
    return Fault


def perturb_biases(model, seed):
    """The backbone's biases and LayerNorm shifts drawn N(0, 0.1) (the
    builds make them zero, which would hide a bias added twice)."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.core.transformer.named_parameters():
            if name.endswith('bias'):
                p.copy_((torch.randn(p.shape, generator=gen) * 0.1).to(
                    p.device))


def _tp_hold(dp, dtype_name: str, planted: bool) -> dict:
    """One rank of phase_train_tp_gloo at ``dtype_name``: the flagship's
    training build from seed 0 (a spread codebook, nonzero biases), the
    recipe's TrainConfig at a constant lr, ``breakdown.train_batch``'s
    rows.  Step 1 at tp = 2 without and with seq_parallel at batch
    TP_BATCH; with ``planted``, then at batch TP_EXTRA_BATCH TP_STEPS
    seq_parallel steps, after which the replicated parameters are compared
    bit for bit over the ranks, and step 1 under each planted fault.
    Every run's launches are counted and captured (held against the plain
    versions).  Then rank 0 alone takes the one-rank steps; the gaps
    (``_ddp_gaps``) against them."""
    import copy

    import torch
    import torch.distributed as dist

    from mmvid_tpu_torch import breakdown, factories, training
    from mmvid_tpu_torch.parallel import mesh, tensor
    dev = dp.device
    dtype = getattr(torch, dtype_name)
    free, total = torch.cuda.mem_get_info()
    print(f'[train tp rank {dp.tp.rank}] {dtype_name}: the card has {free} '
          f'of {total} B free', flush=True)
    full, _ = factories.flagship_train(dtype=dtype, device=dev, seed=0)
    _spread_codebook([full], 3)
    perturb_biases(full, 4)
    tc = breakdown.train_config('train', lr_scheduler='none')
    data = breakdown.train_batch(full, TP_BATCH, dev)
    small = {k: v[:TP_EXTRA_BATCH] for k, v in data.items()}
    group = dp.tp.group

    def gen(i):
        return torch.Generator(device=dev).manual_seed(i)

    def first_step(tp, batch):
        model = copy.deepcopy(full)
        tensor.split_model(model, tp)
        state = training.create_train_state(model, tc)
        step = training.make_train_step(model, tc, mesh.LOCAL)
        state, m = step(state, batch, gen(0))
        mu = tensor.gather_state_dict(state.opt_state['mu'], tp)
        # on the host: the phase keeps one a run
        mu = torch.cat([t.reshape(-1) for t in mu.values()]).cpu()
        return ({k: float(v) for k, v in m.items()}, mu), model, state, step

    def counted(tag, sp, batch, steps):
        """``steps`` steps of a fresh split at ``batch``: (step 1's
        metrics and moment, the run's record, the last state)."""
        tp = tensor.TensorParallel(group, seq_parallel=sp)
        reset_counts()
        with _LaunchCapture(CAPTURE_SITES[:1] + BACKWARD_SITES) as cap:
            res, model, state, step = first_step(tp, batch)
            for i in range(1, steps):
                state, _ = step(state, batch, gen(i))
            torch.cuda.synchronize()
        run = {'batch': batch['text'].shape[0], 'steps': steps,
               'launches': read_counts(),
               'attention_backward_launches': backward_launches(),
               'heads': sorted({key[1][2] for key in cap.calls})}
        run['checked'] = check_captured(
            f'train tp rank {tp.rank} {dtype_name} {tag}', cap,
            {'attention': run['launches']['attention'],
             'attention_backward': run['attention_backward_launches']})
        out['runs'][tag] = run
        del model, step, cap
        torch.cuda.empty_cache()
        return res, state

    out = {'params': sum(p.numel() for p in training.trainable_parameters(
        full).values()), 'runs': {}}
    t0 = time.perf_counter()
    tp_runs = {sp: counted(f'seq_parallel={sp}', sp, data, 1)[0]
               for sp in (False, True)}
    faults = {}
    if planted:
        _, state = counted('seq_parallel=True, 3 steps', True, small,
                           TP_STEPS)
        bits = torch.cat([p.detach().reshape(-1) for n, p in
                          state.params.items()
                          if tensor.split_dim(n) is None]).view(torch.int32)
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        out['replicated_bit_identical'] = torch.equal(hi, lo)
        del bits, hi, lo, state
        for kind, sp in TP_FAULTS:
            faults[kind] = first_step(_tp_fault(kind)(
                group, seq_parallel=sp), small)[0]
    torch.cuda.empty_cache()
    out['steps_s'] = time.perf_counter() - t0
    dp.barrier()
    if dp.tp.rank == 0:
        one = first_step(tensor.LOCAL_TP, data)[0]
        out['metrics'] = {'tp2': tp_runs[False][0],
                          'tp2_seq_parallel': tp_runs[True][0],
                          'one_rank': one[0]}
        out['gaps'] = {'tp2': _ddp_gaps(tp_runs[False], one),
                       'tp2_seq_parallel': _ddp_gaps(tp_runs[True], one)}
        if planted:
            one = first_step(tensor.LOCAL_TP, small)[0]
            out['fault_gaps'] = {k: _ddp_gaps(v, one)
                                 for k, v in faults.items()}
    del full
    torch.cuda.empty_cache()
    dp.barrier()
    return out


def _tp_rank(rank: int, world: int, store: str, results):
    """A rank of phase_train_tp_gloo (a spawned process): on cuda:0 over
    gloo at tp = 2, fp32 with the planted faults, then bf16; TF32 off."""
    import traceback
    os.environ['GLOO_SOCKET_IFNAME'] = 'lo'
    try:
        import torch

        from mmvid_tpu_torch.ops.precision import fp32_exact
        from mmvid_tpu_torch.parallel import mesh
        dp = mesh.init('gloo', torch.device('cuda', 0), rank, world,
                       f'file://{store}', mesh_shape=f'tp={world}')
        try:
            with fp32_exact():
                out = {'float32': _tp_hold(dp, 'float32', planted=True),
                       'bfloat16': _tp_hold(dp, 'bfloat16', planted=False)}
        finally:
            mesh.shutdown()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def _cgroup_pids() -> str:
    """The processes and threads this machine's cgroup counts against its
    limit, 'current / max' (read only; 'not readable' where absent)."""
    for d in ('/sys/fs/cgroup', '/sys/fs/cgroup/pids'):
        try:
            with open(f'{d}/pids.current') as f, open(f'{d}/pids.max') as m:
                return f'{f.read().strip()} / {m.read().strip()}'
        except OSError:
            continue
    return 'not readable'


def free_card_memory(tag: str):
    """Before ranks start on the card: this process's unreachable tensors
    collected and its cached blocks released; prints what it still holds,
    its threads, the cgroup's task count and the card's free memory.  The
    guard of C8 (ROADMAP): fails if another process still holds the card
    (a rank of an earlier phase) or a loader thread of an earlier run is
    still alive in this one."""
    import gc
    import threading

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    # a stopped loader's producer ends within its put timeout (0.1 s)
    for t in threading.enumerate():
        if 'produce' in t.name:
            t.join(timeout=5)
    left = sorted(t.name for t in threading.enumerate()
                  if 'produce' in t.name)
    free, total = torch.cuda.mem_get_info()
    with open('/proc/meminfo') as f:
        host = next(ln.split()[1] for ln in f if ln.startswith('MemAvailable'))
    with open('/proc/self/status') as f:
        tasks = next(ln.split()[1] for ln in f if ln.startswith('Threads'))
    apps = subprocess.run(
        ['nvidia-smi', '--query-compute-apps=pid,used_memory',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(f'[{tag}] this process holds {torch.cuda.memory_allocated()} B '
          f'and {threading.active_count()} Python threads ({tasks} tasks); '
          f'the cgroup\'s tasks {_cgroup_pids()}; processes on the card '
          f'{apps}; the card has {free} of {total} B free; the host {host} '
          f'kB available', flush=True)
    if len(apps) > 1:
        fail(f'{tag}: another process holds the card: {apps}')
    if left:
        fail(f'{tag}: loader threads of an earlier run are alive: {left}')


def _spawn_ranks(target, n: int, args=(), timeout=DDP_TIMEOUT_S) -> dict:
    """Start ``n`` spawned processes ``target(rank, n, *args, results)``
    and collect each rank's result; a rank that fails or does not answer
    fails the smoke, and every process is stopped."""
    import torch.multiprocessing as mp
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, n, *args, results))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        outs = {}
        for _ in range(n):
            r, out = results.get(timeout=timeout)
            outs[r] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    for r, out in outs.items():
        if isinstance(out, str):
            fail(f'{target.__name__}: rank {r} failed:\n{out}')
    return outs


def phase_train_tp_gloo():
    """Two ranks on the one card over gloo (asked for; NCCL refuses two
    ranks on one device) with the backbone split at tp = 2: the flagship's
    training step at batch 16, fp32 and bf16 compute, without and with
    seq_parallel, against the one-rank step on the same weights and
    generator (:func:`_tp_hold`).  Gates: step 1 within DDP_TOL; after 3
    fp32 seq_parallel steps (at TP_EXTRA_BATCH rows) the replicated
    parameters bit-identical on the ranks; the planted faults (at
    TP_EXTRA_BATCH, against the one-rank step there) out of the fp32
    tolerance; each run's launches a rank those of as many flagship
    training steps (B1 72, B1-bwd 36, B3 2 a step), every attention call
    at H6, held against the plain versions.  The times go through host memory under gloo and
    are no scaling number."""
    import tempfile
    print(f'[train tp gloo] on {card()}', flush=True)
    tmp = tempfile.mkdtemp(prefix='mmvid_tp_')
    free_card_memory('train tp gloo')
    t0 = time.perf_counter()
    try:
        outs = _spawn_ranks(_tp_rank, TP_RANKS,
                            (os.path.join(tmp, 'store'),))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = outs[0]
    res = {'wall_s': wall, 'params': r0['float32']['params'],
           'float32': {k: r0['float32'][k] for k in (
               'metrics', 'gaps', 'fault_gaps', 'steps_s', 'runs',
               'replicated_bit_identical')},
           'bfloat16': {k: r0['bfloat16'][k] for k in (
               'metrics', 'gaps', 'steps_s', 'runs')},
           'rank1': {d: {k: outs[1][d][k] for k in ('runs', 'steps_s')}
                     for d in ('float32', 'bfloat16')},
           'tol': DDP_TOL}
    res['rank1']['replicated_bit_identical'] = outs[1]['float32'][
        'replicated_bit_identical']
    f32 = res['float32']
    runs = {(r, d, k): o[d]['runs'][k] for r, o in outs.items()
            for d in ('float32', 'bfloat16') for k in o[d]['runs']}
    print(f'[train tp gloo] {TP_RANKS} ranks on cuda:0 over gloo, tp='
          f'{TP_RANKS}, batch {TP_BATCH}: step 1 against the one-rank step, '
          f'relative gaps: fp32 {f32["gaps"]}, bf16 '
          f'{res["bfloat16"]["gaps"]} (tolerances {DDP_TOL}); the planted '
          f'faults (fp32) {f32["fault_gaps"]}; replicated parameters '
          f'bit-identical after {TP_STEPS} fp32 seq_parallel steps at batch '
          f'{TP_EXTRA_BATCH}: rank 0 '
          f'{f32["replicated_bit_identical"]}, rank 1 '
          f'{res["rank1"]["replicated_bit_identical"]}; launches by (rank, '
          f'dtype, run): ' + '; '.join(
              f'{key} {v["steps"]} steps {v["launches"]} backward '
              f'{v["attention_backward_launches"]} heads {v["heads"]}'
              for key, v in runs.items())
          + f'; fp32 {f32["steps_s"]:.2f} s, bf16 '
          f'{res["bfloat16"]["steps_s"]:.2f} s on rank 0 (gloo through host '
          f'memory: no scaling number); wall {wall:.1f} s', flush=True)
    print(f'[train tp gloo] {json.dumps(res)}', flush=True)
    for dtype in ('float32', 'bfloat16'):
        for sp, gaps in res[dtype]['gaps'].items():
            bad = _ddp_out_of_tol(gaps, dtype)
            if bad:
                fail(f'train tp gloo: {dtype} {sp} step 1 off the one-rank '
                     f'step in {bad}: {gaps}')
    for kind, gaps in f32['fault_gaps'].items():
        if not _ddp_out_of_tol(gaps, 'float32'):
            fail(f'train tp gloo: the planted fault {kind} passed the '
                 f'hold: {gaps}')
    if not (f32['replicated_bit_identical']
            and res['rank1']['replicated_bit_identical']):
        fail('train tp gloo: the replicated parameters differ on the ranks')
    heads = 12 // TP_RANKS
    for key, v in runs.items():
        want = expected(**{k: v['steps'] * n for k, n in
                           TRAIN_LAUNCHES['train'].items()})
        want_bwd = v['steps'] * TRAIN_BACKWARD_CALLS['train']
        if (v['launches'] != want or v['attention_backward_launches']
                != want_bwd or v['heads'] != [heads]):
            fail(f'train tp gloo: {key} launched {v["launches"]}, backward '
                 f'{v["attention_backward_launches"]} at heads {v["heads"]}; '
                 f'want {want}, {want_bwd} at [{heads}]')
    return res


# the training driver under tp: two launched ranks on cuda:0 over gloo,
# text_to_video/train.sh's flags at batch 4 in fp32 (the recipe's
# precision), iterations 0 and 1, the grid at iteration 1 (after the
# warm-up schedule's first update, whose lr is 0, so both runs sample from
# the same weights); against the one-rank run of the same flags
TP_DRIVER_BATCH, TP_DRIVER_ITERS = 4, 2
# the grid's tokens, tp run against one rank: argmax sampling and the
# confidence ranking of mask-predict decide on near-ties that the tp run's
# fp32 sums in another order (about 1e-7 relative) can tip, and a tipped
# choice changes the later steps of its sample; the share of equal tokens
# must reach this (the reading is printed; exact equality is its aim)
TP_GRID_TOKEN_SHARE = 0.95


class _GridTokens:
    """Installed (``with``): mask-predict sampling under the deterministic
    hook (argmax, the most confident tokens kept), each ``generate_images``
    call's tokens kept in ``seqs``."""

    def __enter__(self):
        import dataclasses

        from mmvid_tpu_torch.models import mmvid as pmmvid
        self.mod, self.seqs = pmmvid, []
        self.spec, self.gen = pmmvid.build_spec, pmmvid.MMVIDBert.\
            generate_images
        spec, gen, seqs = self.spec, self.gen, self.seqs
        pmmvid.build_spec = lambda *a, **k: dataclasses.replace(
            spec(*a, **k), deterministic=True)

        def generate(model, *a, **k):
            videos, seq = gen(model, *a, **k)
            seqs.append(seq.cpu())
            return videos, seq
        pmmvid.MMVIDBert.generate_images = generate
        return self

    def __exit__(self, *exc):
        self.mod.build_spec = self.spec
        self.mod.MMVIDBert.generate_images = self.gen


def _tp_driver_argv(tree, vae, logs):
    return recipe_argv('text_to_video', 'train.sh', {
        '--image_text_folder': tree, '--vae_path': vae}) + [
        '--log_root', logs, '--iters', str(TP_DRIVER_ITERS),
        '--save_every_n_steps', '100000', '--sample_every', '1',
        '--log_every', '1', '--batch_size', str(TP_DRIVER_BATCH),
        '--n_sample', '2', '--deterministic', '--device', 'cuda:0']


def _tp_driver_rank(rank: int, world: int, port: int, argv, results):
    """A rank of phase_train_driver_tp, as ``python -m
    torch.distributed.run`` starts it: ``train.main`` on cuda:0 over gloo
    at tp = 2 with --seq_parallel, TF32 off; its record and grid tokens."""
    import traceback
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                      MASTER_PORT=str(port), GLOO_SOCKET_IFNAME='lo')
    try:
        from mmvid_tpu_torch import train
        from mmvid_tpu_torch.ops.precision import fp32_exact
        reset_counts()
        with fp32_exact(), _GridTokens() as grid:
            rec = train.main(argv + ['--dist_backend', 'gloo',
                                     '--mesh_shape', f'tp={world}',
                                     '--seq_parallel'])
        results.put((rank, {'metrics': _driver_metrics(rec),
                            # numpy: a tensor in the queue outlives no rank
                            'tokens': [t.numpy() for t in grid.seqs],
                            'launches': read_counts(),
                            'attention_backward_launches':
                                backward_launches()}))
    except BaseException:
        results.put((rank, traceback.format_exc()))


def phase_train_driver_tp():
    """The training driver under tp: ``train.main`` in two ranks started
    through the launcher's environment on cuda:0 over gloo with
    ``--mesh_shape tp=2 --seq_parallel`` and text_to_video/train.sh's
    flags (batch 4, fp32), against one rank on the same flags: every
    iteration's metrics within DDP_TOL's fp32 losses, the grid's tokens
    equal under the deterministic hook; the checkpoint the tp run writes
    has the one-rank run's keys and shapes, and resumes in one process
    at tp = 1 for one more iteration."""
    import socket
    import tempfile

    import numpy as np
    import torch
    from mmvid_tpu_torch import train
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.ops.precision import fp32_exact
    print(f'[train driver tp] on {card()}', flush=True)
    free_card_memory('train driver tp')
    tmp = tempfile.mkdtemp(prefix='mmvid_tp_driver_')
    t0 = time.perf_counter()
    try:
        tree = write_driver_data(os.path.join(tmp, 'vox_text'),
                                 TP_DRIVER_BATCH * 4, DRIVER_CLIP_FRAMES,
                                 distinct=TP_DRIVER_BATCH)
        vae = os.path.join(tmp, 'vae.ckpt')
        write_vqgan_ckpt(vae, 7)
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
        t1 = time.perf_counter()
        ranks = _spawn_ranks(_tp_driver_rank, TP_RANKS, (port, _tp_driver_argv(
            tree, vae, os.path.join(tmp, 'tp'))))
        tp_s = time.perf_counter() - t1
        reset_counts()
        t1 = time.perf_counter()
        with fp32_exact(), _GridTokens() as grid:
            one = train.main_worker(process_args(
                train=True, argv=_tp_driver_argv(tree, vae, os.path.join(
                    tmp, 'one'))))
        one_s = time.perf_counter() - t1
        name = process_args(train=True, argv=_tp_driver_argv(
            tree, vae, tmp)).name
        last = os.path.join(tmp, 'tp', name, 'weights', 'last')
        a = torch.load(os.path.join(last, 'dalle.pt'), map_location='cpu',
                       weights_only=False)
        b = torch.load(os.path.join(tmp, 'one', name, 'weights', 'last',
                                    'dalle.pt'), map_location='cpu',
                       weights_only=False)
        layout = all(list(a[p]) == list(b[p]) and all(
            a[p][k].shape == v.shape for k, v in b[p].items())
            for p in ('weights', 'opt_state'))
        del a, b
        with fp32_exact():
            resumed = train.main_worker(process_args(train=True, argv=(
                _tp_driver_argv(tree, vae, os.path.join(tmp, 'resume'))
                + ['--dalle_path', last, '--iters',
                   str(TP_DRIVER_ITERS + 1)])))
        samples = sorted(os.listdir(os.path.join(tmp, 'tp', name,
                                                 'samples')))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = _driver_metrics(one)
    gaps = {r: {i: {k: abs(m[i][k] - v) / abs(v) for k, v in want[i].items()
                    if v} for i in want}
            for r, m in ((r, o['metrics']) for r, o in ranks.items())}
    shares = {r: (float(np.mean(np.concatenate([
        (x == y.numpy()).reshape(-1) for x, y in zip(o['tokens'],
                                                      grid.seqs)])))
        if len(o['tokens']) == len(grid.seqs) and grid.seqs else 0.0)
        for r, o in ranks.items()}
    same_tokens = all(v == 1.0 for v in shares.values())
    res = {'tp_run_s': tp_s, 'one_rank_s': one_s,
           'wall_s': time.perf_counter() - t0, 'relative_gaps': gaps,
           'grid_calls': len(grid.seqs), 'same_grid_tokens': same_tokens,
           'grid_token_share': shares,
           'one_rank_layout': layout, 'samples': samples,
           'resumed_start_iter': resumed['start_iter'],
           'resumed_iters': [r['iter'] for r in resumed['iters']],
           'rank_launches': {r: o['launches'] for r, o in ranks.items()},
           'rank_attention_backward_launches': {
               r: o['attention_backward_launches'] for r, o in ranks.items()}}
    print(f'[train driver tp] {TP_RANKS} launched ranks on cuda:0 over gloo, '
          f'--mesh_shape tp={TP_RANKS} --seq_parallel, batch '
          f'{TP_DRIVER_BATCH} fp32: {TP_DRIVER_ITERS} iterations in '
          f'{tp_s:.1f} s (one rank {one_s:.1f} s, gloo through host memory: '
          f'no scaling number); relative gaps to one rank {gaps}; grid '
          f'tokens equal {same_tokens} over {len(grid.seqs)} calls (share '
          f'equal by rank {shares}); the '
          f'checkpoint has the one-rank layout: {layout}; resumed at tp=1 '
          f'from iteration {resumed["start_iter"]}; launches a rank '
          f'{res["rank_launches"]}, attention backward '
          f'{res["rank_attention_backward_launches"]}', flush=True)
    print(f'[train driver tp] {json.dumps(res)}', flush=True)
    tol = DDP_TOL['float32']
    if any(v > (tol['grad_norm'] if k == 'grad_norm' else tol['loss'])
           for g in gaps.values() for it in g.values()
           for k, v in it.items()):
        fail(f'train driver tp: the tp run is off the one-rank run: {gaps}')
    if min(shares.values()) < TP_GRID_TOKEN_SHARE:
        fail(f'train driver tp: the grid tokens differ from one rank\'s: '
             f'{shares}')
    if not layout:
        fail('train driver tp: the checkpoint is not in the one-rank layout')
    if resumed['start_iter'] != TP_DRIVER_ITERS or not resumed['iters']:
        fail(f'train driver tp: resumed at {resumed["start_iter"]}')
    if not any(s.endswith('.png') for s in samples):
        fail(f'train driver tp: no grid written: {samples}')
    if not all(n['attention'] and res['rank_attention_backward_launches'][r]
               for r, n in res['rank_launches'].items()):
        fail(f'train driver tp: a rank ran without the attention kernels: '
             f'{res["rank_launches"]}')
    return res


def phase_test_driver(run_dir: str, tmp: str):
    """``python -m mmvid_tpu_torch.test`` through ``main_worker`` on
    ``text_to_video/test.sh``'s flags verbatim but the data and log paths
    and ``--dalle_path``, which names the training driver's run directory
    (its latest checkpoint): the first batch of 16, one sample, 4 rows of
    20 mask-predict rounds (fp32, as the script runs it), the grid and
    the page.  Gates: videos finite and in [0, 1], the grid written, the
    attention, sample-head and nearest-code kernels launched."""
    import torch
    from mmvid_tpu_torch import test as driver
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.models.mmvid import MMVIDBert

    argv = recipe_argv('text_to_video', 'test.sh', {
        '--image_text_folder': os.path.join(tmp, 'vox_text'),
        '--dalle_path': run_dir}) + [
        '--log_root', os.path.join(tmp, 'logs')]
    args = process_args(train=False, argv=argv)
    seen = []
    orig = MMVIDBert.generate_images

    def recorded(self, *a, **kw):
        out = orig(self, *a, **kw)
        v = out[0].float()
        seen.append((tuple(v.shape), bool(torch.isfinite(v).all()),
                     float(v.min()), float(v.max())))
        return out

    reset_counts()
    MMVIDBert.generate_images = recorded
    try:
        t0 = time.perf_counter()
        out = driver.main_worker(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        MMVIDBert.generate_images = orig
    counts = read_counts()
    frames = sum(s[0][0] * s[0][1] for s in seen)
    print(f'[test driver] {len(seen)} sampling calls {seen}; '
          f'visualize_train {out["sample_s"]:.2f} s '
          f'({frames / out["sample_s"]:.2f} frames/s, the '
          f'reconstruction and the grid included); {wall:.2f} s with '
          f'the load; launches {counts}', flush=True)
    if not seen or not all(ok and lo >= 0 and hi <= 1
                           for _, ok, lo, hi in seen):
        fail('test driver: videos not finite or outside [0, 1]')
    grid = os.path.join(out['sample_dir'], '0000000_0.png')
    if not os.path.isfile(grid):
        fail(f'test driver: {grid} not written')
    for name in ('attention', 'sample_head', 'codebook'):
        if counts[name] <= 0:
            fail(f'test driver: {name} launched no time')
    return {'launches': counts, 'sample_s': out['sample_s'],
            'frames_s': frames / out['sample_s'], 'calls': len(seen)}


# --eval_mode long on the test driver: each mode's flags and the frames a
# video (long: T + (t_repeat-1)(T - t_overlap); interp: T 2^(t_repeat-1);
# interp_real: last_tt T/2 + T - 1, last_tt = (T - T/2) // (T/4)) and its
# sampling calls (the windows), of which the first of long and interp
# preserves nothing
LONG_MODES = {
    'long': (['--t_repeat', '3', '--t_overlap', '1', '--save_codebook'],
             22, 3, 2),
    'interp': (['--t_repeat', '3'], 32, 7, 6),
    'interp_real': (['--t_repeat', '2'], 15, 3, 3)}


def _test_sh_argv(run_dir: str, tmp: str, *extra, data=None) -> list:
    """``text_to_video/test.sh``'s flags but the data and log paths, the run
    to sample, and ``extra``."""
    return recipe_argv('text_to_video', 'test.sh', {
        '--image_text_folder': data or os.path.join(tmp, 'vox_text'),
        '--dalle_path': run_dir}) + [
        '--log_root', os.path.join(tmp, 'logs'), *extra]


def _preserved_mismatch(model, kw, seq) -> int:
    """Tokens of a sampling call's preserved slots that differ from the
    sources it was given (``generate_images``'s ``preserve``)."""
    import torch
    from mmvid_tpu_torch.models.sampler import (
        arrange_preserve_tokens,
        preserve_layout,
    )
    mode, overlap = kw['long_mode'], kw.get('t_overlap', 1)
    pmask, _ = preserve_layout(model.cfg, mode, overlap, True)
    src = arrange_preserve_tokens(model.cfg, kw['preserve'], mode, overlap)
    pm = torch.as_tensor(pmask, device=seq.device)
    return int((seq[:, pm] != src[:, pm]).sum())


class _HostTime:
    """Accumulates the host seconds of ``module.name`` while installed
    (``with``): what a phase spends writing its PNGs."""

    def __init__(self, module, name: str):
        self.module, self.name, self.s = module, name, 0.0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed_call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(*a, **kw)
            finally:
                self.s += time.perf_counter() - t0
        setattr(self.module, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


# where the models call the kernels' wrappers: (kernel, module, name)
CAPTURE_SITES = (
    ('attention', 'mmvid_tpu_torch.models.clip', 'fused_attention_blhd'),
    ('sample_head', 'mmvid_tpu_torch.models.sampler', 'fused_sample_head'),
    ('codebook', 'mmvid_tpu_torch.models.vqgan', 'nearest_codebook_indices'))
# where FusedAttention.backward calls the backward kernels' wrapper
BACKWARD_SITES = (('attention_backward', 'mmvid_tpu_torch.ops.attention',
                   'attention_backward_kernel'),)
# the noise seed of the sample head's check on captured inputs
CAPTURE_SEED = 20260516


def _copy_qkv(q, k, v):
    """Copies of q, k, v [B, L, H, D] in their layout: strided views of one
    packed [B, L, 3 * H * D] buffer where they were such views (the main
    path's, models/clip.py), else contiguous tensors."""
    import torch
    b, l, h, d = q.shape
    packed = (l * 3 * h * d, 3 * h * d, d, 1)
    if all(t.stride() == packed for t in (q, k, v)):
        qkv = torch.cat([t.reshape(b, l, h * d) for t in (q, k, v)], -1)
        return [qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d)
                for i in range(3)]
    return [t.clone(memory_format=torch.contiguous_format)
            for t in (q, k, v)]


def _copy_inputs(kernel, a, kw):
    """A copy of a wrapper call's inputs that later calls cannot change."""
    from mmvid_tpu_torch.ops import attention as A
    if kernel == 'attention_backward':
        q, k, v, mask, scale, g, out, lse, out_lo = a[:9]
        # the mask's compact form (the models' masks are built once and
        # kept, so its bits stay as they are)
        compact = a[9] if len(a) > 9 else kw.get('compact')
        return (*_copy_qkv(q, k, v), mask.clone(), scale, g.clone(),
                out.clone(), lse.clone(),
                None if out_lo is None else out_lo.clone(), compact)
    if kernel == 'attention':
        q, k, v, mask = (tuple(a) + (None,))[:4]
        if isinstance(mask, A.AttentionMask):
            mask = A.AttentionMask(mask.dense.clone(), mask.compact)
        elif mask is not None:
            mask = mask.clone()
        return (*_copy_qkv(q, k, v), mask)
    if kernel == 'sample_head':
        x, ln_w, ln_b, w, b, temp = a[:6]
        return (x.clone(), ln_w.detach().clone(), ln_b.detach().clone(),
                w.detach().clone(), b.detach().clone(), float(temp),
                kw.get('w_prepared'))
    z, codebook = a[:2]
    return z.reshape(-1, z.shape[-1]).clone(), codebook.detach().clone()


def _shape_key(kernel, a) -> tuple:
    if kernel == 'attention_backward':
        return tuple(a[0].shape), str(a[0].dtype)
    if kernel == 'attention':
        return (tuple(a[0].shape), str(a[0].dtype),
                len(a) < 4 or a[3] is None)
    if kernel == 'sample_head':
        return tuple(a[0].shape), str(a[3].dtype)
    z, codebook = a[:2]
    return z.numel() // z.shape[-1], z.shape[-1], codebook.shape[0]


class _LaunchCapture:
    """Installed (``with``) over the names the models call the kernels'
    wrappers by (``sites``: CAPTURE_SITES, or BACKWARD_SITES in training):
    keeps a copy of the inputs of the first call at each shape a phase's
    run gives a kernel on the card, so that :func:`check_captured` can
    hold the kernel against its plain version at the shapes the run gave
    it, after the run's counts are read."""

    def __init__(self, sites=CAPTURE_SITES):
        self.sites = sites
        self.calls = {}   # (kernel, *shape key) -> inputs

    def __enter__(self):
        import importlib
        self.orig = []
        for kernel, mod_name, name in self.sites:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, name)
            self.orig.append((mod, name, fn))
            setattr(mod, name, self._wrap(kernel, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.orig:
            setattr(mod, name, fn)

    def _wrap(self, kernel, fn):
        def call(*a, **kw):
            key = (kernel,) + _shape_key(kernel, a)
            if key not in self.calls and a[0].device.type == 'cuda':
                self.calls[key] = _copy_inputs(kernel, a, kw)
            return fn(*a, **kw)
        return call


def _capture_name(kernel: str, key) -> str:
    """'attention B1 L757 H12 D64 float32', 'sample_head M512 W float32',
    'codebook M192 D256 K1024' from a :func:`_shape_key`."""
    if kernel == 'attention':
        (b, l, h, d), dtype, no_mask = key
        return (f'attention B{b} L{l} H{h} D{d} {dtype.split(".")[-1]}'
                f'{" no mask" if no_mask else ""}')
    if kernel == 'attention_backward':
        (b, l, h, d), dtype = key
        return (f'attention_backward B{b} L{l} H{h} D{d} '
                f'{dtype.split(".")[-1]}')
    if kernel == 'sample_head':
        (m, d), dtype = key
        return f'sample_head M{m} D{d} W {dtype.split(".")[-1]}'
    return 'codebook M{} D{} K{}'.format(*key)


def check_captured(tag: str, cap: _LaunchCapture, counts: dict) -> dict:
    """Each kernel's wrapper against its plain version on the inputs
    ``cap`` kept, TF32 off, at the tolerances of the kernel phases:
    attention within ATTN_TOL (and, for bf16 outputs, ATTN_DIFFER_MAX);
    the sample head against the plain version fed its Philox noise at one
    seed, tokens equal on HEAD_TOKEN_SHARE of rows and Y within
    HEAD_Y_REL_TOL (HEAD_Y_REL_TOL_FP32 for fp32 W) on those; nearest-code
    ids within CODE_GAP_TOL of the best score (the ids differing from
    plain printed); attention's backward kernels against
    ``attention_backward`` within ATTN_BWD_TOL * (1 + |plain|) and
    ATTN_BWD_NORM_TOL normwise, on the captured cotangent rescaled to unit
    RMS (``_unit_rms``; a step's own is tiny).  Fails
    beyond them, or where a kernel the run launched (``counts``) left no
    inputs.  Returns the errors by kernel and shape."""
    import torch
    from mmvid_tpu_torch.ops import attention as A
    from mmvid_tpu_torch.ops import codebook as C
    from mmvid_tpu_torch.ops import sample_head as S
    from mmvid_tpu_torch.ops.precision import fp32_exact

    for kernel, _, _ in cap.sites:
        if counts[kernel] > 0 and not any(key[0] == kernel
                                          for key in cap.calls):
            fail(f'{tag}: {kernel} launched but no call of its was captured')
    res = {}
    with fp32_exact(), torch.no_grad():
        for (kernel, *key), inp in cap.calls.items():
            if kernel == 'attention_backward':
                q, k, v, mask, scale, g = inp[:6]
                g = _unit_rms(g)
                got = A.attention_backward_kernel(q, k, v, mask, scale, g,
                                                  *inp[6:])
                want = A.attention_backward(q, k, v, mask, scale, g)
                dtype = str(q.dtype).split('.')[-1]
                rel, norm = _bwd_errors(got, want)
                tol = ATTN_BWD_TOL[dtype]
                ok = _bwd_ok(rel, norm, dtype)
                row = {'max_rel_err': rel, 'max_norm_rel_err': norm,
                       'tol': tol, 'norm_tol': ATTN_BWD_NORM_TOL[dtype]}
                del got, want
            elif kernel == 'attention':
                q, k, v, mask = inp
                bf16p = A.bf16_probs()
                got = A.fused_attention_blhd(q, k, v, mask)
                dense = (mask.dense if isinstance(mask, A.AttentionMask)
                         else mask)
                if dense is None:
                    dense = torch.zeros(q.shape[1:2] * 2, device=q.device)
                ref = A.attention_reference(q, k, v, dense,
                                            q.shape[-1] ** -0.5, bf16p)
                dtype = str(q.dtype).split('.')[-1]
                err = (got.float() - ref.float()).abs().max().item()
                differ = (got != ref).float().mean().item()
                tol = ATTN_TOL[(dtype, bf16p)]
                ok = err <= tol and (dtype != 'bfloat16' or bf16p
                                     or differ <= ATTN_DIFFER_MAX)
                row = {'max_abs_err': err, 'differ_share': differ,
                       'tol': tol}
            elif kernel == 'sample_head':
                x, ln_w, ln_b, w, b, temp, w_prepared = inp
                seed = torch.tensor([CAPTURE_SEED], dtype=torch.int64,
                                    device=x.device)
                g1, g2 = S.philox_gumbel(CAPTURE_SEED, x.shape[0],
                                         w.shape[1], x.device)
                y_ref, tok_ref = S.sample_head_reference(
                    x, ln_w, ln_b, w, b, temp, g1, g2)
                y, tok = S.sample_head_kernel(x, ln_w, ln_b, w, b, temp,
                                              seed, w_prepared=w_prepared)
                same = tok == tok_ref
                share = same.float().mean().item()
                y_rel = (((y - y_ref).abs() / y_ref)[same].max().item()
                         if same.any() else float('inf'))
                tol = (HEAD_Y_REL_TOL_FP32 if w.dtype == torch.float32
                       else HEAD_Y_REL_TOL)
                ok = share >= HEAD_TOKEN_SHARE and y_rel <= tol
                row = {'route': S.kernel_route(w), 'temp': temp,
                       'tokens_equal_share': share, 'y_rel_err': y_rel,
                       'tol': tol}
            else:
                z, cb = inp
                idx = C.nearest_codebook_indices(z, cb)
                ref = C.nearest_codebook_reference(z, cb)
                s = (z.double() @ cb.double().t()
                     - 0.5 * cb.double().square().sum(-1)[None])
                gap = (s.max(-1).values - s.gather(1, idx[:, None])[:, 0]
                       ).max().item()
                ok = gap <= CODE_GAP_TOL and 0 <= idx.min() and \
                    idx.max() < cb.shape[0]
                row = {'max_score_gap': gap, 'tol': CODE_GAP_TOL,
                       'ids_differing': int((idx != ref).sum())}
            torch.cuda.synchronize()
            name = _capture_name(kernel, key)
            print(f'[{tag}] {name} on the run\'s own inputs vs plain: '
                  f'{row}', flush=True)
            if not ok:
                fail(f'{tag}: {name} disagrees with its plain version on '
                     f'the run\'s inputs: {row}')
            res[name] = row
    return res


def phase_test_driver_long(run_dir: str, tmp: str):
    """``python -m mmvid_tpu_torch.test`` through ``main_worker`` on
    ``text_to_video/test.sh``'s flags (fp32, batch 16, 20 rounds a call)
    with ``--eval_mode long`` on the training driver's run, once for each
    ``--long_mode`` (``LONG_MODES``).  Gates: videos [16, frames, 128,
    128, 3] finite in [0, 1], ``long_{i}.png`` for each sample,
    ``codebook_long.npy`` [16, 22 * 64] with ``--save_codebook``, every
    sampling call's preserved slots equal to its sources, the sampling
    calls counted, the attention and sample-head kernels launched in each
    mode and the nearest-code kernel in ``interp_real`` (the batch's clips
    encoded) and with ``--save_codebook``, and each kernel held against its
    plain version on the inputs of its first launch at each shape the mode
    gave it (:func:`check_captured`)."""
    import numpy as np
    import torch
    from mmvid_tpu_torch import test as driver
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.models.mmvid import MMVIDBert
    from mmvid_tpu_torch.utils import viz

    orig = MMVIDBert.generate_images
    res = {}
    for mode, (flags, frames, calls, preserving) in LONG_MODES.items():
        args = process_args(train=False, argv=_test_sh_argv(
            run_dir, tmp, '--eval_mode', 'long', '--long_mode', mode,
            '--name_suffix', f'_long_{mode}', *flags))
        seen = []

        def recorded(self, *a, **kw):
            out = orig(self, *a, **kw)
            seen.append(None if kw.get('preserve') is None else
                        _preserved_mismatch(self, kw, out[1]))
            return out

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        MMVIDBert.generate_images = recorded
        try:
            with _HostTime(viz, 'save_image_array') as png_s, \
                    _LaunchCapture() as cap:
                out = driver.main_worker(args)
            torch.cuda.synchronize()
        finally:
            MMVIDBert.generate_images = orig
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        video = out['video']
        # args now hold the checkpoint's hparams
        b, size = args.batch_size, args.image_size
        rate = b * video.shape[1] / out['long_s']
        print(f'[test driver long] {mode}: {video.shape[1]} frames a video, '
              f'{len(seen)} sampling calls ({sum(s is not None for s in seen)}'
              f' preserving, preserved tokens differing {seen}); '
              f'visualize_long {out["long_s"]:.3f} s ({png_s.s:.3f} s of it '
              f'writing PNG strips), {rate:.2f} frames/s, peak {peak} B, on '
              f'{card()}; launches {counts}', flush=True)
        if video.shape != (b, frames, size, size, 3):
            fail(f'test driver long {mode}: videos {video.shape}')
        if not (np.isfinite(video).all() and video.min() >= 0
                and video.max() <= 1):
            fail(f'test driver long {mode}: videos not finite in [0, 1]')
        if len(seen) != calls or \
                sum(s is not None for s in seen) != preserving:
            fail(f'test driver long {mode}: {len(seen)} sampling calls')
        if any(seen):
            fail(f'test driver long {mode}: preserved tokens differ from '
                 f'their sources {seen}')
        for i in range(b):
            if not os.path.isfile(os.path.join(out['long_dir'],
                                               f'long_{i}.png')):
                fail(f'test driver long {mode}: long_{i}.png not written')
        need = ['attention', 'sample_head']
        if mode == 'interp_real' or '--save_codebook' in flags:
            need.append('codebook')
        for name in need:
            if counts[name] <= 0:
                fail(f'test driver long {mode}: {name} launched no time')
        if '--save_codebook' in flags:
            codes = np.load(os.path.join(
                os.path.dirname(out['long_dir']), 'codebook_long.npy'))
            if codes.shape != (b, frames * (size // 16) ** 2):
                fail(f'test driver long {mode}: codebook_long.npy '
                     f'{codes.shape}')
        res[mode] = {'launches': counts, 'frames': video.shape[1],
                     'long_s': out['long_s'], 'png_s': png_s.s,
                     'frames_s': rate, 'peak_bytes': peak,
                     'checked': check_captured(
                         f'test driver long {mode}', cap, counts)}
    return res


def phase_test_driver_debug(run_dir: str, tmp: str):
    """The test driver's sampling grids with ``--debug`` on ``test.sh``'s
    flags and ``--n_sample 16 --n_per_sample 1``: the PNAG trace of the
    whole batch (20 rounds, fp32) and a step grid a sample, each round's
    frames decoded in a call of their own.  Gates: the 16 ``_pnag``
    grids written; each step's keep count the preserved count (0) plus
    N - n_sched[t-1] (step 0: 0); the kernels launched, and held against
    their plain versions on the run's own inputs (:func:`check_captured`);
    peak memory printed (the captured inputs included)."""
    import torch
    from mmvid_tpu_torch import test as driver
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.models.mmvid import MMVIDBert
    from mmvid_tpu_torch.models.sampler import build_spec
    from mmvid_tpu_torch.utils import viz

    args = process_args(train=False, argv=_test_sh_argv(
        run_dir, tmp, '--debug', '--n_sample', '16', '--n_per_sample', '1',
        '--name_suffix', '_debug'))
    orig = MMVIDBert.generate_images_debug
    seen = []

    def recorded(self, *a, **kw):
        out = orig(self, *a, **kw)
        seen.append((self.cfg.target_seq_len, tuple(out[2].shape),
                     out[3].sum(-1).cpu()))
        return out

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    MMVIDBert.generate_images_debug = recorded
    try:
        t0 = time.perf_counter()
        with _HostTime(viz, 'save_pnag_debug_grid') as grid_s, \
                _LaunchCapture() as cap:
            out = driver.main_worker(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        MMVIDBert.generate_images_debug = orig
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if len(seen) != 1:
        fail(f'test driver debug: {len(seen)} trace calls')
    n, decodes_shape, keeps = seen[0]
    spec = build_spec(args.mp_config, n, steps=args.mask_predict_steps[0],
                      dynamic=False)
    want = torch.tensor([0] + [n - spec.n_sched[t - 1]
                               for t in range(1, spec.Tmax)])
    print(f'[test driver debug] step decodes {decodes_shape}, keep counts '
          f'a step {keeps[:, 0].tolist()}; visualize_train '
          f'{out["sample_s"]:.3f} s ({grid_s.s:.3f} s of it writing the '
          f'step grids; {wall:.3f} s with the load), peak {peak} B, on '
          f'{card()}; launches {counts}', flush=True)
    if decodes_shape != (spec.Tmax, 16, args.num_targets, args.image_size,
                         args.image_size, 3):
        fail(f'test driver debug: step decodes {decodes_shape}')
    if not torch.equal(keeps, want[:, None].expand_as(keeps)):
        fail('test driver debug: keep counts off the schedule')
    for i in range(16):
        grid = os.path.join(out['sample_dir'], '0000000_pnag',
                            f'{i:02d}.png')
        if not os.path.isfile(grid):
            fail(f'test driver debug: {grid} not written')
    for name in ('attention', 'sample_head', 'codebook'):
        if counts[name] <= 0:
            fail(f'test driver debug: {name} launched no time')
    return {'launches': counts, 'sample_s': out['sample_s'],
            'grid_s': grid_s.s, 'peak_bytes': peak, 'steps': spec.Tmax,
            'checked': check_captured('test driver debug', cap,
                                           counts)}


SHAPE_SIZES = ('small', 'large')
SHAPE_COLORS = ('red', 'blue', 'green')
SHAPE_KINDS = ('circle', 'square', 'triangle')
SHAPE_MOTIONS = ('left', 'up and right', 'down')


def shape_caption(i: int, motion: int = 0) -> str:
    """Clip i's caption 'A <size> <color> <shape> is moving <motion>':
    every color with every shape in 9 clips, ``motion`` shifting the
    motion alone."""
    return (f'A {SHAPE_SIZES[i % 2]} {SHAPE_COLORS[i % 3]} '
            f'{SHAPE_KINDS[(i // 3) % 3]} is moving '
            f'{SHAPE_MOTIONS[(i + motion) % 3]}')


def write_shapes_data(root: str, clips: int, frames: int, size: int = 128,
                      seed: int = 0) -> str:
    """A moving-shapes tree (``video/<key>/*.png``, ``txt/<key>.txt``) of
    ``clips`` clips, two captions a clip (:func:`shape_caption`: one
    object, two motions), written by the port's PNG writer."""
    import numpy as np
    from mmvid_tpu_torch.data import png
    rng = np.random.RandomState(seed)
    for i in range(clips):
        key = f'shape{i:04d}'
        d = os.path.join(root, 'video', key)
        os.makedirs(d)
        for j, img in enumerate(_smooth_frames(rng, frames, size)):
            png.write_png(os.path.join(d, f'{j:03d}.png'), img, (i + j) % 5)
        os.makedirs(os.path.join(root, 'txt'), exist_ok=True)
        with open(os.path.join(root, 'txt', f'{key}.txt'), 'w') as f:
            f.write(shape_caption(i) + '\n' + shape_caption(i, 1) + '\n')
    return root


def phase_test_driver_shapes(tmp: str):
    """The shapes evaluation through the test driver: a ``shape_attr``
    frame folder of 16 clips at 128 px, a full-width fp32 model with 3
    visual controls and a cvae from seeded weights saved as ``dalle.pt``,
    then ``test.sh``'s flags with ``--dataset shape_attr --attr_mode
    color+shape+background+rand --negvc --test_mode shapes``.  Gates:
    the grid's rows (real, reconstruction, the samples, the
    counterfactual and free rows, and one row a control slot swapped for
    its negative), the attention, sample-head and nearest-code (the
    cvae) kernels launched, and held against their plain versions on the
    run's own inputs (:func:`check_captured`: attention at B1 L757 with
    the 3-control mask, the cvae's M192)."""
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch import test as driver
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.data import png
    from mmvid_tpu_torch.generate import HPARAM_KEYS

    t0 = time.perf_counter()
    data = write_shapes_data(os.path.join(tmp, 'shapes'), 16,
                             DRIVER_CLIP_FRAMES)
    dalle = os.path.join(tmp, 'shapes_dalle.pt')
    argv = _test_sh_argv(dalle, tmp, '--dataset', 'shape_attr',
                         '--attr_mode', 'color+shape+background+rand',
                         '--negvc', '--test_mode', 'shapes', '--visual',
                         '--num_visuals', '3', '--name_suffix', '_shapes',
                         data=data)
    args = process_args(train=False, argv=argv)
    model = factories.get_driver_model(args, 'cuda', use_cvae=True,
                                       training=False)
    torch.save({'iter': 0, 'hparams': {k: getattr(args, k)
                                       for k in HPARAM_KEYS},
                'weights': model.state_dict()}, dalle)
    del model
    setup = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    with _LaunchCapture() as cap:
        out = driver.main_worker(process_args(train=False, argv=argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    grid = png.read_rgb(os.path.join(out['sample_dir'], '0000000_0.png'))
    rows = grid.shape[0] // (args.image_size + 2)
    want = 2 + args.n_per_sample + 2 + 3
    print(f'[test driver shapes] data and dalle.pt written in {setup:.2f} '
          f's; grid {grid.shape} ({rows} rows, {want} expected); '
          f'visualize_train {out["sample_s"]:.3f} s ({wall:.3f} s with the '
          f'load) on {card()}; launches {counts}', flush=True)
    if rows != want or grid.shape[0] != want * (args.image_size + 2):
        fail(f'test driver shapes: {rows} grid rows, not {want}')
    for name in ('attention', 'sample_head', 'codebook'):
        if counts[name] <= 0:
            fail(f'test driver shapes: {name} launched no time')
    return {'launches': counts, 'sample_s': out['sample_s'], 'rows': rows,
            'checked': check_captured('test driver shapes', cap,
                                           counts)}


# the fixed LM on the card against the CPU: max |features| difference
# over max |features|, fp32 with TF32 off on both (24 post-LN layers
# keep fp32 rounding near 1e-6 of the scale; a TF32 product reads about
# 1e-3)
ROBERTA_TOL = 1e-4
TEXT_AUGMENT_ITERS = 3


def _host_ms(fn, reps: int = 5) -> float:
    """Median host ms of ``fn()`` between two syncs, after a warm-up."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_roberta():
    """The fixed language model at full width: a synthetic roberta-large
    folder (``write_roberta_archive``: the published shapes, N(0, 0.02)
    weights, a ``RobertaForMaskedLM`` ``pytorch_model.bin``) read through
    ``factories.get_fixed_language_model`` on the card and on the CPU.
    Gate: the 4 recipe captions' features [4, 1024] finite, the card's
    within ``ROBERTA_TOL`` of max |features| from the CPU's.  Prints
    ``encode``'s host ms at batch 24 (text_augment/train.sh's) and 16
    (test.sh's), median of 5 between syncs, and the peak memory.  Returns
    (the numbers, the folder; the caller removes it)."""
    import tempfile
    import types

    import torch
    from mmvid_tpu_torch import factories

    folder = tempfile.mkdtemp(prefix='mmvid_roberta_')
    try:
        t0 = time.perf_counter()
        cfg, _ = write_roberta_archive(folder, seed=5)
        write_s = time.perf_counter() - t0
        os.environ['ROBERTA_PATH'] = folder
        args = types.SimpleNamespace(fixed_language_model='roberta-large')
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        encode, dim = factories.get_fixed_language_model(args, 'cuda')
        load_s = time.perf_counter() - t0
        cpu_encode, _ = factories.get_fixed_language_model(args, 'cpu')
        caps = list(ROBERTA_CAPTIONS[:4])
        got, want = encode(caps), cpu_encode(caps)
        del cpu_encode
        scale = float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        print(f'[roberta] {cfg.num_hidden_layers} layers x '
              f'{cfg.hidden_size}, vocabulary {cfg.vocab_size}: archive '
              f'written in {write_s:.2f} s, loaded on the card in '
              f'{load_s:.2f} s; features {tuple(got.shape)} card vs CPU '
              f'max |d| {err:.3e} of max |features| {scale:.4f} (bound '
              f'{ROBERTA_TOL} of it)', flush=True)
        if (tuple(got.shape) != (4, cfg.hidden_size)
                or dim != cfg.hidden_size
                or not bool(torch.isfinite(got).all())):
            fail(f'roberta: features {tuple(got.shape)}, dim {dim}, not '
                 f'finite or not [4, {cfg.hidden_size}]')
        if err > ROBERTA_TOL * scale:
            fail(f'roberta: the card is {err:.3e} from the CPU, over '
                 f'{ROBERTA_TOL} x {scale:.4f}')
        res = {'max_abs_err': err, 'max_abs_features': scale,
               'load_s': load_s, 'card': card()}
        for batch in (24, 16):
            texts = (list(ROBERTA_CAPTIONS) * 4)[:batch]
            res[f'encode_ms_b{batch}'] = _host_ms(lambda: encode(texts))
        res['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
        print(f'[roberta] encode {res["encode_ms_b24"]:.3f} ms at batch 24, '
              f'{res["encode_ms_b16"]:.3f} ms at 16 (host clock, median of '
              f'5 between syncs, tokenizer included); peak memory '
              f'{res["peak_memory_bytes"]} B; {res["card"]}', flush=True)
        return res, folder
    except BaseException:
        shutil.rmtree(folder, ignore_errors=True)
        raise


def phase_text_augment(tmp: str, roberta: str):
    """The text_augment recipe through the drivers with ``ROBERTA_PATH``
    at ``roberta`` (``phase_roberta``'s folder): ``train.sh``'s flags
    verbatim but the data and log paths and ``--iters 3 --log_every 1
    --image_size 128`` (test.sh's size, the vox frames'; fp32 at batch 24,
    as the script runs) on the training driver's
    synthetic tree and VQGAN checkpoint under ``tmp``; then ``test.sh``'s
    flags on that run (``--description "A girl."``, batch 16, 4 rows of 20
    rounds).  Gates: finite losses; the LM called once a step and once by
    the test driver; attention's launches, and its backward calls exact,
    in training; attention and the sample head launched in sampling; the
    videos finite in [0, 1]; the grid written."""
    import torch
    from mmvid_tpu_torch import breakdown, factories
    from mmvid_tpu_torch import test as test_driver
    from mmvid_tpu_torch import train as train_driver
    from mmvid_tpu_torch.config import process_args
    from mmvid_tpu_torch.models.mmvid import MMVIDBert

    os.environ['ROBERTA_PATH'] = roberta
    tree, logs = os.path.join(tmp, 'vox_text'), os.path.join(tmp, 'logs')
    # train.sh passes no --image_size, so both packages' get_vae_model
    # would build a 256 px VQGAN (2048 targets a video) that the 128 px
    # vox frames do not fill; test.sh passes 128 for the same model
    argv = recipe_argv('text_augment', 'train.sh', {
        '--image_text_folder': tree,
        '--vae_path': os.path.join(tmp, 'vae.ckpt')}) + [
        '--log_root', logs, '--iters', str(TEXT_AUGMENT_ITERS),
        '--log_every', '1', '--image_size', '128']
    args = process_args(train=True, argv=argv)
    run_dir = os.path.join(logs, args.name)
    lm_calls = []
    orig_lm = factories.get_fixed_language_model

    def timed_lm(a, device='cuda'):
        encode, dim = orig_lm(a, device)

        def timed_encode(texts):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = encode(texts)
            torch.cuda.synchronize()
            lm_calls.append((len(texts), (time.perf_counter() - t0) * 1e3))
            return out
        return timed_encode, dim

    factories.get_fixed_language_model = timed_lm
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        with _LaunchCapture(BACKWARD_SITES) as cap:
            record = train_driver.main_worker(args)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = read_counts()
        calls = breakdown.KERNELS['attention'].backward_calls
        bl = backward_launches()
        losses = _driver_losses(run_dir)
        step_ms, wait_ms = _steady(record)
        train_lm = list(lm_calls)
        lm_ms = statistics.mean(ms for _, ms in train_lm[1:])
        print(f'[text_augment] train.sh (fp32, batch {args.batch_size}): '
              f'step {step_ms:.2f} ms (mean of iterations '
              f'1-{TEXT_AUGMENT_ITERS - 1}, to the loss read), the LM '
              f'{lm_ms:.3f} ms of it ({lm_ms / step_ms:.4f}), loader wait '
              f'{wait_ms:.3f} ms; losses {losses}; LM calls {train_lm}; '
              f'launches {counts}, attention backward calls {calls} '
              f'(kernel launches {bl}); peak '
              f'memory {peak} B; {card()}', flush=True)
        if len(train_lm) != TEXT_AUGMENT_ITERS or any(
                n != args.batch_size for n, _ in train_lm):
            fail(f'text_augment: the LM calls {train_lm} are not one of '
                 f'{args.batch_size} captions a step')
        if sorted(losses) != list(range(TEXT_AUGMENT_ITERS)):
            fail(f'text_augment: iterations logged {sorted(losses)}')
        if not (calls == bl == _backward_calls(args, TEXT_AUGMENT_ITERS)):
            fail(f'text_augment: attention backward calls {calls}, kernel '
                 f'launches {bl} != '
                 f'{_backward_calls(args, TEXT_AUGMENT_ITERS)}')
        checked = check_captured('text_augment', cap,
                                 {'attention_backward': bl})
        for name in ('attention', 'codebook'):
            if counts[name] <= 0:
                fail(f'text_augment: {name} launched no time')

        targv = recipe_argv('text_augment', 'test.sh', {
            '--image_text_folder': tree, '--dalle_path': run_dir}) + [
            '--log_root', logs]
        targs = process_args(train=False, argv=targv)
        seen = []
        orig_gen = MMVIDBert.generate_images

        def recorded(self, *a, **kw):
            out = orig_gen(self, *a, **kw)
            v = out[0].float()
            seen.append((tuple(v.shape), bool(torch.isfinite(v).all()),
                         float(v.min()), float(v.max())))
            return out

        reset_counts()
        del lm_calls[:]
        MMVIDBert.generate_images = recorded
        try:
            out = test_driver.main_worker(targs)
            torch.cuda.synchronize()
        finally:
            MMVIDBert.generate_images = orig_gen
        tcounts = read_counts()
    finally:
        factories.get_fixed_language_model = orig_lm
    frames = sum(sh[0] * sh[1] for sh, *_ in seen)
    frames_s = frames / out['sample_s']
    print(f'[text_augment] test.sh ({targs.description!r}): {len(seen)} '
          f'sampling calls {seen}; visualize_train {out["sample_s"]:.2f} s '
          f'({frames_s:.2f} frames/s); LM calls {lm_calls}; launches '
          f'{tcounts}; {card()}', flush=True)
    if len(lm_calls) != 1:
        fail(f'text_augment: the test driver called the LM {lm_calls}')
    if not seen or not all(ok and lo >= 0 and hi <= 1
                           for _, ok, lo, hi in seen):
        fail('text_augment: videos not finite or outside [0, 1]')
    grid = os.path.join(out['sample_dir'], '0000000_0.png')
    if not os.path.isfile(grid):
        fail(f'text_augment: {grid} not written')
    for name in ('attention', 'sample_head'):
        if tcounts[name] <= 0:
            fail(f'text_augment test: {name} launched no time')
    return {'step_ms': step_ms, 'lm_ms': lm_ms, 'loader_wait_ms': wait_ms,
            'lm_share': lm_ms / step_ms, 'peak_memory_bytes': peak,
            'launches': counts, 'attention_backward_calls': calls,
            'attention_backward_launches': bl, 'checked': checked,
            'test_frames_s': frames_s, 'test_launches': tcounts}


def _cpu_i3d_check(i3d):
    """I3D on the card against the same weights on the CPU, one clip of 15
    frames: (max abs error over max |CPU|, TF32 off as eval runs it; the
    same with cuDNN's default TF32)."""
    import copy

    import torch
    from mmvid_tpu_torch.ops.precision import fp32_exact
    g = torch.Generator().manual_seed(3)
    clip = torch.rand((1, 15, 224, 224, 3), generator=g) * 2 - 1
    cpu = copy.deepcopy(i3d).cpu()
    with torch.no_grad():
        ref = cpu.embed(clip)
        with fp32_exact():
            got = i3d.embed(clip.cuda()).cpu()
        conv = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32 = i3d.embed(clip.cuda()).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = conv
    scale = ref.abs().max().item()
    return ((got - ref).abs().max().item() / scale,
            (tf32 - ref).abs().max().item() / scale)


def phase_eval():
    """FVD / PRD evaluation at full width: the flagship (bf16, 20 rounds)
    at the evaluation script's batch 16 through ``eval.evaluate.evaluate``
    over EVAL_SAMPLES samples with a random I3D
    (MMVID_ALLOW_RANDOM_I3D=1): launch counts exact (EVAL_LAUNCHES a
    batch), embeddings finite [EVAL_SAMPLES, 400], FVD of the generated
    set against itself about 0 (FVD_SELF_TOL), I3D on the card within
    I3D_CARD_TOL of the CPU on one clip (TF32 off; the TF32 reading
    reported); then ``bench_eval.measure_eval``: samples/s, the 2048-sample
    extrapolation, generation and ping-pong + I3D ms a batch, peak
    memory, and I3D's ms a batch with TF32 for comparison."""
    import tempfile

    import numpy as np
    import torch
    from mmvid_tpu_torch import bench_eval, breakdown
    from mmvid_tpu_torch.eval import evaluate as E
    from mmvid_tpu_torch.eval.fvd import frechet_distance, preprocess_videos
    from mmvid_tpu_torch.ops.precision import fp32_exact

    os.environ['MMVID_ALLOW_RANDOM_I3D'] = '1'
    os.environ.pop('I3D_CHECKPOINT', None)
    model = breakdown.build('flagship')
    n_batches = EVAL_SAMPLES // EVAL_BATCH
    with tempfile.TemporaryDirectory(prefix='mmvid_eval_') as tmp:
        args = bench_eval.eval_args(model, EVAL_BATCH, EVAL_SAMPLES, tmp)
        batches = bench_eval.synthetic_batches(model, EVAL_BATCH, n_batches)
        reset_counts()
        res = E.evaluate(args, model, batches, metrics=('fvd', 'prd'))
        torch.cuda.synchronize()
        counts = read_counts()
        real = np.load(os.path.join(tmp, 'real_embs.npy'))
        fake = np.load(os.path.join(tmp, 'fake_embs.npy'))
    want = expected(**{k: v * n_batches for k, v in EVAL_LAUNCHES.items()})
    print(f'[eval] {EVAL_SAMPLES} samples at batch {EVAL_BATCH}: FVD '
          f'{res["fvd"]:.4f}, PRD {res["prd"]}; launches {counts}',
          flush=True)
    if counts != want:
        fail(f'eval: launches {counts} != {want}')
    for name, e in (('real', real), ('fake', fake)):
        if e.shape != (EVAL_SAMPLES, 400) or not np.isfinite(e).all():
            fail(f'eval: {name} embeddings {e.shape}, finite '
                 f'{np.isfinite(e).all()}')
    if not np.isfinite(res['fvd']):
        fail(f'eval: FVD {res["fvd"]}')
    self_fvd = frechet_distance(fake, fake)
    trace = float(np.trace(np.cov(fake, rowvar=False)))
    print(f'[eval] FVD of the generated set against itself {self_fvd:.3e} '
          f'(trace of its covariance {trace:.4f})', flush=True)
    if not abs(self_fvd) <= FVD_SELF_TOL * trace:
        fail(f'eval: FVD(x, x) = {self_fvd}')

    i3d = E.build_i3d(args, None, torch.device('cuda'))
    err, err_tf32 = _cpu_i3d_check(i3d)
    print(f'[eval] I3D card vs CPU, one clip: max abs err / max |CPU| '
          f'{err:.3e} in fp32 (tol {I3D_CARD_TOL}), {err_tf32:.3e} with '
          f'TF32', flush=True)
    if not err <= I3D_CARD_TOL:
        fail(f'eval: I3D on the card {err} from the CPU')

    timing = bench_eval.measure_eval(model, EVAL_BATCH, EVAL_SAMPLES)
    clips = preprocess_videos(torch.rand(
        (EVAL_BATCH, 15, 128, 128, 3), device='cuda'))
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            tf32_ms = breakdown.steady(lambda: i3d.embed(clips))[0] * 1e3
            with fp32_exact():
                fp32_ms = breakdown.steady(lambda: i3d.embed(clips))[0] * 1e3
    finally:
        torch.cuda.synchronize()
        torch.backends.cudnn.allow_tf32 = conv
    out = {**timing, 'launches': counts, 'fvd_self': self_fvd,
           'i3d_card_vs_cpu': err, 'i3d_tf32_vs_cpu': err_tf32,
           'i3d_batch_ms_fp32': fp32_ms, 'i3d_batch_ms_tf32': tf32_ms}
    print(f'[eval] {json.dumps(out)}', flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def _check_metrics(tag, metric_dir, n):
    import numpy as np
    for name in ('real_embs.npy', 'fake_embs.npy', 'fvd_score.txt',
                 'prd_data.pkl', 'prd_score.txt'):
        if not os.path.isfile(os.path.join(metric_dir, name)):
            fail(f'{tag}: {name} not written')
    for name in ('real_embs.npy', 'fake_embs.npy'):
        e = np.load(os.path.join(metric_dir, name))
        if e.shape != (n, 400) or not np.isfinite(e).all():
            fail(f'{tag}: {name} {e.shape}')
    with open(os.path.join(metric_dir, 'fvd_score.txt')) as f:
        text = f.read()
    if f'n_samples = {n}' not in text:
        fail(f'{tag}: fvd_score.txt says {text!r}')


def phase_test_driver_eval(run_dir: str, tmp: str):
    """``python -m mmvid_tpu_torch.test`` through ``main_worker`` on
    ``text_to_video/evaluation.sh``'s flags verbatim but the data and log
    paths, ``--dalle_path`` (the training driver's run directory) and
    ``--eval_num`` EVAL_SAMPLES (4 batches of 16), random I3D: every
    artifact written, FVD finite, the embeddings [EVAL_SAMPLES, 400], the
    attention and sample-head kernels launched."""
    import math

    import torch
    from mmvid_tpu_torch import test as driver
    from mmvid_tpu_torch.config import process_args

    os.environ['MMVID_ALLOW_RANDOM_I3D'] = '1'
    os.environ.pop('I3D_CHECKPOINT', None)
    argv = recipe_argv('text_to_video', 'evaluation.sh', {
        '--image_text_folder': os.path.join(tmp, 'vox_text'),
        '--dalle_path': run_dir, '--eval_num': str(EVAL_SAMPLES)}) + [
        '--log_root', os.path.join(tmp, 'logs')]
    args = process_args(train=False, argv=argv)
    reset_counts()
    t0 = time.perf_counter()
    results = driver.main_worker(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f'[test driver eval] {args.eval_metric} over {args.eval_num} '
          f'samples at batch {args.batch_size}: {results}; {wall:.2f} s '
          f'with the load; launches {counts}', flush=True)
    if not math.isfinite(results.get('fvd', math.nan)):
        fail(f'test driver eval: FVD {results.get("fvd")}')
    _check_metrics('test driver eval', args.log_metric_dir, EVAL_SAMPLES)
    for name in ('attention', 'sample_head'):
        if counts[name] <= 0:
            fail(f'test driver eval: {name} launched no time')
    return {'launches': counts, 's': wall, 'fvd': results['fvd'],
            'prd': results['prd']}


def write_clip_archive(path: str, seed: int = 0) -> float:
    """A ``ViT-B-32.pt``-format torch.jit archive at ViT-B/32's full size
    (``models/clip_full.py::ClipConfig()``), weights from ``seed``, traced
    on the CPU (the card's kernels are ctypes calls, which a trace does
    not record); returns the seconds it took."""
    import warnings

    import torch
    from mmvid_tpu_torch.models import clip_full
    t0 = time.perf_counter()
    cfg = clip_full.ClipConfig()
    model = clip_full.CLIP(cfg).eval()
    clip_full.init_random(model, torch.Generator().manual_seed(seed))
    img = torch.zeros(1, 3, cfg.image_resolution, cfg.image_resolution)
    txt = torch.zeros(1, cfg.context_length, dtype=torch.long)
    txt[0, -1] = cfg.vocab_size - 1
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter('ignore')
        traced = torch.jit.trace(model, (img, txt), check_trace=False)
        torch.jit.save(traced, path)
    return time.perf_counter() - t0


def phase_clip(run_dir: str, tmp: str):
    """The CLIP archive at full size: the graft (``python -m
    mmvid_tpu_torch.train`` on ``text_to_video/train.sh``'s flags with
    ``--openai_clip_model_path`` at the archive, ``--bf16``, one step:
    the backbone equal to the archive's visual resblocks when grafted,
    a finite loss), then the CLIP score (``.test`` on
    ``evaluation.sh``'s flags with ``--eval_metric clip``, 32 samples, the
    training driver's run): ``clip_score.txt`` written, the score in
    [-1, 1], attention launched (generation, and the scorer's towers on
    the fp32 route)."""
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch import test as test_driver
    from mmvid_tpu_torch import train as train_driver
    from mmvid_tpu_torch.config import process_args

    archive = os.path.join(tmp, 'ViT-B-32.pt')
    archive_s = write_clip_archive(archive)
    print(f'[clip] ViT-B/32-shaped archive written in {archive_s:.2f} s, '
          f'{os.path.getsize(archive)} B', flush=True)

    graft = factories.graft_transformer_params
    grafted = []

    def checked(model, stack_sd):
        graft(model, stack_sd)
        got = model.transformer['transformer'].state_dict()
        grafted.append(all(torch.equal(got[k].cpu(), v.to(got[k].dtype))
                           for k, v in stack_sd.items()))

    logs = os.path.join(tmp, 'clip_logs')
    argv = recipe_argv('text_to_video', 'train.sh', {
        '--image_text_folder': os.path.join(tmp, 'vox_text'),
        '--vae_path': os.path.join(tmp, 'vae.ckpt')}) + [
        '--openai_clip_model_path', archive, '--log_root', logs,
        '--iters', '1', '--log_every', '1', '--bf16']
    args = process_args(train=True, argv=argv)
    factories.graft_transformer_params = checked
    try:
        reset_counts()
        t0 = time.perf_counter()
        train_driver.main_worker(args)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        factories.graft_transformer_params = graft
    losses = _driver_losses(os.path.join(logs, args.name))
    print(f'[clip] the training driver with the archive: grafted '
          f'{grafted}, losses {losses}, {train_s:.2f} s', flush=True)
    if grafted != [True]:
        fail(f'clip: the graft ran {len(grafted)} times, equal {grafted}')
    shutil.rmtree(logs, ignore_errors=True)

    argv = recipe_argv('text_to_video', 'evaluation.sh', {
        '--image_text_folder': os.path.join(tmp, 'vox_text'),
        '--dalle_path': run_dir, '--eval_num': str(2 * EVAL_BATCH),
        '--eval_metric': 'clip'}) + [
        '--log_root', os.path.join(tmp, 'logs'),
        '--openai_clip_model_path', archive, '--name_suffix', '_eval=clip']
    args = process_args(train=False, argv=argv)
    reset_counts()
    t0 = time.perf_counter()
    results = test_driver.main_worker(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    mean, std = results['clip']
    print(f'[clip] CLIP score over {args.eval_num} samples: {mean:.5f} +/- '
          f'{std:.5f}; {wall:.2f} s with the load; launches {counts}',
          flush=True)
    if not (-1 <= mean <= 1 and std >= 0):
        fail(f'clip: score {results["clip"]}')
    if not os.path.isfile(os.path.join(args.log_metric_dir,
                                       'clip_score.txt')):
        fail('clip: clip_score.txt not written')
    if counts['attention'] <= 0:
        fail('clip: attention launched no time')
    return {'launches': counts, 's': wall, 'clip': results['clip'],
            'archive_s': archive_s, 'train_step_run_s': train_s}


# VQGAN finetuning (phase_vqgan_train).  The tiny trainer on the card
# against the CPU from the same weights, on camera-like frames
# (_smooth_frames) and on uniform noise, TF32 off on both: each metric
# within VQGAN_METRIC_TOL of max(|CPU|, 1), Adam's first moments (the
# gradients) within VQGAN_GRAD_TOL of the model's largest.  The phase
# prints its control (vqgan_tiny_tf32_control), TF32 on; PERF.md records
# its reading.
VQGAN_METRIC_TOL = 1e-4
VQGAN_GRAD_TOL = 1e-4
VQGAN_TINY_FLAGS = ['--image_size', '32', '--ch', '32', '--ch_mult', '1,2',
                    '--num_res_blocks', '1', '--z_channels', '64',
                    '--embed_dim', '64', '--n_embed', '128',
                    '--attn_resolutions', '']
# the full-width run: train_vqgan.py's defaults (the vqgan.1024 config,
# batch 8) at 128 px, iterations cut from 10000; the median s an
# iteration over those after VQGAN_WARMUP
VQGAN_ITERS = 8
VQGAN_SAVE_EVERY = 4
VQGAN_WARMUP = 3
VQGAN_IMAGES = 48


def _vqgan_grad_gap(opt_a, mod_a, opt_b, mod_b) -> float:
    """The largest gap between two trainers' Adam first moments (the
    gradients, halved), over the largest of the CPU's (``b``)."""
    pairs = [(opt_a.state[p]['exp_avg'].cpu(), opt_b.state[q]['exp_avg'])
             for p, q in zip(mod_a.parameters(), mod_b.parameters())]
    top = max(w.abs().max().item() for _, w in pairs)
    return (max((g - w).abs().max().item() for g, w in pairs)
            / max(top, 1e-30))


def vqgan_conv_gflop(batch: int = 8, size: int = 128) -> dict:
    """GFLOP of the convolutions of one forward of each network of VQGAN
    finetuning at ``VQGanConfig()`` (encoder, decoder, LPIPS' VGG16 over
    both batches, the discriminator), counted from the shapes on meta
    tensors: 2 x output elements x the kernel's input taps."""
    import torch
    from mmvid_tpu_torch.models.lpips import VGG16Features
    from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQModel
    from mmvid_tpu_torch.models.vqgan_losses import NLayerDiscriminator

    with torch.device('meta'):
        vq = VQModel(VQGanConfig(resolution=size))
        nets = {'encoder': (vq.encoder, torch.empty(batch, 3, size, size)),
                'decoder': (vq.decoder, torch.empty(
                    batch, 256, size // 16, size // 16)),
                'vgg16_both': (VGG16Features(),
                               torch.empty(2 * batch, 3, size, size)),
                'discriminator': (NLayerDiscriminator(),
                                  torch.empty(batch, 3, size, size))}
        out = {}
        for name, (net, x) in nets.items():
            flops = [0]

            def hook(m, inp, y):
                flops[0] += (2 * y.numel() * m.in_channels
                             * m.kernel_size[0] * m.kernel_size[1])

            hooks = [m.register_forward_hook(hook) for m in net.modules()
                     if isinstance(m, torch.nn.Conv2d)]
            net(x)
            for h in hooks:
                h.remove()
            out[name] = flops[0] / 1e9
    return out


def _vqgan_tiny_steps(device: str, x, tf32: bool = False):
    """One g step and one d step of the tiny trainer (VQGAN_TINY_FLAGS)
    built by ``train_vqgan.build_trainer`` from its seed on ``device``,
    with a randn codebook from its own seed (the uniform-initialised one
    has near-ties), on ``x`` [B, 3, 32, 32] in [-1, 1]; ``tf32`` (the
    control): TF32 on where the trainer turns it off.  Returns the
    trainer and its metrics."""
    import contextlib
    from unittest import mock

    import torch
    from mmvid_tpu_torch import train_vqgan as driver
    from mmvid_tpu_torch.models import vqgan_losses

    @contextlib.contextmanager
    def tf32_on():
        conv, mm = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = conv
            torch.backends.cuda.matmul.allow_tf32 = mm

    args = driver.parse_args(['--image_folder', '.'] + VQGAN_TINY_FLAGS)
    tr = driver.build_trainer(args, torch.device(device))
    cb = tr.model.quantize.embedding.weight
    with torch.no_grad():
        cb.copy_(torch.randn(cb.shape, generator=torch.Generator(
        ).manual_seed(5)))
    xd = x.to(device)
    with (mock.patch.object(vqgan_losses, 'fp32_exact', tf32_on) if tf32
          else contextlib.nullcontext()):
        metrics = {k: float(v) for k, v in tr.g_step(xd).items()}
        metrics.update({k: float(v) for k, v in tr.d_step(xd).items()})
    return tr, metrics


def _vqgan_tiny_gaps(a, b):
    """Two tiny runs' (``_vqgan_tiny_steps``) metric gaps (of max(|b|,
    1)) and each step's gradient gap (``_vqgan_grad_gap``)."""
    (ta, ma), (tb, mb) = a, b
    gaps = {k: abs(ma[k] - v) / max(abs(v), 1.0) for k, v in mb.items()}
    return gaps, {'g_step': _vqgan_grad_gap(ta.g_opt, ta.model, tb.g_opt,
                                            tb.model),
                  'd_step': _vqgan_grad_gap(ta.d_opt, ta.disc, tb.d_opt,
                                            tb.disc)}


def _vqgan_tiny_batches() -> dict:
    """The tiny check's two batches, NCHW in [-1, 1]: two 32 px
    ``_smooth_frames`` and two uniform-noise images."""
    import numpy as np
    import torch

    frames = torch.from_numpy(np.stack(_smooth_frames(
        np.random.RandomState(3), 2, 32)).astype(np.float32) / 127.5
        - 1).permute(0, 3, 1, 2).contiguous()
    noise = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, frames.shape).astype(np.float32))
    return {'frames': frames, 'noise': noise}


def vqgan_tiny_card_vs_cpu():
    """One g step and one d step of the tiny trainer on the card and on
    the CPU from the same weights, on each of ``_vqgan_tiny_batches``
    (``_vqgan_tiny_steps``).  Returns the card's metrics on the frames,
    its launches, each metric's gap to the CPU's (of max(|CPU|, 1)) and
    each step's gradient gap (``_vqgan_grad_gap``), keyed
    ``<batch>/<name>``."""
    reset_counts()   # the CPU trainer launches nothing
    cards = {name: _vqgan_tiny_steps('cuda', x)
             for name, x in _vqgan_tiny_batches().items()}
    launches = read_counts()
    gaps, grad_gaps = {}, {}
    for name, x in _vqgan_tiny_batches().items():
        g, gg = _vqgan_tiny_gaps(cards[name], _vqgan_tiny_steps('cpu', x))
        gaps.update({f'{name}/{k}': v for k, v in g.items()})
        grad_gaps.update({f'{name}/{k}': v for k, v in gg.items()})
    return cards['frames'][1], launches, gaps, grad_gaps


def vqgan_tiny_tf32_control() -> dict:
    """The tiny check's control: the card with TF32 on against the CPU on
    the frames, as the largest metric gap (and which) and each step's
    gradient gap; each must exceed its limit, or the check could not tell
    TF32 from fp32."""
    frames = _vqgan_tiny_batches()['frames']
    gaps, grads = _vqgan_tiny_gaps(_vqgan_tiny_steps('cuda', frames, True),
                                   _vqgan_tiny_steps('cpu', frames))
    worst = max(gaps, key=gaps.get)
    return {'metric': gaps[worst], 'worst': worst, **grads}


def phase_vqgan_train():
    """VQGAN finetuning (``mmvid_tpu_torch.train_vqgan``).  First the tiny
    trainer (tests/test_vqgan_train.py's TINY_VQ, 32 px, batch 2) built by
    ``train_vqgan.build_trainer`` from one seed on the card and on the
    CPU, one randn codebook in both (the random-init one has near-ties):
    one g step and one d step each on each of ``_vqgan_tiny_batches``,
    every metric (``d_weight`` included) and gradient against the CPU's,
    four nearest-code launches; then its control with TF32 on
    (``vqgan_tiny_tf32_control``), printed.  Then the driver's
    ``main`` (what ``python -m mmvid_tpu_torch.train_vqgan``
    runs) at full width: ``VQGanConfig()`` at 128 px, batch 8, fp32,
    LPIPS on seeded random VGG16 weights, ``NLayerDiscriminator(64, 3)``,
    over VQGAN_IMAGES synthetic 128 px PNGs, VQGAN_ITERS iterations with
    ``--log_every 1`` and a save every VQGAN_SAVE_EVERY.  Gates: every
    logged metric finite; the nearest-code kernel launched exactly twice
    an iteration (the g step's reconstruction and the d step's); the
    last checkpoint read by ``factories.taming_vqgan_state`` into
    ``get_vae_model``'s VQGAN, which encodes and decodes a batch to
    finite images.  Then one iteration of a fresh trainer under
    ``torch.profiler`` (``breakdown.profile_run``): device time by kind,
    busy time and idle share.  Returns the launches, the tiny check's
    gaps and control, s an iteration (median after VQGAN_WARMUP),
    images/s, peak memory, the profile and the wall time."""
    import argparse
    import math
    import tempfile

    import numpy as np
    import torch
    from mmvid_tpu_torch import factories
    from mmvid_tpu_torch import train_vqgan as driver
    from mmvid_tpu_torch.data import png
    from mmvid_tpu_torch.weights import load_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='mmvid_vqgan_')
    try:
        # -- the tiny trainer, card against CPU --------------------------
        folder = os.path.join(tmp, 'frames')
        os.makedirs(folder)
        rng = np.random.RandomState(3)
        for i, img in enumerate(_smooth_frames(rng, VQGAN_IMAGES, 128)):
            png.write_png(os.path.join(folder, f'{i:04d}.png'), img, i % 5)
        metrics, tiny_launches, gaps, grad_gaps = vqgan_tiny_card_vs_cpu()
        metric_gap = max(gaps.values())
        grad_gap = max(grad_gaps.values())
        print(f'[vqgan train] tiny card vs CPU: metrics {metrics}; '
              f'gaps {gaps} (tol {VQGAN_METRIC_TOL}); gradient gaps '
              f'{grad_gaps} (tol {VQGAN_GRAD_TOL}); launches '
              f'{tiny_launches}', flush=True)
        if not metric_gap <= VQGAN_METRIC_TOL:
            fail(f'vqgan train: tiny card metrics off the CPU by '
                 f'{metric_gap} > {VQGAN_METRIC_TOL}')
        if not grad_gap <= VQGAN_GRAD_TOL:
            fail(f'vqgan train: tiny card gradients off the CPU by '
                 f'{grad_gap} > {VQGAN_GRAD_TOL}')
        if tiny_launches != expected(codebook=4):
            fail(f'vqgan train: tiny launches {tiny_launches}')
        tf32 = vqgan_tiny_tf32_control()
        print(f'[vqgan train] tiny control, TF32 on, card vs CPU on the '
              f'frames (must exceed the limits): {tf32}', flush=True)
        if not (tf32['metric'] > VQGAN_METRIC_TOL
                and max(tf32['g_step'], tf32['d_step']) > VQGAN_GRAD_TOL):
            fail(f'vqgan train: the check cannot tell TF32 on: {tf32}')

        # -- the driver at full width ------------------------------------
        logs = os.path.join(tmp, 'logs')
        args = driver.parse_args([
            '--image_folder', folder, '--image_size', '128',
            '--batch_size', '8', '--iters', str(VQGAN_ITERS),
            '--log_every', '1', '--save_every_n_steps',
            str(VQGAN_SAVE_EVERY), '--log_root', logs])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        record = driver.main(args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        lines = open(os.path.join(logs, args.name, 'log.txt')).read(
        ).splitlines()
        values = [float(w) for ln in lines for w in ln.split()[3:10:2]]
        iter_s = [r['load_s'] + r['step_s'] for r in record['iters']]
        steady = iter_s[VQGAN_WARMUP:]
        s_iter = statistics.median(steady)
        step_s = statistics.median(r['step_s'] for r in
                                   record['iters'][VQGAN_WARMUP:])
        load_s = statistics.median(r['load_s'] for r in
                                   record['iters'][VQGAN_WARMUP:])
        # an iteration's convolutions: the g step's forward, the adaptive
        # weight's input gradients through VGG16 and the discriminator,
        # the backward (data and weight gradients of the VQGAN, input
        # gradients of the frozen nets), the d step's reconstruction, two
        # discriminator calls and their weight gradients
        gf = vqgan_conv_gflop()
        iter_gflop = (4 * (gf['encoder'] + gf['decoder'])
                      + 3 * gf['vgg16_both'] + 7 * gf['discriminator'])
        bound_s = iter_gflop * 1e9 / PEAK_FLOPS['fp32']
        print(f'[vqgan train] driver, VQGanConfig() at 128 px, batch 8, '
              f'fp32: {VQGAN_ITERS} iterations in {run_s:.2f} s (build '
              f'and saves included); s an iteration {iter_s}; median '
              f'after {VQGAN_WARMUP}: {s_iter:.4f} s (steps {step_s:.4f}, '
              f'image read {load_s:.4f}), {8 / s_iter:.2f} images/s; '
              f'convolutions {iter_gflop:.1f} GFLOP an iteration ({gf}), '
              f'{bound_s:.4f} s at the fp32 peak; peak {peak} B; launches '
              f'{counts}; saves {record["saves"]}', flush=True)
        print('\n'.join(f'[vqgan train] {ln}' for ln in lines), flush=True)
        if len(lines) != VQGAN_ITERS or len(values) != 4 * VQGAN_ITERS:
            fail(f'vqgan train: {len(lines)} log lines, {len(values)} '
                 f'values')
        if not all(math.isfinite(v) for v in values):
            fail(f'vqgan train: a non-finite metric in {lines}')
        if counts != expected(codebook=2 * VQGAN_ITERS):
            fail(f'vqgan train: launches {counts}, expected the nearest '
                 f'code {2 * VQGAN_ITERS} and nothing else')
        last = os.path.join(logs, args.name, 'weights', 'last',
                            driver.CKPT_FILE)
        if (record['saves'][-1] != os.path.join(
                os.path.abspath(os.path.join(logs, args.name)), 'weights',
                str(VQGAN_ITERS), driver.CKPT_FILE)
                or not os.path.isfile(last)):
            fail(f'vqgan train: checkpoints {record["saves"]}')
        vae = factories.get_vae_model(argparse.Namespace(
            image_size=128, which_vae='vqgan1024'), device='cuda')
        load_weights(vae.model, factories.taming_vqgan_state(
            record['saves'][-1]))
        img = (torch.from_numpy(driver.image_batch(
            driver.image_paths(folder), np.random.RandomState(1), 8, 128))
            .cuda() + 1) / 2
        ids = vae.get_codebook_indices(img)
        dec = vae.decode(ids)
        torch.cuda.synchronize()
        if (tuple(ids.shape) != (8, 64) or int(ids.min()) < 0
                or int(ids.max()) >= 1024 or tuple(dec.shape) !=
                (8, 128, 128, 3) or not torch.isfinite(dec).all()):
            fail(f'vqgan train: the finetuned checkpoint encodes to '
                 f'{tuple(ids.shape)} and decodes to {tuple(dec.shape)}')
        print(f'[vqgan train] checkpoint {record["saves"][-1]} read back '
              f'by taming_vqgan_state: ids {tuple(ids.shape)}, images '
              f'{tuple(dec.shape)} finite', flush=True)
        del vae

        # -- where an iteration's device time goes -----------------------
        from mmvid_tpu_torch import breakdown
        tr = driver.build_trainer(args, torch.device('cuda'))
        xb = (img * 2 - 1).permute(0, 3, 1, 2).contiguous()

        def iteration():
            tr.g_step(xb)
            tr.d_step(xb)

        iteration()
        prof = breakdown.profile_run(iteration)
        print(f'[vqgan train] one profiled iteration: device busy '
              f'{prof["device_busy_ms"]:.3f} ms of a '
              f'{prof["batch_span_ms"]:.3f} ms span, idle share '
              f'{prof["idle_share"]:.4f}, {prof["device_events"]} device '
              f'events; ms by kind {prof["device_ms_by_kind"]}; largest '
              f'kernels {prof["top_kernels_ms"]}', flush=True)
        if prof['launches'] != expected(codebook=2):
            fail(f'vqgan train: profiled launches {prof["launches"]}')
        del tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {'launches': counts, 'tiny_launches': tiny_launches,
            'tiny_metric_gap': metric_gap, 'tiny_grad_gap': grad_gap,
            'tiny_tf32_control': tf32,
            's_per_iter': s_iter, 'step_s': step_s, 'load_s': load_s,
            'images_per_s': 8 / s_iter, 'peak_bytes': peak,
            'conv_gflop_per_iter': iter_gflop, 'bound_s': bound_s,
            'profile': {k: prof[k] for k in (
                'device_busy_ms', 'batch_span_ms', 'idle_share',
                'device_events', 'device_ms_by_kind', 'top_kernels_ms')},
            'iter_s': iter_s, 'wall_s': time.perf_counter() - t_phase}


# Media I/O without Pillow, imageio or OpenCV (data/jpeg.py, data/bmp.py,
# utils/gif.py, utils/mp4.py, generate.py's write overlap).
MEDIA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'tests',
                         'data', 'media')
MEDIA_BATCHES, MEDIA_BATCH, MEDIA_STEPS = 3, 16, 20
MEDIA_TRAIN_BATCH, MEDIA_TRAIN_ITERS = 8, 2
MEDIA_LAYERS = 12


def parse_gif(data: bytes) -> dict:
    """A GIF's structure, read without a decoder: the logical screen, each
    image descriptor's size, each graphic control extension's delay
    (centiseconds), the NETSCAPE2.0 loop count."""
    import struct
    if data[:6] not in (b'GIF87a', b'GIF89a'):
        raise ValueError('not a GIF')
    w, h, flags = struct.unpack('<HHB', data[6:11])
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
    frames, delays, loop = [], [], None

    def blocks(pos):
        body = bytearray()
        while data[pos]:
            body += data[pos + 1:pos + 1 + data[pos]]
            pos += 1 + data[pos]
        return bytes(body), pos + 1

    while True:
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = data[pos + 1]
            body, pos = blocks(pos + 2)
            if label == 0xF9:
                delays.append(struct.unpack('<H', body[1:3])[0])
            elif label == 0xFF and body[:11] == b'NETSCAPE2.0':
                loop = struct.unpack('<H', body[12:14])[0]
        elif kind == 0x2C:
            fw, fh, fflags = struct.unpack('<HHB', data[pos + 5:pos + 10])
            pos += 10 + (3 << ((fflags & 7) + 1) if fflags & 0x80 else 0)
            _, pos = blocks(pos + 1)
            frames.append((fw, fh))
        else:
            raise ValueError(f'GIF block {kind:#x} at {pos}')
    return {'size': (w, h), 'frames': frames, 'delays_cs': delays,
            'loop': loop}


def parse_mp4(data: bytes) -> dict:
    """An MP4's structure: the sample count of ``stsz``, the ``avc1``
    sample entry's size, its ``avcC`` profile and level, ``stts``."""
    import struct
    out = {}

    def walk(pos, end):
        while pos + 8 <= end:
            n, kind = struct.unpack('>I4s', data[pos:pos + 8])
            body = pos + 8
            if kind in (b'moov', b'trak', b'mdia', b'minf', b'stbl'):
                walk(body, pos + n)
            elif kind == b'stsd':
                walk(body + 8, pos + n)
            elif kind == b'avc1':
                out['size'] = struct.unpack('>HH', data[body + 24:body + 28])
                walk(body + 78, pos + n)
            elif kind == b'avcC':
                out['avcC'] = {'profile': data[body + 1],
                               'level': data[body + 3]}
            elif kind == b'stsz':
                out['samples'] = struct.unpack(
                    '>I', data[body + 8:body + 12])[0]
            elif kind == b'stts':
                out['stts'] = struct.unpack('>III', data[body + 4:body + 16])
            elif kind == b'mdhd':
                out['timescale'] = struct.unpack(
                    '>I', data[body + 12:body + 16])[0]
            out.setdefault('boxes', []).append(kind.decode())
            pos += n

    walk(0, len(data))
    return out


def _check_media_file(tag, path, frames, size):
    with open(path, 'rb') as f:
        data = f.read()
    if path.endswith('.gif'):
        g = parse_gif(data)
        ok = (len(g['frames']) == frames and g['size'] == size
              and all(fr == size for fr in g['frames']) and g['loop'] == 0
              and g['delays_cs'] == [25] * frames)
        if not ok:
            fail(f'{tag}: {path} parses as {g}')
        return g
    m = parse_mp4(data)
    if not (m.get('samples') == frames and m.get('size') == size
            and 'avcC' in m and m.get('stts') == (1, frames, 1000)
            and m.get('timescale') == 4000):
        fail(f'{tag}: {path} parses as {m}')
    return m


def _media_decoders() -> dict:
    """Every committed JPEG and BMP fixture through ``png.read_rgb``
    (which imports no Pillow), byte-equal to its committed Pillow decode;
    the core's time a 128 x 128 4:2:0 JPEG frame; which of PIL, imageio
    and cv2 this machine could import."""
    import glob
    import importlib.util

    import numpy as np
    from mmvid_tpu_torch.data import png
    names = sorted(glob.glob(os.path.join(MEDIA_DIR, '*.jpg'))
                   + glob.glob(os.path.join(MEDIA_DIR, '*.bmp')))
    if len(names) < 20:
        fail(f'media: {len(names)} fixtures under {MEDIA_DIR}')
    for p in names:
        got, want = png.read_rgb(p), png.read_rgb(p + '.png')
        if not np.array_equal(got, want):
            fail(f'media: {os.path.basename(p)} differs from its Pillow '
                 f'decode ({np.abs(got.astype(int) - want).max()})')
    p = os.path.join(MEDIA_DIR, 'baseline_q75_420_128.jpg')
    with open(p, 'rb') as f:
        data = f.read()
    ms = _host_ms(lambda: png.decode(data), reps=200)
    present = [m for m in ('PIL', 'imageio', 'cv2')
               if importlib.util.find_spec(m) is not None]
    res = {'fixtures': len(names), 'jpeg_128_ms': ms, 'cpu': host_cpu(),
           'media_packages_present': present}
    print(f'[media] {len(names)} JPEG and BMP fixtures byte-equal to their '
          f'Pillow decodes; importable here of PIL, imageio, cv2: '
          f'{present or "none"}; the C++ core {ms:.4f} ms a 128x128 4:2:0 '
          f'JPEG frame (one thread of {os.cpu_count()}, {res["cpu"]})',
          flush=True)
    return res


def host_cpu() -> str:
    """The host CPU's model name, from /proc/cpuinfo."""
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                if line.startswith('model name'):
                    return line.split(':', 1)[1].strip()
    except OSError:
        pass
    return 'unknown'


def _media_generate(tmp: str, fmt: str, dalle: str, prompts: str,
                    frames: int, size: tuple, extra_argv) -> dict:
    """``generate.main`` at full width (the flagship in fp32, batch 16, 20
    rounds, 3 batches) to ``fmt``; the sampled batches recorded by
    wrapping ``generate_videos``.  Gates: the launch counts, each file
    parsed (8 frames of 128 x 128), and byte-equal to the writer called
    afterwards on the recorded videos, in order."""
    import contextlib
    import io
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from mmvid_tpu_torch import generate
    from mmvid_tpu_torch.utils import html

    out = os.path.join(tmp, fmt)
    argv = ['--dalle_path', dalle, '--prompt_file', prompts, '--out_dir', out,
            '--batch_size', str(MEDIA_BATCH), '--mask_predict_steps',
            str(MEDIA_STEPS), '--no-bf16', '--format', fmt, '--seed', '3',
            *extra_argv]
    recorded, load = [], {}
    real_videos, real_load = generate.generate_videos, generate.load_model

    def recording(*a, **kw):
        for batch in real_videos(*a, **kw):
            recorded.append(batch)
            yield batch

    def timed_load(args):
        t0 = time.perf_counter()
        res = real_load(args)
        torch.cuda.synchronize()
        load['s'] = time.perf_counter() - t0
        return res

    generate.generate_videos, generate.load_model = recording, timed_load
    text = io.StringIO()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            generate.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        generate.generate_videos, generate.load_model = real_videos, real_load
    printed = text.getvalue()
    print(''.join(f'[media {fmt}] | {ln}\n' for ln in printed.splitlines()),
          end='', flush=True)
    n_frames = MEDIA_BATCHES * MEDIA_BATCH * frames
    want = expected(attention=MEDIA_LAYERS * MEDIA_STEPS * MEDIA_BATCHES,
                    sample_head=TF32_HEAD_LAUNCHES * MEDIA_STEPS
                    * MEDIA_BATCHES)
    if counts != want:
        fail(f'media {fmt}: launch counts {counts} != {want}')
    if len(recorded) != MEDIA_BATCHES:
        fail(f'media {fmt}: {len(recorded)} batches sampled')
    loop_s = wall - load['s']
    fps_io = float(printed.split('frames/sec incl. IO')[-2].split('(')[-1])
    # the same writer afterwards on the recorded videos, in order, on the
    # pool generate.main writes with
    again = os.path.join(tmp, fmt + '_again')
    os.makedirs(again)
    writer = html.save_gif if fmt == 'gif' else html.save_mp4
    threads = generate.WRITE_THREADS if fmt == 'gif' else 1
    pool = ThreadPoolExecutor(threads)
    write_s, n, names = [], 0, []
    for batch in recorded:
        vids = batch.videos.float().cpu().numpy()
        stems = [f'{n + j:04d}_' + '_'.join(p.split()[:6])[:48]
                 for j, p in enumerate(batch.prompts)]
        t0 = time.perf_counter()
        list(pool.map(lambda sv: writer(os.path.join(again, sv[0] + '.' + fmt),
                                        sv[1], 4), zip(stems, vids)))
        write_s.append(time.perf_counter() - t0)
        n += len(stems)
        names += stems
    t0 = time.perf_counter()
    for vid in recorded[0].videos.float().cpu().numpy():
        writer(os.path.join(again, 'serial.' + fmt), vid, 4)
    serial_s = time.perf_counter() - t0
    pool.shutdown()
    for stem in names:
        with open(os.path.join(out, f'{stem}.{fmt}'), 'rb') as f:
            got = f.read()
        with open(os.path.join(again, f'{stem}.{fmt}'), 'rb') as f:
            if f.read() != got:
                fail(f'media {fmt}: {stem}.{fmt} differs from the writer '
                     'called afterwards on the sampled videos')
        if not os.path.isfile(os.path.join(out, f'{stem}.txt')):
            fail(f'media {fmt}: {stem}.txt not written')
    parsed = _check_media_file(f'media {fmt}', os.path.join(
        out, f'{names[0]}.{fmt}'), frames, size)
    for stem in names[1:]:
        _check_media_file(f'media {fmt}', os.path.join(out, f'{stem}.{fmt}'),
                          frames, size)
    sizes = [os.path.getsize(os.path.join(out, f'{s}.{fmt}')) for s in names]
    return {'wall_s': wall, 'load_s': load['s'], 'loop_s': loop_s,
            'frames': n_frames, 'printed_fps_incl_io': fps_io,
            'loop_fps': n_frames / loop_s, 'launches': counts,
            'write_s_per_batch': write_s, 'threads': threads,
            'serial_write_s_per_batch': serial_s,
            'mean_file_bytes': sum(sizes) / len(sizes),
            'parsed_first': {k: v for k, v in parsed.items()
                             if k != 'boxes'}}


def _media_sampling_alone(dalle: str, prompts: list, extra_argv) -> float:
    """Seconds of ``generate_videos`` alone over the same prompts and
    batches, as ``generate.main`` runs them (the model loaded anew),
    synchronised at the end."""
    import torch
    from mmvid_tpu_torch import generate
    args = generate.parse_args(['--dalle_path', dalle, '--no-bf16',
                                *extra_argv])
    model, tok = generate.load_model(args)
    torch.cuda.synchronize()
    gen = torch.Generator(device=args.device).manual_seed(3)
    t0 = time.perf_counter()
    for _ in generate.generate_videos(model, tok, prompts, MEDIA_BATCH, gen,
                                      MEDIA_STEPS):
        pass
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _media_train_driver(tmp: str) -> dict:
    """``mmvid_tpu_torch.train`` with ``text_to_video/train.sh``'s flags
    (batch 8, 2 iterations, the sample page at iteration 1, bf16) on a
    video_text folder whose frames are the committed JPEG fixtures,
    copied to fill the clips.  Gates: finite losses, the kernels
    launched, ``index.html`` listing ``.gif`` media that parse."""
    import glob
    import re

    import torch
    from mmvid_tpu_torch import train as driver
    from mmvid_tpu_torch.config import process_args

    jpgs = sorted(glob.glob(os.path.join(MEDIA_DIR, '*.jpg')))
    tree = os.path.join(tmp, 'jpeg_text')
    clips = MEDIA_TRAIN_BATCH * 2
    for i in range(clips):
        key = f'id{i // 2}#v{i // 2}#{i % 2:03d}'
        d = os.path.join(tree, 'video', key)
        os.makedirs(d)
        for j in range(DRIVER_CLIP_FRAMES):
            shutil.copyfile(jpgs[(i + j) % len(jpgs)],
                            os.path.join(d, f'{j:04d}.jpg'))
        os.makedirs(os.path.join(tree, 'txt'), exist_ok=True)
        with open(os.path.join(tree, 'txt', f'{key}.txt'), 'w') as f:
            f.write('A person with glasses is speaking.\n')
    write_vqgan_ckpt(os.path.join(tmp, 'vae.ckpt'), 7)
    logs = os.path.join(tmp, 'logs')
    argv = recipe_argv('text_to_video', 'train.sh', {
        '--image_text_folder': tree,
        '--vae_path': os.path.join(tmp, 'vae.ckpt')}) + [
        '--log_root', logs, '--iters', str(MEDIA_TRAIN_ITERS),
        '--save_every_n_steps', '1000', '--sample_every', '1',
        '--log_every', '1', '--bf16', '--batch_size',
        str(MEDIA_TRAIN_BATCH)]
    args = process_args(train=True, argv=argv)
    reset_counts()
    t0 = time.perf_counter()
    driver.main_worker(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    run_dir = os.path.join(logs, args.name)
    losses = _driver_losses(run_dir)
    with open(os.path.join(run_dir, 'web', 'index.html')) as f:
        page = f.read()
    media = re.findall(r'src="images/([^"]+)"', page)
    if not media or not all(m.endswith('.gif') for m in media):
        fail(f'media train driver: the page lists {media}')
    for m in media:
        _check_media_file('media train driver', os.path.join(
            run_dir, 'web', 'images', m), args.num_targets,
            (args.image_size, args.image_size))
    for name in ('attention', 'sample_head'):
        if counts[name] <= 0:
            fail(f'media train driver: {name} launched no time')
    if backward_launches() <= 0:
        fail('media train driver: attention backward launched no time')
    print(f'[media] train driver on {len(jpgs)} JPEG fixtures copied into '
          f'{clips} clips of {DRIVER_CLIP_FRAMES} frames: losses {losses}, '
          f'the page lists {len(media)} GIFs of {args.num_targets} frames '
          f'at {args.image_size}x{args.image_size}, '
          f'launches {counts}; {wall:.2f} s with the model build', flush=True)
    return {'losses': losses, 'gifs': len(media), 'launches': counts,
            'wall_s': wall}


def phase_media(extra_argv=()):
    """Media I/O on a host without Pillow, imageio or OpenCV: the JPEG and
    BMP fixtures byte-equal to their Pillow decodes; ``generate.main`` at
    full width to GIF and to MP4 with its write overlap (the files
    byte-equal to the writers called afterwards on the sampled videos,
    the loop's frames/s against sampling alone); the training driver on
    JPEG frames, its page's GIFs parsed.  ``extra_argv`` is appended to
    generate's flags (a CPU rehearsal: the tiny model's and ``--device
    cpu``)."""
    import tempfile

    import torch
    from mmvid_tpu_torch import breakdown, factories, generate

    res = {'decoders': _media_decoders()}
    tmp = tempfile.mkdtemp(prefix='mmvid_media_')
    try:
        t0 = time.perf_counter()
        args = generate.parse_args(['--dalle_path', '-', '--no-bf16',
                                    *extra_argv])
        model = factories.get_dalle(
            args, factories.get_vae_model(args, dtype=torch.float32,
                                          device=args.device),
            dtype=torch.float32, device=args.device)
        factories.init_weights(model, torch.Generator().manual_seed(0))
        dalle = os.path.join(tmp, 'dalle.pt')
        torch.save({'iter': 0, 'hparams': {k: getattr(args, k) for k in
                                           generate.HPARAM_KEYS},
                    'weights': model.state_dict()}, dalle)
        del model
        torch.cuda.empty_cache()
        prompt_list = (breakdown.PROMPTS * MEDIA_BATCHES * MEDIA_BATCH)[
            :MEDIA_BATCHES * MEDIA_BATCH]
        prompts = os.path.join(tmp, 'prompts.txt')
        with open(prompts, 'w') as f:
            f.write('\n'.join(prompt_list) + '\n')
        print(f'[media] full-width fp32 dalle.pt written in '
              f'{time.perf_counter() - t0:.2f} s', flush=True)
        # sampling alone before and after the two runs, each in the same
        # warm state (after a discarded first run, no cache emptied); the
        # writes hidden are read against their mean
        _media_sampling_alone(dalle, prompt_list, extra_argv)
        alone = [_media_sampling_alone(dalle, prompt_list, extra_argv)]
        runs = {}
        for fmt in ('gif', 'mp4'):
            runs[fmt] = _media_generate(tmp, fmt, dalle, prompts,
                                        args.num_targets,
                                        (args.image_size, args.image_size),
                                        extra_argv)
        alone.append(_media_sampling_alone(dalle, prompt_list, extra_argv))
        alone_s = sum(alone) / 2
        alone_fps = len(prompt_list) * args.num_targets / alone_s
        for fmt in ('gif', 'mp4'):
            r = runs[fmt]
            write = sum(r['write_s_per_batch'])
            r['sampling_alone_s'] = alone
            r['sampling_fps'] = alone_fps
            # the share of the writing the overlap took off the loop: the
            # loop against sampling alone plus the writes
            r['hidden_share'] = (alone_s + write - r['loop_s']) / write
            res[fmt] = r
            print(f'[media] generate --format {fmt} on {card()}: '
                  f'{MEDIA_BATCHES} batches of {MEDIA_BATCH}, {MEDIA_STEPS} '
                  f'rounds, fp32; the loop {r["loop_s"]:.4f} s, '
                  f'{r["loop_fps"]:.2f} frames/s (printed incl. IO '
                  f'{r["printed_fps_incl_io"]}); sampling alone '
                  f'{alone[0]:.4f} s before, {alone[1]:.4f} s after, '
                  f'{alone_fps:.2f} frames/s on their mean; the '
                  f'write {[round(w, 4) for w in r["write_s_per_batch"]]} s '
                  f'a batch as generate writes it ({r["threads"]} '
                  f'thread(s); {r["serial_write_s_per_batch"]:.4f} s on '
                  f'one); the '
                  f'overlap hid {r["hidden_share"]:.4f} of the writing; '
                  f'{r["mean_file_bytes"]:.0f} B a file; launches '
                  f'{r["launches"]}; every file byte-equal to the writer '
                  f'called afterwards and parsed as {args.num_targets} '
                  f'frames of {args.image_size}x{args.image_size}',
                  flush=True)
        res['train_driver'] = _media_train_driver(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f'[media] {json.dumps(res)}', flush=True)
    return res


def _fp32_attention_entry(route, clip, flagship_fp32, driver_launches):
    """The kernels line's entry of attention's fp32 route: its numbers at
    the fp32 flagship's shape (B16 H12 D64 L565, packed views), its
    launches in the fp32 flagship batch; the text+mask shape, the CLIP
    scorer's shapes and the fp32 drivers' launches (the attention counter
    of those runs, every call of which is fp32) beside them."""
    keys = ('max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by')
    return {'name': 'attention_fp32', 'route': 'cuda',
            'source': 'mmvid_tpu_torch/csrc/attention_fp32_sm90.cu',
            'replaces': 'mmvid_tpu/ops/attention.py:211',
            'launches': flagship_fp32['launches']['attention'],
            **{k: route[565][k] for k in keys},
            'tile_rows': route[565]['tile_rows'],
            'bf16_probs': route[565]['bf16_probs'],
            'at_text_mask_L629': route[629], 'clip': clip,
            'launches_by_path': {'flagship_fp32': flagship_fp32[
                'launches']['attention'], **driver_launches},
            'flagship_fp32': {k: flagship_fp32[k] for k in (
                's_per_batch', 'frames_per_s', 'attention_share_of_busy',
                'device_busy_ms', 'idle_share')}}


def _fp32_head_entry(route, flagship_fp32, driver_launches):
    """The kernels line's entry of the sample head's fp32-W route (the
    split-TF32 kernel): its numbers at M 8192 D 768 V 1024 with a
    genuinely fp32 W, its launches in the fp32 flagship batch; the fp32
    drivers' launches (the sample-head counter of those runs, every call
    of which is fp32) beside them."""
    return {'name': 'sample_head_fp32', 'route': 'cuda',
            'replaces': 'mmvid_tpu/ops/sample_head.py:97',
            'launches': flagship_fp32['launches']['sample_head'],
            **route,
            'launches_by_path': {'flagship_fp32': flagship_fp32[
                'launches']['sample_head'], **driver_launches}}


def _tp_entry(rows, dtype, part, tp_gloo, driver_tp) -> dict:
    """The kernels line's record of one attention route (``part``:
    'forward' or 'backward') at a tp rank's heads: its numbers at each
    shape of phase_attention_tp (times at L565), its launches a tp = 2
    training step on a rank (phase_train_tp_gloo's seq_parallel run of
    that dtype) and, for fp32, in the driver's tp run (a rank's two
    iterations and its grid)."""
    run = tp_gloo[dtype]['runs']['seq_parallel=True']
    kernel = 'attention' if part == 'forward' else None
    per_step = (run['launches'][kernel] if kernel
                else run['attention_backward_launches']) // run['steps']
    out = {'launches_a_tp2_step': per_step,
           'shapes': {key: r[part] for key, r in rows[dtype].items()}}
    if dtype == 'float32':
        out['train_driver_tp_rank'] = (
            driver_tp['rank_launches'][0]['attention'] if kernel
            else driver_tp['rank_attention_backward_launches'][0])
    return out


def _backward_entry(dtype, rows, launches_by_path, **tp_kw):
    """The kernels line's entry of one route of attention's backward
    (B1-bwd: JAX's XLA VJP of the kernel, ``_fused_attention_bwd``, which
    reaches no pallas_call): its numbers at the flagship's training shape
    (B16 H12 D64 L565 mask_prev, packed views) and at every shape of
    ``phase_attention_backward``; its launches on the main path of its
    dtype (bf16: the flagship's training step; fp32: the text_augment
    recipe's training run, fp32 as every released train.sh) and on the
    others; with ``MMVID_BWD_OLD_SOURCE``, PR 20's kernel and the route
    in turns (``old_in_turns``)."""
    r = rows[dtype]
    at = r['shapes']['B16_L565_H12_D64_mask_prev']
    bf16 = dtype == 'bfloat16'
    return {'name': 'attention_backward' + ('' if bf16 else '_fp32'),
            'route': 'cuda',
            'source': 'mmvid_tpu_torch/csrc/attention_bwd_'
                      + ('sm90.cu' if bf16 else 'fp32_sm90.cu'),
            'replaces': 'mmvid_tpu/ops/attention.py:126',
            'launches': next(iter(launches_by_path.values())),
            'max_abs_err': r['max_abs_err'], 'max_rel_err': r['max_rel_err'],
            'max_norm_rel_err': r['max_norm_rel_err'],
            **{k: at[k] for k in ('ms', 'plain_ms', 'bound_ms', 'bound_by',
                                  'library_ms')},
            # PR 20's kernel and this one in turns (None: not asked for)
            'old_in_turns': None if rows['in_turns'] is None else {
                k: v for k, v in rows['in_turns']['ms'].items()
                if k.endswith(dtype)},
            'shapes': r['shapes'], 'launches_by_path': launches_by_path,
            'tp': _tp_entry(tp_kw['tp_rows'], dtype, 'backward',
                            tp_kw['tp_gloo'], tp_kw['driver_tp'])}


def _long_launches(name, long_runs, debug, shapes):
    """The launches of kernel ``name`` in the test driver's long-video
    runs (one a mode), its ``--debug`` run and its shapes run."""
    return {'test_driver_long': {mode: r['launches'][name]
                                 for mode, r in long_runs.items()},
            'test_driver_debug': debug['launches'][name],
            'test_driver_shapes': shapes['launches'][name]}


def timed(phase, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f'[time] {phase.__name__} {time.perf_counter() - t0:.1f} s',
          flush=True)
    return out


def main():
    import torch
    t_start = time.perf_counter()
    # the default paths first
    os.environ.pop('MMVID_FUSED_LNQKV', None)
    os.environ.pop('MMVID_ARTV_FUSED', None)
    os.environ.pop('MMVID_ATTN_BF16', None)
    os.environ.pop('MMVID_ATTN_INT8', None)
    phase_device()
    timed(phase_build)
    attention, attention_fp32, attention_clip = timed(phase_attention)
    attention_bwd = timed(phase_attention_backward)
    attention_tp = timed(phase_attention_tp)
    attention_int8 = timed(phase_attention_int8)
    artv_decode, decode_by_pos = timed(phase_artv_decode)
    gridstep, probe = timed(phase_gridstep)
    keys = ('max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms',
            'bound_by')
    sample_head, head_extra = timed(phase_sample_head)
    ln_qkv, ln_qkv_at = timed(phase_ln_qkv)
    codebook, codebook_at = timed(phase_codebook)
    rows = {'attention': tuple(attention[(629, False)][k] for k in keys),
            'attention_int8': tuple(attention_int8[629][k] for k in keys),
            'sample_head': sample_head,
            'codebook': codebook,
            'fused_ln_qkv': ln_qkv,
            'artv_decode': artv_decode, 'gridstep': gridstep}
    timed(phase_tiny_reference)
    timed(phase_tiny_artv)
    timed(phase_tiny_artv_spec)
    timed(phase_tiny_train)
    flagship, flagship_fp32 = timed(phase_main_path)
    text_mask, fused = timed(phase_text_mask)
    artv, artv_per_layer = timed(phase_artv)
    artv_spec, _ = timed(phase_artv_spec)
    int8_serving = timed(phase_int8_serving)
    _, artv_int8_counts = timed(phase_artv_int8)
    train, train_artv = timed(phase_train)
    eval_res = timed(phase_eval)
    train_driver, run_dir, driver_tmp = timed(phase_train_driver)
    try:
        ddp_nccl = timed(phase_train_ddp_nccl, driver_tmp, train_driver)
        ddp_gloo = timed(phase_train_ddp_gloo)
        tp_gloo = timed(phase_train_tp_gloo)
        driver_tp = timed(phase_train_driver_tp)
        test_driver = timed(phase_test_driver, run_dir, driver_tmp)
        test_driver_long = timed(phase_test_driver_long, run_dir,
                                 driver_tmp)
        test_driver_debug = timed(phase_test_driver_debug, run_dir,
                                  driver_tmp)
        test_driver_shapes = timed(phase_test_driver_shapes, driver_tmp)
        test_driver_eval = timed(phase_test_driver_eval, run_dir,
                                 driver_tmp)
        clip_run = timed(phase_clip, run_dir, driver_tmp)
        _, roberta_dir = timed(phase_roberta)
        try:
            text_augment = timed(phase_text_augment, driver_tmp,
                                 roberta_dir)
        finally:
            shutil.rmtree(roberta_dir, ignore_errors=True)
    finally:
        shutil.rmtree(driver_tmp, ignore_errors=True)
    vqgan_train = timed(phase_vqgan_train)
    media = timed(phase_media)
    sources = {'attention': 'mmvid_tpu/ops/attention.py:211',
               'attention_int8': 'mmvid_tpu/ops/attention.py:211',
               'sample_head': 'mmvid_tpu/ops/sample_head.py:97',
               'codebook': 'mmvid_tpu/ops/codebook.py:59',
               'fused_ln_qkv': 'mmvid_tpu/ops/fused_ln_qkv.py:65',
               'artv_decode': 'mmvid_tpu/ops/artv_decode.py:284',
               'gridstep': 'scripts/probe_gridstep.py:36'}
    # launches: the main path that runs the kernel (the gated kernels
    # with their gate on; the probe runs on none); the numbers: at that
    # path's shapes
    main_run = {'attention': text_mask, 'attention_int8': int8_serving,
                'sample_head': text_mask,
                'codebook': text_mask, 'fused_ln_qkv': fused,
                'artv_decode': artv, 'gridstep': artv}
    kernels = []
    for name, row in rows.items():
        entry = {'name': name, 'route': 'cuda',
                 'source': f'mmvid_tpu_torch/csrc/{name}.cu',
                 'replaces': sources[name],
                 'launches': main_run[name][name],
                 **dict(zip(keys, row)),
                 'launches_by_path': {'flagship': flagship[name],
                                      'text_mask': text_mask[name],
                                      'text_mask_fused': fused[name],
                                      'artv': artv[name],
                                      'artv_per_layer': artv_per_layer[name],
                                      'artv_spec': artv_spec[name],
                                      'int8_serving': int8_serving[name],
                                      'artv_int8': artv_int8_counts[name],
                                      # a training step each
                                      'train': train['launches_per_step'][
                                          name],
                                      'train_artv': train_artv[
                                          'launches_per_step'][name],
                                      # the drivers' whole runs
                                      'train_driver': train_driver[
                                          'launches'][name],
                                      # world size 1 over NCCL, its first
                                      # 3 iterations; a gloo rank's 3 fp32
                                      # steps at batch 24 (attention: the
                                      # fp32 route's)
                                      'train_driver_nccl': ddp_nccl[
                                          'launches'][name],
                                      'train_ddp_gloo_rank': ddp_gloo[
                                          'float32']['launches'][name],
                                      'test_driver': test_driver[
                                          'launches'][name],
                                      **_long_launches(
                                          name, test_driver_long,
                                          test_driver_debug,
                                          test_driver_shapes),
                                      # eval: phase_eval's evaluate run
                                      # and the test driver's runs
                                      'eval': eval_res['launches'][name],
                                      'test_driver_eval': test_driver_eval[
                                          'launches'][name],
                                      'test_driver_clip': clip_run[
                                          'launches'][name],
                                      # VQGAN finetuning's driver run
                                      'vqgan_train': vqgan_train[
                                          'launches'][name],
                                      # the training driver on JPEG frames
                                      'media_train_driver': media[
                                          'train_driver']['launches'][
                                          name]}}
        if name == 'attention':
            # the bf16 route (the bf16 paths'), the tensor-core kernel, on
            # packed views; the fp32 route is the next entry
            entry['source'] = 'mmvid_tpu_torch/csrc/attention_sm90.cu'
            entry['tp'] = _tp_entry(attention_tp, 'bfloat16', 'forward',
                                    tp_gloo, driver_tp)
            entry['differ_share'] = attention[(629, False)]['differ_share']
            entry['at_flagship_L565'] = attention[(565, False)]
            entry['bf16_probs'] = {'L629': attention[(629, True)],
                                   'L565': attention[(565, True)]}
        if name == 'attention_int8':
            # MMVID_ATTN_INT8=1; the int8-serving path's launches (two a
            # call: the operand pass and the attention); the body at
            # attention.py:47-53,66-72, chosen at :162
            entry['source'] = 'mmvid_tpu_torch/csrc/attention_int8_sm90.cu'
            entry['at_flagship_L565'] = attention_int8[565]
            entry.update({k: attention_int8[629][k] for k in (
                'differ_share', 'max_steps', 'mean_steps', 'controls',
                'bitwise_repeat', 'equal_with_fp32_mask', 'ms_fp32_mask',
                'sdpa_bf16_ms_context')})
        if name == 'fused_ln_qkv':   # MMVID_FUSED_LNQKV=1, on wgmma
            entry['source'] = 'mmvid_tpu_torch/csrc/fused_ln_qkv_sm90.cu'
            entry['layer_norm_linear_ms'] = ln_qkv_at[16 * 629][
                'layer_norm_linear_ms']
            entry['at_flagship_M9040'] = ln_qkv_at[16 * 565]
        if name == 'artv_decode':   # one cooperative launch a step
            # the phased kernel is the route; the streaming one runs only
            # when asked for
            entry['source'] = 'mmvid_tpu_torch/csrc/artv_decode.cu'
            entry.update(decode_by_pos)
            entry['stream_route'] = {
                'source': 'mmvid_tpu_torch/csrc/artv_decode_sm90.cu',
                'taken': "only when asked for (kernel='stream')",
                'ms_at_pos': {pos: e['stream']['ms'] for pos, e in
                              decode_by_pos['at_pos'].items()},
                'b64_pos370_ms': decode_by_pos['b64_pos370']['stream_ms']}
        if name == 'codebook':   # 2-D tiles, one launch a call
            entry['source'] = 'mmvid_tpu_torch/csrc/codebook_sm90.cu'
            entry['at'] = codebook_at
        if name == 'sample_head':   # the bf16 route, on wgmma
            entry['source'] = 'mmvid_tpu_torch/csrc/sample_head_sm90.cu'
            entry.update({k: e for k, e in head_extra.items()
                          if k != 'fp32_w_route'})
        if name == 'gridstep':
            entry.update(probe)
        kernels.append(entry)
        if name == 'sample_head':   # the fp32-W route, split TF32
            kernels.append(_fp32_head_entry(
                head_extra['fp32_w_route'], flagship_fp32, {
                    'test_driver': test_driver['launches'][name],
                    **_long_launches(name, test_driver_long,
                                     test_driver_debug, test_driver_shapes),
                    'test_driver_eval': test_driver_eval['launches'][name],
                    'test_driver_clip': clip_run['launches'][name],
                    'text_augment_train': text_augment['launches'][name],
                    'text_augment_test': text_augment['test_launches'][
                        name],
                    # generate.main, 3 batches of 16 to GIF and to MP4
                    'generate_gif': media['gif']['launches'][name],
                    'generate_mp4': media['mp4']['launches'][name]}))
        if name == 'attention':
            tp_kw = dict(tp_rows=attention_tp, tp_gloo=tp_gloo,
                         driver_tp=driver_tp)
            kernels.append(_backward_entry(
                'bfloat16', attention_bwd, {
                    'train': train['attention_backward_launches_per_step'],
                    'train_artv': train_artv[
                        'attention_backward_launches_per_step'],
                    'train_driver': train_driver[
                        'attention_backward_launches'],
                    'train_driver_text_mask': train_driver['text_mask'][
                        'attention_backward_launches'],
                    'train_driver_nccl': ddp_nccl[
                        'attention_backward_launches']}, **tp_kw))
            kernels.append(_backward_entry(
                'float32', attention_bwd, {
                    'text_augment_train': text_augment[
                        'attention_backward_launches'],
                    'train_ddp_gloo_rank': ddp_gloo['float32'][
                        'attention_backward_launches']}, **tp_kw))
            kernels.append(_fp32_attention_entry(
                attention_fp32, attention_clip, flagship_fp32, {
                    'test_driver': test_driver['launches'][name],
                    **_long_launches(name, test_driver_long,
                                     test_driver_debug, test_driver_shapes),
                    'test_driver_eval': test_driver_eval['launches'][name],
                    'test_driver_clip': clip_run['launches'][name],
                    'text_augment_train': text_augment['launches'][name],
                    'text_augment_test': text_augment['test_launches'][
                        name],
                    'generate_gif': media['gif']['launches'][name],
                    'generate_mp4': media['mp4']['launches'][name]}))
            kernels[-1]['tp'] = _tp_entry(attention_tp, 'float32', 'forward',
                                          tp_gloo, driver_tp)
    # VQGAN finetuning's path record: the whole iteration's numbers (the
    # nearest-code kernel's own are in the kernels line)
    print('[vqgan train] path ' + json.dumps({k: vqgan_train[k] for k in (
        's_per_iter', 'step_s', 'load_s', 'images_per_s', 'peak_bytes',
        'conv_gflop_per_iter', 'bound_s', 'tiny_metric_gap',
        'tiny_grad_gap', 'tiny_tf32_control', 'profile', 'wall_s')}),
        flush=True)
    print(f'[total] {time.perf_counter() - t_start:.1f} s', flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
