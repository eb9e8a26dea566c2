"""Flag/config system of the port's drivers.

The port's copy of ``mmvid_tpu/config.py``, flag for flag (the reference
CLI, utils/utils_args.py:5-558), so that the released
``scripts/mmvoxceleb/*/{train,test}.sh`` invocations run unchanged against
``python -m mmvid_tpu_torch.train`` / ``mmvid_tpu_torch.test``.  Three
layered parsers (base / train / test) plus ``process_args``
post-processing that packs the 16 mask-predict hyper-parameters into
``args.mp_config`` (utils/utils_args.py:504-523), normalizes
strategy-probability strings (:539-552) and applies AR-mode overrides
(:529-537).  One flag is the port's own: ``--device`` (default ``cuda``),
the torch device the drivers run on.  The mesh and pipeline flags are
parsed and refused by the drivers where they ask for more than one
device.
"""

from __future__ import annotations

import argparse

import numpy as np


def get_args_base() -> argparse.ArgumentParser:
    """Base flags shared by train and test (reference utils/utils_args.py:5-320)."""
    p = argparse.ArgumentParser()
    add = p.add_argument

    # ----- checkpoints / model selection -----
    add('--vae_path', type=str, help='pretrained VQGAN for video frames')
    add('--cvae_path', type=str, help='VQGAN for visual controls')
    add('--dalle_path', type=str, default=None, help='mmvid model checkpoint')
    add('--which_vae', type=str, default='vqgan1024')
    # dead in the reference too (defined, never read); CLI-compat only
    add('--transformer_path', type=str, default=None)

    # ----- data -----
    add('--image_text_folder', type=str, required=True, help='dataset folder')
    add('--dataset', type=str, default='video_text')
    add('--dataset_keys', type=str, default=None,
        help='text file with a subset of dataset keys to use')
    add('--dataset_cache', type=str, default=None, help='dataset cache .pkl')
    add('--video_only', action='store_true')
    add('--truncate_captions', dest='truncate_captions', action='store_true')
    add('--random_resize_crop_lower_ratio', dest='resize_ratio',
        type=float, default=1)
    add('--which_tokenizer', type=str, default='simple',
        help='(yttm | hug | simple | chinese)')
    add('--bpe_path', type=str, help='path to BPE vocab file')

    # ----- precision / experiment -----
    add('--fp16', action='store_true',
        help='bfloat16 compute policy (name kept for CLI compat)')
    # dead in the reference too (utils_args.py defines it, train.py never
    # reads it; SURVEY §2.3); CLI-compat only
    add('--amp', action='store_true')
    add('--name', default='dalle_train_transformer', help='experiment name')
    add('--visual', action='store_true', help='add visual control?')
    add('--debug', action='store_true')
    add('--use_html', action='store_true')
    add('--log_root', type=str, default='logs')
    add('--seed', default=42, type=int)
    add('--iters', default=200000, type=int)
    add('--batch_size', default=4, type=int)
    add('--deterministic', action='store_true')
    add('--frame_num', default=8, type=int)
    add('--frame_step', default=4, type=int)

    # ----- visual-control conditioning -----
    add('--rand_visual', action='store_true')
    add('--fullvc', action='store_true')
    add('--negvc', action='store_true')
    add('--vc_mode', type=str, default=None)
    add('--attr_mode', type=str, default='object')
    add('--dropout_vc', type=float, default=0.1,
        help='prob of visual control being zeroed')

    # ----- sampling / visualization -----
    add('--mask_predict_steps', nargs='+', default=[0], type=int)
    add('--mask_predict_steps1', default=0, type=int)
    add('--n_sample', default=4, type=int)
    add('--n_per_sample', default=4, type=int)
    add('--drop_sentence', action='store_true')
    add('--fixed_language_model', type=str, default=None,
        help='e.g. roberta-large')

    # ----- model hyperparameters -----
    add('--dim', default=768, type=int)
    add('--text_seq_len', default=50, type=int)
    add('--loss_img_weight', default=7, type=int, help='ART-V only')
    add('--which_transformer', type=str, default='openai_clip_visual')
    add('--image_size', default=None, type=int)
    add('--num_targets', default=1, type=int, help='frames to generate')
    add('--num_visuals', default=1, type=int, help='visual-control frames')
    add('--use_separate_visual_emb', action='store_true')
    add('--num_workers', default=16, type=int)
    add('--text_emb_bottleneck', type=str, default=None)
    add('--visual_aug_mode', type=str, default=None)

    # ----- mask-predict schedule (reference utils/utils_args.py:215-308) -----
    add('--mp_T1n', type=int, default=10)
    add('--mp_T2n', type=int, default=10)
    add('--mp_T3n', type=int, default=30)
    add('--mp_N1n', type=float, default=0.9)
    add('--mp_N2n', type=float, default=0.1)
    add('--mp_N3n', type=float, default=0.125)
    add('--mp_N4n', type=float, default=0.0625)
    add('--mp_T1t', type=int, default=10)
    add('--mp_T2t', type=int, default=5)
    add('--mp_T3t', type=int, default=35)
    add('--mp_N1t', type=float, default=0.)
    add('--mp_N2t', type=float, default=0.)
    add('--mp_N3t', type=float, default=0.)
    add('--mp_N4t', type=float, default=0.)
    add('--mp_T', type=int, default=20)
    add('--mp_B', type=int, default=1, help='beam size')

    add('--ar', action='store_true', help='use autoregressive ART-V model')
    add('--slow', action='store_true', help='iPER speed-variant data')
    add('--insert_sep', action='store_true')
    # NB: dead flag in the reference as well — generate_images forwards
    # argmax into mask_predict's **kwargs, which never reads it
    # (dalle_bert.py:469 vs :514-526); accepted for CLI compatibility.
    add('--pnag_argmax', action='store_true')
    add('--pnag_dynamic', action='store_true')
    add('--openai_clip_model_path', type=str, default='ViT-B-32.pt')

    # ----- the JAX package's additions (not in reference) -----
    add('--mesh_shape', type=str, default=None,
        help='comma list e.g. "dp=8", "dcn=2,dp=4", "dp=2,tp=2"; default: '
             'all devices dp; the port trains over dcn x dp x tp ranks, the '
             'backbone split over tp (a tp must divide the heads; pp > 1 '
             'raises)')
    add('--pp_microbatches', type=int, default=2,
        help='GPipe microbatches per step when the mesh has pp>1 '
             '(clamped to a divisor of the batch)')
    add('--seq_parallel', action='store_true',
        help='sequence-shard the residual stream over tp between blocks '
             '(Megatron-SP style activation sharding; at tp=1 the plain '
             'stack)')
    add('--bf16', action='store_true', help='bfloat16 compute policy')
    add('--profile_dir', type=str, default=None,
        help='write a profiler trace of steps 10-15 here')
    # ----- the port's own -----
    add('--device', type=str, default='cuda',
        help="torch device; 'cpu' runs the kernels' plain versions")
    return p


def get_args_train(argv=None):
    """Training flags (reference utils/utils_args.py:321-440)."""
    p = get_args_base()
    add = p.add_argument
    # data-parallel ranks (mmvid_tpu_torch/parallel/mesh.py), the
    # reference's DDP flags; --workers is shadowed by --num_workers in the
    # reference's own loaders (train.py:232), --gpu_ids is accepted and
    # unused
    add('--rank', type=int, default=0,
        help='this node among --world_size (its ranks are rank * GPUs + '
             'local)')
    add('--gpu_ids', type=int, default=None)
    add('--workers', default=16, type=int)
    add('--world_size', default=1, type=int,
        help='nodes of --multiprocessing_distributed')
    add('--dist_url', default='tcp://localhost:10001', type=str,
        help="the ranks' rendezvous under --multiprocessing_distributed")
    add('--dist_backend', default='nccl', type=str,
        help='nccl (CUDA devices) or gloo (asked for: never a fallback)')
    add('--multiprocessing_distributed', action='store_true',
        help='spawn one data-parallel rank a visible GPU; --batch_size '
             'stays the global batch')
    add('--save_every_n_steps', default=5000, type=int)
    # beyond-parity: overlap the periodic checkpoint write with training (the
    # reference's torch.save blocks the loop); final/emergency saves stay
    # synchronous
    add('--async_ckpt', action='store_true')
    # beyond-parity: restarted jobs (same command line, e.g. after a
    # SIGTERM preemption) resume from their own <log>/weights/last
    add('--auto_resume', action='store_true')
    # beyond-parity: keep only the newest N numeric weights/<iter> dirs
    # (0 = keep all, the reference behavior); last/preempt/nan never pruned
    add('--keep_n_checkpoints', default=0, type=int)
    add('--learning_rate', default=1e-4, type=float)
    add('--clip_grad_norm', default=1.0, type=float)
    add('--no_lr_decay', action='store_true')
    add('--log_every', type=int, default=200)
    add('--sample_every', type=int, default=5000)
    add('--start_iter', default=None, type=int)
    add('--limit_train_batches', type=float, default=1)
    add('--optimizer', type=str, default='adam')
    add('--lr_scheduler', type=str, default='warmuplr')
    add('--lr_scheduler_every', default=1, type=int)
    add('--lr_scheduler_step_size', default=10000, type=int)
    add('--lr_scheduler_warmup', default=5000, type=int)
    add('--weight_decay', type=float, default=0)
    add('--beta_msm', default=7.0, type=float)
    add('--beta_rel', default=0.5, type=float)
    add('--beta_vid', default=0.5, type=float)
    add('--msm_strategy_prob', type=str, default='7,1,1,1')
    add('--msm_bernoulli_prob', type=str, default='0.2,0.2')
    add('--vid_strategy_prob', type=str, default='1,1,1,1')
    add('--rel_no_fully_masked', action='store_true')
    add('--pc_prob', type=float, default=0,
        help='prob of preservation control')
    return p.parse_args(argv), p


def get_args_test(argv=None):
    """Test/eval flags (reference utils/utils_args.py:442-497)."""
    p = get_args_base()
    add = p.add_argument
    add('--name_suffix', default='', type=str)
    add('--test_mode', type=str, default=None)
    add('--eval_mode', type=str, default=None)
    add('--eval_metric', type=str, nargs='+', default=['fvd_prd'])
    add('--eval_num', type=int, default=2048)
    add('--pc_mode', type=str, default=None)  # dead in the reference:
    # flows generate_images -> mask_predict(**kwargs) and is swallowed
    # unread (dalle_bert.py:475, 514-526)
    add('--description', type=str, default=None)
    add('--no_debug', action='store_true')  # dead in the reference:
    # parsed (utils_args.py:474) and never read anywhere
    add('--t_overlap', default=1, type=int)
    add('--t_repeat', default=10, type=int)
    add('--use_cvae', action='store_true')
    add('--save_codebook', action='store_true')
    add('--long_mode', type=str, default='long',
        help='long | interp | interp_real')
    # beyond-parity: w8a8 int8 serving quantization of the backbone
    # (ops/int8.py; calibrated on startup).  NB eval metrics then measure
    # the quantized model.
    add('--int8', action='store_true')
    # beyond-parity: exact speculative AR decode (models/artv_spec.py) —
    # K copy-previous-frame drafts verified per chunk forward, output
    # distribution identical to the plain decode.
    add('--spec', default=0, type=int, metavar='K')
    # opt-in for bench-only env knobs whose output is garbage by design
    # (MMVID_ARTV_SPEC_FORCE=1); serving refuses them otherwise
    add('--bench_unsafe', action='store_true')
    return p.parse_args(argv), p


def process_args(train=False, argv=None):
    """Parse + post-process flags (reference utils/utils_args.py:499-558)."""
    if train:
        args, _ = get_args_train(argv)
    else:
        args, _ = get_args_test(argv)

    # Pack mask-predict hyperparameters (reference utils/utils_args.py:504-523).
    args.mp_config = {
        'T1_n': args.mp_T1n, 'T2_n': args.mp_T2n, 'T3_n': args.mp_T3n,
        'N1_n': args.mp_N1n, 'N2_n': args.mp_N2n, 'N3_n': args.mp_N3n,
        'N4_n': args.mp_N4n,
        'T1_t': args.mp_T1t, 'T2_t': args.mp_T2t, 'T3_t': args.mp_T3t,
        'N1_t': args.mp_N1t, 'N2_t': args.mp_N2t, 'N3_t': args.mp_N3t,
        'N4_t': args.mp_N4t,
        'T': args.mp_T, 'B': args.mp_B,
    }

    args.truncate_captions = True
    args.num_visuals *= args.visual

    if args.ar:  # ART-V overrides (reference utils/utils_args.py:529-537)
        args.debug = False
        args.mask_predict_steps = [0]
        args.mask_predict_steps1 = 0
        args.num_visuals = max(1, args.num_visuals)

    if train:
        if args.ar:
            args.beta_msm = 1.0
        args.lr_decay = not args.no_lr_decay
        if args.msm_strategy_prob is not None:
            msp = np.array(list(map(float, args.msm_strategy_prob.split(','))))
            args.msm_strategy_prob = msp / msp.sum()
        if args.vid_strategy_prob is not None:
            vsp = np.array(list(map(float, args.vid_strategy_prob.split(','))))
            args.vid_strategy_prob = vsp / vsp.sum()
        args.msm_bernoulli_prob = list(
            map(float, args.msm_bernoulli_prob.split(',')))
    else:
        # At test time VAE weights come from the dalle checkpoint
        # (reference utils/utils_args.py:554-557).
        args.vae_path = ""
        args.cvae_path = ""

    return args
