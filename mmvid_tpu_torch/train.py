#!/usr/bin/env python3
"""Training driver of the port (reference train.py:47-395), on one device
or data-parallel over ranks.

The twin of the repository's ``train.py``, with the same CLI: the released
``scripts/mmvoxceleb/*/train.sh`` flags run unchanged as

    python -m mmvid_tpu_torch.train <the train.sh flags> [--device cpu]

The same loop as JAX's: the dataset through the threaded loader, the
MSM/REL/VID step (``training.make_train_step``), ``log.txt`` lines, run
directories in the reference's format (``utils/checkpoint.py``:
``weights/<iter>/dalle.pt`` and ``weights/last``), ``--async_ckpt``,
``--keep_n_checkpoints``, ``--auto_resume``, a ``nan_at_<iter>``
checkpoint and a raise on a non-finite loss, ``preempt_at_<iter>`` and
``last`` on SIGTERM/SIGINT, sample grids every ``--sample_every``, and a
profiler trace of steps 10-15 with ``--profile_dir``.

The step's random draws come from a generator seeded from ``(seed,
iter)``, the counterpart of JAX's ``fold_in(base_key, iter)``, and a
resume starts the loader at the batch the step reads, so a resumed run
takes what an uninterrupted one takes; visualization uses a separate
stream.  ``--device cuda`` (the default) raises when there is no GPU.
With ``--fixed_language_model roberta-large`` (the text_augment recipe)
each step's text is the captions' RoBERTa features on the device
(``factories.get_fixed_language_model``, weights from ``ROBERTA_PATH``).

Data parallelism (``parallel/mesh.py``), one process a rank:

    # one rank a visible GPU, as the reference's mp.spawn (NCCL):
    python -m mmvid_tpu_torch.train <flags> --multiprocessing_distributed
    # ranks started by PyTorch's launcher (any number; on the CPU with
    # --device cpu --dist_backend gloo):
    python -m torch.distributed.run --nproc_per_node N \
        -m mmvid_tpu_torch.train <flags>

``--batch_size`` is the global batch: each rank loads ``batch_size //
N`` (with ``--multiprocessing_distributed`` and no ``--mesh_shape``, N
is the largest count of visible GPUs that divides the batch, as JAX's
default dp).  ``--world_size`` nodes of ``--rank`` (each spawning its
GPUs' ranks) meet at ``--dist_url`` over ``--dist_backend``.  The step
computes the one-process step at the global batch (``training.
make_train_step``); rank 0 alone writes ``args.txt``, ``log.txt``, the
HTML page, the checkpoints, the sample grids and the profiler trace, and
the other ranks wait for it at a barrier; a non-finite loss or a signal
on any rank stops every rank at the same iteration.
"""

from __future__ import annotations

import math
import os
import signal
import time
from pathlib import Path

import numpy as np
import torch

STEP_SALT = 0
VIZ_SALT = 0x5eed5eed


def main(argv=None):
    from mmvid_tpu_torch.config import process_args
    return launch(process_args(train=True, argv=argv))


def launch(args):
    """Train as the flags ask: as one rank of PyTorch's launcher (its
    environment set), one spawned rank a visible GPU
    (``--multiprocessing_distributed``), or one process on one device.
    Returns :func:`main_worker`'s record of this process's run (None
    after a spawn)."""
    from mmvid_tpu_torch.parallel import mesh
    mesh.refuse_model_parallel(args)
    if mesh.launched_by_env():
        if args.multiprocessing_distributed:
            raise ValueError('--multiprocessing_distributed spawns the '
                             'ranks itself: not under a launcher')
        n = int(os.environ['WORLD_SIZE'])
        if args.mesh_shape:
            mesh.mesh_ranks(args.mesh_shape, n)
        return _run_rank(args, int(os.environ['RANK']), n,
                         int(os.environ['LOCAL_RANK']), 'env://')
    if args.multiprocessing_distributed:
        nprocs = spawn_count(args)
        torch.multiprocessing.spawn(spawned_rank, args=(nprocs, args),
                                    nprocs=nprocs)
        return None
    return main_worker(args)


def spawn_count(args) -> int:
    """The ranks ``--multiprocessing_distributed`` spawns on this node:
    one a visible GPU, or ``--mesh_shape``'s dcn * dp over the nodes'
    GPUs, else the largest count that divides the batch (JAX's dp
    default)."""
    from mmvid_tpu_torch.parallel import mesh
    dev = torch.device(args.device)
    if dev.type != 'cuda':
        raise RuntimeError(
            '--multiprocessing_distributed spawns one rank a visible GPU; '
            'on the CPU start the ranks with python -m '
            'torch.distributed.run --nproc_per_node N and --device cpu '
            '--dist_backend gloo')
    resolve_device(args.device)
    mesh.check_backend(args.dist_backend, 'cuda')
    gpus = torch.cuda.device_count()
    if args.mesh_shape:
        mesh.mesh_ranks(args.mesh_shape, args.world_size * gpus)
        return gpus
    dp = mesh.default_dp(args.world_size * gpus, args.batch_size)
    if dp % args.world_size:
        raise ValueError(f'dp={dp} does not split over --world_size '
                         f'{args.world_size} nodes')
    return dp // args.world_size


def spawned_rank(local: int, nprocs: int, args):
    """One rank of ``--multiprocessing_distributed``: rank ``--rank *
    nprocs + local`` of ``--world_size * nprocs``, on its local GPU (the
    reference's ``main_worker(gpu, ngpus, args)``)."""
    return _run_rank(args, args.rank * nprocs + local,
                     args.world_size * nprocs, local, args.dist_url)


def _run_rank(args, rank: int, world: int, local: int, init_method: str):
    from mmvid_tpu_torch.parallel import mesh
    dp = mesh.init(args.dist_backend, mesh.rank_device(args.device, local),
                   rank, world, init_method)
    try:
        return main_worker(args, dp)
    finally:
        mesh.shutdown()


def resolve_device(name: str) -> torch.device:
    """The torch device the flags ask for; a CUDA device must exist (no
    fall back to the CPU)."""
    dev = torch.device(name)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'--device {name}: no CUDA device is available (pass --device '
            'cpu to run the kernels\' plain versions on the CPU)')
    return dev


def refuse_multi_device(args) -> None:
    """One process on one device: the flags that ask for more ranks raise
    (:func:`launch` starts them), and so do ``tp``, ``pp`` and
    ``--seq_parallel``, which are not ported."""
    from mmvid_tpu_torch.parallel import mesh
    mesh.refuse_model_parallel(args)
    if getattr(args, 'multiprocessing_distributed', False) or getattr(
            args, 'world_size', 1) > 1:
        raise NotImplementedError(
            '--multiprocessing_distributed / --world_size: one process here; '
            'the training driver launches the ranks '
            '(mmvid_tpu_torch.train.launch)')
    if getattr(args, 'mesh_shape', None):
        mesh.parse_mesh_shape(args.mesh_shape, 1)


def step_generator(seed: int, idx: int, salt: int, device
                   ) -> torch.Generator:
    """A generator on ``device`` seeded from (salt, seed, idx) alone."""
    state = np.random.SeedSequence([salt, seed, idx]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(state[0]) << 32 | int(state[1]))


def train_config(args):
    """The TrainConfig of the flags, as ``train.py`` builds JAX's."""
    from mmvid_tpu_torch.training import TrainConfig
    return TrainConfig(
        learning_rate=args.learning_rate, optimizer=args.optimizer,
        lr_scheduler=(args.lr_scheduler if args.lr_decay else 'none'),
        lr_scheduler_warmup=args.lr_scheduler_warmup,
        lr_scheduler_step_size=args.lr_scheduler_step_size,
        lr_scheduler_every=args.lr_scheduler_every,
        total_steps=args.iters, weight_decay=args.weight_decay,
        clip_grad_norm=args.clip_grad_norm, beta_msm=args.beta_msm,
        beta_rel=args.beta_rel, beta_vid=args.beta_vid,
        msm_strategy_prob=tuple(args.msm_strategy_prob),
        msm_bernoulli_prob=tuple(args.msm_bernoulli_prob),
        vid_strategy_prob=tuple(args.vid_strategy_prob),
        pc_prob=args.pc_prob,
        rel_no_fully_masked=args.rel_no_fully_masked, negvc=args.negvc,
        rand_visual=args.rand_visual, fullvc=args.fullvc,
        vc_mode=args.vc_mode, visual_aug_mode=args.visual_aug_mode,
        dropout_vc=args.dropout_vc)


def load_dalle_weights(model, weights) -> None:
    """Load a ``dalle.pt`` ``weights`` dict into ``model``: every key of
    the core is required; the VQGANs' (``vae.model.*``, ``cvae.model.*``)
    are loaded where present and left as the model has them otherwise,
    as JAX's driver keeps its VQGAN when a checkpoint has none."""
    from mmvid_tpu_torch.weights import load_weights
    full = {k: v for k, v in model.state_dict().items()
            if k.startswith(('vae.', 'cvae.'))}
    full.update(weights)
    load_weights(model, full)


def host_tree(model, state, idx: int) -> dict:
    """The checkpoint of step ``idx``: the weights (fp32, the VQGANs'
    included) and the optimizer's leaves, on the host."""
    from mmvid_tpu_torch.training import opt_state_leaves
    return {'step': idx,
            'weights': {k: (v.detach().float() if v.is_floating_point()
                            else v.detach()).cpu().clone()
                        for k, v in model.state_dict().items()},
            'opt_state': {k: v.detach().cpu().clone() for k, v in
                          opt_state_leaves(state.opt_state).items()}}


def main_worker(args, dp=None):
    """Train as ``args`` say, in one process on one device, or as the rank
    ``dp`` (a ``parallel.mesh.DataParallel``, whose device it runs on);
    returns the run's record: ``start_iter``, and for each iteration its
    seconds waiting for the loader (``wait_s``), in the step up to its
    loss read (``step_s``, where ``--log_every`` reads it), the logged
    metrics (``metrics``, where it logs), in saves (``save_s``,
    ``save_bytes``) and in visualization (``viz_s``)."""
    from mmvid_tpu_torch import factories, training
    from mmvid_tpu_torch.data.loader import (
        DataLoader,
        Subset,
        infinite_batches,
    )
    from mmvid_tpu_torch.parallel import mesh
    from mmvid_tpu_torch.utils.checkpoint import (
        AsyncCheckpointWriter,
        load_checkpoint,
        prune_checkpoints,
        save_checkpoint,
    )

    if dp is None:
        refuse_multi_device(args)
        device = resolve_device(args.device)
        dp = mesh.LOCAL
    else:
        device = dp.device
    root = mesh.is_root()
    say = print if root else (lambda *a, **k: None)
    log_dir = Path(args.log_root) / args.name
    log_sample_dir = log_dir / 'samples'
    if root:
        log_dir.mkdir(parents=True, exist_ok=True)
        log_sample_dir.mkdir(exist_ok=True)
        (log_dir / 'args.txt').write_text(
            '\n'.join(f'{k}={v}' for k, v in sorted(vars(args).items())))

    webpage = None
    if args.use_html and root:
        from mmvid_tpu_torch.utils.html import initialize_webpage
        webpage = initialize_webpage(
            str(log_dir / 'web'), 'MMVID-TPU: ' + args.name, False)

    # ---- components (reference train.py:129-234) ----
    tokenizer = factories.get_tokenizer(args)
    encode, text_feature_dim = None, 0
    if args.fixed_language_model is not None:
        encode, text_feature_dim = factories.get_fixed_language_model(
            args, device)
    model = factories.get_driver_model(args, device,
                                       text_feature_dim=text_feature_dim)

    # --auto_resume: a restarted job (same command line, e.g. after the
    # SIGTERM preemption checkpoint below) picks up its own weights/last,
    # restoring params, optimizer moments, and the schedule position.
    if args.auto_resume and not args.dalle_path:
        last = log_dir / 'weights' / 'last'
        if (last / 'dalle.pt').is_file():
            args.dalle_path = str(last)
            say(f'auto_resume: restoring from {last}')

    start_iter = args.start_iter or 0
    resume_opt_leaves = None
    if args.dalle_path:
        # every rank reads the same file
        ckpt, _ = load_checkpoint(args.dalle_path)
        load_dalle_weights(model, ckpt['weights'])
        # a JAX-written dalle.pt carries iter only; the port's also the
        # optimizer's leaves and the step
        resume_opt_leaves = ckpt.get('opt_state')
        if args.start_iter is None:
            start_iter = int(ckpt.get('step', ckpt.get('iter', 0)) or 0)

    dataset = factories.get_dataset(args, tokenizer)
    if args.limit_train_batches < 1:
        # random subset of the dataset (reference train.py:217-219)
        rng = np.random.RandomState(args.seed)
        keep = int(args.limit_train_batches * len(dataset))
        dataset = Subset(dataset,
                         rng.permutation(len(dataset))[:max(keep, 1)])
    say(f'{len(dataset)} samples found')
    if len(dataset) == 0:
        raise SystemExit(
            'dataset is empty after filtering (e.g. every clip shorter '
            'than the min_len=8 frame requirement) — infinite_batches '
            'would spin forever on it')
    # --batch_size is the global batch; each rank loads its block of it
    loader = DataLoader(dataset,
                        batch_size=mesh.local_batch(args.batch_size,
                                                    dp.world),
                        num_workers=min(args.num_workers, 16),
                        seed=args.seed, process_index=dp.rank,
                        process_count=dp.world, shard='block')
    batches = infinite_batches(loader, start=start_iter)

    tc = train_config(args)
    step_fn = training.make_train_step(model, tc, dp)
    state = training.create_train_state(model, tc)
    if resume_opt_leaves is not None:
        state.opt_state = training.opt_state_from_leaves(state.opt_state,
                                                         resume_opt_leaves)
    state.step = start_iter
    # rank 0's parameters on every rank, as DDP starts
    dp.broadcast_(list(state.params.values()))

    log_path = log_dir / 'log.txt'
    t0 = time.time()
    profile_dir = args.profile_dir
    profiler = None
    hparams = {k: v for k, v in vars(args).items()
               if isinstance(v, (int, float, str, bool, type(None)))}
    # --async_ckpt: periodic saves overlap with training; emergency/final
    # saves below first wait() so weights/last is never written twice at
    # once
    ckpt_writer = AsyncCheckpointWriter() if args.async_ckpt and root \
        else None
    record = {'start_iter': start_iter, 'iters': []}

    def to_device(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype).to(device)

    def save(tag, idx, keep_last=True, wait=True):
        """Rank 0 writes; every rank leaves once it has (or has handed
        the write to the writer's thread)."""
        t = time.perf_counter()
        nbytes = None
        if root:
            if ckpt_writer is not None and wait:
                ckpt_writer.wait()
            tree = host_tree(model, state, idx)
            if ckpt_writer is not None and not wait:
                ckpt_writer.submit(str(log_dir), tag, tree, hparams=hparams,
                                   keep_last=keep_last)
            else:
                nbytes = os.path.getsize(save_checkpoint(
                    str(log_dir), tag, tree, hparams=hparams,
                    keep_last=keep_last))
        dp.barrier()
        return time.perf_counter() - t, nbytes

    # Graceful preemption (beyond-parity; the reference restarts
    # manually): finish the in-flight step, write a resumable checkpoint,
    # and return so the job supervisor restarts cleanly with --auto_resume.
    preempted = {'sig': None}

    def _on_term(signum, frame):
        preempted['sig'] = signum

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_term)
        except (ValueError, OSError):  # not the main thread
            pass

    try:
        for idx in range(start_iter, args.iters):
            # a signal on any rank stops every rank here
            if dp.any(preempted['sig'] is not None):
                save(f'preempt_at_{idx}', idx)
                say(f'signal {preempted["sig"]}: checkpoint written at '
                    f'iter {idx}; restart with --auto_resume, or '
                    f'--dalle_path {log_dir}/weights/last')
                return record
            rec = {'iter': idx}
            t_it = time.perf_counter()
            with torch.profiler.record_function('mmvid_train_iter'):
                batch = next(batches)
                rec['wait_s'] = time.perf_counter() - t_it
                feed = {'text': (encode(batch['description']) if encode
                                 else to_device(batch['text'], torch.long)),
                        'target': to_device(batch['target'],
                                            torch.float32)}
                if model.cfg.num_visuals > 0 and 'visual' in batch:
                    feed['visual'] = to_device(batch['visual'],
                                               torch.float32)
                if args.negvc and 'text_neg' in batch:
                    feed['text_neg'] = to_device(batch['text_neg'],
                                                 torch.long)
                if args.negvc and 'visual_neg' in batch:
                    feed['visual_neg'] = to_device(batch['visual_neg'],
                                                   torch.float32)

                if profile_dir and root and idx == start_iter + 10:
                    profiler = torch.profiler.profile(activities=(
                        [torch.profiler.ProfilerActivity.CPU]
                        + ([torch.profiler.ProfilerActivity.CUDA]
                           if device.type == 'cuda' else [])))
                    profiler.__enter__()
                gen = step_generator(args.seed, idx, STEP_SALT, device)
                state, metrics = step_fn(state, feed, gen)
                if profiler is not None and idx == start_iter + 15:
                    if device.type == 'cuda':
                        torch.cuda.synchronize(device)
                    profiler.__exit__(None, None, None)
                    os.makedirs(profile_dir, exist_ok=True)
                    profiler.export_chrome_trace(os.path.join(
                        profile_dir, f'trace_{start_iter + 10}.json'))
                    profiler = None

                # failure detection (the reference has none): a
                # non-finite loss aborts with an emergency checkpoint
                # instead of silently corrupting the run; the metrics are
                # the global batch's, so every rank stops here
                if idx % args.log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    rec['metrics'] = m
                    if not math.isfinite(m['loss']):
                        save(f'nan_at_{idx}', idx, keep_last=False)
                        raise FloatingPointError(
                            f'non-finite loss {m["loss"]} at iter {idx}; '
                            f'emergency checkpoint written under '
                            f'{log_dir}/weights/')
                    line = (f'iter {idx} loss {m["loss"]:.4f} '
                            f'msm {m["loss_msm"]:.4f} '
                            f'rel {m["loss_rel"]:.4f} '
                            f'vid {m["loss_vid"]:.4f} '
                            f'gnorm {m["grad_norm"]:.3f} '
                            f'({time.time() - t0:.1f}s)')
                    if root:
                        print(line)
                        with open(log_path, 'a') as f:
                            f.write(line + '\n')
                rec['step_s'] = time.perf_counter() - t_it - rec['wait_s']

            if idx and idx % args.save_every_n_steps == 0:
                rec['save_s'], rec['save_bytes'] = save(
                    idx, idx, wait=ckpt_writer is None)
                if args.keep_n_checkpoints > 0 and root:
                    # safe alongside an in-flight async write: that write
                    # targets the NEWEST numeric dir, which prune
                    # (keep_n >= 1) never deletes, and 'last' is exempt
                    prune_checkpoints(str(log_dir), args.keep_n_checkpoints)

            if idx and idx % args.sample_every == 0 and not args.ar:
                t = time.perf_counter()
                if root:
                    from mmvid_tpu_torch.utils.viz import visualize_train
                    visualize_train(
                        model, dict(batch, text=feed['text']),
                        step_generator(args.seed, idx, VIZ_SALT, device),
                        str(log_sample_dir), idx, n_sample=args.n_sample,
                        n_per_sample=min(args.n_per_sample, 2),
                        mask_predict_steps=args.mask_predict_steps[0],
                        vc_mode=args.vc_mode, rand_visual=args.rand_visual,
                        webpage=webpage, mp_config=args.mp_config)
                dp.barrier()
                rec['viz_s'] = time.perf_counter() - t
            record['iters'].append(rec)
    finally:
        # restore prior dispositions on EVERY exit (normal completion,
        # preemption return, or an abort raise) so handlers never leak
        # into the caller (in-process driver tests run main_worker
        # repeatedly)
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if profiler is not None:
            profiler.__exit__(None, None, None)
        if ckpt_writer is not None:
            ckpt_writer.close()

    s, nbytes = save(args.iters, args.iters)
    record['final_save'] = {'s': s, 'bytes': nbytes}
    say('training done')
    return record


if __name__ == '__main__':
    main()
