"""The port's drivers (``python -m mmvid_tpu_torch.train`` / ``.test``) on
the CPU at the tiny flags of tests/test_drivers.py::_train_args with
``--device cpu``, their run directories in the reference's format, and
those checkpoints crossing to and from the JAX package
(``mmvid_tpu/utils/torch_compat.py``) without building a JAX model.

* 3 iterations, a checkpoint at 2; ``--auto_resume`` continues at iter 3,
  and its parameters and optimizer state are bitwise equal to an
  uninterrupted 5-iteration run's; the preemption checkpoint on a SIGTERM
  sent from the loop, the signal handlers restored; the ``nan_at``
  checkpoint; ``--async_ckpt`` with retention;
* ``latest_checkpoint`` and ``prune_checkpoints`` as JAX's;
* the test driver from the run's latest checkpoint: mask-predict, ``--ar``
  on an ``--ar`` run, ``--int8``, and the ``--spec`` refusals;
  ``--eval_mode eval`` with ``fvd_prd`` (every artifact, random I3D) and
  with ``clip`` (a tiny ViT-B-32.pt-format archive);
* the writers without Pillow, imageio and OpenCV: a PNG is written (and
  Pillow reads it back equal), and ``generate`` writes every ``--format``
  (gif, mp4, png) under JAX's file names, a ``.txt`` beside each video.
"""

import builtins
import os
import shutil
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from mmvid_tpu.utils import checkpoint as jckpt
from mmvid_tpu.utils import torch_compat as jcompat
from mmvid_tpu_torch import factories, generate, training, weights
from mmvid_tpu_torch import test as ptest
from mmvid_tpu_torch import train as ptrain
from mmvid_tpu_torch.config import process_args
from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.utils import checkpoint as pckpt
from mmvid_tpu_torch.utils import html


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """torch's and the BLAS / OpenMP pools at one thread for the module,
    as tests/test_torch_eval.py::one_thread: the drivers' tiny ops run
    as fast in one, and do not spin against the other test workers'
    threads (the suite runs six processes on the CPU)."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope='module')
def data_tree(tmp_path_factory):
    """6 clips of 10 frames at 32 px, written through every filter type."""
    root = tmp_path_factory.mktemp('driver') / 'mmvox'
    rng = np.random.RandomState(0)
    for i in range(6):
        key = f'id{i:05d}#c{i}#000'
        d = root / 'video' / key
        d.mkdir(parents=True)
        for j in range(10):
            png.write_png(d / f'{j:03d}.png',
                          rng.randint(0, 255, (32, 32, 3)).astype(np.uint8),
                          (i + j) % 5)
        (root / 'txt').mkdir(exist_ok=True)
        (root / 'txt' / f'{key}.txt').write_text(
            f'a person number {i} is talking\n')
    return root


MODEL = ['--which_transformer', 'custom:64:2:2', '--dim', '64',
         '--text_seq_len', '12', '--num_targets', '2', '--frame_num', '2',
         '--frame_step', '2', '--image_size', '32', '--device', 'cpu']


def _train_args(data_tree, logs, name, extra=()):
    return process_args(train=True, argv=[
        '--image_text_folder', str(data_tree), '--dataset', 'video_text',
        '--name', name, '--log_root', str(logs), '--batch_size', '2',
        '--iters', '3', '--num_visuals', '0', *MODEL,
        '--save_every_n_steps', '2', '--log_every', '1',
        '--sample_every', '100000', '--num_workers', '2',
        '--beta_rel', '0.0', '--beta_vid', '0.0',
        '--lr_scheduler_warmup', '2', '--deterministic', *extra])


def _test_args(data_tree, logs, name, extra=()):
    return process_args(train=False, argv=[
        '--image_text_folder', str(data_tree), '--dataset', 'video_text',
        '--name', name, '--log_root', str(logs), '--batch_size', '2',
        *MODEL, '--n_per_sample', '1', '--mask_predict_steps', '2',
        '--num_workers', '2', *extra])


def _iters(log_dir):
    return [int(line.split()[1]) for line in
            (log_dir / 'log.txt').read_text().splitlines()
            if line.startswith('iter ')]


def _payload(path):
    return torch.load(path, map_location='cpu', weights_only=False)


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """A checkpoint here is 0.3 GB (the full VQGAN's weights): each test's
    files go when it ends."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope='module')
def run(data_tree, tmp_path_factory):
    """A 3-iteration run, a checkpoint at 2: (logs root, run dir)."""
    logs = tmp_path_factory.mktemp('logs')
    record = ptrain.main_worker(_train_args(data_tree, logs, 'tiny'))
    assert record['start_iter'] == 0
    assert [r['iter'] for r in record['iters']] == [0, 1, 2]
    yield logs, logs / 'tiny'
    shutil.rmtree(logs, ignore_errors=True)


def test_train_three_iterations(run):
    _, log_dir = run
    assert _iters(log_dir) == [0, 1, 2]
    line = (log_dir / 'log.txt').read_text().splitlines()[0]
    assert 'loss' in line and 'gnorm' in line and 'nan' not in line
    w = log_dir / 'weights'
    assert sorted(os.listdir(w)) == ['2', '3', 'last']
    ck = _payload(w / '2' / 'dalle.pt')
    assert {'iter', 'hparams', 'vae_params', 'weights', 'opt_state',
            'step'} <= set(ck)
    assert ck['iter'] == ck['step'] == 2
    assert ck['hparams']['dim'] == 64
    assert any(k.startswith('vae.model.') for k in ck['weights'])
    assert all(v.dtype == torch.float32 for v in ck['weights'].values()
               if v.is_floating_point())
    assert _payload(w / 'last' / 'dalle.pt')['step'] == 3


def _state(path):
    ck = _payload(path)
    return ck['weights'], ck['opt_state'], ck['step']


def test_auto_resume_is_bitwise_an_uninterrupted_run(run, data_tree,
                                                     tmp_path):
    logs, log_dir = run
    shutil.copytree(log_dir, tmp_path / 'tiny')
    args = _train_args(data_tree, tmp_path, 'tiny', ['--auto_resume'])
    args.iters, args.save_every_n_steps = 5, 100
    record = ptrain.main_worker(args)
    assert record['start_iter'] == 3
    assert _iters(tmp_path / 'tiny') == [0, 1, 2, 3, 4]
    whole = _train_args(data_tree, tmp_path, 'whole')
    whole.iters, whole.save_every_n_steps = 5, 100
    ptrain.main_worker(whole)
    got = _state(tmp_path / 'tiny' / 'weights' / '5' / 'dalle.pt')
    want = _state(tmp_path / 'whole' / 'weights' / '5' / 'dalle.pt')
    assert got[2] == want[2] == 5
    for a, b in zip(got[:2], want[:2]):
        assert sorted(a) == sorted(b)
        bad = [k for k in a if not torch.equal(a[k], b[k])]
        assert not bad, bad


def _patch_step(monkeypatch, after):
    """make_train_step whose step calls ``after(n, metrics)`` after its
    n-th call (1-based)."""
    orig = training.make_train_step

    def patched(model, tc, *rest):
        step = orig(model, tc, *rest)
        calls = {'n': 0}

        def wrapper(*a, **kw):
            state, metrics = step(*a, **kw)
            calls['n'] += 1
            return state, after(calls['n'], metrics)
        return wrapper

    monkeypatch.setattr(training, 'make_train_step', patched)


def test_sigterm_writes_preemption_checkpoint(data_tree, tmp_path,
                                              monkeypatch):
    def after(n, metrics):
        if n == 2:
            signal.raise_signal(signal.SIGTERM)
        return metrics

    _patch_step(monkeypatch, after)
    before = signal.getsignal(signal.SIGTERM)
    args = _train_args(data_tree, tmp_path, 'pre')
    args.iters, args.save_every_n_steps = 50, 100
    record = ptrain.main_worker(args)
    assert signal.getsignal(signal.SIGTERM) is before
    assert [r['iter'] for r in record['iters']] == [0, 1]
    w = tmp_path / 'pre' / 'weights'
    assert _payload(w / 'preempt_at_2' / 'dalle.pt')['step'] == 2
    assert _payload(w / 'last' / 'dalle.pt')['step'] == 2


def test_non_finite_loss_writes_nan_checkpoint(data_tree, tmp_path,
                                               monkeypatch):
    def after(n, metrics):
        if n == 2:
            metrics = dict(metrics, loss=torch.tensor(float('nan')))
        return metrics

    _patch_step(monkeypatch, after)
    with pytest.raises(FloatingPointError, match='iter 1'):
        ptrain.main_worker(_train_args(data_tree, tmp_path, 'nan'))
    w = tmp_path / 'nan' / 'weights'
    assert _payload(w / 'nan_at_1' / 'dalle.pt')['step'] == 1
    assert not (w / 'last').exists()


def test_async_checkpoints_with_retention(data_tree, tmp_path):
    args = _train_args(data_tree, tmp_path, 'async',
                       ['--async_ckpt', '--keep_n_checkpoints', '1'])
    args.save_every_n_steps = 1
    ptrain.main_worker(args)
    w = tmp_path / 'async' / 'weights'
    # the final save is not pruned, as in JAX
    assert sorted(os.listdir(w)) == ['2', '3', 'last']
    assert _payload(w / '2' / 'dalle.pt')['step'] == 2
    assert _payload(w / 'last' / 'dalle.pt')['step'] == 3


def test_latest_and_prune_as_jax(tmp_path):
    tags = ['1', '2', '10', 'last', 'preempt_at_5', 'nan_at_3']
    for pkg in ('jax', 'port'):
        for t in tags:
            (tmp_path / pkg / 'weights' / t).mkdir(parents=True)
    j, p = str(tmp_path / 'jax'), str(tmp_path / 'port')
    assert os.path.relpath(pckpt.latest_checkpoint(p), p) == \
        os.path.relpath(jckpt.latest_checkpoint(j), j) == 'weights/10'
    pckpt.prune_checkpoints(p, 0)
    jckpt.prune_checkpoints(j, 2)
    pckpt.prune_checkpoints(p, 2)
    assert sorted(os.listdir(f'{p}/weights')) == \
        sorted(os.listdir(f'{j}/weights')) == \
        ['10', '2', 'last', 'nan_at_3', 'preempt_at_5']
    for d in ('10', '2'):
        shutil.rmtree(f'{p}/weights/{d}')
        shutil.rmtree(f'{j}/weights/{d}')
    assert os.path.relpath(pckpt.latest_checkpoint(p), p) == \
        os.path.relpath(jckpt.latest_checkpoint(j), j) == 'weights/last'
    assert pckpt.latest_checkpoint(str(tmp_path / 'none')) is \
        jckpt.latest_checkpoint(str(tmp_path / 'none')) is None


def test_port_checkpoint_loads_into_jax(run, data_tree):
    """The port's dalle.pt through JAX's load_dalle_checkpoint: its params
    (and VQGAN params) carried back by weights.load_jax_params give the
    saved weights exactly."""
    _, log_dir = run
    path = log_dir / 'weights' / '3' / 'dalle.pt'
    ck = jcompat.load_dalle_checkpoint(str(path))
    assert ck['iter'] == 3 and ck['hparams']['which_transformer'] == \
        'custom:64:2:2'
    args = _train_args(data_tree, log_dir, 'unused')
    model = factories.get_driver_model(args, 'cpu')
    weights.load_jax_params(model, ck['params'], ck['vae'], ck['cvae'])
    saved = _payload(path)['weights']
    got = model.state_dict()
    assert sorted(got) == sorted(saved)
    bad = [k for k in saved if not torch.equal(got[k], saved[k])]
    assert not bad, bad


def test_jax_checkpoint_loads_into_the_driver(run, data_tree, tmp_path):
    """A JAX-written dalle.pt (save_dalle_checkpoint: no optimizer, iter
    7) resumes the driver at iter 7 with its weights, and samples."""
    _, log_dir = run
    ck = jcompat.load_dalle_checkpoint(
        str(log_dir / 'weights' / '3' / 'dalle.pt'))
    jpath = tmp_path / 'jax.pt'
    jcompat.save_dalle_checkpoint(str(jpath), params=ck['params'], iter=7,
                                  hparams=ck['hparams'],
                                  vae_params=ck['vae'])
    args = _train_args(data_tree, tmp_path, 'fromjax',
                       ['--dalle_path', str(jpath)])
    args.iters, args.save_every_n_steps = 8, 100
    record = ptrain.main_worker(args)
    assert record['start_iter'] == 7
    assert _iters(tmp_path / 'fromjax') == [7]
    out = ptest.main_worker(_test_args(data_tree, tmp_path, 'fromjax_test',
                                       ['--dalle_path', str(jpath)]))
    assert os.listdir(out['sample_dir'])


def _grids(sample_dir):
    grids = [f for f in os.listdir(sample_dir) if f.endswith('.png')]
    assert grids, 'no sample grids written'
    for f in grids:
        img = png.read_rgb(os.path.join(sample_dir, f))
        assert img.ndim == 3 and img.shape[0] > 32
    return grids


def test_test_driver_samples_latest_checkpoint(run, data_tree):
    logs, log_dir = run
    out = ptest.main_worker(_test_args(data_tree, logs, 'tiny',
                                       ['--use_html']))
    assert out['sample_dir'] == str(log_dir / 'samples')
    assert len(_grids(out['sample_dir'])) == 2
    assert (log_dir / 'web' / 'index.html').exists()
    out = ptest.main_worker(_test_args(data_tree, logs, 'tiny',
                                       ['--int8', '--name_suffix', '_q']))
    assert out['sample_dir'] == str(logs / 'tiny_q' / 'samples')
    _grids(out['sample_dir'])


def test_test_driver_refusals(run, data_tree, text_augment_run,
                              roberta_dir, monkeypatch):
    """--spec on a mask-predict checkpoint (its hparams say ar False, as
    they override --ar in JAX); --eval_mode long of a fixed-LM checkpoint
    (JAX's long videos feed text ids and never build the LM, ROADMAP
    A9)."""
    logs, _ = run
    with pytest.raises(SystemExit, match='requires --ar'):
        ptest.main_worker(_test_args(data_tree, logs, 'tiny',
                                     ['--spec', '4']))
    assert 'MMVID_ARTV_SPEC' not in os.environ
    lm_logs, lm_run, _ = text_augment_run
    monkeypatch.setenv('ROBERTA_PATH', roberta_dir)
    with pytest.raises(NotImplementedError, match='long of a fixed-LM'):
        ptest.main_worker(_test_args(data_tree, lm_logs, 'x', [
            '--dalle_path', str(lm_run), '--eval_mode', 'long']))


@pytest.fixture(scope='module')
def eval_tree(tmp_path_factory):
    """16 clips of 10 frames at 32 px: one batch of the eval mode's 16."""
    root = tmp_path_factory.mktemp('eval') / 'mmvox'
    rng = np.random.RandomState(1)
    for i in range(16):
        key = f'id{i:05d}#e{i}#000'
        d = root / 'video' / key
        d.mkdir(parents=True)
        for j in range(10):
            png.write_png(d / f'{j:03d}.png',
                          rng.randint(0, 255, (32, 32, 3)).astype(np.uint8),
                          (i + j) % 5)
        (root / 'txt').mkdir(exist_ok=True)
        (root / 'txt' / f'{key}.txt').write_text(
            f'a person number {i} is talking\n')
    return root


def test_test_driver_eval_writes_every_artifact(run, eval_tree,
                                                monkeypatch):
    """``--eval_mode eval --eval_metric fvd_prd`` (evaluation.sh's) at
    the tiny flags: the batch forced to 16, random I3D under
    MMVID_ALLOW_RANDOM_I3D, every artifact of the JAX package's
    ``evaluate`` written."""
    logs, _ = run
    monkeypatch.setenv('MMVID_ALLOW_RANDOM_I3D', '1')
    monkeypatch.delenv('I3D_CHECKPOINT', raising=False)
    args = _test_args(eval_tree, logs, 'tiny', [
        '--eval_mode', 'eval', '--eval_metric', 'fvd_prd', '--eval_num',
        '16', '--name_suffix', '_eval=fvd'])
    results = ptest.main_worker(args)
    assert args.batch_size == 16
    assert np.isfinite(results['fvd'])
    assert all(0 <= v <= 1 for v in results['prd'])
    metrics = logs / 'tiny_eval=fvd' / 'metrics'
    for name in ('real_embs.npy', 'fake_embs.npy'):
        assert np.load(metrics / name).shape == (16, 400)
    text = (metrics / 'fvd_score.txt').read_text()
    assert text.startswith(str(results['fvd'])) and 'n_samples = 16' in text
    assert (metrics / 'prd_score.txt').read_text() == (
        f'F_8 = {results["prd"][0]}, F_1/8 = {results["prd"][1]}\n')
    assert (metrics / 'prd_data.pkl').exists()


def test_test_driver_clip_score(run, eval_tree, tmp_path):
    """``--eval_metric clip`` with a ViT-B-32.pt-format archive (the
    BPE's 49408 ids and 77 positions, tiny widths) made by the port's
    CLIP: ``clip_score.txt`` and the (mean, std) pair."""
    from test_torch_clip_full import make_archive
    from mmvid_tpu_torch.models.clip_full import ClipConfig
    logs, _ = run
    archive = tmp_path / 'ViT-B-32.pt'
    make_archive(ClipConfig(embed_dim=32, image_resolution=32,
                            vision_width=64, vision_layers=1,
                            vision_patch_size=16, context_length=77,
                            vocab_size=49408, transformer_width=64,
                            transformer_layers=1), archive, 4)
    args = _test_args(eval_tree, logs, 'tiny', [
        '--eval_mode', 'eval', '--eval_metric', 'clip', '--eval_num', '16',
        '--openai_clip_model_path', str(archive), '--name_suffix', '_clip'])
    results = ptest.main_worker(args)
    mean, std = results['clip']
    assert -1 <= mean <= 1 and std >= 0 and 'fvd' not in results
    text = (logs / 'tiny_clip' / 'metrics' / 'clip_score.txt').read_text()
    assert text == f'{mean} +/- {std}\n'


def test_ar_run_and_samples(data_tree, tmp_path):
    args = _train_args(data_tree, tmp_path, 'ar',
                       ['--ar', '--num_visuals', '1', '--visual'])
    args.iters, args.save_every_n_steps = 2, 100
    ptrain.main_worker(args)
    assert _iters(tmp_path / 'ar') == [0, 1]
    for extra in ([], ['--spec', '2']):
        out = ptest.main_worker(_test_args(
            data_tree, tmp_path, 'ar', ['--ar', '--num_visuals', '1',
                                        '--visual', *extra]))
        _grids(out['sample_dir'])
    assert 'MMVID_ARTV_SPEC' not in os.environ
    with pytest.raises(SystemExit, match='drop --int8'):
        ptest.main_worker(_test_args(data_tree, tmp_path, 'ar', [
            '--ar', '--num_visuals', '1', '--visual', '--spec', '4',
            '--int8']))


@pytest.fixture
def no_pillow_no_imageio(monkeypatch):
    """Imports of PIL, imageio and cv2 raise."""
    real = builtins.__import__

    def patched(name, *a, **kw):
        if name.split('.')[0] in ('PIL', 'imageio', 'cv2'):
            raise ImportError(f'no module named {name!r}')
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, '__import__', patched)


def test_writers_without_pillow_or_imageio(tmp_path, no_pillow_no_imageio,
                                           monkeypatch):
    img = np.random.RandomState(0).rand(17, 29, 3)
    html.save_image_array(str(tmp_path / 'x.png'), img)
    monkeypatch.undo()
    back = np.asarray(Image.open(tmp_path / 'x.png'))
    np.testing.assert_array_equal(back, (img * 255).astype(np.uint8))


def test_generate_gif_refused_before_sampling(tmp_path,
                                              no_pillow_no_imageio,
                                              monkeypatch):
    """``generate.main`` with PIL, imageio and cv2 unimportable writes
    every ``--format`` (it refused gif, and mp4 without OpenCV, before):
    JAX's names (``{i:04d}_`` and the prompt's first six words), one
    ``.txt`` beside each video, the GIF and MP4 parsed back."""
    from types import SimpleNamespace
    hparams = {'dim': 64, 'text_seq_len': 12, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32,
               'which_transformer': 'custom:64:2:2'}
    args = SimpleNamespace(**hparams, insert_sep=False,
                           use_separate_visual_emb=False,
                           fixed_language_model=None,
                           text_emb_bottleneck=None)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    factories.init_weights(model, torch.Generator().manual_seed(0))
    torch.save({'iter': 1, 'hparams': hparams,
                'weights': model.state_dict()}, tmp_path / 'dalle.pt')
    prompts = ['a man', 'a woman with wavy hair is talking to someone now']
    want = [f'{i:04d}_' + '_'.join(p.split()[:6])[:48]
            for i, p in enumerate(prompts)]
    for fmt in ('gif', 'mp4', 'png'):
        out = tmp_path / fmt
        generate.main(['--dalle_path', str(tmp_path / 'dalle.pt'),
                       '--prompts', *prompts, '--device', 'cpu',
                       '--no-bf16', '--mask_predict_steps', '2',
                       '--batch_size', '1', '--out_dir', str(out),
                       '--format', fmt])
        assert sorted(os.listdir(out)) == sorted(
            [f'{w}.{fmt}' for w in want] + [f'{w}.txt' for w in want])
        for w, p in zip(want, prompts):
            assert (out / f'{w}.txt').read_text() == p
    monkeypatch.undo()
    for w in want:
        with Image.open(tmp_path / 'gif' / f'{w}.gif') as im:
            assert (im.n_frames, im.size) == (2, (32, 32))
        assert png.read_rgb(tmp_path / 'png' / f'{w}.png').shape == (
            32, 64, 3)
        data = (tmp_path / 'mp4' / f'{w}.mp4').read_bytes()
        assert data[4:8] == b'ftyp' and b'avcC' in data


# -- the text_augment recipe: the fixed language model -----------------------

LM_WIDTH = 32


@pytest.fixture(scope='module')
def roberta_dir(tmp_path_factory):
    """A tiny RoBERTa folder (chip_smoke.write_roberta_archive: 2 layers
    of 32, a BPE vocabulary learned on the recipe's captions)."""
    from chip_smoke import write_roberta_archive
    from mmvid_tpu_torch.models.roberta import RobertaConfig
    folder = tmp_path_factory.mktemp('roberta')
    write_roberta_archive(str(folder), RobertaConfig(
        hidden_size=LM_WIDTH, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, max_position_embeddings=134,
        type_vocab_size=1, layer_norm_eps=1e-5), seed=4)
    yield str(folder)
    shutil.rmtree(folder, ignore_errors=True)


def _recipe(script, paths, extra):
    from chip_smoke import recipe_argv
    return recipe_argv('text_augment', script, paths) + [
        *MODEL, '--batch_size', '2', '--num_workers', '2', *extra]


def _count_lm(monkeypatch, calls):
    real = factories.get_fixed_language_model

    def counted(args, device='cuda'):
        encode, dim = real(args, device)

        def wrapped(texts):
            calls.append(list(texts))
            return encode(texts)
        return wrapped, dim

    monkeypatch.setattr(factories, 'get_fixed_language_model', counted)


@pytest.fixture(scope='module')
def text_augment_run(data_tree, roberta_dir, tmp_path_factory):
    """text_augment/train.sh's flags at the tiny size, ROBERTA_PATH at the
    tiny folder, with ``--text_emb_bottleneck 8`` for the round trip
    below, 2 iterations: (logs root, run dir, the captions the LM
    encoded)."""
    logs = tmp_path_factory.mktemp('ta_logs')
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('ROBERTA_PATH', roberta_dir)
        _count_lm(mp, calls)
        args = process_args(train=True, argv=_recipe('train.sh', {
            '--image_text_folder': str(data_tree), '--vae_path': ''}, [
            '--log_root', str(logs), '--iters', '2', '--log_every', '1',
            '--text_emb_bottleneck', '8']))
        ptrain.main_worker(args)
    yield logs, logs / args.name, calls
    shutil.rmtree(logs, ignore_errors=True)


def test_text_augment_train_and_test(text_augment_run, data_tree,
                                     roberta_dir, monkeypatch):
    """train.sh: one LM call a step on the batch's captions, the feature
    layout's weights and the hparams (fixed_language_model,
    text_emb_bottleneck) in the checkpoint; test.sh on that run (its
    flags carry no bottleneck: the hparams bring it back) samples the
    grid from ``--description``'s features, one LM call."""
    logs, run_dir, calls = text_augment_run
    assert _iters(run_dir) == [0, 1]
    assert [len(c) for c in calls] == [2, 2]
    ck = _payload(run_dir / 'weights' / 'last' / 'dalle.pt')
    assert ck['hparams']['fixed_language_model'] == 'roberta-large'
    assert ck['hparams']['text_emb_bottleneck'] == '8'
    assert {'fixed_language_model', 'text_emb_bottleneck'} <= set(
        generate.HPARAM_KEYS)
    text_keys = sorted(k for k in ck['weights'] if k.startswith('text_'))
    assert text_keys == sorted(f'text_feature_mapping.{i}.{leaf}'
                               for i in range(5)
                               for leaf in ('weight', 'bias'))
    assert ck['weights']['text_feature_mapping.1.weight'].shape == (
        8, LM_WIDTH)
    monkeypatch.setenv('ROBERTA_PATH', roberta_dir)
    test_calls = []
    _count_lm(monkeypatch, test_calls)
    out = ptest.main_worker(process_args(train=False, argv=_recipe(
        'test.sh', {'--image_text_folder': str(data_tree),
                    '--dalle_path': str(run_dir)},
        ['--log_root', str(logs), '--n_per_sample', '1',
         '--mask_predict_steps', '2'])))
    assert test_calls == [['A girl.'] * 2]
    assert len(_grids(out['sample_dir'])) == 1


def test_fixed_lm_checkpoint_crosses_to_jax(text_augment_run, data_tree):
    """The run's dalle.pt (text_feature_mapping.0-4) through JAX's
    load_dalle_checkpoint and carried back by weights.load_jax_params
    gives every saved weight; JAX's writer of those params is read back by
    the port with every key and value."""
    logs, run_dir, _ = text_augment_run
    path = run_dir / 'weights' / 'last' / 'dalle.pt'
    ck = jcompat.load_dalle_checkpoint(str(path))
    assert set(ck['params']['tfm_ln0']) == {'scale', 'bias'}
    args = process_args(train=True, argv=_recipe('train.sh', {
        '--image_text_folder': str(data_tree), '--vae_path': ''},
        ['--text_emb_bottleneck', '8']))
    model = factories.get_driver_model(args, 'cpu',
                                       text_feature_dim=LM_WIDTH)
    weights.load_jax_params(model, ck['params'], ck['vae'], ck['cvae'])
    saved = _payload(path)['weights']
    got = model.state_dict()
    assert sorted(got) == sorted(saved)
    assert not [k for k in saved if not torch.equal(got[k], saved[k])]
    back = logs / 'jax_written.pt'
    jcompat.save_dalle_checkpoint(str(back), params=ck['params'],
                                  vae_params=ck['vae'],
                                  hparams=ck['hparams'])
    read = weights.read_dalle_checkpoint(str(back))
    assert read['hparams']['fixed_language_model'] == 'roberta-large'
    assert sorted(read['weights']) == sorted(saved)
    assert not [k for k in saved if not np.array_equal(
        np.asarray(read['weights'][k]), saved[k].numpy())]
    back.unlink()


def test_fixed_lm_refusals(text_augment_run, data_tree, roberta_dir,
                           monkeypatch, tmp_path):
    """A fixed-LM checkpoint: ``--eval_mode eval`` and ``generate.py``
    raise (JAX's evaluation and generate.py never build the LM; ROADMAP
    A9); without a ROBERTA_PATH folder the driver raises naming it."""
    logs, run_dir, _ = text_augment_run
    monkeypatch.setenv('ROBERTA_PATH', roberta_dir)
    with pytest.raises(NotImplementedError, match='A9'):
        ptest.main_worker(_test_args(data_tree, logs, 'x', [
            '--dalle_path', str(run_dir), '--eval_mode', 'eval']))
    with pytest.raises(NotImplementedError, match='A9'):
        generate.load_model(generate.parse_args([
            '--dalle_path', str(run_dir / 'weights' / 'last' / 'dalle.pt'),
            '--device', 'cpu', '--no-bf16']))
    monkeypatch.setenv('ROBERTA_PATH', str(tmp_path / 'absent'))
    with pytest.raises(FileNotFoundError, match='ROBERTA_PATH'):
        ptrain.main_worker(process_args(train=True, argv=_recipe(
            'train.sh', {'--image_text_folder': str(data_tree),
                         '--vae_path': ''},
            ['--log_root', str(tmp_path), '--iters', '1'])))
