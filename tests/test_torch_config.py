"""The port's flags (mmvid_tpu_torch.config) and the training driver's
TrainConfig against the JAX package's, for the flag set of every released
recipe script (scripts/mmvoxceleb/*/{train,test}.sh), parsed from the
scripts with the data folder and the checkpoint paths pointed at a
temporary tree.  Equal ``vars()`` but for the port's own ``--device``;
the strategy probabilities exactly equal (numpy arrays)."""

import dataclasses
import glob
import os
import shlex

import numpy as np
import pytest

from mmvid_tpu import config as jconfig
from mmvid_tpu import training as jtrain
from mmvid_tpu_torch import config as pconfig
from mmvid_tpu_torch import train as ptrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(
    REPO, 'scripts', 'mmvoxceleb', '*', '*.sh')))
RECIPES = [s for s in SCRIPTS
           if os.path.basename(s) in ('train.sh', 'test.sh')]


def script_argv(path, tmp_path):
    """The flags a recipe script passes to train.py / test.py, with
    --image_text_folder and every --*_path pointed into ``tmp_path``."""
    text = open(path).read().replace('\\\n', ' ')
    line = next(ln for ln in text.splitlines()
                if ln.strip().startswith('python3'))
    words = shlex.split(line)[2:]
    out = []
    for i, w in enumerate(words):
        prev = words[i - 1] if i else ''
        if prev == '--image_text_folder' or (prev.endswith('_path')
                                              and prev.startswith('--')):
            w = str(tmp_path / os.path.basename(w))
        out.append(w)
    return out


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b) and np.asarray(a).dtype == \
            np.asarray(b).dtype
    return a == b and type(a) is type(b)


def test_every_recipe_script_is_found():
    assert len(RECIPES) == 16
    train = [s for s in RECIPES if s.endswith('train.sh')]
    assert len(train) == 8


@pytest.mark.parametrize('script', RECIPES,
                         ids=[os.path.relpath(s, REPO) for s in RECIPES])
def test_process_args_equal_jax(script, tmp_path):
    argv = script_argv(script, tmp_path)
    train = script.endswith('train.sh')
    want = vars(jconfig.process_args(train=train, argv=list(argv)))
    got = vars(pconfig.process_args(train=train, argv=list(argv)))
    assert got.pop('device') == 'cuda'
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not _equal(got[k], want[k])]
    assert not bad, {k: (got[k], want[k]) for k in bad}
    got = vars(pconfig.process_args(train=train,
                                    argv=argv + ['--device', 'cpu']))
    assert got['device'] == 'cpu'


def jax_train_config(args):
    """JAX's TrainConfig as the repository's train.py builds it."""
    return jtrain.TrainConfig(
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


TRAIN = [s for s in RECIPES if s.endswith('train.sh')]


@pytest.mark.parametrize('script', TRAIN,
                         ids=[os.path.relpath(s, REPO) for s in TRAIN])
@pytest.mark.parametrize('extra', [[], ['--ar']], ids=['mp', 'ar'])
def test_train_config_equal_jax(script, extra, tmp_path):
    argv = script_argv(script, tmp_path) + extra
    want = dataclasses.asdict(jax_train_config(
        jconfig.process_args(train=True, argv=list(argv))))
    got = dataclasses.asdict(ptrain.train_config(
        pconfig.process_args(train=True, argv=list(argv))))
    assert sorted(got) == sorted(want)
    for k in want:
        assert _equal(got[k], want[k]), (k, got[k], want[k])


def test_driver_refusals(tmp_path):
    """One process: the ranks' flags raise there (``train.launch`` starts
    ranks), as do a tensor-parallel mesh and a data-parallel one larger
    than the one process; a CUDA device that is not there raises instead
    of falling back to the CPU."""
    argv = script_argv(TRAIN[0], tmp_path)
    args = pconfig.process_args(train=True, argv=argv + [
        '--multiprocessing_distributed'])
    with pytest.raises(NotImplementedError, match='launches the ranks'):
        ptrain.refuse_multi_device(args)
    args = pconfig.process_args(train=True, argv=argv + [
        '--mesh_shape', 'dp=4,tp=2'])
    with pytest.raises(NotImplementedError, match='tp > 1 is not ported'):
        ptrain.refuse_multi_device(args)
    args = pconfig.process_args(train=True, argv=argv + [
        '--mesh_shape', 'dp=4'])
    with pytest.raises(ValueError, match='needs 4 devices, have 1'):
        ptrain.refuse_multi_device(args)
    ptrain.refuse_multi_device(pconfig.process_args(
        train=True, argv=argv + ['--mesh_shape', 'dp=1,tp=1']))
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            ptrain.resolve_device('cuda')
    assert ptrain.resolve_device('cpu').type == 'cpu'
