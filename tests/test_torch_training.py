"""The port's training (mmvid_tpu_torch.training, the losses of
models/bert.py, remat) against the JAX package's, on the CPU, at the tiny
flagship config (``__graft_entry__._flagship(tiny=True)``), fp32, JAX
weights and optimizer state carried over through
``weights.load_jax_params`` / ``weights.train_state_from_jax``; the
attention backward, negvc's control and ART-V are in
tests/test_torch_losses.py.

Tolerances (fp32 with sums in another order, and flax's one-pass
LayerNorm variance): losses 1e-5; every parameter's gradient rtol 1e-4 /
atol 1e-6; schedules rtol 1e-6 (fp32 values); one optimizer update 1e-6;
three train steps 1e-5.  The VQGANs' codebooks are given spread (randn)
in both packages, so that the token ids, which the losses take, do not
sit on near-ties.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu import training as jtrain
from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models import masking as jmask
from mmvid_tpu.models.clip import ClipStackConfig as JaxClip
from mmvid_tpu.models.mmvid import MMVIDBert as JaxMMVID
from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE
from mmvid_tpu_torch import factories, training, weights
from mmvid_tpu_torch.models import bert as pbert
from mmvid_tpu_torch.models.clip import (
    ClipStackConfig,
    TransformerStack,
    build_attention_mask,
)
from mmvid_tpu_torch.utils.torch_compat import bert_params_to_torch
from test_torch_eval import one_thread  # noqa: F401 (a fixture)
from test_torch_warp import jax_warp_draws

LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
STEP_TOL = 1e-5


def _spread(vae_params, seed):
    """vae params with a randn codebook (a copy)."""
    params = jax.tree_util.tree_map(lambda x: x, vae_params)
    cb = params['quantize']['embedding']
    params['quantize']['embedding'] = jnp.asarray(
        np.random.RandomState(seed).randn(*cb.shape), jnp.float32)
    return params


@pytest.fixture(scope='module')
def flagship():
    """(JAX tiny MMVIDBert, the port's training build with its weights)."""
    vq = JaxVQCfg(resolution=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                  z_channels=64, embed_dim=64, n_embed=1024,
                  attn_resolutions=())
    k_vae, k_bert = jax.random.split(jax.random.PRNGKey(0))
    vae_params = _spread(jax.jit(JaxVAE(image_size=16, cfg=vq,
                                        params={}).init_params)(k_vae), 1)
    vae = JaxVAE(image_size=16, cfg=vq, params=vae_params)
    cfg = jbert.BertConfig(dim=64, num_text_tokens=100, text_seq_len=8,
                           num_visuals=0, num_targets=2,
                           num_image_tokens=1024, image_fmap_size=8,
                           image_size=16,
                           clip=JaxClip(width=64, layers=2, heads=2))
    params = jax.jit(jbert.BertCore(cfg).init)(
        k_bert, jnp.zeros((1, cfg.text_seq_len), jnp.int32), None,
        jnp.zeros((1, cfg.target_seq_len), jnp.int32))['params']
    jmodel = JaxMMVID(cfg, vae, params=params)
    pmodel, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                         device='cpu', seed=1, remat=True)
    weights.load_jax_params(pmodel, params, vae_params)
    return jmodel, pmodel


def _batch(cfg, b=4, seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 100, (b, cfg.text_seq_len)).astype(np.int32)
    text[:, -2:] = 0                                  # padding positions
    frames = rng.uniform(0, 1, (b, cfg.num_targets, cfg.image_size,
                                cfg.image_size, 3)).astype(np.float32)
    return text, frames


def _torch_batch(text, frames):
    return {'text': torch.from_numpy(text).long(),
            'target': torch.from_numpy(frames)}


_jax_msm_mask = jax.jit(jmask.sample_msm_mask, static_argnums=(1, 2, 3, 4, 5))


def _jax_draws(cfg, tc, key, b):
    """The draws of JAX's step for ``key`` (no visual control): its split
    of the key, the MSM masks through JAX's sample_msm_mask, and the
    warp's through test_torch_warp.jax_warp_draws."""
    _, key = jax.random.split(key)             # k_vc, then the loss key
    _, k_mask, k_warp = jax.random.split(key, 3)
    keep, nfm = _jax_msm_mask(k_mask, cfg, tc.msm_strategy_prob,
                              tc.msm_bernoulli_prob, tc.pc_prob, b)
    return {'keep': torch.from_numpy(np.array(keep)),
            'nfm': torch.from_numpy(np.array(nfm)),
            'warp': jax_warp_draws(k_warp, b, cfg.num_targets,
                                   tc.vid_strategy_prob)}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _hold_params(params, jax_params, dim, lr_sum):
    """Parameters after Adam steps within STEP_TOL of JAX's, except the
    key projection's bias: its gradient is exactly 0 (softmax cancels a
    constant added to a query's logits), so each package's Adam divides its
    own rounding noise (below 1e-6, test_bert_losses_and_gradients_
    match_jax) by the
    noise's own scale and moves the bias by up to the lr a step in either
    direction; those elements are held to three times the lr summed over
    the steps instead."""
    want = bert_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                       jax_params))
    for name, p in params.items():
        got = p.detach().numpy().copy()
        if name.endswith('attn.in_proj_bias'):
            key_bias = slice(dim, 2 * dim)
            assert np.abs(got[key_bias] - want[name][key_bias]).max() <= (
                3 * lr_sum), name
            got[key_bias] = want[name][key_bias]
        _close(got, want[name], STEP_TOL, STEP_TOL, name)


def test_remat_gives_the_same_gradients():
    cfg = ClipStackConfig(width=64, layers=2, heads=2)
    torch.manual_seed(1)
    stack = TransformerStack(cfg)
    x = torch.randn(2, 13, 64)
    mask = build_attention_mask(13, 'causal')
    stack(x, mask).square().sum().backward()
    want = {n: p.grad.clone() for n, p in stack.named_parameters()}
    stack.zero_grad()
    stack.cfg = dataclasses.replace(cfg, remat=True)
    stack(x, mask).square().sum().backward()
    for n, p in stack.named_parameters():
        assert torch.equal(p.grad, want[n]), n
    stack.cfg = dataclasses.replace(cfg, remat=True,
                                    int8_scales=((1.0,) * 4,) * 2)
    with pytest.raises(RuntimeError, match='serving-only'):
        with torch.no_grad():
            stack(x, mask)


# -- losses ----------------------------------------------------------------

@pytest.mark.parametrize('rel_nfm,negvc', [(False, False), (True, False),
                                           (True, True)])
def test_bert_losses_and_gradients_match_jax(flagship, rel_nfm, negvc):
    """bert_losses on the same tokens, masks and VID negatives: the three
    losses within 1e-5, and every parameter's gradient of the step's total
    (beta 7 / 0.5 / 0.5) within rtol 1e-4 / atol 1e-6 (JAX's gradient
    tree through the same layout conversion as the params)."""
    jmodel, pmodel = flagship
    cfg = jmodel.cfg
    rng = np.random.RandomState(5)
    b, n = 4, cfg.target_seq_len
    text = rng.randint(0, 100, (b, cfg.text_seq_len)).astype(np.int32)
    tgt = rng.randint(0, 1024, (b, n)).astype(np.int32)
    warp_t = rng.randint(0, 1024, (b, n)).astype(np.int32)
    keep = rng.rand(b, n) < 0.3
    keep[1] = False                                   # fully masked
    nfm = np.array([1, 0, 1, 1], np.float32)
    text_neg = rng.randint(0, 100, (b, cfg.text_seq_len)).astype(np.int32)
    kw = dict(rel=True, vid=True, rel_no_fully_masked=rel_nfm)

    def jax_total(p):
        msm, rel, vid = jbert.bert_losses(
            jmodel.core, p, text=jnp.asarray(text), visual_tokens=None,
            target_tokens=jnp.asarray(tgt),
            target_tokens_warp=jnp.asarray(warp_t),
            keep_gt_mask=jnp.asarray(keep),
            not_fully_masked=jnp.asarray(nfm),
            control_neg=jnp.asarray(text_neg) if negvc else None, **kw)
        return 7.0 * msm + 0.5 * rel + 0.5 * vid, (msm, rel, vid)

    (_, want), jgrads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        jmodel.params)
    t = lambda a: torch.from_numpy(a).long()
    weights.load_jax_params(pmodel, jmodel.params, jmodel.vae.params)
    got = pbert.bert_losses(
        pmodel.core, text=t(text), visual_tokens=None, target_tokens=t(tgt),
        target_tokens_warp=t(warp_t), keep_gt_mask=torch.from_numpy(keep),
        not_fully_masked=torch.from_numpy(nfm),
        control_neg=t(text_neg) if negvc else None, **kw)
    for name, g, w in zip(('msm', 'rel', 'vid'), got, want):
        _close(g.detach(), w, 0, LOSS_TOL, name)
    params = training.trainable_parameters(pmodel)
    grads = torch.autograd.grad(7.0 * got[0] + 0.5 * got[1] + 0.5 * got[2],
                                list(params.values()))
    want_g = bert_params_to_torch(jax.tree_util.tree_map(np.asarray,
                                                         jgrads))
    assert sorted(want_g) == sorted(params)
    for name, g in zip(params, grads):
        _close(g, want_g[name], GRAD_RTOL, GRAD_ATOL, name)


def test_swap_halves_and_bce_match_jax():
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32) * 30
    for b in (4, 5):
        _close(pbert.swap_halves(torch.from_numpy(x[:b])),
               jbert.swap_halves(jnp.asarray(x[:b])), 0, 0, 'swap')
    lab = (x > 0).astype(np.float32)
    _close(pbert.bce_logits_none(torch.from_numpy(x), torch.from_numpy(lab)),
           jbert.bce_logits_none(jnp.asarray(x), jnp.asarray(lab)), 0, 1e-6,
           'bce')


# -- gradients of the whole loss -------------------------------------------

TC = jtrain.TrainConfig(learning_rate=1e-3, lr_scheduler='warmuplr',
                        lr_scheduler_warmup=3, rel_no_fully_masked=True,
                        msm_bernoulli_prob=(0.2, 0.5), dropout_vc=0.0)


def _port_tc(tc):
    return training.TrainConfig(**{f.name: getattr(tc, f.name)
                                   for f in dataclasses.fields(tc)})


def test_train_config_fields_match_jax():
    j, p = jtrain.TrainConfig(), training.TrainConfig()
    assert [f.name for f in dataclasses.fields(j)] == [
        f.name for f in dataclasses.fields(p)]
    assert dataclasses.asdict(j) == dataclasses.asdict(p)


# -- schedules and optimizer -----------------------------------------------

@pytest.mark.parametrize('sched', ['warmuplr', 'warmupdecaylr', 'steplr',
                                   'cosineannealinglr', 'reducelronplateau',
                                   'none'])
def test_lr_schedule_matches_optax(sched):
    tc = jtrain.TrainConfig(learning_rate=3e-4, lr_scheduler=sched,
                            lr_scheduler_warmup=10, lr_scheduler_step_size=7,
                            total_steps=25)
    want = jax.jit(jax.vmap(jtrain.make_lr_schedule(tc)))(jnp.arange(20))
    got = [training.make_lr_schedule(_port_tc(tc))(i) for i in range(20)]
    _close(got, want, 1e-6, 0, sched)


OPT_CONFIGS = {
    'adam': dict(optimizer='adam'),
    'adamw': dict(optimizer='adamw', weight_decay=0.1),
    'adam_l2': dict(optimizer='adam', weight_decay=0.1),
    'plateau': dict(optimizer='adam', lr_scheduler='reducelronplateau',
                    lr_scheduler_every=2),
}


@pytest.mark.parametrize('name', list(OPT_CONFIGS))
def test_optimizer_update_matches_optax(name):
    """Updates and state of the port's optimizer against optax's, on the
    same params, gradients (clipped on odd steps: norm above 1) and loss
    values; the plateau over 20 updates (10 checks: a reduction after
    patience, the cooldown, a second reduction)."""
    tc = jtrain.TrainConfig(learning_rate=1e-2, lr_scheduler_warmup=4,
                            **{'lr_scheduler': 'warmuplr',
                               **OPT_CONFIGS[name]})
    rng = np.random.RandomState(0)
    params = {'a.weight': rng.randn(5, 3).astype(np.float32),
              'b.bias': rng.randn(7).astype(np.float32)}
    tx = jtrain.make_optimizer(tc)
    jstate = tx.init(params)
    popt = training.make_optimizer(_port_tc(tc))
    pparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = popt.init(pparams)
    jparams = params
    n = 20 if name == 'plateau' else 3
    for i in range(n):
        scale = 3.0 if i % 2 else 0.1
        grads = {k: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for k, v in params.items()}
        value = np.float32(1.0 if i < 6 else 2.0)
        upd, jstate = tx.update(grads, jstate, jparams, value=value)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        pupd, pstate, _ = popt.update(
            {k: torch.from_numpy(v) for k, v in grads.items()}, pstate,
            pparams, value=torch.tensor(value))
        for k in pparams:
            pparams[k] = pparams[k] + pupd[k]
            _close(pupd[k], upd[k], 0, 1e-6, f'{name} step {i} {k}')
            _close(pparams[k], jparams[k], 0, 1e-6, k)
    adam = weights._find_state(jstate, 'nu')
    assert int(pstate['count']) == int(adam.count) == n
    for k in params:
        _close(pstate['mu'][k], adam.mu[k], 0, 1e-6, 'mu')
        _close(pstate['nu'][k], adam.nu[k], 0, 1e-6, 'nu')
    if name == 'plateau':
        pl = weights._find_state(jstate, 'plateau_count')
        assert float(pl.scale) == 0.25        # two reductions
        for f in training.PLATEAU_FIELDS:
            _close(pstate['plateau'][f], getattr(pl, f), 0, 1e-6, f)


# -- whole steps ----------------------------------------------------------

def test_three_steps_from_jax_state_match_jax(flagship):
    """JAX takes two steps; its state crosses over through
    weights.train_state_from_jax; then both take three more on the same
    draws: parameters (:func:`_hold_params`), moments and metrics within
    1e-5."""
    jmodel, pmodel = flagship
    cfg = jmodel.cfg
    tc = TC
    text, frames = _batch(cfg, seed=1)
    jbatch = {'text': jnp.asarray(text), 'target': jnp.asarray(frames)}
    step = jax.jit(jtrain.make_train_step(jmodel, tc))
    jstate = jtrain.create_train_state(jmodel, tc)
    for i in range(2):
        jstate, _ = step(jstate, jbatch, jax.random.PRNGKey(20 + i))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = weights.train_state_from_jax(
        pmodel, _port_tc(tc), np_tree(jstate.params),
        np_tree(jstate.opt_state), int(jstate.step))
    pstep = training.make_train_step(pmodel, _port_tc(tc))
    batch = _torch_batch(text, frames)
    for i in range(3):
        key = jax.random.PRNGKey(30 + i)
        jstate, jm = step(jstate, jbatch, key)
        state, pm = pstep(state, batch, None, draws=_jax_draws(cfg, tc, key,
                                                               4))
        for k in ('loss', 'loss_msm', 'loss_rel', 'loss_vid', 'grad_norm'):
            _close(pm[k], jm[k], STEP_TOL, STEP_TOL, f'step {i} {k}')
    assert state.step == int(jstate.step) == 5
    _hold_params(state.params, jstate.params, cfg.dim,
                 sum(training.make_lr_schedule(_port_tc(tc))(c)
                     for c in range(2, 5)))
    adam = weights._find_state(np_tree(jstate.opt_state), 'nu')
    mu = bert_params_to_torch(adam.mu)
    for name, t in state.opt_state['mu'].items():
        _close(t, mu[name], STEP_TOL, STEP_TOL, f'mu {name}')


def test_train_state_from_jax_carries_the_plateau(flagship):
    """optax's plateau scalars and Adam's moments, after a few updates of
    JAX's optimizer on the model's params, cross over as they are."""
    jmodel, pmodel = flagship
    tc = dataclasses.replace(TC, lr_scheduler='reducelronplateau')
    tx = jtrain.make_optimizer(tc)
    params = jmodel.params
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, v: tx.update(g, s, params, value=v))
    for i, v in enumerate((3.0, 2.0, 2.5)):
        grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, i + 1.0),
                                       params)
        _, opt_state = update(grads, opt_state, v)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    state = weights.train_state_from_jax(pmodel, _port_tc(tc),
                                         np_tree(params),
                                         np_tree(opt_state), 3)
    pl = weights._find_state(opt_state, 'plateau_count')
    assert int(pl.plateau_count) == 1 and float(pl.best_value) == 2.0
    for f in training.PLATEAU_FIELDS:
        _close(state.opt_state['plateau'][f], getattr(pl, f), 0, 0, f)
    adam = weights._find_state(np_tree(opt_state), 'nu')
    assert state.opt_state['count'] == int(adam.count) == 3
    nu = bert_params_to_torch(adam.nu)
    for name, t in state.opt_state['nu'].items():
        _close(t, nu[name], 0, 0, name)


# -- resume, refusals, the frozen VQGAN, the loss falling ---------------------

def _tiny_port(seed=3):
    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=seed, remat=False)
    return model


def _run(model, state, step, batch, steps, first):
    for i in range(steps):
        state, m = step(state, batch,
                        torch.Generator().manual_seed(first + i))
    return state, m


def test_resume_is_bitwise(tmp_path):
    """Save after two steps (the parameters and opt_state_leaves), load
    into a fresh model and optimizer, take two more: bit for bit the run
    that did not stop."""
    tc = training.TrainConfig(lr_scheduler='reducelronplateau',
                              learning_rate=1e-3, weight_decay=0.01)
    text, frames = _batch(_tiny_port().cfg, b=2, seed=4)
    batch = _torch_batch(text, frames)
    model = _tiny_port()
    step = training.make_train_step(model, tc)
    state = training.create_train_state(model, tc)
    state, _ = _run(model, state, step, batch, 2, 0)
    torch.save({'step': state.step, 'weights': model.state_dict(),
                'opt': training.opt_state_leaves(state.opt_state)},
               tmp_path / 'ckpt.pt')
    state, m = _run(model, state, step, batch, 2, 2)

    fresh = _tiny_port(seed=9)
    ckpt = torch.load(tmp_path / 'ckpt.pt')
    weights.load_weights(fresh, ckpt['weights'])
    template = training.create_train_state(fresh, tc)
    resumed = training.TrainState(
        ckpt['step'], template.params,
        training.opt_state_from_leaves(template.opt_state, ckpt['opt']))
    resumed, m2 = _run(fresh, resumed, training.make_train_step(fresh, tc),
                       batch, 2, 2)
    assert resumed.step == state.step == 4
    assert torch.equal(m['loss'], m2['loss'])
    for (n, p), (n2, p2) in zip(model.state_dict().items(),
                                fresh.state_dict().items()):
        assert n == n2 and torch.equal(p, p2), n
    for a, b in zip(training.opt_state_leaves(state.opt_state).values(),
                    training.opt_state_leaves(resumed.opt_state).values()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='leaf count'):
        training.opt_state_from_leaves(
            training.create_train_state(fresh, training.TrainConfig()
                                        ).opt_state, ckpt['opt'])


@pytest.mark.parametrize('what', ['int8', 'MMVID_ATTN_BF16', 'MMVID_ATTN_INT8',
                                  'MMVID_FUSED_LNQKV'])
def test_train_step_refuses_serving_only(monkeypatch, what):
    model = _tiny_port()
    if what == 'int8':
        model.set_int8_scales(((1.0,) * 4,) * 2)
    else:
        monkeypatch.setenv(what, '1')
    with pytest.raises(RuntimeError, match='serving'):
        training.make_train_step(model, training.TrainConfig())


@pytest.mark.parametrize('remat', [False, True])
def test_attention_backward_calls_a_step(remat):
    """A step of the tiny flagship build runs attention's backward
    (FusedAttention.backward) once for each block of each of its three
    forwards (MSM, REL's negative, VID's negative), with or without remat
    (which runs the forward again, not the backward): the per-block count
    of chip_smoke.TRAIN_BACKWARD_CALLS."""
    from mmvid_tpu_torch.ops import attention

    model, _ = factories.flagship_train(tiny=True, dtype=torch.float32,
                                        device='cpu', seed=3, remat=remat)
    tc = training.TrainConfig(rel_no_fully_masked=True, dropout_vc=0.0)
    state = training.create_train_state(model, tc)
    step = training.make_train_step(model, tc)
    text, frames = _batch(model.cfg, b=2, seed=5)
    attention.backward_calls = 0
    step(state, _torch_batch(text, frames), torch.Generator().manual_seed(0))
    assert attention.backward_calls == 3 * model.cfg.clip.layers


def test_vae_frozen_and_loss_falls():
    """The VQGAN is not trained (not among the state's parameters, and
    unchanged after the steps) and the tiny model's MSM loss falls on a
    fixed batch, as JAX's test_train_step_improves_loss."""
    tc = training.TrainConfig(learning_rate=3e-3, beta_msm=1.0,
                              beta_rel=0.0, beta_vid=0.0,
                              lr_scheduler='none', dropout_vc=0.0,
                              msm_strategy_prob=(1.0, 0.0, 0.0, 0.0),
                              msm_bernoulli_prob=(0.3, 0.3))
    model = _tiny_port()
    vae = {k: v.clone() for k, v in model.vae.state_dict().items()}
    state = training.create_train_state(model, tc)
    assert not any(n.startswith('vae.') for n in state.params)
    assert len(state.params) == len(list(model.core.parameters()))
    step = training.make_train_step(model, tc)
    text, frames = _batch(model.cfg, b=2, seed=6)
    losses = []
    for i in range(12):
        state, m = step(state, _torch_batch(text, frames),
                        torch.Generator().manual_seed(100 + i))
        losses.append(float(m['loss_msm']))
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0], losses
    assert state.step == 12
    for k, v in model.vae.state_dict().items():
        assert torch.equal(v, vae[k]), k


def test_training_build_holds_fp32_parameters():
    """fp32 parameters computing in bf16 (weights cast at use), as flax's
    Dense(dtype=bf16) with its fp32 param_dtype; the serving build holds
    its dense weights in the compute dtype."""
    model, _ = factories.flagship_train(tiny=True, dtype=torch.bfloat16,
                                        device='cpu', seed=0)
    serve, _ = factories.flagship(tiny=True, dtype=torch.bfloat16,
                                  device='cpu', seed=0)
    assert model.cfg.clip.remat
    assert all(p.dtype == torch.float32 for p in model.core.parameters())
    block = 'transformer.transformer.resblocks.0.attn.in_proj_weight'
    assert serve.state_dict()[block].dtype == torch.bfloat16
    assert torch.equal(model.state_dict()[block].bfloat16(),
                       serve.state_dict()[block])
    text, frames = _batch(model.cfg, b=2, seed=2)
    b = _torch_batch(text, frames)
    tgt = model.get_image_tokens(b['target'])
    with torch.no_grad():
        got = model.core(b['text'], None, tgt)
        want = serve.core(b['text'], None, tgt)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)


def _train_and_serve(path):
    """(training build with bf16-exact nonzero biases, the serving build
    loaded from its state_dict), both computing in bf16 on the CPU."""
    if path == 'mask_predict':
        train, _ = factories.flagship_train(tiny=True, dtype=torch.bfloat16,
                                            device='cpu', seed=5)
        serve, _ = factories.flagship(tiny=True, dtype=torch.bfloat16,
                                      device='cpu', seed=6)
    else:
        train, _ = factories.artv_train(tiny=True, dtype=torch.bfloat16,
                                        device='cpu', seed=5)
        serve, _ = factories.artv_tiny(dtype=torch.bfloat16, device='cpu',
                                       seed=6)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in train.core.named_parameters():
            if name.endswith('bias'):
                # a serving build holds its biases in bf16: keep them
                # exact there, so only the weights' rounding is tested
                p.copy_((torch.randn(p.shape, generator=g) * 0.1)
                        .bfloat16().float())
    weights.load_weights(serve, train.state_dict())
    assert all(p.dtype == torch.float32 for p in train.core.parameters())
    return train.eval(), serve.eval()


@pytest.mark.parametrize('path,env', [
    ('mask_predict', {}),
    ('artv', {'MMVID_ARTV_FUSED': '0'}),
    ('artv', {'MMVID_ARTV_FUSED': '1'}),
    ('artv', {'MMVID_ARTV_SPEC': '4'}),
])
def test_training_build_samples_as_its_serving_build(monkeypatch, path,
                                                     env, one_thread):
    """C5: sampling from a training build (fp32 parameters computing in
    bf16) rounds the head and decode weights to the compute dtype, as
    JAX's sampler and ``cast_block`` do, so it draws the tokens of the
    serving build loaded from its weights, from the same generator:
    mask-predict's head, ART-V's per-layer step and its stacked step
    (``stack_decode_params``), and the speculative decode."""
    for k in ('MMVID_ARTV_FUSED', 'MMVID_ARTV_SPEC'):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    train, serve = _train_and_serve(path)
    cfg = train.cfg
    # 16 lanes: the rounding moves a mask-predict token in about one
    # draw of a hundred at this size
    text = torch.randint(1, cfg.num_text_tokens - 1, (16, cfg.text_seq_len),
                         generator=torch.Generator().manual_seed(1))
    kw = (dict(mask_predict_steps=8, dynamic=False)
          if path == 'mask_predict' else {})
    with torch.no_grad():
        _, got = train.generate_images(torch.Generator().manual_seed(2),
                                       text, decode=False, **kw)
        _, want = serve.generate_images(torch.Generator().manual_seed(2),
                                        text, decode=False, **kw)
    assert torch.equal(got, want)
