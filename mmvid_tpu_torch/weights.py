"""Weights in the reference ``dalle.pt`` format.

The port's modules carry the reference state_dict names, so a ``weights``
payload loads with ``load_state_dict`` and the port's ``state_dict()`` is
such a payload: the BERT's keys, ``vae.model.*`` (the target VQGAN, encoder
included) and, for a model with visual controls, ``cvae.model.*``.  JAX
params cross over through the port's own numpy-only converter
(``mmvid_tpu_torch.utils.torch_compat``).  Every key must match exactly.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from mmvid_tpu_torch.utils.torch_compat import (
    _flatten,
    bert_params_to_torch,
    stack_params_to_torch,
    vqgan_params_to_torch,
)


def load_weights(model: torch.nn.Module, weights: Mapping) -> None:
    """Load a reference-format ``weights`` dict (numpy arrays or tensors)
    into ``model``; raises if any key is missing or unexpected, except
    the keys the model lists in ``optional_keys`` (reference names that
    no forward reads), which may be missing."""
    sd = {k: v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
          for k, v in weights.items()}
    res = model.load_state_dict(sd, strict=False)
    missing = [k for k in res.missing_keys
               if k not in getattr(model, 'optional_keys', ())]
    if missing or res.unexpected_keys:
        raise KeyError(f'weights do not match the model: missing '
                       f'{missing}, unexpected {res.unexpected_keys}')


def load_jax_params(model: torch.nn.Module, params: Dict,
                    vae_params: Dict | None = None,
                    cvae_params: Dict | None = None) -> None:
    """Load JAX BertCore or ArtvCore params (and the vae's and cvae's
    VQModel params) into the port."""
    load_weights(model, bert_params_to_torch(params, vae_params,
                                             cvae_params))


def flax_conv_bn_to_torch(variables: Dict) -> Dict[str, np.ndarray]:
    """A flax tree of Conv + center-only BatchNorm units ({'params',
    'batch_stats'}, as ``mmvid_tpu/eval/i3d.py`` and ``eval/inception.py``
    make and ``convert_tfhub_i3d`` / ``convert_slim_inception`` read) ->
    the state_dict of the port's :class:`~mmvid_tpu_torch.eval.i3d.I3D`
    or :class:`~mmvid_tpu_torch.eval.inception.InceptionV3`, whose
    modules carry the flax names: kernels [*k, in, out] -> [out, in, *k],
    biases and the running ``mean`` / ``var`` as they are."""
    sd = {}
    for path, w in _flatten(variables['params']):
        name = '.'.join(path[:-1])
        if path[-1] == 'kernel':
            n = w.ndim
            sd[f'{name}.weight'] = np.transpose(
                w, (n - 1, n - 2) + tuple(range(n - 2)))
        else:
            sd[f'{name}.{path[-1]}'] = w
    for path, w in _flatten(variables.get('batch_stats', {})):
        sd['.'.join(path)] = w
    return sd


def load_conv_bn_variables(model: torch.nn.Module, variables: Dict) -> None:
    """Load JAX's I3D or InceptionV3 variables into the port's module
    (every key must match)."""
    load_weights(model, {k: np.asarray(v, np.float32) for k, v in
                         flax_conv_bn_to_torch(variables).items()})


def clip_full_params_to_torch(visual: Dict, text: Dict
                              ) -> Dict[str, np.ndarray]:
    """JAX's full-CLIP params (``mmvid_tpu/models/clip_full.py``:
    ClipVisual's and ClipText's) -> the port's
    :class:`~mmvid_tpu_torch.models.clip_full.CLIP` state_dict under
    OpenAI's names, ``logit_scale`` left out."""
    sd = {
        'visual.conv1.weight': np.transpose(np.asarray(
            visual['conv1']['kernel']), (3, 2, 0, 1)),
        'visual.class_embedding': visual['class_embedding'],
        'visual.positional_embedding': visual['positional_embedding'],
        'visual.proj': visual['proj'],
        'token_embedding.weight': text['token_embedding']['embedding'],
        'positional_embedding': text['positional_embedding'],
        'text_projection': text['text_projection'],
    }
    for tree, names in ((visual, ('ln_pre', 'ln_post')),
                        (text, ('ln_final',))):
        prefix = 'visual.' if tree is visual else ''
        for n in names:
            sd[f'{prefix}{n}.weight'] = tree[n]['scale']
            sd[f'{prefix}{n}.bias'] = tree[n]['bias']
    sd.update(stack_params_to_torch(visual['transformer'],
                                    'visual.transformer.resblocks'))
    sd.update(stack_params_to_torch(text['transformer'],
                                    'transformer.resblocks'))
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def roberta_params_to_torch(flax_params: Dict) -> Dict[str, np.ndarray]:
    """The params of ``transformers``' ``FlaxRobertaModel`` (JAX's fixed
    language model, ``mmvid_tpu/factories.py::get_fixed_language_model``)
    -> the state_dict of the port's
    :class:`~mmvid_tpu_torch.models.roberta.RobertaModel`, which carries
    the library's torch names: Dense kernels [in, out] transposed to
    Linear weights, ``embedding`` and LayerNorm ``scale`` as ``weight``;
    the pooler, which the port does not compute, left out."""
    leaf_names = {'kernel': 'weight', 'embedding': 'weight',
                  'scale': 'weight', 'bias': 'bias'}
    sd = {}
    for path, w in _flatten(flax_params):
        if path[0] == 'pooler':
            continue
        w = w.T if path[-1] == 'kernel' else w
        sd['.'.join(path[:-1] + (leaf_names[path[-1]],))] = np.asarray(
            w, np.float32)
    return sd


def int8_scales_from_jax(clip_scales=None, vae_scales=None):
    """JAX int8 serving scales in the port's form: (the backbone's tuple
    of per-layer (qkv_in, out_in, fc_in, proj_in), the decoder's sorted
    (path, scale) pairs), each None where JAX has none.  The port keys
    the decoder's sites by JAX's path strings, so the pairs carry over
    one for one; apply them with ``ops.int8.quantized_model`` and
    ``ops.int8.quantized_vae``."""
    backbone = (tuple(tuple(float(v) for v in layer)
                      for layer in clip_scales) if clip_scales else None)
    decoder = (tuple(sorted((str(p), float(v)) for p, v in vae_scales))
               if vae_scales else None)
    return backbone, decoder


def read_dalle_checkpoint(path: str) -> Dict:
    """Read a reference ``dalle.pt``: {iter, hparams, vae_params,
    weights}."""
    obj = torch.load(path, map_location='cpu', weights_only=False)
    return {'iter': obj.get('iter', 0), 'hparams': obj.get('hparams') or {},
            'vae_params': obj.get('vae_params'), 'weights': obj['weights']}


def _find_state(node, field: str):
    """The first namedtuple with ``field`` in an optax state tree."""
    if hasattr(node, '_fields'):
        if field in node._fields:
            return node
        children = [getattr(node, f) for f in node._fields]
    elif isinstance(node, (list, tuple)):
        children = node
    else:
        return None
    for child in children:
        found = _find_state(child, field)
        if found is not None:
            return found
    return None


def train_state_from_jax(model: torch.nn.Module, tc, params: Dict,
                         opt_state, step: int):
    """The JAX package's train state (core params, optax state with numpy
    or array leaves, step) as the port's :class:`training.TrainState`:
    the params are copied into ``model``'s core; Adam's moments have the
    params' tree, so they take the same layout conversion
    (``bert_params_to_torch``); the counts and the plateau's scalars carry
    over as they are.  The VQGAN weights are left as the model has
    them.  Where the model's backbone is split over tp
    (``parallel.tensor.split_model``), the params and moments are sliced
    to its rank's shard."""
    from mmvid_tpu_torch import training
    from mmvid_tpu_torch.parallel import tensor

    tp = tensor.stack_tp(model)
    state = training.create_train_state(model, tc)
    names = list(state.params)

    def tensors(tree):
        sd = bert_params_to_torch(tree)
        if sorted(sd) != sorted(names):
            raise KeyError(f'params do not match the trained parameters: '
                           f'{sorted(set(sd) ^ set(names))}')
        return tensor.shard_state_dict(
            {n: torch.as_tensor(np.array(sd[n])).to(dev) for n in names},
            tp.size, tp.rank)

    dev = next(iter(state.params.values())).device
    core_sd = tensors(params)
    with torch.no_grad():
        for n in names:
            state.params[n].copy_(core_sd[n])
    adam = _find_state(opt_state, 'nu')

    count = int(np.asarray(adam.count))
    opt = {'count': count, 'mu': tensors(adam.mu),
           'nu': tensors(adam.nu)}
    if 'plateau' in state.opt_state:
        plateau = _find_state(opt_state, 'plateau_count')
        opt['plateau'] = {
            k: torch.as_tensor(np.array(getattr(plateau, k))).to(
                device=dev, dtype=state.opt_state['plateau'][k].dtype)
            for k in training.PLATEAU_FIELDS}
    return training.TrainState(step=int(step), params=state.params,
                               opt_state=opt)


def gumbel_params_to_torch(params: Dict) -> Dict[str, np.ndarray]:
    """JAX's ``GumbelQuantize`` params (``proj`` conv, ``embedding``) ->
    the port's :class:`~mmvid_tpu_torch.models.vqgan.GumbelQuantize`
    state_dict (``proj.weight`` / ``bias``, ``embed.weight``)."""
    sd = flax_conv_bn_to_torch({'params': {'proj': params['proj']}})
    sd['embed.weight'] = np.asarray(params['embedding'])
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def lpips_vgg_from_jax(vgg_params: Dict) -> Dict[str, np.ndarray]:
    """JAX's LPIPS ``VGG16Features`` params (``conv_<i>``) -> the state_dict
    of the port's :class:`~mmvid_tpu_torch.models.lpips.VGG16Features`."""
    return {k: np.asarray(v, np.float32) for k, v in
            flax_conv_bn_to_torch({'params': vgg_params}).items()}


def _load_adam(opt: torch.optim.Adam, module: torch.nn.Module, adam,
               convert) -> None:
    """optax's ``ScaleByAdamState`` (count, mu, nu over the params' tree)
    as ``opt``'s state for ``module``'s parameters, ``convert`` naming the
    moments' leaves as ``module``'s state_dict does."""
    mu, nu = convert(adam.mu), convert(adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in module.named_parameters():
        opt.state[p] = {
            'step': torch.tensor(count),
            'exp_avg': torch.as_tensor(np.array(mu[name])).to(p),
            'exp_avg_sq': torch.as_tensor(np.array(nu[name])).to(p)}


def vqgan_train_state_from_jax(trainer, state) -> None:
    """JAX's ``VQGanTrainState`` (numpy or array leaves) into a
    :class:`~mmvid_tpu_torch.models.vqgan_losses.VQGanTrainer`: the
    VQModel's params through ``vqgan_params_to_torch``, the
    discriminator's params and batch stats through
    :func:`flax_conv_bn_to_torch` (HWIO kernels to OIHW; the BatchNorm's
    flax names as they are), both Adams' counts and moments, and the
    step count.  Every key must match."""
    load_weights(trainer.model, vqgan_params_to_torch(state.g_params))
    load_weights(trainer.disc, {
        k: np.asarray(v, np.float32) for k, v in flax_conv_bn_to_torch(
            {'params': state.d_params,
             'batch_stats': state.d_state}).items()})
    _load_adam(trainer.g_opt, trainer.model, _find_state(state.g_opt, 'nu'),
               vqgan_params_to_torch)
    _load_adam(trainer.d_opt, trainer.disc, _find_state(state.d_opt, 'nu'),
               lambda tree: flax_conv_bn_to_torch({'params': tree}))
    trainer.step = int(np.asarray(state.step))
