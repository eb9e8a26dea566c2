"""JAX (flax) params -> reference ``dalle.pt`` state_dict names, numpy
only; and OpenAI's CLIP torch.jit archive (``ViT-B-32.pt``) read.

The port's own copy of the converters it needs from
``mmvid_tpu/utils/torch_compat.py`` (``_flatten``, ``bert_params_to_torch``,
``vqgan_params_to_torch``, ``load_torchjit_state_dict``,
``clip_stack_dims``), so that carrying JAX params over imports nothing of
the JAX package.  The params are nested dicts of arrays; nothing here
imports jax or flax.  The port's resblocks carry the archive's names, so
the archive's stacks need no conversion (:func:`clip_resblocks`), where
JAX's ``convert_clip_resblocks`` splits ``in_proj`` into q/k/v.

Layout conversions (flax -> torch):
* Conv kernel HWIO (kh, kw, I, O) -> OIHW (O, I, kh, kw)
* Dense kernel (I, O)             -> Linear weight (O, I)
* Norm scale/bias                 -> weight/bias unchanged
* q/k/v projections               -> one packed ``in_proj_weight`` [3D, D]
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np

_SEQ_HEADS = {  # torch Sequential(LayerNorm, Linear) head names
    'to_logits': ('to_logits_ln', 'to_logits_fc'),
    'to_logits_rel': ('to_logits_rel_ln', 'to_logits_rel_fc'),
    'to_logits_vid': ('to_logits_vid_ln', 'to_logits_vid_fc'),
}

_TFM_BOTTLENECK = {  # Sequential(LN, Linear, LN, Linear, LN)
    '0': 'tfm_ln0', '1': 'tfm_fc0', '2': 'tfm_ln1', '3': 'tfm_fc1',
    '4': 'tfm_ln2',
}

_VQ_INV_SUBS = [
    (re.compile(r'\bdown_(\d+)_block_(\d+)\b'), r'down.\1.block.\2'),
    (re.compile(r'\bdown_(\d+)_attn_(\d+)\b'), r'down.\1.attn.\2'),
    (re.compile(r'\bdown_(\d+)_downsample\b'), r'down.\1.downsample'),
    (re.compile(r'\bup_(\d+)_block_(\d+)\b'), r'up.\1.block.\2'),
    (re.compile(r'\bup_(\d+)_attn_(\d+)\b'), r'up.\1.attn.\2'),
    (re.compile(r'\bup_(\d+)_upsample\b'), r'up.\1.upsample'),
    (re.compile(r'\bmid_block_1\b'), 'mid.block_1'),
    (re.compile(r'\bmid_attn_1\b'), 'mid.attn_1'),
    (re.compile(r'\bmid_block_2\b'), 'mid.block_2'),
]


def load_torchjit_state_dict(path: str) -> Dict[str, Any]:
    """A torch.jit archive's (e.g. ViT-B-32.pt's) state_dict: fp32 CPU
    tensors under the archive's names."""
    import torch
    model = torch.jit.load(path, map_location='cpu')
    return {k: v.detach().float() for k, v in model.state_dict().items()}


def clip_stack_dims(sd: Dict[str, Any], prefix: str):
    """(width, n_layers, n_heads) of a CLIP resblock stack under
    ``prefix`` (``visual.transformer`` or ``transformer``)."""
    head = f'{prefix}.' if prefix else ''
    layers = {int(m.group(1)) for m in
              (re.match(re.escape(head) + r'resblocks\.(\d+)\.', k)
               for k in sd) if m}
    width = sd[f'{head}resblocks.0.ln_1.weight'].shape[0]
    return width, len(layers), width // 64


def clip_resblocks(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    """The ``{prefix}.resblocks.*`` entries of a CLIP state_dict, as a
    :class:`~mmvid_tpu_torch.models.clip.TransformerStack` state_dict
    (``resblocks.{i}.attn.in_proj_weight`` ...)."""
    head = f'{prefix}.' if prefix else ''
    return {k[len(head):]: v for k, v in sd.items()
            if k.startswith(head + 'resblocks.')}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _linear(sd, name, leaf, w):
    """Dense kernel/bias -> Linear weight/bias under ``name``."""
    if leaf == 'kernel':
        sd[f'{name}.weight'] = w.T
    else:
        sd[f'{name}.bias'] = w


def _norm(sd, name, leaf, w):
    sd[f'{name}.{"weight" if leaf == "scale" else "bias"}'] = w


def bert_params_to_torch(params: Dict[str, Any],
                         vae_params: Dict[str, Any] | None = None,
                         cvae_params: Dict[str, Any] | None = None
                         ) -> Dict[str, np.ndarray]:
    """BertCore flax params (and the VQGANs' params) -> the reference BERT
    state_dict naming: ``transformer.transformer.resblocks.{i}.*``,
    ``to_logits.{0,1}.*``, ``*_emb.weight``, ``vae.model.*`` and
    ``cvae.model.*``."""
    inv_heads = {name: head for head, names in _SEQ_HEADS.items()
                 for name in names}
    inv_tfm = {v: k for k, v in _TFM_BOTTLENECK.items()}
    sd: Dict[str, np.ndarray] = {}

    for path, w in _flatten(params):
        if path[0] == 'transformer':
            continue
        if path[-1] == 'embedding':
            sd[f'{path[0]}.weight'] = w
        elif path[0] in ('target_pos_emb', 'image_pos_emb'):
            sd[f'{path[0]}.{path[1]}'] = w
        elif path[0] == 'visual_pos_emb':
            i = path[1].split('_')[-1]
            sd[f'visual_pos_emb.module_list.{i}.{path[2]}'] = w
        elif path[0] in inv_heads:
            head = inv_heads[path[0]]
            if path[0].endswith('_ln'):
                _norm(sd, f'{head}.0', path[1], w)
            else:
                _linear(sd, f'{head}.1', path[1], w)
        elif path[0] in inv_tfm:
            name = f'text_feature_mapping.{inv_tfm[path[0]]}'
            if path[0].startswith('tfm_ln'):
                _norm(sd, name, path[1], w)
            else:
                _linear(sd, name, path[1], w)
        elif path[0] == 'tfm_fc':
            _linear(sd, 'text_feature_mapping', path[1], w)

    if 'transformer' in params:
        sd.update(stack_params_to_torch(params['transformer'],
                                        'transformer.transformer.resblocks'))
    for tree, prefix in ((vae_params, 'vae.model.'),
                         (cvae_params, 'cvae.model.')):
        if tree is not None:
            sd.update(vqgan_params_to_torch(tree, prefix))
    return sd


def stack_params_to_torch(params: Dict[str, Any], base: str
                          ) -> Dict[str, np.ndarray]:
    """flax TransformerStack params (``blocks_<i>``) -> the reference
    resblock names under ``base`` (``{base}.{i}.attn.in_proj_weight`` ...):
    q/k/v packed into torch's ``in_proj``."""
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for path, w in _flatten(params):
        i = path[0].split('_')[1]              # blocks_<i>
        blk = f'{base}.{i}'
        if path[1] == 'attn':
            proj, leaf = path[2], path[3]
            if proj in ('query', 'key', 'value'):
                qkv.setdefault(f'{blk}|{leaf}', {})[proj] = w
            else:  # out
                _linear(sd, f'{blk}.attn.out_proj', leaf, w)
        elif path[1] in ('ln_1', 'ln_2'):
            _norm(sd, f'{blk}.{path[1]}', path[2], w)
        elif path[1] == 'mlp':
            tname = {'fc': 'c_fc', 'proj': 'c_proj'}[path[2]]
            _linear(sd, f'{blk}.mlp.{tname}', path[3], w)
    for key, parts in qkv.items():
        blk, leaf = key.split('|')
        q, k, v = parts['query'], parts['key'], parts['value']
        if leaf == 'kernel':
            sd[f'{blk}.attn.in_proj_weight'] = np.concatenate(
                [q.T, k.T, v.T], axis=0)
        else:
            sd[f'{blk}.attn.in_proj_bias'] = np.concatenate([q, k, v])
    return sd


def vqgan_params_to_torch(params: Dict[str, Any], prefix: str = ''
                          ) -> Dict[str, np.ndarray]:
    """flax VQModel params -> taming's VQModel state_dict naming
    (``encoder.down.{i}.block.{j}``, ``decoder.up.{i}.upsample`` ...)."""
    sd: Dict[str, np.ndarray] = {}
    for path, w in _flatten(params):
        if path == ('quantize', 'embedding'):
            sd[prefix + 'quantize.embedding.weight'] = w
            continue
        name = '.'.join(path[:-1])
        for rx, sub in _VQ_INV_SUBS:
            name = rx.sub(sub, name)
        leaf = path[-1]
        if leaf == 'kernel':
            sd[prefix + name + '.weight'] = np.transpose(w, (3, 2, 0, 1))
        elif leaf == 'scale':
            sd[prefix + name + '.weight'] = w
        else:
            sd[prefix + name + '.bias'] = w
    return sd
