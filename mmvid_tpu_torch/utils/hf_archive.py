"""Read a Hugging Face model folder without ``transformers``.

``config.json`` is read as JSON; the weights come from
``model.safetensors`` through the reader below (a little-endian u64
header length, a JSON header of ``{name: {dtype, shape, data_offsets}}``,
then the raw bytes) or from ``pytorch_model.bin`` through
``torch.load(weights_only=True)``.  The keys are normalised as the
library's loader normalises them for a base model: a leading
``<prefix>.`` stripped (the hub's ``roberta-large`` is a
``RobertaForMaskedLM`` archive), the heads (``lm_head.*``, ``pooler.*``)
and the position-id buffers dropped, and the legacy LayerNorm
``gamma`` / ``beta`` renamed ``weight`` / ``bias``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

SAFETENSORS = 'model.safetensors'
TORCH_BIN = 'pytorch_model.bin'
FLAX_MSGPACK = 'flax_model.msgpack'

# the safetensors dtypes read; the position-id buffers are I64
_DTYPES = {'F32': torch.float32, 'F16': torch.float16,
           'BF16': torch.bfloat16, 'I64': torch.int64}
_DROPPED = ('lm_head.', 'pooler.')
_BUFFERS = ('embeddings.position_ids', 'embeddings.token_type_ids')


def read_config(folder: str) -> dict:
    """The folder's ``config.json``."""
    path = os.path.join(folder, 'config.json')
    if not os.path.isfile(path):
        raise FileNotFoundError(f'{path}: no config.json in the model '
                                'folder')
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dtype = _DTYPES.get(info['dtype'])
        if dtype is None:
            raise ValueError(f'{path}: tensor {name!r} has dtype '
                             f'{info["dtype"]}; the reader takes '
                             f'{sorted(_DTYPES)}')
        start, end = info['data_offsets']
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        t = torch.frombuffer(data, dtype=dtype, count=count, offset=start)
        out[name] = t.reshape(info['shape'])
    return out


def normalize_keys(sd: Dict[str, torch.Tensor], prefix: str
                   ) -> Dict[str, torch.Tensor]:
    """A base model's state dict from an archive's: ``prefix + '.'``
    stripped, the heads and the position-id buffers dropped, LayerNorm
    ``gamma`` / ``beta`` renamed."""
    head = prefix + '.'
    out = {}
    for k, v in sd.items():
        k = k[len(head):] if k.startswith(head) else k
        if k.startswith(_DROPPED) or k in _BUFFERS:
            continue
        if k.endswith('.gamma'):
            k = k[:-len('gamma')] + 'weight'
        elif k.endswith('.beta'):
            k = k[:-len('beta')] + 'bias'
        out[k] = v
    return out


def read_state_dict(folder: str, prefix: str) -> Dict[str, torch.Tensor]:
    """The base model's weights in ``folder``: ``model.safetensors``, else
    ``pytorch_model.bin``, keys normalised (:func:`normalize_keys`)."""
    path = os.path.join(folder, SAFETENSORS)
    if os.path.isfile(path):
        return normalize_keys(read_safetensors(path), prefix)
    path = os.path.join(folder, TORCH_BIN)
    if os.path.isfile(path):
        return normalize_keys(
            torch.load(path, map_location='cpu', weights_only=True), prefix)
    found = (f'; it holds {FLAX_MSGPACK}, which the port does not read '
             '(ROADMAP.md queue A, item A9)'
             if os.path.isfile(os.path.join(folder, FLAX_MSGPACK)) else '')
    raise FileNotFoundError(f'{folder}: no {SAFETENSORS} or {TORCH_BIN}'
                            f'{found}')
