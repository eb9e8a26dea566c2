"""RoBERTa's encoder in PyTorch, the fixed language model of the
text_augment recipe (``--fixed_language_model roberta-large``).

Counterpart of ``mmvid_tpu/factories.py::get_fixed_language_model``,
which runs ``transformers``' ``FlaxRobertaModel``: the same encoder under
the library's state-dict names (``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight`` ...), so a model
folder's weights load as they are (``utils/hf_archive.py``).

* Embeddings: word, plus position from the ids (positions start at
  ``pad_token_id + 1`` and pads keep ``pad_token_id``), plus token type 0,
  then LayerNorm.
* Post-LN layers: self-attention under an additive key-padding bias of
  fp32's lowest value, then the exact-erf GELU MLP.
* fp32 throughout with TF32 off, as JAX's Flax model computes.  B1 does not
  fit here: it takes one [L, L] mask for the batch, and RoBERTa masks keys
  per row, so the attention is plain torch ops.

:meth:`RobertaModel.encode` is JAX's ``encode``: captions tokenized
(``roberta_tokenizer.py``), ``last_hidden_state`` mean-pooled over the
attention mask, [B, hidden] fp32 on the model's device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mmvid_tpu_torch.ops.precision import fp32_exact
from mmvid_tpu_torch.roberta_tokenizer import RobertaTokenizer
from mmvid_tpu_torch.utils import hf_archive


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    """The fields of a ``config.json`` that the encoder reads, with the
    library's ``RobertaConfig`` defaults."""
    vocab_size: int = 50265
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 1
    hidden_act: str = 'gelu'

    @classmethod
    def from_json(cls, config: dict) -> 'RobertaConfig':
        """From a parsed ``config.json``; raises for a setting the encoder
        does not compute."""
        act = config.get('hidden_act', 'gelu')
        pos = config.get('position_embedding_type', 'absolute')
        if act != 'gelu' or pos != 'absolute' or config.get('is_decoder'):
            raise ValueError(f'config.json: hidden_act {act!r}, '
                             f'position_embedding_type {pos!r}, is_decoder '
                             f'{config.get("is_decoder")}: the encoder '
                             "computes 'gelu', 'absolute', False")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in config.items() if k in names})


ROBERTA_LARGE = RobertaConfig(
    vocab_size=50265, hidden_size=1024, num_hidden_layers=24,
    num_attention_heads=16, intermediate_size=4096,
    max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
    pad_token_id=1)


def position_ids(input_ids, pad: int):
    """Positions from ``pad + 1`` over the non-pad ids; pads keep ``pad``."""
    mask = (input_ids != pad).long()
    return torch.cumsum(mask, dim=1) * mask + pad


class _Dense(nn.Module):
    """``{name}.dense`` + ``{name}.LayerNorm``, the library's layout."""

    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=eps)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                h)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.pad = cfg.pad_token_id

    def forward(self, input_ids):
        pos = position_ids(input_ids, self.pad)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class SelfAttention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        h = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)

    def forward(self, x, bias):
        """x [B, L, H]; bias [B, 1, 1, L] additive over the keys."""
        b, n, h = x.shape
        d = h // self.heads

        def split(t):
            return t.reshape(b, n, self.heads, d).transpose(1, 2)

        q = split(self.query(x)) / d ** 0.5
        k, v = split(self.key(x)), split(self.value(x))
        p = torch.softmax(q @ k.transpose(-1, -2) + bias, dim=-1)
        return (p @ v).transpose(1, 2).reshape(b, n, h)


class Attention(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.self = SelfAttention(cfg)
        self.output = _Dense(cfg.hidden_size, cfg.hidden_size,
                             cfg.layer_norm_eps)

    def forward(self, x, bias):
        return self.output(self.self(x, bias), x)


class Intermediate(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class Layer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.attention = Attention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = _Dense(cfg.intermediate_size, cfg.hidden_size,
                             cfg.layer_norm_eps)

    def forward(self, x, bias):
        x = self.attention(x, bias)
        return self.output(self.intermediate(x), x)


class Encoder(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.layer = nn.ModuleList(Layer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x, bias):
        for layer in self.layer:
            x = layer(x, bias)
        return x


class RobertaModel(nn.Module):
    """The encoder (no pooler); ``tokenizer`` (a
    :class:`~mmvid_tpu_torch.roberta_tokenizer.RobertaTokenizer`) serves
    :meth:`encode`."""

    def __init__(self, cfg: RobertaConfig, tokenizer=None):
        super().__init__()
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)

    @classmethod
    def from_pretrained(cls, folder: str, device='cuda') -> 'RobertaModel':
        """The model folder's config, weights (every key required) and
        tokenizer, in eval mode on ``device``."""
        cfg = RobertaConfig.from_json(hf_archive.read_config(folder))
        tokenizer = RobertaTokenizer(folder)
        sd = {k: v.float() for k, v in
              hf_archive.read_state_dict(folder, prefix='roberta').items()}
        with torch.device('meta'):   # no initialisation to overwrite
            model = cls(cfg, tokenizer)
        res = model.load_state_dict(sd, strict=False, assign=True)
        if res.missing_keys or res.unexpected_keys:
            raise KeyError(f'{folder}: weights do not match the encoder: '
                           f'missing {res.missing_keys}, unexpected '
                           f'{res.unexpected_keys}')
        return model.to(device).eval()

    def forward(self, input_ids, attention_mask):
        """``last_hidden_state`` [B, L, hidden] fp32."""
        bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                           torch.finfo(torch.float32).min)
        with fp32_exact():
            return self.encoder(self.embeddings(input_ids), bias)

    @torch.no_grad()
    def encode(self, texts: Sequence[str]):
        """Mean-pooled features [len(texts), hidden] fp32 of the captions,
        on the model's device."""
        dev = self.embeddings.word_embeddings.weight.device
        ids, mask = self.tokenizer(list(texts))
        ids = torch.from_numpy(ids).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        out = self(ids, mask)
        m = mask[..., None].float()
        return (out * m).sum(1) / m.sum(1)
