"""RoBERTa's byte-level BPE tokenizer without ``tokenizers`` or ``regex``.

Gives the ids and attention masks of
``AutoTokenizer.from_pretrained(folder)(texts, padding=True,
truncation=True, max_length=128)``, as ``mmvid_tpu/factories.py::
get_fixed_language_model`` calls it:

* the GPT-2 pre-tokenizer pattern, case-sensitive, no prefix space,

      's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+
      |\\s+(?!\\S)|\\s+

  matched by a scanner over ``unicodedata`` (the classes of
  ``tokenizer.py``: ``\\s`` is ``regex``'s; code points assigned after
  the Unicode version of Python's ``unicodedata`` may be classed
  differently from a newer ``regex`` or the library's);
* each piece's UTF-8 bytes through GPT-2's ``bytes_to_unicode`` map, then
  the merges applied by rank, lowest rank and then leftmost first, as the
  ``tokenizers`` library merges a word;
* ``<s> ... </s>``, truncated to ``max_length`` ids with the two specials
  included, padded to the longest row with ``<pad>``.

The vocabulary and merges come from ``vocab.json`` + ``merges.txt``, or
from ``tokenizer.json``'s ``model`` section where only that file exists.
A caption that holds a special token's string (``<s>``, ``<mask>`` ...),
which the library would split out as that token, raises.
"""

from __future__ import annotations

import heapq
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mmvid_tpu_torch.tokenizer import (
    _is_letter,
    _is_number,
    _is_space,
    byte_unicode_table,
)

_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
SPECIALS = ('<s>', '<pad>', '</s>', '<unk>', '<mask>')


def _is_other(ch: str) -> bool:
    return not (_is_space(ch) or _is_letter(ch) or _is_number(ch))


def _run(text: str, j: int, cls) -> int:
    """The end of the run of ``cls`` characters from ``j``."""
    while j < len(text) and cls(text[j]):
        j += 1
    return j


def pre_tokenize(text: str) -> List[str]:
    """``regex.findall`` of the GPT-2 pattern above."""
    out, i, n = [], 0, len(text)
    while i < n:
        hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)),
                   None)
        if hit is not None:
            out.append(hit)
            i += len(hit)
            continue
        j = None
        for cls in (_is_letter, _is_number, _is_other):
            if cls(text[i]):
                j = _run(text, i + 1, cls)
            elif text[i] == ' ' and i + 1 < n and cls(text[i + 1]):
                j = _run(text, i + 2, cls)
            if j is not None:
                break
        if j is None:   # whitespace: \s+(?!\S), else \s+
            j = _run(text, i + 1, _is_space)
            if j < n and j - i > 1:
                j -= 1
        out.append(text[i:j])
        i = j
    return out


def _read_merges(folder: str) -> Tuple[Dict[str, int], List[Tuple]]:
    """(vocab, merges in rank order) from ``vocab.json`` + ``merges.txt``
    (its first line, the version header, skipped as the library's reader
    skips it), or from ``tokenizer.json``."""
    vocab_path = os.path.join(folder, 'vocab.json')
    merges_path = os.path.join(folder, 'merges.txt')
    if os.path.isfile(vocab_path) and os.path.isfile(merges_path):
        with open(vocab_path, encoding='utf-8') as f:
            vocab = json.load(f)
        with open(merges_path, encoding='utf-8') as f:
            lines = f.read().split('\n')[1:-1]
        return vocab, [tuple(line.split()) for line in lines if line]
    path = os.path.join(folder, 'tokenizer.json')
    if not os.path.isfile(path):
        raise FileNotFoundError(f'{folder}: no vocab.json + merges.txt and '
                                'no tokenizer.json')
    with open(path, encoding='utf-8') as f:
        model = json.load(f)['model']
    if model.get('type') != 'BPE':
        raise ValueError(f'{path}: model type {model.get("type")!r}, not '
                         'BPE')
    return model['vocab'], [tuple(m.split(' ')) if isinstance(m, str)
                            else tuple(m) for m in model['merges']]


class RobertaTokenizer:
    """Byte-level BPE of a RoBERTa model folder (see the module's
    docstring)."""

    def __init__(self, folder: str):
        self.vocab, merges = _read_merges(folder)
        self.rank = {}
        for r, pair in enumerate(merges):
            if len(pair) != 2 or ''.join(pair) not in self.vocab:
                raise ValueError(f'{folder}: merge {pair!r} is not a pair '
                                 'whose result is in the vocabulary')
            self.rank.setdefault(pair, r)
        self.byte_encoder = byte_unicode_table()
        self.bos, self.pad, self.eos = (self.vocab[s] for s in
                                        ('<s>', '<pad>', '</s>'))
        self._cache: Dict[str, List[int]] = {}

    def _bpe(self, word: str) -> List[int]:
        """A piece's ids: merge the lowest-ranked pair, the leftmost among
        equal ranks, until no pair has a rank."""
        if word in self._cache:
            return self._cache[word]
        syms = list(word)
        nxt = list(range(1, len(syms))) + [-1]
        prv = list(range(-1, len(syms) - 1))
        heap = []

        def push(i):
            j = nxt[i]
            if j != -1 and (syms[i], syms[j]) in self.rank:
                heapq.heappush(heap, (self.rank[syms[i], syms[j]], i,
                                      syms[i] + syms[j]))

        for i in range(len(syms) - 1):
            push(i)
        while heap:
            _, i, merged = heapq.heappop(heap)
            j = nxt[i]
            if (not syms[i] or j == -1 or (syms[i], syms[j]) not in self.rank
                    or syms[i] + syms[j] != merged):
                continue   # a stale entry
            syms[i], syms[j] = merged, ''
            nxt[i] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = i
            if prv[i] != -1:
                push(prv[i])
            push(i)
        try:
            ids = [self.vocab[s] for s in syms if s]
        except KeyError as e:
            raise ValueError(f'symbol {e.args[0]!r} of {word!r} is not in '
                             'the vocabulary') from None
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """The caption's ids, without ``<s>`` and ``</s>``."""
        hit = next((s for s in SPECIALS if s in text), None)
        if hit is not None:
            raise ValueError(f'caption {text!r} holds the special token '
                             f'{hit!r}, which the tokenizer does not split '
                             'out')
        ids = []
        for piece in pre_tokenize(text):
            ids.extend(self._bpe(''.join(
                self.byte_encoder[b] for b in piece.encode('utf-8'))))
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = 128
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), int64 [len(texts), longest];
        ``max_length`` 128 is JAX's truncation."""
        rows = [[self.bos] + self.encode(t)[:max_length - 2] + [self.eos]
                for t in texts]
        width = max(len(r) for r in rows)
        ids = np.full((len(rows), width), self.pad, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask
