"""Byte-level BPE text tokenizer (CLIP "simple" vocabulary) without the
``regex`` package.

Gives the ids of ``mmvid_tpu.tokenizer.SimpleTokenizer``.  Its word pattern

    <|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+

is matched by a scanner over ``unicodedata.category``: letters are the
categories L*, numbers N*, and whitespace is ``str.isspace`` without the
separators U+001C..U+001F, which ``regex``'s ``\\s`` excludes.  The
pattern is compiled with IGNORECASE, under which U+0345 (a combining mark
whose case folding is a letter) matches none of the three classes, so it
is skipped like whitespace.  (Code
points assigned after the Unicode version of Python's ``unicodedata`` may
be classed differently from a newer ``regex``.)  The vocabulary is read in
place from ``mmvid_tpu/data_files/bpe_simple_vocab_16e6.txt``.
"""

from __future__ import annotations

import html
import unicodedata
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

_DEFAULT_BPE = (Path(__file__).resolve().parent.parent / 'mmvid_tpu'
                / 'data_files' / 'bpe_simple_vocab_16e6.txt')

_SPECIAL = ('<|startoftext|>', '<|endoftext|>')
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch)[0] == 'L'


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch)[0] == 'N'


def _is_space(ch: str) -> bool:
    return ch.isspace() and not '\x1c' <= ch <= '\x1f'


def _in_no_class(ch: str) -> bool:
    """Skipped by the pattern: whitespace, and U+0345 (see above)."""
    return ch == '\u0345' or _is_space(ch)


def split_words(text: str) -> List[str]:
    """``regex.findall`` of the CLIP word pattern, on lowercased text."""
    out, i, n = [], 0, len(text)
    while i < n:
        hit = next((w for w in _SPECIAL + _CONTRACTIONS
                    if text.startswith(w, i)), None)
        if hit is not None:
            out.append(hit)
            i += len(hit)
            continue
        ch = text[i]
        if _in_no_class(ch):
            i += 1
            continue
        j = i + 1
        if _is_letter(ch):
            while j < n and _is_letter(text[j]):
                j += 1
        elif not _is_number(ch):
            while j < n and not (_in_no_class(text[j])
                                 or _is_letter(text[j])
                                 or _is_number(text[j])):
                j += 1
        out.append(text[i:j])
        i = j
    return out


def byte_unicode_table():
    """Invertible byte -> printable-unicode map (standard GPT-2 table);
    insertion order sets the vocab indices."""
    keep = (list(range(ord('!'), ord('~') + 1))
            + list(range(ord('¡'), ord('¬') + 1))
            + list(range(ord('®'), ord('ÿ') + 1)))
    table = {b: chr(b) for b in keep}
    extra = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + extra)
            extra += 1
    return table


def _clean(text: str) -> str:
    text = unicodedata.normalize('NFC', text)
    text = html.unescape(html.unescape(text))
    out, in_space = [], False
    for ch in text:  # re.sub(r'\s+', ' ', text) with regex's \s
        if _is_space(ch):
            if not in_space:
                out.append(' ')
            in_space = True
        else:
            out.append(ch)
            in_space = False
    return ''.join(out).strip()


class SimpleTokenizer:
    def __init__(self, bpe_path: str | Path = _DEFAULT_BPE):
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with open(bpe_path, encoding='utf8') as f:
            lines = f.read().split('\n')
        merges = [tuple(line.split()) for line in
                  lines[1:49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab += [v + '</w>' for v in vocab]
        vocab += [''.join(m) for m in merges]
        vocab += list(_SPECIAL)
        self.vocab_size = 49408
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.rank = {m: i for i, m in enumerate(merges)}
        self._cache = {s: s for s in _SPECIAL}
        self.sot = self.encoder['<|startoftext|>']
        self.eot = self.encoder['<|endoftext|>']

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.rank.get(p, float('inf')))
            if best not in self.rank:
                break
            first, second = best
            merged = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = ' '.join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        out = []
        for tok in split_words(_clean(text).lower()):
            tok = ''.join(self.byte_encoder[b] for b in tok.encode('utf-8'))
            out.extend(self.encoder[t] for t in self._bpe(tok).split(' '))
        return out

    def decode(self, ids: Sequence[int]) -> str:
        ids = [int(i) for i in ids if int(i) not in (self.sot, self.eot, 0)]
        text = ''.join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode('utf-8', errors='replace').replace('</w>', ' ')

    def tokenize(self, texts: Union[str, Sequence[str]],
                 context_length: int = 256,
                 truncate_text: bool = False) -> np.ndarray:
        """-> int32 [N, context_length], zero-padded, no SOT/EOT."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > context_length:
                if not truncate_text:
                    raise RuntimeError(
                        f'Input {text!r} is too long for context length '
                        f'{context_length}')
                ids = ids[:context_length]
            result[i, :len(ids)] = ids
        return result
