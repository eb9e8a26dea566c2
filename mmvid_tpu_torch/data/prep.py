"""Offline dataset preparation (reference mm_vox_celeb/make_text.py and
make_label.py), the port's copy of ``mmvid_tpu/data/prep.py``: turn
per-video attribute annotations (``<key>,<Attr1>,<Attr2>,...`` lines) into
per-video PCFG caption files and binary 40-attribute label files.

Usage:
    python -m mmvid_tpu_torch.data.prep --annotations face-attributes.txt \\
        --text_dir data/mmvoxceleb/txt --label_dir data/mmvoxceleb/label
"""

from __future__ import annotations

import argparse
import os
from typing import Iterable

import numpy as np

from mmvid_tpu_torch.data.pcfg import ATTR, generate

_CLASS2INDEX = {a.lower(): i for i, a in enumerate(ATTR)}


def parse_annotation_line(line: str):
    """'key,Attr One,Attr_Two,...' -> (key, bool[40])."""
    parts = line.rstrip().split(',')
    key = parts[0]
    pred = np.zeros(40, bool)
    for classname in parts[1:]:
        cls = classname.lower().replace(' ', '_')
        if cls:
            pred[_CLASS2INDEX[cls]] = True
    return key, pred


def make_text(lines: Iterable[str], text_dir: str, n: int = 20):
    """Write <text_dir>/<key>.txt with n PCFG caption variants each
    (make_text.py:56-68)."""
    os.makedirs(text_dir, exist_ok=True)
    for line in lines:
        if not line.strip():
            continue
        key, pred = parse_annotation_line(line)
        captions = generate(pred.copy(), n=n)
        with open(os.path.join(text_dir, key + '.txt'), 'w') as f:
            f.write('\n'.join(captions))


def make_label(lines: Iterable[str], label_dir: str):
    """Write <label_dir>/<key>.txt with comma-separated 0/1 labels
    (make_label.py:50-65)."""
    os.makedirs(label_dir, exist_ok=True)
    for line in lines:
        if not line.strip():
            continue
        key, pred = parse_annotation_line(line)
        with open(os.path.join(label_dir, key + '.txt'), 'w') as f:
            f.write(','.join('1' if p else '0' for p in pred))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--annotations', required=True)
    p.add_argument('--text_dir', default=None)
    p.add_argument('--label_dir', default=None)
    p.add_argument('--num_captions', type=int, default=20)
    args = p.parse_args(argv)
    with open(args.annotations) as f:
        lines = f.readlines()
    if args.text_dir:
        make_text(lines, args.text_dir, n=args.num_captions)
    if args.label_dir:
        make_label(lines, args.label_dir)


if __name__ == '__main__':
    main()
