"""Shape attribute datasets (reference loader_ext.py:1216-1884): the port's
copy of ``mmvid_tpu/data/shapes.py``.

* The plain shapes dataset (``--dataset shape``) is TextVideoDataset over
  moving-shapes videos with captions like "A <size> <color> <shape> is
  moving <motion>" (``factories.get_dataset``).
* ShapeAttrDataset — attribute-composition controls: visual controls drawn
  from other clips sharing the object / color / shape attributes, 1-3-image
  caption templates, and counterfactual negatives for REL
  (loader_ext.py:1738-1855).  Reads an ``<name>_attr_dict.pkl`` next to
  the dataset root mapping {'object'|'color'|'shape': {attr: [keys]}}, the
  JAX package's pickle (either package reads the other's), and builds it
  with :func:`build_shape_attr_dict` when absent.

Every ``random`` draw is the JAX module's, in its order.
"""

from __future__ import annotations

import os
import pickle
import random
from pathlib import Path
from typing import Dict

import numpy as np

from mmvid_tpu_torch.data.datasets import TextVideoDataset
from mmvid_tpu_torch.data.transforms import open_rgb


def parse_shape_caption(description: str):
    """'A <size> <color> <shape> is moving <motion>' ->
    (size, color, shape, motion) (loader_ext.py:1735-1737)."""
    size, color, shape = description.split(' is moving')[0][2:].split()
    motion = description.split(' is moving ')[1]
    return size, color, shape, motion


def build_shape_attr_dict(dataset: TextVideoDataset, out_path: str):
    """Offline attr-dict builder: {'object','color','shape'} -> keys."""
    attr = {'object': {}, 'color': {}, 'shape': {}}
    for k in dataset.keys:
        desc = dataset._descriptions(k)[0]
        size, color, shape, _ = parse_shape_caption(desc)
        attr['object'].setdefault(f'{size} {color} {shape}', []).append(k)
        attr['color'].setdefault(color, []).append(k)
        attr['shape'].setdefault(shape, []).append(k)
    with open(out_path, 'wb') as f:
        pickle.dump(attr, f)
    return attr


class ShapeAttrDataset(TextVideoDataset):
    """Attribute-composition controls per ``attr_mode``: 'text', 'object',
    'object_same', 'object+same_background'(+'rand'),
    'same_object+same_background', 'color+shape+background'(+'rand');
    ``return_neg`` (the +rand modes) adds ``visual_neg`` and
    ``text_neg``."""

    def __init__(self, folder, attr_mode='object', return_neg=False, **kw):
        super().__init__(folder, **kw)
        self.attr_mode = attr_mode
        self.return_neg = return_neg
        path = Path(folder)
        attr_path = path.parent / (path.name + '_attr_dict.pkl')
        if attr_path.exists():
            with open(attr_path, 'rb') as f:
                self.attr_dict = pickle.load(f)
        else:
            self.attr_dict = build_shape_attr_dict(self, str(attr_path))
        keep = set(self.keys)
        self.attr_dict = {t: {a: [k for k in ks if k in keep]
                              for a, ks in d.items()}
                          for t, d in self.attr_dict.items()}

    def _rand_frame(self, key) -> np.ndarray:
        idx = random.randint(0, self.lengths[key] - 1)
        img = open_rgb(os.path.join(self.root, self.videos[key][idx]))
        return self.transform([img])[0]

    def _neg_visuals(self, key, color, shape, order123):
        """Counterfactual controls: a clip of another color, one of
        another shape, another clip's background."""
        color_ = random.choice(list(set(self.attr_dict['color']) - {color}))
        shape_ = random.choice(list(set(self.attr_dict['shape']) - {shape}))
        kc = random.choice(list(
            set(self.attr_dict['color'][color_])
            - set(self.attr_dict['shape'][shape]))
            or self.attr_dict['color'][color_])
        ks = random.choice(list(
            set(self.attr_dict['shape'][shape_])
            - set(self.attr_dict['color'][color]))
            or self.attr_dict['shape'][shape_])
        kb = random.choice(list(set(self.keys) - {key}))
        v1n = self._rand_frame(kc)
        v2n = self._rand_frame(ks)
        v3n = self._rand_frame(kb)
        return (np.stack([v1n, v2n, v3n]) if order123
                else np.stack([v2n, v1n, v3n]))

    def __getitem__(self, ind) -> Dict:
        frames, key, visual = self._get_video(ind)
        try:
            descriptions = self._descriptions(key)
            description = (descriptions[0] if self.deterministic
                           else random.choice(descriptions))
            size, color, shape, motion = parse_shape_caption(description)
            mode = self.attr_mode
            out_neg = None

            if mode == 'text':
                visuals = visual[None]
            elif mode == 'object':
                obj = f'{size} {color} {shape}'
                key_attr = random.choice(self.attr_dict['object'][obj])
                visuals = self._rand_frame(key_attr)[None]
                description = f'An object in image one is moving {motion}'
            elif mode == 'object_same':
                visuals = visual[None]
                description = f'An object in image one is moving {motion}'
            elif mode in ('object+same_background',
                          'object+same_background+rand'):
                obj = f'{size} {color} {shape}'
                key_attr = random.choice(self.attr_dict['object'][obj])
                v1 = self._rand_frame(key_attr)
                swap = mode.endswith('rand') and random.random() >= 0.5
                if swap:
                    visuals = np.stack([visual, v1])
                    description = ('An object in image two with background '
                                   f'in image one is moving {motion}')
                else:
                    visuals = np.stack([v1, visual])
                    description = ('An object in image one with background '
                                   f'in image two is moving {motion}')
            elif mode == 'same_object+same_background':
                v2 = self._rand_frame(key)
                visuals = np.stack([visual, v2])
                description = ('An object in image one with background in '
                               f'image two is moving {motion}')
            elif mode in ('color+shape+background',
                          'color+shape+background+rand'):
                key_color = random.choice(self.attr_dict['color'][color])
                key_shape = random.choice(self.attr_dict['shape'][shape])
                v1 = self._rand_frame(key_color)
                v2 = self._rand_frame(key_shape)
                v3 = visual
                if mode.endswith('rand'):
                    order123 = random.random() < 0.5
                    visuals = (np.stack([v1, v2, v3]) if order123
                               else np.stack([v2, v1, v3]))
                    a, b = (('color', 'shape') if order123
                            else ('shape', 'color'))
                    if random.random() < 0.5:
                        description = (
                            f'An object with {a} in image one, {b} in image '
                            f'two, background in image three is moving '
                            f'{motion}')
                        desc_neg = (
                            f'An object with {a} in image two, {b} in image '
                            f'one, background in image three is moving '
                            f'{motion}')
                    else:
                        description = (
                            f'An object with {b} in image two, {a} in image '
                            f'one, background in image three is moving '
                            f'{motion}')
                        desc_neg = (
                            f'An object with {b} in image one, {a} in image '
                            f'two, background in image three is moving '
                            f'{motion}')
                    if self.return_neg:
                        out_neg = (self._neg_visuals(key, color, shape,
                                                     order123), desc_neg)
                else:
                    visuals = np.stack([v1, v2, v3])
            else:
                raise NotImplementedError(mode)
        except IndexError:
            return self.skip_sample(ind)

        out = {'text': self._tokenize(description), 'target': frames,
               'visual': visuals, 'description': description}
        if self.return_neg and out_neg is not None:
            out['visual_neg'] = out_neg[0]
            out['text_neg'] = self._tokenize(out_neg[1])
        return out
