"""Multimodal VoxCeleb dataset with composable visual-control modes: the
port's copy of ``mmvid_tpu/data/vox.py``, frames read by ``data/png.py``.

Parity target: mmvid_pytorch/loader_ext.py:143-819 (VoxDataset).  The
dataset tree is

    <root>/video/<key>/*.png      frames
    <root>/txt/<key>.txt          PCFG captions (one per line)
    <root>/label/<key>.txt        comma-separated 40-attr binary labels
    <root>/mask/<key>/*.png       segmentation masks
    <root>/draw/style1/<key>/*.png  artistic drawings

``attr_mode`` composes visual controls + templated captions ("A person with
appearance in image one and mask in image two is talking",
loader_ext.py:607-623); per-identity sampling uses the pid ('id#id2') prefix
of the key (loader_ext.py:252-274); REL negatives are label-based
(loader_ext.py:422-429).
"""

from __future__ import annotations

import os
import pickle
import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mmvid_tpu_torch.data import pcfg
from mmvid_tpu_torch.data.datasets import TextVideoDataset, natsorted
from mmvid_tpu_torch.data.pcfg import ATTR, ATTR_VERB, NAME
from mmvid_tpu_torch.data.transforms import open_rgb


def _tmpl_two(a: str, b: str, swap_order: bool, swap_name: bool) -> str:
    """Two-control caption templates (loader_ext.py:596-623 pattern)."""
    if not swap_order:
        if not swap_name:
            return (f'A person with {a} in image one and {b} in image two '
                    f'is talking')
        return (f'A person with {b} in image two and {a} in image one '
                f'is talking')
    if not swap_name:
        return (f'A person with {b} in image one and {a} in image two '
                f'is talking')
    return (f'A person with {a} in image two and {b} in image one '
            f'is talking')


class VoxDataset(TextVideoDataset):
    def __init__(self, folder, attr_mode='mask+text', sample_label=False,
                 cat1=(), **kw):
        kw.setdefault('resize_ratio', 1.0)
        self.attr_mode = attr_mode
        self.sample_label = sample_label
        self.cat1 = list(cat1)
        self.draw_style = 'style1'
        super().__init__(folder, **kw)
        self._build_vox_attr_dict(Path(folder))

    # pid + per-attribute key index (loader_ext.py:252-274)
    def _build_vox_attr_dict(self, path: Path):
        cache = path.parent / (path.name + '_attr_dict_vox2.pkl')
        if cache.exists():
            with open(cache, 'rb') as f:
                attr_dict = pickle.load(f)
        else:
            attr_dict = {'pid': {}, 'attr': {}, 'cat1': {}}
            for k in self.keys:
                pid = '#'.join(k.split('#')[:2])
                attr_dict['pid'].setdefault(pid, []).append(k)
                y = self._get_label_str(k).split(',')
                for j, v in enumerate(y):
                    if v == '1':
                        attr_dict['cat1'].setdefault(j, []).append(k)
            try:
                with open(cache, 'wb') as f:
                    pickle.dump(attr_dict, f)
            except OSError:
                pass
        keep = set(self.keys)
        self.vox_attr_dict = {
            t: {a: [k for k in ks if k in keep] for a, ks in d.items()}
            for t, d in attr_dict.items()}

    def _get_label_str(self, key) -> str:
        label_file = Path(os.path.join(
            self.root, self.texts[key].replace('txt/', 'label/')))
        return label_file.read_text().rstrip()

    def _sample_negative_label_key(self, key) -> str:
        label = self._get_label_str(key)
        key_ = random.choice(self.keys)
        while self._get_label_str(key_) == label:
            key_ = random.choice(self.keys)
        return key_

    # -- control-image loading ------------------------------------------
    def _control_image(self, subdir: str, key: str) -> np.ndarray:
        folder = os.path.join(self.root, subdir, key)
        names = os.listdir(folder)
        name = (natsorted(names)[0] if self.deterministic
                else random.choice(names))
        return self.transform([open_rgb(os.path.join(folder, name))])[0]

    def _video_frame(self, key: str) -> np.ndarray:
        return self._control_image('video', key)

    def _mask(self, key: str) -> np.ndarray:
        return self._control_image('mask', key)

    def _draw(self, key: str) -> np.ndarray:
        return self._control_image(os.path.join('draw', self.draw_style),
                                   key)

    def _same_pid_key(self, key: str) -> str:
        pid = '#'.join(key.split('#')[:2])
        return random.choice(self.vox_attr_dict['pid'][pid])

    # -- main ------------------------------------------------------------
    def __getitem__(self, ind) -> Dict:
        # cat1/cat2 short-circuit the normal (text, target, visual) flow and
        # return an attribute-prompt batch (loader_ext.py:469-543)
        if self.attr_mode == 'cat1':
            return self.cat1_batch(ind)
        if self.attr_mode == 'cat2':
            return self.cat2_batch(ind)
        frames, key, visual = self._get_video(ind)
        if self.video_only:
            return {'text': self._tokenize('dummy text'), 'target': frames,
                    'visual': visual[None], 'description': 'dummy text'}
        try:
            descriptions = self._descriptions(key)
            description = (descriptions[0] if self.deterministic
                           else random.choice(descriptions))
            visuals, description = self._compose(ind, key, frames, visual,
                                                 description)
        except (IndexError, OSError):
            return self.skip_sample(ind)

        out = {'text': self._tokenize(description), 'target': frames,
               'visual': visuals, 'description': description}
        if self.return_neg:
            key_ = self._sample_negative_label_key(key)
            desc_ = random.choice(self._descriptions(key_))
            out['text_neg'] = self._tokenize(desc_)
        return out

    def _compose(self, ind, key, frames, visual, description):
        """attr_mode branches (loader_ext.py:469-791)."""
        mode = self.attr_mode
        r = random.random

        if mode == 'text':
            return visual[None], description

        if mode in ('mask', 'draw'):
            v1 = self._mask(key) if mode == 'mask' else self._draw(key)
            return v1[None], 'A person in image one is talking'

        if mode in ('mask+text', 'mask+text_dropout'):
            v1 = self._mask(key)
            if mode.endswith('dropout') and r() < 0.1:
                description = 'null'
            return v1[None], description

        if mode in ('draw+text', 'draw+text_dropout'):
            v1 = self._draw(key)
            if mode.endswith('dropout') and r() < 0.1:
                description = 'null'
            return v1[None], description

        if mode in ('image_same+draw', 'image_same+mask'):
            kind = 'draw' if 'draw' in mode else 'mask'
            v1 = self._draw(key) if kind == 'draw' else self._mask(key)
            swap_order = r() < 0.5
            desc = _tmpl_two('appearance', kind, swap_order, r() < 0.5)
            vis = (np.stack([v1, visual]) if swap_order
                   else np.stack([visual, v1]))
            return vis, desc

        if mode in ('image+draw', 'image+draw2', 'image+mask',
                    'image+mask2'):
            kind = 'draw' if 'draw' in mode else 'mask'
            v1 = self._draw(key) if kind == 'draw' else self._mask(key)
            key_ = self._same_pid_key(key)
            v2 = self._video_frame(key_)
            test_mode = mode.endswith('2')
            swap_order = False if test_mode else (r() >= 0.5)
            swap_name = r() < 0.5 if not test_mode else (r() >= 0.5)
            desc = _tmpl_two('appearance', kind, swap_order,
                             swap_name if not test_mode else swap_name)
            vis = (np.stack([v1, v2]) if swap_order
                   else np.stack([v2, v1]))
            return vis, desc

        if mode in ('draw+mask', 'draw+mask2'):
            v1 = self._mask(key)
            key_ = self._same_pid_key(key)
            v2 = self._draw(key_)
            test_mode = mode.endswith('2')
            swap_order = False if test_mode else (r() >= 0.5)
            desc = _tmpl_two('draw', 'mask', swap_order, r() < 0.5)
            vis = (np.stack([v1, v2]) if swap_order
                   else np.stack([v2, v1]))
            return vis, desc

        if mode == 'image+text_dropout':
            if r() < 0.5:
                key_ = self._same_pid_key(key)
                v2 = self._video_frame(key_)
            else:
                v2 = self._video_frame(key)
            if r() < 0.1:
                description = 'null'
            return v2[None], description

        if mode == 'image+video33':
            v2 = self._video_frame(key)
            visual_num, visual_step = 3, 3
            v3 = frames[:visual_num * visual_step:visual_step]
            vis = np.concatenate([v2[None], v3], axis=0)
            return vis, ('A person with appearance in image one and motion '
                         'in the following frames is talking.')

        # default: one video frame as control
        return visual[None], description

    def _clip_for_attr(self, yi: int, ind: int) -> np.ndarray:
        """The (ind mod pool)-th clip whose label has attribute column yi
        set (loader_ext.py:474-476); empty pools fall back to the full key
        list instead of the reference's ZeroDivisionError."""
        pool = self.vox_attr_dict['cat1'].get(yi) or self.keys
        k = pool[ind % len(pool)]
        frames, _, _ = self._get_video(self.keys.index(k))
        return frames

    def cat1_batch(self, ind) -> Dict:
        """attr_mode='cat1' visualization batches (loader_ext.py:469-487):
        one clip + PCFG phrase per requested attribute column."""
        clips, texts = [], []
        for yi in self.cat1:
            desc = pcfg.generate_phrase(
                (True, 1), (ATTR_VERB[ATTR[yi]], NAME[yi]))
            desc = 'A person' + desc[2:]
            clips.append(self._clip_for_attr(yi, ind))
            texts.append(self._tokenize(desc))
        return {'target': np.stack(clips), 'text': np.stack(texts)}

    def cat2_batch(self, ind) -> Dict:
        """attr_mode='cat2' (loader_ext.py:488-543): five fixed attribute
        prompts — gender (phrased from the ind-th key's own Male label),
        young, bald, eyeglasses, chubby — one clip each."""
        clips, texts = [], []
        key = self.keys[ind % len(self.keys)]
        frames, _, _ = self._get_video(self.keys.index(key))
        male = self._get_label_str(key).split(',')[ATTR.index('Male')] == '1'
        if male:
            desc = 'A boy.' if ind % 2 == 0 else 'A guy.'
        else:
            desc = 'A girl.' if ind % 2 == 0 else 'A lady.'
        clips.append(frames)
        texts.append(self._tokenize(desc))
        for attr_name, desc in (('Young', 'A person is youthful.'),
                                ('Bald', 'A person has no hair.'),
                                ('Eyeglasses', 'A person wears spectacles.'),
                                ('Chubby', 'A person is plump.')):
            clips.append(self._clip_for_attr(ATTR.index(attr_name), ind))
            texts.append(self._tokenize(desc))
        return {'target': np.stack(clips), 'text': np.stack(texts)}
