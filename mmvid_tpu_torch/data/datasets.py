"""Generic datasets (host-side, numpy, no Pillow): the port's copy of
``mmvid_tpu/data/datasets.py``.

Parity targets in mmvid_pytorch/loader.py:
* TextImageDataset (:75) — image+caption folders matched by stem.
* TextVideoDataset (:206) — frame-folder videos under <root>/video/<key>/,
  captions <root>/txt/<key>.txt, key scan + pickle cache, min-length filter,
  random/deterministic clip sampling, caption choice + sentence dropout,
  negative text sampling for REL (attr-dict by caption).
* TextImageStackDataset (:852) — all frames tiled into one PNG strip.

Frames are read by ``data/png.py`` (PNG, PPM, PGM, JPEG and BMP, all
without Pillow) and resized as Pillow resizes them; every ``random`` draw is the JAX module's, in its order.
``TextMP4Dataset`` (cv2) and the g++ loader core of ``mmvid_tpu/native``
(``MMVID_NATIVE_LOADER``) are not ported yet (ROADMAP.md).

Samples are dicts of numpy arrays (NHWC, float32 [0,1]):
{'text': [L] int32, 'target': [T,S,S,3], 'visual': [V,S,S,3]?,
 'text_neg': [L]?, 'description': str}.
Corrupt entries skip to a neighbouring index like the reference
(loader.py:168-197).
"""

from __future__ import annotations

import os
import pickle
import random
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.data.transforms import (
    VideoTransform,
    open_rgb,
    resize_exact,
)

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.pgm')


def is_image_file(name: str) -> bool:
    return name.lower().endswith(IMG_EXTENSIONS)


_NUM_RE = re.compile(r'(\d+)')


def natsorted(names: Sequence[str]) -> List[str]:
    return sorted(names, key=lambda s: [int(t) if t.isdigit() else t
                                        for t in _NUM_RE.split(s)])


def choose_description(descriptions: List[str], deterministic: bool,
                       drop_sentence: bool) -> str:
    """Caption choice + sentence dropout (loader.py:517-533)."""
    if deterministic:
        description = descriptions[0]
        if drop_sentence:
            description = description.split('. ')[0]
            if 'and' in description:
                description = description.split(', ')[0] + '.'
        return description
    description = random.choice(descriptions)
    if drop_sentence:
        parts = description.split('. ')
        num_drop = random.randint(0, len(parts) - 1)
        for _ in range(num_drop):
            parts.remove(random.choice(parts))
        description = '. '.join(parts)
    return description


class _SkipMixin:
    shuffle: bool = False

    def random_sample(self):
        return self[random.randint(0, len(self) - 1)]

    def sequential_sample(self, ind):
        return self[0] if ind >= len(self) - 1 else self[ind + 1]

    def skip_sample(self, ind):
        return self.random_sample() if self.shuffle \
            else self.sequential_sample(ind)


class TextVideoDataset(_SkipMixin):
    def __init__(self, folder, text_len=256, image_size=128,
                 truncate_captions=False, resize_ratio=1.0, tokenizer=None,
                 shuffle=False, mode='video', frame_step=2, frame_num=8,
                 deterministic=False, cache=None, video_only=False,
                 keys=None, return_neg=False, drop_sentence=False,
                 skip_min_len_check=False, return_label=False, rep_num=1):
        self.text_len = text_len
        self.image_size = image_size
        self.truncate_captions = truncate_captions
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.mode = mode
        self.frame_num = frame_num
        self.frame_step = frame_step
        self.deterministic = deterministic
        self.video_only = video_only
        self.return_neg = return_neg
        self.drop_sentence = drop_sentence
        self.return_label = return_label
        self.rep_num = rep_num

        min_len = 8
        if skip_min_len_check:
            self.min_len = max(min_len,
                               (frame_num - 1) * int(frame_step * 1.5) + 1)
        else:
            self.min_len = max(min_len, (frame_num - 1) * frame_step + 1)

        path = Path(folder)
        self.root = str(path)
        self._scan(path, cache)

        keys_keep = [k for k in self.keys if self.lengths[k] >= self.min_len]
        if keys is not None:
            keys_keep = list(set(keys_keep) & set(keys))
        self.keys = sorted(keys_keep)
        self.texts = {k: self.texts[k] for k in self.keys}
        self.videos = {k: self.videos[k] for k in self.keys}
        self.lengths = {k: self.lengths[k] for k in self.keys}

        if return_neg:
            self._build_attr_dict(path)

        self.transform = VideoTransform(image_size, resize_ratio,
                                        deterministic)

    # -- scanning + caches (loader.py:269-320) --
    def _scan(self, path: Path, cache):
        cache = (path.parent / (path.name + '_local.pkl')
                 if cache is None else Path(cache))
        if cache is not None and cache.exists():
            with open(cache, 'rb') as f:
                data = pickle.load(f)
            self.keys = data['keys']
            self.texts, self.videos, self.lengths = (
                data['texts'], data['videos'], data['lengths'])
            return
        video_root = os.path.join(self.root, 'video')
        text_root = os.path.join(self.root, 'txt')
        text_files = set(os.listdir(text_root))
        keys, texts, videos, lengths = [], {}, {}, {}
        for key in os.listdir(video_root):
            if not (os.path.isdir(os.path.join(video_root, key))
                    and key + '.txt' in text_files):
                continue
            frames = [os.path.join('video', key, f)
                      for f in natsorted(os.listdir(
                          os.path.join(video_root, key)))
                      if is_image_file(f)]
            if frames:
                keys.append(key)
                texts[key] = os.path.join('txt', key + '.txt')
                videos[key] = frames
                lengths[key] = len(frames)
        assert keys, f'no videos found under {video_root}'
        self.keys, self.texts, self.videos, self.lengths = (
            keys, texts, videos, lengths)
        try:
            with open(cache, 'wb') as f:
                pickle.dump({'root': self.root, 'keys': keys, 'texts': texts,
                             'videos': videos, 'lengths': lengths}, f)
        except OSError:
            pass

    def _build_attr_dict(self, path: Path):
        """Caption -> keys map for negative text sampling
        (loader.py:323-349)."""
        cache = path.parent / (path.name + '_attr_dict.pkl')
        if cache.exists():
            with open(cache, 'rb') as f:
                self.attr_dict = pickle.load(f)
        else:
            attr = {'text': {}}
            for k in self.keys:
                first = self._descriptions(k)[0]
                text = first.lower().replace(',', '')
                attr['text'].setdefault(text, []).append(k)
            self.attr_dict = attr
            try:
                with open(cache, 'wb') as f:
                    pickle.dump(attr, f)
            except OSError:
                pass
        self.attr_dict = {
            t: {a: list(set(ks) & set(self.keys))
                for a, ks in d.items()}
            for t, d in self.attr_dict.items()}

    # -- sample pieces --
    def _descriptions(self, key) -> List[str]:
        text = Path(os.path.join(self.root, self.texts[key])).read_text()
        return [t for t in text.split('\n') if t]

    def _get_label(self, key) -> int:
        label_file = Path(os.path.join(
            self.root, self.texts[key].replace('txt/', 'label/')))
        return int(label_file.read_text().rstrip())

    def _load_frame(self, key, i):
        # The reference square-resizes each frame first (loader.py:407-409).
        path = os.path.join(self.root, self.videos[key][i])
        return resize_exact(open_rgb(path),
                            (self.image_size, self.image_size))

    def _load_clip(self, key, idxs):
        """Decode a whole clip to [T, S, S, 3] float32 [0,1]."""
        return self.transform([self._load_frame(key, i) for i in idxs])

    def _get_video(self, index, frame_step=None):
        frame_step = frame_step or self.frame_step
        key = self.keys[index]
        video_len = self.lengths[key]
        start = 0 if self.deterministic else random.randint(
            0, video_len - (self.frame_num - 1) * frame_step - 1)
        if self.rep_num == 1:
            idxs = range(start, start + self.frame_num * frame_step,
                         frame_step)
        else:
            m_step = int((video_len - (self.frame_num - 1) * frame_step)
                         / self.rep_num)
            idxs = []
            for m in range(self.rep_num):
                s = m_step * m
                idxs += list(range(s, s + self.frame_num * frame_step,
                                   frame_step))
        frames = self._load_clip(key, list(idxs))
        vis_idx = 0 if self.deterministic else random.randint(
            0, video_len - 1)
        visual = self._load_clip(key, [vis_idx])[0]
        return frames, key, visual

    def _tokenize(self, description):
        if self.tokenizer is None:
            return description
        return self.tokenizer.tokenize(
            description, self.text_len,
            truncate_text=self.truncate_captions)[0]

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, ind) -> Dict:
        frames, key, visual = self._get_video(ind)
        if self.video_only:
            out = {'text': self._tokenize('dummy text'), 'target': frames,
                   'visual': visual[None], 'description': 'dummy text'}
            if self.return_label:
                out['label'] = self._get_label(key)
            return out
        try:
            descriptions = self._descriptions(key)
            description = choose_description(descriptions,
                                             self.deterministic,
                                             self.drop_sentence)
        except IndexError:
            return self.skip_sample(ind)
        out = {'text': self._tokenize(description), 'target': frames,
               'visual': visual[None], 'description': description}
        if self.return_neg:
            text = descriptions[0].lower().replace(',', '')
            others = list(set(self.attr_dict['text'].keys()) - {text})
            key_ = random.choice(self.attr_dict['text'][random.choice(
                others)])
            desc_ = random.choice(self._descriptions(key_))
            out['text_neg'] = self._tokenize(desc_)
        return out


class TextImageDataset(_SkipMixin):
    """Image+caption folders matched by stem (loader.py:75-203)."""

    def __init__(self, folder, text_len=256, image_size=128,
                 truncate_captions=False, resize_ratio=1.0, tokenizer=None,
                 shuffle=False, cache=None, image_only=False,
                 deterministic=False):
        self.text_len = text_len
        self.truncate_captions = truncate_captions
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.image_only = image_only
        self.deterministic = deterministic
        path = Path(folder)
        cache = (path.parent / (path.name + '_local.db')
                 if cache is None else Path(cache))
        if cache is not None and cache.exists():
            with open(cache, 'rb') as f:
                self.keys, self.text_files, self.image_files = \
                    pickle.load(f)
        else:
            text_files = {p.stem: p for p in path.glob('**/*.txt')}
            image_files = {p.stem: p for ext in
                           ('png', 'jpg', 'jpeg', 'bmp')
                           for p in path.glob(f'**/*.{ext}')}
            keys = sorted(image_files.keys() & text_files.keys())
            self.keys = keys
            self.text_files = {k: text_files[k] for k in keys}
            self.image_files = {k: image_files[k] for k in keys}
            try:
                with open(cache, 'wb') as f:
                    pickle.dump((self.keys, self.text_files,
                                 self.image_files), f)
            except OSError:
                pass
        self.transform = VideoTransform(image_size, resize_ratio,
                                        deterministic)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, ind) -> Dict:
        key = self.keys[ind]
        try:
            img = open_rgb(self.image_files[key])
        except OSError:
            return self.skip_sample(ind)
        image = self.transform([img])[0]
        if self.image_only:
            return {'text': self._tokenize('dummy text'), 'target': image,
                    'description': 'dummy text'}
        descriptions = [t for t in
                        self.text_files[key].read_text().split('\n') if t]
        if not descriptions:
            return self.skip_sample(ind)
        description = (descriptions[0] if self.deterministic
                       else random.choice(descriptions))
        return {'text': self._tokenize(description), 'target': image,
                'description': description}

    def _tokenize(self, description):
        if self.tokenizer is None:
            return description
        return self.tokenizer.tokenize(
            description, self.text_len,
            truncate_text=self.truncate_captions)[0]


def read_frames_imagestack(path, frame_idxs=None) -> np.ndarray:
    """Frames tiled in one image strip -> [T,H,W,3] (loader.py:60-72)."""
    imgs = np.asarray(open_rgb(path))
    h, w = imgs.shape[:2]
    horizontal = w > h
    vlen = (w // h) if horizontal else (h // w)
    frames = np.stack(np.split(imgs, vlen, axis=1 if horizontal else 0))
    if frame_idxs is not None:
        frames = frames[list(frame_idxs)]
    return frames.astype(np.float32) / 255.0


class TextImageStackDataset(_SkipMixin):
    """Videos stored as one tiled PNG per clip (loader.py:852-1110)."""

    def __init__(self, folder, text_len=256, image_size=128,
                 truncate_captions=False, resize_ratio=1.0, tokenizer=None,
                 shuffle=False, frame_step=1, frame_num=8,
                 deterministic=False, video_only=False, keys=None,
                 drop_sentence=False, cache=None):
        self.text_len = text_len
        self.image_size = image_size
        self.truncate_captions = truncate_captions
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.frame_num = frame_num
        self.frame_step = frame_step
        self.deterministic = deterministic
        self.video_only = video_only
        self.drop_sentence = drop_sentence

        path = Path(folder)
        self.root = str(path)
        # key-scan pickle cache, same contract as the reference's
        # TextImageStackDataset(cache=...) (loader.py:867,909-956)
        cache_path = Path(cache) if cache else None
        if cache_path is not None and cache_path.exists():
            import pickle
            with open(cache_path, 'rb') as f:
                data = pickle.load(f)
            self.keys = data['keys']
            self.texts, self.videos = data['texts'], data['videos']
            self.lengths = data.get('lengths', {})
        else:
            video_root = os.path.join(self.root, 'video')
            text_root = os.path.join(self.root, 'txt')
            text_files = (set(os.listdir(text_root))
                          if os.path.isdir(text_root) else set())
            self.keys, self.texts, self.videos = [], {}, {}
            self.lengths = {}
            for name in natsorted(os.listdir(video_root)):
                stem = Path(name).stem
                if is_image_file(name) and (video_only
                                            or stem + '.txt' in text_files):
                    # probe the stack once for its frame count (its header)
                    # and drop undecodable stacks at scan, like the
                    # reference (loader.py:931-948) — keeps the cache
                    # pickle loadable by the reference's loader too
                    try:
                        w, h = png.image_size(os.path.join(video_root,
                                                           name))
                    except OSError:
                        continue
                    self.keys.append(stem)
                    self.texts[stem] = os.path.join('txt', stem + '.txt')
                    self.videos[stem] = os.path.join('video', name)
                    self.lengths[stem] = max(w, h) // min(w, h)
            if cache_path is not None:
                import pickle
                cache_path.parent.mkdir(parents=True, exist_ok=True)
                with open(cache_path, 'wb') as f:
                    # full reference cache contract (loader.py:916-920,
                    # 953-960): root/keys/texts/videos/lengths
                    pickle.dump({'root': self.root, 'keys': self.keys,
                                 'texts': self.texts,
                                 'videos': self.videos,
                                 'lengths': self.lengths}, f)
        if keys is not None:
            self.keys = sorted(set(self.keys) & set(keys))
        self.transform = VideoTransform(image_size, resize_ratio,
                                        deterministic)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, ind) -> Dict:
        key = self.keys[ind]
        try:
            frames = read_frames_imagestack(
                os.path.join(self.root, self.videos[key]))
        except OSError:
            return self.skip_sample(ind)
        vlen = len(frames)
        step = self.frame_step
        span = (self.frame_num - 1) * step + 1
        start = 0 if (self.deterministic or vlen <= span) else \
            random.randint(0, vlen - span)
        idxs = [min(start + i * step, vlen - 1)
                for i in range(self.frame_num)]
        pil = [resize_exact((frames[i] * 255).astype(np.uint8),
                            (self.image_size, self.image_size))
               for i in idxs]
        clip = self.transform(pil)
        visual = clip[0]
        if self.video_only:
            return {'text': self._tokenize('dummy text'), 'target': clip,
                    'visual': visual[None], 'description': 'dummy text'}
        descriptions = [t for t in Path(os.path.join(
            self.root, self.texts[key])).read_text().split('\n') if t]
        if not descriptions:
            return self.skip_sample(ind)
        description = choose_description(descriptions, self.deterministic,
                                         self.drop_sentence)
        return {'text': self._tokenize(description), 'target': clip,
                'visual': visual[None], 'description': description}

    def _tokenize(self, description):
        if self.tokenizer is None:
            return description
        return self.tokenizer.tokenize(
            description, self.text_len,
            truncate_text=self.truncate_captions)[0]
