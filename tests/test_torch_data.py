"""The port's frame reader and datasets (mmvid_tpu_torch.data) against
Pillow and the JAX package's (mmvid_tpu.data), on the CPU.

* ``data/png.py``: every filter type, colour types 0/2/3/4/6, odd sizes;
  the C++ core equal to the plain numpy version byte for byte; decoded
  pixels equal to Pillow's ``open().convert('RGB')``; the resize within
  1.1/255 of Pillow's ``resize(BILINEAR)`` with at least 70% exact (the
  bound tests/test_native.py holds the JAX native core to); PPM/PGM;
  the refusals (16-bit, interlaced: ValueError; damaged: OSError); a
  JPEG read equal to Pillow's with Pillow's import blocked (the JPEG and
  BMP readers in full: tests/test_torch_media.py).
* The datasets on one temporary tree, ``random.seed(s)`` (and
  ``np.random.seed(s)``) before each ``__getitem__`` of both packages:
  keys, texts and descriptions equal, frames within 1.1/255 (they come
  out equal: the resize is Pillow's arithmetic), negatives included;
  VoxDataset in each ``attr_mode`` of the 12 vox recipe scripts.
* ``DataLoader``: the same index order per epoch and the same shards over
  3 processes with the wrap-around; ``infinite_batches(start=k)``.
"""

import builtins
import io
import random
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from mmvid_tpu.data import datasets as jds
from mmvid_tpu.data import loader as jloader
from mmvid_tpu.data import transforms as jtf
from mmvid_tpu.data import vox as jvox
from mmvid_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mmvid_tpu_torch.data import datasets as pds
from mmvid_tpu_torch.data import loader as ploader
from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.data import transforms as ptf
from mmvid_tpu_torch.data import vox as pvox
from mmvid_tpu_torch.tokenizer import SimpleTokenizer

FRAME_TOL = 1.1 / 255
EXACT_SHARE = 0.7


def _img(rng, h, w, ctype):
    shape = {0: (h, w), 2: (h, w, 3), 3: (h, w), 4: (h, w, 2),
             6: (h, w, 4)}[ctype]
    # smooth gradients plus noise: the filters' predictions matter
    y, x = np.mgrid[:h, :w]
    base = (3 * x + 5 * y)[..., None] if len(shape) == 3 else 3 * x + 5 * y
    arr = (base + rng.randint(0, 40, shape)) % 256
    if ctype == 3:
        arr = arr % 19
    return arr.astype(np.uint8)


@pytest.mark.parametrize('ctype', [0, 2, 3, 4, 6])
@pytest.mark.parametrize('hw', [(37, 53), (53, 37)])
def test_png_read_and_resize_against_pillow(ctype, hw):
    rng = np.random.RandomState(ctype)
    h, w = hw
    img = _img(rng, h, w, ctype)
    pal = (rng.randint(0, 256, (16, 3)).astype(np.uint8) if ctype == 3
           else None)
    data = png.encode_png(img, [y % 5 for y in range(h)], palette=pal)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))
    got = png.decode_png(data, native=True)
    np.testing.assert_array_equal(got, png.decode_png(data, native=False))
    np.testing.assert_array_equal(got, ref)
    exact = total = 0
    for oh, ow in ((32, 32), (64, 48), (13, 29)):
        out = png.resize(got, oh, ow)
        np.testing.assert_array_equal(out, png.resize(got, oh, ow,
                                                      native=False))
        want = np.asarray(Image.fromarray(ref).resize((ow, oh),
                                                      Image.BILINEAR))
        diff = np.abs(out.astype(np.int64) - want) / 255
        assert diff.max() <= FRAME_TOL
        exact += int((diff == 0).sum())
        total += diff.size
    assert exact / total >= EXACT_SHARE


def test_png_writer_every_filter_read_by_pillow():
    """Each filter type alone, on an RGB image Pillow reads back equal."""
    img = _img(np.random.RandomState(5), 29, 31, 2)
    for ft in range(5):
        data = png.encode_png(img, ft)
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), img)
        np.testing.assert_array_equal(png.decode_png(data), img)


def test_pnm_read(tmp_path):
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    grey = rng.randint(0, 256, (53, 37)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / 'a.ppm')
    Image.fromarray(grey).save(tmp_path / 'b.pgm')
    for name in ('a.ppm', 'b.pgm'):
        want = np.asarray(Image.open(tmp_path / name).convert('RGB'))
        np.testing.assert_array_equal(png.read_rgb(tmp_path / name), want)
        assert png.image_size(tmp_path / name) == \
            Image.open(tmp_path / name).size


def test_png_refusals(tmp_path):
    Image.fromarray(np.arange(600, dtype=np.uint16).reshape(20, 30)
                    ).save(tmp_path / 'deep.png')
    with pytest.raises(ValueError, match='deep.png'):
        png.read_rgb(tmp_path / 'deep.png')
    data = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    data[28] = 1   # the interlace byte of IHDR
    data[29:33] = struct.pack('>I', zlib.crc32(bytes(data[12:29])))
    (tmp_path / 'inter.png').write_bytes(bytes(data))
    with pytest.raises(ValueError, match='inter.png'):
        png.read_rgb(tmp_path / 'inter.png')
    bad = bytearray(png.encode_png(np.zeros((4, 4, 3), np.uint8)))
    bad[-20] ^= 0xff   # inside IDAT: its CRC no longer holds
    (tmp_path / 'bad.png').write_bytes(bytes(bad))
    with pytest.raises(OSError):
        png.read_rgb(tmp_path / 'bad.png')


def test_jpeg_through_pillow_or_refused(tmp_path, monkeypatch):
    """A JPEG decodes equal to Pillow's with Pillow's import blocked (the
    port reads JPEG itself; it refused it without Pillow before)."""
    rgb = np.random.RandomState(2).randint(0, 256, (24, 40, 3)).astype(
        np.uint8)
    Image.fromarray(rgb).save(tmp_path / 'f.jpg')
    want = np.asarray(Image.open(tmp_path / 'f.jpg').convert('RGB'))
    real = builtins.__import__

    def no_pillow(name, *a, **kw):
        if name == 'PIL' or name.startswith('PIL.'):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, '__import__', no_pillow)
    np.testing.assert_array_equal(png.read_rgb(tmp_path / 'f.jpg'), want)
    assert png.image_size(tmp_path / 'f.jpg') == (40, 24)


def test_frame_pipeline_equals_jax(tmp_path):
    """open_rgb + resize_exact + VideoTransform of both packages on the
    same files, deterministic and random-crop (resize_ratio 0.7): PNG
    frames, then JPEG and BMP frames (JAX's through Pillow)."""
    rng = np.random.RandomState(3)
    sets = {'png': [], 'jpg': [], 'bmp': []}
    for i, ctype in enumerate((2, 6, 0)):
        img = _img(rng, 45, 61, ctype)
        p = tmp_path / f'{i}.png'
        png.write_png(p, img, [y % 5 for y in range(45)])
        sets['png'].append(p)
        rgb = Image.open(p).convert('RGB' if ctype != 0 else 'L')
        rgb.save(tmp_path / f'{i}.jpg', quality=70 + 10 * i, subsampling=i,
                 progressive=i == 1)
        (rgb.quantize(40) if i == 1 else rgb).save(tmp_path / f'{i}.bmp')
        sets['jpg'].append(tmp_path / f'{i}.jpg')
        sets['bmp'].append(tmp_path / f'{i}.bmp')
    for paths in sets.values():
        for det, ratio in ((True, 1.0), (False, 1.0), (False, 0.7)):
            random.seed(7)
            j = jtf.VideoTransform(32, ratio, det)(
                [jtf.resize_exact(jtf.open_rgb(p), (40, 36)) for p in paths])
            random.seed(7)
            g = ptf.VideoTransform(32, ratio, det)(
                [ptf.resize_exact(ptf.open_rgb(p), (40, 36))
                 for p in paths])
            assert g.dtype == j.dtype and g.shape == j.shape
            assert np.abs(g - j).max() <= FRAME_TOL


# -- datasets ----------------------------------------------------------------

@pytest.fixture(scope='module')
def tokenizers():
    return JaxTokenizer(), SimpleTokenizer()


CAPTIONS = ('A man is talking. He has a beard. He wears glasses.\n'
            'A person speaks, smiles and nods.\n',
            'A woman with wavy hair is talking. She is young.\n'
            'She smiles.\nShe talks.\n')


def _labels(i):
    lab = ['0'] * 40
    lab[i % 40] = lab[(3 * i) % 40] = lab[20] = '1' if i % 2 else '0'
    lab[i % 40] = '1'
    return ','.join(lab)


@pytest.fixture(scope='module')
def vox_tree(tmp_path_factory):
    """A vox tree (video, txt, label, mask, draw/style1) of 8 clips of 12
    frames, 2 clips per identity, frames 40x48 and controls 48x40."""
    root = tmp_path_factory.mktemp('vox') / 'mmvox'
    rng = np.random.RandomState(0)
    for i in range(8):
        key = f'id{i // 2}#v{i // 2}#{i % 2:03d}'
        for sub, n, hw in (('video', 12, (40, 48)), ('mask', 3, (48, 40)),
                           ('draw/style1', 2, (48, 40))):
            d = root / sub / key
            d.mkdir(parents=True)
            for j in range(n):
                png.write_png(d / f'{j:03d}.png',
                              _img(rng, *hw, 2 if j % 3 else 6), (i + j) % 5)
        for sub, text in (('txt', CAPTIONS[i % 2]), ('label', _labels(i))):
            (root / sub).mkdir(exist_ok=True)
            (root / sub / f'{key}.txt').write_text(text)
    return root


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], (str, list)):
            assert a[k] == b[k], k
        elif np.asarray(a[k]).dtype.kind == 'f':
            assert a[k].shape == b[k].shape, k
            assert np.abs(a[k] - b[k]).max() <= FRAME_TOL, k
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _pairs(jset, pset, seeds=(0, 1)):
    assert jset.keys == pset.keys
    for i in range(len(jset)):
        for s in seeds:
            random.seed(s)
            np.random.seed(s)
            a = jset[i]
            random.seed(s)
            np.random.seed(s)
            _same(a, pset[i])


@pytest.mark.parametrize('det', [False, True], ids=['random', 'determ'])
def test_text_video_dataset_equals_jax(vox_tree, tokenizers, det):
    kw = dict(text_len=20, image_size=32, truncate_captions=True,
              frame_step=2, frame_num=3, deterministic=det,
              return_neg=True, drop_sentence=True,
              resize_ratio=1.0 if det else 0.8)
    p = pds.TextVideoDataset(vox_tree, tokenizer=tokenizers[1], **kw)
    j = jds.TextVideoDataset(vox_tree, tokenizer=tokenizers[0], **kw)
    assert p.attr_dict == j.attr_dict
    _pairs(j, p)


VOX_MODES = ['mask+text_dropout', 'draw+mask2', 'draw+text_dropout',
             'image+mask2', 'image+text_dropout', 'image+video33']


@pytest.mark.parametrize('mode', VOX_MODES)
def test_vox_dataset_equals_jax(vox_tree, tokenizers, mode):
    kw = dict(attr_mode=mode, text_len=20, image_size=32,
              truncate_captions=True, frame_step=4, frame_num=3,
              return_neg=True)
    p = pvox.VoxDataset(vox_tree, tokenizer=tokenizers[1], **kw)
    j = jvox.VoxDataset(vox_tree, tokenizer=tokenizers[0], **kw)
    assert p.vox_attr_dict == j.vox_attr_dict
    assert [p._get_label_str(k) for k in p.keys] == \
        [j._get_label_str(k) for k in j.keys]
    _pairs(j, p, seeds=(3,))


@pytest.mark.parametrize('mode', ['cat1', 'cat2'])
def test_vox_attribute_batches_equal_jax(vox_tree, tokenizers, mode):
    kw = dict(attr_mode=mode, text_len=20, image_size=32, frame_step=4,
              frame_num=3, truncate_captions=True, cat1=(1, 20, 3),
              deterministic=True)
    p = pvox.VoxDataset(vox_tree, tokenizer=tokenizers[1], **kw)
    j = jvox.VoxDataset(vox_tree, tokenizer=tokenizers[0], **kw)
    _pairs(j, p, seeds=(4,))


def test_image_datasets_equal_jax(tmp_path, tokenizers):
    """TextImageStackDataset (frames tiled in one strip) and
    TextImageDataset (image + caption by stem)."""
    rng = np.random.RandomState(4)
    root = tmp_path / 'stack'
    (root / 'video').mkdir(parents=True)
    (root / 'txt').mkdir()
    for i in range(3):
        strip = _img(rng, 24, 24 * 9, 2)
        png.write_png(root / 'video' / f'k{i}.png', strip, i % 5)
        (root / 'txt' / f'k{i}.txt').write_text(CAPTIONS[i % 2])
    for det in (False, True):
        kw = dict(text_len=20, image_size=16, truncate_captions=True,
                  frame_step=2, frame_num=3, deterministic=det,
                  drop_sentence=True)
        _pairs(jds.TextImageStackDataset(root, tokenizer=tokenizers[0], **kw),
               pds.TextImageStackDataset(root, tokenizer=tokenizers[1], **kw))
    kw = dict(text_len=20, image_size=16, truncate_captions=True)
    _pairs(jds.TextImageDataset(root / 'video', tokenizer=tokenizers[0],
                                **kw),
           pds.TextImageDataset(root / 'video', tokenizer=tokenizers[1],
                                **kw))


# -- loader ----------------------------------------------------------------

class _Ids:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {'i': np.int64(i), 'name': f's{i}'}


@pytest.mark.parametrize('n', [10, 11])
def test_loader_order_and_shards_equal_jax(n):
    for rank in range(3):
        kw = dict(batch_size=2, num_workers=1, seed=5, process_index=rank,
                  process_count=3)
        j = jloader.DataLoader(_Ids(n), **kw)
        p = ploader.DataLoader(_Ids(n), **kw)
        assert len(p) == len(j)
        for epoch in range(3):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert p._indices() == j._indices()
            assert [b['i'].tolist() for b in p] == \
                [b['i'].tolist() for b in j]
        seq = [b['i'].tolist() for b, _ in zip(
            ploader.infinite_batches(p), range(7))]
        jseq = [b['i'].tolist() for b, _ in zip(
            jloader.infinite_batches(j), range(7))]
        assert seq == jseq
        for start in (1, 3, 5):
            got = [b['i'].tolist() for b, _ in zip(
                ploader.infinite_batches(p, start=start), range(7 - start))]
            assert got == seq[start:]


def test_loader_thread_ends_when_the_consumer_stops():
    """A run that stops reading mid-epoch (a training run's last step)
    leaves no producer thread behind, blocked on the full prefetch queue
    (chip_smoke.py's free_card_memory fails on one: ROADMAP C8)."""
    import gc
    import threading
    import time

    def producers():
        return [t for t in threading.enumerate() if 'produce' in t.name]

    before = set(producers())
    p = ploader.DataLoader(_Ids(40), batch_size=2, num_workers=1, seed=0,
                           prefetch=1)
    batches = ploader.infinite_batches(p)
    assert next(batches)['i'].shape == (2,)
    time.sleep(0.2)   # the producer fills the queue and waits on it
    assert set(producers()) - before
    del batches
    gc.collect()
    for t in set(producers()) - before:
        t.join(timeout=5)
    assert not set(producers()) - before


def test_loader_surfaces_errors():
    class Broken(_Ids):
        def __getitem__(self, i):
            if i == 3:
                raise KeyError('frame 3')
            return super().__getitem__(i)

    loader = ploader.DataLoader(Broken(8), batch_size=2, num_workers=2,
                                shuffle=False)
    with pytest.raises(KeyError, match='frame 3'):
        list(loader)
