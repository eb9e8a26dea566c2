"""The port's media I/O without Pillow, imageio or OpenCV, on the CPU.

* JPEG (``data/jpeg.py``): baseline at quality 10 / 50 / 95 and
  subsampling 4:4:4 / 4:2:2 / 4:2:0, progressive, restart intervals,
  grey, odd and tiny sizes, decoded byte-equal to Pillow 12's
  ``Image.open(p).convert('RGB')`` (libjpeg-turbo) with the imports of
  PIL, imageio and cv2 blocked, and ``image_size`` equal; every C++ stage
  (the scans' coefficients, the IDCT planes, upsampling and colour) equal
  to its plain version; the refusals.
* BMP (``data/bmp.py``): every bit depth and orientation of the
  committed fixtures and Pillow's own BMPs, byte-equal to Pillow.
* The committed fixtures (``tests/data/media``, made by its
  ``make_fixtures.py``): each equal to its committed Pillow decode.
* A frame folder of ``.jpg`` / ``.bmp`` frames: the port's
  ``TextVideoDataset`` gives JAX's batches (JAX reads through Pillow).
* GIF (``utils/gif.py``): Pillow reads back JAX's frame count, size,
  250 ms delay and loop 0; the decoded frames equal the port's
  palette-mapped frames; the mean error within JAX's imageio GIF's + 1.0
  (of 255); the median cut, mapping and LZW equal their plain versions.
* MP4 (``utils/mp4.py``): OpenCV's FFmpeg reads the frame count, size and
  fps as written; frames constant over 2 x 2 blocks come back within
  3/255 per channel, ``chip_smoke._smooth_frames`` within 2/255 mean.
* The pages (``utils/html.py``): the port's and JAX's ``index.html`` and
  ``images/`` names equal for the same rows.
* ``generate.main``: the writes of batch i come after the dispatch of
  batch i + 1, as in the root ``generate.py``, with and without
  ``--dynamic``; the files byte-equal to ``save_gif`` / ``save_mp4``
  called on ``generate_videos``' batches in order.

The module runs in one thread (as tests/test_torch_drivers.py does).
"""

import builtins
import contextlib
import glob
import io
import os
import random
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from mmvid_tpu.data import datasets as jds
from mmvid_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mmvid_tpu.utils import html as jhtml
from mmvid_tpu_torch import factories, generate
from mmvid_tpu_torch.data import jpeg, png
from mmvid_tpu_torch.data import datasets as pds
from mmvid_tpu_torch.tokenizer import SimpleTokenizer
from mmvid_tpu_torch.utils import gif, mp4
from mmvid_tpu_torch.utils import html as phtml

MEDIA = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'data',
                     'media')
FIXTURES = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(MEDIA, '*.jpg'))
                  + glob.glob(os.path.join(MEDIA, '*.bmp')))
# the GIF's mean absolute error may exceed JAX's imageio GIF's by this
GIF_MAE_SLACK = 1.0
# MP4 read back by OpenCV: 2 x 2-constant frames per channel, and the
# smooth frames' mean (of 255)
MP4_BLOCK_TOL = 3
MP4_SMOOTH_MEAN_TOL = 2.0


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def media_imports_blocked():
    """Any import of PIL, imageio or cv2 raises ImportError."""
    real = builtins.__import__

    def patched(name, *a, **kw):
        if name.split('.')[0] in ('PIL', 'imageio', 'cv2'):
            raise ImportError(f'no module named {name!r}')
        return real(name, *a, **kw)

    builtins.__import__ = patched
    try:
        yield
    finally:
        builtins.__import__ = real


def smooth(rng, h, w):
    y, x = np.mgrid[:h, :w]
    base = rng.randint(0, 256, 3)
    img = (x[..., None] * (1 + base % 3) + y[..., None] * 2 + base
           + rng.randint(0, 32, (h, w, 3)))
    return (img % 256).astype(np.uint8)


def pillow_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert('RGB'))


def jpeg_bytes(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, 'JPEG', **kw)
    return b.getvalue()


# -- JPEG --------------------------------------------------------------------

JPEG_CASES = {
    **{f'q{q}_s{s}': ((37, 53), dict(quality=q, subsampling=s))
       for q in (10, 50, 95) for s in (0, 1, 2)},
    'progressive_s2': ((37, 53), dict(quality=75, subsampling=2,
                                      progressive=True)),
    'progressive_s1': ((53, 37), dict(quality=90, subsampling=1,
                                      progressive=True)),
    'progressive_s0': ((48, 64), dict(quality=30, subsampling=0,
                                      progressive=True)),
    'restart_s2': ((37, 53), dict(quality=80, subsampling=2,
                                  restart_marker_blocks=3)),
    'restart_progressive': ((48, 64), dict(quality=70, subsampling=1,
                                           progressive=True,
                                           restart_marker_blocks=1)),
    'grey': ((37, 53), dict(quality=75, grey=True)),
    'grey_progressive': ((48, 64), dict(quality=60, grey=True,
                                        progressive=True)),
    'tiny_1x1': ((1, 1), dict(quality=75, subsampling=2)),
    'narrow_9x3': ((9, 3), dict(quality=75, subsampling=2)),
    'narrow_3x9_422': ((3, 9), dict(quality=75, subsampling=1)),
    'full_128': ((128, 128), dict(quality=95, subsampling=2)),
}


def _jpeg_case(name: str) -> bytes:
    (h, w), kw = JPEG_CASES[name]
    kw = dict(kw)
    img = smooth(np.random.RandomState(sorted(JPEG_CASES).index(name)), h, w)
    if kw.pop('grey', False):
        img = img[..., 1]
    return jpeg_bytes(img, **kw)


@pytest.mark.parametrize('case', sorted(JPEG_CASES))
def test_jpeg_equals_pillow(case, tmp_path):
    data = _jpeg_case(case)
    path = tmp_path / 'f.jpg'
    path.write_bytes(data)
    want = pillow_rgb(data)
    with media_imports_blocked():
        got = png.read_rgb(path)
        size = png.image_size(path)
    np.testing.assert_array_equal(got, want)
    assert size == (want.shape[1], want.shape[0])


def _frame_stages(data: bytes, native: bool):
    frame = jpeg.coefficients(data, native=native)
    planes, prm = jpeg.idct_planes(frame, native=native)
    return frame, planes, prm


@pytest.mark.parametrize('case', ['progressive_s2', 'restart_progressive',
                                  'q95_s1', 'grey_progressive',
                                  'opencv_q85_440_odd.jpg',
                                  'adobe_rgb_q90.jpg'])
def test_jpeg_stages_equal_plain(case):
    """The core's coefficients, IDCT planes and RGB, each from the same
    input as the plain version's."""
    if case.endswith('.jpg'):
        with open(os.path.join(MEDIA, case), 'rb') as f:
            data = f.read()
    else:
        data = _jpeg_case(case)
    frame, planes, prm = _frame_stages(data, True)
    plain_frame = jpeg.coefficients(data, native=False)
    np.testing.assert_array_equal(plain_frame.coef, frame.coef)
    plain_planes, plain_prm = jpeg.idct_planes(frame, native=False)
    np.testing.assert_array_equal(plain_planes, planes)
    np.testing.assert_array_equal(plain_prm, prm)
    np.testing.assert_array_equal(
        jpeg.color(planes, prm, frame, native=False),
        jpeg.color(planes, prm, frame))


@pytest.mark.parametrize('ratio', [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                   (2, 4)])
def test_jpeg_upsampling_equals_plain(ratio):
    """``frames_jpeg_color`` on random planes at each sampling ratio
    (fancy where libjpeg-turbo takes it, box otherwise), downsampled
    widths 2 (box) and 3 (fancy) included."""
    rng = np.random.RandomState(sum(ratio))
    hr, vr = ratio
    for W, H in ((37, 53), (2 * hr, 3 * vr), (3 * hr - 1, 5)):
        dw, dh = -(-W // hr), -(-H // vr)
        luma = rng.randint(0, 256, (-(-H // 8) * 8 * 2, -(-W // 8) * 8 * 2))
        chroma = rng.randint(0, 256, (2, -(-dh // 8) * 8, -(-dw // 8) * 8))
        planes = np.concatenate([luma.reshape(-1), chroma.reshape(-1)]
                                ).astype(np.uint8)
        prm = [3, W, H, hr, vr, 1, 0, luma.shape[1], hr, vr, W, H]
        off = luma.size
        for _ in range(2):
            prm += [off, chroma.shape[2], 1, 1, dw, dh]
            off += chroma[0].size
        prm = np.asarray(prm, np.int64)
        frame = SimpleNamespace(width=W, height=H)
        np.testing.assert_array_equal(
            jpeg.color(planes, prm, frame),
            jpeg.color(planes, prm, frame, native=False))


def test_jpeg_idct_equals_plain_on_extremes():
    """Random and saturating coefficients (the range-limit table's wrap)
    through ``frames_jpeg_idct`` and ``idct_plain``."""
    rng = np.random.RandomState(4)
    coef = rng.randint(-2048, 2048, (6, 64)).astype(np.int16)
    coef[:2, 1:] = 0
    q = rng.randint(1, 256, 64).astype(np.uint16)
    frame = SimpleNamespace(width=24, height=16, hmax=1, vmax=1,
                            transform=1, comps=[SimpleNamespace(
                                q=q, off=0, bh=2, bw=3, h=1, v=1, dw=24,
                                dh=16, id=1)], coef=coef)
    planes, _ = jpeg.idct_planes(frame)
    np.testing.assert_array_equal(jpeg.idct_plain(coef, 2, 3, q),
                                  planes.reshape(16, 24))


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` into ``marker``'s segment set to
    ``value`` (the marker itself for offset -1)."""
    i = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[i + 1 if offset < 0 else i + 4 + offset] = value
    return bytes(out)


def test_jpeg_refusals(tmp_path):
    base = _jpeg_case('q50_s2')
    cmyk = io.BytesIO()
    Image.new('CMYK', (16, 8), (1, 2, 3, 4)).save(cmyk, 'JPEG')
    refused = {
        'cmyk.jpg': (cmyk.getvalue(), 'CMYK'),
        'arith.jpg': (_patched(base, 0xC0, -1, 0xC9), 'arithmetic'),
        'lossless.jpg': (_patched(base, 0xC0, -1, 0xC3), 'lossless'),
        'twelve.jpg': (_patched(base, 0xC0, 0, 12), '12-bit'),
    }
    for name, (data, what) in refused.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError, match=rf'{name}.*{what}'):
            png.read_rgb(tmp_path / name)
    for cut in (len(base) - 2, len(base) // 2, 200):
        (tmp_path / 'cut.jpg').write_bytes(base[:cut])
        with pytest.raises(OSError, match='cut.jpg'):
            png.read_rgb(tmp_path / 'cut.jpg')
    (tmp_path / 'x.gif').write_bytes(b'GIF89a' + bytes(20))
    with pytest.raises(ValueError, match=r'x\.gif.*PNG, PPM, PGM, JPEG and '
                                         'BMP'):
        png.read_rgb(tmp_path / 'x.gif')


# -- BMP and the committed fixtures ---------------------------------------

@pytest.mark.parametrize('mode', ['1', 'L', 'P', 'RGB', 'RGBA'])
def test_bmp_equals_pillow(mode, tmp_path):
    rng = np.random.RandomState(len(mode))
    img = Image.fromarray(smooth(rng, 23, 29))
    if mode == 'P':
        img = img.quantize(37)
    else:
        img = img.convert(mode)
    img.save(tmp_path / 'f.bmp')
    data = (tmp_path / 'f.bmp').read_bytes()
    with media_imports_blocked():
        got = png.read_rgb(tmp_path / 'f.bmp')
        size = png.image_size(tmp_path / 'f.bmp')
    np.testing.assert_array_equal(got, pillow_rgb(data))
    assert size == (29, 23)


def test_bmp_refusals(tmp_path):
    data = bytearray((open(os.path.join(MEDIA, 'bits8.bmp'), 'rb').read()))
    data[30] = 1   # BI_RLE8
    (tmp_path / 'rle.bmp').write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r'rle\.bmp.*RLE'):
        png.read_rgb(tmp_path / 'rle.bmp')
    full = open(os.path.join(MEDIA, 'bits24.bmp'), 'rb').read()
    (tmp_path / 'cut.bmp').write_bytes(full[:-40])
    with pytest.raises(OSError, match=r'cut\.bmp'):
        png.read_rgb(tmp_path / 'cut.bmp')


@pytest.mark.parametrize('name', FIXTURES)
def test_fixture_equals_pillow_decode(name):
    path = os.path.join(MEDIA, name)
    with open(path, 'rb') as f:
        data = f.read()
    with media_imports_blocked():
        got = png.read_rgb(path)
        want = png.read_rgb(path + '.png')
        size = png.image_size(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, pillow_rgb(data))
    assert size == (want.shape[1], want.shape[0])


def test_fixture_set_covers_the_formats():
    """Every JPEG kind and BMP depth that chip_smoke.py reads on a host
    without Pillow is committed, under 200 KB in all."""
    kinds = {'baseline', 'progressive', 'restart', 'grey', 'adobe', 'sof1',
             'opencv'}
    assert kinds <= {n.split('_')[0] for n in FIXTURES if n.endswith('jpg')}
    assert {f'bits{b}' for b in (1, 4, 8, 16, 24, 32)} <= {
        n.split('_')[0].split('.')[0] for n in FIXTURES if n.endswith('bmp')}
    total = sum(os.path.getsize(p) for p in glob.glob(os.path.join(MEDIA,
                                                                   '*')))
    assert total < 200 * 1024


# -- a frame folder of JPEG / BMP frames against JAX's dataset -------------

@pytest.mark.parametrize('suffix', ['jpg', 'bmp'])
def test_text_video_dataset_frames_equal_jax(tmp_path, suffix):
    rng = np.random.RandomState(5)
    for i in range(3):
        key = f'id{i}#v{i}#000'
        d = tmp_path / 'video' / key
        d.mkdir(parents=True)
        for j in range(6):
            img = Image.fromarray(smooth(rng, 40, 48))
            if suffix == 'jpg':
                img.save(d / f'{j:03d}.jpg', quality=60 + 5 * j,
                         subsampling=j % 3, progressive=bool(j % 2))
            else:
                (img.quantize(50) if j % 2 else img).save(d / f'{j:03d}.bmp')
        (tmp_path / 'txt').mkdir(exist_ok=True)
        (tmp_path / 'txt' / f'{key}.txt').write_text(
            f'a person number {i} is talking.\nhe smiles.\n')
    kw = dict(text_len=12, image_size=32, truncate_captions=True,
              frame_step=2, frame_num=3, deterministic=False,
              resize_ratio=0.8)
    j = jds.TextVideoDataset(tmp_path, tokenizer=JaxTokenizer(), **kw)
    p = pds.TextVideoDataset(tmp_path, tokenizer=SimpleTokenizer(), **kw)
    assert j.keys == p.keys
    for i in range(len(j)):
        random.seed(i)
        np.random.seed(i)
        a = j[i]
        random.seed(i)
        np.random.seed(i)
        with media_imports_blocked():
            b = p[i]
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(b['text'], a['text'])
        assert b['description'] == a['description']
        np.testing.assert_array_equal(b['target'], a['target'])


# -- GIF -------------------------------------------------------------------

def _gif_frames(path_or_bytes):
    im = Image.open(path_or_bytes if isinstance(path_or_bytes, str)
                    else io.BytesIO(path_or_bytes))
    frames = []
    for i in range(im.n_frames):
        im.seek(i)
        frames.append(np.asarray(im.convert('RGB')))
    return im, np.stack(frames)


def smooth_colour_frames(rng, t=8, size=64):
    """Smooth random colour fields moving in time, in [0, 1]."""
    y, x = np.mgrid[:size, :size] / size
    out = []
    phase = rng.rand(3, 3) * 6
    for k in range(t):
        chans = [0.5 + 0.5 * np.sin(3 * x * (c + 1) + 2 * y + phase[c, 0]
                                    + 0.4 * k + phase[c, 1] * x * y)
                 for c in range(3)]
        out.append(np.stack(chans, -1))
    return np.stack(out).astype(np.float32)


def test_gif_against_jax_and_pillow(tmp_path):
    frames = smooth_colour_frames(np.random.RandomState(0))
    jhtml.save_gif(str(tmp_path / 'j.gif'), frames, fps=4)
    with media_imports_blocked():
        phtml.save_gif(str(tmp_path / 'p.gif'), frames, fps=4)
    jim, jdec = _gif_frames(str(tmp_path / 'j.gif'))
    pim, pdec = _gif_frames(str(tmp_path / 'p.gif'))
    assert pdec.shape == jdec.shape == (8, 64, 64, 3)
    for im in (jim, pim):
        im.seek(0)
    assert pim.info['duration'] == jim.info['duration'] == 250
    assert pim.info['loop'] == jim.info['loop'] == 0
    u8 = gif.to_uint8(frames)
    for f, dec in zip(u8, pdec):
        pal, idx = gif.quantize(f)
        np.testing.assert_array_equal(dec, pal[idx])
    mae = np.abs(pdec.astype(np.int64) - u8).mean()
    jmae = np.abs(jdec.astype(np.int64) - u8).mean()
    assert mae <= jmae + GIF_MAE_SLACK, (mae, jmae)


def test_gif_stages_equal_plain():
    rng = np.random.RandomState(1)
    frame = (smooth_colour_frames(rng, 1, 40)[0] * 255).astype(np.uint8)
    frame[:6] = rng.randint(0, 256, (6, 40, 3))
    few = np.zeros((6, 5, 3), np.uint8)
    few[::2] = (200, 10, 99)
    for f in (frame, few):
        pal, n = gif.palette(f)
        ppal, pn = gif.palette(f, native=False)
        assert n == pn and n == min(256, len(np.unique(
            f.reshape(-1, 3), axis=0)))
        np.testing.assert_array_equal(pal, ppal)
        np.testing.assert_array_equal(gif.map_pixels(f, pal, n),
                                      gif.map_pixels(f, pal, n,
                                                     native=False))
    # long runs and noise: the table fills and clears several times
    idx = rng.randint(0, 256, 30000).astype(np.uint8)
    idx[:9000] = rng.randint(0, 2, 9000)
    assert gif.lzw(idx) == gif.lzw(idx, native=False)
    assert gif.lzw(idx[:1]) == gif.lzw(idx[:1], native=False)
    # the whole file from the plain stages
    vid = (rng.rand(2, 9, 11, 3) * 255).astype(np.uint8)
    assert gif.encode_gif(vid) == gif.encode_gif(vid, native=False)
    _, dec = _gif_frames(gif.encode_gif(vid, fps=3))
    assert dec.shape == vid.shape


# -- MP4 -------------------------------------------------------------------

def _read_mp4(path):
    cap = cv2.VideoCapture(str(path))
    meta = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            cap.get(cv2.CAP_PROP_FPS))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1])
    cap.release()
    return meta, np.stack(frames)


@pytest.mark.parametrize('hw,fps', [((128, 128), 4), ((40, 56), 4),
                                    ((37, 53), 8), ((16, 32), 25)])
def test_mp4_read_back_by_opencv(hw, fps, tmp_path):
    h, w = hw
    rng = np.random.RandomState(h)
    blocks = rng.rand(5, -(-h // 2), -(-w // 2), 3).astype(np.float32)
    frames = blocks.repeat(2, 1).repeat(2, 2)[:, :h, :w]
    with media_imports_blocked():
        phtml.save_mp4(str(tmp_path / 'v.mp4'), frames, fps=fps)
    meta, back = _read_mp4(tmp_path / 'v.mp4')
    assert meta == (5, w, h, fps)
    err = np.abs(back.astype(np.int64) - gif.to_uint8(frames))
    assert err.max() <= MP4_BLOCK_TOL


def test_mp4_smooth_frames(tmp_path):
    from chip_smoke import _smooth_frames
    frames = np.stack(_smooth_frames(np.random.RandomState(0), 8, 128))
    (tmp_path / 'v.mp4').write_bytes(mp4.encode_mp4(frames, 4))
    meta, back = _read_mp4(tmp_path / 'v.mp4')
    assert meta == (8, 128, 128, 4)
    assert np.abs(back.astype(np.int64) - frames).mean() <= \
        MP4_SMOOTH_MEAN_TOL


def test_mp4_emulation_prevention():
    """``escape`` against the rule a byte at a time, on zero-heavy data."""
    def one_at_a_time(rbsp):
        out, zeros = bytearray(), 0
        for b in rbsp:
            if zeros >= 2 and b <= 3:
                out.append(3)
                zeros = 0
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        return bytes(out)

    rng = np.random.RandomState(3)
    for n in (0, 1, 2, 3, 10, 300):
        for _ in range(20):
            data = bytes(np.where(rng.rand(n) < 0.6, 0,
                                  rng.randint(0, 6, n)).astype(np.uint8))
            assert mp4.escape(data) == one_at_a_time(data), data
    assert mp4.escape(b'\x00\x00\x01\x00\x00\x00\x00\x00\x03') == \
        b'\x00\x00\x03\x01\x00\x00\x03\x00\x00\x03\x00\x03'


# -- the pages ---------------------------------------------------------------

def test_pages_equal_jax(tmp_path):
    """The same rows through both packages' HTML: the same images/ names
    and index.html; the port's GIF and MP4 read back."""
    rng = np.random.RandomState(2)
    video = smooth_colour_frames(rng, 4, 16)
    image = rng.rand(16, 20, 3).astype(np.float32)
    pages = {}
    for tag, mod in (('j', jhtml), ('p', phtml)):
        page = mod.HTML(str(tmp_path / tag), 'samples')
        names = [page.save_media('0000003_0.gif', video),
                 page.save_media('long_0.gif', video),
                 page.save_media('clip.mp4', video),
                 page.save_media('grid.png', image)]
        page.add_media_row([(n, f'caption {i}') for i, n in
                            enumerate(names)])
        page.add_header('iteration 3')
        page.save()
        pages[tag] = names
    assert pages['p'] == pages['j']
    assert sorted(os.listdir(tmp_path / 'p' / 'images')) == sorted(
        os.listdir(tmp_path / 'j' / 'images')) == [
        '0000003_0.gif', 'clip.mp4', 'grid.png', 'long_0.gif']
    assert (tmp_path / 'p' / 'index.html').read_text() == \
        (tmp_path / 'j' / 'index.html').read_text()
    _, dec = _gif_frames(str(tmp_path / 'p' / 'images' / 'long_0.gif'))
    assert dec.shape == (4, 16, 16, 3)
    meta, _ = _read_mp4(tmp_path / 'p' / 'images' / 'clip.mp4')
    assert meta == (4, 16, 16, 4)


# -- generate.main's write overlap -----------------------------------------

@pytest.fixture(scope='module')
def tiny_dalle(tmp_path_factory):
    """A ``dalle.pt`` of the tiny text-to-video model (2 frames at 32
    px) and five prompts: three batches of 2."""
    root = tmp_path_factory.mktemp('gen')
    hparams = {'dim': 64, 'text_seq_len': 12, 'num_targets': 2,
               'num_visuals': 0, 'image_size': 32,
               'which_transformer': 'custom:64:2:2'}
    args = SimpleNamespace(**hparams, insert_sep=False,
                           use_separate_visual_emb=False,
                           fixed_language_model=None,
                           text_emb_bottleneck=None)
    model = factories.get_dalle(
        args, factories.get_vae_model(args, device='cpu'), device='cpu')
    factories.init_weights(model, torch.Generator().manual_seed(0))
    torch.save({'iter': 1, 'hparams': hparams,
                'weights': model.state_dict()}, root / 'dalle.pt')
    prompts = ['a person is talking', 'a man smiles', 'she laughs',
               'he nods slowly', 'a woman with wavy hair is talking']
    return root, prompts


def _argv(root, prompts, out, fmt, *extra):
    return ['--dalle_path', str(root / 'dalle.pt'), '--prompts', *prompts,
            '--out_dir', str(out), '--batch_size', '2',
            '--mask_predict_steps', '2', '--format', fmt, '--device', 'cpu',
            '--no-bf16', '--seed', '7', *extra]


@pytest.mark.parametrize('fmt,dynamic', [('gif', False), ('mp4', False),
                                         ('gif', True)])
def test_generate_overlap_order_and_bytes(tiny_dalle, tmp_path,
                                          monkeypatch, fmt, dynamic):
    root, prompts = tiny_dalle
    events, recorded = [], []
    real_videos = generate.generate_videos

    def recording(*a, **kw):
        for i, batch in enumerate(real_videos(*a, **kw)):
            events.append(('dispatch', i))
            recorded.append(batch)
            yield batch

    writer = {'gif': 'save_gif', 'mp4': 'save_mp4'}[fmt]
    real_writer = getattr(generate, writer)

    def writing(path, vid, fps):
        events.append(('write', int(os.path.basename(path)[:4]) // 2))
        real_writer(path, vid, fps)

    monkeypatch.setattr(generate, 'generate_videos', recording)
    monkeypatch.setattr(generate, writer, writing)
    extra = ['--dynamic'] if dynamic else []
    with media_imports_blocked():
        generate.main(_argv(root, prompts, tmp_path / 'out', fmt, *extra))
    # the writes of batch i after the dispatch of batch i + 1 (and, on
    # the host's own order, before that of batch i + 2)
    at = {e: k for k, e in enumerate(events) if e[0] == 'dispatch'}
    for k, (kind, i) in enumerate(events):
        if kind == 'write' and i + 1 < len(recorded):
            assert k > at[('dispatch', i + 1)], events
            if not dynamic and ('dispatch', i + 2) in at:
                assert k < at[('dispatch', i + 2)], events
    assert sum(kind == 'write' for kind, _ in events) == len(prompts)
    # byte-equal to the writer called afterwards on the batches, in order,
    # and on a fresh generate_videos run with the same seed (the parent's
    # order)
    monkeypatch.undo()
    model, tok = generate.load_model(generate.parse_args(
        _argv(root, prompts, tmp_path / 'out', fmt)))
    again = list(generate.generate_videos(
        model, tok, prompts, 2, torch.Generator().manual_seed(7), 2,
        dynamic))
    encode = {'gif': gif.encode_gif, 'mp4': mp4.encode_mp4}[fmt]
    n = 0
    for batch, fresh in zip(recorded, again):
        torch.testing.assert_close(fresh.videos, batch.videos, rtol=0,
                                   atol=0)
        for p, vid in zip(batch.prompts, batch.videos.float().numpy()):
            stem = f'{n:04d}_' + '_'.join(p.split()[:6])[:48]
            got = (tmp_path / 'out' / f'{stem}.{fmt}').read_bytes()
            assert got == encode(gif.to_uint8(vid), 4), stem
            assert (tmp_path / 'out' / f'{stem}.txt').read_text() == p
            n += 1
    assert n == len(prompts)
