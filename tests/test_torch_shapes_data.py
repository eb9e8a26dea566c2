"""The port's shapes and iPER datasets and its offline caption writer
(``mmvid_tpu_torch.data.shapes``, ``.iper``, ``.prep``) against the JAX
package's (``mmvid_tpu.data.shapes``, ``.iper``, ``.prep``) on the CPU.

* One moving-shapes frame folder (``chip_smoke.write_shapes_data``: 12
  clips of 10 frames, two sizes, three colors, three shapes, three
  motions): JAX's ``ShapeDataset`` against the port's
  ``TextVideoDataset`` (``--dataset shape``), and ``ShapeAttrDataset`` in
  every ``attr_mode``, with and without
  ``return_neg``, random and deterministic, ``random.seed(s)`` before each
  ``__getitem__`` of both packages: descriptions, text ids and negatives
  equal, frames within 1.1/255 (tests/test_torch_data.py's bound; they
  come out equal).  The ``<name>_attr_dict.pkl`` one package writes, the
  other reads, both ways.
* ``IPERDataset`` with ``slow`` (random speed classes, and 'normal' for a
  deterministic sample) and the caption dropout template.
* ``prep``: ``parse_annotation_line``, and the caption and label files
  ``make_text`` / ``make_label`` / ``main`` write under one
  ``random`` / ``np.random`` seed, byte for byte.
* ``factories.get_dataset`` routes ``shape``, ``shape_attr`` and
  ``iper`` as JAX's does; ``mp4_text`` is refused, naming what it lacks.
"""

import os
import pickle
import random
import shutil
from pathlib import Path

import numpy as np
import pytest

from mmvid_tpu.data import iper as jiper
from mmvid_tpu.data import prep as jprep
from mmvid_tpu.data import shapes as jshapes
from mmvid_tpu.tokenizer import SimpleTokenizer as JaxTokenizer
from mmvid_tpu_torch import factories
from mmvid_tpu_torch.config import process_args
from mmvid_tpu_torch.data import iper as piper
from mmvid_tpu_torch.data import png
from mmvid_tpu_torch.data import prep as pprep
from mmvid_tpu_torch.data import shapes as pshapes
from mmvid_tpu_torch.data.datasets import TextVideoDataset
from mmvid_tpu_torch.tokenizer import SimpleTokenizer
from chip_smoke import SHAPE_COLORS, shape_caption, write_shapes_data
from test_torch_data import _pairs

# 12 clips of 10 frames at 16 px: every color with every shape
CLIPS = 12


@pytest.fixture(scope='module')
def tokenizers():
    return JaxTokenizer(), SimpleTokenizer()


@pytest.fixture(scope='module')
def shapes_tree(tmp_path_factory):
    return Path(write_shapes_data(
        str(tmp_path_factory.mktemp('shapes') / 'shapes'), CLIPS, 10, 16))


def _attr_pickle(root):
    return root.parent / (root.name + '_attr_dict.pkl')


KW = dict(text_len=20, image_size=16, truncate_captions=True, frame_step=2,
          frame_num=3)


def test_parse_shape_caption_matches_jax():
    for i in range(CLIPS):
        desc = shape_caption(i)
        assert pshapes.parse_shape_caption(desc) == \
            jshapes.parse_shape_caption(desc)
    assert pshapes.parse_shape_caption(shape_caption(1))[3] == \
        'up and right'


@pytest.mark.parametrize('det', [False, True], ids=['random', 'determ'])
def test_shape_dataset_equals_jax(shapes_tree, tokenizers, det):
    kw = dict(KW, deterministic=det)
    p = TextVideoDataset(shapes_tree, tokenizer=tokenizers[1], **kw)
    j = jshapes.ShapeDataset(shapes_tree, tokenizer=tokenizers[0],
                             attr_mode='text', **kw)
    _pairs(j, p)


SHAPE_ATTR_MODES = [
    ('text', False), ('object', False), ('object_same', False),
    ('object+same_background', False),
    ('object+same_background+rand', False),
    ('same_object+same_background', False),
    ('color+shape+background', False),
    ('color+shape+background+rand', False),
    ('color+shape+background+rand', True)]


@pytest.mark.parametrize('mode,neg', SHAPE_ATTR_MODES)
def test_shape_attr_dataset_equals_jax(shapes_tree, tokenizers, mode, neg):
    kw = dict(KW, attr_mode=mode, return_neg=neg)
    p = pshapes.ShapeAttrDataset(shapes_tree, tokenizer=tokenizers[1], **kw)
    j = jshapes.ShapeAttrDataset(shapes_tree, tokenizer=tokenizers[0], **kw)
    assert p.attr_dict == j.attr_dict
    _pairs(j, p, seeds=(0, 1, 2))
    random.seed(5)
    item = p[0]
    n_vis = 3 if mode.startswith('color') else 2 if '+' in mode else 1
    assert item['visual'].shape == (n_vis, 16, 16, 3)
    assert ('visual_neg' in item) == neg
    if neg:
        assert item['visual_neg'].shape == (3, 16, 16, 3)
        assert item['text_neg'].shape == (20,)


def test_shape_attr_dataset_deterministic_equals_jax(shapes_tree,
                                                     tokenizers):
    kw = dict(KW, attr_mode='color+shape+background+rand', return_neg=True,
              deterministic=True)
    p = pshapes.ShapeAttrDataset(shapes_tree, tokenizer=tokenizers[1], **kw)
    j = jshapes.ShapeAttrDataset(shapes_tree, tokenizer=tokenizers[0], **kw)
    _pairs(j, p, seeds=(3,))


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_attr_dict_pickle_crosses_both_ways(shapes_tree, tmp_path, writer):
    """The pickle beside the root: written by one package when absent,
    read by the other as its own."""
    root = tmp_path / 'shapes'
    shutil.copytree(shapes_tree, root)
    first, second = ((jshapes, pshapes) if writer == 'jax'
                     else (pshapes, jshapes))
    built = first.ShapeAttrDataset(root, **KW).attr_dict
    assert _attr_pickle(root).exists()
    with open(_attr_pickle(root), 'rb') as f:
        written = pickle.load(f)
    assert set(written) == {'object', 'color', 'shape'}
    read = second.ShapeAttrDataset(root, **KW).attr_dict
    assert read == built
    assert read['color'] == {c: sorted(k for k in written['color'][c])
                             for c in SHAPE_COLORS}
    # the offline builders write the same dict
    paths = [str(tmp_path / f'{m.__name__}.pkl') for m in (jshapes,
                                                           pshapes)]
    dicts = [m.build_shape_attr_dict(cls(root, **KW), path)
             for m, cls, path in zip((jshapes, pshapes),
                                     (jshapes.ShapeDataset, TextVideoDataset),
                                     paths)]
    assert dicts[0] == dicts[1]
    with open(paths[0], 'rb') as f, open(paths[1], 'rb') as g:
        assert pickle.load(f) == pickle.load(g)


IPER_CAPTIONS = ("person 012 dressed in red is performing 'A' pose.",
                 'person 044 dressed in blue is performing random pose.')


@pytest.fixture(scope='module')
def iper_tree(tmp_path_factory):
    """6 clips of 20 frames with iPER captions."""
    root = tmp_path_factory.mktemp('iper') / 'iper'
    rng = np.random.RandomState(1)
    for i in range(6):
        key = f'{i:03d}_1_{i % 2 + 1}'
        d = root / 'video' / key
        d.mkdir(parents=True)
        for j in range(20):
            png.write_png(d / f'{j:04d}.png',
                          rng.randint(0, 255, (20, 24, 3)).astype(np.uint8),
                          j % 5)
        (root / 'txt').mkdir(exist_ok=True)
        (root / 'txt' / f'{key}.txt').write_text(
            IPER_CAPTIONS[i % 2] + '\n' + IPER_CAPTIONS[1 - i % 2] + '\n')
    return root


@pytest.mark.parametrize('slow,det,drop', [
    (False, False, False), (False, False, True), (True, False, True),
    (True, True, False), (True, True, True)])
def test_iper_dataset_equals_jax(iper_tree, tokenizers, slow, det, drop):
    kw = dict(text_len=24, image_size=16, truncate_captions=True,
              frame_step=4, frame_num=4, slow=slow, deterministic=det,
              drop_sentence=drop)
    p = piper.IPERDataset(iper_tree, tokenizer=tokenizers[1], **kw)
    j = jiper.IPERDataset(iper_tree, tokenizer=tokenizers[0], **kw)
    assert p.min_len == j.min_len == (19 if slow else 13)
    _pairs(j, p, seeds=(0, 1, 2, 3))
    if slow:
        random.seed(0)
        assert p[0]['description'].endswith(
            ' normal speed.' if det else ' speed.')


ANNOTATIONS = ['id0001#a#000,Male,Black Hair,Smiling,No_Beard\n',
               'id0002#b#001,Wavy_Hair,Young,Wearing Lipstick,\n', '\n',
               'id0003#c#002,Eyeglasses,Bald,Mustache,Goatee\n',
               'id0004#d#003\n']


def test_prep_parse_annotation_line_matches_jax():
    for line in ANNOTATIONS:
        if not line.strip():
            continue
        (kj, pj), (kp, pp) = (jprep.parse_annotation_line(line),
                              pprep.parse_annotation_line(line))
        assert kj == kp
        np.testing.assert_array_equal(pj, pp)
    _, pred = pprep.parse_annotation_line(ANNOTATIONS[0])
    assert int(pred.sum()) == 4


def _files(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize('seed', [0, 7])
def test_prep_writers_match_jax(tmp_path, seed):
    out = {}
    for name, mod in (('jax', jprep), ('port', pprep)):
        random.seed(seed)
        np.random.seed(seed)
        mod.make_text(ANNOTATIONS, str(tmp_path / name / 'txt'), n=6)
        mod.make_label(ANNOTATIONS, str(tmp_path / name / 'label'))
        out[name] = (_files(tmp_path / name / 'txt'),
                     _files(tmp_path / name / 'label'))
    assert out['jax'] == out['port']
    txt, label = out['port']
    assert sorted(txt) == [f'id000{i}#{c}#00{i - 1}.txt' for i, c in
                           zip(range(1, 5), 'abcd')]
    assert len(txt['id0001#a#000.txt'].decode().split('\n')) == 6
    assert label['id0004#d#003.txt'] == b','.join([b'0'] * 40)


def test_prep_main_matches_jax(tmp_path, monkeypatch):
    ann = tmp_path / 'ann.txt'
    ann.write_text(''.join(ANNOTATIONS))
    for name, mod in (('jax', jprep), ('port', pprep)):
        random.seed(3)
        np.random.seed(3)
        argv = ['--annotations', str(ann), '--text_dir',
                str(tmp_path / name / 'txt'), '--label_dir',
                str(tmp_path / name / 'label'), '--num_captions', '4']
        if mod is jprep:
            monkeypatch.setattr('sys.argv', ['prep'] + argv)
            mod.main()
        else:
            mod.main(argv)
    for sub in ('txt', 'label'):
        assert _files(tmp_path / 'jax' / sub) == \
            _files(tmp_path / 'port' / sub)


@pytest.mark.parametrize('dataset,cls', [
    ('shape', TextVideoDataset), ('shape_attr', pshapes.ShapeAttrDataset),
    ('iper', piper.IPERDataset)])
def test_get_dataset_routes_as_jax(shapes_tree, tokenizers, dataset, cls):
    args = process_args(train=False, argv=[
        '--image_text_folder', str(shapes_tree), '--dataset', dataset,
        '--text_seq_len', '20', '--image_size', '16', '--frame_num', '3',
        '--frame_step', '2', '--attr_mode', 'color+shape+background+rand',
        '--negvc', '--deterministic', '--device', 'cpu'])
    got = factories.get_dataset(args, tokenizers[1])
    assert type(got) is cls
    assert len(got) == CLIPS
    if dataset == 'shape_attr':
        assert got.return_neg and 'visual_neg' in got[0]


def test_get_dataset_refuses_mp4_text(tmp_path, tokenizers):
    args = process_args(train=False, argv=[
        '--image_text_folder', str(tmp_path), '--dataset', 'mp4_text',
        '--device', 'cpu'])
    with pytest.raises(NotImplementedError, match='cv2'):
        factories.get_dataset(args, tokenizers[1])
