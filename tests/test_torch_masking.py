"""The port's visual-control erasers (mmvid_tpu_torch.models.masking) vs
the JAX package's (mmvid_tpu.models.masking), on the CPU.

Fixed patterns (every ``vc_mode`` with ``face_mode`` given, and the
bottom-half erase) must match token for token.  The random modes draw
from another generator than JAX's PRNG, so they are held in distribution:
total variation between the two packages' empirical distributions (and
against the exact pattern probabilities) at most 0.05, the bound of
tests/test_sampler_parity.py.  With the draw counts below the expected
TV of a correct sampler is about 0.01-0.02.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmvid_tpu.models import bert as jbert
from mmvid_tpu.models import masking as jmask
from mmvid_tpu_torch.models import bert as pbert
from mmvid_tpu_torch.models import masking as pmask

TV_BOUND = 0.05
JCFG = jbert.BertConfig(dim=64, num_visuals=2, image_fmap_size=8)
PCFG = pbert.BertConfig(dim=64, num_visuals=2, image_fmap_size=8)
MASK = PCFG.mask_token


def _tokens(b, seed=0):
    return np.random.RandomState(seed).randint(
        0, 1024, (b, PCFG.visual_seq_len)).astype(np.int32)


def _tv(p, q):
    return 0.5 * np.abs(np.asarray(p, float) - np.asarray(q, float)).sum()


def _hist(values, bins):
    return np.bincount(np.asarray(values), minlength=bins) / len(values)


@pytest.mark.parametrize('vc_mode,face_mode', [
    ('face_8x8', 'eyes_nose'), ('face_8x8', 'mouth'),
    ('face2_8x8', 'face2'), ('face3_8x8', 'face3'),
    ('mask_8x8', 'mask'), ('mask2_8x8', 'mask2'), ('shape_4x4', 'shape')])
def test_erase_codebook_face_fixed_patterns_match_jax(vc_mode, face_mode):
    toks = _tokens(3)
    want = jmask.erase_codebook_face(jax.random.PRNGKey(0),
                                     jnp.asarray(toks), JCFG, vc_mode,
                                     face_mode)
    got = pmask.erase_codebook_face(torch.Generator(),
                                    torch.from_numpy(toks).long(), PCFG,
                                    vc_mode, face_mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == MASK).any()


def test_erase_half_matches_jax():
    toks = _tokens(2, seed=1)
    want = jmask.random_erase_codebook(jax.random.PRNGKey(0),
                                       jnp.asarray(toks), JCFG,
                                       erase_half=True)
    got = pmask.random_erase_codebook(torch.Generator(),
                                      torch.from_numpy(toks).long(), PCFG,
                                      erase_half=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unknown_vc_mode_raises():
    with pytest.raises(NotImplementedError):
        pmask.erase_codebook_face(torch.Generator(),
                                  torch.zeros((1, 128), dtype=torch.long),
                                  PCFG, 'nose_2x2')


def _pattern(out, toks):
    """0 keep-all, 1 centre, 2 wide (mask_8x8); 0 eyes, 1 mouth
    (face_8x8): told apart by the number of [MASK]s."""
    n_masked = int((np.asarray(out) == MASK).sum())
    n_masked //= PCFG.num_visuals
    return {0: 0, 48: 1, 28: 2, 46: 0, 56: 1}[n_masked]


@pytest.mark.parametrize('vc_mode,probs', [('mask_8x8', [0.5, 0.25, 0.25]),
                                           ('face_8x8', [0.5, 0.5])])
def test_random_pattern_frequencies_match_jax(vc_mode, probs):
    """face_mode=None: one pattern drawn per call (for the whole batch)."""
    n = 4000
    toks = _tokens(1, seed=2)
    gen = torch.Generator().manual_seed(0)
    pt = torch.from_numpy(toks).long()
    port = [_pattern(pmask.erase_codebook_face(gen, pt, PCFG, vc_mode)[0],
                     toks) for _ in range(n)]
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    outs = jax.vmap(lambda k: jmask.erase_codebook_face(
        k, jnp.asarray(toks), JCFG, vc_mode))(keys)
    ref = [_pattern(o[0], toks) for o in np.asarray(outs)]
    p_port, p_ref = _hist(port, len(probs)), _hist(ref, len(probs))
    assert _tv(p_port, probs) <= TV_BOUND, p_port
    assert _tv(p_port, p_ref) <= TV_BOUND, (p_port, p_ref)


def test_random_erase_box_distribution_matches_jax():
    """Boxes of random_erase_codebook: the erased-area distribution and
    the per-cell erase frequency (position) agree with the JAX package's;
    every box is shared by the sample's frames."""
    n = 20000
    toks = np.full((n, PCFG.visual_seq_len), 7, np.int32)
    got = pmask.random_erase_codebook(
        torch.Generator().manual_seed(3), torch.from_numpy(toks).long(),
        PCFG).numpy().reshape(n, 2, 64) == MASK
    want = np.asarray(jmask.random_erase_codebook(
        jax.random.PRNGKey(3), jnp.asarray(toks), JCFG)).reshape(
        n, 2, 64) == MASK
    for m in (got, want):
        assert (m[:, 0] == m[:, 1]).all()
    area_p, area_j = got[:, 0].sum(-1), want[:, 0].sum(-1)
    assert _tv(_hist(area_p, 65), _hist(area_j, 65)) <= TV_BOUND
    # p = 0.95 of erasing at all
    assert abs((area_p > 0).mean() - 0.95) < 0.01
    cell_p, cell_j = got[:, 0].mean(0), want[:, 0].mean(0)
    assert np.abs(cell_p - cell_j).max() <= 0.03
