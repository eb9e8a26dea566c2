"""The int8 VQGAN decoder at full width: the port beside the JAX package,
on the same weights, calibration ids and decoded ids, on the CPU in fp32.

Both packages' ``quantize_vae_decoder`` calibrate the full-width decoder
(``VQGanConfig()``, 128 px, 58 int8 sites) on the same random token
grids; both then decode other random grids, int8 and unquantized.  The
JAX package's own test (tests/test_int8.py, at a 28-site decoder) bounds
mean |int8 - fp| at 0.02 and max at 0.2 on the [0, 1] images; this script
reads both packages against those bounds at full width, and the port run
with the JAX package's own scales.  The weights are drawn as the port
draws the flagship's (``factories.init_weights``), from ``--seed``.

Run from the repository root (a few minutes, about 3 GB):

    python tests/int8_decoder_witness.py [--seed 0] [--frames 4]

It prints one JSON line.
"""

import argparse
import json
import os
import sys

os.environ['JAX_PLATFORMS'] = 'cpu'
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update('jax_platforms', 'cpu')

from mmvid_tpu.models.vqgan import VQGanConfig as JaxVQCfg  # noqa: E402
from mmvid_tpu.models.vqgan import VQGanVAE as JaxVAE  # noqa: E402
from mmvid_tpu.ops import int8 as jint8  # noqa: E402
from mmvid_tpu.utils.torch_compat import convert_vqgan  # noqa: E402
from mmvid_tpu_torch import factories  # noqa: E402
from mmvid_tpu_torch.models.vqgan import VQGanConfig, VQGanVAE  # noqa: E402
from mmvid_tpu_torch.ops import int8 as pint8  # noqa: E402


def _diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return {'mean': float(d.mean()), 'max': float(d.max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--frames', type=int, default=4)
    args = ap.parse_args(argv)

    torch.set_grad_enabled(False)
    pvae = VQGanVAE(image_size=128, cfg=VQGanConfig()).eval()
    factories.init_weights(pvae, torch.Generator().manual_seed(args.seed))
    jvae = JaxVAE(image_size=128, cfg=JaxVQCfg(), params=convert_vqgan(
        {k: v.numpy() for k, v in pvae.model.state_dict().items()}))
    rng = np.random.RandomState(args.seed)
    shape = (args.frames, pvae.image_seq_len)
    calib = rng.randint(0, pvae.num_tokens, shape).astype(np.int32)
    ids = rng.randint(0, pvae.num_tokens, shape).astype(np.int32)

    jq = jint8.quantize_vae_decoder(jvae, sample_tokens=jnp.asarray(calib))
    j_fp = np.asarray(jvae.decode(jnp.asarray(ids)))
    j_i8 = np.asarray(jq.decode(jnp.asarray(ids)))

    t_ids = torch.from_numpy(ids).long()
    pq = pint8.quantize_vae_decoder(
        pvae, sample_tokens=torch.from_numpy(calib).long())
    p_fp = pvae.decode(t_ids).numpy()
    p_i8 = pq.decode(t_ids).numpy()
    p_i8_jax_scales = pint8.quantized_vae(pvae, jq.cfg.int8_scales).decode(
        t_ids).numpy()

    j_scales, p_scales = dict(jq.cfg.int8_scales), dict(pq.cfg.int8_scales)
    print(json.dumps({
        'config': 'VQGanConfig() at 128 px, fp32, CPU',
        'seed': args.seed, 'frames': args.frames, 'sites': len(j_scales),
        'scales_equal_sites': sum(abs(p_scales[p] - v) <= 1e-4
                                  for p, v in j_scales.items()),
        'jax_int8_vs_jax_fp32': _diff(j_i8, j_fp),
        'port_int8_vs_port_fp32': _diff(p_i8, p_fp),
        'port_int8_jax_scales_vs_port_fp32': _diff(p_i8_jax_scales, p_fp),
        'port_fp32_vs_jax_fp32': _diff(p_fp, j_fp),
        'port_int8_vs_jax_int8': _diff(p_i8_jax_scales, j_i8),
        'bounds': {'mean': 0.02, 'max': 0.2}}))


if __name__ == '__main__':
    main()
