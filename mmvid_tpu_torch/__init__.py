"""mmvid_tpu_torch — the PyTorch/CUDA port of ``mmvid_tpu``.

Mirrors ``mmvid_tpu``'s layout (``models/``, ``ops/``) and names, with
PyTorch idiom inside: ``nn.Module``s, explicit devices and
``torch.Generator``s, Python loops.  The ops that ``mmvid_tpu`` wrote as
Pallas kernels are hand-written CUDA kernels here (``csrc/``), each beside
a plain PyTorch version that the CPU takes.

Imports ``torch`` and never ``jax``; from ``mmvid_tpu`` it reads only the
BPE vocabulary file and, for carrying JAX params over, the numpy-only
``mmvid_tpu.utils.torch_compat``.
"""

__version__ = "0.1.0"
