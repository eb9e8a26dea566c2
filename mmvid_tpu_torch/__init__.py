"""mmvid_tpu_torch — the PyTorch/CUDA port of ``mmvid_tpu``.

Mirrors ``mmvid_tpu``'s layout (``models/``, ``ops/``, ``parallel/``) and
names, with PyTorch idiom inside: ``nn.Module``s, explicit devices and
``torch.Generator``s, Python loops.  The ops that ``mmvid_tpu`` wrote as
Pallas kernels are hand-written CUDA kernels here (``csrc/``), each beside
a plain PyTorch version that the CPU takes.

Imports ``torch`` and never ``jax``, and no module of ``mmvid_tpu``: it
keeps its own numpy-only copy of the JAX-params converter
(``utils/torch_compat.py``).  From ``mmvid_tpu`` it reads only a data file,
the BPE vocabulary.
"""

__version__ = "0.1.0"
