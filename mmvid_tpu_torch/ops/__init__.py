"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: attention (``attention.py``) and the sample head
(``sample_head.py``).  ``_build`` compiles ``csrc/*.cu`` at first use."""
