"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: attention (``attention.py``), the sample head
(``sample_head.py``), the nearest codebook entry (``codebook.py``) and the
fused LN + QKV projection (``fused_ln_qkv.py``).  ``_build`` compiles
``csrc/*.cu`` at first use."""
