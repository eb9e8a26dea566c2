"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: attention (``attention.py``; its int8 variant
``attention_int8.py``), the sample head (``sample_head.py``), the nearest
codebook entry (``codebook.py``), the fused LN + QKV projection
(``fused_ln_qkv.py``), the ART-V decode step (``artv_decode.py``) and the
launch-cost probe (``gridstep.py``); the int8 serving quantization
(``int8.py``, torch ops and ``torch._int_mm``, no kernel of its own); and
``precision.fp32_exact``, the context that turns TF32 off.
``_build`` compiles ``csrc/*.cu`` at first use."""
