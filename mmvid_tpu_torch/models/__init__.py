"""Models of the port: backbone (``clip``), ``axial``, ``bert``,
``sampler``, ``vqgan`` (encoder and decoder), the visual-control erasers
(``masking``) and the top-level ``mmvid``."""
