"""Models of the port: backbone (``clip``), ``axial``, ``bert``,
``sampler``, ``vqgan`` (decoder) and the top-level ``mmvid``."""
