"""Evaluation: FVD (I3D), PRD (InceptionV3 or CLIP embeddings) and the
CLIP score; the port's counterpart of ``mmvid_tpu/eval``."""
