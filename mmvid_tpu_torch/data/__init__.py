"""Datasets and the batch loader of the port's drivers (the port's copy of
``mmvid_tpu.data``; frames read without Pillow by ``data/png.py``)."""

from mmvid_tpu_torch.data.loader import DataLoader, infinite_batches
from mmvid_tpu_torch.data.datasets import (
    TextImageDataset,
    TextVideoDataset,
    TextImageStackDataset,
)
from mmvid_tpu_torch.data.vox import VoxDataset

__all__ = [
    'DataLoader', 'infinite_batches', 'TextImageDataset', 'TextVideoDataset',
    'TextImageStackDataset', 'VoxDataset',
]
