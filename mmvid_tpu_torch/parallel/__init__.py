"""Data-parallel training over ``torch.distributed`` (``mesh.py``), the
counterpart of the ``dcn`` / ``dp`` axes of ``mmvid_tpu/parallel/``."""

from mmvid_tpu_torch.parallel.mesh import (
    LOCAL,
    MESH_AXES,
    DataParallel,
    LocalBatch,
    is_root,
    parse_mesh_shape,
    rank,
    world,
)

__all__ = ['LOCAL', 'MESH_AXES', 'DataParallel', 'LocalBatch', 'is_root',
           'parse_mesh_shape', 'rank', 'world']
