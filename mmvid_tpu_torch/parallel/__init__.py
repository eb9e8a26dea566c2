"""Training over ``torch.distributed``: the mesh of ranks and data
parallelism (``mesh.py``) and tensor parallelism (``tensor.py``), the
counterparts of the ``dcn`` / ``dp`` and ``tp`` axes of
``mmvid_tpu/parallel/``."""

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
