"""Multi-device layer of the port: the device mesh, data parallelism over
it and the global BatchNorm (parallel/mesh.py), and spatial sharding of the
3-D ResNet over the mesh's 'space' axis (parallel/spatial.py)."""

from .mesh import (AXES, DATA_AXES, SPACE_AXIS, all_reduce_sum, barrier,
                   convert_sync_batchnorm, data_group, data_rank, data_size, default_mesh,
                   gather_rows, grad_group, group_sum, init_distributed, is_main, local_rows,
                   make_mesh, make_multislice_mesh, mesh_group, mesh_size, pad_to_multiple,
                   replicate, resolve_mesh, shard_batch, space_group, space_rank, space_size,
                   spatial_sharding, split_ranges)
from .spatial import HaloExchange, convert_spatial

__all__ = ["AXES", "DATA_AXES", "SPACE_AXIS", "HaloExchange", "all_reduce_sum", "barrier",
           "convert_spatial", "convert_sync_batchnorm", "data_group", "data_rank",
           "data_size", "default_mesh", "gather_rows", "grad_group", "group_sum",
           "init_distributed", "is_main", "local_rows", "make_mesh", "make_multislice_mesh",
           "mesh_group", "mesh_size", "pad_to_multiple", "replicate", "resolve_mesh",
           "shard_batch", "space_group", "space_rank", "space_size", "spatial_sharding",
           "split_ranges"]
