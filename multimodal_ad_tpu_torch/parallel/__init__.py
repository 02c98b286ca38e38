"""Multi-device layer of the port: the device mesh, data parallelism over
it and the global BatchNorm (parallel/mesh.py)."""

from .mesh import (DATA_AXES, all_reduce_sum, barrier, convert_sync_batchnorm,
                   data_group, data_rank, data_size, default_mesh, gather_rows,
                   init_distributed, is_main, local_rows, make_mesh,
                   make_multislice_mesh, pad_to_multiple, replicate, resolve_mesh,
                   shard_batch)

__all__ = ["DATA_AXES", "all_reduce_sum", "barrier", "convert_sync_batchnorm",
           "data_group", "data_rank", "data_size", "default_mesh", "gather_rows",
           "init_distributed", "is_main", "local_rows", "make_mesh",
           "make_multislice_mesh", "pad_to_multiple", "replicate", "resolve_mesh",
           "shard_batch"]
