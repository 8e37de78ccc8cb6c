"""Data parallelism over processes, one device each (counterpart of
``dtt.parallel``): the process group, the rank's mesh and the collectives
the parallel train and inference steps use."""

from dtt_torch.parallel.mesh import (DataMesh, all_gather_cat,
                                     all_reduce_mean_, barrier, broadcast_,
                                     data_mesh, exchange_halo,
                                     initialize_distributed, local_device)

__all__ = ["DataMesh", "all_gather_cat", "all_reduce_mean_", "barrier",
           "broadcast_", "data_mesh", "exchange_halo",
           "initialize_distributed", "local_device"]
