from .partition import (Partition, local_split, shard_offsets,
                        padded_shard_size, pad_index_map, unpad_index_map,
                        flat_outer_shapes)
from .mesh import (Mesh, make_mesh, default_mesh, init, destroy,
                   default_device, set_default_device, resolve_device,
                   world_size, rank, best_grid_2d, Grid2D, make_grid_2d,
                   make_mesh_hybrid, sub_mesh, detach)
from . import collectives, topology, reshard, spill
from .reshard import (Layout, ReshardPlan, ReshardError, plan_reshard,
                      place_replica)
from .spill import HostArray

__all__ = ["Partition", "local_split", "shard_offsets", "padded_shard_size",
           "pad_index_map", "unpad_index_map", "flat_outer_shapes", "Mesh",
           "make_mesh", "default_mesh", "init", "destroy", "default_device",
           "set_default_device", "resolve_device", "world_size", "rank",
           "best_grid_2d", "Grid2D", "make_grid_2d", "make_mesh_hybrid",
           "sub_mesh", "detach", "collectives", "topology", "reshard",
           "spill", "Layout", "ReshardPlan", "ReshardError", "plan_reshard",
           "place_replica", "HostArray"]
