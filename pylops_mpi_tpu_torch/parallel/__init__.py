from .partition import Partition, local_split
from .mesh import default_device, set_default_device, resolve_device, world_size

__all__ = ["Partition", "local_split", "default_device",
           "set_default_device", "resolve_device", "world_size"]
