"""Multi-device layer of the port, in the JAX package's names: the
``TM_MESH_*`` surface, the mesh types with their named axes, the
selector's grid sharding over 1-D and 2-D (grid x data) meshes
(``get_mesh``, ``get_mesh_2d``, ``default_mesh``, ``grid_map``),
padding helpers, the row-partitioned (data-parallel) entry points,
``sharded_statistics`` among them, and the multi-process runtime
(``multihost``: ``initialize_distributed``, ``hybrid_mesh``)."""
from .data_parallel import (data_mesh, shard_rows,
                            sharded_contingency, sharded_histograms,
                            sharded_score, sharded_statistics)
from .mesh import (MESH_AXES, Mesh, Mesh2D, MeshConfig, configured_devices,
                   default_mesh, device_labels, get_mesh, get_mesh_2d,
                   grid_map, pad_grid_by_data, pad_to_multiple,
                   resolve_mesh_config, visible_devices, zero_pad_rows)
from .multihost import (host_device_groups, hybrid_mesh,
                        initialize_distributed, process_info)

__all__ = ["MESH_AXES", "Mesh", "Mesh2D", "MeshConfig",
           "resolve_mesh_config", "visible_devices", "configured_devices",
           "default_mesh", "device_labels", "get_mesh", "get_mesh_2d",
           "grid_map", "pad_to_multiple", "pad_grid_by_data",
           "zero_pad_rows", "hybrid_mesh", "host_device_groups",
           "initialize_distributed", "process_info", "data_mesh",
           "shard_rows", "sharded_statistics", "sharded_contingency",
           "sharded_histograms", "sharded_score"]
