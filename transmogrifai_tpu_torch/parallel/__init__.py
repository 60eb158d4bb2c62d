"""Multi-device layer of the port, in the JAX package's names: the
``TM_MESH_*`` surface, the mesh type with its named axis, the selector's
1-D grid sharding (``get_mesh``, ``default_mesh``, ``grid_map``),
padding helpers and the row-partitioned (data-parallel) entry points,
``sharded_statistics`` among them. Not yet ported from
``transmogrifai_tpu.parallel``: the 2-D grid x data sweep
(``get_mesh_2d``, ``pad_grid_by_data``) and ``multihost``."""
from .data_parallel import (data_mesh, shard_rows,
                            sharded_contingency, sharded_histograms,
                            sharded_score, sharded_statistics)
from .mesh import (MESH_AXES, Mesh, MeshConfig, configured_devices,
                   default_mesh, device_labels, get_mesh, grid_map,
                   pad_to_multiple, resolve_mesh_config, visible_devices,
                   zero_pad_rows)

__all__ = ["MESH_AXES", "Mesh", "MeshConfig", "resolve_mesh_config",
           "visible_devices", "configured_devices", "default_mesh",
           "device_labels", "get_mesh", "grid_map", "pad_to_multiple",
           "zero_pad_rows", "data_mesh", "shard_rows",
           "sharded_statistics", "sharded_contingency",
           "sharded_histograms", "sharded_score"]
