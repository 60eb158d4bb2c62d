"""Multi-device layer of the port: the ``TM_MESH_*`` surface, padding
helpers and the row-partitioned (data-parallel) entry points. Not yet
ported from ``transmogrifai_tpu.parallel``: the grid sharding of the
selector (``get_mesh``, ``default_mesh``, ``grid_map``), the 2-D
``get_mesh_2d`` sweep, ``sharded_statistics`` and ``multihost``."""
from .data_parallel import (DataMesh, data_mesh, shard_rows,
                            sharded_contingency, sharded_histograms,
                            sharded_score)
from .mesh import (MESH_AXES, MeshConfig, configured_devices, device_labels,
                   pad_to_multiple, resolve_mesh_config, zero_pad_rows)

__all__ = ["MESH_AXES", "MeshConfig", "resolve_mesh_config",
           "configured_devices", "device_labels", "pad_to_multiple",
           "zero_pad_rows", "DataMesh", "data_mesh", "shard_rows",
           "sharded_contingency", "sharded_histograms", "sharded_score"]
