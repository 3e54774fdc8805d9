"""Multi-device scaling: mesh helpers, scene-parallel fusion, spatially
sharded volumes, multi-process start-up."""

from .mesh import data_parallel_mesh, replicate, scene_mesh, shard_batch
from .multihost import initialize, is_multihost, local_scene_shard
from .scene_parallel import (SceneParallelFusion, stack_volumes,
                             unstack_volumes)
from .spatial import SpatialShardedFusion, shard_volume_spatial
