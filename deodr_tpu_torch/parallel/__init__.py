"""Scale-out on torch.distributed: device meshes, tile-sharded rendering,
view-parallel fitting (``sharding``), and starting the ranks (``launch``)."""

from deodr_tpu_torch.parallel.launch import init_process_group, run_ranks
from deodr_tpu_torch.parallel.sharding import (
    make_device_mesh,
    make_multiview_train_step,
    make_textured_multiview_step,
    make_tile_sharded_render,
    multiview_train_step,
    shard_render_scene,
)

__all__ = [
    "init_process_group",
    "make_device_mesh",
    "make_multiview_train_step",
    "make_textured_multiview_step",
    "make_tile_sharded_render",
    "multiview_train_step",
    "run_ranks",
    "shard_render_scene",
]
