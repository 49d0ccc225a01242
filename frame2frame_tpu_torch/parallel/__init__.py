from .mesh import (
    data_parallel_mesh,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch,
    shard_video,
    video_sharding,
)
from .shard import (
    make_sharded_f2f_step,
    make_sharded_sup_step,
    make_sharded_window_step,
)
from .spatial import (
    gather_frame,
    make_space_mesh,
    make_spatial_online_step,
    pad_h,
    split_frame,
)
