"""Distributed rendering and training over torch.distributed (port of
`tinypathtracer_tpu/parallel`): pixels shard over the "data" axis of a
("data", "sample") device mesh, samples over "sample", the scene is
replicated on every rank."""

from tinypathtracer_tpu_torch.parallel.distributed import (global_mesh,
                                                           initialize)
from tinypathtracer_tpu_torch.parallel.mesh import (DATA_AXIS, SAMPLE_AXIS,
                                                    make_mesh)
from tinypathtracer_tpu_torch.parallel.shard import (make_sharded_renderer,
                                                     render_frame_sharded)
from tinypathtracer_tpu_torch.parallel.spawn import (collect_ranks, rank_file,
                                                     spawn_ranks, start_ranks)

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "collect_ranks", "global_mesh",
           "initialize", "make_mesh", "make_sharded_renderer", "rank_file",
           "render_frame_sharded", "spawn_ranks", "start_ranks"]
