"""Device meshes for distributed rendering (port of
`tinypathtracer_tpu/parallel/mesh.py`).

A `torch.distributed.device_mesh.DeviceMesh` with two named axes:

  * "data"   -- pixel batches: each rank owns a slice of the film, the
                scene is replicated, the forward pass communicates only
                to gather the image;
  * "sample" -- samples per pixel: ranks render disjoint sample ranges
                of the same pixels and all-reduce the radiance sum.

JAX runs many devices in one process; torch runs one rank per device
(NCCL refuses two ranks on one card, gloo does not). So the mesh is
built over the ranks of the default process group, in rank order: rank
r sits at (r // n_sample, r % n_sample). Where the JAX mesh takes the
first n_data * n_sample of its devices, this one must cover the whole
world: a mesh smaller than the world raises too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
SAMPLE_AXIS = "sample"


def make_mesh(n_data: Optional[int] = None, n_sample: int = 1,
              device="cuda") -> DeviceMesh:
    """A ("data", "sample") mesh of shape (n_data, n_sample) over the
    ranks of the default process group, on the card unless device is
    "cpu". n_data defaults to world_size // n_sample. A (N, 1) mesh is
    pure pixel sharding; (N/2, 2) also splits the samples in half across
    pairs of ranks. Call on every rank, after
    `parallel.distributed.initialize()`: without a process group it
    raises, rather than building a one-rank mesh."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a torch.distributed process "
                           "group: call parallel.distributed.initialize() "
                           "on every rank first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_sample
    n = n_data * n_sample
    if n > world:
        raise ValueError(f"mesh {n_data}x{n_sample} needs {n} devices, "
                         f"have {world}")
    if n < world:
        raise ValueError(f"mesh {n_data}x{n_sample} covers {n} of the "
                         f"{world} ranks: the mesh must cover every rank")
    return init_device_mesh(torch.device(device).type, (n_data, n_sample),
                            mesh_dim_names=(DATA_AXIS, SAMPLE_AXIS))


def axis(mesh: DeviceMesh, name: str):
    """(size, this rank's index, process group) of a mesh axis."""
    dim = mesh.mesh_dim_names.index(name)
    return (mesh.size(dim), mesh.get_local_rank(dim),
            mesh.get_group(dim))
