"""Process-group initialisation and the global mesh (port of
`tinypathtracer_tpu/parallel/distributed.py`).

`initialize()` reads the JAX package's variables, COORDINATOR_ADDRESS,
NUM_PROCESSES and PROCESS_ID, and starts the torch.distributed default
group: one process a rank, one rank a card. With none of them set it
starts a one-rank group, as the JAX CLI meshes one local device. The
collectives of the sharded paths are the radiance all-reduce over
"sample", the image gather over "data" and the gradient and loss
all-reduce over both (parallel/shard.py, diff/invrender.py); NCCL
carries them between cards, gloo on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from tinypathtracer_tpu_torch.parallel.mesh import make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> None:
    """Start the default process group of this rank. Call once per
    process, on every rank, before building a mesh.

    coordinator_address: "host:port" of rank 0's store (any free port,
    e.g. "localhost:29500"), or an init_method URL ("tcp://...",
    "file://..."); default COORDINATOR_ADDRESS. num_processes and
    process_id default to NUM_PROCESSES and PROCESS_ID, else 1 and 0; a
    one-rank group needs no address (an in-memory store). backend None
    is "nccl" on the card and "gloo" for device="cpu"; a backend given
    is used as given. On the card the rank takes card LOCAL_RANK (else
    process_id) modulo the cards present.
    """
    dev = torch.device(device)
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", 1))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", 0))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is None:
        if num_processes != 1:
            raise ValueError(f"{num_processes} processes need a "
                             "coordinator_address (or COORDINATOR_ADDRESS)")
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
        return
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def global_mesh(n_sample: int = 1, device="cuda"):
    """("data", "sample") mesh over every rank of the group (call after
    initialize() on every rank)."""
    n = dist.get_world_size()
    if n % n_sample:
        raise ValueError(f"{n} global devices not divisible by "
                         f"n_sample={n_sample}")
    return make_mesh(n_data=n // n_sample, n_sample=n_sample, device=device)
