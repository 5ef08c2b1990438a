"""Rank processes on one host: start fn(rank, world, tmp, *args) in
world processes ("spawn" start method), wait for them with a deadline,
stop every one of them, and read back what each saved to
`rank_file(tmp, rank)`. A rank joins its group through a store under
tmp (e.g. `initialize(f"file://{tmp}/store", world, rank)`), so groups
started at once in different directories never race for a port.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

# seconds a group of rank processes may take
RANK_TIMEOUT = 300


def rank_file(tmp, rank: int) -> str:
    """Where rank `rank` saves its result (torch.save)."""
    return os.path.join(str(tmp), f"rank{rank}.pt")


def start_ranks(fn, world: int, tmp, *args):
    """Start fn(rank, world, tmp, *args) on world ranks; `collect_ranks`
    waits for them."""
    import torch.multiprocessing as mp

    return mp.start_processes(fn, args=(world, str(tmp)) + args,
                              nprocs=world, join=False,
                              start_method="spawn")


def collect_ranks(context, tmp,
                  timeout: Optional[float] = RANK_TIMEOUT) -> list:
    """What each rank of a started context saved, in rank order. A rank
    that raises or exits non-zero raises here, and so do ranks that
    outlast `timeout` seconds (None: no deadline); every process has
    stopped when this returns."""
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not context.join(timeout=5):
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"{len(context.processes)} ranks did not "
                                   f"finish in {timeout} s")
    finally:
        for proc in context.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
    return [torch.load(rank_file(tmp, r))
            for r in range(len(context.processes))]


def spawn_ranks(fn, world: int, tmp, *args,
                timeout: Optional[float] = RANK_TIMEOUT) -> list:
    """Run fn(rank, world, tmp, *args) on world ranks and return what
    each saved, in rank order (`start_ranks`, then `collect_ranks`)."""
    return collect_ranks(start_ranks(fn, world, tmp, *args), tmp, timeout)
