"""A tiny version of the benchmark's cell for the CPU tests: the cell's
own files, with the frame cut to what a CPU test holds (16 x 11 pixels
in chunks of 32, the last one ragged), at 64 spp so that most sampled
pixels are lit and a fault in one chunk shows on every seed."""

import time

import torch

from portbench import bench, faults, run
from portbench.kinds import frame

CELL = "cornell-frame"


def cell(name: str = CELL) -> bench.Cell:
    c = bench.Cell.load(name)
    c.config.update(width=16, height=11, spp=64, max_depth=4,
                    rays_per_dispatch=2048)
    c.traffic["samples_per_chunk"] = 16
    return c


class Ticks:
    """A clock for the frame kind that reads one second more at every
    reading: a window of n - 0.5 s then holds n frames, whatever a frame
    takes."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 1.0
        return self.t


def execute(c: bench.Cell = None, seed: int = 1234567890123, trace: int = 0,
            seconds: float = 0.01, frames: int = None):
    """One run of the tiny cell (or of c) on the CPU: the result line's
    object. With frames, the window holds that many frames exactly."""
    torch.set_num_threads(2)
    c = cell() if c is None else c
    if frames is None:
        return run.execute(c, seed, seconds, trace, torch.device("cpu"),
                           time.time())
    with faults.patched(frame, "time", lambda _: Ticks()):
        return run.execute(c, seed, frames - 0.5, trace, torch.device("cpu"),
                           time.time())
