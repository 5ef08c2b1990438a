"""A tiny version of the benchmark's cell for the CPU tests: the cell's
own files, with the frame cut to what a CPU test holds (16 x 11 pixels
in chunks of 32, the last one ragged), at 64 spp so that most sampled
pixels are lit and a fault in one chunk shows on every seed."""

import time

import torch

from portbench import bench, run

CELL = "cornell-frame"


def cell(name: str = CELL) -> bench.Cell:
    c = bench.Cell.load(name)
    c.config.update(width=16, height=11, spp=64, max_depth=4,
                    rays_per_dispatch=2048)
    c.traffic["samples_per_chunk"] = 16
    return c


def execute(name: str = CELL, seed: int = 1234567890123, trace: int = 0,
            seconds: float = 0.01):
    """One run of the tiny cell on the CPU: the result line's object."""
    torch.set_num_threads(2)
    return run.execute(cell(name), seed, seconds, trace, torch.device("cpu"),
                       time.time())
