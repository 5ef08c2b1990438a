"""Observability: stage timers, render statistics, the profiler (port of
`tinypathtracer_tpu/utils/metrics.py`).

  * `StageTimer`: wall-clock time per stage, synchronising the card at a
    stage's end (PyTorch returns before the device finishes), so the
    numbers mean what they say;
  * `RenderStats`: rays/s, spp/s and the stage breakdown, as JSON with
    the JAX package's keys;
  * `trace_profile`: `torch.profiler` around a block, written as a
    Chrome trace (chrome://tracing, Perfetto);
  * `span`: a named range inside the program (`tpt.frame`, `tpt.chunk`,
    ...), recorded by whatever torch profiler is running, on the clock
    of the card's kernels; nothing but one check when none is;
  * `timed_render`: one render with its RenderStats.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch


def synchronize() -> None:
    """Wait for the card to finish the work queued on it (nothing to wait
    for without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StageTimer:
    """Wall-clock stage timing. A stage given sync_on (the JAX package's
    argument: what the stage computed) waits for the card at its end."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                synchronize()
            self.stages[name] = self.stages.get(name, 0.0) \
                + (time.perf_counter() - t0)


@dataclass
class RenderStats:
    width: int
    height: int
    spp: int
    max_depth: int
    seconds: float = 0.0
    stages: Dict[str, float] = field(default_factory=dict)

    @property
    def primary_rays(self) -> int:
        return self.width * self.height * self.spp

    @property
    def rays_per_s(self) -> float:
        return self.primary_rays / self.seconds if self.seconds else 0.0

    @property
    def spp_per_s(self) -> float:
        return self.spp / self.seconds if self.seconds else 0.0

    def to_json(self) -> str:
        return json.dumps({
            "width": self.width, "height": self.height, "spp": self.spp,
            "max_depth": self.max_depth, "seconds": round(self.seconds, 4),
            "primary_rays": self.primary_rays,
            "rays_per_s": round(self.rays_per_s, 1),
            "spp_per_s": round(self.spp_per_s, 3),
            "stages": {k: round(v, 4) for k, v in self.stages.items()},
        })


@contextlib.contextmanager
def trace_profile(logdir: Optional[str]):
    """torch.profiler around the block if a logdir is given (the card's
    kernels too when CUDA is available), written to
    logdir/trace.json as a Chrome trace; else a no-op."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """The context of a named range of the program: while a torch
    profiler records (`trace_profile`, or any `torch.profiler.profile`),
    `torch.profiler.record_function(name)`, which the profiler keeps
    beside the kernels, copies and runtime calls the range launches;
    otherwise one shared null context, so that a range costs one check
    and enters no profiler op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def timed_render(renderer, scene, key) -> tuple:
    """(image, RenderStats) of one renderer.render call, the card
    synchronised before the clock stops."""
    cfg = renderer.cfg
    t0 = time.perf_counter()
    img = renderer.render(scene, key)
    synchronize()
    dt = time.perf_counter() - t0
    return img, RenderStats(width=cfg.width, height=cfg.height, spp=cfg.spp,
                            max_depth=cfg.max_depth, seconds=dt)
