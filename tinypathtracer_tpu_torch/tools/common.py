"""Timing and device helpers shared by the lab harnesses.

On the card a time is device time between CUDA events: one warm-up
call, then the median of `reps` calls, each between its own pair of
events (PyTorch returns before the device finishes). On the CPU it is
the host clock. Every result names the device it ran on.
"""

from __future__ import annotations

import argparse
import time

import torch

from tinypathtracer_tpu_torch.render.renderer import resolve_device


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def parse(ap: argparse.ArgumentParser, argv, caller: str):
    """(the parsed arguments, their device): a card that is not there
    raises rather than the lab running elsewhere."""
    args = ap.parse_args(argv)
    return args, resolve_device(args.device, caller)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def timed_ms(fn, dev: torch.device, reps: int = 5, warm: int = 1) -> float:
    """Median time of one fn() call in ms (CUDA events on the card, the
    host clock on the CPU), after `warm` untimed calls."""
    for _ in range(warm):
        fn()
    if dev.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2]
    pairs = []
    for _ in range(reps):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize(dev)
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]
