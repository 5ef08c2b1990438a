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


# H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 outside the tensor
# cores, dense TF32 on the tensor cores, and HBM3; the rooflines of every
# bound the labs and chip_smoke.py report
FP32_PEAK = 67e12
TF32_PEAK = 495e12
HBM_BYTES_PER_S = 3.35e12
# fp32 operations of the hit test (csrc/hit.cuh), a fused multiply-add
# counted as 2 and the IEEE divide as 1 (the least it can cost; the
# compiler's divide is a sequence of ~10 instructions), comparisons not
# counted: o' = W o + c is 3 x (1 mul + 2 FMA) + 3 adds = 18 per
# (origin, triangle), needed once for each distinct origin; a direction
# against it is d' = W d (15), t (1), u and v (2 FMA = 4), u + v (1) = 21
# per (ray, triangle)
OPS_ORIGIN = 18
OPS_DIRECTION = 21
# fp32 operations of a slab test of one ray against one box (kernel A's
# run boxes, kernel C's chunk boxes; the boxes come widened): 6
# subtractions, 6 multiplies (min, max and comparisons not counted); and
# per ray its 3 reciprocals
OPS_SLAB = 12
OPS_RECIPROCALS = 3


def pair_ops(pairs, origin_pairs):
    """fp32 operations of `pairs` (ray, triangle) tests whose rays leave
    from origins that make `origin_pairs` distinct (origin, triangle)
    pairs: o' once per distinct pair, the rest per ray."""
    return pairs * OPS_DIRECTION + origin_pairs * OPS_ORIGIN


def origin_ids(origins):
    """(ids [N] i64 of the rows of origins [N, 3] among its distinct
    rows, the number of distinct rows)."""
    if origins.shape[0] == 0:
        return origins.new_zeros((0,), dtype=torch.int64), 0
    _, ids = torch.unique(origins, dim=0, return_inverse=True)
    return ids, int(ids.max()) + 1


def origin_visits(origins, visits):
    """Sum over the distinct rows of origins [N, 3] of the most chunks
    [N] a ray from that origin visited: the least number of distinct
    (origin, chunk) pairs of a walk with these visit counts (rays from
    one origin may visit different chunks; this counts the ones the
    furthest of them needs)."""
    ids, count = origin_ids(origins)
    most = visits.new_zeros((count,)).scatter_reduce_(0, ids, visits, "amax")
    return int(most.sum())


def dense_work(n, faces, pairs, origin_pairs, slab_tests=0, live=0):
    """(operations, bytes) of kernel A's function on n rays against
    `faces` triangles: `pairs` (ray, triangle) tests, `origin_pairs`
    distinct (origin, triangle) transforms, and with a gate its
    `slab_tests` (ray x run box tests) and the reciprocals of its `live`
    rays. Bytes: rays [N, 8] read, (t, slot, u, v) written, the faces'
    planes read once (padding slots need no work).
    tools/lab_dense.dense_pairs counts the pairs of both readings: all
    pairs, the same work whatever implements it, and the pairs in the
    runs a gated launch tested."""
    reciprocals = live * OPS_RECIPROCALS if slab_tests else 0
    return (pair_ops(pairs, origin_pairs) + slab_tests * OPS_SLAB
            + reciprocals, n * (32 + 16) + faces * 48)


def bound(ops, nbytes):
    """(least time in ms, "operations" or "bytes"): the larger of the
    two rooflines."""
    t_ops, t_bytes = ops / FP32_PEAK * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
