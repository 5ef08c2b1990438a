"""Readings that the limits of the comparison are set from (PERF.md):
the program's numbers on many seeds, the control's, and the planted
faults', at the cell's own size, in one process, each judged by
`compare.verdict` against the cell's limits.

    python -m portbench.readings --workload <cell> --seeds <n> [<n> ...] \
        [--control] [--faults]

Per seed FRAMES frames of the program (keys fold_in(seed, i), as a
window's) and the cell's sampled pixels of them against the reference's;
with --control the reference computed in TF32 (the control) on the same
pixels; with --faults the program with each fault of `faults.FRAME` and
`faults.SMALL` planted. Prints one JSON line per seed: for each of
"program", "control" and every fault its numbers and its verdict.
Needs the card (the tests call `frame_readings` on the CPU at a tiny
size).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import bench, compare, faults, scenes
from portbench.kinds import frame
from portbench.reference import tracer as ref

# frames a seed renders: two, so that a fault that repeats a frame shows
FRAMES = 2


def _judged(numbers, limits):
    ok, _ = compare.verdict(numbers, limits)
    return dict(numbers, correct=ok)


def frame_readings(cell, seeds, device, control=False, plant=False):
    import tinypathtracer_tpu_torch as T

    arrays = scenes.build(cell.config)
    rcfg = T.RenderConfig(**scenes.render_args(cell.config))
    scene = T.FlatScene.from_numpy(arrays, device)
    tab = ref.Tables.build(arrays, device)
    per_chunk = int(cell.traffic["samples_per_chunk"])

    def window(seed):
        renderer = T.Renderer(rcfg, device=device)
        keys = [frame.frame_key(seed, i, device) for i in range(FRAMES)]
        imgs = [renderer.render(scene, k) for k in keys]
        return keys, frame.sample_pixels(imgs, seed, per_chunk, rcfg)

    for seed in seeds:
        keys, (which, pix, chunk, port) = window(seed)
        want = frame.reference_pixels(tab, keys, which, pix, rcfg)
        out = {"seed": seed, "program": _judged(
            compare.frame_numbers(port, want, chunk), cell.limits)}
        if control:
            ctl = frame.reference_pixels(tab, keys, which, pix, rcfg,
                                         tf32=True)
            out["control"] = _judged(compare.frame_numbers(ctl, want, chunk),
                                     cell.limits)
        if plant:
            for name, fault in {**faults.FRAME, **faults.SMALL}.items():
                with fault():
                    _, (_, _, _, bad) = window(seed)
                out[name] = _judged(compare.frame_numbers(bad, want, chunk),
                                    cell.limits)
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    if not torch.cuda.is_available():
        print("portbench.readings needs a CUDA card", file=sys.stderr)
        return 2
    cell = bench.Cell.load(args.workload)
    rows = frame_readings(cell, args.seeds, torch.device("cuda", 0),
                          args.control, args.faults)
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
