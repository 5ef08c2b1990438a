"""Run one cell of the port's benchmark and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json, portbench/ and
the port (`tinypathtracer_tpu_torch`). Needs as many CUDA cards as the
cell asks for, and exits with an error without printing a result when
they are not there (it never runs on the CPU). The last line of
standard output is one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
metrics), device, with --trace 1 breakdown, and last the compared
numbers beside their limits, which also end standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def layer_metrics(cell, ctx, strict=True) -> dict:
    """The cell's per-layer metrics read from a traced run. A metric the
    cell lists that reads nothing (a kernel renamed or taken off the
    path) fails the run, rather than leaving the metric out unseen;
    with strict=False (the CPU's twins leave no kernel names) it is left
    out."""
    from portbench import bench

    metrics = {}
    for m in cell.per_layer:
        value = bench.reader(m["name"])(ctx)
        if value is None and strict:
            raise SystemExit(
                f"per-layer metric {m['name']} read nothing in {cell.name}, "
                f"which its workloads list names: portbench/metrics/"
                f"{m['name']}.py found nothing in the trace")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def execute(cell, seed, seconds, trace, device, start):
    """Run a loaded cell on a device; returns the result line's object.
    The card check is the caller's (the tests run this on the CPU)."""
    from portbench import bench, compare

    run = bench.Run(cell=cell, seed=seed, seconds=seconds, trace=bool(trace),
                    device=device, start=start)
    out = bench.kind(cell.traffic["kind"]).run(run)
    found = bench.forbidden_modules()
    if found:
        raise SystemExit(f"modules that a benchmark run must not load are "
                         f"loaded: {found}")
    if trace:
        metrics = layer_metrics(cell, out.layer_ctx,
                                strict=device.type != "cpu")
    else:
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in out.end_to_end]
        if missing:
            raise SystemExit(f"the {cell.traffic['kind']} runner measured "
                             f"none of {missing}")
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    correct, checks = compare.verdict(out.numbers, cell.limits)
    correct = correct and out.failed == 0 and all(
        bench.finite(m["value"]) for m in metrics.values())
    import torch
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        dev.update(busy_s=out.busy_s, window_s=out.window_s)
    result = {"correct": bool(correct), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.breakdown is not None:
        result["breakdown"] = out.breakdown
    if cuda:
        result["card"] = bench.card_line()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    from portbench import bench

    start = bench.process_start()
    args = parse(argv)
    bench.set_cache_dirs()
    # one host thread: no idle OpenMP workers spinning beside the loop
    # that launches the kernels
    os.environ["OMP_NUM_THREADS"] = "1"
    cell = bench.Cell.load(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    bench.log_at(start, f"torch imported, {torch.cuda.device_count()} "
                 f"card(s) found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = execute(cell, args.seed, args.seconds, args.trace,
                     torch.device("cuda", 0), start)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
