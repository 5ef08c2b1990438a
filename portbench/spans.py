"""The port's spans in a profiled frame: the frame's device time, launch
calls, host syncs and device idle time put down to the innermost
`tpt.*` range (`tinypathtracer_tpu_torch.utils.metrics.span`) that
holds each.

An addition beside `trace.py`, whose records and readings it leaves as
they are. `events` reads the same profiler events as `trace.events`,
keeps the host's `tpt.*` annotations apart (category "span", so that
they label no idle gap) and gives launches, runtime calls, kernels,
copies and sets their correlation id and host thread. `reduce` returns
`trace.reduce`'s reading of the records without the spans, with the
table `spans`: span name -> count, device seconds, launch calls,
syncing runtime calls and idle seconds, by these rules:

- a kernel, copy or set goes to the innermost span, on the thread that
  launched it, enclosing the start of its launch call (the runtime
  record of the same correlation id); its seconds are clipped to the
  window, as `kernel_s`. One whose launch call is not in the trace goes
  under "(unlinked)", never into a guessed span;
- a launch call, and a syncing runtime call (`SYNC_CALLS`), goes to the
  innermost span enclosing its start on its thread;
- an idle gap of the device goes to the innermost span enclosing its
  midpoint on the thread of the window's annotation;
- anything no span encloses goes under "(none)".

`per_frame` gives the four numbers a frame that the spans are for: the
key chain's device and idle milliseconds, the glue's launch calls, the
frame's host syncs.

    python -m portbench.spans --workload <cell> --seed <n>

renders the cell's traced frame as `portbench.run --trace 1` does (the
set-up, one plain frame, one profiled) and prints one JSON line: the
window, the table, `per_frame` and the launch links (`links`). Needs
the card.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import sys

from portbench import trace

PREFIX = "tpt."
FRAME, KEYS, KERNEL_B = "tpt.frame", "tpt.keys", "tpt.kernel_b"
NONE, UNLINKED = "(none)", "(unlinked)"
SYNC_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"))
DEVICE = ("kernel", "memcpy", "memset")
Event = collections.namedtuple("Event", trace.Event._fields + ("corr", "tid"),
                               defaults=(None, None))


def events(prof) -> list:
    """The records of `trace.events` with the host's tpt.* annotations
    as "span", and `corr` (the runtime's correlation id: a launch or
    runtime call and the device record it made share it) and `tid` (the
    host thread, the system's id) where they apply."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        corr = tid = None
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name == trace.WINDOW:
                continue
            low = name.lower()
            cat = ("memcpy" if low.startswith("memcpy") else
                   "memset" if low.startswith("memset") else "kernel")
            corr = e.correlation_id()
        else:
            tid = e.device_resource_id()
            if name == trace.WINDOW:
                cat = "window"
            elif e.is_user_annotation() and name.startswith(PREFIX):
                cat = "span"
            elif name in trace.LAUNCH_CALLS:
                cat, corr = "launch", e.correlation_id()
            elif name.startswith(("cuda", "cu")) and \
                    not name.startswith("cudnn"):
                cat, corr = "runtime", e.correlation_id()
            else:
                cat = "cpu"
        out.append(Event(cat, name, start, end, corr, tid))
    return out


def profiled(fn, device):
    """(fn()'s result, its records (`events`)) under torch.profiler, run
    as `trace.profiled` runs it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            out = fn()
    return out, events(prof)


class _Innermost:
    """The spans of one host thread, which nest, and the innermost one
    holding a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        # the enclosing span of each (-1: none)
        self.parent, stack = [], []
        for i, (start, _, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, t) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][1] < t:
            i = self.parent[i]
        return self.spans[i][2] if i >= 0 else NONE


@dataclasses.dataclass
class Reduced(trace.Reduced):
    spans: dict = dataclasses.field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        """`trace.Reduced.breakdown` with the spans table."""
        return dict(super().breakdown(top), spans=self.spans)


def _row():
    return {"count": 0, "device_s": 0.0, "launches": 0, "syncs": 0,
            "idle_s": 0.0}


def reduce(evts) -> Reduced:
    """Read `events`' records: `trace.reduce` of those that are not
    spans, and the spans table (the module's rules)."""
    plain = [trace.Event(*e[:4]) for e in evts if e.cat != "span"]
    base = trace.reduce(plain)
    win = [e for e in evts if e.cat == "window"] or plain
    w0, w1 = min(e.start for e in win), max(e.end for e in win)

    threads = collections.defaultdict(list)
    table = collections.defaultdict(_row)
    for e in evts:
        if e.cat == "span":
            threads[e.tid].append((e.start, e.end, e.name))
            table[e.name]["count"] += 1
    index = {tid: _Innermost(s) for tid, s in threads.items()}

    def at(tid, t):
        return index[tid].at(t) if tid in index else NONE

    calls = {e.corr: e for e in evts
             if e.cat in ("launch", "runtime") and e.corr is not None}
    device = []
    for e in evts:
        if e.cat in DEVICE and e.end > w0 and e.start < w1:
            s, t = max(e.start, w0), min(e.end, w1)
            device.append((s, t))
            call = calls.get(e.corr)
            name = UNLINKED if call is None else at(call.tid, call.start)
            table[name]["device_s"] += (t - s) * 1e-6
        elif e.cat == "launch" and w0 <= e.start <= w1:
            table[at(e.tid, e.start)]["launches"] += 1
        elif e.cat == "runtime" and e.name in SYNC_CALLS and \
                w0 <= e.start <= w1:
            table[at(e.tid, e.start)]["syncs"] += 1
    # the idle gaps of trace.reduce, by position
    edges = [w0] + [x for iv in trace._merge(device) for x in iv] + [w1]
    main = win[0].tid if win[0].cat == "window" else max(
        threads, key=lambda k: len(threads[k]), default=None)
    for i in range(0, len(edges), 2):
        s, t = edges[i], edges[i + 1]
        if t > s:
            table[at(main, 0.5 * (s + t))]["idle_s"] += (t - s) * 1e-6
    return Reduced(**dataclasses.asdict(base), spans=dict(table))


def links(evts) -> dict:
    """How the device records in the trace find their launch calls:
    linked, unlinked, early (records that start before their launch
    call does: the device's clock and the host's disagree) and
    early_max_us (the most by which one does)."""
    calls = {e.corr: e for e in evts
             if e.cat in ("launch", "runtime") and e.corr is not None}
    linked = unlinked = 0
    lead = []
    for e in evts:
        if e.cat in DEVICE:
            call = calls.get(e.corr)
            if call is None:
                unlinked += 1
                continue
            linked += 1
            if e.start < call.start:
                lead.append(call.start - e.start)
    return {"linked": linked, "unlinked": unlinked, "early": len(lead),
            "early_max_us": max(lead, default=0.0)}


def per_frame(spans: dict, units: int):
    """The spans table's four numbers a frame, or None where no tpt.frame
    span was recorded: the key chain's device and idle milliseconds
    (`tpt.keys`), the launch calls in the frame's other spans than
    `tpt.keys` and `tpt.kernel_b` (the glue), and the syncing runtime
    calls in the frame's spans."""
    if FRAME not in spans:
        return None
    keys = spans.get(KEYS, _row())
    ours = [r for n, r in spans.items() if n.startswith(PREFIX)]
    return {
        "key_chain_ms_per_frame": 1e3 * keys["device_s"] / units,
        "key_chain_idle_ms_per_frame": 1e3 * keys["idle_s"] / units,
        "glue_launches_per_frame": sum(
            r["launches"] for n, r in spans.items()
            if n.startswith(PREFIX) and n not in (KEYS, KERNEL_B)) / units,
        "host_syncs_per_frame": sum(r["syncs"] for r in ours) / units,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from portbench import bench, scenes
    from portbench.kinds import frame

    start = bench.process_start()
    bench.set_cache_dirs()
    os.environ["OMP_NUM_THREADS"] = "1"
    cell = bench.Cell.load(args.workload)
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench.spans needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import tinypathtracer_tpu_torch as T
    from tinypathtracer_tpu_torch.render import renderer as rend

    dev = torch.device("cuda", 0)
    job = bench.Run(cell=cell, seed=args.seed, seconds=0.0, trace=True,
                    device=dev, start=start)
    rcfg = T.RenderConfig(**scenes.render_args(cell.config))
    scene = T.FlatScene.from_numpy(scenes.build(cell.config), dev)
    renderer = T.Renderer(rcfg, device=dev)
    frame._warm_up(rend, scene, rcfg, job)
    frame._render(renderer, scene, frame.frame_key(args.seed, 0, dev), job)
    key = frame.frame_key(args.seed, 1, dev)
    _, evts = profiled(lambda: frame._render(renderer, scene, key, job), dev)
    r = reduce(evts)
    print(json.dumps({
        "card": bench.card_line(), "window_s": r.window_s,
        "busy_s": r.busy_s, "launches": r.launches,
        "idle_pct": r.idle_pct(), "links": links(evts),
        "per_frame": per_frame(r.spans, 1), "spans": r.spans,
        "breakdown": r.breakdown()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
