"""Reduction of a profiler trace to what the per-layer metrics read.

`events` turns a `torch.profiler` run into plain records (category,
name, start, end in microseconds); `reduce` reads them: the traced
window, the union of device activity in it (busy seconds), device time
by kernel name, kernel launches (the runtime's launch calls), and the
idle gaps of the device labelled by what the host was doing (the CPU op
or runtime call that overlaps the gap most). The records are plain so
that the tests can hand `reduce` a synthetic trace.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "portbench.window"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
# host ops looked back over for the one running in a gap
SCAN = 4096
Event = collections.namedtuple("Event", "cat name start end")


def events(prof) -> list:
    """Plain records of a finished torch.profiler.profile, read from its
    raw kineto events (building the profiler's event tree takes minutes
    at 10^5 launches): "kernel", "memcpy", "memset" (device), "launch",
    "runtime" (CUDA runtime calls), "window" (the harness's window
    annotation on the host; its copy on the device timeline is dropped),
    "cpu" (other host ops)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns() * 1e-3, e.end_ns() * 1e-3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or name == WINDOW:
                continue
            low = name.lower()
            cat = ("memcpy" if low.startswith("memcpy") else
                   "memset" if low.startswith("memset") else "kernel")
        elif name == WINDOW:
            cat = "window"
        elif name in LAUNCH_CALLS:
            cat = "launch"
        elif name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
            cat = "runtime"
        else:
            cat = "cpu"
        out.append(Event(cat, name, start, end))
    return out


def profiled(fn, device):
    """(fn()'s result, the reduced trace of the call) under
    torch.profiler, host ops and, on the card, its activity, the call
    annotated as the window."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    return out, reduce(events(prof))


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    kernel_s: dict          # kernel name -> device seconds in the window
    kernel_count: dict      # kernel name -> launches executed
    launches: int           # launch calls of the runtime in the window
    gaps: list              # (label, seconds) of every idle gap

    def kernel_seconds(self, symbol: str) -> float:
        return sum(s for k, s in self.kernel_s.items() if symbol in k)

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops with the most time, and the idle time by what
        the host was doing, the largest first (seconds as measured)."""
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        idle = collections.Counter()
        for label, s in self.gaps:
            idle[label] += s
        return {"device_ops": [[k[:160], s] for k, s in ops],
                "idle_gaps": [[k[:160], s] for k, s in
                              idle.most_common(top)]}


def reduce(evts) -> Reduced:
    """Read plain records (see `events`); the window is the span of the
    "window" record (the whole trace without one)."""
    win = [e for e in evts if e.cat == "window"]
    if win:
        w0, w1 = min(e.start for e in win), max(e.end for e in win)
    else:
        w0, w1 = min(e.start for e in evts), max(e.end for e in evts)
    device = [(max(e.start, w0), min(e.end, w1)) for e in evts
              if e.cat in ("kernel", "memcpy", "memset")
              and e.end > w0 and e.start < w1]
    busy = _merge(device)
    kernel_s, kernel_count = collections.Counter(), collections.Counter()
    for e in evts:
        if e.cat == "kernel" and e.end > w0 and e.start < w1:
            kernel_s[e.name] += (min(e.end, w1) - max(e.start, w0)) * 1e-6
            kernel_count[e.name] += 1
    launches = sum(1 for e in evts if e.cat == "launch"
                   and w0 <= e.start <= w1)
    # idle gaps inside the window, each labelled by the innermost host
    # op (CPU op or runtime call) running at its midpoint
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    host = sorted((e.start, e.end, e.name) for e in evts
                  if e.cat in ("cpu", "runtime", "launch"))
    starts = [h[0] for h in host]
    gaps = []
    for s, e in holes:
        mid, label = 0.5 * (s + e), "host: no profiled op"
        i = bisect.bisect_right(starts, mid) - 1
        for k in range(i, max(i - SCAN, -1), -1):
            if host[k][1] >= mid:
                label = host[k][2]
                break
        gaps.append((label, (e - s) * 1e-6))
    return Reduced(window_s=(w1 - w0) * 1e-6,
                   busy_s=sum(e - s for s, e in busy) * 1e-6,
                   kernel_s=dict(kernel_s), kernel_count=dict(kernel_count),
                   launches=launches, gaps=gaps)
