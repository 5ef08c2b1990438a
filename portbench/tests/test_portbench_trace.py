"""Idle share, kernel times, launch counts and gap labels on a
synthetic profiler trace (microseconds)."""

import types

import pytest

from portbench import bench
from portbench import trace as tr

E = tr.Event
EVENTS = [
    E("window", tr.WINDOW, 0.0, 100.0),
    E("cpu", "aten::mul", 0.0, 12.0),
    E("launch", "cudaLaunchKernel", 1.0, 2.0),
    E("kernel", "void tpt::mega_kernel<0>(float*)", 10.0, 40.0),
    E("launch", "cudaLaunchKernel", 3.0, 4.0),
    E("kernel", "elementwise_kernel", 35.0, 50.0),   # overlaps the first
    E("cpu", "aten::nonzero", 50.0, 75.0),
    E("runtime", "cudaStreamSynchronize", 55.0, 74.0),
    E("memcpy", "Memcpy DtoH", 74.0, 75.0),
    E("kernel", "packet_hit_kernel", 80.0, 90.0),
    E("launch", "cuLaunchKernel", 79.0, 80.0),
    E("launch", "cudaLaunchKernel", 150.0, 151.0),    # outside the window
    E("kernel", "late", 150.0, 160.0),
]


def test_reduce_synthetic_trace():
    r = tr.reduce(EVENTS)
    assert r.window_s == pytest.approx(100e-6)
    # busy: [10, 50] + [74, 75] + [80, 90] = 51 us
    assert r.busy_s == pytest.approx(51e-6)
    assert r.idle_pct() == pytest.approx(49.0)
    assert r.launches == 3
    assert r.kernel_seconds("mega_kernel") == pytest.approx(30e-6)
    assert r.kernel_count["packet_hit_kernel"] == 1
    labels = dict(r.gaps)
    # gaps [0, 10], [50, 74], [75, 80], [90, 100]
    assert [round(s * 1e6) for _, s in r.gaps] == [10, 24, 5, 10]
    assert r.gaps[0][0] == "aten::mul"
    assert r.gaps[1][0] == "cudaStreamSynchronize"
    assert "host: no profiled op" in labels
    b = r.breakdown()
    assert b["device_ops"][0][0].startswith("void tpt::mega_kernel")
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_metric_readers_on_the_trace():
    ctx = types.SimpleNamespace(trace=tr.reduce(EVENTS), units=2,
                                work=(67e12 * 15e-6, 0.0))
    assert bench.reader("launches_per_frame")(ctx) == 1.5
    assert bench.reader("device_idle_pct.frame")(ctx) == pytest.approx(49.0)
    # least time 15 us a frame, 2 frames, kernel B 30 us: 100 %
    assert bench.reader("kernel_b_roofline_pct")(ctx) == pytest.approx(100.0)


def test_readers_find_nothing_to_read():
    empty = tr.reduce([E("window", tr.WINDOW, 0.0, 10.0),
                       E("cpu", "aten::add", 0.0, 5.0)])
    ctx = types.SimpleNamespace(trace=empty, units=1, work=None)
    for name in ("kernel_b_roofline_pct", "launches_per_frame",
                 "device_idle_pct.frame"):
        assert bench.reader(name)(ctx) is None


def test_a_listed_metric_that_reads_nothing_fails_the_run():
    """A traced run on the card whose listed per-layer metric finds
    nothing to read (a kernel renamed or taken off the path) exits with
    an error and no result, rather than leaving the metric out unseen;
    on the CPU, whose kernel twins leave no names, the metric is left
    out."""
    from portbench import run
    from portbench.tests import _tiny

    trace = tr.reduce([E("window", tr.WINDOW, 0.0, 10.0),
                       E("launch", "cudaLaunchKernel", 0.5, 1.0),
                       E("kernel", "elementwise_kernel", 1.0, 2.0)])
    ctx = types.SimpleNamespace(trace=trace, units=1, work=(1e9, 1e6))
    with pytest.raises(SystemExit, match="kernel_b_roofline_pct read "
                                         "nothing"):
        run.layer_metrics(_tiny.cell(), ctx)
    got = run.layer_metrics(_tiny.cell(), ctx, strict=False)
    assert sorted(got) == ["device_idle_pct.frame", "launches_per_frame"]
