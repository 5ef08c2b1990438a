"""The spans table (`portbench/spans.py`) on a synthetic profiler trace
(microseconds): each rule of attribution, the four numbers a frame, and
`trace.reduce`'s readings left as they are; a profiled frame of the port
on the CPU, and on the card (skipped without one) its kernels linked to
their launch calls on one clock."""

import time

import pytest
import torch

from portbench import bench, spans
from portbench import trace as tr
from portbench.tests import _tiny
from portbench.tests.test_portbench_trace import EVENTS

E = spans.Event
# how far a device record may start before its launch call: the card's
# clock and the host's disagreed in some profiled runs on an H100, by up
# to 1.25 us where measured; a span lasts tens of microseconds or more
CLOCK_SKEW_US = 10.0
SPANNED = [
    E("window", tr.WINDOW, 0.0, 100.0, tid=1),
    E("span", "tpt.frame", 1.0, 95.0, tid=1),
    E("span", "tpt.chunk", 2.0, 60.0, tid=1),
    E("span", "tpt.keys", 3.0, 20.0, tid=1),
    E("launch", "cudaLaunchKernel", 4.0, 5.0, corr=11, tid=1),
    # runs on past its span's end: still the key chain's, by its launch
    E("kernel", "xor", 10.0, 30.0, corr=11),
    # after tpt.keys closed: the chunk's own
    E("launch", "cudaLaunchKernel", 21.0, 22.0, corr=12, tid=1),
    E("kernel", "cat", 30.0, 35.0, corr=12),
    E("span", "tpt.kernel_b", 23.0, 25.0, tid=1),
    E("launch", "cudaLaunchKernel", 23.5, 24.0, corr=13, tid=1),
    E("kernel", "mega_kernel", 35.0, 55.0, corr=13),
    E("runtime", "cudaMemcpyAsync", 26.0, 27.0, corr=15, tid=1),
    E("runtime", "cudaStreamSynchronize", 40.0, 55.0, corr=14, tid=1),
    E("memcpy", "Memcpy HtoD", 56.0, 57.0, corr=15),
    E("span", "tpt.film", 70.0, 80.0, tid=1),
    E("launch", "cudaLaunchKernel", 71.0, 72.0, corr=16, tid=1),
    E("kernel", "film", 75.0, 85.0, corr=16),
    # its launch is not in the trace
    E("kernel", "orphan", 88.0, 90.0, corr=99),
    # after the frame, and on a thread with no span
    E("launch", "cudaLaunchKernel", 96.0, 97.0, corr=17, tid=1),
    E("runtime", "cudaDeviceSynchronize", 97.5, 99.0, corr=19, tid=1),
    E("kernel", "after", 97.0, 99.0, corr=17),
    E("launch", "cudaLaunchKernel", 10.0, 11.0, corr=18, tid=2),
    E("kernel", "side", 12.0, 13.0, corr=18),
]


def test_spans_table_rules():
    r = spans.reduce(SPANNED)
    t = r.spans
    us = {n: round(row["device_s"] * 1e6, 6) for n, row in t.items()}
    # innermost span wins; kernels follow their launch's correlation id
    assert us == {"tpt.frame": 0.0, "tpt.chunk": 6.0, "tpt.keys": 20.0,
                  "tpt.kernel_b": 20.0, "tpt.film": 10.0,
                  spans.UNLINKED: 2.0, spans.NONE: 3.0}
    assert {n: row["launches"] for n, row in t.items()} == {
        "tpt.frame": 0, "tpt.chunk": 1, "tpt.keys": 1, "tpt.kernel_b": 1,
        "tpt.film": 1, spans.UNLINKED: 0, spans.NONE: 2}
    assert {n: row["syncs"] for n, row in t.items() if row["syncs"]} == {
        "tpt.chunk": 1, spans.NONE: 1}
    # gaps [0, 10] [55, 56] [57, 75] [85, 88] [90, 97] [99, 100] by their
    # midpoints
    assert {n: round(row["idle_s"] * 1e6, 6) for n, row in t.items()
            if row["idle_s"]} == {"tpt.keys": 10.0, "tpt.chunk": 1.0,
                                  "tpt.frame": 28.0, spans.NONE: 1.0}
    assert {n: row["count"] for n, row in t.items()
            if n.startswith(spans.PREFIX)} == {
        "tpt.frame": 1, "tpt.chunk": 1, "tpt.keys": 1, "tpt.kernel_b": 1,
        "tpt.film": 1}
    # the table holds every device second and launch of the window
    assert sum(row["launches"] for row in t.values()) == r.launches == 6
    assert sum(row["device_s"] for row in t.values()) == pytest.approx(61e-6)
    assert r.breakdown()["spans"] is t
    assert spans.links(SPANNED) == {"linked": 7, "unlinked": 1, "early": 0,
                                   "early_max_us": 0.0}


def test_four_numbers_a_frame():
    got = spans.per_frame(spans.reduce(SPANNED).spans, units=2)
    assert got == pytest.approx({
        "key_chain_ms_per_frame": 0.01, "key_chain_idle_ms_per_frame": 0.005,
        "glue_launches_per_frame": 1.0, "host_syncs_per_frame": 0.5})


def test_nothing_to_read_without_a_frame_and_true_zeros():
    bare = [e for e in SPANNED if e.cat != "span"]
    assert spans.per_frame(spans.reduce(bare).spans, 1) is None
    quiet = [E("window", tr.WINDOW, 0.0, 10.0, tid=1),
             E("span", "tpt.frame", 0.0, 10.0, tid=1),
             E("launch", "cudaLaunchKernel", 1.0, 2.0, corr=1, tid=1),
             E("kernel", "k", 2.0, 3.0, corr=1)]
    got = spans.per_frame(spans.reduce(quiet).spans, 1)
    assert got == {"key_chain_ms_per_frame": 0.0,
                   "key_chain_idle_ms_per_frame": 0.0,
                   "glue_launches_per_frame": 1.0,
                   "host_syncs_per_frame": 0.0}


def test_spans_leave_the_trace_readings_as_they_are():
    """trace.py's synthetic trace with spans added: the busy time,
    launches, kernel times and gap labels of trace.reduce without them."""
    plain = tr.reduce(EVENTS)
    spanned = [E(*e) for e in EVENTS] + [
        E("span", "tpt.frame", 0.0, 100.0), E("span", "tpt.keys", 0.0, 60.0),
        E("span", "tpt.chunk", 76.0, 92.0)]
    r = spans.reduce(spanned)
    assert r.busy_s == plain.busy_s and r.launches == plain.launches
    assert r.kernel_s == plain.kernel_s and r.gaps == plain.gaps
    assert r.window_s == plain.window_s
    b = r.breakdown()
    assert {k: b[k] for k in ("device_ops", "idle_gaps")} == plain.breakdown()
    # without correlation ids every device record is unlinked
    assert set(b["spans"]) == {"tpt.frame", "tpt.keys", "tpt.chunk",
                               spans.UNLINKED}
    assert b["spans"]["tpt.chunk"]["idle_s"] == pytest.approx(5e-6)


def test_spans_of_a_profiled_frame_on_the_cpu():
    """The port's spans reach `events` as "span" records from the
    profiler, and on the CPU (no device records) the table holds their
    counts and the frame's four numbers read 0."""
    import tinypathtracer_tpu_torch as T
    from portbench import scenes

    torch.set_num_threads(2)
    cell = _tiny.cell()
    rcfg = T.RenderConfig(**scenes.render_args(cell.config))
    dev = torch.device("cpu")
    scene = T.FlatScene.from_numpy(scenes.build(cell.config), dev)
    renderer = T.Renderer(rcfg, device=dev)
    _, evts = spans.profiled(lambda: renderer.render(scene, T.prng_key(3)),
                             dev)
    assert not [e for e in evts if e.cat == "cpu"
                and e.name.startswith(spans.PREFIX)]
    t = spans.reduce(evts).spans
    chunks = -(-rcfg.n_pixels // (rcfg.rays_per_dispatch // rcfg.spp))
    assert {n: row["count"] for n, row in t.items()} == {
        "tpt.frame": 1, "tpt.prepare": 1, "tpt.chunk": chunks,
        "tpt.keys": 2 * chunks, "tpt.kernel_b": chunks, "tpt.film": 1}
    assert set(spans.per_frame(t, 1).values()) == {0.0}


@pytest.mark.card
def test_spans_on_the_card():
    """A small Cornell frame profiled on the card: every kernel, copy
    and set finds its launch call, none starts more than CLOCK_SKEW_US
    before it (the spans and the device share one clock, to that), and
    the table holds the window's device seconds and launch calls."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import tinypathtracer_tpu_torch as T
    from portbench import scenes
    from portbench.kinds import frame

    dev = torch.device("cuda", 0)
    cell = _tiny.cell()
    rcfg = T.RenderConfig(**scenes.render_args(cell.config))
    scene = T.FlatScene.from_numpy(scenes.build(cell.config), dev)
    renderer = T.Renderer(rcfg, device=dev)
    job = bench.Run(cell=cell, seed=7, seconds=0.0, trace=True, device=dev,
                    start=time.time())
    frame._render(renderer, scene, frame.frame_key(7, 0, dev), job)
    key = frame.frame_key(7, 1, dev)
    _, evts = spans.profiled(lambda: frame._render(renderer, scene, key, job),
                             dev)
    r = spans.reduce(evts)
    got = spans.links(evts)
    assert got["unlinked"] == 0 and got["linked"] > 0, got
    assert got["early_max_us"] < CLOCK_SKEW_US, got
    window = [e for e in evts if e.cat == "window"][0]
    device_s = sum((min(e.end, window.end) - max(e.start, window.start))
                   * 1e-6 for e in evts if e.cat in spans.DEVICE
                   and e.end > window.start and e.start < window.end)
    table = r.spans
    assert sum(row["device_s"] for row in table.values()) == \
        pytest.approx(device_s, rel=0.01)
    assert sum(row["launches"] for row in table.values()) == r.launches
    assert table["tpt.frame"]["count"] == 1
    assert table["tpt.kernel_b"]["device_s"] > 0.0
    numbers = spans.per_frame(table, 1)
    assert numbers["key_chain_ms_per_frame"] > 0.0
    assert numbers["glue_launches_per_frame"] > 0.0
