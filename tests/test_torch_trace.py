"""The port's spans (`utils/metrics.span`) on the CPU: a profiled frame
records `tpt.frame` holding `tpt.prepare`, one `tpt.chunk` a chunk (each
with its `tpt.keys` and, on the megakernel's route, its `tpt.kernel_b`;
on the packet route one `tpt.bounce` a bounce of the modular loop, each
with one `tpt.kernel_c` a closest-hit query) and `tpt.film`, nested by
their intervals in the profiler's trace; with no profiler a span is one
shared null context and enters no profiler op; the image does not
depend on the profiler.
"""

import contextlib
import dataclasses
import json
import os

import pytest
import torch

from tinypathtracer_tpu_torch import (RenderConfig, Renderer, prng_key,
                                      trace_profile)
from tinypathtracer_tpu_torch.ops import packet
from tinypathtracer_tpu_torch.render import integrator
from tinypathtracer_tpu_torch.utils import metrics

from _torch_scenes import jax_scene, port_scene

torch.set_num_threads(2)

# 8 x 6 pixels at 2 spp in dispatches of 32 lanes: 3 chunks of 16 pixels
CFG = RenderConfig(width=8, height=6, spp=2, max_depth=3,
                   rays_per_dispatch=32)
CHUNKS = 3
# the same frame on the packet traversal (kernel C's twin) under the
# modular loop
PACKET = dataclasses.replace(CFG, intersector="packet")


@pytest.fixture(scope="module")
def scene():
    return port_scene(jax_scene())


def _profiled(fn):
    """(fn()'s result, the tpt.* spans it recorded as (name, start, end)
    in nanoseconds, ordered by start)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.name().startswith("tpt.")),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _inside(spans, outer, name=None):
    """The spans of `spans` within the interval of `outer` (itself left
    out), of one name if given."""
    return [s for s in spans if s is not outer
            and outer[1] <= s[1] and s[2] <= outer[2]
            and (name is None or s[0] == name)]


def test_megakernel_frame_spans_nest(scene):
    _, spans = _profiled(
        lambda: Renderer(CFG, device="cpu").render(scene, prng_key(3)))
    frames = [s for s in spans if s[0] == "tpt.frame"]
    assert len(frames) == 1
    within = _inside(spans, frames[0])
    assert len(within) == len(spans) - 1
    assert [s[0] for s in within if s[0] in ("tpt.prepare", "tpt.film")] \
        == ["tpt.prepare", "tpt.film"]
    chunks = _inside(spans, frames[0], "tpt.chunk")
    assert len(chunks) == CHUNKS
    for chunk in chunks:
        assert len(_inside(spans, chunk, "tpt.keys")) == 2
        assert len(_inside(spans, chunk, "tpt.kernel_b")) == 1
    counts = {n: sum(s[0] == n for s in spans) for n in
              ("tpt.keys", "tpt.kernel_b", "tpt.prepare", "tpt.film")}
    assert counts == {"tpt.keys": 2 * CHUNKS, "tpt.kernel_b": CHUNKS,
                      "tpt.prepare": 1, "tpt.film": 1}


def test_modular_route_draws_keys_once_a_bounce(scene, monkeypatch):
    """Off the megakernel, tpt.keys is the camera's hashing in each chunk
    and the draw of each bounce the loop runs (the loop stops early
    once every lane is dead: bounces are counted by env_miss, called
    once a bounce)."""
    bounces = []
    env_miss = integrator.env_miss

    def counted(*args):
        bounces.append(1)
        return env_miss(*args)

    monkeypatch.setattr(integrator, "env_miss", counted)
    cfg = dataclasses.replace(CFG, megakernel=False)
    _, spans = _profiled(
        lambda: Renderer(cfg, device="cpu").render(scene, prng_key(3)))
    chunks = [s for s in spans if s[0] == "tpt.chunk"]
    keys = [s for s in spans if s[0] == "tpt.keys"]
    assert len(chunks) == CHUNKS and CHUNKS <= len(bounces) <= \
        CHUNKS * cfg.max_depth
    assert len(keys) == CHUNKS + len(bounces)
    assert all(any(c[1] <= k[1] and k[2] <= c[2] for c in chunks)
               for k in keys)
    assert not any(s[0] == "tpt.kernel_b" for s in spans)


def test_span_off_is_one_shared_null_context(scene, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert metrics.span("tpt.frame") is metrics.span("tpt.keys")
    assert isinstance(metrics.span("tpt.frame"), contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"a profiler op was entered for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    img = Renderer(CFG, device="cpu").render(scene, prng_key(3))
    assert bool(torch.isfinite(img).all())


def test_profiled_frame_is_bit_equal(scene):
    plain = Renderer(CFG, device="cpu").render(scene, prng_key(4))
    traced, spans = _profiled(
        lambda: Renderer(CFG, device="cpu").render(scene, prng_key(4)))
    assert spans and torch.equal(plain, traced)


def test_progressive_step_records_a_frame(scene):
    prog = Renderer(CFG, device="cpu").progressive()
    _, spans = _profiled(lambda: prog.step(scene, prng_key(5), 1))
    names = [s[0] for s in spans]
    assert names.count("tpt.frame") == 1 and "tpt.chunk" in names
    assert len(_inside(spans, spans[0])) == len(spans) - 1


def test_trace_profile_writes_the_spans(scene, tmp_path):
    logdir = str(tmp_path / "prof")
    with trace_profile(logdir):
        Renderer(CFG, device="cpu").render(scene, prng_key(6))
    with open(os.path.join(logdir, "trace.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for name in ("tpt.frame", "tpt.prepare", "tpt.chunk", "tpt.keys",
                 "tpt.kernel_b", "tpt.film"):
        assert name in names, name


def _counted(monkeypatch, owner, name, calls):
    """owner.name patched to append 1 to calls at each call."""
    orig = getattr(owner, name)

    def call(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(owner, name, call)


def test_packet_route_spans_each_bounce_and_query(scene, monkeypatch):
    """On the packet route each bounce the loop runs is one tpt.bounce
    inside its chunk (bounces counted by env_miss, called once a
    bounce), and each closest-hit query one tpt.kernel_c inside its
    bounce (queries counted by the twin's calls): two a bounce, the next
    direction and the estimator's extra ray, the scene having no delta
    light."""
    bounces, queries = [], []
    _counted(monkeypatch, integrator, "env_miss", bounces)
    _counted(monkeypatch, packet, "_packet_torch", queries)
    _, spans = _profiled(
        lambda: Renderer(PACKET, device="cpu").render(scene, prng_key(3)))
    chunks = [s for s in spans if s[0] == "tpt.chunk"]
    bounce = [s for s in spans if s[0] == "tpt.bounce"]
    kernel_c = [s for s in spans if s[0] == "tpt.kernel_c"]
    assert len(chunks) == CHUNKS
    assert CHUNKS <= len(bounces) <= CHUNKS * PACKET.max_depth
    assert len(bounce) == len(bounces)
    assert len(kernel_c) == len(queries) == 2 * len(bounces)
    assert sum(len(_inside(spans, c, "tpt.bounce")) for c in chunks) \
        == len(bounce)
    assert [len(_inside(spans, b, "tpt.kernel_c")) for b in bounce] \
        == [2] * len(bounce)
    assert not any(s[0] == "tpt.kernel_b" for s in spans)


def test_packet_route_span_off_enters_no_profiler_op(scene, monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def refuse(name):
        raise AssertionError(f"a profiler op was entered for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    img = Renderer(PACKET, device="cpu").render(scene, prng_key(3))
    assert bool(torch.isfinite(img).all())


def test_packet_route_profiled_frame_is_bit_equal(scene):
    plain = Renderer(PACKET, device="cpu").render(scene, prng_key(4))
    traced, spans = _profiled(
        lambda: Renderer(PACKET, device="cpu").render(scene, prng_key(4)))
    assert any(s[0] == "tpt.kernel_c" for s in spans)
    assert any(s[0] == "tpt.bounce" for s in spans)
    assert torch.equal(plain, traced)
