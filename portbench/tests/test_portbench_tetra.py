"""The configuration `spd-tetra` and its cell `tetra-frame`: the SPD
tetra builder is a file found by name, the reference computes its
scene, the kernel C reader reads a trace, and a tiny cell of the same
files runs correct on the CPU, and on the card (`-m card`) through
kernel C and never kernel B."""

import json
import time
import types

import pytest
import torch

from portbench import bench, run, scenes
from portbench import trace as tr
from portbench.reference import tracer
from portbench.tests import _tiny

CELL = "tetra-frame"
E = tr.Event


def config() -> dict:
    return bench.Cell.load(CELL).config


def test_spd_tetra_is_a_builder_found_by_name():
    build = scenes.builder("spd.tetra")
    assert build.__code__.co_filename == str(scenes.BUILDERS /
                                             "spd.tetra.py")
    arrays = scenes.build(config())
    cornell = scenes.build(json.loads(
        (bench.ROOT / "portbench/configs/cornell.json").read_text()))
    assert list(arrays) == list(cornell)
    assert arrays["indices"].shape == (16384, 3)
    assert arrays["env_radiance"][0, 0].tolist() == pytest.approx(
        [0.078, 0.361, 0.753])


def test_the_reference_computes_the_scene():
    """128 clusters of 128 slots, each with its box: no triangle spans a
    tenth of the scene."""
    tab = tracer.Tables.build(scenes.build(config()), "cpu")
    assert tab.n_faces == 16384
    assert [(e - s, box is not None) for s, e, box in tab.clusters] \
        == [(128, True)] * 128


def test_the_cell_lists_its_metrics():
    c = bench.Cell.load(CELL)
    assert c.chips == 1 and c.traffic["kind"] == "frame"
    assert {m["name"] for m in c.per_layer} == {
        "kernel_c_ms_per_frame", "launches_per_frame",
        "device_idle_pct.frame"}
    assert {m["name"] for m in c.end_to_end} == {"frame_rays_per_s",
                                                 "setup_s"}


def test_kernel_c_reader():
    trace = tr.reduce([E("window", tr.WINDOW, 0.0, 100.0),
                       E("launch", "cudaLaunchKernel", 1.0, 2.0),
                       E("kernel", "packet_hit_kernel(float const*)",
                         10.0, 40.0),
                       E("kernel", "mega_kernel", 50.0, 60.0)])
    ctx = types.SimpleNamespace(trace=trace, units=2, work=None)
    assert bench.reader("kernel_c_ms_per_frame")(ctx) == pytest.approx(0.015)
    none = tr.reduce([E("window", tr.WINDOW, 0.0, 10.0),
                      E("kernel", "mega_kernel", 1.0, 2.0)])
    ctx = types.SimpleNamespace(trace=none, units=1, work=None)
    assert bench.reader("kernel_c_ms_per_frame")(ctx) is None


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_tetra_cell_runs_correct(trace):
    """The cell's own files at 16 x 11 @64 spp d4 in chunks of 32
    pixels: the frame runs through the packet route's twins, and the
    sampled pixels equal the reference's."""
    out = _tiny.execute(_tiny.cell(CELL), trace=trace, frames=1)
    assert out["failed"] == 0 and out["correct"], out["checks"]
    assert out["checks"]["pixels_off"]["value"] == 0.0


@pytest.mark.card
def test_tiny_tetra_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = run.execute(_tiny.cell(CELL), 7, 0.01, 1, torch.device("cuda", 0),
                      time.time())
    assert out["correct"], out["checks"]
    assert out["metrics"]["kernel_c_ms_per_frame"]["value"] > 0.0
    ops = [name for name, _ in out["breakdown"]["device_ops"]]
    assert not any("mega_kernel" in name for name in ops), ops
