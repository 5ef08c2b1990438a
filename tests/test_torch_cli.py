"""The port's render CLI (`tools/render_cli.py`) and metrics
(`utils/metrics.py`) on the CPU, on the textured quad glTF of
tests/_torch_scenes.py.

The CLI's PNG equals the in-process one-shot `render` + `write_png`
byte for byte (and the AOV's, `render_aov` flipped to top-down rows);
--stats prints the JSON of a RenderStats with the JAX package's keys;
--shard with no COORDINATOR_ADDRESS renders on a one-rank mesh the
unsharded PNG (tests/test_torch_shard.py runs it on two ranks); the
profiler context writes a Chrome trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from tinypathtracer_tpu.utils.metrics import RenderStats as JaxRenderStats
from tinypathtracer_tpu_torch import (RenderConfig, Renderer, StageTimer,
                                      load_scene, prng_key, render,
                                      render_aov, timed_render, trace_profile)
from tinypathtracer_tpu_torch.models.envlight import gradient_sky
from tinypathtracer_tpu_torch.render import film
from tinypathtracer_tpu_torch.tools import render_cli

from _torch_scenes import write_textured_quad

torch.set_num_threads(2)

ARGS = ["--width", "16", "--height", "12", "--spp", "2", "--depth", "3",
        "--seed", "5", "--device", "cpu"]
CFG = RenderConfig(width=16, height=12, spp=2, max_depth=3)


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    return write_textured_quad(tmp_path_factory.mktemp("cli"))


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_cli_png_equals_render(quad, tmp_path, capsys):
    out = str(tmp_path / "cli.png")
    render_cli.main(["--scene", quad, "--out", out] + ARGS)
    assert capsys.readouterr().out.strip() == out
    img = render(load_scene(quad), CFG, prng_key(5),
                 env_radiance=gradient_sky(64, 128), device="cpu")
    ref = str(tmp_path / "ref.png")
    film.write_png(ref, img)
    assert _bytes(out) == _bytes(ref)


@pytest.mark.parametrize("kind", ["normal", "depth", "hitmask"])
def test_cli_aov(quad, tmp_path, kind):
    out = str(tmp_path / f"{kind}.png")
    render_cli.main(["--scene", quad, "--out", out, "--aov", kind] + ARGS)
    flat = load_scene(quad).flatten(gradient_sky(64, 128), device="cpu")
    ref = str(tmp_path / "ref.png")
    film.write_png(ref, render_aov(flat, CFG, prng_key(5), kind,
                                        device="cpu").flip(0))
    assert _bytes(out) == _bytes(ref)
    from PIL import Image

    assert np.asarray(Image.open(out)).max() > 0


@pytest.mark.parametrize("aov", [[], ["--aov", "depth"]])
def test_cli_stats_keys_equal_jax(quad, tmp_path, capsys, aov):
    render_cli.main(["--scene", quad, "--out", str(tmp_path / "s.png"),
                     "--stats"] + aov + ARGS)
    stats = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    want = json.loads(JaxRenderStats(16, 12, 2, 3, 1.0).to_json())
    assert set(stats) == set(want)
    assert stats["primary_rays"] == 16 * 12 * 2 and stats["seconds"] > 0
    assert stats["rays_per_s"] > 0


def test_cli_shard_exits_naming_the_roadmap_item(quad, tmp_path, monkeypatch):
    """--shard in one process: a one-rank gloo group (no variable set),
    the PNG of the unsharded CLI byte for byte, the group torn down."""
    import torch.distributed as dist

    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    out, ref = str(tmp_path / "x.png"), str(tmp_path / "ref.png")
    render_cli.main(["--scene", quad, "--out", out, "--shard"] + ARGS)
    assert not dist.is_initialized()
    render_cli.main(["--scene", quad, "--out", ref] + ARGS)
    assert _bytes(out) == _bytes(ref)


def test_cli_tile_pixels_is_accepted(quad, tmp_path):
    out = str(tmp_path / "t.png")
    render_cli.main(["--scene", quad, "--out", out, "--tile-pixels", "64"]
                    + ARGS)
    assert os.path.getsize(out) > 0


def test_cli_default_device_is_the_card():
    assert render_cli.build_parser().parse_args(
        ["--scene", "x.gltf"]).device == "cuda"


def test_timed_render_and_stage_timer(quad):
    flat = load_scene(quad).flatten(gradient_sky(16, 32), device="cpu")
    r = Renderer(CFG, device="cpu")
    img, stats = timed_render(r, flat, prng_key(0))
    assert img.shape == (12, 16, 3) and stats.seconds > 0
    assert stats.rays_per_s == stats.primary_rays / stats.seconds
    parsed = json.loads(stats.to_json())
    assert parsed["width"] == 16 and parsed["spp"] == 2
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("render", sync_on=img):
            r.render(flat, prng_key(1))
    assert set(timer.stages) == {"render"} and timer.stages["render"] > 0


def test_trace_profile_writes_a_trace(quad, tmp_path):
    flat = load_scene(quad).flatten(gradient_sky(16, 32), device="cpu")
    logdir = str(tmp_path / "prof")
    with trace_profile(logdir):
        Renderer(CFG, device="cpu").render(flat, prng_key(0))
    with open(os.path.join(logdir, "trace.json")) as f:
        trace = json.load(f)
    assert len(trace["traceEvents"]) > 0
    with trace_profile(None):
        pass
