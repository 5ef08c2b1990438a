"""BENCHMARK.json against the contract's form, and every file a cell or
metric names found by name."""

import json
import re

import pytest

from portbench import bench

SPEC = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in SPEC["command"])


def test_names_units_and_keys():
    spec = SPEC
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in spec["end_to_end"]]
        assert m["workloads"] and set(m["workloads"]) <= cells
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_found_by_name(cell):
    c = bench.Cell.load(cell)
    assert c.traffic["kind"] == "frame"
    assert bench.kind(c.traffic["kind"]).run
    assert c.limits and all(v >= 0 for v in c.limits.values())
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert callable(bench.reader(m["name"]))
        assert m["moves"] in reported


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    data = json.loads((bench.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert sorted(data["reduced"]) == sorted(conf["reduced"])
    assert set(data["assumed"])


def test_cornell_box_as_published():
    """The configuration's scene is the source's: 19 quads (the ceiling
    cut around the light), 38 triangles, 5 of them white blocks' tops and
    sides over 0.33 m at most, the camera at (278, 273, -800) mm looking
    along +z with a 0.025 film at 0.035."""
    data = json.loads((bench.ROOT / "portbench/configs/cornell.json")
                      .read_text())
    from portbench import scenes

    arrays = scenes.build(data)
    assert arrays["indices"].shape == (38, 3)
    assert abs(arrays["cam_yfov"] - 0.6860478808) < 1e-9
    assert arrays["cam_to_world"][:3, 3].tolist() == pytest.approx(
        [0.278, 0.273, -0.8])
    light = [q for q in data["scene"]["quads"] if q["material"] == "light"]
    assert len(light) == 1
    ceiling = [q for q in data["scene"]["quads"]
               if q["name"].startswith("ceiling")]
    area = sum((max(v[0] for v in q["vertices"]) - min(v[0] for v in
                                                        q["vertices"]))
               * (max(v[2] for v in q["vertices"])
                  - min(v[2] for v in q["vertices"])) for q in ceiling)
    assert area + 0.13 * 0.105 == pytest.approx(0.556 * 0.5592)


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        bench.Cell.load("no-such-cell")
