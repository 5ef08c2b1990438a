"""What every cell of the benchmark shares: finding a cell's files by
name, the clock, the card, the check that no JAX module was loaded, and
the result line.

A cell is an entry of `workloads` in BENCHMARK.json; its configuration
is `configs/<config>.json` (`file` in BENCHMARK.json), its traffic mix
`traffic/<traffic>.json`, whose "kind" names the runner
`kinds/<kind>.py`, the limits of its comparison `limits/<cell>.json`,
and each of its per-layer metrics a reader `metrics/<metric>.py`.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# what a benchmark run may not have loaded: compared by whole top-level
# module names (the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "tinypathtracer_tpu")
# build and kernel caches the program could use, at fixed paths inside
# the checkout (listed in .gitignore)
CACHE_DIR = ROOT / ".portbench_cache"


def process_start() -> float:
    """time.time() of this process's start (/proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs() -> None:
    """Point every build and kernel cache at fixed directories inside
    the checkout. The port builds its kernels into
    tinypathtracer_tpu_torch/_build/, also inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE_DIR / sub)


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def read_spec() -> dict:
    """BENCHMARK.json."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    """One cell of BENCHMARK.json with its files read."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list        # the cell's end-to-end metric entries
    per_layer: list         # the cell's per-layer metric entries

    @staticmethod
    def load(name: str) -> "Cell":
        """The cell of BENCHMARK.json called name."""
        spec = read_spec()
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        w = cells[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        return Cell(
            name=name,
            config=json.loads((ROOT / conf["file"]).read_text()),
            traffic=json.loads((HERE / "traffic" /
                                f"{w['traffic']}.json").read_text()),
            limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
            chips=w["chips"],
            end_to_end=[m for m in spec["end_to_end"] if mine(m)],
            per_layer=[m for m in spec["per_layer"] if mine(m)])


def kind(name: str):
    """The runner module of a traffic kind: kinds/<name>.py."""
    return importlib.import_module(f"portbench.kinds.{name}")


def reader(metric: str):
    """The read(ctx) function of metrics/<metric>.py (a name may hold
    dots, so the file is loaded by its path)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What a run is asked: the cell, seed, window and trace flag, the
    device, and the process's start."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    start: float

    def since_start(self) -> float:
        return time.time() - self.start

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind's runner hands back."""

    attempted: int
    failed: int
    end_to_end: dict        # metric name -> value (what the runner measured)
    layer_ctx: object       # what the per-layer readers read (trace runs)
    numbers: dict           # compared number -> value
    memory_peak_bytes: int
    busy_s: float = None
    window_s: float = None
    breakdown: dict = None


def card_line() -> str:
    """nvidia-smi's name, power limit and SM clock of the card, or ""."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def peak_bytes(device) -> int:
    """The card's peak allocation since the last reset (0 on the CPU)."""
    import torch
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def log(run, msg: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started."""
    log_at(run.start, msg)


def log_at(start: float, msg: str) -> None:
    print(f"portbench [{time.time() - start:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
