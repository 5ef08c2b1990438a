"""Build and load the port's CUDA kernels.

Each kernel source `csrc/<name>.cu` (plus the shared headers in
`csrc/`) is compiled by `nvcc` into a shared library with a plain C
interface, at first use, into `_build/` inside the package, under a
file name keyed by a hash of the sources and flags; it is loaded with
`ctypes`. Nothing here runs at import time: this module is imported on
machines that have no CUDA toolkit.

Flags: `sm_90a` (Hopper), IEEE division and square root (no
`--use_fast_math`: IEEE `/` and NaN rejection are part of the hit
contract), and `--fmad=false`, so the compiler fuses no multiply-add by
itself; the kernels fuse exactly where they say so (`fmaf`), which keeps
them bit-equal to their plain PyTorch twins.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _library(name: str) -> Path:
    """The shared library of `csrc/<name>.cu`, named by a hash of its
    source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_libraries(names) -> None:
    """Compile the libraries of `csrc/<name>.cu` for every name that is
    not built yet, one nvcc process each, all running at once."""
    procs = []
    for name in names:
        lib = _library(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs.append((name, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{err}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


def build_variants(name: str, variants, bind=lambda lib: lib,
                   flags=()) -> dict:
    """{variant: bind(library)} of builds of `csrc/<name>.cu` with the
    text edits `variants` lists ({variant: [(text, replacement), ...]},
    each text found in the source exactly once), compiled at once (one
    nvcc each) under `_build/variants/`; nvcc's messages (with `flags`
    such as `-Xptxas -v`) go to `<name>_<variant>.log` there. The labs'
    `--variants` builds."""
    src = (CSRC / f"{name}.cu").read_text()
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for var, edits in variants.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {var}: {old!r} is not in "
                                 f"csrc/{name}.cu exactly once")
            text = text.replace(old, new)
        (out / f"{name}_{var}.cu").write_text(text)
        procs[var] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *flags, f"-I{CSRC}", "-o",
             str(out / f"lib{name}_{var}.so"), str(out / f"{name}_{var}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, proc in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}_{var}.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {var}:\n{log}")
        libs[var] = bind(ctypes.CDLL(str(out / f"lib{name}_{var}.so")))
    return libs


def variant_resources(name: str, variant: str) -> list:
    """The register and spill lines nvcc's `-Xptxas -v` wrote for a
    build_variants build."""
    log = (BUILD_DIR / "variants" / f"{name}_{variant}.log").read_text()
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load `csrc/<name>.cu`."""
    build_libraries([name])
    return ctypes.CDLL(str(_library(name)))


def check_launch(status: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {status}")


def check_operands(*tensors: torch.Tensor) -> None:
    """Validate kernel operands: float32, contiguous, 16-byte aligned (the
    kernels load planes as float4), on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if (t.device != dev or dev.type != "cuda" or not t.is_contiguous()
                or t.dtype != torch.float32 or t.data_ptr() % 16):
            raise ValueError(
                "kernel operands must be contiguous, 16-byte aligned float32 "
                f"tensors on one CUDA device (got {t.dtype} on {t.device}, "
                f"contiguous={t.is_contiguous()}, address {t.data_ptr():#x})")


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
