"""The native host library through ctypes (port of
`tinypathtracer_tpu/utils/native.py`): the LBVH builder and the base64
decoder of glTF data URIs.

The C++ source is the repository's `csrc/tpt_native.cpp` (read, never
changed here), compiled with g++ at first use into the port's `_build/`
under a name keyed by a hash of the source and flags. No fallback: if
the library does not build, `build_lbvh_host` and `b64_decode` raise
(`RenderConfig(bvh_source="device")` is the explicit alternative to the
first). The JAX package falls back to the standard library's decoder
without saying so; the port does not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from tinypathtracer_tpu_torch.utils.cuda_build import BUILD_DIR

SRC = BUILD_DIR.parents[1] / "csrc" / "tpt_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


@functools.cache
def _lib() -> ctypes.CDLL:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    lib = BUILD_DIR / f"libtpt_native-{h.hexdigest()[:16]}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{proc.stderr}")
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    cdll.tpt_build_lbvh.restype = ctypes.c_int
    cdll.tpt_build_lbvh.argtypes = [fp, ctypes.c_int] + [ip] * 4 + [fp] * 2
    cdll.tpt_b64_decode.restype = ctypes.c_longlong
    cdll.tpt_b64_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_ubyte)]
    return cdll


def b64_decode(payload: str) -> bytes:
    """Decode a base64 payload (a glTF data URI's text after the comma)."""
    raw = payload.encode("ascii")
    out = np.empty(len(raw) * 3 // 4 + 3, dtype=np.uint8)
    n = _lib().tpt_b64_decode(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if n < 0:
        raise ValueError("invalid base64 payload")
    return out[:n].tobytes()


def build_lbvh_host(tri_verts: np.ndarray) -> dict:
    """Host LBVH build of [F, 3, 3] float32 triangles, with the topology
    rules of `ops/lbvh.build_lbvh`. Returns the numpy arrays left, right,
    parent, leaf_fid, bmin, bmax in the device layout."""
    tv = np.ascontiguousarray(tri_verts, dtype=np.float32)
    f = tv.shape[0]
    out = dict(left=np.empty(max(f - 1, 1), np.int32),
               right=np.empty(max(f - 1, 1), np.int32),
               parent=np.empty(2 * f - 1, np.int32),
               leaf_fid=np.empty(f, np.int32),
               bmin=np.empty((2 * f - 1, 3), np.float32),
               bmax=np.empty((2 * f - 1, 3), np.float32))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    rc = _lib().tpt_build_lbvh(
        tv.ctypes.data_as(fp), f,
        *(out[k].ctypes.data_as(ip)
          for k in ("left", "right", "parent", "leaf_fid")),
        out["bmin"].ctypes.data_as(fp), out["bmax"].ctypes.data_as(fp))
    if rc != 0:
        raise RuntimeError(f"tpt_build_lbvh failed: {rc}")
    return out
