"""The plain references of the port's estimators, one module a
configuration's `mode`, found by `for_mode`: "reference" is tracer.py,
any other mode the module <mode>.py here. A new estimator's reference is
a new file, and nothing here is edited.

Each module exposes what the frame kind and the readings call:
`Tables.build(arrays, device)`, which raises ValueError for a scene it
cannot compute, and `render_pixels(tab, key, pix, width, height, spp,
depth, tf32=False, stats=None)`, the mean radiance [P, 3] of pixel ids
pix. Frame keys are tracer.py's (`prng_key`, `fold_in`) whatever the
mode, since every estimator shares the threefry chain; a mode's module
may import its sibling by relative import (`from . import tracer`).
Each imports torch, numpy and the standard library only.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
# modes whose module is not named after them
MODULES = {"reference": "tracer"}


def for_mode(mode: str):
    """The plain reference module of an estimator mode; a mode with no
    module exits, naming the file looked for."""
    name = MODULES.get(mode, mode)
    path = HERE / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z][A-Za-z0-9_]*", name) or \
            not path.is_file():
        raise SystemExit(f"no plain reference for mode {mode!r}: looked "
                         f"for {path}")
    return importlib.import_module(f"{__name__}.{name}")
