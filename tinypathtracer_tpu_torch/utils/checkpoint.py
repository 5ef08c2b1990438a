"""Checkpoint / resume (port of `tinypathtracer_tpu/utils/checkpoint.py`).

Two checkpointable states:

  * progressive rendering (`ProgressiveRender`): the radiance sum and the
    samples done. Samples are indexed, not drawn from a mutable RNG
    state, so a resumed run continues the same sample sequence and ends
    on the image an uninterrupted run gives, bit for bit;
  * inverse rendering: `Params` and `AdamState` (`save_pytree`).

The files are the JAX package's .npz layout: `leaf_{i}` in flatten
order (a dataclass's fields in declaration order, a dict's keys sorted),
`__meta__` JSON and `__treedef__`, a structure string checked on load.
A file the JAX package wrote loads here: the port cannot reproduce
JAX's treedef string, so for such a file it checks the number and the
shapes of the leaves against `like` instead. `ProgressiveRender` files
hold `radiance_sum` (float32) and `samples_done`, the JAX keys, so a
progressive render JAX saved resumes here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Tuple

import numpy as np
import torch

_PORT_TAG = "tpt_torch:"


def _flatten(tree, leaves: list) -> str:
    """Append tree's leaves to leaves; return its structure string."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        inner = ", ".join(f"{f.name}={_flatten(getattr(tree, f.name), leaves)}"
                          for f in dataclasses.fields(tree))
        return f"{type(tree).__name__}({inner})"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_flatten(x, leaves) for x in tree)
        return f"{type(tree).__name__}[{inner}]"
    if isinstance(tree, dict):
        inner = ", ".join(f"{k!r}: {_flatten(tree[k], leaves)}"
                          for k in sorted(tree))
        return "{" + inner + "}"
    leaves.append(tree)
    return "*"


def _to_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _unflatten(like, leaves):
    """A tree shaped as `like` with the next leaves of the iterator
    `leaves` (numpy arrays): tensors land on like's device and dtype,
    Python numbers keep their type."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _unflatten(getattr(like, f.name), leaves)
                             for f in dataclasses.fields(like)})
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    arr = next(leaves)
    if torch.is_tensor(like):
        return torch.from_numpy(np.array(arr)).to(like.device, like.dtype)
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


def save_pytree(path: str, tree: Any, meta: dict | None = None) -> None:
    """Save a tree of tensors (dataclasses, lists, tuples, dicts) to an
    .npz with its structure and metadata."""
    leaves: list = []
    structure = _PORT_TAG + _flatten(tree, leaves)
    payload = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        dtype=np.uint8)
    payload["__treedef__"] = np.frombuffer(structure.encode(), dtype=np.uint8)
    np.savez(path, **payload)


def load_pytree(path: str, like: Any) -> Tuple[Any, dict]:
    """Load a tree saved by save_pytree (or by the JAX package's), with
    `like` giving the structure. Returns (tree, meta). A file of this
    package must hold like's structure string; a JAX file must hold as
    many leaves as like, of the same shapes. Raises ValueError if not."""
    data = np.load(path)
    like_leaves: list = []
    structure = _PORT_TAG + _flatten(like, like_leaves)
    saved = bytes(data["__treedef__"]).decode()
    n = len([k for k in data.files if k.startswith("leaf_")])
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    if saved.startswith(_PORT_TAG):
        if saved != structure:
            raise ValueError(f"checkpoint structure mismatch:\n saved: "
                             f"{saved}\n expected: {structure}")
    else:
        shapes = [tuple(np.shape(_to_numpy(x))) for x in like_leaves]
        if [tuple(x.shape) for x in leaves] != shapes:
            raise ValueError(
                f"checkpoint leaves do not fit: the file ({saved}) holds "
                f"shapes {[tuple(x.shape) for x in leaves]}, expected "
                f"{shapes}")
    meta = json.loads(bytes(data["__meta__"]).decode())
    return _unflatten(like, iter(leaves)), meta


class ProgressiveRender:
    """Resumable progressive accumulator over sample indices.

    Renders spp in passes; each pass derives its keys from (base key,
    absolute sample index), so save / stop / load / go on gives the
    image an uninterrupted run would, bit for bit (float32 sums added in
    the same order).
    """

    def __init__(self, renderer_fn, width: int, height: int, device="cuda"):
        # renderer_fn(scene, key, sample_offset, n_samples) -> [H, W, 3]
        # radiance sum (raw, bottom-up rows) on `device`, where the sum
        # lives: the card unless the caller asks for "cpu"
        from tinypathtracer_tpu_torch.render.renderer import resolve_device

        self._fn = renderer_fn
        self.device = resolve_device(device, "ProgressiveRender")
        self.radiance_sum = torch.zeros((height, width, 3),
                                        dtype=torch.float32,
                                        device=self.device)
        self.samples_done = 0

    def step(self, scene, key, n_samples: int):
        chunk = self._fn(scene, key, self.samples_done, n_samples)
        self.radiance_sum = self.radiance_sum + chunk
        self.samples_done += n_samples
        return self.image()

    def image(self):
        """Mean radiance [H, W, 3] so far, in raw (bottom-up) row order
        as the JAX package's; film.to_image flips for display."""
        return self.radiance_sum / max(self.samples_done, 1)

    def save(self, path: str) -> None:
        np.savez(path, radiance_sum=self.radiance_sum.cpu().numpy(),
                 samples_done=np.int64(self.samples_done))

    def load(self, path: str) -> None:
        data = np.load(path)
        self.radiance_sum = torch.from_numpy(
            np.array(data["radiance_sum"], np.float32)).to(self.device)
        self.samples_done = int(data["samples_done"])
