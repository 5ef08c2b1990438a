"""Per-lane threefry key chain, bit-exact with `jax.random`.

Port of `tinypathtracer_tpu/ops/sampling.py:35-47`. Every random draw of
a frame derives from a (frame key, pixel, sample, tag) chain, so an
image depends only on its key and never on chunking. The port keeps
that contract by reproducing jax's threefry2x32 bit for bit: the keys
are `[..., 2]` int64 tensors holding uint32 words (int64 with
`& 0xFFFFFFFF` because torch's uint32 lacks shifts and adds).

The recipe (jax 0.9, `jax_threefry_partitionable=True`, which is the
default there):
  * `PRNGKey(seed)`        -> (seed >> 32, seed & 0xFFFFFFFF);
  * `fold_in(key, d)`      -> threefry2x32(key, (0, d));
  * `uniform(key, (m,))`   -> word j = x0 ^ x1 of threefry2x32(key, (0, j)),
                              then float((w >> 9) | 0x3F800000) - 1.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors
    of uint32 words. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device="cpu"):
    """The raw key of `jax.random.PRNGKey(seed)` as an int64 [2] tensor."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def fold_in(keys, data):
    """`jax.random.fold_in` on [..., 2] keys; `data` (an int or an int
    tensor broadcastable to keys[..., 0]) is taken modulo 2**32."""
    if not torch.is_tensor(data):
        data = torch.tensor(data, dtype=torch.int64, device=keys.device)
    data = data.to(torch.int64) & _MASK
    x0, x1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(x0, x1), dim=-1)


def fold_lanes(key, ids):
    """One key per lane: fold_in(key, ids[i]). key [2], ids [N] ints."""
    return fold_in(key, ids)


def fold_all(keys, tag: int):
    """Fold the same scalar tag into a [N, 2] key array."""
    return fold_in(keys, tag)


def lane_uniform(keys, m: int):
    """[N, m] U[0,1) float32 draws, column j of lane i depending only on
    keys[i] (`jax.random.uniform(keys[i], (m,))`)."""
    j = torch.arange(m, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(j), j)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
