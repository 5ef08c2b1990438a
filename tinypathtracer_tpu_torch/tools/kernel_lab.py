"""Kernel lab 3: the dense closest hit's (ray, triangle) pair rate and
the row-gather rate. Port of `tinypathtracer_tpu/tools/kernel_lab.py`.

  dense            kernel A through `closest_hit_dense`: 2**20 rays from
                   random origins in random directions against 1,948
                   random triangles (2,048 slots)
  dense_coherent   the same with near-parallel directions
  row_gather       `index_select` of a random permutation of the rows of
                   a [2**20, 8] table: the cost model of any ray binning

Timing: CUDA events around each call, one warm-up, the median of
`--reps` (the TPU tool's readback-overhead subtraction has no
counterpart). Inputs are made with numpy from fixed seeds.

Usage: python -m tinypathtracer_tpu_torch.tools.kernel_lab
       [--device cuda|cpu] [--n 1048576] [--f 2048]
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tinypathtracer_tpu_torch.ops.dense import (closest_hit_dense,
                                                precompute_woop)
from tinypathtracer_tpu_torch.tools import common


def dense_pair_rate(n=1 << 20, f=2048, coherent=False,
                    dev=torch.device("cuda"), reps=10):
    """(ms per call, pairs/s) of kernel A on n rays x (f - 100) random
    triangles."""
    rng = np.random.default_rng(0)
    tv = (rng.random((f - 100, 3, 3)) * 100.0).astype(np.float32)
    woop = precompute_woop(torch.from_numpy(tv).to(dev))
    o = rng.random((n, 3)) * 100.0
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if coherent:        # near-parallel rays: the best case for coherence
        d = d * 0.02 + 0.57735
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(dev) for x in (o, d))
    ms = common.timed_ms(lambda: closest_hit_dense(o, d, woop), dev, reps)
    return ms, n * woop.n_padded / (ms * 1e-3)


def gather_rate(n=1 << 20, dev=torch.device("cuda"), reps=10):
    """(ms per call, elements/s) of a random row gather of [n, 8]."""
    rng = np.random.default_rng(0)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    x8 = torch.from_numpy(rng.random((n, 8)).astype(np.float32)).to(dev)
    ms = common.timed_ms(lambda: torch.index_select(x8, 0, perm), dev, reps)
    return ms, 8 * n / (ms * 1e-3)


def main(argv=None):
    ap = common.parser(__doc__)
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--f", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=10)
    args, dev = common.parse(ap, argv, "kernel_lab")
    kw = dict(n=args.n, dev=dev, reps=args.reps)
    res = {"device": common.device_name(dev), "n_rays": args.n}
    t, rate = dense_pair_rate(f=args.f, **kw)
    res["dense_1Mx2048_ms"] = t
    res["dense_gpairs_per_s"] = rate / 1e9
    t, rate = dense_pair_rate(f=args.f, coherent=True, **kw)
    res["dense_coherent_1Mx2048_ms"] = t
    res["dense_coherent_gpairs_per_s"] = rate / 1e9
    t, rate = gather_rate(**kw)
    res["row_gather_1Mx8_ms"] = t
    res["row_gather_melem_per_s"] = rate / 1e6
    print(json.dumps(res, indent=2), flush=True)
    return res


if __name__ == "__main__":
    main()
