"""Kernel E's cull and survivor queue (tools/lab4.py, csrc/lab4.cu):
the plain model `vpu_rol_schedule` against a full evaluation of every
(ray, slot) pair, on a hand-built case with known counts, and on
triangles planted so that t lands on DELTA, on a ray's best and on ties
across tiles, with zero and signed-zero z rows, where the twin must also
equal the JAX kernel `_vpu_rol_kernel` in interpret mode and kernel A's
twin bit for bit.

The CUDA kernel runs on the card only; chip_smoke.py phase 13 holds it
to the twin and its counting launch to the model there.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from tinypathtracer_tpu.tools import lab4 as jlab4
from tinypathtracer_tpu_torch.ops import dense
from tinypathtracer_tpu_torch.tools import lab4
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX

torch.set_num_threads(2)

F32 = np.float32


def _ulps(x, k):
    """The float32 k ulps above (k > 0) or below x."""
    x = F32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, F32(np.inf if k > 0 else -np.inf))
    return float(x)


def _z_plane(h):
    """The plane rows of a triangle in the plane z = h with edges along x
    and y from (0, 0, h): o' = (ox, oy, oz - h), d' = d, so a ray from
    (ox, oy, 0) along +z has t = h exactly and (u, v) = (ox, oy)."""
    return [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, -h]


def _rays8(origins, dirs):
    n = len(origins)
    o = torch.tensor(origins, dtype=torch.float32)
    d = torch.tensor(dirs, dtype=torch.float32)
    return torch.cat([o, torch.ones((n, 1)), d, torch.zeros((n, 1))],
                     dim=1).T.contiguous()


def _exact_pairs(rays8, planesT):
    """(t, hit) [N, Fp] of every pair with the twin's arithmetic, and
    taken [N, Fp]: the hits that beat the ray's running best in slot
    order (the sequential sweep's updates)."""
    w = list(planesT.T[:, None, :])
    o = [rays8[k][:, None] for k in range(3)]
    d = [rays8[4 + k][:, None] for k in range(3)]
    t, u, v = dense.hit_terms(dense.origin_terms(*o, w), *d, w)
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
    run = torch.cummin(torch.where(hit, t, REAL_MAX), dim=1).values
    prev = torch.cat([torch.full((t.shape[0], 1), REAL_MAX), run[:, :-1]],
                     dim=1)
    return t, hit, hit & (t < prev)


@pytest.mark.parametrize("n,f,tc,seed", [(256, 1948, 512, 0),
                                         (1024, 1948, 256, 1),
                                         (1037, 200, 16, 2),
                                         (300, 700, 128, 3)])
def test_cull_model_is_conservative(n, f, tc, seed):
    """On lab4's data, every pair the model culls is one the exact test
    rejects or does not take (a full [N, Fp] evaluation), the model's
    result is the twin's, and its survivors are its kept pairs."""
    woop, _, rays8 = lab4.test_data(n, f, torch.device("cpu"), seed)
    planesT = lab4.make_planesT(woop)
    t, fid, surv, batches, kept = lab4.vpu_rol_schedule(rays8, planesT, tc,
                                                        pairs=True)
    tw, fw = lab4._vpu_rol_torch(rays8, planesT, tc)
    assert torch.equal(t, tw) and torch.equal(fid, fw)
    _, hit, taken = _exact_pairs(rays8, planesT)
    assert int((taken & ~kept).sum()) == 0
    won = fid >= 0
    assert bool(kept[won.nonzero()[:, 0], fid[won].long()].all())
    warps = -(-n // 1024) * 8
    assert surv.shape == batches.shape == (warps,)
    assert int(surv.sum()) == int(kept.sum())
    # the cull keeps a minority: most pairs are culled on the z row
    assert int(taken.sum()) <= int(kept.sum()) < 0.5 * kept.numel()
    # every batch but a tile's last one is full
    tiles = woop.n_padded // tc
    assert (batches * lab4.E_BATCH >= surv).all() and (
        (batches - tiles) * lab4.E_BATCH <= surv).all()


def _hand_built():
    """One warp of 128 rays from (0.25, 0.25, 0): rays 0-39 along +z,
    the rest along -z; tiles of 16 slots: z = 5, 7, 3, -2, twelve padding
    slots; z = 3 (a tie with slot 2), 3 - 1 ulp, -(2 + 1 ulp), thirteen
    padding slots."""
    dirs = [(0.0, 0.0, 1.0)] * 40 + [(0.0, 0.0, -1.0)] * 88
    rays8 = _rays8([(0.25, 0.25, 0.0)] * 128, dirs)
    rows = [_z_plane(h) for h in (5.0, 7.0, 3.0, -2.0)] + [[0.0] * 12] * 12
    rows += [_z_plane(h) for h in (3.0, _ulps(3.0, -1), -_ulps(2.0, 1))]
    rows += [[0.0] * 12] * 13
    return rays8, torch.tensor(rows, dtype=torch.float32)


def test_schedule_counts_on_a_hand_built_case():
    """The survivors and batches of `_hand_built` in batches of 64,
    counted by hand: slot 0 keeps 40 (none drained); slot 1 the same 40,
    whose best is still pending (one batch, 16 wait); slot 2 40, below
    their best 5 (56 wait); slot 3 the 88 downward rays (two batches, 16
    wait, drained at the tile's end: one batch); slot 16 40, on their
    best 3 (40 wait); slot 17 40 (one batch, 16 wait); slot 18 the 88
    downward rays, 1 ulp above their best 2 but within the cull's margin
    (one batch, 40 wait, drained at the tile's end: one batch). The other
    7 warps of the block are empty. The result: 3 - 1 ulp at slot 17 up,
    2 at slot 3 down (the tie at slot 16 loses to slot 2)."""
    assert lab4.E_BATCH == 64
    rays8, planesT = _hand_built()
    t, fid, surv, batches = lab4.vpu_rol_schedule(rays8, planesT, tc=16)
    assert surv.tolist() == [376] + [0] * 7
    assert batches.tolist() == [7] + [0] * 7
    assert fid.tolist() == [17] * 40 + [3] * 88
    assert t.tolist() == [_ulps(3.0, -1)] * 40 + [2.0] * 88
    # deterministic: the same counts again, and through `counted` on the
    # CPU
    again = lab4.counted(rays8, planesT, tc=16)
    assert all(torch.equal(a, b) for a, b in zip(again,
                                                  (t, fid, surv, batches)))
    tw, fw = lab4._vpu_rol_torch(rays8, planesT, tc=16)
    assert torch.equal(t, tw) and torch.equal(fid, fw)


def _planted(case):
    """(rays8 [8, 128], planesT [Fp, 12], tc) of a planted case: rays
    from (0.1 + 0.005 r, 0.2, 0) along +z, so that a z-plane's t is its
    height exactly."""
    rays8 = _rays8([(0.1 + 0.005 * r, 0.2, 0.0) for r in range(128)],
                   [(0.0, 0.0, 1.0)] * 128)
    zero = [0.0] * 12
    if case == "delta":
        # t on DELTA and 1-4 ulp either side, descending: the winner is
        # DELTA + 1 ulp, the lowest t above DELTA
        rows = [_z_plane(_ulps(DELTA, k)) for k in (4, 3, 2, 1, 0, -1, -2,
                                                     -3, -4)]
        rows += [zero] * 7
        return rays8, rows, 16
    if case == "best":
        # a best of 3, then t 1-4 ulp above it (not taken) and below it
        # (taken, each lower than the last), the last two in a second tile
        rows = [_z_plane(3.0)] + [_z_plane(_ulps(3.0, k))
                                  for k in (1, 2, 3, 4, -1, -2)]
        rows += [zero] * 9 + [_z_plane(_ulps(3.0, k)) for k in (4, -3)]
        rows += [_z_plane(_ulps(3.0, -4))] + [zero] * 13
        return rays8, rows, 16
    if case == "ties":
        # equal t in three tiles: the lowest slot wins
        rows = [zero] * 5 + [_z_plane(2.0)] + [zero] * 10
        rows += [_z_plane(2.0)] + [zero] * 14 + [_z_plane(2.0)]
        rows += [_z_plane(_ulps(2.0, 1))] + [zero] * 15
        return rays8, rows, 16
    # signed zeros: d'z = -0 and +0 with o'z = 1, o'z = -0 (t = -0), an
    # all-zero slot, a -0 row, then the one hit, at t = 1.5
    neg = -0.0
    rows = [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, neg, neg, neg, 1.0],
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0],
            [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, neg, neg, -1.0, neg],
            zero, [neg] * 12, _z_plane(1.5)] + [zero] * 10
    return rays8, rows, 16


@pytest.mark.parametrize("case", ["delta", "best", "ties", "zeros"])
def test_planted_pairs(case):
    """On planted pairs the twin equals lab4._vpu_rol_kernel in interpret
    mode and kernel A's twin bit for bit; the model's result is the
    twin's and it keeps every winning pair."""
    rays8, rows, tc = _planted(case)
    planesT = torch.tensor(rows, dtype=torch.float32)
    fp = planesT.shape[0]
    t, fid = lab4.vpu_rol_closest_hit(rays8, planesT, tc=tc)
    want_t, want_f = pl.pallas_call(
        jlab4._vpu_rol_kernel(fp, tc), grid=(1,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (0, i)),
                  pl.BlockSpec((fp, 12), lambda i: (0, 0))],
        out_specs=(pl.BlockSpec((1, 128), lambda i: (0, i)),
                   pl.BlockSpec((1, 128), lambda i: (0, i))),
        out_shape=(jax.ShapeDtypeStruct((1, 128), jnp.float32),
                   jax.ShapeDtypeStruct((1, 128), jnp.int32)),
        interpret=True)(jnp.asarray(rays8.numpy()),
                        jnp.asarray(planesT.numpy()))
    assert np.array_equal(t.numpy(), np.asarray(want_t)[0])
    assert np.array_equal(fid.numpy(), np.asarray(want_f)[0])
    ta, sa, _ = dense._dense_torch(rays8[[0, 1, 2, 4, 5, 6, 3, 7]].T
                                   .contiguous(), planesT)
    assert torch.equal(t, ta) and torch.equal(fid, sa)
    mt, mf, surv, _, kept = lab4.vpu_rol_schedule(rays8, planesT, tc,
                                                  pairs=True)
    assert torch.equal(mt, t) and torch.equal(mf, fid)
    assert bool(kept[torch.arange(128), fid.long()].all())
    _, _, taken = _exact_pairs(rays8, planesT)
    assert int((taken & ~kept).sum()) == 0
    expect = {"delta": (_ulps(DELTA, 1), 3), "best": (_ulps(3.0, -4), 18),
              "ties": (2.0, 5), "zeros": (1.5, 5)}[case]
    assert (fid == expect[1]).all() and (t == expect[0]).all()
    if case == "zeros":
        # only the real plane's pairs survive: signed zeros are culled
        assert kept[:, :5].sum() == 0 and kept[:, 6:].sum() == 0


def test_counts_and_constants_match_the_kernel_source():
    """The block geometry and the margin of the model are csrc/lab4.cu's;
    a ragged batch pads its last block's warps with empty counts."""
    src = (cuda_build.CSRC / "lab4.cu").read_text()
    assert f"constexpr int kEThreads = {lab4.E_THREADS};" in src
    assert f"constexpr int kERays = {lab4.E_RAYS};" in src
    assert f"constexpr int kBatch = {lab4.E_BATCH};" in src
    up = re.search(r"kBestUp = (0x[0-9a-fp.+-]+)f;", src).group(1)
    assert float.fromhex(up) == lab4.BEST_UP == float(F32(lab4.BEST_UP))
    woop, _, rays8 = lab4.test_data(1100, 300, torch.device("cpu"), 4)
    _, _, surv, batches = lab4.counted(rays8, lab4.make_planesT(woop), 64)
    assert surv.shape == (16,) and (surv[9:] == 0).all()
    assert (surv[:8] > 0).all() and surv[8] > 0 and (batches[9:] == 0).all()


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_114vpu_rol_kernelILb1EEEvPKfS2_iiiPfPiS4_S4_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   BRA `(.L_x_0) ;
.L_x_0:
        /*0020*/                   NOP ;
		Function : _ZN12_GLOBAL__N_114vpu_rol_kernelILb0EEEvPKfS2_iiiPfPiS4_S4_
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_1:
        /*0010*/                   LDS.128 R4, [R2+0x20] ;
        /*0020*/                   FFMA R5, R6, R7, R8 ;
.L_x_2:
        /*0030*/                   LDS R9, [R3] ;
        /*0040*/                   MUFU.RCP R10, R11 ;
        /*0050*/                   NOP ;
        /*0060*/              @P0 BRA `(.L_x_2) ;
        /*0070*/                   ISETP.NE.AND P1, PT, R12, RZ, PT ;
        /*0080*/              @P1 BRA `(.L_x_1) ;
        /*0090*/                   BRA 0x90 ;
        /*00a0*/                   EXIT ;
"""


def test_sass_loops_reader():
    """sass_loops finds each backward branch's loop (NOPs not counted)
    in the named function only; vpu_rol_sass's split: the drain loop
    holds the divide, the fast loop is the rest of the loop around it."""
    loops = lab4.sass_loops(SASS, "vpu_rol_kernelILb0E")
    assert loops == [[0x30, 0x60, 3, 1], [0x10, 0x80, 7, 1],
                     [0x90, 0x90, 1, 0]]
    assert lab4.e_loop_counts(loops) == {"slot": 4, "pair": 1.0,
                                         "batch": 3}
    with pytest.raises(ValueError, match="no SASS function"):
        lab4.sass_loops(SASS, "mxu_hit_kernel")
