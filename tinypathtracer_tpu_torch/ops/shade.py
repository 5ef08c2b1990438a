"""The modular loop's reference-mode bounce, shaded between its
closest-hit queries by two hand-written CUDA kernels (`csrc/shade.cu`).

A bounce of `render/integrator.trace_paths` in reference mode is a
draw, the main closest-hit query, the shading of its hits, the extra
emitter query and one shadow query a delta light, and the step of the
paths that go on. On the card the shading runs as two kernels around the
second group of queries (`integrator.shaded_bounce`):

  * `shade_hits`: the environment on a miss, the emission of an emissive
    hit, the BSDF sample, the extra emitter direction and each light's
    direction (`env_miss`, `surface`, `scatter`, `sample_delta_light`);
  * `close_bounce`: the extra emitter's and the lights' direct term and
    the next carry (`end_bounce`).

Vectors are [N, 3] rows, the layout the closest hit takes, so the
queries read the kernels' outputs as they are. Replaces no TPU kernel:
the JAX package's bounce loop shades with XLA operations. The plain
twins (`_shade_hits_torch`, `_close_bounce_torch`, for CPU tensors) are
the integrator's own torch code, called rather than copied; the kernels
share kernel B's shading code (`csrc/shade.cuh`), give the same bits on
the card, and count their launches (`shade_hits.launches`,
`close_bounce.launches`). Each launch is a `tpt.shade` span.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tinypathtracer_tpu_torch.ops.lights import MAX_LIGHTS, sample_delta_light
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.metrics import span


@dataclasses.dataclass
class Shaded:
    """A bounce shaded at its hits (`shade_hits`): what its other queries
    and `close_bounce` read. [N, 3] rows unless said."""

    rad: torch.Tensor     # radiance: the environment, the emission added
    h: torch.Tensor       # hit point, the origin of every query
    nd: torch.Tensor      # next direction (the BSDF sample)
    d2: torch.Tensor      # the extra emitter query's direction
    weight: torch.Tensor  # throughput weight, base color * BSDF ratio
    wi: torch.Tensor      # [L, N, 3]: the direction toward each light
    live: torch.Tensor    # [N] bool: the path goes on (the shadow mask)
    extra: torch.Tensor   # [N] bool: live and diffuse (the extra mask)


@functools.cache
def _lib():
    lib = cuda_build.load_library("shade")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpt_shade_hits.argtypes = [i, i] + [p] * 10 + [i] + [p] * 3 \
        + [i, i, ctypes.c_float] + [p] * 10
    lib.tpt_shade_hits.restype = ctypes.c_int
    lib.tpt_close_bounce.argtypes = [i, i] + [p] * 18 + [i] + [p] * 8
    lib.tpt_close_bounce.restype = ctypes.c_int
    return lib


def _check(n: int, rows=(), masks=(), ids=(), other=()):
    """The kernels' operands: contiguous, on one card; [N, 3] float32
    rows, [N] bool masks, [N] int64 face ids, other float32 tensors."""
    dev = rows[0].device
    for t, shape, dtype in (
            [(x, (n, 3), torch.float32) for x in rows]
            + [(x, (n,), torch.bool) for x in masks]
            + [(x, (n,), torch.int64) for x in ids]
            + [(x, x.shape, torch.float32) for x in other]):
        if not (t.device == dev and dev.type == "cuda" and t.is_contiguous()
                and t.dtype == dtype and tuple(t.shape) == tuple(shape)):
            raise ValueError(
                f"shade kernels take contiguous {dtype} tensors of "
                f"{tuple(shape)} on one card (got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, contiguous="
                f"{t.is_contiguous()})")


def _shade_hits_cuda(o, d, thr, rad, alive, fid, t, uv, u, data, cfg,
                     lights) -> Shaded:
    n, n_lights = o.shape[0], data.n_lights
    eh, ew = data.env_radiance.shape[0], data.env_radiance.shape[1]
    if not (0 <= n_lights <= MAX_LIGHTS and data.shade_packT.shape[0] == 15
            and tuple(u.shape) == (6, n) and tuple(uv.shape) == (n, 2)
            and tuple(t.shape) == (n,)):
        raise ValueError(f"shade_hits: {n_lights} lights, shade_packT "
                         f"{tuple(data.shade_packT.shape)}, u "
                         f"{tuple(u.shape)}, uv {tuple(uv.shape)}, t "
                         f"{tuple(t.shape)} for {n} lanes")
    _check(n, rows=(o, d, thr, rad), masks=(alive,), ids=(fid,),
           other=(t, uv, u, data.shade_packT, data.env_r, data.env_g,
                  data.env_b, lights))
    out = Shaded(*(torch.empty_like(o) for _ in range(5)),
                 wi=o.new_empty((n_lights, n, 3)),
                 live=torch.empty_like(alive), extra=torch.empty_like(alive))
    if n == 0:
        return out
    with span("tpt.shade"):
        status = _lib().tpt_shade_hits(
            n, n_lights, o.data_ptr(), d.data_ptr(), thr.data_ptr(),
            rad.data_ptr(), alive.data_ptr(), fid.data_ptr(), t.data_ptr(),
            uv.data_ptr(), u.data_ptr(), data.shade_packT.data_ptr(),
            data.shade_packT.shape[1], data.env_r.data_ptr(),
            data.env_g.data_ptr(), data.env_b.data_ptr(), eh, ew,
            cfg.env_scale, lights.data_ptr(), out.rad.data_ptr(),
            out.h.data_ptr(), out.nd.data_ptr(), out.d2.data_ptr(),
            out.weight.data_ptr(), out.wi.data_ptr(), out.live.data_ptr(),
            out.extra.data_ptr(), cuda_build.stream_ptr(o.device))
    cuda_build.check_launch(status, "shade_hits")
    shade_hits.launches += 1
    return out


def _shade_hits_torch(o, d, thr, rad, alive, fid, t, uv, u, data, cfg,
                      lights) -> Shaded:
    """Plain twin of `shade_hits`: the torch code of the modular bounce
    (`integrator.trace_paths`) from its main query to its other
    queries."""
    from tinypathtracer_tpu_torch.render import integrator as it

    st = it.Paths(o=o.unbind(1), d=d.unbind(1), thr=thr.unbind(1),
                  rad=rad.unbind(1), alive=alive)
    miss = fid < 0
    env = it.env_miss(data, cfg, *st.d)
    st.rad = tuple(r + tc * torch.where(st.alive & miss, e, 0.0)
                   for r, tc, e in zip(st.rad, st.thr, env))
    row = it.gather(data.shade_packT, 1, torch.clamp_min(fid, 0))
    st, sc = it.scatter(st, miss, torch.where(miss, 1.0, t), uv[:, 0],
                        uv[:, 1], row, u, lights, data.n_lights)
    wi = [torch.stack(w, dim=1) for w, _ in sc.lights]
    return Shaded(
        *(torch.stack(v, dim=1) for v in (st.rad, sc.h, sc.nd, sc.d2,
                                          sc.weight)),
        wi=torch.stack(wi) if wi else o.new_empty((0, o.shape[0], 3)),
        live=sc.live, extra=sc.live & sc.do_extra)


def shade_hits(o, d, thr, rad, alive, fid, t, uv, u, data, cfg,
               lights) -> Shaded:
    """Shade one reference-mode bounce at its main query's hits.

    o, d, thr, rad [N, 3]: the carry; alive [N] bool; fid [N] int64 (-1
    on a miss), t [N], uv [N, 2]: the hits along d; u [6, N]: the
    bounce's draws (`lane_draws(keys, depth, 1, 6)`); data: the
    untextured `TraceData`, cfg its RenderConfig, lights its [max(L, 1),
    16] table (L <= MAX_LIGHTS). `shade_hits_kernel` on CUDA tensors,
    the integrator's torch code on CPU tensors."""
    if o.device.type == "cuda":
        return _shade_hits_cuda(o, d, thr, rad, alive, fid, t, uv, u, data,
                                cfg, lights)
    if o.device.type == "cpu":
        with span("tpt.shade"):
            return _shade_hits_torch(o, d, thr, rad, alive, fid, t, uv, u,
                                     data, cfg, lights)
    raise ValueError(f"shade_hits has no kernel for device {o.device}")


shade_hits.launches = 0


def _close_bounce_cuda(o, d, thr, sh: Shaded, fid, fid2, occ, data, lights):
    n, n_lights = o.shape[0], len(occ)
    if not (n_lights == data.n_lights == sh.wi.shape[0] <= MAX_LIGHTS
            and data.shade_packT.shape[0] == 15):
        raise ValueError(f"close_bounce: {n_lights} shadow queries, "
                         f"{data.n_lights} lights, {sh.wi.shape[0]} light "
                         f"directions")
    _check(n, rows=(o, d, thr, sh.rad, sh.h, sh.nd, sh.weight),
           masks=(sh.live, sh.extra), ids=(fid, fid2, *occ),
           other=(data.shade_packT, data.face_emission, lights))
    nxt = [torch.empty_like(o) for _ in range(4)] + [
        torch.empty_like(sh.live)]
    if n == 0:
        return tuple(nxt)
    occ_ptrs = [x.data_ptr() for x in occ] + [None] * (MAX_LIGHTS - n_lights)
    with span("tpt.shade"):
        status = _lib().tpt_close_bounce(
            n, n_lights, o.data_ptr(), d.data_ptr(), thr.data_ptr(),
            sh.rad.data_ptr(), sh.h.data_ptr(), sh.nd.data_ptr(),
            sh.weight.data_ptr(), sh.live.data_ptr(), sh.extra.data_ptr(),
            fid.data_ptr(), fid2.data_ptr(), *occ_ptrs,
            data.shade_packT.data_ptr(), data.shade_packT.shape[1],
            data.face_emission.data_ptr(), lights.data_ptr(),
            *(x.data_ptr() for x in nxt), cuda_build.stream_ptr(o.device))
    cuda_build.check_launch(status, "close_bounce")
    close_bounce.launches += 1
    return tuple(nxt)


def _close_bounce_torch(o, d, thr, sh: Shaded, fid, fid2, occ, data, lights):
    """Plain twin of `close_bounce`: `integrator.end_bounce` on the
    bounce's Scatter, the lights' radiance computed again from the hit
    points and the base color gathered again, as the kernel does."""
    from tinypathtracer_tpu_torch.render import integrator as it

    h = sh.h.unbind(1)
    base = it.gather(data.shade_packT[9:12], 1, torch.clamp_min(fid, 0))
    lw = [sample_delta_light(*h, lights[li]) for li in range(len(occ))]
    sc = it.Scatter(live=sh.live, h=h, nd=sh.nd.unbind(1),
                    weight=sh.weight.unbind(1), base=tuple(base),
                    do_extra=sh.extra, d2=sh.d2.unbind(1),
                    lights=[(l_[:3], l_[3:]) for l_ in lw])
    st = it.Paths(o=o.unbind(1), d=d.unbind(1), thr=thr.unbind(1),
                  rad=sh.rad.unbind(1), alive=sh.live)
    st = it.end_bounce(st, sc, fid2, data.face_emission,
                       [f < 0 for f in occ])
    return (*(torch.stack(v, dim=1) for v in (st.o, st.d, st.thr, st.rad)),
            st.alive)


def close_bounce(o, d, thr, sh: Shaded, fid, fid2, occ, data, lights):
    """Close one reference-mode bounce: its direct light and the step of
    the paths that go on. o, d, thr [N, 3]: the bounce's carry; sh: its
    `shade_hits`; fid, fid2 [N] int64: the main and the extra emitter
    query's faces; occ: per delta light, its shadow query's faces [N]
    int64 (-1: unoccluded). Returns the next carry (o, d, thr, rad [N,
    3], alive [N] bool). `close_bounce_kernel` on CUDA tensors, the
    integrator's torch code on CPU tensors."""
    if o.device.type == "cuda":
        return _close_bounce_cuda(o, d, thr, sh, fid, fid2, occ, data,
                                  lights)
    if o.device.type == "cpu":
        with span("tpt.shade"):
            return _close_bounce_torch(o, d, thr, sh, fid, fid2, occ, data,
                                       lights)
    raise ValueError(f"close_bounce has no kernel for device {o.device}")


close_bounce.launches = 0
