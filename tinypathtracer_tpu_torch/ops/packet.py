"""Packet traversal: closest hit by a near-to-far walk over chunk boxes
(port of `tinypathtracer_tpu/ops/packet.py`).

The triangles are kernel A's Woop planes in morton slot order
(ops/dense.py), cut into chunks of `tc` consecutive slots, each with an
axis-aligned box. A ray slab-tests every chunk box, then visits the
chunks it enters in ascending (entry distance, chunk id) and stops when
the next entry distance is greater than its best t so far: a chunk whose
entry equals the best is still visited, since it can hold an equal-t
lower slot. Inside a chunk a hit is taken on `t < best` or on
`t == best` with a lower slot. The hits are kernel A's, bit for bit --
the same arithmetic (`hit_terms`, `origin_terms`) and the same tie rule,
the lowest slot among equal t -- with work that grows with the chunks a
ray visits, not with F. Lanes that are not alive traverse nothing.

The slab test is kept conservative: a zero direction component gets the
huge finite reciprocal REAL_MAX (a parallel ray never culls a box it lies
in), `precompute_packet` widens the boxes by a per-chunk margin (1e-5
of their extent from the origin, as the JAX package pads its host-built
LBVH boxes) so that the slab test's rounding can never cull a hit the
Woop test accepts, and the entry distance is max(near, DELTA).

The CUDA kernel (`csrc/packet.cu`, kernel C) replaces the TPU kernel
`_make_packet_kernel`. `_packet_torch` is its plain PyTorch twin: same
inputs and outputs, visit counts included. `packet_hit` dispatches on
the tensors' device: CPU tensors take the twin, CUDA tensors launch the
kernel, anything else raises. A query crosses the boundary as the bounce
holds it, origins and directions as [N, 3] rows and an optional bool
mask, and comes back as the intersectors report a hit (`face_hits`:
original face ids, a miss as -1): on the card one launch a query, with
nothing packed before it or unpacked after it. The TPU kernel's 8-ray packets, its
[S*16, 128] plane tiling and its chunk-id packing into 11 mantissa bits
(a cap of 2048 chunks) are not carried over.

On the H100 the pair tests bound kernel C, and so do the planes they
read: a chunk is tc x 48 B (24 KB at tc = 512), and bounce rays that
share a warp sit in different chunks. The kernel therefore walks a block
of PACKET_BLOCK rays together. It stages the chunk most of the block's
waiting rays wait on into shared memory (a TMA bulk copy,
double-buffered), tests every ray waiting on it there, a warp per ray
(two while many wait) with lanes over slots, and finds each ray's next
chunk with the same warp. A block reads each staged chunk once, not once per ray that
visits it. `_packet_schedule` is the plain model of that schedule: the
tests hold it to the twin, and chip_smoke.py holds the kernel's
per-block staging counts to it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from tinypathtracer_tpu_torch.ops.dense import (BOX_MARGIN, CLUSTER, WoopTris,
                                                face_hits, hit_terms,
                                                origin_terms, precompute_woop,
                                                reciprocals, slab, winner_uv)
from tinypathtracer_tpu_torch.utils import cuda_build
from tinypathtracer_tpu_torch.utils.math3d import DELTA, REAL_MAX
from tinypathtracer_tpu_torch.utils.metrics import span

# Triangles per chunk (the JAX package's default `packet_tc`); it halves
# down to CLUSTER until it divides the padded face count.
PACKET_TC = 512
_I32_MAX = 2**31 - 1
# rays (and threads) per block of kernel C: csrc/packet.cu kBlock
PACKET_BLOCK = 256
_LANES = 32
# shared memory one block can have on the H100 (232,448 B = 227 KB)
SMEM_PER_BLOCK = 232448
# (ray, triangle) pairs per tile of the plain twin, and (ray, chunk)
# pairs per tile of its slab test: bound its memory
_TILE_PAIRS = 1 << 21
_TILE_BOXES = 1 << 22


@dataclasses.dataclass
class PacketTris:
    """Chunked scene tables of the packet traversal.

    woop: the morton-ordered Woop planes (kernel A's [Fp, 12] table and
    the slot -> face permutation). boxes: [C, 8] f32 per chunk of tc
    slots: bmin xyz, bmax xyz over its real faces, widened by the margin
    (padding faces give an inverted box), validity (1, or 0 for an
    all-padding chunk), 0 (the rows stay 32 B for float4 loads).
    """

    woop: WoopTris
    boxes: torch.Tensor
    tc: int

    @property
    def n_chunks(self) -> int:
        return self.boxes.shape[0]


def precompute_packet(tri_verts, tc: int = PACKET_TC,
                      margin: float = BOX_MARGIN) -> PacketTris:
    """[F, 3, 3] world-space triangles -> PacketTris, each valid box
    widened by `margin` times max(1, |bmin| + |bmax|) (0: the JAX
    package's boxes). The morton order and the planes are
    `precompute_woop`'s, shared with kernel A."""
    woop = precompute_woop(tri_verts, margin)
    fp = woop.n_padded
    while fp % tc:
        tc //= 2
    tc = max(tc, CLUSTER)
    c = fp // tc
    tv = tri_verts[woop.perm]                            # [Fp, 3, 3]
    valid = (torch.arange(fp, device=tv.device) < woop.n_faces)[:, None]
    fb_min = torch.where(valid, tv.amin(dim=1), REAL_MAX)
    fb_max = torch.where(valid, tv.amax(dim=1), -REAL_MAX)
    ck_min = fb_min.reshape(c, tc, 3).amin(dim=1)
    ck_max = fb_max.reshape(c, tc, 3).amax(dim=1)
    ck_valid = torch.arange(c, device=tv.device) * tc < woop.n_faces
    extent = (ck_min.abs() + ck_max.abs()).amax(dim=1).clamp_min(1.0)
    pad = torch.where(ck_valid, margin * extent, 0.0)[:, None]
    boxes = torch.cat([ck_min - pad, ck_max + pad, ck_valid.float()[:, None],
                       torch.zeros_like(pad)], dim=1)
    return PacketTris(woop=woop, boxes=boxes.contiguous(), tc=tc)


def _rays(origins, dirs, mask):
    """The twin's own table of a query: (rays [N, 6], origin xyz and
    direction xyz; live [N] bool, every lane where mask is None)."""
    live = (torch.ones(origins.shape[:1], dtype=torch.bool,
                       device=origins.device) if mask is None else mask)
    return torch.cat([origins, dirs], dim=1), live


def _slab(rays, live, boxes):
    """(entry [N, C], entered [N, C] bool) of rays [N, 6] against the
    boxes; a lane that is not live enters none."""
    near, far = slab(rays[:, 0:3], reciprocals(rays[:, 3:6]), boxes)
    entry = torch.fmax(near, torch.full_like(near, DELTA))
    entered = ((far >= entry) & (boxes[:, 6] != 0.0)[None]
               & live[:, None])
    return entry, entered


def _candidates(rays, planes, tc, ray_i, chunk):
    """The pair tests of ray ray_i[p] against the tc slots of chunk
    chunk[p], with the dense scan's arithmetic, in tiles: yields (pair
    slice, chunk ids [P'], t [P', tc], REAL_MAX where the slot is not
    hit)."""
    cols = planes.view(-1, tc, 12).permute(2, 0, 1)      # [12, C, tc]
    step = max(1, _TILE_PAIRS // tc)
    for p0 in range(0, ray_i.shape[0], step):
        ps = slice(p0, p0 + step)
        ck = chunk[ps]
        w = [cols[k][ck] for k in range(12)]             # 12 x [P', tc]
        r = rays[ray_i[ps]]
        col = [r[:, k:k + 1] for k in range(6)]
        t, u, v = hit_terms(origin_terms(*col[:3], w), *col[3:], w)
        ok = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > DELTA)
        yield ps, ck, torch.where(ok, t, REAL_MAX)


def _chunk_minima(rays, planes, tc, ray_i, chunk):
    """Closest hit of ray ray_i[p] within chunk chunk[p], for each pair p:
    (t [P], REAL_MAX if none; slot [P], the lowest slot at that t),
    with the dense scan's arithmetic."""
    iota = torch.arange(tc, dtype=torch.int64, device=rays.device)
    t_out = torch.empty(ray_i.shape, dtype=torch.float32, device=rays.device)
    s_out = torch.empty(ray_i.shape, dtype=torch.int64, device=rays.device)
    for ps, ck, tcand in _candidates(rays, planes, tc, ray_i, chunk):
        cmin = tcand.amin(dim=1)
        t_out[ps] = cmin
        s_out[ps] = ck * tc + torch.where(tcand == cmin[:, None], iota,
                                          _I32_MAX).amin(dim=1)
    return t_out, s_out


def _walk(entry, entered, chunk_t, chunk_s):
    """The near-to-far walk over [N, C] per-chunk results: chunks in
    ascending (entry, chunk id); one is visited when it is entered and
    its entry is <= the best t of the chunks before it, and the walk
    stops at the first entered chunk that is not. Returns (t [N], slot
    [N] i64, -1 on a miss; visits [N] i32): the lowest (t, slot) over
    the visited chunks."""
    e_s, order = torch.sort(torch.where(entered, entry, float("inf")),
                            dim=1, stable=True)
    ent_s = entered.gather(1, order)
    t_s, s_s = chunk_t.gather(1, order), chunk_s.gather(1, order)
    best_before = torch.cat([torch.full_like(t_s[:, :1], REAL_MAX),
                             torch.cummin(t_s, dim=1).values[:, :-1]], dim=1)
    stop = ent_s & (e_s > best_before)
    visited = ent_s & (torch.cumsum(stop.int(), dim=1) == 0)
    t = torch.where(visited, t_s, REAL_MAX).amin(dim=1)
    slot = torch.where(visited & (t_s == t[:, None]), s_s,
                       _I32_MAX).amin(dim=1)
    return (t, torch.where(t < REAL_MAX, slot, -1),
            visited.sum(dim=1, dtype=torch.int32))


def _packet_torch(origins, dirs, mask, pk: PacketTris):
    """Plain twin of kernel C. origins, dirs [N, 3]; mask [N] bool or
    None (every lane alive); pk's planes [Fp, 12] and boxes [C, 8] with
    C * tc = Fp. Returns (fid [N] i64, the original face id, -1 on a
    miss; t [N] f32, REAL_MAX on a miss; uv [N, 2] f32, 0 on a miss;
    visits [N] i32, the chunks tested): kernel A's hits through
    `face_hits` on live lanes, a miss and 0 visits on dead ones."""
    rays, live = _rays(origins, dirs, mask)
    planes, boxes, tc = pk.woop.planes, pk.boxes, pk.tc
    n, c = rays.shape[0], boxes.shape[0]
    dev = rays.device
    t = torch.full((n,), REAL_MAX, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    step = max(1, _TILE_BOXES // c)
    for r0 in range(0, n, step):
        rs = slice(r0, r0 + step)
        entry, entered = _slab(rays[rs], live[rs], boxes)
        ray_i, chunk = entered.nonzero(as_tuple=True)
        chunk_t = torch.full(entry.shape, REAL_MAX, device=dev)
        chunk_s = torch.zeros(entry.shape, dtype=torch.int64, device=dev)
        pt, ps = _chunk_minima(rays[rs], planes, tc, ray_i, chunk)
        chunk_t[ray_i, chunk] = pt
        chunk_s[ray_i, chunk] = ps
        t[rs], slot[rs], visits[rs] = _walk(entry, entered, chunk_t, chunk_s)
    uv = winner_uv(rays, planes, slot)
    return (*face_hits(t, slot, uv, pk.woop), visits)


def _pick(hist):
    """Per block, the chunk with the highest count, ties to the lowest
    id (torch.argmax returns the first maximum); -1 where every count is
    0."""
    best = hist.argmax(dim=1)
    return torch.where(hist.amax(dim=1) > 0, best, -1)


def _lane_minima(rays, planes, tc, ray_i, chunk):
    """Closest hit of ray ray_i[p] within chunk chunk[p] as kernel C's
    warp finds it: lane l takes the lexicographic minimum of (t, slot)
    over slots l, l + 32, ..., then the 32 lane results are reduced the
    same way. Returns (t [P], REAL_MAX if none; slot [P])."""
    dev = rays.device
    rows = -(-tc // _LANES)
    j = torch.arange(rows, device=dev)[None, :, None]
    lane = torch.arange(_LANES, device=dev)
    t_out = torch.empty(ray_i.shape, dtype=torch.float32, device=dev)
    s_out = torch.empty(ray_i.shape, dtype=torch.int64, device=dev)
    for ps, ck, tcand in _candidates(rays, planes, tc, ray_i, chunk):
        by_lane = torch.full((ck.shape[0], rows * _LANES), REAL_MAX,
                             device=dev)
        by_lane[:, :tc] = tcand
        by_lane = by_lane.view(-1, rows, _LANES)         # [P', j, lane]
        lane_t = by_lane.amin(dim=1)                     # [P', lane]
        lane_s = torch.where(by_lane == lane_t[:, None], j,
                             _I32_MAX).amin(dim=1) * _LANES + lane
        t_out[ps] = lane_t.amin(dim=1)
        s_out[ps] = ck * tc + torch.where(lane_t == t_out[ps, None], lane_s,
                                          _I32_MAX).amin(dim=1)
    return t_out, s_out


def _packet_schedule(origins, dirs, mask, pk: PacketTris,
                     block: int = PACKET_BLOCK):
    """Plain model of kernel C's block schedule, for the tests and
    chip_smoke.py only: no route calls it. It takes `_packet_torch`'s
    arguments. Rays are cut into blocks of
    `block` in order; each block replays the kernel's rules:

    - a ray waits on the chunk its next key names (none once its walk
      has ended; dead lanes never wait);
    - with nothing staged, the block stages the chunk most of its
      waiting rays wait on, ties to the lowest id;
    - while a chunk is tested, the chunk most of the other waiting rays
      wait on is staged beside it (the same rule) and tested next; with
      none, the block picks afresh after the test;
    - a waiting ray's pair tests go to one warp, lanes over slots,
      reduced lexicographically on (t, slot) (`_lane_minima`; a warp
      that tests two rays at once reduces each alike), and are merged
      into the ray's best on t < best or t == best with a lower slot;
    - the ray's next key is the least (entry bits << 32 | chunk id)
      above the visited one whose entry is <= its best t.

    Returns ((fid, t, uv, visits) as `_packet_torch` does; stagings
    [blocks] i32, the chunks each block staged, which kernel C reports;
    served [blocks, steps] i32, the rays each block tested at each of
    its stagings in order, 0 once it has ended)."""
    rays, live = _rays(origins, dirs, mask)
    planes, boxes, tc = pk.woop.planes, pk.boxes, pk.tc
    n, c = rays.shape[0], boxes.shape[0]
    dev = rays.device
    nb = -(-n // block)
    none = torch.iinfo(torch.int64).max
    entry, entered = _slab(rays, live, boxes)           # [N, C]
    keys = (entry.view(torch.int32).long() << 32) \
        | torch.arange(c, device=dev)
    ids = torch.arange(nb * block, device=dev)
    best_t = torch.full((nb * block,), REAL_MAX, device=dev)
    best_s = torch.full((nb * block,), -1, dtype=torch.int64, device=dev)
    visits = torch.zeros((nb * block,), dtype=torch.int32, device=dev)
    nxt = torch.full((nb * block,), none, dtype=torch.int64, device=dev)

    def next_key(r, last):
        ok = (entered[r] & (entry[r] <= best_t[r, None])
              & (keys[r] > last[:, None]))
        return torch.where(ok, keys[r], none).amin(dim=1)

    alive = live.nonzero()[:, 0]
    nxt[alive] = next_key(alive, torch.zeros_like(alive))
    cur = torch.full((nb,), -1, dtype=torch.int64, device=dev)
    stagings = torch.zeros((nb,), dtype=torch.int32, device=dev)
    rows = torch.arange(nb, device=dev)
    served = []
    while True:
        waits = torch.where(nxt == none, -1, nxt & 0xFFFFFFFF).view(nb, block)
        hist = torch.zeros((nb, c + 1), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, waits + 1, torch.ones_like(waits))
        hist = hist[:, 1:]
        fresh = cur < 0
        cur = torch.where(fresh, _pick(hist), cur)
        if bool((cur < 0).all()):
            break
        stagings += (fresh & (cur >= 0)).int()
        others = hist.clone()
        others[rows, cur.clamp_min(0)] = 0
        ahead = _pick(others)
        stagings += (ahead >= 0).int()
        sel = (waits == cur[:, None]) & (cur >= 0)[:, None]
        served.append(sel.sum(dim=1, dtype=torch.int32))
        r = ids[sel.view(-1)]
        pt, ps = _lane_minima(rays, planes, tc, r, cur[r // block])
        take = (pt < best_t[r]) | ((pt == best_t[r]) & (ps < best_s[r]))
        best_t[r] = torch.where(take, pt, best_t[r])
        best_s[r] = torch.where(take, ps, best_s[r])
        visits[r] += 1
        nxt[r] = next_key(r, nxt[r])
        cur = ahead
    t = best_t[:n]
    slot = torch.where(t < REAL_MAX, best_s[:n], -1)
    served = (torch.stack(served, dim=1) if served
              else torch.zeros((nb, 0), dtype=torch.int32, device=dev))
    uv = winner_uv(rays, planes, slot)
    return ((*face_hits(t, slot, uv, pk.woop), visits[:n]), stagings,
            served)


@functools.cache
def _lib():
    lib = cuda_build.load_library("packet")
    lib.tpt_packet_hit.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 6
    lib.tpt_packet_hit.restype = ctypes.c_int
    lib.tpt_packet_resources.argtypes = [ctypes.c_void_p] * 2
    lib.tpt_packet_resources.restype = ctypes.c_int
    if lib.tpt_packet_block() != PACKET_BLOCK:
        raise RuntimeError(f"csrc/packet.cu runs {lib.tpt_packet_block()} "
                           f"rays a block, PACKET_BLOCK is {PACKET_BLOCK}")
    return lib


@functools.cache
def kernel_resources():
    """(registers per thread, static shared memory bytes per block) of
    kernel C, from cudaFuncGetAttributes."""
    regs, static = ctypes.c_int(), ctypes.c_int()
    status = _lib().tpt_packet_resources(ctypes.byref(regs),
                                         ctypes.byref(static))
    cuda_build.check_launch(status, "packet_resources")
    return regs.value, static.value


def stage_bytes(n_chunks: int, tc: int) -> int:
    """Dynamic shared memory of one block of kernel C: two stage buffers
    of tc slots (48 B each) and the histogram (one int per chunk)."""
    return 2 * 48 * tc + 4 * n_chunks


def check_fits(n_chunks: int, tc: int, static: int) -> None:
    """Raise unless a block of kernel C with `static` bytes of ray state
    has room for the stage buffers and the histogram of n_chunks chunks
    of tc slots."""
    if stage_bytes(n_chunks, tc) + static > SMEM_PER_BLOCK:
        raise ValueError(
            f"kernel C cannot take {n_chunks} chunks of {tc} slots: a block "
            f"needs {stage_bytes(n_chunks, tc)} B of stage buffers and "
            f"histogram beside {static} B of ray state, more than the "
            f"{SMEM_PER_BLOCK} B of shared memory an H100 block can have")


def _check_query(origins, dirs, mask, pk: PacketTris):
    """Raise unless the query is what kernel C reads in place: origins
    and dirs contiguous float32 [N, 3], mask None or a contiguous bool
    [N], and pk's slot -> face table a contiguous int64 [Fp], all on the
    device of pk's boxes."""
    n, dev = origins.shape[0], pk.boxes.device
    ok = all(x.dtype == torch.float32 and x.device == dev
             and x.is_contiguous() and x.shape == (n, 3)
             for x in (origins, dirs))
    ok &= mask is None or (mask.dtype == torch.bool and mask.device == dev
                           and mask.is_contiguous() and mask.shape == (n,))
    perm = pk.woop.perm
    ok &= (perm.dtype == torch.int64 and perm.device == dev
           and perm.is_contiguous() and perm.shape == (pk.woop.n_padded,))
    if not ok:
        raise ValueError(
            f"kernel C takes contiguous float32 origins and dirs [N, 3], a "
            f"contiguous bool mask [N] or None and an int64 perm [Fp] on "
            f"one device (got {origins.dtype} {tuple(origins.shape)}, "
            f"{dirs.dtype} {tuple(dirs.shape)}, mask "
            f"{None if mask is None else (mask.dtype, tuple(mask.shape))}, "
            f"perm {perm.dtype} {tuple(perm.shape)})")


def _packet_cuda(origins, dirs, mask, pk: PacketTris, stagings=None):
    """Kernel C. With `stagings` (int32 [ceil(N / PACKET_BLOCK)] on the
    rays' device) it also writes the chunks each block staged; the route
    passes none."""
    cuda_build.check_operands(pk.woop.planes, pk.boxes)
    _check_query(origins, dirs, mask, pk)
    n, dev, c = origins.shape[0], origins.device, pk.n_chunks
    check_fits(c, pk.tc, kernel_resources()[1])
    if stagings is not None and not (
            stagings.dtype == torch.int32 and stagings.device == dev
            and stagings.is_contiguous()
            and stagings.shape == (-(-n // PACKET_BLOCK),)):
        raise ValueError(f"stagings must be a contiguous int32 tensor of "
                         f"{-(-n // PACKET_BLOCK)} on {dev}")
    fid = torch.empty((n,), dtype=torch.int64, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    visits = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return fid, t, uv, visits
    with span("tpt.kernel_c"):
        status = _lib().tpt_packet_hit(
            origins.data_ptr(), dirs.data_ptr(),
            None if mask is None else mask.data_ptr(),
            pk.woop.planes.data_ptr(), pk.boxes.data_ptr(),
            pk.woop.perm.data_ptr(), n, pk.woop.n_faces, c, pk.tc,
            fid.data_ptr(), t.data_ptr(), uv.data_ptr(), visits.data_ptr(),
            None if stagings is None else stagings.data_ptr(),
            cuda_build.stream_ptr(dev))
    cuda_build.check_launch(status, "packet_hit")
    packet_hit.launches += 1
    return fid, t, uv, visits


def packet_hit(origins, dirs, mask, pk: PacketTris):
    """Closest hit of rays origins, dirs [N, 3] by the near-to-far chunk
    walk, lanes with mask=False (mask: [N] bool or None) traversing
    nothing: kernel C on CUDA tensors, its plain twin on CPU tensors.
    Returns (fid, t, uv, visits); see `_packet_torch`."""
    n = origins.shape[0]
    planes, boxes = pk.woop.planes, pk.boxes
    if (origins.shape != (n, 3) or dirs.shape != (n, 3)
            or (mask is not None and mask.shape != (n,))
            or planes.shape[-1] != 12 or boxes.shape[-1] != 8
            or boxes.shape[0] * pk.tc != planes.shape[0]):
        raise ValueError(
            f"bad shapes origins {tuple(origins.shape)}, dirs "
            f"{tuple(dirs.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}, planes "
            f"{tuple(planes.shape)}, boxes {tuple(boxes.shape)}, tc {pk.tc}")
    if origins.device.type == "cuda":
        return _packet_cuda(origins, dirs, mask, pk)
    if origins.device.type == "cpu":
        with span("tpt.kernel_c"):
            return _packet_torch(origins, dirs, mask, pk)
    raise ValueError(f"packet_hit has no kernel for device {origins.device}")


packet_hit.launches = 0


def closest_hit_packet(origins, dirs, pk: PacketTris, mask=None,
                       with_visits: bool = False):
    """Closest hit by the packet traversal. origins/dirs: [N, 3].

    Returns (fid, t, uv) as `closest_hit_dense` does, bit for bit;
    lanes with mask=False traverse nothing and report a miss. With
    with_visits, also visits [N] i32, the chunks each ray tested (pairs
    tested = visits * pk.tc). The rows are read where they lie (a copy
    only of a strided view): on the card one launch of kernel C."""
    fid, t, uv, visits = packet_hit(
        origins.contiguous(), dirs.contiguous(),
        None if mask is None else mask.contiguous(), pk)
    return (fid, t, uv, visits) if with_visits else (fid, t, uv)
