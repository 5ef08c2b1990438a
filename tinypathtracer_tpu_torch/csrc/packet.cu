// Kernel C: closest hit of N rays by a near-to-far walk over chunk boxes.
//
// Replaces the TPU kernel tinypathtracer_tpu/ops/packet.py
// `_make_packet_kernel` (called through `_packet_pallas`). Plain twin:
// tinypathtracer_tpu_torch/ops/packet.py `_packet_torch`; plain model of
// this kernel's block schedule: `_packet_schedule` there.
//
// The triangles are kernel A's Woop planes in morton slot order, cut into
// C chunks of tc consecutive slots, each with an axis-aligned box (widened
// by its margin on the host, ops/packet.precompute_packet). A ray visits
// the chunks whose boxes it enters in ascending 64-bit key, (entry bits
// << 32) | chunk id (the entry distance is >= DELTA > 0, so its bits order
// like the floats), and stops when the next entry is greater than its best
// t; inside a chunk it takes a hit on t < best or on t == best with a
// lower slot. The hit is kernel A's (t, slot, u, v) bit for bit: the
// same arithmetic (hit.cuh) and the same tie rule, the lowest slot among
// equal t.
//
// Its boundary is the bounce's: a query is read as the callers hold it,
// origins and directions as [N, 3] float32 rows and an optional bool
// mask (the carry rows and the rows csrc/shade.cu writes), and the hit is
// written as the intersectors report it (ops/dense.face_hits): the
// original face id perm[slot] (int64; -1 for a miss or a padding slot),
// t (FLT_MAX there) and (u, v) (0 there). Selection, not arithmetic: the
// results are kernel A's face-level hits bit for bit, and a query is one
// launch with nothing packed before it or unpacked after it.
//
// What bounds it on the H100: the pair tests, ~39 fp32 operations each
// (as kernel A), tc per visited chunk. A chunk's planes are tc x 48 B
// (24 KB at tc = 512). Walking one ray per thread, as bounce rays scatter
// over the chunks, each thread streams a private copy of every chunk it
// visits through L2 (Σ visits x 24 KB a query) and a warp runs as long as
// its longest walk.
//
// Design: a block of kBlock rays walks together.
// - Each ray's state (origin, direction, reciprocals, best (t, slot, u,
//   v), next key, visits) lives in shared memory. A ray waits on the
//   chunk its next key names; dead lanes and finished walks wait on none.
// - A shared histogram counts the waiting rays per chunk. The block stages
//   the chunk most rays wait on (ties to the lowest id) into one of two
//   shared buffers with one TMA bulk copy (cp.async.bulk, completing on an
//   mbarrier: the chunk is one contiguous run of bytes, so the copy needs
//   no tensor map and no thread spends registers on it). While that chunk
//   is tested, the chunk most of the other waiting rays wait on is staged
//   into the other buffer and tested next: those rays' state cannot change
//   meanwhile, so it is still wanted when it lands. A block reads Σ
//   stagings x tc x 48 B of planes instead of Σ visits x tc x 48 B.
// - The rays waiting on the staged chunk are listed (ballot and prefix
//   count). A warp takes one listed ray at a time, two while more than
//   one ray per warp waits, and its lanes test slots l, l + 32, ... from
//   shared memory (three conflict-free 16-byte loads at a 48 B stride,
//   each plane read once for the warp's rays). Each lane keeps the
//   lexicographic minimum of (t, slot); the warp reduces it with two
//   redux.sync minima (t > 0, so its bits order like the floats) and
//   fetches (u, v) from the winning lane. The result is merged into the
//   ray's best by the serial rule; (t, slot) taken lexicographically is
//   order-free, so the hits are the serial scan's. The same warp then
//   finds each ray's next key, its lanes over the C boxes (each box loaded
//   once for the warp's rays): the least key above the visited one whose
//   entry is <= the best t, as a serial rescan would. Pair work spreads
//   over the block's warps whatever each ray's walk length.
// - The block ends when no ray waits. Every ray visits its own chunks in
//   its own key order, so t, slot, uv and visits equal the twin's.
//
// Limits: the histogram holds C ints and the chunk id of a pick 20 bits,
// so a block needs 2 x tc x 48 B + 4 C B of dynamic shared memory beside
// the ray state; the wrapper refuses what does not fit (ROADMAP Faults).
#include <climits>
#include <cstdint>

#include "hit.cuh"
#include "tma.cuh"

namespace {

constexpr int kBlock = 256;  // rays, and threads, per block
constexpr int kWarps = kBlock / 32;
constexpr int kMaxRays = 2;  // rays a warp tests at once
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kNone = UINT64_MAX;  // no next chunk
constexpr int kIdBits = 20;             // chunk id bits of a histogram pick
constexpr unsigned kIdMask = (1u << kIdBits) - 1;

struct SlabRay {
  float ox, oy, oz, ivx, ivy, ivz;
};

// The block's rays, one array per field: thread t loads ray t.
struct Block {
  float ox[kBlock], oy[kBlock], oz[kBlock];
  float dx[kBlock], dy[kBlock], dz[kBlock];
  float ivx[kBlock], ivy[kBlock], ivz[kBlock];
  float best_t[kBlock], best_u[kBlock], best_v[kBlock];
  int best[kBlock], visits[kBlock], live[kBlock], list[kBlock];
  uint64_t next[kBlock];
  uint64_t bar[2];          // one mbarrier per stage buffer
  unsigned red[2][kWarps];  // partial picks, alternating
  int count[kWarps];        // waiting rays per warp
};

// Slab test of a ray against a chunk box lo = (bmin x, bmin y, bmin z,
// bmax x), hi = (bmax y, bmax z, validity, 0). Returns whether the ray
// enters the box at or beyond DELTA; entry = max(near, DELTA). fminf /
// fmaxf ignore NaN.
__device__ __forceinline__ bool enter_box(const float4& lo, const float4& hi,
                                          const SlabRay& r, float& entry) {
  const float tx0 = (lo.x - r.ox) * r.ivx;
  const float ty0 = (lo.y - r.oy) * r.ivy;
  const float tz0 = (lo.z - r.oz) * r.ivz;
  const float tx1 = (lo.w - r.ox) * r.ivx;
  const float ty1 = (hi.x - r.oy) * r.ivy;
  const float tz1 = (hi.y - r.oz) * r.ivz;
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fmaxf(tz0, tz1));
  entry = fmaxf(near, tpt::kDelta);
  return far >= entry && hi.z != 0.f;
}

// The least 64-bit key over the warp: a minimum of the high words, then of
// the low words among the lanes that hold it.
__device__ __forceinline__ uint64_t warp_min_key(uint64_t key) {
  const unsigned k_hi = static_cast<unsigned>(key >> 32);
  const unsigned hi = __reduce_min_sync(kFull, k_hi);
  const unsigned lo = __reduce_min_sync(
      kFull, k_hi == hi ? static_cast<unsigned>(key) : UINT_MAX);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// For each of the warp's R rays r[q]: the least key above last[q] of a
// chunk the ray enters at or before best_t[q], kNone if none. Lanes go
// over the boxes, each box loaded once for the R rays; every lane returns
// the keys.
template <int R>
__device__ __forceinline__ void next_keys(const Block& s, const int (&r)[R],
                                          const float (&best_t)[R],
                                          const uint64_t (&last)[R],
                                          uint64_t (&next)[R],
                                          const float* __restrict__ boxes,
                                          int n_chunks, int lane) {
  SlabRay ray[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    ray[q] = {s.ox[r[q]], s.oy[r[q]], s.oz[r[q]],
              s.ivx[r[q]], s.ivy[r[q]], s.ivz[r[q]]};
    next[q] = kNone;
  }
  for (int ck = lane; ck < n_chunks; ck += 32) {
    const float4* p = reinterpret_cast<const float4*>(boxes + 8 * (size_t)ck);
    const float4 lo = __ldg(p), hi = __ldg(p + 1);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      float entry;
      if (enter_box(lo, hi, ray[q], entry) && entry <= best_t[q]) {
        const uint64_t key =
            (static_cast<uint64_t>(__float_as_uint(entry)) << 32) |
            static_cast<uint32_t>(ck);
        if (key > last[q] && key < next[q]) next[q] = key;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) next[q] = warp_min_key(next[q]);
}

__device__ __forceinline__ int chunk_of(uint64_t key) {
  return key == kNone ? -1 : static_cast<int>(key & 0xffffffffu);
}

// The lexicographic minimum of (t, slot) over the warp (t > 0: its bits
// order like the floats), (u, v) fetched from the lane that holds it;
// every lane returns it.
__device__ __forceinline__ void warp_min(float& bt, int& bs, float& bu,
                                         float& bv) {
  const unsigned tb = __reduce_min_sync(kFull, __float_as_uint(bt));
  const bool at_t = __float_as_uint(bt) == tb;
  const unsigned sb =
      __reduce_min_sync(kFull, at_t ? static_cast<unsigned>(bs) : UINT_MAX);
  const int src =
      __ffs(__ballot_sync(kFull, at_t && static_cast<unsigned>(bs) == sb)) -
      1;
  bt = __uint_as_float(tb);
  bs = static_cast<int>(sb);
  bu = __shfl_sync(kFull, bu, src);
  bv = __shfl_sync(kFull, bv, src);
}

// The chunk most waiting rays wait on, ties to the lowest id, skipping
// `skip`; -1 if no ray waits on another chunk. Every thread calls it and
// gets the answer; `red` must not be the previous call's.
__device__ __forceinline__ int pick_chunk(const int* hist, int n_chunks,
                                          int skip, unsigned* red) {
  unsigned best = 0;
  for (int c = threadIdx.x; c < n_chunks; c += kBlock) {
    const unsigned h = static_cast<unsigned>(hist[c]);
    if (h != 0 && c != skip) {
      const unsigned v = (h << kIdBits) | (kIdMask - static_cast<unsigned>(c));
      best = v > best ? v : best;
    }
  }
  best = __reduce_max_sync(kFull, best);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = best;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) best = red[w] > best ? red[w] : best;
  return best == 0 ? -1 : static_cast<int>(kIdMask - (best & kIdMask));
}

// One thread: copy chunk ck's tc x 48 B of planes into buf, completing on
// bar.
__device__ __forceinline__ void stage(float* buf, const float* planes,
                                      int ck, int tc, uint64_t* bar) {
  tpt::bulk_copy(buf, planes + 12 * static_cast<size_t>(ck) * tc,
                 static_cast<uint32_t>(tc) * 48u, bar);
}

// One warp: the cnt <= R listed rays rs[0..cnt) against the staged chunk
// ck (planes in buf). Lane l tests slots l, l + 32, ... against every ray,
// so each plane is read from shared memory once for the R rays; a short
// task repeats rs[0] in its empty places and drops their results. Each
// ray's chunk result is merged into its best by the serial rule, then its
// next key is found; lane 0 writes the rays' state back and counts their
// new chunks in the histogram.
template <int R>
__device__ __forceinline__ void test_rays(Block& s, const int* rs, int cnt,
                                          const float* __restrict__ buf,
                                          int ck, int tc,
                                          const float* __restrict__ boxes,
                                          int n_chunks, int* hist, int lane) {
  int r[R];
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R];
  float bt[R], bu[R], bv[R];
  int bs[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    r[q] = rs[q < cnt ? q : 0];
    ox[q] = s.ox[r[q]];
    oy[q] = s.oy[r[q]];
    oz[q] = s.oz[r[q]];
    dx[q] = s.dx[r[q]];
    dy[q] = s.dy[r[q]];
    dz[q] = s.dz[r[q]];
    bt[q] = tpt::kRealMax;
    bs[q] = INT_MAX;
    bu[q] = 0.f;
    bv[q] = 0.f;
  }
  const int f0 = ck * tc;
  for (int k = lane; k < tc; k += 32) {
    const float4* p = reinterpret_cast<const float4*>(buf + 12 * k);
    const float4 a = p[0], b = p[1], c = p[2];
    const float w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const tpt::Origin op = tpt::origin_terms(ox[q], oy[q], oz[q], w);
      float t, u, v;
      // slots rise with k: t < bt keeps the lowest slot among equal t
      if (tpt::hit_terms(op, dx[q], dy[q], dz[q], w, t, u, v) && t < bt[q]) {
        bt[q] = t;
        bs[q] = f0 + k;
        bu[q] = u;
        bv[q] = v;
      }
    }
  }
  float best_t[R];
  bool take[R];
  uint64_t last[R], next[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    warp_min(bt[q], bs[q], bu[q], bv[q]);
    best_t[q] = s.best_t[r[q]];
    take[q] = bt[q] < best_t[q] || (bt[q] == best_t[q] && bs[q] < s.best[r[q]]);
    if (take[q]) best_t[q] = bt[q];
    last[q] = s.next[r[q]];
  }
  next_keys<R>(s, r, best_t, last, next, boxes, n_chunks, lane);
  __syncwarp();  // every lane has read the rays' state
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (q >= cnt) break;
      if (take[q]) {
        s.best_t[r[q]] = bt[q];
        s.best[r[q]] = bs[q];
        s.best_u[r[q]] = bu[q];
        s.best_v[r[q]] = bv[q];
      }
      ++s.visits[r[q]];
      s.next[r[q]] = next[q];
      if (next[q] != kNone) atomicAdd(hist + chunk_of(next[q]), 1);
    }
  }
}

__global__ void __launch_bounds__(kBlock, 3)
    packet_hit_kernel(const float* __restrict__ origins,
                      const float* __restrict__ dirs,
                      const bool* __restrict__ mask,
                      const float* __restrict__ planes,
                      const float* __restrict__ boxes,
                      const int64_t* __restrict__ perm, int n, int n_faces,
                      int n_chunks, int tc, int64_t* __restrict__ fid_out,
                      float* __restrict__ t_out, float* __restrict__ uv_out,
                      int* __restrict__ visits_out,
                      int* __restrict__ stagings_out) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Block s;
  float* const buf0 = reinterpret_cast<float*>(dyn);
  int* const hist = reinterpret_cast<int*>(dyn + 2 * 48 * (size_t)tc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * kBlock + tid;

  for (int c = tid; c < n_chunks; c += kBlock) hist[c] = 0;
  // origin xyz, direction xyz: the rows as the caller holds them
  float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool live = false;
  if (i < n) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r[k] = __ldg(origins + 3 * (size_t)i + k);
      r[3 + k] = __ldg(dirs + 3 * (size_t)i + k);
    }
    live = mask == nullptr || mask[i];
  }
  s.ox[tid] = r[0]; s.oy[tid] = r[1]; s.oz[tid] = r[2];
  s.dx[tid] = r[3]; s.dy[tid] = r[4]; s.dz[tid] = r[5];
  s.ivx[tid] = tpt::reciprocal(r[3]);
  s.ivy[tid] = tpt::reciprocal(r[4]);
  s.ivz[tid] = tpt::reciprocal(r[5]);
  s.best_t[tid] = tpt::kRealMax;
  s.best[tid] = -1;
  s.best_u[tid] = 0.f;
  s.best_v[tid] = 0.f;
  s.visits[tid] = 0;
  s.live[tid] = live;
  s.next[tid] = kNone;
  if (tid == 0) tpt::init_barriers(s.bar, 2);
  __syncthreads();
  // every live ray's first key (entry bits > 0 = last), kMaxRays rays a
  // warp at a time
  for (int first = warp * kMaxRays; first < kBlock;
       first += kWarps * kMaxRays) {
    bool any = false;
    for (int q = 0; q < kMaxRays; ++q) any |= s.live[first + q] != 0;
    if (!any) continue;
    int ids[kMaxRays];
    float best_t[kMaxRays];
    uint64_t last[kMaxRays], next[kMaxRays];
#pragma unroll
    for (int q = 0; q < kMaxRays; ++q) {
      ids[q] = first + q;
      best_t[q] = tpt::kRealMax;
      last[q] = 0;
    }
    next_keys<kMaxRays>(s, ids, best_t, last, next, boxes, n_chunks, lane);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < kMaxRays; ++q) {
        if (s.live[ids[q]] && next[q] != kNone) {
          s.next[ids[q]] = next[q];
          atomicAdd(hist + chunk_of(next[q]), 1);
        }
      }
    }
  }
  __syncthreads();

  float* const buf[2] = {buf0, buf0 + 12 * tc};
  int cur = -1, b = 0, stagings = 0, calls = 0;
  uint32_t parity = 0;  // bit k: the phase buffer k's next copy completes
  for (;;) {
    if (cur < 0) {
      cur = pick_chunk(hist, n_chunks, -1, s.red[calls++ & 1]);
      if (cur < 0) break;
      if (tid == 0) stage(buf[b], planes, cur, tc, &s.bar[b]);
      ++stagings;
    }
    const int ahead = pick_chunk(hist, n_chunks, cur, s.red[calls++ & 1]);
    if (ahead >= 0) {
      if (tid == 0) stage(buf[b ^ 1], planes, ahead, tc, &s.bar[b ^ 1]);
      ++stagings;
    }
    // list the rays waiting on cur
    const bool waiting = chunk_of(s.next[tid]) == cur;
    const unsigned m = __ballot_sync(kFull, waiting);
    if (lane == 0) s.count[warp] = __popc(m);
    tpt::wait_parity(&s.bar[b], (parity >> b) & 1u);
    parity ^= 1u << b;
    __syncthreads();
    int base = 0, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      base += w < warp ? s.count[w] : 0;
      total += s.count[w];
    }
    if (waiting) s.list[base + __popc(m & ((1u << lane) - 1u))] = tid;
    if (tid == 0) hist[cur] = 0;  // no walk comes back to a visited chunk
    __syncthreads();
    // one ray a warp at a time while at most one ray per warp waits, else
    // kMaxRays
    if (total <= kWarps) {
      if (warp < total)
        test_rays<1>(s, s.list + warp, 1, buf[b], cur, tc, boxes, n_chunks,
                     hist, lane);
    } else {
      for (int first = warp * kMaxRays; first < total;
           first += kWarps * kMaxRays)
        test_rays<kMaxRays>(s, s.list + first, min(kMaxRays, total - first),
                            buf[b], cur, tc, boxes, n_chunks, hist, lane);
    }
    __syncthreads();
    cur = ahead;
    b ^= 1;
  }
  if (i < n) {
    // the face-level hit: padding slots (at or above n_faces) miss
    const int slot = s.best[tid];
    const bool hit = slot >= 0 && slot < n_faces;
    fid_out[i] = hit ? perm[slot] : -1;
    t_out[i] = hit ? s.best_t[tid] : tpt::kRealMax;
    uv_out[2 * (size_t)i] = hit ? s.best_u[tid] : 0.f;
    uv_out[2 * (size_t)i + 1] = hit ? s.best_v[tid] : 0.f;
    visits_out[i] = s.visits[tid];
  }
  if (stagings_out != nullptr && tid == 0) stagings_out[blockIdx.x] = stagings;
}

size_t dynamic_smem(int n_chunks, int tc) {
  return 2 * 48 * static_cast<size_t>(tc) + 4 * static_cast<size_t>(n_chunks);
}

}  // namespace

// Rays per block: ops/packet.PACKET_BLOCK must equal it.
extern "C" int tpt_packet_block() { return kBlock; }

// Registers per thread and static shared memory per block of kernel C.
extern "C" int tpt_packet_resources(int* regs, int* static_smem) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, packet_hit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

// origins, dirs [N, 3] (4-byte aligned), mask [N] bool or null (every
// lane alive), planes [Fp, 12], boxes [C, 8] (16-byte aligned), perm [Fp]
// int64 (slot -> face), C * tc = Fp, C < 2^20, n_faces <= Fp; outputs fid
// [N] int64 (perm[slot], -1 for a miss or a padding slot), t [N] (FLT_MAX
// there), uv [N, 2] (0 there), visits [N] (chunks tested), and, unless
// null, stagings [ceil(N / kBlock)] (chunks each block staged). Returns
// the error of cudaFuncSetAttribute (the block's dynamic shared memory)
// or cudaGetLastError() after the launch.
extern "C" int tpt_packet_hit(const float* origins, const float* dirs,
                              const bool* mask, const float* planes,
                              const float* boxes, const int64_t* perm, int n,
                              int n_faces, int n_chunks, int tc, int64_t* fid,
                              float* t, float* uv, int* visits, int* stagings,
                              void* stream) {
  if (n_chunks <= 0 || n_chunks > static_cast<int>(kIdMask) || tc <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_bytes = dynamic_smem(n_chunks, tc);
  const cudaError_t err = cudaFuncSetAttribute(
      packet_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kBlock - 1) / kBlock;
  packet_hit_kernel<<<blocks, kBlock, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      origins, dirs, mask, planes, boxes, perm, n, n_faces, n_chunks, tc, fid,
      t, uv, visits, stagings);
  return static_cast<int>(cudaGetLastError());
}
