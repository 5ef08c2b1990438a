// Kernel A: dense closest hit of N rays against all Fp triangles, with the
// SUPER gate on scenes of 4,096 padded faces or more.
//
// Replaces the TPU kernel tinypathtracer_tpu/ops/dense.py
// `_make_dense_kernel` (called through `_dense_pallas`, gated and
// ungated). Plain twin: tinypathtracer_tpu_torch/ops/dense.py
// `_dense_torch`; plain model of its gate: `_dense_schedule`.
//
// What bounds it on the H100: the pair tests, on the CUDA cores. A (ray,
// triangle) pair costs about 21 fp32 multiply-adds, one IEEE divide (a
// sequence of some ten instructions) and eight compares and selects; the
// bound counts 39 operations a pair (tools/common.py). The planes are 48 B
// a slot and every block reads all of them: bytes are no limit, but the
// original design's three global loads a pair were instructions. What the
// design does:
// - Runs. The slots are cut into runs of kSuper (1,024, the JAX package's
//   SUPER) taken in ascending order. A block of kThreads threads holds
//   kBlockRays rays: warp w the kWarpRays consecutive rays from
//   w * kWarpRays, lane l of it the rays l, l + 32, ... (kRays each).
// - The gate (`boxes` given: scenes of >= 4,096 padded faces). Before a
//   run each lane slab-tests its rays against the run's box (widened on the
//   host, ops/dense.precompute_woop): a ray needs the run when it enters
//   the box at or beyond DELTA no later than its best t so far. A warp
//   tests the run only when one of its lanes needs it (__any_sync); a block
//   stages it only when one of its warps needs it (__syncthreads_or).
//   Without the gate every warp that holds a live ray needs every run.
//   Masked rays (live[i] = 0) never vote, and report a miss.
// - Staging. Thread 0 copies a needed run into shared memory by TMA, one
//   cp.async.bulk per kTile-slot tile on its own mbarrier, so that the
//   tests start on the first tile while the rest land. The threads read a
//   slot's planes as three shared-memory broadcasts, which serve kRays
//   rays.
// - One origin. Where every ray a thread holds leaves from the same point
//   (camera rays), o' = W o + c is computed once a slot for all of them:
//   12 of the ~40 instructions of a pair. Each warp decides once, and the
//   rays' bits do not change.
// - Slots ascend and only a strictly smaller t updates, so the lowest slot
//   wins ties. A ray keeps (t, slot); its winner's (u, v) are computed once
//   at the end, with the same operations on the same operands (the same
//   bits as in the sweep).
// - Counters, when asked for: the runs each warp tested and the runs each
//   block staged. chip_smoke.py holds them to `_dense_schedule`'s.
// The hit arithmetic is hit.cuh's (origin_terms, hit_terms).
#include <cstdint>

#include "hit.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 256;       // threads per block: ops/dense
constexpr int kRays = 4;            // rays per thread: ops/dense
constexpr int kMinBlocks = 3;       // blocks an SM (85 registers a thread)
constexpr int kSuper = 1024;        // slots per run: ops/dense.SUPER
constexpr int kTile = 128;          // slots per TMA copy
constexpr int kTiles = kSuper / kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRays = 32 * kRays;
constexpr int kBlockRays = kThreads * kRays;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kRunBytes = static_cast<size_t>(kSuper) * 48;

// The gate's slab test of a ray against a run's box: whether it enters the
// box at or beyond DELTA and no later than its best t (the JAX gate's
// rule). fminf / fmaxf ignore NaN, as the twin's torch.fmin / fmax do.
__device__ __forceinline__ bool enters(const float lo[3], const float hi[3],
                                       float ox, float oy, float oz,
                                       float ivx, float ivy, float ivz,
                                       float best) {
  const float tx0 = (lo[0] - ox) * ivx, tx1 = (hi[0] - ox) * ivx;
  const float ty0 = (lo[1] - oy) * ivy, ty1 = (hi[1] - oy) * ivy;
  const float tz0 = (lo[2] - oz) * ivz, tz1 = (hi[2] - oz) * ivz;
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fmaxf(tz0, tz1));
  return far >= fmaxf(near, tpt::kDelta) && near <= best;
}

// The slots [base, base + m) of a staged tile against a thread's rays, in
// ascending order: a strictly smaller t updates (t, slot). kOneOrigin: all
// of the thread's live rays leave from (rx, ry, rz), whose o' serves them.
template <bool kOneOrigin>
__device__ __forceinline__ void test_tile(
    const float* tile, int base, int m, float rx, float ry, float rz,
    const float (&ox)[kRays], const float (&oy)[kRays],
    const float (&oz)[kRays], const float (&dx)[kRays],
    const float (&dy)[kRays], const float (&dz)[kRays],
    float (&best_t)[kRays], int (&best)[kRays]) {
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    float w[12];
    tpt::load_planes_shared(tile + 12 * j, w);
    tpt::Origin op[kRays];
    if (kOneOrigin) op[0] = tpt::origin_terms(rx, ry, rz, w);
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      if (!kOneOrigin) op[q] = tpt::origin_terms(ox[q], oy[q], oz[q], w);
      float t, u, v;
      const bool hit = tpt::hit_terms(op[kOneOrigin ? 0 : q], dx[q], dy[q],
                                      dz[q], w, t, u, v);
      if (hit & (t < best_t[q])) {
        best_t[q] = t;
        best[q] = base + j;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    dense_hit_kernel(const float* __restrict__ rays,
                     const float* __restrict__ planes,
                     const float* __restrict__ boxes, int n_boxes,
                     const unsigned char* __restrict__ live, int n, int fp,
                     float* __restrict__ t_out, int* __restrict__ slot_out,
                     float* __restrict__ uv_out, int* __restrict__ tested_out,
                     int* __restrict__ staged_out) {
  extern __shared__ __align__(128) unsigned char dyn[];
  float* const run = reinterpret_cast<float*>(dyn);
  __shared__ __align__(8) uint64_t bars[kTiles];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kBlockRays + warp * kWarpRays + lane;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float ivx[kRays], ivy[kRays], ivz[kRays], best_t[kRays];
  int best[kRays];
  bool on[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int i = first + 32 * q;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (i < n) {  // origin xyz, direction xyz, two unread columns
      const float4* p =
          reinterpret_cast<const float4*>(rays + 8 * static_cast<size_t>(i));
      a = __ldg(p);
      b = __ldg(p + 1);
    }
    ox[q] = a.x; oy[q] = a.y; oz[q] = a.z;
    dx[q] = a.w; dy[q] = b.x; dz[q] = b.y;
    ivx[q] = tpt::reciprocal(a.w);
    ivy[q] = tpt::reciprocal(b.x);
    ivz[q] = tpt::reciprocal(b.y);
    best_t[q] = tpt::kRealMax;
    best[q] = -1;
    on[q] = i < n && (live == nullptr || live[i] != 0);
  }
  // one origin for the thread's live rays (a masked ray's result is never
  // read, so its origin does not matter), decided for the whole warp
  float rx = ox[0], ry = oy[0], rz = oz[0];
#pragma unroll
  for (int q = kRays - 1; q >= 0; --q)
    if (on[q]) rx = ox[q], ry = oy[q], rz = oz[q];
  bool same = true;
#pragma unroll
  for (int q = 0; q < kRays; ++q)
    same &= !on[q] || (__float_as_uint(ox[q]) == __float_as_uint(rx) &&
                       __float_as_uint(oy[q]) == __float_as_uint(ry) &&
                       __float_as_uint(oz[q]) == __float_as_uint(rz));
  const bool one_origin = __all_sync(kFull, same);
  if (threadIdx.x == 0) tpt::init_barriers(bars, kTiles);
  __syncthreads();
  int tested = 0, staged = 0;
  const int runs = (fp + kSuper - 1) / kSuper;
  for (int s = 0; s < runs; ++s) {
    bool need = false;
    if (boxes != nullptr) {
      const float lo[3] = {__ldg(boxes + s), __ldg(boxes + n_boxes + s),
                           __ldg(boxes + 2 * n_boxes + s)};
      const float hi[3] = {__ldg(boxes + 3 * n_boxes + s),
                           __ldg(boxes + 4 * n_boxes + s),
                           __ldg(boxes + 5 * n_boxes + s)};
      if (__ldg(boxes + 6 * n_boxes + s) != 0.f) {
#pragma unroll
        for (int q = 0; q < kRays; ++q)
          need |= on[q] && enters(lo, hi, ox[q], oy[q], oz[q], ivx[q],
                                  ivy[q], ivz[q], best_t[q]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < kRays; ++q) need |= on[q];
    }
    const bool warp_need = __any_sync(kFull, need);
    // also the barrier after which the run buffer's last readers are done
    if (!__syncthreads_or(warp_need)) continue;
    const int lo = s * kSuper, slots = min(kSuper, fp - lo);
    const int tiles = (slots + kTile - 1) / kTile;
    if (threadIdx.x == 0)
      for (int k = 0; k < tiles; ++k)
        tpt::bulk_copy(
            run + 12 * kTile * k,
            planes + 12 * static_cast<size_t>(lo + kTile * k),
            static_cast<uint32_t>(min(kTile, slots - kTile * k)) * 48u,
            bars + k);
    const uint32_t parity = static_cast<uint32_t>(staged) & 1u;
    ++staged;
    if (!warp_need) continue;
    ++tested;
    for (int k = 0; k < tiles; ++k) {
      tpt::wait_parity(bars + k, parity);
      const float* tile = run + 12 * kTile * k;
      const int base = lo + kTile * k, m = min(kTile, slots - kTile * k);
      if (one_origin)
        test_tile<true>(tile, base, m, rx, ry, rz, ox, oy, oz, dx, dy, dz,
                        best_t, best);
      else
        test_tile<false>(tile, base, m, rx, ry, rz, ox, oy, oz, dx, dy, dz,
                         best_t, best);
    }
  }
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int i = first + 32 * q;
    if (i >= n) continue;
    const int slot = on[q] ? best[q] : -1;
    float t = tpt::kRealMax, u = 0.f, v = 0.f;
    if (slot >= 0) {
      float w[12];
      tpt::load_planes(planes + 12 * static_cast<size_t>(slot), w);
      tpt::hit_terms(tpt::origin_terms(ox[q], oy[q], oz[q], w), dx[q], dy[q],
                     dz[q], w, t, u, v);
      t = best_t[q];
    }
    t_out[i] = t;
    slot_out[i] = slot;
    uv_out[2 * static_cast<size_t>(i)] = u;
    uv_out[2 * static_cast<size_t>(i) + 1] = v;
  }
  if (tested_out != nullptr && lane == 0)
    tested_out[blockIdx.x * kWarps + warp] = tested;
  if (staged_out != nullptr && threadIdx.x == 0)
    staged_out[blockIdx.x] = staged;
}

// The run buffer's dynamic shared memory, allowed above the 48 KB default;
// then the blocks an SM holds, refusing 0 (a launch that could never run).
cudaError_t prepare(int* per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      dense_hit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRunBytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, dense_hit_kernel, kThreads, kRunBytes);
  if (err == cudaSuccess && *per_sm < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace

// Threads per block and rays per thread: ops/dense.DENSE_THREADS and
// DENSE_RAYS must equal them.
extern "C" int tpt_dense_geometry(int* threads, int* rays_per_thread) {
  *threads = kThreads;
  *rays_per_thread = kRays;
  return 0;
}

// Registers and local (spill) bytes per thread, and blocks an SM.
extern "C" int tpt_dense_resources(int* regs, int* local_bytes,
                                   int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = prepare(blocks_per_sm);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, dense_hit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// rays [N, 8] and planes [Fp, 12] (16-byte aligned); boxes: null (no gate)
// or [8, n_boxes] with n_boxes = Fp / 1024 (ops/dense.WoopTris.sp_boxes);
// live: null (every ray) or [N] bytes, 0 = masked. Outputs t [N] (FLT_MAX
// on a miss), slot [N] (-1 on a miss), uv [N, 2] (0 on a miss), and, unless
// null, tested [blocks * kWarps] (runs each warp tested) and staged
// [blocks] (runs each block staged), blocks = ceil(N / kBlockRays).
// Returns the error of the set-up or cudaGetLastError() after the launch.
extern "C" int tpt_dense_hit(const float* rays, const float* planes,
                             const float* boxes, int n_boxes,
                             const unsigned char* live, int n, int fp,
                             float* t, int* slot, float* uv, int* tested,
                             int* staged, void* stream) {
  if (n <= 0 || fp <= 0 ||
      (boxes != nullptr && (fp % kSuper != 0 || n_boxes != fp / kSuper)))
    return static_cast<int>(cudaErrorInvalidValue);
  int per_sm;
  const cudaError_t err = prepare(&per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kBlockRays - 1) / kBlockRays;
  dense_hit_kernel<<<blocks, kThreads, kRunBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      rays, planes, boxes, n_boxes, live, n, fp, t, slot, uv, tested, staged);
  return static_cast<int>(cudaGetLastError());
}
