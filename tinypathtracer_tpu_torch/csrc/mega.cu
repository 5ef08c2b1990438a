// Kernel B: the reference-mode path-tracing megakernel, forward.
//
// Replaces the TPU kernel tinypathtracer_tpu/ops/mega.py
// `_make_mega_kernel` (called through `_mega_pallas`; ungated). Plain twin:
// tinypathtracer_tpu_torch/ops/mega.py `_mega_torch`. Every expression
// below transcribes the twin's (and the JAX kernel's) in the same order;
// see hit.cuh for the roundings.
//
// Two instances per light count: the forward (kSaveHits = false) and the
// train step's forward (kSaveHits = true), which also writes the per-bounce
// hit residuals that the backward replays shading on: [8 * depth, N]
// floats, per bounce the rows slot, t, u, v, slot2, occlusion bitmask
// (bit li = light li occluded), 0, 0. A bounce the lane never reaches (it
// missed or died earlier) reads "dead": slot -1, t REAL_MAX, slot2 -1, the
// rest 0. The emissive bounce keeps its hit (slot, t, u, v) with slot2 -1
// and occlusion 0; slot2 and occlusion are read only on live lanes. A
// lane writes the columns of the path it holds, so these stores scatter.
//
// What bounds it on the H100: per (path, triangle, query) about 21 fp32
// operations and one IEEE divide, plus 18 per (origin, triangle) shared
// by the queries of a bounce; O(F) per query: compute-bound on the CUDA
// cores. What it wastes is lanes: a path ends at a miss or an emissive
// hit, and with one path per thread a warp ran until its longest path
// ended, its dead lanes idling through every later sweep.
//
// Design: persistent blocks whose lanes are refilled from a pool of paths.
// - The grid is as many blocks of lanes(lights) lanes as the SMs hold at
//   once (at most one block per lanes(lights) paths). Block b of G takes
//   the paths b, b + G, b + 2G, ... in that order: every block gets a like
//   share of the frame's long and short paths.
// - The block runs in rounds. First each lane that holds a path shades
//   its ray's hit: the shading fetch (an indexed load of the hit slot's
//   face-major row of 32 floats), emission, the BSDF sample, the extra
//   emitter and the light directions. A path that ends there (miss,
//   emissive hit, or every bounce done) writes its out column and its
//   remaining dead residual rows and frees the lane. Free lanes then take
//   the next paths of the pool in lane order (ballot and prefix count over
//   the block's warps: deterministic; ops/mega._mega_schedule models it)
//   and start at their camera query. Then one sweep over the triangles
//   serves every lane's queries: a fresh path's camera direction; a live
//   path's next direction (not on the last bounce, whose result is never
//   read), its extra emitter direction (diffuse lanes only) and up to 6
//   delta-light any-hits (each stops at its first occluder; no
//   max-distance clip, a reference quirk). A lane idles only once its
//   block's pool is spent.
// - Each path runs the one-path-per-thread kernel's arithmetic in the same
//   order, so its bits do not change: only which lane runs it, and when.
// - The planes come into shared memory by TMA, in tiles of kTile slots
//   (one cp.async.bulk of kTile x 48 B each, completing on an mbarrier),
//   through a ring of kStages (stages(lights)) buffers: tile k + kStages
//   is copied as soon as tile k is tested, so the copies run ahead of the
//   tests. A scene of at most kStages tiles is copied once and stays. The
//   tests read the planes as shared-memory broadcasts.
// - Across a sweep a lane keeps only what the sweep and the accumulation
//   after it need: residual rows 0-3 are stored before the sweep, the
//   base color is read again and the light radiance computed again after
//   it (the same operations on the same operands: the same bits).
// The lights table sits in shared memory. The env lookup of lanes that
// missed runs after the kernel. The shading arithmetic (BSDF sample,
// hemisphere sample, delta lights) lives in shade.cuh, which the modular
// bounce's kernels (shade.cu) share.
#include <cstdint>

#include "hit.cuh"
#include "shade.cuh"
#include "tma.cuh"

namespace {

constexpr int kShadeRows = 32;
constexpr int kRowNrm = 12, kRowBase = 21, kRowEm = 24, kRowEta = 25,
              kRowMetal = 26;

constexpr int kTile = 128;     // slots of a staged tile
constexpr unsigned kFull = 0xffffffffu;

// Each instance's block (__launch_bounds__). Up to two lights' state fits
// 64 registers a thread: two blocks an SM of 512 lanes, whose 16-deep ring
// (96 KB) holds the room's 15 tiles resident. Above, three blocks of 256
// lanes (80 registers) with a 4-deep ring: one block of 512 at 80-114
// registers would leave the SM half its lanes.
__host__ __device__ constexpr int lanes(int lights) {
  return lights <= 2 ? 512 : 256;
}
__host__ __device__ constexpr int min_blocks(int lights) {
  return lights <= 2 ? 2 : 3;
}
__host__ __device__ constexpr int stages(int lights) {
  return lights <= 2 ? 16 : 4;
}
constexpr size_t ring_bytes(int lights) {
  return static_cast<size_t>(stages(lights)) * kTile * 48;
}

// The planes' ring: kStages buffers of kTile slots in dynamic shared
// memory, an mbarrier each. Tile g of the sweep sequence (tile g mod nt of
// every round) lands in buffer g mod kStages, in its mbarrier's phase
// g / kStages. A scene of nt <= kStages tiles is resident instead: tile t
// is copied once, into buffer t.
__device__ __forceinline__ float* tile_buffer(int s) {
  extern __shared__ __align__(128) unsigned char dyn[];
  return reinterpret_cast<float*>(dyn) + 12 * kTile * s;
}

// One thread: copy tile t (its slots, 48 B each) into buffer s.
__device__ __forceinline__ void stage(const float* planes, int fp, int t,
                                      int s, uint64_t* bars) {
  const uint32_t bytes = static_cast<uint32_t>(min(kTile, fp - t * kTile)) *
                         48u;
  tpt::bulk_copy(tile_buffer(s), planes + 12 * static_cast<size_t>(t) * kTile,
                 bytes, bars + s);
}

// Thread 0 starts the ring: every tile of a resident scene, else the first
// kStages tiles of the sequence. A resident scene is waited for here.
template <int kStages>
__device__ __forceinline__ void start_ring(const float* planes, int fp,
                                           int nt, uint64_t* bars) {
  if (threadIdx.x == 0) {
    tpt::init_barriers(bars, kStages);
    const int copies = nt <= kStages ? nt : kStages;
    for (int k = 0; k < copies; ++k) stage(planes, fp, k, k, bars);
  }
  __syncthreads();
  if (nt <= kStages)
    for (int k = 0; k < nt; ++k) tpt::wait_parity(bars + k, 0);
}

// The copies still in flight when the block ends (tiles g .. g + kStages
// - 1 of the sequence): waited for, so that none lands in shared memory
// the block no longer owns.
template <int kStages>
__device__ __forceinline__ void drain_ring(int nt, unsigned g,
                                          uint64_t* bars) {
  if (nt <= kStages) return;
  for (unsigned k = g; k < g + kStages; ++k)
    tpt::wait_parity(bars + k % kStages, (k / kStages) & 1u);
}

// One sweep over all triangles for every lane's queries from its origin
// (ox, oy, oz): up to two closest-hit directions (slot -1 on a miss or
// where the query is not needed) and the any-hits of the lights not yet
// occluded. Slots ascend and only a strictly smaller t updates: ties go to
// the lowest slot. Every thread of the block calls it, with the ring's
// next tile g of the sequence.
template <int kLights>
__device__ __forceinline__ void sweep(const float* __restrict__ planes,
                                      int fp, int nt, uint64_t* bars,
                                      unsigned& g, float ox, float oy,
                                      float oz,
                                      bool need_a, const float da[3],
                                      int& slot_a, bool need_b,
                                      const float db[3], int& slot_b,
                                      const float wi[][3], bool occluded[]) {
  constexpr int kStages = stages(kLights);
  bool active = need_a || need_b;
#pragma unroll
  for (int li = 0; li < kLights; ++li) active = active || !occluded[li];
  float best_a = tpt::kRealMax, best_b = tpt::kRealMax;
  int arg_a = -1, arg_b = -1;
  const bool ring = nt > kStages;  // else resident
  for (int t = 0; t < nt; ++t) {
    const int s = ring ? static_cast<int>(g % kStages) : t;
    if (ring) tpt::wait_parity(bars + s, (g / kStages) & 1u);
    const int f0 = t * kTile, cnt = min(kTile, fp - f0);
    const float* src = tile_buffer(s);
    if (active) {
      // four slots an iteration: the compiler overlaps their tests (the
      // order of the updates does not change)
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        float w[12];
        tpt::load_planes_shared(src + 12 * k, w);
        const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
        float th, u, v;
        if (need_a && tpt::hit_terms(op, da[0], da[1], da[2], w, th, u, v) &&
            th < best_a) {
          best_a = th;
          arg_a = f0 + k;
        }
        if (need_b && tpt::hit_terms(op, db[0], db[1], db[2], w, th, u, v) &&
            th < best_b) {
          best_b = th;
          arg_b = f0 + k;
        }
#pragma unroll
        for (int li = 0; li < kLights; ++li) {
          if (!occluded[li]) {
            occluded[li] =
                tpt::hit_terms(op, wi[li][0], wi[li][1], wi[li][2], w, th, u,
                               v);
          }
        }
      }
    }
    if (ring) {
      __syncthreads();  // every lane has tested buffer s: refill it
      if (threadIdx.x == 0)
        stage(planes, fp, static_cast<int>((g + kStages) % nt), s, bars);
      ++g;
    }
  }
  slot_a = arg_a;
  slot_b = arg_b;
}

// Block b of g holds the pool of paths b, b + g, b + 2g, ... of the n:
// every block gets a like share of the frame's long and short paths. The
// pool's size, and the path of its k-th entry.
__device__ __forceinline__ int pool_size(int n, int b, int g) {
  return (n - b + g - 1) / g;
}
__device__ __forceinline__ int pool_path(int n, int b, int g, int k) {
  return b + k * g;
}

// Residual rows k0 .. k0 + kCount - 1 of one bounce (column `path` of
// [8 * depth, N]).
template <int kCount>
__device__ __forceinline__ void store_rows(float* __restrict__ hits, int n,
                                           int path, int dep, int k0,
                                           const float (&row)[kCount]) {
  float* h = hits + static_cast<size_t>(8 * dep + k0) * n + path;
#pragma unroll
  for (int k = 0; k < kCount; ++k) h[static_cast<size_t>(k) * n] = row[k];
}

// The light count is a template parameter: the per-light state (direction,
// occlusion) then takes registers only for lights that exist. kSaveHits
// adds the residual stores and nothing else: every value it stores is live
// in the forward already.
template <int kLights, bool kSaveHits>
__global__ void __launch_bounds__(lanes(kLights), min_blocks(kLights))
    mega_kernel(const float* __restrict__ rays8,
                const float* __restrict__ u8d,
                const float* __restrict__ planes,
                const float* __restrict__ shade,
                const float* __restrict__ lights, int n, int fp, int depth,
                float* __restrict__ out, float* __restrict__ hits,
                int* __restrict__ rounds_out) {
  constexpr int kSlots = kLights > 0 ? kLights : 1;
  constexpr int kThreads = lanes(kLights), kWarps = kThreads / 32;
  constexpr int kStages = stages(kLights);
  __shared__ float s_lights[kSlots * 16];
  __shared__ uint64_t s_bar[kStages];
  __shared__ int s_free[2][kWarps], s_busy[2][kWarps];  // by round parity
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < kLights * 16; k += kThreads) s_lights[k] = lights[k];
  const int nt = (fp + kTile - 1) / kTile;
  unsigned g = 0;  // the ring's next tile of the sequence
  start_ring<kStages>(planes, fp, nt, s_bar);

  const int blocks = gridDim.x;
  const int pool = pool_size(n, blockIdx.x, blocks);
  int taken = 0, rounds = 0;

  // the lane's path: -1 none; its next bounce (-1: the camera query is in
  // flight) and the slot its ray hit
  int path = -1, dep = 0, slot = -1;
  float ox = 0.f, oy = 0.f, oz = 0.f;  // the ray: origin,
  float da[3] = {0.f, 0.f, 0.f};       // direction (the next-direction query)
  float db[3] = {0.f, 0.f, 0.f};       // the extra emitter query
  float tr = 1.f, tg = 1.f, tb = 1.f;  // throughput
  float rr = 0.f, rg = 0.f, rb = 0.f;  // radiance
  float ratio = 0.f;                   // the bounce's BSDF ratio
  float wi[kSlots][3];
  bool occluded[kSlots];
  for (int r = 0;; r = !r) {
    // ---- shade each held ray's hit; a path that ends frees its lane
    bool need_a = false, need_b = false;
#pragma unroll
    for (int li = 0; li < kSlots; ++li) occluded[li] = true;
    if (path >= 0) {
      bool missed = false, ends = true;
      int dead_from = dep;  // first residual bounce left dead
      if (dep < depth && slot < 0) {
        missed = true;  // the epilogue adds thr * env(dir)
      } else if (dep < depth) {
        const float dx = da[0], dy = da[1], dz = da[2];
        const float* u = u8d + static_cast<size_t>(8 * dep) * n + path;
        const float u0 = u[0], u1 = u[n], u2 = u[2 * static_cast<size_t>(n)],
                    u3 = u[3 * static_cast<size_t>(n)],
                    u4 = u[4 * static_cast<size_t>(n)];
        // hit slot's row: planes, then shading; (t, u, v) recomputed with
        // the query's arithmetic, bit-equal to the values it compared
        const float* row = shade + static_cast<size_t>(slot) * kShadeRows;
        float w[12];
        tpt::load_planes(row, w);
        float tw, uw, vw;
        tpt::hit_terms(tpt::origin_terms(ox, oy, oz, w), dx, dy, dz, w, tw,
                       uw, vw);
        const float ww = 1.f - uw - vw;
        float nx = (ww * row[kRowNrm + 0] + uw * row[kRowNrm + 3]) +
                   vw * row[kRowNrm + 6];
        float ny = (ww * row[kRowNrm + 1] + uw * row[kRowNrm + 4]) +
                   vw * row[kRowNrm + 7];
        float nz = (ww * row[kRowNrm + 2] + uw * row[kRowNrm + 5]) +
                   vw * row[kRowNrm + 8];
        const float inv =
            tpt::inv_sqrt(tpt::nan_max((nx * nx + ny * ny) + nz * nz,
                                       1e-20f));
        nx = nx * inv;
        ny = ny * inv;
        nz = nz * inv;
        const float hx = ox + tw * dx, hy = oy + tw * dy, hz = oz + tw * dz;
        const float em = row[kRowEm], eta = row[kRowEta],
                    metallic = row[kRowMetal];
        // an emissive hit adds the raw scalar emission and ends the path
        const bool emissive = em > 0.f;
        const float hit_em = emissive ? em : 0.f;
        rr = rr + tr * hit_em;
        rg = rg + tg * hit_em;
        rb = rb + tb * hit_em;
        if constexpr (kSaveHits) {
          const float hit[4] = {static_cast<float>(slot), tw, uw, vw};
          const float rest[4] = {-1.f, 0.f, 0.f, 0.f};
          store_rows(hits, n, path, dep, 0, hit);
          if (emissive) {
            store_rows(hits, n, path, dep, 4, rest);
          } else {  // slot2 and occlusion follow the sweep
            const float zeros[2] = {0.f, 0.f};
            store_rows(hits, n, path, dep, 6, zeros);
          }
        }
        if (emissive) {
          dead_from = dep + 1;
        } else {
          ends = false;
          float ndx, ndy, ndz;
          tpt::sample_bsdf(u0, u1, u2, dx, dy, dz, nx, ny, nz, eta, metallic,
                           ndx, ndy, ndz, ratio);
          // extra direct-emitter sample on diffuse lanes
          need_b = !((eta >= 1.f) || (metallic > 0.f));
          const float sgn =
              tpt::dot3(dx, dy, dz, nx, ny, nz) > 0.f ? -1.f : 1.f;
          float pdf2;
          tpt::hemi_cos(u3, u4, nx * sgn, ny * sgn, nz * sgn, db[0], db[1],
                        db[2], pdf2);
#pragma unroll
          for (int li = 0; li < kLights; ++li) {
            float lrad[3];
            occluded[li] = false;
            tpt::delta_light(s_lights + 16 * li, hx, hy, hz, wi[li], lrad);
          }
          need_a = dep + 1 < depth;
          ox = hx;
          oy = hy;
          oz = hz;
          da[0] = ndx;
          da[1] = ndy;
          da[2] = ndz;
        }
      }
      if (ends) {
        const float res[9] = {rr,  rg,  rb,  missed ? tr : 0.f,
                              missed ? tg : 0.f, missed ? tb : 0.f,
                              da[0], da[1], da[2]};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          out[static_cast<size_t>(k) * n + path] = k < 9 ? res[k] : 0.f;
        if constexpr (kSaveHits) {
          const float dead[8] = {-1.f, tpt::kRealMax, 0.f, 0.f,
                                 -1.f, 0.f,           0.f, 0.f};
          for (int d = dead_from; d < depth; ++d)
            store_rows(hits, n, path, d, 0, dead);
        }
        path = -1;
      }
    }

    // ---- free lanes take the next paths of the pool, in lane order
    const bool free_lane = path < 0;
    const unsigned m = __ballot_sync(kFull, free_lane);
    if (lane == 0) {
      s_free[r][warp] = __popc(m);
      s_busy[r][warp] = 32 - __popc(m);
    }
    __syncthreads();
    int base = 0, n_free = 0, n_busy = 0;
    for (int w = 0; w < kWarps; ++w) {
      base += w < warp ? s_free[r][w] : 0;
      n_free += s_free[r][w];
      n_busy += s_busy[r][w];
    }
    const int take = min(n_free, pool - taken);
    if (n_busy + take == 0) break;
    const int q = base + __popc(m & ((1u << lane) - 1u));
    if (free_lane && q < take) {
      path = pool_path(n, blockIdx.x, blocks, taken + q);
      ox = rays8[path];
      oy = rays8[n + path];
      oz = rays8[2 * static_cast<size_t>(n) + path];
      da[0] = rays8[4 * static_cast<size_t>(n) + path];
      da[1] = rays8[5 * static_cast<size_t>(n) + path];
      da[2] = rays8[6 * static_cast<size_t>(n) + path];
      tr = tg = tb = 1.f;
      rr = rg = rb = 0.f;
      dep = -1;
      need_a = true;
    }
    taken += take;

    // ---- one sweep serves every lane's queries
    int slot_a, slot_b;
    sweep<kLights>(planes, fp, nt, s_bar, g, ox, oy, oz, need_a, da, slot_a,
                   need_b, db, slot_b, wi, occluded);
    ++rounds;

    // ---- a live bounce gathers its extra emitter and its lights
    if (path >= 0 && dep >= 0) {
      const float* row = shade + static_cast<size_t>(slot) * kShadeRows;
      const float br = row[kRowBase], bg = row[kRowBase + 1],
                  bb = row[kRowBase + 2];
      const float wr = br * ratio, wg = bg * ratio, wb = bb * ratio;
      const float em2 =
          (slot_b >= 0 && need_b)
              ? shade[static_cast<size_t>(slot_b) * kShadeRows + kRowEm]
              : 0.f;
      float dr = em2, dg = em2, dbl = em2;
#pragma unroll
      for (int li = 0; li < kLights; ++li) {
        float unused[3], lrad[3];
        tpt::delta_light(s_lights + 16 * li, ox, oy, oz, unused, lrad);
        dr = dr + (occluded[li] ? 0.f : br * lrad[0]);
        dg = dg + (occluded[li] ? 0.f : bg * lrad[1]);
        dbl = dbl + (occluded[li] ? 0.f : bb * lrad[2]);
      }
      rr = rr + tr * wr * dr;
      rg = rg + tg * wg * dg;
      rb = rb + tb * wb * dbl;
      if constexpr (kSaveHits) {
        float occ = 0.f;
#pragma unroll
        for (int li = 0; li < kLights; ++li)
          occ = occ + (occluded[li] ? static_cast<float>(1 << li) : 0.f);
        const float rows[2] = {
            (need_b && slot_b >= 0) ? static_cast<float>(slot_b) : -1.f, occ};
        store_rows(hits, n, path, dep, 4, rows);
      }
      tr = tr * wr;
      tg = tg * wg;
      tb = tb * wb;
    }
    if (path >= 0) {  // the next bounce shades what the ray hit
      slot = slot_a;
      ++dep;
    }
  }
  drain_ring<kStages>(nt, g, s_bar);
  if (rounds_out != nullptr && tid == 0) rounds_out[blockIdx.x] = rounds;
}

// The ring's dynamic shared memory, allowed above the 48 KB default.
template <int kLights, bool kSaveHits>
cudaError_t allow_ring() {
  return cudaFuncSetAttribute(mega_kernel<kLights, kSaveHits>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(ring_bytes(kLights)));
}

template <int kLights, bool kSaveHits>
cudaError_t launch(const float* rays8, const float* u8d, const float* planes,
                   const float* shade, const float* lights, int n, int fp,
                   int depth, int blocks, float* out, float* hits,
                   int* rounds, cudaStream_t stream) {
  const cudaError_t err = allow_ring<kLights, kSaveHits>();
  if (err != cudaSuccess) return err;
  mega_kernel<kLights, kSaveHits>
      <<<blocks, lanes(kLights), ring_bytes(kLights), stream>>>(
          rays8, u8d, planes, shade, lights, n, fp, depth, out, hits, rounds);
  return cudaGetLastError();
}

// The persistent grid: the blocks the SMs hold at once, at most one per
// lanes(kLights) paths.
template <int kLights, bool kSaveHits>
cudaError_t grid(int n, int* blocks) {
  int dev, sms, per_sm;
  cudaError_t err = allow_ring<kLights, kSaveHits>();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mega_kernel<kLights, kSaveHits>, lanes(kLights),
        ring_bytes(kLights));
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = min(sms * per_sm, (n + lanes(kLights) - 1) / lanes(kLights));
  return cudaSuccess;
}

template <int kLights, bool kSaveHits>
cudaError_t attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, mega_kernel<kLights, kSaveHits>);
}

struct Instance {
  cudaError_t (*launch)(const float*, const float*, const float*,
                        const float*, const float*, int, int, int, int,
                        float*, float*, int*, cudaStream_t);
  cudaError_t (*grid)(int, int*);
  cudaError_t (*attributes)(cudaFuncAttributes*);
};

template <int kLights, bool kSaveHits>
constexpr Instance instance() {
  return {launch<kLights, kSaveHits>, grid<kLights, kSaveHits>,
          attributes<kLights, kSaveHits>};
}

// [save_hits][n_lights]
constexpr Instance kInstances[2][tpt::kMaxLights + 1] = {
    {instance<0, false>(), instance<1, false>(), instance<2, false>(),
     instance<3, false>(), instance<4, false>(), instance<5, false>(),
     instance<6, false>()},
    {instance<0, true>(), instance<1, true>(), instance<2, true>(),
     instance<3, true>(), instance<4, true>(), instance<5, true>(),
     instance<6, true>()}};

}  // namespace

// Lanes per block of the instances for n_lights: ops/mega.mega_threads
// must equal it.
extern "C" int tpt_mega_threads(int n_lights) { return lanes(n_lights); }

// The grid tpt_mega_trace launches for n paths (blocks <= 0 there).
extern "C" int tpt_mega_grid(int n, int n_lights, int save_hits,
                             int* blocks) {
  if (n_lights < 0 || n_lights > tpt::kMaxLights || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      kInstances[save_hits != 0][n_lights].grid(n, blocks));
}

// rays8 [8, N], u8d [8*depth, N], planes [Fp, 12] and shade [Fp, 32]
// (face-major, 16-byte aligned), lights [max(L,1), 16] with L <= 6;
// out [16, N]: radiance rgb, throughput at miss rgb, final direction, 0;
// hits: NULL, or [8*depth, N] for the per-bounce hit residuals (the
// kSaveHits instance). blocks: the grid, 1..N (each block then has a
// pool of paths), or <= 0 for tpt_mega_grid's; rounds: NULL, or [blocks]
// for the sweeps each block ran. Returns the error of
// cudaFuncSetAttribute (the ring's dynamic shared memory) or
// cudaGetLastError() after the launch.
extern "C" int tpt_mega_trace(const float* rays8, const float* u8d,
                              const float* planes, const float* shade,
                              const float* lights, int n, int fp, int depth,
                              int n_lights, int blocks, float* out,
                              float* hits, int* rounds, void* stream) {
  if (n_lights < 0 || n_lights > tpt::kMaxLights || n <= 0 || fp <= 0 ||
      blocks > n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Instance& inst = kInstances[hits != nullptr][n_lights];
  if (blocks <= 0) {
    const cudaError_t err = inst.grid(n, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(inst.launch(rays8, u8d, planes, shade, lights, n,
                                      fp, depth, blocks, out, hits, rounds,
                                      static_cast<cudaStream_t>(stream)));
}

// Registers per thread and local (spill) bytes per thread of one instance.
extern "C" int tpt_mega_resources(int n_lights, int save_hits, int* regs,
                                  int* local_bytes) {
  if (n_lights < 0 || n_lights > tpt::kMaxLights) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err =
      kInstances[save_hits != 0][n_lights].attributes(&attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
