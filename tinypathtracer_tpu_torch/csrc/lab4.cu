// Kernels D and E: the kernel lab's closest hit of N rays against all Fp
// triangles, with the Woop transform on the tensor cores (D) or on the
// CUDA cores from triangles staged in shared memory (E).
//
// Replace the TPU kernels tinypathtracer_tpu/tools/lab4.py
// `_mxu_hit_kernel` (called through `mxu_closest_hit`) and
// `_vpu_rol_kernel` (through `vpu_rol_closest_hit`). Plain twins:
// tinypathtracer_tpu_torch/tools/lab4.py `_mxu_torch` and `_vpu_rol_torch`.
//
// Both take rays8 [8, N] (rows ox oy oz 1 dx dy dz 0) and return t [N]
// (FLT_MAX on a miss) and fid [N] (the lowest slot among equal t, -1 on a
// miss). Each thread walks its slots in ascending order, so a strictly
// smaller t wins, and the final (t, slot) reduction breaks ties to the
// lower slot: the reference's tie rule. `tc` is the lab's sweep
// parameter: triangles per staged tile.
//
// Kernel D: the transform o' = W o + c, d' = W d as warpgroup products
// (wgmma, sm_90a) from shared memory, triangles on M (64 rows a product),
// rays on N: B's columns are each ray's [o; 1] and [d; 0], ray r at
// columns 2r and 2r + 1, so a thread's accumulator pair holds o' and d'
// of one (triangle, ray); the x, y and z rows of W are three products
// that share B. Operands are TF32 rounded by cvt.rna, accumulators fp32.
// precision 1 ("highest") is the 3xTF32 split folded into K = 16, two k8
// steps: [a_big | a_small] . [b_small; b_big], then [a_big | a_small] .
// [b_big; 0]; precision 0 ("default") is the second step alone, one TF32
// pass. `split_planes` splits the planes once a launch into a scratch
// tensor in the operands' shared-memory image (K-major 8 x 16-byte core
// matrices, no swizzle), which TMA copies a tile of tc triangles at a
// time into a ring completing on mbarriers; a tile's rows past tc (tc not
// a multiple of 64) stay zero planes, whose t = -0/0 fails t > DELTA.
// A block holds kWarpgroups (2) warpgroups, each over kGroups (8) groups
// of 16 rays (32 columns): 256 rays a block. A warpgroup takes a product's
// groups in turn and runs group g's epilogue while group g + 1's products
// compute (two accumulator sets, wgmma.commit_group, wait_group 1); every
// product of an iteration is waited for within it. The last warpgroup
// done with a tile refills its slot. The epilogue (t, u, v, the tests and
// the running minimum) works on the accumulators in registers: a thread
// holds 2 triangles x 4 rays of every product.
// What bounds it: the epilogue on the CUDA cores (~12 instructions a pair,
// 7 of them comparisons and selects on the half-rate ALU pipe), not the
// products (96 multiply-adds a pair at "highest": 0.55-0.68 ms alone at
// 2^20 rays x 2,048 slots). Measured on an NVIDIA H100 80GB HBM3 at
// 700 W: 2.73 ms "highest", 2.14 "default", against 3.66 and 3.20 for the
// v1 mma.sync kernel in the same call (lab4 --variants).
//
// Kernel E: 256 threads x 4 rays a block (warp w the 128 consecutive rays
// from 128 w, lane l of it rays l, l + 32, l + 64, l + 96), over tiles of
// tc triangles that TMA copies into a ring of kEStages slots on
// mbarriers; the last warp done with a slot refills it. Lab4's rays each
// leave from their own origin, so the exact test of a pair is ~45
// instructions (o' and d' 21, the IEEE divide ~10, u, v, the tests): the
// v1 kernel (one thread a ray, lab4 --variants e_thread_per_ray) was
// bound by issuing them, not by bytes. Most pairs need only the z row: a
// divide-free cull on o'z and d'z (the very FMAs of hit.cuh, so the same
// bits) rejects every pair whose t is <= 0 or >= the ray's best
// (`survives`, proof there). Each warp appends the (ray, slot) pairs that
// survive, ~12 % on lab4's rays, to a ring queue in shared memory (ballot
// and popc, in the order slot, then ray l + 32 q) and, when it holds
// kBatch of them, runs them as full warps of the exact test, two a lane
// (`drain`, the ray read from its columns of rays8); at a tile's last
// slot it drains what is left, so the queue only holds the staged tile's
// slots. A ray's best is a (t, slot) key in shared memory, lowered by
// atomicMin: the unsigned order of the key is the reference's (t first,
// then the lower slot), so the result is the sequential sweep's whatever
// order a batch's lanes update in. E equals its twin and kernel A bit for
// bit. Its plain model is lab4.py `vpu_rol_schedule` (the survivors and
// batches of each warp), whose counts the counting instance
// (tpt_vpu_rol_count) equals.
// What bounds it: issue, still: the fast path's SASS a slot against a
// lane's 4 rays (z rows, cull, queue, the slot's load and loop) and the
// exact test's a batch, counted by lab4.vpu_rol_sass, against 4 x 21
// operations of the bound a slot. Times and counts: PERF.md (lab4
// --variants, chip_smoke.py phase 13).
#include <cmath>
#include <cstdint>

#include "hit.cuh"
#include "tma.cuh"

namespace {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// ---- kernel D ----------------------------------------------------------
constexpr int kWarpgroups = 2;       // warpgroups a block
constexpr int kGroups = 8;           // ray groups a warpgroup
constexpr int kCols = 32;            // columns of a product: 16 rays
constexpr int kBuffers = 2;          // accumulator sets: groups in flight + 1
constexpr int kRaysPerGroup = kCols / 2;
constexpr int kRaysPerBlock = kWarpgroups * kGroups * kRaysPerGroup;
constexpr int kDThreads = 128 * kWarpgroups;
constexpr int kRowBytes = 96;        // a triangle's split planes: 3 x 8 floats
constexpr int kCoreBytes = 128;      // a core matrix: 8 rows x 16 bytes
// B: per 8 columns three core matrices [b_small][b_big][zero]
constexpr int kColGroupBytes = 3 * kCoreBytes;
constexpr int kGroupBBytes = kCols / 8 * kColGroupBytes;
constexpr int kBBytes = kWarpgroups * kGroups * kGroupBBytes;
constexpr int kRedBytes = kWarpgroups * 4 * kGroups * kRaysPerGroup * 8;

// A tile of tc triangles fills a ring slot of tc rounded up to 64 rows.
__host__ __device__ __forceinline__ int slot_rows(int tc) {
  return (tc + 63) / 64 * 64;
}
__host__ __device__ __forceinline__ int ring_stages(int tc) {
  const int s = 64 * 1024 / (slot_rows(tc) * kRowBytes);
  return s < 2 ? 2 : (s > 8 ? 8 : s);
}
int d_smem_bytes(int tc) {
  return ring_stages(tc) * slot_rows(tc) * kRowBytes + kBBytes + kRedBytes +
         ring_stages(tc) * 16;
}

// wgmma matrix descriptor: no swizzle, K-major; lbo: the next core matrix
// along K, sbo: the next 8 rows (M) or columns (N)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (+)= A [64 x 8] . B [8 x 32]: d's 16 floats of this thread; value i
// is row 16 warp + lane / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1)
__device__ __forceinline__ void wgmma(float d[16], uint64_t a, uint64_t b,
                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// the compiler keeps reads and writes of d on their side of a wgmma fence
// or wait
__device__ __forceinline__ void pin(float (&d)[3][16]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[c][i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Split planes4 [3 * Fp, 4] into the operand image of A: per 8 triangles
// and component the core matrices [big][small] (8 rows x 4 floats each),
// 768 bytes for 8 triangles. small = 0 at "default".
__global__ void split_planes(const float* __restrict__ planes4, int fp,
                             int highest, float* __restrict__ a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 12 * fp) return;
  const int f = idx / 12, c = (idx / 4) % 3, k = idx % 4;
  const float x = planes4[((size_t)c * fp + f) * 4 + k];
  const uint32_t big = tf32(x);
  const uint32_t small = highest ? tf32(x - __uint_as_float(big)) : 0u;
  float* core = a + (((size_t)(f / 8) * 3 + c) * 2) * 32 + (f % 8) * 4 + k;
  core[0] = __uint_as_float(big);
  core[32] = __uint_as_float(small);
}

struct Best {
  float t[kGroups][4];
  int i[kGroups][4];
};

// the epilogue of product rows row0 (+8) against group g's 4 rays of this
// thread: t = -o'z / d'z, u, v, the tests and the running minimum (g is a
// constant once the caller's loop is unrolled). The divide is the fast one
// (a reciprocal and a multiply, within 2 ulp): it set the pace with the
// IEEE divide (lab4 --variants, "ieee_divide").
__device__ __forceinline__ void epilogue(const float (&acc)[3][16], int row0,
                                         int g, Best& b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h;
      const float t = __fdividef(-acc[2][e], acc[2][e + 1]);
      const float u = fmaf(t, acc[0][e + 1], acc[0][e]);
      const float v = fmaf(t, acc[1][e + 1], acc[1][e]);
      const bool ok = (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                      (t > tpt::kDelta);
      if (ok && t < b.t[g][j]) {
        b.t[g][j] = t;
        b.i[g][j] = row0 + 8 * h;
      }
    }
}

template <bool kHighest>
__global__ void __launch_bounds__(kDThreads, 1)
    mxu_hit_kernel(const float* __restrict__ rays8,
                   const float* __restrict__ a_split, int n, int fp, int tc,
                   float* __restrict__ t_out, int* __restrict__ fid_out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, t128 = tid & 127;
  const int warp = t128 >> 5, lane = tid & 31;
  const int rows = slot_rows(tc), stages = ring_stages(tc);
  const int slot_bytes = rows * kRowBytes;
  const int tiles = fp / tc, per_tile = rows / 64;
  const int products = tiles * per_tile;
  unsigned char* ring = smem;
  float* bsm = reinterpret_cast<float*>(ring + stages * slot_bytes);
  float2* red = reinterpret_cast<float2*>(
      reinterpret_cast<unsigned char*>(bsm) + kBBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(red) + kRedBytes);
  int* done = reinterpret_cast<int*>(full + stages);
  const int ray0 = blockIdx.x * kRaysPerBlock;

  // B: column col = 2 r + h of ray r, [o; 1] (h = 0) or [d; 0] (h = 1)
  for (int col = tid; col < 2 * kRaysPerBlock; col += kDThreads) {
    const int r = ray0 + col / 2, h = col & 1;
    float* core = bsm + (col / 8) * (kColGroupBytes / 4) + (col % 8) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float x = r < n ? rays8[(size_t)(4 * h + k) * n + r] : 0.f;
      const uint32_t big = tf32(x);
      core[k] = kHighest ? __uint_as_float(tf32(x - __uint_as_float(big)))
                         : 0.f;
      core[32 + k] = __uint_as_float(big);
      core[64 + k] = 0.f;
    }
  }
  // the rows of each slot past tc stay zero planes
  for (int s = 0; s < stages; ++s)
    for (int k = tc * kRowBytes / 4 + tid; k < slot_bytes / 4;
         k += kDThreads)
      reinterpret_cast<float*>(ring + s * slot_bytes)[k] = 0.f;
  if (tid == 0) {
    tpt::init_barriers(full, stages);
    for (int s = 0; s < stages; ++s) done[s] = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const float* src = a_split;
  if (tid == 0)
    for (int s = 0; s < stages && s < tiles; ++s)
      tpt::bulk_copy(ring + s * slot_bytes, src + (size_t)s * tc * 24,
                     tc * kRowBytes, &full[s]);

  const uint32_t ring_addr = tpt::smem_addr(ring);
  const uint32_t b_addr = tpt::smem_addr(bsm) + wg * kGroups * kGroupBBytes;
  Best b;
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b.t[g][j] = tpt::kRealMax;
      b.i[g][j] = 0;
    }
  float acc[kBuffers][3][16];

  // descriptors of the ring's first rows and of this warpgroup's B; an
  // offset of k bytes adds k >> 4 to the address field
  const uint64_t a_desc = desc(ring_addr, kCoreBytes, 768);
  const uint64_t b_desc = desc(b_addr, kCoreBytes, kColGroupBytes);
  // issue the products of product p against group g into d
  auto issue = [&](int p, int g, float (&d)[3][16]) {
    const uint64_t a0 =
        a_desc + (((p / per_tile) % stages * slot_bytes +
                   (p % per_tile) * 8 * 768) >> 4);
    const uint64_t bg = b_desc + (g * kGroupBBytes >> 4);
    pin(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const uint64_t a = a0 + c * 256 / 16;
      if (kHighest) {
        wgmma(d[c], a, bg, 0);                          // . [b_small; b_big]
        wgmma(d[c], a, bg + kCoreBytes / 16, 1);        // . [b_big; 0]
      } else {
        wgmma(d[c], a, bg + kCoreBytes / 16, 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  auto wait_tile = [&](int tile) {
    tpt::wait_parity(&full[tile % stages], (tile / stages) & 1);
  };

  // Product p against each ray group in turn: group g's epilogue runs
  // while the products of the next kBuffers - 1 groups compute; every
  // product of p is waited for within the iteration, so no accumulator is
  // in flight across it.
  for (int p = 0; p < products; ++p) {
    const int tile = p / per_tile;
    const int row0 = tile * tc + (p % per_tile) * 64 + warp * 16 + (lane >> 2);
    if (p % per_tile == 0) wait_tile(tile);
#pragma unroll
    for (int g = 0; g + 1 < kBuffers; ++g) issue(p, g, acc[g]);
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      // groups g + 1 .. g + kBuffers - 1 in flight past this wait
      const int ahead = g + kBuffers - 1;
      if (ahead < kGroups) issue(p, ahead, acc[ahead % kBuffers]);
      const int later = (ahead < kGroups ? ahead : kGroups - 1) - g;
      if (later >= 2)
        wgmma_wait<2>();
      else if (later == 1)
        wgmma_wait<1>();
      else
        wgmma_wait<0>();
      pin(acc[g % kBuffers]);
      epilogue(acc[g % kBuffers], row0, g, b);
    }
    if (p % per_tile == per_tile - 1) {
      // every warp of this warpgroup is done with the tile's slot; the
      // last warpgroup refills it
      named_sync(1 + wg, 128);
      if (t128 == 0 && atomicAdd(&done[tile % stages], 1) == kWarpgroups - 1) {
        done[tile % stages] = 0;
        const int next = tile + stages;
        if (next < tiles)
          tpt::bulk_copy(ring + (tile % stages) * slot_bytes,
                         src + (size_t)next * tc * 24, tc * kRowBytes,
                         &full[tile % stages]);
      }
    }
  }

  // (t, slot) minimum over the 8 lanes that share a ray column, then over
  // the warpgroup's 4 warps
#pragma unroll
  for (int g = 0; g < kGroups; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float bt = b.t[g][j];
      int bi = b.i[g][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ot < bt || (ot == bt && oi < bi)) {
          bt = ot;
          bi = oi;
        }
      }
      const int r = (wg * kGroups + g) * kRaysPerGroup + 4 * j + (lane & 3);
      if (lane < 4)
        red[warp * kRaysPerBlock + r] = make_float2(bt, __int_as_float(bi));
    }
  __syncthreads();
  if (tid < kRaysPerBlock && ray0 + tid < n) {
    float bt = red[tid].x;
    int bi = __float_as_int(red[tid].y);
    for (int w = 1; w < 4; ++w) {
      const float2 o = red[w * kRaysPerBlock + tid];
      const int oi = __float_as_int(o.y);
      if (o.x < bt || (o.x == bt && oi < bi)) {
        bt = o.x;
        bi = oi;
      }
    }
    t_out[ray0 + tid] = bt;
    fid_out[ray0 + tid] = bt >= tpt::kRealMax ? -1 : bi;
  }
}

// ---- kernel E ----------------------------------------------------------
constexpr int kEThreads = 256;         // threads a block: lab4.E_THREADS
constexpr int kERays = 4;              // rays a thread: lab4.E_RAYS
constexpr int kEWarps = kEThreads / 32;
constexpr int kEWarpRays = 32 * kERays;
constexpr int kEBlockRays = kEThreads * kERays;
constexpr int kEStages = 2;            // ring slots, tc triangles each
constexpr int kBatch = 64;             // survivors an exact-test batch
// a warp's survivor queue, a ring of 1 KB: at most kBatch - 1 wait while a
// slot appends up to kEWarpRays
constexpr unsigned kQueue = 256;
// the cull's margin on a ray's best (lab4.BEST_UP)
constexpr float kBestUp = 0x1.00001p+0f;
constexpr unsigned kFull = 0xffffffffu;

// a block's shared memory: per warp its queue (1 KB aligned) and its
// rays' keys, then the ring, the barriers and the refill counts
size_t e_smem_bytes(int tc) {
  return kEWarps * (kQueue * sizeof(int) +
                    kEWarpRays * sizeof(unsigned long long)) +
         (size_t)kEStages * tc * 48 +
         kEStages * (sizeof(uint64_t) + sizeof(int));
}

// (t, slot) as one key whose unsigned order is the reference's: a hit has
// t > DELTA, whose bits order as its values, and the lower slot wins ties
__device__ __forceinline__ unsigned long long pack(float t, int slot) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned>(slot);
}

// -(best (1 + 2^-20)) of a ray's key: -inf until it has a hit, +inf for
// a ray past n (whose key holds t = -inf)
__device__ __forceinline__ float neg_best_up(unsigned long long key) {
  return __uint_as_float(static_cast<unsigned>(key >> 32)) * -kBestUp;
}

// The cull: false only for a pair the exact test cannot take, given o'z = x
// and d'z = y of hit.cuh (the same bits) and nbu = -(best (1 + 2^-20)) of
// the ray, whose best slot is lower than this one. A sign flip, an fp32
// multiply and compares only, so the model (lab4.vpu_rol_schedule)
// repeats it exactly.
// The test computes t = RN(-x / y) (IEEE) and takes the pair only if
// t > DELTA and t < best (a tie goes to the lower slot, the best's).
// xs is x with its sign flipped where y's sign bit is set; ay = |y|.
// - Culled as !(xs < 0): x and y share a sign bit, so t is <= -0, -inf or
//   NaN; or x = +-0 (t = +-0 or NaN); or x or y is NaN (t = NaN).
// - Culled as xs < -hi, hi = RN(-nbu ay): x and y have opposite signs and
//   |x| > hi. For y = 0, t = +-inf, never taken. Else for a normal hi,
//   hi >= best ay (1 + 2^-20)(1 - 2^-24)^2 >= best ay; for a subnormal hi
//   the float |x| is >= hi + 2^-149 > -nbu ay >= best ay. So q = |x| / |y|
//   > best, and t = RN(q) >= RN(best) = best (RN is monotone). Before a
//   ray's first hit nbu = -inf and -hi = -inf (NaN for y = 0, culled).
// The pairs with 0 < t <= DELTA survive: the exact test rejects them (a
// DELTA cull is the lab4 --variants build e_delta_cull).
__device__ __forceinline__ bool survives(float x, float y, float nbu) {
  const float xs =
      __uint_as_float(__float_as_uint(x) ^ (__float_as_uint(y) & 0x80000000u));
  return (xs < 0.f) & (xs >= nbu * fabsf(y));
}

// One batch of the queue's first m (<= kBatch) entries, lane l the
// entries l, l + 32, ...: the exact test (hit.cuh, o' recomputed from the
// ray's columns of rays8 [8, sn], the warp's rays from `first`), and a
// hit that beats the ray's key lowers it. Then, if a key went down, every
// lane reloads the thresholds of its rays.
__device__ __forceinline__ void drain(const int* queue, unsigned head,
                                      unsigned m, const float* tile,
                                      int base, const float* rays8,
                                      size_t sn, int first, int lane,
                                      unsigned long long* key,
                                      float (&nbu)[kERays]) {
  bool took = false;
#pragma unroll
  for (int h = 0; h < kBatch / 32; ++h) {
    const unsigned idx = lane + 32 * h;
    if (idx >= m) break;
    const int e = queue[(head + idx) % kQueue];
    const int r = e & (kEWarpRays - 1), f = e >> 7;
    float w[12];
    tpt::load_planes_shared(tile + 12 * f, w);
    const float* const ray = rays8 + first + r;
    const float ox = __ldg(ray), oy = __ldg(ray + sn),
                oz = __ldg(ray + 2 * sn), dx = __ldg(ray + 4 * sn),
                dy = __ldg(ray + 5 * sn), dz = __ldg(ray + 6 * sn);
    float t, u, v;
    if (tpt::hit_terms(tpt::origin_terms(ox, oy, oz, w), dx, dy, dz, w, t, u,
                       v)) {
      const unsigned long long k = pack(t, base + f);
      if (k < key[r]) {
        atomicMin(key + r, k);
        took = true;
      }
    }
  }
  if (__any_sync(kFull, took)) {
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kERays; ++q)
      nbu[q] = neg_best_up(key[lane + 32 * q]);
  }
}

// kCount: the counting instance, which also writes each warp's survivors
// and batches.
template <bool kCount>
__global__ void __launch_bounds__(kEThreads, 2)
    vpu_rol_kernel(const float* __restrict__ rays8,
                   const float* __restrict__ planesT, int n, int fp, int tc,
                   float* __restrict__ t_out, int* __restrict__ fid_out,
                   int* __restrict__ survivors_out,
                   int* __restrict__ batches_out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int* const queues = reinterpret_cast<int*>(smem);
  unsigned long long* const keys = reinterpret_cast<unsigned long long*>(
      queues + kEWarps * kQueue);
  float* const ring = reinterpret_cast<float*>(
      keys + kEWarps * kEWarpRays);  // [kEStages][tc][12]
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      ring + static_cast<size_t>(kEStages) * tc * 12);
  int* const done = reinterpret_cast<int*>(full + kEStages);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kEBlockRays + warp * kEWarpRays;
  unsigned long long* const key = keys + warp * kEWarpRays;
  int* const queue = queues + warp * kQueue;
  const uint32_t qs = tpt::smem_addr(queue);
  const unsigned below = (1u << lane) - 1u;
  float ox[kERays], oy[kERays], oz[kERays], dx[kERays], dy[kERays],
      dz[kERays], nbu[kERays];
#pragma unroll
  for (int q = 0; q < kERays; ++q) {
    const int i = first + lane + 32 * q;
    const bool on = i < n;
    const size_t sn = n;
    ox[q] = on ? __ldg(rays8 + i) : 0.f;
    oy[q] = on ? __ldg(rays8 + sn + i) : 0.f;
    oz[q] = on ? __ldg(rays8 + 2 * sn + i) : 0.f;
    dx[q] = on ? __ldg(rays8 + 4 * sn + i) : 0.f;
    dy[q] = on ? __ldg(rays8 + 5 * sn + i) : 0.f;
    dz[q] = on ? __ldg(rays8 + 6 * sn + i) : 0.f;
    // a ray past n keeps no pair
    key[lane + 32 * q] = pack(on ? tpt::kRealMax : -INFINITY, 0);
    nbu[q] = neg_best_up(key[lane + 32 * q]);
  }
  if (threadIdx.x == 0) {
    tpt::init_barriers(full, kEStages);
    for (int s = 0; s < kEStages; ++s) done[s] = 0;
  }
  __syncthreads();
  const int tiles = fp / tc;
  if (threadIdx.x == 0)
    for (int s = 0; s < kEStages && s < tiles; ++s)
      tpt::bulk_copy(ring + static_cast<size_t>(s) * tc * 12,
                     planesT + static_cast<size_t>(s) * tc * 12, tc * 48,
                     &full[s]);
  // the queue's ends in bytes, the same in every lane: an entry's address
  // is qs | (its byte count mod 1 KB)
  unsigned head = 0, tail = 0;
  int batches = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    const int s = tile % kEStages;
    tpt::wait_parity(&full[s], (tile / kEStages) & 1);
    const float* const tp = ring + static_cast<size_t>(s) * tc * 12;
    const int base = tile * tc;
    const float4* z4 = reinterpret_cast<const float4*>(tp) + 2;  // z rows
#pragma unroll 1
    for (int j = 0; j < tc; ++j, z4 += 3) {
      const float4 z = *z4;
#pragma unroll
      for (int q = 0; q < kERays; ++q) {
        const float x = tpt::affine(ox[q], oy[q], oz[q], z.x, z.y, z.z) + z.w;
        const float y = tpt::affine(dx[q], dy[q], dz[q], z.x, z.y, z.z);
        const bool keep = survives(x, y, nbu[q]);
        const unsigned b = __ballot_sync(kFull, keep);
        if (keep)
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           qs | ((tail + 4 * __popc(b & below)) & 1023u)),
                       "r"((j << 7) | (lane + 32 * q))
                       : "memory");
        tail += 4 * __popc(b);
      }
      // full batches; at the tile's last slot also the rest
      const unsigned need = j == tc - 1 ? 4u : 4u * kBatch;
      while (tail - head >= need) {
        const unsigned m = min(tail - head, 4u * kBatch) / 4;
        drain(queue, head / 4, m, tp, base, rays8, n, first, lane, key,
              nbu);
        head += 4 * m;
        if (kCount) ++batches;
      }
    }
    // every lane of this warp is done with the slot; the last warp refills
    // it
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1) == kEWarps - 1) {
        done[s] = 0;
        const int next = tile + kEStages;
        if (next < tiles)
          tpt::bulk_copy(ring + static_cast<size_t>(s) * tc * 12,
                         planesT + static_cast<size_t>(next) * tc * 12,
                         tc * 48, &full[s]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kERays; ++q) {
    const int i = first + lane + 32 * q;
    if (i >= n) continue;
    const unsigned long long k = key[lane + 32 * q];
    const float t = __uint_as_float(static_cast<unsigned>(k >> 32));
    t_out[i] = t;
    fid_out[i] = t >= tpt::kRealMax ? -1 : static_cast<int>(k & 0xffffffffu);
  }
  if (kCount && lane == 0) {
    survivors_out[blockIdx.x * kEWarps + warp] = static_cast<int>(tail / 4);
    batches_out[blockIdx.x * kEWarps + warp] = batches;
  }
}

// Kernel E's launch (counts: null, or survivors and batches of each of
// the blocks * kEWarps warps).
int e_launch(const float* rays8, const float* planesT, int n, int fp, int tc,
             float* t, int* fid, int* survivors, int* batches,
             cudaStream_t st) {
  const size_t smem = e_smem_bytes(tc);
  const auto kernel =
      survivors ? vpu_rol_kernel<true> : vpu_rol_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kEBlockRays - 1) / kEBlockRays;
  kernel<<<blocks, kEThreads, smem, st>>>(rays8, planesT, n, fp, tc, t, fid,
                                          survivors, batches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays8 [8, N], planes4 [3 * Fp, 4] (16-byte aligned), tc | Fp, tc a
// multiple of 16 up to 1024; precision 1 = 3xTF32, 0 = one TF32 pass;
// scratch [24 * Fp] floats (16-byte aligned), the split planes. Returns
// cudaGetLastError() after the launches.
extern "C" int tpt_mxu_hit(const float* rays8, const float* planes4, int n,
                           int fp, int tc, int precision, float* t, int* fid,
                           float* scratch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fp > 0)
    split_planes<<<(12 * fp + 255) / 256, 256, 0, st>>>(planes4, fp,
                                                        precision, scratch);
  const int smem = d_smem_bytes(tc);
  const int blocks = (n + kRaysPerBlock - 1) / kRaysPerBlock;
  const auto kernel =
      precision ? mxu_hit_kernel<true> : mxu_hit_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kDThreads, smem, st>>>(rays8, scratch, n, fp, tc, t, fid);
  return static_cast<int>(cudaGetLastError());
}

// rays8 [8, N], planesT [Fp, 12] (16-byte aligned), tc | Fp, tc a
// multiple of 16 up to 1024. Returns cudaGetLastError() after the launch.
extern "C" int tpt_vpu_rol_hit(const float* rays8, const float* planesT,
                               int n, int fp, int tc, float* t, int* fid,
                               void* stream) {
  const cudaStream_t est = static_cast<cudaStream_t>(stream);
  return e_launch(rays8, planesT, n, fp, tc, t, fid, nullptr, nullptr, est);
}

// The counting launch: also survivors [W] and batches [W] of each warp,
// W = ceil(N / 1024) * 8 (lab4.vpu_rol_schedule's).
extern "C" int tpt_vpu_rol_count(const float* rays8, const float* planesT,
                                 int n, int fp, int tc, float* t, int* fid,
                                 int* survivors, int* batches, void* stream) {
  return e_launch(rays8, planesT, n, fp, tc, t, fid, survivors, batches,
                  static_cast<cudaStream_t>(stream));
}
