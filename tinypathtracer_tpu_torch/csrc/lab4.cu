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
// Kernel E: one thread per ray; every thread of the block reads the same
// staged triangle, a shared-memory broadcast (the GPU form of "plane
// coefficients on sublanes, rays on lanes"). Its arithmetic is hit.cuh's,
// the fused multiply-adds where XLA:CPU fuses lab4.py:161-171 (measured),
// so E equals its twin and kernel A bit for bit. What bounds it: the ~39
// fp32 operations and the IEEE divide per pair, as kernel A.
#include <cstdint>

#include "hit.cuh"
#include "tma.cuh"

namespace {

constexpr int kThreads = 128;  // kernel E: 4 warps

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// Stage planes rows [base, base + tc) of each of the ncomp row groups of
// `fp` rows (row width 4 floats) into smem [ncomp][tc][4].
__device__ __forceinline__ void stage(const float* __restrict__ planes,
                                      int fp, int base, int tc, int ncomp,
                                      float* smem) {
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(planes);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int k = threadIdx.x; k < ncomp * tc; k += blockDim.x) {
    const int c = k / tc, r = k - c * tc;
    dst[k] = __ldg(src + (size_t)c * fp + base + r);
  }
  __syncthreads();
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

__global__ void __launch_bounds__(kThreads)
    vpu_rol_kernel(const float* __restrict__ rays8,
                   const float* __restrict__ planesT, int n, int fp, int tc,
                   float* __restrict__ t_out, int* __restrict__ fid_out) {
  extern __shared__ float4 smem4[];
  const float* sp = reinterpret_cast<const float*>(smem4);  // [tc][12]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int rr = r < n ? r : n - 1;  // idle lanes still stage
  const float ox = rays8[rr], oy = rays8[(size_t)n + rr],
              oz = rays8[2 * (size_t)n + rr];
  const float dx = rays8[4 * (size_t)n + rr], dy = rays8[5 * (size_t)n + rr],
              dz = rays8[6 * (size_t)n + rr];
  float best_t = tpt::kRealMax;
  int best = 0;
  for (int base = 0; base < fp; base += tc) {
    // [Fp, 12] is [3 * Fp, 4] in float4 rows: one group of 3 * tc rows
    stage(planesT + (size_t)base * 12, 3 * tc, 0, 3 * tc, 1,
          reinterpret_cast<float*>(smem4));
    for (int f = 0; f < tc; ++f) {
      const float* w = sp + 12 * f;
      const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
      float t, u, v;
      if (tpt::hit_terms(op, dx, dy, dz, w, t, u, v) && t < best_t) {
        best_t = t;
        best = base + f;
      }
    }
  }
  if (r < n) {
    t_out[r] = best_t;
    fid_out[r] = best_t >= tpt::kRealMax ? -1 : best;
  }
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

// rays8 [8, N], planesT [Fp, 12] (16-byte aligned), tc | Fp, tc <= 1024.
extern "C" int tpt_vpu_rol_hit(const float* rays8, const float* planesT,
                               int n, int fp, int tc, float* t, int* fid,
                               void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  vpu_rol_kernel<<<blocks, kThreads, 48 * tc,
                   static_cast<cudaStream_t>(stream)>>>(rays8, planesT, n, fp,
                                                        tc, t, fid);
  return static_cast<int>(cudaGetLastError());
}
