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
// miss). A block stages `tc` triangles at a time in shared memory (the
// lab's sweep parameter: triangles per staged tile) and walks the slots in
// ascending order, so a strictly smaller t wins: the reference's tie rule.
//
// Kernel D: the transform o' = W o + c, d' = W d is six K = 4 matrix
// products per tile, [16 triangles x 4] x [4 x 8 rays] per
// mma.sync.m16n8k4 with TF32 operands rounded by cvt.rna and fp32
// accumulators. precision 1 ("highest") is the 3xTF32 split, the card's
// nearest to fp32: a = big + small, a b ~ small·big + big·small +
// big·big, accumulated in that order; precision 0 ("default") is one TF32
// pass. The epilogue (t, u, v, the tests and the running minimum) works on
// the accumulator fragments in registers; each thread holds 2 triangles x
// 2 rays of every 16 x 8 tile, and the 8 threads that share a ray column
// reduce (t, slot) with shuffles at the end. A warp covers 32 rays (four
// n-tiles), a block 128. What bounds it: the fp32 epilogue (an IEEE divide
// and ~8 operations per pair) on the CUDA cores; the tensor cores do 48
// (or 144) multiply-adds per pair at 7x the CUDA cores' rate.
//
// Kernel E: one thread per ray; every thread of the block reads the same
// staged triangle, a shared-memory broadcast (the GPU form of "plane
// coefficients on sublanes, rays on lanes"). Its arithmetic is hit.cuh's,
// the fused multiply-adds where XLA:CPU fuses lab4.py:161-171 (measured),
// so E equals its twin and kernel A bit for bit. What bounds it: the ~39
// fp32 operations and the IEEE divide per pair, as kernel A.
#include <cstdint>

#include "hit.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps; kernel D: 32 rays a warp

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (precision "highest"); small = 0 otherwise
__device__ __forceinline__ void split(float x, bool highest, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = highest ? tf32(x - __uint_as_float(big)) : 0u;
}

// acc += A [16 x 4, row] * B [4 x 8, col]. Fragments (g = lane / 4,
// q = lane % 4): a0 = A[g][q], a1 = A[g + 8][q], b = B[q][g];
// acc = C[g][2q], C[g][2q+1], C[g+8][2q], C[g+8][2q+1].
__device__ __forceinline__ void mma(float acc[4], uint32_t a0, uint32_t a1,
                                    uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a0), "r"(a1), "r"(b));
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

__global__ void __launch_bounds__(kThreads)
    mxu_hit_kernel(const float* __restrict__ rays8,
                   const float* __restrict__ planes4, int n, int fp, int tc,
                   int highest, float* __restrict__ t_out,
                   int* __restrict__ fid_out) {
  extern __shared__ float4 smem4[];
  float* sp = reinterpret_cast<float*>(smem4);  // [3][tc][4]
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int warp_ray0 = blockIdx.x * kThreads + (threadIdx.x >> 5) * 32;

  // B fragments: ray column g of n-tile j, row q of o4 / d4
  uint32_t bo[4][2], bd[4][2];
  float best_t[4][2];
  int best_i[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = warp_ray0 + 8 * j + g;
    const float o = r < n ? rays8[(size_t)q * n + r] : 0.f;
    const float d = r < n ? rays8[(size_t)(4 + q) * n + r] : 0.f;
    split(o, highest, bo[j][0], bo[j][1]);
    split(d, highest, bd[j][0], bd[j][1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      best_t[j][c] = tpt::kRealMax;
      best_i[j][c] = 0;
    }
  }

  for (int base = 0; base < fp; base += tc) {
    stage(planes4, fp, base, tc, 3, sp);
    for (int g0 = 0; g0 < tc; g0 += 16) {
      // A fragments of the 3 components: rows g0 + g and g0 + g + 8
      uint32_t a[3][2][2];  // [comp][row half][big, small]
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split(sp[(c * tc + g0 + g + 8 * h) * 4 + q], highest, a[c][h][0],
                a[c][h][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc[6][4];  // o'x o'y o'z d'x d'y d'z
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          const int c = m % 3;
          const uint32_t* b = m < 3 ? bo[j] : bd[j];
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
          if (highest) {
            mma(acc[m], a[c][0][1], a[c][1][1], b[0]);  // small · big
            mma(acc[m], a[c][0][0], a[c][1][0], b[1]);  // big · small
          }
          mma(acc[m], a[c][0][0], a[c][1][0], b[0]);    // big · big
        }
        // epilogue: e = 0, 1 triangle g0 + g; e = 2, 3 triangle g0 + g + 8
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = -acc[2][e] / acc[5][e];
          const float u = fmaf(t, acc[3][e], acc[0][e]);
          const float v = fmaf(t, acc[4][e], acc[1][e]);
          const bool ok = (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) &
                          (t > tpt::kDelta);
          const int col = e & 1;
          if (ok && t < best_t[j][col]) {
            best_t[j][col] = t;
            best_i[j][col] = base + g0 + g + 8 * (e >> 1);
          }
        }
      }
    }
  }
  // (t, slot) minimum over the 8 lanes that share a ray column
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int col = 0; col < 2; ++col) {
      float bt = best_t[j][col];
      int bi = best_i[j][col];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, bt, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ot < bt || (ot == bt && oi < bi)) {
          bt = ot;
          bi = oi;
        }
      }
      const int r = warp_ray0 + 8 * j + 2 * q + col;
      if (g == 0 && r < n) {
        t_out[r] = bt;
        fid_out[r] = bt >= tpt::kRealMax ? -1 : bi;
      }
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
// multiple of 16 up to 1024; precision 1 = 3xTF32, 0 = one TF32 pass.
// Returns cudaGetLastError() after the launch.
extern "C" int tpt_mxu_hit(const float* rays8, const float* planes4, int n,
                           int fp, int tc, int precision, float* t, int* fid,
                           void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  mxu_hit_kernel<<<blocks, kThreads, 48 * tc,
                   static_cast<cudaStream_t>(stream)>>>(
      rays8, planes4, n, fp, tc, precision, t, fid);
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
