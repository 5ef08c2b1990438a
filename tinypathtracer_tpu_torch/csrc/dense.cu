// Kernel A: dense closest hit of N rays against all Fp triangles.
//
// Replaces the TPU kernel tinypathtracer_tpu/ops/dense.py
// `_make_dense_kernel` (called through `_dense_pallas`). Plain twin:
// tinypathtracer_tpu_torch/ops/dense.py `_dense_torch`.
//
// Design: one thread per ray loops over the triangle slots in ascending
// order and updates its best hit on a strictly smaller t, which gives the
// reference's tie rule (lowest slot among equal t). Every thread of a warp
// reads the same slot's 12 plane floats: a broadcast load from L1/L2.
//
// What bounds it on the H100: per (ray, triangle) pair about 21 fp32
// multiply-adds and one IEEE divide, with no memory traffic beyond the
// broadcast planes. A query is O(F), so the kernel is compute-bound on the
// CUDA cores. Left for later: staging the planes in shared memory, several
// rays per thread, and culling (BVH or packet traversal) in place of the
// brute-force sweep.
#include "hit.cuh"

namespace {

__global__ void dense_hit_kernel(const float* __restrict__ rays,
                                 const float* __restrict__ planes, int n,
                                 int fp, float* __restrict__ t_out,
                                 int* __restrict__ slot_out,
                                 float* __restrict__ uv_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* r = rays + 8 * (size_t)i;  // origin xyz, 0, dir xyz, 0
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  float best_t = tpt::kRealMax, best_u = 0.f, best_v = 0.f;
  int best = -1;
  for (int f = 0; f < fp; ++f) {
    float w[12];
    tpt::load_planes(planes + 12 * (size_t)f, w);
    const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
    float t, u, v;
    if (tpt::hit_terms(op, dx, dy, dz, w, t, u, v) && t < best_t) {
      best_t = t;
      best = f;
      best_u = u;
      best_v = v;
    }
  }
  t_out[i] = best_t;
  slot_out[i] = best;
  uv_out[2 * (size_t)i] = best_u;
  uv_out[2 * (size_t)i + 1] = best_v;
}

}  // namespace

// rays [N, 8], planes [Fp, 12] (16-byte aligned); outputs t [N] (FLT_MAX on
// miss), slot [N] (-1 on miss), uv [N, 2] (0 on miss). Returns
// cudaGetLastError() after the launch.
extern "C" int tpt_dense_hit(const float* rays, const float* planes, int n,
                             int fp, float* t, int* slot, float* uv,
                             void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  dense_hit_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rays, planes, n, fp, t, slot, uv);
  return static_cast<int>(cudaGetLastError());
}
