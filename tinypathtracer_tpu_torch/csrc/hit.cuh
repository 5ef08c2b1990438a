// Woop hit test shared by the port's kernels (dense.cu, mega.cu,
// packet.cu), and the reciprocal of their slab tests.
//
// A triangle is 12 plane floats (W[0, 0:3], c0, W[1, 0:3], c1, W[2, 0:3],
// c2): o' = W o + c, d' = W d, t = -o'z / d'z, u = o'x + t d'x,
// v = o'y + t d'y; hit iff u, v >= 0, u + v <= 1 and t > DELTA. Padding
// slots are all-zero planes: t = NaN, rejected by the comparisons.
//
// The multiply-adds are fused exactly where XLA:CPU fuses the JAX
// reference's hit test (each three-term sum as fma(z, c, fma(x, a, y*b)),
// u and v as fma(t, d', o')), so hits are bit-equal to the reference and
// to the plain PyTorch twin, which emulates these FMAs exactly. The files
// are compiled with --fmad=false: no other operation is fused, and `/` is
// IEEE division (no --use_fast_math).
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace tpt {

constexpr float kDelta = 2e-4f;      // self-intersection epsilon
constexpr float kRealMax = FLT_MAX;  // "no hit" distance

// x a + y b + z c with the reference's roundings
__device__ __forceinline__ float affine(float x, float y, float z, float a,
                                        float b, float c) {
  return fmaf(z, c, fmaf(x, a, y * b));
}

// 12 plane floats from a 16-byte aligned address: three vector loads.
// Where every thread of a warp reads the same slot, each is a broadcast.
__device__ __forceinline__ void load_planes(const float* __restrict__ src,
                                            float w[12]) {
  const float4* p = reinterpret_cast<const float4*>(src);
  const float4 a = __ldg(p), b = __ldg(p + 1), c = __ldg(p + 2);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
}

// The same from shared memory (16-byte aligned): three 16-byte loads, a
// broadcast where every thread of a warp reads the same slot.
__device__ __forceinline__ void load_planes_shared(const float* src,
                                                   float w[12]) {
  const float4* p = reinterpret_cast<const float4*>(src);
  const float4 a = p[0], b = p[1], c = p[2];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  w[8] = c.x; w[9] = c.y; w[10] = c.z; w[11] = c.w;
}

// o' = W o + c: computed once per (origin, triangle), shared by every
// direction leaving that origin.
struct Origin {
  float x, y, z;
};

__device__ __forceinline__ Origin origin_terms(float ox, float oy, float oz,
                                               const float w[12]) {
  return {affine(ox, oy, oz, w[0], w[1], w[2]) + w[3],
          affine(ox, oy, oz, w[4], w[5], w[6]) + w[7],
          affine(ox, oy, oz, w[8], w[9], w[10]) + w[11]};
}

// (t, u, v) of one direction; returns whether the triangle is hit.
__device__ __forceinline__ bool hit_terms(const Origin& op, float dx,
                                          float dy, float dz,
                                          const float w[12], float& t,
                                          float& u, float& v) {
  const float dpx = affine(dx, dy, dz, w[0], w[1], w[2]);
  const float dpy = affine(dx, dy, dz, w[4], w[5], w[6]);
  const float dpz = affine(dx, dy, dz, w[8], w[9], w[10]);
  t = -op.z / dpz;  // inf/NaN on parallel/degenerate: rejected below
  u = fmaf(t, dpx, op.x);
  v = fmaf(t, dpy, op.y);
  return (u >= 0.f) & (v >= 0.f) & (u + v <= 1.f) & (t > kDelta);
}

// 1 / d, or the huge finite REAL_MAX for a zero component, so that
// 0 * REAL_MAX is 0 and a ray parallel to a slab never culls a box it lies
// in (the slab tests of dense.cu and packet.cu).
__device__ __forceinline__ float reciprocal(float d) {
  return d == 0.f ? kRealMax : 1.f / d;
}

}  // namespace tpt
