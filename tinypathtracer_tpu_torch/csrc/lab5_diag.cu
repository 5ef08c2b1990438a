// Kernel F: the stripped variants of the v1 packet kernel, the lab that
// attributes the packet walk's fixed cost per packet.
//
// Replaces the TPU kernel tinypathtracer_tpu/tools/lab5_diag.py
// `make_kernel(cp, variant)` (called through `run_variant`). Plain twin:
// tinypathtracer_tpu_torch/tools/lab5_diag.py `_diag_torch`; the module
// docstring defines each variant's output.
//
// Design: one __global__ template over the variant, one thread per ray. A
// packet of 8 consecutive rays is 8 consecutive lanes of a warp (a warp
// holds 4 packets), and the packet-wide minimum of select() is a shuffle
// over those 8 lanes, under their own mask: a packet's lanes run the same
// walk (the select's result is uniform over the packet), the packets of a
// warp need not. The TPU kernel's [8, Cp] key scratch is shared memory,
// Cp keys per ray laid out [Cp][thread] (consecutive lanes, consecutive
// banks); a block holds 64 rays, or 32 above 256 boxes, so that the keys
// of up to 1024 boxes fit (128 KB). Each ray keeps its best t in a
// register: the TPU kernel's [8, 128] per-slot running minimum is only
// ever read through its minimum over the 128 slots, which this is.
//
// The hit test is the JAX kernel's arithmetic with the multiply-adds
// fused where XLA:CPU fuses it (measured), compiled with --fmad=false, so
// every variant equals the twin bit for bit. min / max are fminf / fmaxf:
// no operand is NaN here (a zero direction component gets the finite
// reciprocal REAL_MAX, boxes are finite).
//
// What bounds it: the walk's per-visit hit tests (1,024 pairs a packet,
// ~39 fp32 operations each) and, per ray, the slab test of every box; the
// variants measure how much of the time is neither.
#include <cstdint>

#include "hit.cuh"

namespace {

constexpr float kDeltaL = 1e-4f;    // the lab's own constants
constexpr float kRealMaxL = 3.4e38f;
constexpr int kI32Max = 0x7fffffff;
constexpr int kTN = 256, kPacket = 8, kChunk = 128, kRows = 16;

enum Variant { kEmpty, kEpilogue, kBoxtest, kBoxvec, kSelect1, kWalkfix,
               kWalksel, kWalk };

// minimum over the 8 lanes of this lane's packet
__device__ __forceinline__ int packet_min(int v, unsigned mask) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(mask, v, off));
  return v;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// (near, far) of the slab test of box c: boxes [8, cp]
__device__ __forceinline__ void slab(const Ray& r, float ivx, float ivy,
                                     float ivz, const float* __restrict__ b,
                                     int cp, int c, float& near, float& far) {
  const float tx0 = (__ldg(b + c) - r.ox) * ivx;
  const float ty0 = (__ldg(b + cp + c) - r.oy) * ivy;
  const float tz0 = (__ldg(b + 2 * cp + c) - r.oz) * ivz;
  const float tx1 = (__ldg(b + 3 * cp + c) - r.ox) * ivx;
  const float ty1 = (__ldg(b + 4 * cp + c) - r.oy) * ivy;
  const float tz1 = (__ldg(b + 5 * cp + c) - r.oz) * ivz;
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

__device__ __forceinline__ float inv(float d) {
  return d == 0.f ? kRealMaxL : 1.f / d;
}

// best lowered by the hits of the 128 slots of chunk ck: planes
// [16 * C, 128], row k of chunk ck = coefficient k of its slots
__device__ __forceinline__ float visit(const Ray& r,
                                       const float* __restrict__ planes,
                                       int ck, float best) {
  const float* p = planes + (size_t)ck * kRows * kChunk;
  for (int s = 0; s < kChunk; ++s) {
    float w[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) w[k] = __ldg(p + k * kChunk + s);
    const float opx = tpt::affine(r.ox, r.oy, r.oz, w[0], w[1], w[2]) + w[3];
    const float opy = tpt::affine(r.ox, r.oy, r.oz, w[4], w[5], w[6]) + w[7];
    const float opz =
        tpt::affine(r.ox, r.oy, r.oz, w[8], w[9], w[10]) + w[11];
    const float dpx = tpt::affine(r.dx, r.dy, r.dz, w[0], w[1], w[2]);
    const float dpy = tpt::affine(r.dx, r.dy, r.dz, w[4], w[5], w[6]);
    const float dpz = tpt::affine(r.dx, r.dy, r.dz, w[8], w[9], w[10]);
    const float t = -opz / dpz;
    const float u = fmaf(t, dpx, opx), v = fmaf(t, dpy, opy);
    if ((fminf(u, v) >= 0.f) & (u + v <= 1.f) & (t > kDeltaL) &
        (t < best))
      best = t;
  }
  return best;
}

// the packet's smallest live key: a key is live while it is <= the bits
// of its ray's best t with the low 10 bits set
__device__ __forceinline__ int select_key(const int* keys, int stride,
                                          int cp, float best, unsigned mask) {
  const int ibt = __float_as_int(best) | 1023;
  int m = kI32Max;
  for (int c = 0; c < cp; ++c) {
    const int k = keys[c * stride];
    m = min(m, k <= ibt ? k : kI32Max);
  }
  return packet_min(m, mask);
}

template <int V>
__global__ void diag_kernel(const float* __restrict__ rays,
                            const float* __restrict__ planes,
                            const float* __restrict__ boxes, int cp,
                            float* __restrict__ out) {
  extern __shared__ int s_key[];  // [cp][blockDim.x]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float* rp = rays + 8 * (size_t)i;
  const Ray r{rp[0], rp[1], rp[2], rp[3], rp[4], rp[5]};
  const unsigned mask = 0xFFu << (threadIdx.x & 24);

  if (V == kEmpty) {
    out[i] = r.ox + r.dx;
    return;
  }
  if (V == kEpilogue) {
    // the argmin epilogue over a [128] scratch row that holds REAL_MAX
    __shared__ float lane_t[kChunk];
    for (int k = threadIdx.x; k < kChunk; k += blockDim.x)
      lane_t[k] = kRealMaxL;
    __syncthreads();
    float m = lane_t[0];
    for (int k = 1; k < kChunk; ++k) m = fminf(m, lane_t[k]);
    int cand = kI32Max;
    for (int k = 0; k < kChunk; ++k)
      if (lane_t[k] == m) cand = min(cand, k);
    out[i] = m + (float)cand;
    return;
  }
  const float ivx = inv(r.dx), ivy = inv(r.dy), ivz = inv(r.dz);
  if (V == kBoxvec) {
    float m = kRealMaxL;
    for (int c = 0; c < cp; ++c) {
      float near, far;
      slab(r, ivx, ivy, ivz, boxes, cp, c, near, far);
      if (far >= fmaxf(near, kDeltaL)) m = fminf(m, near);
    }
    out[i] = m;
    return;
  }
  if (V == kWalkfix) {
    const int p = (i % kTN) / kPacket;  // the packet's index in its block
    float best = kRealMaxL;
    for (int k = 0; k < 8; ++k) best = visit(r, planes, (p + k) % 16, best);
    out[i] = best;
    return;
  }

  // the packed keys of every box, into this ray's column of s_key
  int* keys = s_key + threadIdx.x;
  const int stride = blockDim.x;
  int kmin = kI32Max;
  for (int c = 0; c < cp; ++c) {
    float near, far;
    slab(r, ivx, ivy, ivz, boxes, cp, c, near, far);
    const float e = fmaxf(near, kDeltaL);
    const bool hit = (far >= e) & (__ldg(boxes + 6 * cp + c) != 0.f);
    const int k = hit ? (((__float_as_int(e) | 1023) ^ 1023) | c) : kI32Max;
    keys[c * stride] = k;
    kmin = min(kmin, k);
  }
  if (V == kBoxtest) {
    out[i] = (float)kmin;
    return;
  }
  float best = kRealMaxL;
  int m = select_key(keys, stride, cp, best, mask);
  if (V == kSelect1) {
    out[i] = (float)m;
    return;
  }
  while (m < kI32Max) {
    const int ck = m & 1023;
    if (V == kWalk) best = visit(r, planes, ck, best);
    keys[ck * stride] = kI32Max;  // the chunk leaves every ray's list
    m = select_key(keys, stride, cp, best, mask);
  }
  out[i] = V == kWalk ? best : (float)m;
}

template <int V>
cudaError_t launch(const float* rays, const float* planes,
                   const float* boxes, int n, int cp, float* out,
                   cudaStream_t stream) {
  const bool keyed = V != kEmpty && V != kEpilogue && V != kBoxvec &&
                     V != kWalkfix;
  const int threads = !keyed ? 128 : (cp <= 256 ? 64 : 32);
  const int smem = keyed ? cp * threads * 4 : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        diag_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  diag_kernel<V><<<n / threads, threads, smem, stream>>>(rays, planes, boxes,
                                                         cp, out);
  return cudaGetLastError();
}

}  // namespace

// variant: index in kEmpty..kWalk (lab5_diag.VARIANTS); rays [N, 8] with
// N a multiple of 256, planes [16 * C, 128], boxes [8, Cp], Cp <= 1024;
// out [N] (the [N, 1] column). Returns the launch's CUDA error.
extern "C" int tpt_lab5_diag(int variant, const float* rays,
                             const float* planes, const float* boxes, int n,
                             int cp, float* out, void* stream) {
  using Launch = cudaError_t (*)(const float*, const float*, const float*,
                                 int, int, float*, cudaStream_t);
  static const Launch kLaunch[] = {
      launch<kEmpty>, launch<kEpilogue>, launch<kBoxtest>, launch<kBoxvec>,
      launch<kSelect1>, launch<kWalkfix>, launch<kWalksel>, launch<kWalk>};
  if (variant < 0 || variant > kWalk)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[variant](
      rays, planes, boxes, n, cp, out, static_cast<cudaStream_t>(stream)));
}
