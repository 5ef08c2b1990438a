// The threefry key chain: every lane's key, camera draws and bounce draws.
//
// Replaces no TPU kernel: the JAX package leaves threefry to XLA through
// `jax.random` (ops/sampling.py there). Plain twin: the int64 chain of
// tinypathtracer_tpu_torch/ops/sampling.py (`_lane_keys_torch`,
// `_lane_draws_torch`), which the tests hold to `jax.random` bit for bit;
// these kernels give the same bits.
//
// What bounds it on the H100: integer issue. One threefry2x32 is ~80
// integer operations (20 rounds of add, rotate, xor; 5 key injections; the
// first adds), and a reference-mode lane at depth 8 hashes 61 times: 5 for
// its key and camera draws, 7 a bounce. The 20 rotates (funnel shifts) and
// 20 xors run only on the ALU pipe, 64 lanes a clock an SM; the adds may
// issue on the IMAD pipe beside it. So a 1920x1080 @16 spp frame (2^25
// lanes) needs ~8.2e10 ALU operations, ~4.9 ms at 132 SMs x 64 x 1.98 GHz.
// The bytes (per lane 256 B of bounce draws, 16 B of key and 8 B of camera
// draws written, the key read back once) take ~3.0 ms at 3.35 TB/s and
// overlap the hashing.
//
// Design: one thread a lane, the whole chain in 32-bit registers (the
// rotate a funnel shift); nothing between two hashes goes to memory. A lane
// reads its inputs once (the frame key is a broadcast, its pixel id shared
// by the spp lanes of a pixel) and writes each output once. Draws are
// written row by row with the lane as the fast index, so each store of a
// warp is one coalesced 128-byte line. No shared memory; exactly
// ceil(N / kThreads) blocks, the last one masked. Tags, counts and the
// sample offset are arguments: nothing is read back to the host.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// Threefry-2x32, 20 rounds, of the key (k0, k1) on the counter (0, c):
// jax's threefry2x32 as `fold_in` and `uniform` call it.
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1,
                                          uint32_t c) {
  const uint32_t k2 = k0 ^ k1 ^ kParity;
  uint32_t x0 = k0, x1 = c + k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// U[0, 1) from the two words of a hash (`_to_unit`).
__device__ __forceinline__ float to_unit(uint2 b) {
  return __uint_as_float(((b.x ^ b.y) >> 9) | 0x3F800000u) - 1.0f;
}

// Lane i of n: pixel pix[i / spp], absolute sample sample_offset + i % spp.
// keys[i] = fold_in(fold_in(key, pixel), sample) as two int64 words;
// u_cam[i] = lane_uniform(fold_in(keys[i], cam_tag), 2).
__global__ void __launch_bounds__(kThreads)
    lane_keys_kernel(const long long* __restrict__ key,
                     const long long* __restrict__ pix, int n, int spp,
                     uint32_t sample_offset, uint32_t cam_tag,
                     longlong2* __restrict__ keys,
                     float2* __restrict__ u_cam) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int p = i / spp;
  const uint2 kp = threefry(static_cast<uint32_t>(key[0]),
                            static_cast<uint32_t>(key[1]),
                            static_cast<uint32_t>(pix[p]));
  const uint2 kl = threefry(kp.x, kp.y,
                            sample_offset + static_cast<uint32_t>(i - p * spp));
  keys[i] = make_longlong2(kl.x, kl.y);
  const uint2 kc = threefry(kl.x, kl.y, cam_tag);
  u_cam[i] = make_float2(to_unit(threefry(kc.x, kc.y, 0u)),
                         to_unit(threefry(kc.x, kc.y, 1u)));
}

// Band b of n_tags (tag first_tag + b) of lane i: rows b * rows + j hold
// lane_uniform(fold_in(keys[i], tag), m)[j] for j < m and 0 for m <= j <
// rows; out is [n_tags * rows, n].
__global__ void __launch_bounds__(kThreads)
    lane_draws_kernel(const longlong2* __restrict__ keys, int n,
                      uint32_t first_tag, int n_tags, int m, int rows,
                      float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const longlong2 k = keys[i];
  const uint32_t k0 = static_cast<uint32_t>(k.x);
  const uint32_t k1 = static_cast<uint32_t>(k.y);
  float* col = out + i;
  for (int b = 0; b < n_tags; ++b) {
    const uint2 kb = threefry(k0, k1, first_tag + static_cast<uint32_t>(b));
    for (int j = 0; j < rows; ++j, col += n)
      *col = j < m ? to_unit(threefry(kb.x, kb.y, static_cast<uint32_t>(j)))
                   : 0.0f;
  }
}

int blocks_of(int n) { return (n - 1) / kThreads + 1; }

}  // namespace

// key [2] and pix [P] int64, n = P * spp lanes; keys [n, 2] int64 (16-byte
// aligned) and u_cam [n, 2] float32 written. Returns cudaGetLastError()
// after the launch.
extern "C" int tpt_lane_keys(const long long* key, const long long* pix,
                             int n, int spp, uint32_t sample_offset,
                             uint32_t cam_tag, long long* keys, float* u_cam,
                             void* stream) {
  if (n <= 0 || spp <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lane_keys_kernel<<<blocks_of(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      key, pix, n, spp, sample_offset, cam_tag,
      reinterpret_cast<longlong2*>(keys), reinterpret_cast<float2*>(u_cam));
  return static_cast<int>(cudaGetLastError());
}

// keys [n, 2] int64 (16-byte aligned); out [n_tags * rows, n] float32
// written, 1 <= m <= rows. Returns cudaGetLastError() after the launch.
extern "C" int tpt_lane_draws(const long long* keys, int n,
                              uint32_t first_tag, int n_tags, int m, int rows,
                              float* out, void* stream) {
  if (n <= 0 || n_tags <= 0 || m <= 0 || rows < m)
    return static_cast<int>(cudaErrorInvalidValue);
  lane_draws_kernel<<<blocks_of(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const longlong2*>(keys), n, first_tag, n_tags, m, rows,
      out);
  return static_cast<int>(cudaGetLastError());
}
