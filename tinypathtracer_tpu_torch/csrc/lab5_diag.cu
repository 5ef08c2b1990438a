// Kernel F: the stripped variants of the v1 packet kernel, the lab that
// attributes the packet walk's fixed cost per packet.
//
// Replaces the TPU kernel tinypathtracer_tpu/tools/lab5_diag.py
// `make_kernel(cp, variant)` (called through `run_variant`). Plain twin:
// tinypathtracer_tpu_torch/tools/lab5_diag.py `_diag_torch`; the module
// docstring defines each variant's output. Plain model of this schedule:
// lab5_diag.py `warp_schedule`.
//
// Design: one __global__ template over the variant, one warp per packet of
// 8 consecutive rays; every lane holds the packet's 8 rays in registers.
// - Lanes over slots: a visit of chunk ck has lane l test slots l, l + 32,
//   l + 64 and l + 96 against all 8 rays, so one lane's 12 plane loads of
//   a slot (12 coalesced 128-byte rows for the warp) serve 8 pairs. Each
//   lane keeps a best t per ray, and after the visit an fminf butterfly
//   over the 32 lanes gives every lane each ray's best: the minimum does
//   not depend on which lane tested which slot, so the walk stays the
//   twin's bit for bit.
// - o' = W o + c once a slot where the 8 origins are equal bit for bit
//   (a pixel8 packet's), the same arithmetic on the same values.
// - The TPU kernel's [8, Cp] key scratch is shared memory, [8][Cp] a
//   warp; the slab test gives lane l boxes l, l + 32, ... for the 8 rays,
//   so each box is read once a packet. The select is a scan of the lane's
//   Cp / 32 x 8 keys, each against its own ray's threshold, then a 5-step
//   min butterfly; dropping the visited chunk is one store of 8 keys.
//   Blocks hold 8 warps up to 256 boxes and fewer above, so that Cp = 1024
//   (32 KB of keys a warp) still launches.
// - A visit stages the chunk's 12 plane rows (6 KB) into the warp's shared
//   memory with one TMA bulk copy (`kTmaChunks`), then the lanes read
//   them there: 7 % faster on `walk` than each lane loading its slots'
//   coalesced rows from global memory (0.850 against 0.920 ms, NVIDIA H100
//   80GB HBM3 at 700 W), which lab5_diag --variants times
//   ("global_chunks"). The next chunk is known only after the select, so
//   no copy overlaps a visit.
//
// The hit test is the JAX kernel's arithmetic with the multiply-adds
// fused where XLA:CPU fuses it (measured), compiled with --fmad=false, so
// every variant equals the twin bit for bit. min / max are fminf / fmaxf:
// no operand is NaN here (a zero direction component gets the finite
// reciprocal REAL_MAX, boxes are finite).
//
// What bounds it: the walk's pair tests (1,024 a visit a packet, ~21 fp32
// operations each once o' is shared, with the IEEE divide) and each ray's
// slab test of every box. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (2^18 pixel8 rays of the big room, 11.7 visits a packet): `walk` 0.85
// ms, `walkfix` 0.37, against 5.14 and 1.59 for the v1 thread-per-ray
// kernel in the same call (lab5_diag --variants).
#include <cstdint>

#include "hit.cuh"
#include "tma.cuh"

namespace {

constexpr float kDeltaL = 1e-4f;    // the lab's own constants
constexpr float kRealMaxL = 3.4e38f;
constexpr int kI32Max = 0x7fffffff;
constexpr int kTN = 256, kPacket = 8, kChunk = 128, kRows = 16;
constexpr int kPlaneRows = 12;             // rows of a chunk that hold planes
constexpr unsigned kFull = 0xffffffffu;
constexpr bool kTmaChunks = true;

enum Variant { kEmpty, kEpilogue, kBoxtest, kBoxvec, kSelect1, kWalkfix,
               kWalksel, kWalk };

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_fmin(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// the packet's 8 rays, in every lane
struct Packet {
  float ox[kPacket], oy[kPacket], oz[kPacket];
  float dx[kPacket], dy[kPacket], dz[kPacket];
};

__device__ __forceinline__ void load_packet(const float* __restrict__ rays,
                                            int i0, Packet& r) {
  const float4* p = reinterpret_cast<const float4*>(rays + 8 * (size_t)i0);
#pragma unroll
  for (int q = 0; q < kPacket; ++q) {
    const float4 a = __ldg(p + 2 * q), b = __ldg(p + 2 * q + 1);
    r.ox[q] = a.x; r.oy[q] = a.y; r.oz[q] = a.z;
    r.dx[q] = a.w; r.dy[q] = b.x; r.dz[q] = b.y;
  }
}

// value q of v in lane q < 8: the packet's output column
__device__ __forceinline__ void write_out(const float v[kPacket], int lane,
                                          int i0, float* __restrict__ out) {
  float x = v[0];
#pragma unroll
  for (int q = 1; q < kPacket; ++q)
    if (lane == q) x = v[q];
  if (lane < kPacket) out[i0 + lane] = x;
}

__device__ __forceinline__ float inv(float d) {
  return d == 0.f ? kRealMaxL : 1.f / d;
}

// (near, far) of the slab test of ray q against box b[0:6]
__device__ __forceinline__ void slab(const Packet& r, const float iv[3],
                                     int q, const float b[6], float& near,
                                     float& far) {
  const float tx0 = (b[0] - r.ox[q]) * iv[0];
  const float ty0 = (b[1] - r.oy[q]) * iv[1];
  const float tz0 = (b[2] - r.oz[q]) * iv[2];
  const float tx1 = (b[3] - r.ox[q]) * iv[0];
  const float ty1 = (b[4] - r.oy[q]) * iv[1];
  const float tz1 = (b[5] - r.oz[q]) * iv[2];
  near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
}

// The 12 planes of chunk ck, rows of 128 slots: in global memory, or
// staged by one TMA bulk copy into this warp's buffer (kTmaChunks).
struct Chunks {
  const float* planes;  // [16 * C, 128]
  float* stage;         // [12][128] of this warp, or null
  uint64_t* bar;
  uint32_t phase;

  __device__ __forceinline__ const float* rows(int ck, int lane) {
    const float* src = planes + (size_t)ck * kRows * kChunk;
    if (!kTmaChunks) return src;
    __syncwarp();  // every lane is done reading the previous chunk
    if (lane == 0)
      tpt::bulk_copy(stage, src, kPlaneRows * kChunk * 4, bar);
    tpt::wait_parity(bar, phase);
    phase ^= 1u;
    return stage;
  }
};

// best [8] (equal in every lane) lowered by the hits of the 128 slots of
// chunk ck: lane l tests slots l + 32 j; kOne: the 8 origins are equal
template <bool kOne>
__device__ __forceinline__ void visit(const Packet& r, Chunks& ch, int ck,
                                      int lane, float best[kPacket]) {
  const float* p = ch.rows(ck, lane);
  float lb[kPacket];
#pragma unroll
  for (int q = 0; q < kPacket; ++q) lb[q] = best[q];
#pragma unroll
  for (int j = 0; j < kChunk / 32; ++j) {
    const int s = lane + 32 * j;
    float w[kPlaneRows];
#pragma unroll
    for (int k = 0; k < kPlaneRows; ++k)
      w[k] = kTmaChunks ? p[k * kChunk + s] : __ldg(p + k * kChunk + s);
    tpt::Origin op0{};
    if (kOne) op0 = tpt::origin_terms(r.ox[0], r.oy[0], r.oz[0], w);
#pragma unroll
    for (int q = 0; q < kPacket; ++q) {
      const tpt::Origin op =
          kOne ? op0 : tpt::origin_terms(r.ox[q], r.oy[q], r.oz[q], w);
      const float dpx = tpt::affine(r.dx[q], r.dy[q], r.dz[q], w[0], w[1],
                                    w[2]);
      const float dpy = tpt::affine(r.dx[q], r.dy[q], r.dz[q], w[4], w[5],
                                    w[6]);
      const float dpz = tpt::affine(r.dx[q], r.dy[q], r.dz[q], w[8], w[9],
                                    w[10]);
      const float t = -op.z / dpz;
      const float u = fmaf(t, dpx, op.x), v = fmaf(t, dpy, op.y);
      if ((fminf(u, v) >= 0.f) & (u + v <= 1.f) & (t > kDeltaL) &
          (t < lb[q]))
        lb[q] = t;
    }
  }
#pragma unroll
  for (int q = 0; q < kPacket; ++q) best[q] = warp_fmin(lb[q]);
}

template <bool kOne>
__device__ __forceinline__ void walkfix(const Packet& r, Chunks& ch, int pk,
                                        int lane, float best[kPacket]) {
  const int p = pk % (kTN / kPacket);  // the packet's index in its 256 rays
  for (int k = 0; k < 8; ++k) visit<kOne>(r, ch, (p + k) % 16, lane, best);
}

// the packet's smallest live key: a key of ray q is live while it is <=
// the bits of best[q] with the low 10 bits set
__device__ __forceinline__ int select_key(const int* keys, int cp, int lane,
                                          const float best[kPacket]) {
  int ibt[kPacket];
#pragma unroll
  for (int q = 0; q < kPacket; ++q) ibt[q] = __float_as_int(best[q]) | 1023;
  int m = kI32Max;
  for (int c = lane; c < cp; c += 32) {
#pragma unroll
    for (int q = 0; q < kPacket; ++q) {
      const int k = keys[q * cp + c];
      m = min(m, k <= ibt[q] ? k : kI32Max);
    }
  }
  return warp_min(m);
}

template <bool kOne, int V>
__device__ __forceinline__ int walk(const Packet& r, Chunks& ch, int* keys,
                                    int cp, int lane, float best[kPacket],
                                    int& visits) {
  int m = select_key(keys, cp, lane, best);
  while (m < kI32Max) {
    const int ck = m & 1023;
    if (V == kWalk) visit<kOne>(r, ch, ck, lane, best);
    __syncwarp();
    if (lane < kPacket) keys[lane * cp + ck] = kI32Max;  // leaves every ray
    __syncwarp();
    ++visits;
    m = select_key(keys, cp, lane, best);
  }
  return m;
}

template <int V>
__global__ void __launch_bounds__(256)
    diag_kernel(const float* __restrict__ rays,
                const float* __restrict__ planes,
                const float* __restrict__ boxes, int cp, int smem_warp,
                float* __restrict__ out, int* __restrict__ visits_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pk = blockIdx.x * (blockDim.x >> 5) + warp;
  const int i0 = pk * kPacket;
  unsigned char* mine = smem + (size_t)warp * smem_warp;
  Packet r;
  load_packet(rays, i0, r);
  float res[kPacket];

  if (V == kEmpty) {
#pragma unroll
    for (int q = 0; q < kPacket; ++q) res[q] = r.ox[q] + r.dx[q];
    write_out(res, lane, i0, out);
    return;
  }
  if (V == kEpilogue) {
    // the argmin epilogue over the warp's [8][128] scratch of REAL_MAX
    float* lane_t = reinterpret_cast<float*>(mine);
    for (int k = lane; k < kPacket * kChunk; k += 32) lane_t[k] = kRealMaxL;
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kPacket; ++q) {
      float m = lane_t[q * kChunk + lane];
      for (int j = 1; j < kChunk / 32; ++j)
        m = fminf(m, lane_t[q * kChunk + lane + 32 * j]);
      m = warp_fmin(m);
      int cand = kI32Max;
      for (int j = 0; j < kChunk / 32; ++j)
        if (lane_t[q * kChunk + lane + 32 * j] == m)
          cand = min(cand, lane + 32 * j);
      res[q] = m + (float)warp_min(cand);
    }
    write_out(res, lane, i0, out);
    return;
  }

  // the chunk stage (kTmaChunks) sits after the keys in the warp's region
  Chunks ch{planes, nullptr, nullptr, 0u};
  if (kTmaChunks && (V == kWalk || V == kWalkfix)) {
    const bool keyed = V == kWalk;
    ch.stage = reinterpret_cast<float*>(
        mine + (keyed ? (size_t)kPacket * cp * 4 : 0));
    ch.bar = reinterpret_cast<uint64_t*>(ch.stage + kPlaneRows * kChunk);
    if (lane == 0) tpt::init_barriers(ch.bar, 1);
    __syncwarp();
  }
  bool one = true;  // the 8 origins equal bit for bit
#pragma unroll
  for (int q = 1; q < kPacket; ++q)
    one &= (__float_as_uint(r.ox[q]) == __float_as_uint(r.ox[0])) &
           (__float_as_uint(r.oy[q]) == __float_as_uint(r.oy[0])) &
           (__float_as_uint(r.oz[q]) == __float_as_uint(r.oz[0]));

  if (V == kWalkfix) {
#pragma unroll
    for (int q = 0; q < kPacket; ++q) res[q] = kRealMaxL;
    if (one)
      walkfix<true>(r, ch, pk, lane, res);
    else
      walkfix<false>(r, ch, pk, lane, res);
    write_out(res, lane, i0, out);
    return;
  }

  float iv[kPacket][3];
#pragma unroll
  for (int q = 0; q < kPacket; ++q) {
    iv[q][0] = inv(r.dx[q]);
    iv[q][1] = inv(r.dy[q]);
    iv[q][2] = inv(r.dz[q]);
  }
  if (V == kBoxvec) {
    float m[kPacket];
#pragma unroll
    for (int q = 0; q < kPacket; ++q) m[q] = kRealMaxL;
    for (int c = lane; c < cp; c += 32) {
      float b[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) b[k] = __ldg(boxes + k * cp + c);
#pragma unroll
      for (int q = 0; q < kPacket; ++q) {
        float near, far;
        slab(r, iv[q], q, b, near, far);
        if (far >= fmaxf(near, kDeltaL)) m[q] = fminf(m[q], near);
      }
    }
#pragma unroll
    for (int q = 0; q < kPacket; ++q) res[q] = warp_fmin(m[q]);
    write_out(res, lane, i0, out);
    return;
  }

  // the packed keys of every box: lane l writes boxes l + 32 j of each ray
  int* keys = reinterpret_cast<int*>(mine);  // [8][cp]
  int kmin[kPacket];
#pragma unroll
  for (int q = 0; q < kPacket; ++q) kmin[q] = kI32Max;
  for (int c = lane; c < cp; c += 32) {
    float b[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = __ldg(boxes + k * cp + c);
    const bool valid = __ldg(boxes + 6 * cp + c) != 0.f;
#pragma unroll
    for (int q = 0; q < kPacket; ++q) {
      float near, far;
      slab(r, iv[q], q, b, near, far);
      const float e = fmaxf(near, kDeltaL);
      const bool hit = (far >= e) & valid;
      const int k = hit ? (((__float_as_int(e) | 1023) ^ 1023) | c) : kI32Max;
      keys[q * cp + c] = k;
      kmin[q] = min(kmin[q], k);
    }
  }
  if (V == kBoxtest) {
#pragma unroll
    for (int q = 0; q < kPacket; ++q) res[q] = (float)warp_min(kmin[q]);
    write_out(res, lane, i0, out);
    return;
  }
  __syncwarp();
  float best[kPacket];
#pragma unroll
  for (int q = 0; q < kPacket; ++q) best[q] = kRealMaxL;
  if (V == kSelect1) {
    const float m = (float)select_key(keys, cp, lane, best);
#pragma unroll
    for (int q = 0; q < kPacket; ++q) res[q] = m;
    write_out(res, lane, i0, out);
    return;
  }
  int visits = 0;
  const int m = one ? walk<true, V>(r, ch, keys, cp, lane, best, visits)
                    : walk<false, V>(r, ch, keys, cp, lane, best, visits);
#pragma unroll
  for (int q = 0; q < kPacket; ++q) res[q] = V == kWalk ? best[q] : (float)m;
  write_out(res, lane, i0, out);
  if (V == kWalk && visits_out != nullptr && lane == 0)
    visits_out[pk] = visits;
}

// warps a block: 8, fewer where a warp's keys pass 8 KB (Cp > 256), so
// that a block keeps <= 64 KB of keys
int block_warps(int cp) {
  int w = 8;
  while (w > 1 && w * kPacket * cp * 4 > 64 * 1024) w >>= 1;
  return w;
}

template <int V>
cudaError_t launch(const float* rays, const float* planes,
                   const float* boxes, int n, int cp, float* out,
                   int* visits, cudaStream_t stream) {
  const bool keyed = V == kBoxtest || V == kSelect1 || V == kWalksel ||
                     V == kWalk;
  const bool staged = kTmaChunks && (V == kWalk || V == kWalkfix);
  int smem_warp = keyed ? kPacket * cp * 4 : 0;
  if (V == kEpilogue) smem_warp = kPacket * kChunk * 4;
  if (staged) smem_warp += kPlaneRows * kChunk * 4 + 16;  // rows, barrier
  smem_warp = (smem_warp + 127) / 128 * 128;
  const int warps = keyed ? block_warps(cp) : 8;
  const int smem = warps * smem_warp;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        diag_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int packets = n / kPacket;
  diag_kernel<V><<<packets / warps, 32 * warps, smem, stream>>>(
      rays, planes, boxes, cp, smem_warp, out, visits);
  return cudaGetLastError();
}

}  // namespace

// variant: index in kEmpty..kWalk (lab5_diag.VARIANTS); rays [N, 8] with
// N a multiple of 256, planes [16 * C, 128], boxes [8, Cp], Cp <= 1024;
// out [N] (the [N, 1] column); visits [N / 8] (the chunks each packet
// visited, written by `walk` only) or null. Returns the launch's CUDA
// error.
extern "C" int tpt_lab5_diag(int variant, const float* rays,
                             const float* planes, const float* boxes, int n,
                             int cp, float* out, int* visits, void* stream) {
  using Launch = cudaError_t (*)(const float*, const float*, const float*,
                                 int, int, float*, int*, cudaStream_t);
  static const Launch kLaunch[] = {
      launch<kEmpty>, launch<kEpilogue>, launch<kBoxtest>, launch<kBoxvec>,
      launch<kSelect1>, launch<kWalkfix>, launch<kWalksel>, launch<kWalk>};
  if (variant < 0 || variant > kWalk)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunch[variant](rays, planes, boxes, n, cp, out,
                                           visits,
                                           static_cast<cudaStream_t>(stream)));
}
