// Kernel C: closest hit of N rays by a near-to-far walk over chunk boxes.
//
// Replaces the TPU kernel tinypathtracer_tpu/ops/packet.py
// `_make_packet_kernel` (called through `_packet_pallas`). Plain twin:
// tinypathtracer_tpu_torch/ops/packet.py `_packet_torch`.
//
// The triangles are kernel A's Woop planes in morton slot order, cut into
// C chunks of tc consecutive slots, each with an axis-aligned box (widened
// by its margin on the host, ops/packet.precompute_packet). A ray visits
// the chunks whose boxes it enters in ascending (entry distance, chunk
// id) and stops when the next entry is greater than its best t; inside a
// chunk it takes a hit on t < best or on t == best with a lower slot. The result is kernel A's (t, slot, u, v)
// bit for bit: the same arithmetic (hit.cuh) and the same tie rule, the
// lowest slot among equal t.
//
// Design: one thread per ray and no per-ray key storage. Each step
// rescans the C boxes with the slab test (all threads of a warp read the
// same box: broadcast loads) and selects the smallest 64-bit key,
// (entry bits << 32) | chunk id, that is above the last visited key and
// whose entry is <= the best t; it then tests that chunk's tc slots. The
// entry distance is positive, so its bits order like the floats: one
// integer comparison orders (entry, chunk id), with no cap on C and no
// truncated distance. Dead lanes (alive flag 0) traverse nothing.
//
// What bounds it on the H100: per visited chunk tc pair tests of ~39
// fp32 operations (as kernel A) plus one rescan of C boxes (~12 each), so
// it is compute-bound like kernel A, on the chunks the rays visit instead
// of all F. Threads of a warp visit different chunks, so the plane loads
// of a visit are no longer broadcasts (the planes, 48 B a slot, stay in
// L2); a warp runs as many steps as its longest walk. Left for later:
// staging chunks in shared memory, warp-cooperative packets, a per-thread
// walk of a deeper hierarchy.
#include <cstdint>

#include "hit.cuh"

namespace {

struct SlabRay {
  float ox, oy, oz, ivx, ivy, ivz;
};

// 1 / d, or the huge finite REAL_MAX for a zero component, so that
// 0 * REAL_MAX is 0 and a ray parallel to a slab never culls a box it lies
// in.
__device__ __forceinline__ float reciprocal(float d) {
  return d == 0.f ? tpt::kRealMax : 1.f / d;
}

// Slab test of a ray against chunk box b (bmin xyz, bmax xyz, validity,
// 0). Returns whether the ray enters the box at or beyond DELTA; entry =
// max(near, DELTA). fminf / fmaxf ignore NaN.
__device__ __forceinline__ bool enter_box(const float* __restrict__ b,
                                          const SlabRay& r, float& entry) {
  const float4* p = reinterpret_cast<const float4*>(b);
  const float4 lo = __ldg(p), hi = __ldg(p + 1);
  // lo = (bmin x, bmin y, bmin z, bmax x), hi = (bmax y, bmax z, valid, 0)
  if (hi.z == 0.f) return false;
  const float tx0 = (lo.x - r.ox) * r.ivx;
  const float ty0 = (lo.y - r.oy) * r.ivy;
  const float tz0 = (lo.z - r.oz) * r.ivz;
  const float tx1 = (lo.w - r.ox) * r.ivx;
  const float ty1 = (hi.x - r.oy) * r.ivy;
  const float tz1 = (hi.y - r.oz) * r.ivz;
  const float near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                          fmaxf(tz0, tz1));
  entry = fmaxf(near, tpt::kDelta);
  return far >= entry;
}

__global__ void packet_hit_kernel(const float* __restrict__ rays,
                                  const float* __restrict__ planes,
                                  const float* __restrict__ boxes, int n,
                                  int n_chunks, int tc,
                                  float* __restrict__ t_out,
                                  int* __restrict__ slot_out,
                                  float* __restrict__ uv_out,
                                  int* __restrict__ visits_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // origin xyz, direction xyz, alive flag, 0
  const float* r = rays + 8 * (size_t)i;
  const float ox = r[0], oy = r[1], oz = r[2];
  const float dx = r[3], dy = r[4], dz = r[5];
  float best_t = tpt::kRealMax, best_u = 0.f, best_v = 0.f;
  int best = -1, visits = 0;
  if (r[6] != 0.f) {
    const SlabRay ray{ox, oy, oz, reciprocal(dx), reciprocal(dy),
                      reciprocal(dz)};
    // entry >= DELTA > 0, so every key is above 0
    uint64_t last = 0;
    for (;;) {
      uint64_t next = UINT64_MAX;
      for (int ck = 0; ck < n_chunks; ++ck) {
        float entry;
        if (enter_box(boxes + 8 * (size_t)ck, ray, entry) &&
            entry <= best_t) {
          const uint64_t key =
              (static_cast<uint64_t>(__float_as_uint(entry)) << 32) |
              static_cast<uint32_t>(ck);
          if (key > last && key < next) next = key;
        }
      }
      if (next == UINT64_MAX) break;
      last = next;
      ++visits;
      const int f0 = static_cast<int>(next & 0xffffffffu) * tc;
      for (int f = f0; f < f0 + tc; ++f) {
        float w[12];
        tpt::load_planes(planes + 12 * (size_t)f, w);
        const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
        float t, u, v;
        if (tpt::hit_terms(op, dx, dy, dz, w, t, u, v) &&
            (t < best_t || (t == best_t && f < best))) {
          best_t = t;
          best = f;
          best_u = u;
          best_v = v;
        }
      }
    }
  }
  t_out[i] = best_t;
  slot_out[i] = best;
  uv_out[2 * (size_t)i] = best_u;
  uv_out[2 * (size_t)i + 1] = best_v;
  visits_out[i] = visits;
}

}  // namespace

// rays [N, 8], planes [Fp, 12], boxes [C, 8] (16-byte aligned), C * tc =
// Fp; outputs t [N] (FLT_MAX on miss), slot [N] (-1 on miss), uv [N, 2]
// (0 on miss), visits [N] (chunks tested). Returns cudaGetLastError()
// after the launch.
extern "C" int tpt_packet_hit(const float* rays, const float* planes,
                              const float* boxes, int n, int n_chunks, int tc,
                              float* t, int* slot, float* uv, int* visits,
                              void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  packet_hit_kernel<<<blocks, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      rays, planes, boxes, n, n_chunks, tc, t, slot, uv, visits);
  return static_cast<int>(cudaGetLastError());
}
