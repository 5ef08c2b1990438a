// The modular loop's reference-mode bounce, shaded between its closest-hit
// queries: two kernels that take the place of ~420 eager torch operations
// a bounce.
//
// Replaces no TPU kernel: the JAX package's bounce loop shades with XLA
// operations (render/integrator.py there). Plain twin: the port's torch
// code in render/integrator.py (`env_miss`, `surface`, `scatter`,
// `sample_delta_light`, `end_bounce`), which ops/shade.py's
// `_shade_hits_torch` and `_close_bounce_torch` call; these kernels give
// the same bits on the card. The shading arithmetic is kernel B's
// (shade.cuh), and every other expression transcribes the torch code in
// its order: a `torch.where(c, x, 0)` that is then multiplied by the
// throughput and added stays `r + thr * (c ? x : 0)` on every lane, so a
// non-finite throughput rounds as it does there.
//
//   shade_hits_kernel: after the bounce's main query. The environment on a
//     miss, the hit face's shading row, the shading normal and hit point,
//     the emission of an emissive hit, the BSDF sample, the extra emitter
//     direction and each delta light's direction. Writes the radiance so
//     far, the origin (the hit point) and directions of the bounce's other
//     queries in the [N, 3] rows the closest hit takes, the throughput
//     weight, and the masks of the queries (live lanes; live diffuse lanes
//     for the extra emitter).
//   close_bounce_kernel: after the extra emitter and shadow queries. The
//     extra emitter's emission, each unoccluded light's radiance (computed
//     again from the hit point, as kernel B does: the same operations on
//     the same operands), the direct term weighted by the bounce's BSDF,
//     and the next carry: origin, direction, throughput, radiance (each
//     [N, 3] rows, the next bounce's main query among them) and alive.
//     Lanes that do not go on keep their state, the radiance plus 0.
//
// What bounds it on the H100: bytes. A lane reads its carry and hits once
// and writes its outputs once: 151 B in shade_hits plus 12 B a light (its
// 15-float shading row comes from a table that stays in L2), 151 B in
// close_bounce plus 8 B a light, 98 B on a lane that does not go on. 2^20
// lanes move ~0.16 GB a kernel, ~0.047 ms at 3.35 TB/s; a few dozen
// operations a lane are far below the fp32 rate.
//
// Design: one thread a lane, ceil(N / kThreads) blocks, the last masked;
// no shared memory. The light count is a template parameter, as in kernel
// B. Built, as every kernel here, with --fmad=false: no multiply-add is
// fused (the torch code calls no `fma` on this path).
#include <cstdint>

#include "shade.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowBase = 9, kRowEm = 12, kRowEta = 13, kRowMetal = 14;

static_assert(tpt::kMaxLights == 6, "tpt_close_bounce takes 6 occ rows");

// Lane i of [N, 3] lane-major rows.
__device__ __forceinline__ void get(const float* __restrict__ p, size_t i,
                                    float& x, float& y, float& z) {
  x = p[3 * i];
  y = p[3 * i + 1];
  z = p[3 * i + 2];
}
__device__ __forceinline__ void put(float* __restrict__ p, size_t i, float x,
                                    float y, float z) {
  p[3 * i] = x;
  p[3 * i + 1] = y;
  p[3 * i + 2] = z;
}

struct HitsIn {
  const float *o, *d, *thr, *rad;  // the carry, [N, 3] each
  const bool* alive;               // [N]
  const int64_t* fid;              // [N], -1 on a miss
  const float *t, *uv;             // [N], [N, 2]
  const float* u;                  // [6, N]: the bounce's draws
  const float* shade;              // [15, F] shade_packT
  const float *env_r, *env_g, *env_b;  // [He * We]
  const float* lights;                 // [max(L, 1), 16]
  int faces, eh, ew;
  float env_scale;
};

struct HitsOut {
  float *rad, *h, *nd, *d2, *weight;  // [N, 3] each
  float* wi;                          // [L, N, 3]
  bool *live, *extra;                 // [N]
};

template <int kLights>
__global__ void __launch_bounds__(kThreads)
    shade_hits_kernel(int n, HitsIn in, HitsOut out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const size_t i = static_cast<size_t>(lane);
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb;
  get(in.o, i, ox, oy, oz);
  get(in.d, i, dx, dy, dz);
  get(in.thr, i, tr, tg, tb);
  get(in.rad, i, rr, rg, rb);
  const bool alive = in.alive[i];
  const int64_t fid = in.fid[i];
  const bool miss = fid < 0;

  // the environment on a miss (integrator.env_miss)
  float er = 0.f, eg = 0.f, eb = 0.f;
  if (alive && miss) {
    const int tex = tpt::env_texel(in.eh, in.ew, dx, dy, dz);
    er = in.env_r[tex] * in.env_scale;
    eg = in.env_g[tex] * in.env_scale;
    eb = in.env_b[tex] * in.env_scale;
  }
  rr = rr + tr * er;
  rg = rg + tg * eg;
  rb = rb + tb * eb;

  // the hit face's shading row; the surface (integrator.surface)
  const size_t f = static_cast<size_t>(fid < 0 ? 0 : fid);
  const size_t faces = static_cast<size_t>(in.faces);
  float row[15];
#pragma unroll
  for (int k = 0; k < 15; ++k) row[k] = in.shade[k * faces + f];
  const float t = miss ? 1.f : in.t[i];
  const float bu = in.uv[2 * i], bv = in.uv[2 * i + 1];
  const float bw = 1.f - bu - bv;
  float nx = (bw * row[0] + bu * row[3]) + bv * row[6];
  float ny = (bw * row[1] + bu * row[4]) + bv * row[7];
  float nz = (bw * row[2] + bu * row[5]) + bv * row[8];
  const float inv =
      tpt::inv_sqrt(tpt::nan_max((nx * nx + ny * ny) + nz * nz, 1e-20f));
  nx = nx * inv;
  ny = ny * inv;
  nz = nz * inv;
  const float hx = ox + t * dx, hy = oy + t * dy, hz = oz + t * dz;

  // integrator.scatter: an emissive hit adds the raw scalar emission
  const float em = row[kRowEm], eta = row[kRowEta], metallic = row[kRowMetal];
  const bool emissive = em > 0.f;
  const float hit_em = (alive && !miss && emissive) ? em : 0.f;
  rr = rr + tr * hit_em;
  rg = rg + tg * hit_em;
  rb = rb + tb * hit_em;
  const float* u = in.u + i;
  const float u0 = u[0], u1 = u[n], u2 = u[2 * static_cast<size_t>(n)],
              u3 = u[3 * static_cast<size_t>(n)],
              u4 = u[4 * static_cast<size_t>(n)];
  float ndx, ndy, ndz, ratio;
  tpt::sample_bsdf(u0, u1, u2, dx, dy, dz, nx, ny, nz, eta, metallic, ndx,
                   ndy, ndz, ratio);
  const float sgn = tpt::dot3(dx, dy, dz, nx, ny, nz) > 0.f ? -1.f : 1.f;
  float d2x, d2y, d2z, pdf2;
  tpt::hemi_cos(u3, u4, nx * sgn, ny * sgn, nz * sgn, d2x, d2y, d2z, pdf2);
#pragma unroll
  for (int li = 0; li < kLights; ++li) {
    float wi[3], lrad[3];
    tpt::delta_light(in.lights + 16 * li, hx, hy, hz, wi, lrad);
    put(out.wi, static_cast<size_t>(li) * n + i, wi[0], wi[1], wi[2]);
  }
  const bool live = alive && !miss && !emissive;
  put(out.rad, i, rr, rg, rb);
  put(out.h, i, hx, hy, hz);
  put(out.nd, i, ndx, ndy, ndz);
  put(out.d2, i, d2x, d2y, d2z);
  put(out.weight, i, row[kRowBase] * ratio, row[kRowBase + 1] * ratio,
      row[kRowBase + 2] * ratio);
  out.live[i] = live;
  out.extra[i] = live && !((eta >= 1.f) || (metallic > 0.f));
}

struct CloseIn {
  const float *o, *d, *thr;  // the bounce's carry, [N, 3] each
  const float *rad, *h, *nd, *weight;  // shade_hits' rows
  const bool *live, *extra;
  const int64_t* fid;                  // the main query's face
  const int64_t* fid2;                 // the extra emitter query's
  const int64_t* occ[tpt::kMaxLights];  // each shadow query's, -1 = free
  const float* shade;                   // [15, F]
  const float* face_emission;           // [F]
  const float* lights;
  int faces;
};

struct CloseOut {
  float *o, *d, *thr, *rad;  // [N, 3] each
  bool* alive;
};

// integrator.end_bounce
template <int kLights>
__global__ void __launch_bounds__(kThreads)
    close_bounce_kernel(int n, CloseIn in, CloseOut out) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const size_t i = static_cast<size_t>(lane);
  float ox, oy, oz, dx, dy, dz, tr, tg, tb, rr, rg, rb;
  get(in.o, i, ox, oy, oz);
  get(in.d, i, dx, dy, dz);
  get(in.thr, i, tr, tg, tb);
  get(in.rad, i, rr, rg, rb);
  const bool live = in.live[i];
  if (!live) {  // torch.where(live, ..., 0.0) adds 0; the rest stays
    put(out.o, i, ox, oy, oz);
    put(out.d, i, dx, dy, dz);
    put(out.thr, i, tr, tg, tb);
    put(out.rad, i, rr + 0.f, rg + 0.f, rb + 0.f);
    out.alive[i] = false;
    return;
  }
  const int64_t fid2 = in.fid2[i];
  const float em2 =
      (fid2 >= 0 && in.extra[i]) ? in.face_emission[fid2] : 0.f;
  float dr = em2, dg = em2, db = em2;
  float hx, hy, hz;
  get(in.h, i, hx, hy, hz);
  const size_t f = static_cast<size_t>(in.fid[i]);  // a live lane hit
  const size_t faces = static_cast<size_t>(in.faces);
  const float br = in.shade[kRowBase * faces + f],
              bg = in.shade[(kRowBase + 1) * faces + f],
              bb = in.shade[(kRowBase + 2) * faces + f];
#pragma unroll
  for (int li = 0; li < kLights; ++li) {
    float unused[3], lrad[3];
    tpt::delta_light(in.lights + 16 * li, hx, hy, hz, unused, lrad);
    const bool unocc = in.occ[li][i] < 0;
    dr = dr + (unocc ? br * lrad[0] : 0.f);
    dg = dg + (unocc ? bg * lrad[1] : 0.f);
    db = db + (unocc ? bb * lrad[2] : 0.f);
  }
  float wr, wg, wb;
  get(in.weight, i, wr, wg, wb);
  put(out.rad, i, rr + tr * wr * dr, rg + tg * wg * dg, rb + tb * wb * db);
  float nx, ny, nz;
  get(in.nd, i, nx, ny, nz);
  put(out.o, i, hx, hy, hz);
  put(out.d, i, nx, ny, nz);
  put(out.thr, i, tr * wr, tg * wg, tb * wb);
  out.alive[i] = true;
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <int kLights>
cudaError_t launch_hits(int n, const HitsIn& in, const HitsOut& out,
                        cudaStream_t stream) {
  shade_hits_kernel<kLights><<<blocks(n), kThreads, 0, stream>>>(n, in, out);
  return cudaGetLastError();
}

template <int kLights>
cudaError_t launch_close(int n, const CloseIn& in, const CloseOut& out,
                         cudaStream_t stream) {
  close_bounce_kernel<kLights><<<blocks(n), kThreads, 0, stream>>>(n, in,
                                                                    out);
  return cudaGetLastError();
}

using HitsFn = cudaError_t (*)(int, const HitsIn&, const HitsOut&,
                               cudaStream_t);
using CloseFn = cudaError_t (*)(int, const CloseIn&, const CloseOut&,
                                cudaStream_t);
constexpr HitsFn kHits[tpt::kMaxLights + 1] = {
    launch_hits<0>, launch_hits<1>, launch_hits<2>, launch_hits<3>,
    launch_hits<4>, launch_hits<5>, launch_hits<6>};
constexpr CloseFn kClose[tpt::kMaxLights + 1] = {
    launch_close<0>, launch_close<1>, launch_close<2>, launch_close<3>,
    launch_close<4>, launch_close<5>, launch_close<6>};

}  // namespace

// The carry o, d, thr, rad [N, 3], alive [N] (bool); the main query's fid
// [N] (int64), t [N], uv [N, 2]; the draws u [6, N]; shade_packT [15, F];
// the environment's channels [eh * ew]; the lights table [max(L, 1), 16],
// L <= 6. Writes rad, h, nd, d2, weight [N, 3], wi [L, N, 3], live and
// extra [N] (bool). Returns cudaGetLastError() after the launch.
extern "C" int tpt_shade_hits(int n, int n_lights, const float* o,
                              const float* d, const float* thr,
                              const float* rad, const bool* alive,
                              const int64_t* fid, const float* t,
                              const float* uv, const float* u,
                              const float* shade, int faces,
                              const float* env_r, const float* env_g,
                              const float* env_b, int eh, int ew,
                              float env_scale, const float* lights,
                              float* rad_out, float* h, float* nd, float* d2,
                              float* weight, float* wi, bool* live,
                              bool* extra, void* stream) {
  if (n <= 0 || n_lights < 0 || n_lights > tpt::kMaxLights || faces <= 0 ||
      eh <= 0 || ew <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const HitsIn in{o,     d,     thr,   rad,    alive, fid,   t,  uv, u,
                  shade, env_r, env_g, env_b, lights, faces, eh, ew,
                  env_scale};
  const HitsOut out{rad_out, h, nd, d2, weight, wi, live, extra};
  return static_cast<int>(
      kHits[n_lights](n, in, out, static_cast<cudaStream_t>(stream)));
}

// The bounce's carry o, d, thr [N, 3]; shade_hits' rad, h, nd, weight [N,
// 3], live and extra [N] (bool); the main query's fid, the extra emitter
// query's fid2 and each light's shadow query's occ[li] [N] (int64, -1 on a
// miss; NULL past n_lights); shade_packT [15, F], face_emission [F], the
// lights table. Writes the next carry o, d, thr, rad [N, 3] and alive [N]
// (bool). Returns cudaGetLastError() after the launch.
extern "C" int tpt_close_bounce(
    int n, int n_lights, const float* o, const float* d, const float* thr,
    const float* rad, const float* h, const float* nd, const float* weight,
    const bool* live, const bool* extra, const int64_t* fid,
    const int64_t* fid2, const int64_t* occ0, const int64_t* occ1,
    const int64_t* occ2, const int64_t* occ3, const int64_t* occ4,
    const int64_t* occ5, const float* shade, int faces,
    const float* face_emission, const float* lights, float* o_out,
    float* d_out, float* thr_out, float* rad_out, bool* alive_out,
    void* stream) {
  if (n <= 0 || n_lights < 0 || n_lights > tpt::kMaxLights || faces <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CloseIn in{o,     d,      thr,  rad,   h,
                   nd,    weight, live, extra, fid,
                   fid2,  {occ0, occ1, occ2, occ3, occ4, occ5},
                   shade, face_emission,       lights, faces};
  const CloseOut out{o_out, d_out, thr_out, rad_out, alive_out};
  return static_cast<int>(
      kClose[n_lights](n, in, out, static_cast<cudaStream_t>(stream)));
}
