// Kernel B: the reference-mode path-tracing megakernel, forward.
//
// Replaces the TPU kernel tinypathtracer_tpu/ops/mega.py
// `_make_mega_kernel` (called through `_mega_pallas`; ungated). Plain twin:
// tinypathtracer_tpu_torch/ops/mega.py `_mega_torch`. Every expression
// below transcribes the twin's (and the JAX kernel's) in the same order;
// see hit.cuh for the roundings.
//
// Two instances per light count: the forward (kSaveHits = false) and the
// train step's forward (kSaveHits = true), which also writes the per-bounce
// hit residuals that the backward replays shading on: [8 * depth, N]
// floats, per bounce the rows slot, t, u, v, slot2, occlusion bitmask
// (bit li = light li occluded), 0, 0. A bounce the lane never reaches (it
// missed or died earlier) reads "dead": slot -1, t REAL_MAX, slot2 -1, the
// rest 0. The emissive bounce keeps its hit (slot, t, u, v) with slot2 -1
// and occlusion 0; slot2 and occlusion are read only on live lanes. Thread
// i writes column i of every row, so each row store is coalesced.
//
// Design: one thread per path, in place of the TPU's 256-lane block. The
// thread does the camera closest hit, then loops over up to `depth`
// bounces and leaves the loop when its path dies (miss or emissive hit):
// a dead lane never changes state, so this equals the TPU kernel's
// block-wide early exit. Per bounce one pass over the triangles serves
// every query that leaves the hit point: the next-direction closest hit
// (skipped on the last bounce, whose result is never read), the extra
// emitter query (only on diffuse lanes) and up to 6 delta-light any-hits
// (each stops testing at its first occluder; no max-distance clip, a
// reference quirk). The shading fetch is an indexed load of the hit
// slot's face-major row of 32 floats. The lights table sits in shared
// memory. The env lookup of lanes that missed runs after the kernel.
//
// What bounds it on the H100: per (ray, triangle, query) about 21 fp32
// multiply-adds and one IEEE divide (the origin transform is shared by
// the queries of a bounce), O(F) per query: compute-bound on the CUDA
// cores. Left for later: staging the planes in shared memory, several
// paths per thread, and culling (BVH or packet traversal) in place of the
// brute-force sweep.
#include "hit.cuh"

namespace {

constexpr int kMaxLights = 6;
constexpr int kShadeRows = 32;
constexpr int kRowNrm = 12, kRowBase = 21, kRowEm = 24, kRowEta = 25,
              kRowMetal = 26;
constexpr float kPi = 3.14159265358979f;
// 1 / pi rounded to float32 (ops/shading_c.py INV_PI): the JAX package's
// `x / pi` is `x * (1 / pi)` once XLA has compiled it
constexpr float kInvPi = 0x1.45f306p-2f;

// jnp.maximum / torch.clamp semantics: a NaN operand gives NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
__device__ __forceinline__ float clip01(float x) {
  return nan_min(nan_max(x, 0.f), 1.f);
}
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return (ax * bx + ay * by) + az * bz;
}
__device__ __forceinline__ float inv_sqrt(float x) { return 1.f / sqrtf(x); }

// Cosine-weighted hemisphere sample in the reference's tangent frame.
__device__ __forceinline__ void hemi_cos(float u1, float u2, float nx,
                                         float ny, float nz, float& dx,
                                         float& dy, float& dz, float& pdf) {
  const float phi = (2.f * kPi) * u1;
  const float cos_t = sqrtf(u2);
  const float sin_t = sqrtf(nan_max(1.f - u2, 0.f));
  const bool z_zero = nz == 0.f;
  const float safe_nz = z_zero ? 1.f : nz;
  const float rx = z_zero ? 0.f : 1.f;
  const float rz = z_zero ? 1.f : -nx / safe_nz;
  const float inv = inv_sqrt(nan_max(rx * rx + rz * rz, 0.f));
  const float tx = rx * inv, tz = rz * inv, ty = 0.f;
  const float bx = ty * nz - tz * ny;
  const float by = tz * nx - tx * nz;
  const float bz = tx * ny - ty * nx;
  const float a = cosf(phi) * sin_t;
  const float c = sinf(phi) * sin_t;
  dx = (a * tx + cos_t * nx) + c * bx;
  dy = (a * ty + cos_t * ny) + c * by;
  dz = (a * tz + cos_t * nz) + c * bz;
  pdf = cos_t * kInvPi;
}

// The reference BSDF sample without the base-color factor: Fresnel-coin
// dielectric, mirror, or cosine diffuse.
__device__ __forceinline__ void sample_bsdf(float u1, float u2, float u3,
                                            float dx, float dy, float dz,
                                            float nx, float ny, float nz,
                                            float ior, float metallic,
                                            float& ndx, float& ndy,
                                            float& ndz, float& ratio) {
  // refraction (bsdf.refract_reference)
  const float cos_i = dot3(dx, dy, dz, nx, ny, nz);
  const bool exiting = cos_i > 0.f;
  const float ior_safe = ior > 0.f ? ior : 1.f;
  const float eta = exiting ? ior_safe : 1.f / ior_safe;
  const float sx = exiting ? -nx : nx;
  const float sy = exiting ? -ny : ny;
  const float sz = exiting ? -nz : nz;
  const float cos_i_abs = fabsf(cos_i);
  const float sin2_t = eta * eta * (1.f - cos_i_abs * cos_i_abs);
  const bool tir = sin2_t >= 1.f;
  const float cos_tt = sqrtf(nan_max(1.f - (tir ? 0.f : sin2_t), 0.f));
  const float k = cos_i_abs * eta - cos_tt;
  const float rfx = tir ? 0.f : eta * dx + k * sx;
  const float rfy = tir ? 0.f : eta * dy + k * sy;
  const float rfz = tir ? 0.f : eta * dz + k * sz;
  // reflection
  const float kr = 2.f * dot3(dx, dy, dz, nx, ny, nz);
  const float rlx = dx - kr * nx, rly = dy - kr * ny, rlz = dz - kr * nz;
  // Schlick Fresnel coin
  float f0 = (1.f - eta) / (1.f + eta);
  f0 = f0 * f0;
  const float m = clip01(1.f - cos_i_abs);
  const float m2 = m * m;
  const float fr = tir ? 1.f : f0 + (1.f - f0) * m2 * m2 * m;
  const bool take_refl = u3 < fr;
  // diffuse lobe around the incident-side normal
  const float sign = dot3(dx, dy, dz, nx, ny, nz) > 0.f ? -1.f : 1.f;
  const float nsx = nx * sign, nsy = ny * sign, nsz = nz * sign;
  float hx, hy, hz, pdf;
  hemi_cos(u1, u2, nsx, nsy, nsz, hx, hy, hz, pdf);
  const float cos_o = dot3(hx, hy, hz, nsx, nsy, nsz);
  const float atten = fabsf(cos_o) * kInvPi;
  const float diff_ratio = atten / nan_max(pdf, 1e-12f);

  const bool is_dielec = ior > 0.f;
  const bool is_mirror = !is_dielec && metallic > 0.f;
  ndx = is_dielec ? (take_refl ? rlx : rfx) : (is_mirror ? rlx : hx);
  ndy = is_dielec ? (take_refl ? rly : rfy) : (is_mirror ? rly : hy);
  ndz = is_dielec ? (take_refl ? rlz : rfz) : (is_mirror ? rlz : hz);
  ratio = (is_dielec || is_mirror) ? 1.f : diff_ratio;
}

// One delta light (a row of the [L, 16] table) seen from (px, py, pz):
// direction toward it and attenuated radiance (ops/lights.py).
__device__ __forceinline__ void delta_light(const float* L, float px,
                                            float py, float pz, float wi[3],
                                            float lrad[3]) {
  const float tlx = L[5] - px, tly = L[6] - py, tlz = L[7] - pz;
  const float dist_ps = sqrtf(nan_max(dot3(tlx, tly, tlz, tlx, tly, tlz),
                                      1e-20f));
  const bool is_dir = L[0] == 1.f;
  wi[0] = is_dir ? -L[8] : tlx / dist_ps;
  wi[1] = is_dir ? -L[9] : tly / dist_ps;
  wi[2] = is_dir ? -L[10] : tlz / dist_ps;
  const float dist = is_dir ? 0.f : dist_ps;
  const float cos_theta = dot3(-wi[0], -wi[1], -wi[2], L[8], L[9], L[10]);
  const float cone = clip01((cos_theta - L[11]) * L[12]);
  const float falloff = L[0] == 2.f ? cone * cone : 1.f;
  const float d2 = dist * dist;
  const float window = clip01(1.f - (d2 * 0.01f) * (d2 * 0.01f));
  const float fa = falloff * ((1.f / (d2 + 1.f)) * (window * window));
  lrad[0] = L[1] * L[4] * fa;
  lrad[1] = L[2] * L[4] * fa;
  lrad[2] = L[3] * L[4] * fa;
}

// One pass over all triangles for the queries leaving one origin: up to
// two closest-hit directions (slot -1 on miss; a query that is not needed
// returns -1) and kLights any-hit directions.
template <int kLights>
__device__ __forceinline__ void trace_queries(
    const float* __restrict__ planes, int fp, float ox, float oy, float oz,
    bool need_a, const float da[3], int& slot_a, bool need_b,
    const float db[3], int& slot_b, const float wi[][3], bool occluded[]) {
  float best_a = tpt::kRealMax, best_b = tpt::kRealMax;
  int arg_a = -1, arg_b = -1;
  for (int f = 0; f < fp; ++f) {
    float w[12];
    tpt::load_planes(planes + 12 * (size_t)f, w);
    const tpt::Origin op = tpt::origin_terms(ox, oy, oz, w);
    float t, u, v;
    if (need_a && tpt::hit_terms(op, da[0], da[1], da[2], w, t, u, v) &&
        t < best_a) {
      best_a = t;
      arg_a = f;
    }
    if (need_b && tpt::hit_terms(op, db[0], db[1], db[2], w, t, u, v) &&
        t < best_b) {
      best_b = t;
      arg_b = f;
    }
#pragma unroll
    for (int li = 0; li < kLights; ++li) {
      if (!occluded[li]) {
        occluded[li] =
            tpt::hit_terms(op, wi[li][0], wi[li][1], wi[li][2], w, t, u, v);
      }
    }
  }
  slot_a = arg_a;
  slot_b = arg_b;
}

// One bounce's rows of the hit residuals (column i of [8 * depth, N]).
__device__ __forceinline__ void store_hit(float* __restrict__ hits, int n,
                                          int i, int dep, float slot, float t,
                                          float u, float v, float slot2,
                                          float occ) {
  float* h = hits + (size_t)(8 * dep) * n + i;
  const float row[8] = {slot, t, u, v, slot2, occ, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) h[(size_t)k * n] = row[k];
}

// The light count is a template parameter: the per-light state (direction,
// radiance, occlusion) then takes registers only for lights that exist.
// Measured on the H100: 104 registers with room for 6 lights, 67 with
// none, and 1.86x faster on a light-free scene (bit-identical output).
// kSaveHits adds the residual stores and nothing else: every value it
// stores is live in the forward already.
template <int kLights, bool kSaveHits>
__global__ void mega_kernel(const float* __restrict__ rays8,
                            const float* __restrict__ u8d,
                            const float* __restrict__ planes,
                            const float* __restrict__ shade,
                            const float* __restrict__ lights, int n, int fp,
                            int depth, float* __restrict__ out,
                            float* __restrict__ hits) {
  constexpr int kSlots = kLights > 0 ? kLights : 1;
  __shared__ float s_lights[kSlots * 16];
  for (int k = threadIdx.x; k < kLights * 16; k += blockDim.x)
    s_lights[k] = lights[k];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float ox = rays8[i], oy = rays8[n + i], oz = rays8[2 * (size_t)n + i];
  float dx = rays8[4 * (size_t)n + i], dy = rays8[5 * (size_t)n + i],
        dz = rays8[6 * (size_t)n + i];
  float tr = 1.f, tg = 1.f, tb = 1.f;   // throughput
  float rr = 0.f, rg = 0.f, rb = 0.f;   // radiance
  float mr = 0.f, mg = 0.f, mb = 0.f;   // throughput at the miss
  float wi[kSlots][3], lrad[kSlots][3];
  bool occluded[kSlots];

  int slot, unused;
  int rows_done = 0;  // bounces whose residual rows are written
  {
    const float d[3] = {dx, dy, dz};
    trace_queries<0>(planes, fp, ox, oy, oz, true, d, slot, false, d,
                     unused, wi, occluded);
  }
  for (int dep = 0; dep < depth; ++dep) {
    if (slot < 0) {  // miss: the epilogue adds thr * env(dir); path ends
      // (its residual row is a dead row, written after the loop)
      mr = tr;
      mg = tg;
      mb = tb;
      break;
    }
    const float* u = u8d + (size_t)(8 * dep) * n + i;
    const float u0 = u[0], u1 = u[n], u2 = u[2 * (size_t)n],
                u3 = u[3 * (size_t)n], u4 = u[4 * (size_t)n];
    // hit slot's row: planes, then shading; (t, u, v) recomputed with the
    // query's arithmetic, bit-equal to the values the query compared
    const float* row = shade + (size_t)slot * kShadeRows;
    float w[12];
    tpt::load_planes(row, w);
    float tw, uw, vw;
    tpt::hit_terms(tpt::origin_terms(ox, oy, oz, w), dx, dy, dz, w, tw, uw,
                   vw);
    const float ww = 1.f - uw - vw;
    float nx = (ww * row[kRowNrm + 0] + uw * row[kRowNrm + 3]) +
               vw * row[kRowNrm + 6];
    float ny = (ww * row[kRowNrm + 1] + uw * row[kRowNrm + 4]) +
               vw * row[kRowNrm + 7];
    float nz = (ww * row[kRowNrm + 2] + uw * row[kRowNrm + 5]) +
               vw * row[kRowNrm + 8];
    const float inv = inv_sqrt(nan_max((nx * nx + ny * ny) + nz * nz, 1e-20f));
    nx = nx * inv;
    ny = ny * inv;
    nz = nz * inv;
    const float hx = ox + tw * dx, hy = oy + tw * dy, hz = oz + tw * dz;
    const float br = row[kRowBase], bg = row[kRowBase + 1],
                bb = row[kRowBase + 2];
    const float em = row[kRowEm], eta = row[kRowEta], metallic = row[kRowMetal];

    // an emissive hit adds the raw scalar emission and ends the path
    const bool emissive = em > 0.f;
    const float hit_em = emissive ? em : 0.f;
    rr = rr + tr * hit_em;
    rg = rg + tg * hit_em;
    rb = rb + tb * hit_em;
    if (emissive) {
      if constexpr (kSaveHits) {
        store_hit(hits, n, i, dep, (float)slot, tw, uw, vw, -1.f, 0.f);
        rows_done = dep + 1;
      }
      break;
    }

    float ndx, ndy, ndz, ratio;
    sample_bsdf(u0, u1, u2, dx, dy, dz, nx, ny, nz, eta, metallic, ndx, ndy,
                ndz, ratio);
    const float wr = br * ratio, wg = bg * ratio, wb = bb * ratio;
    // extra direct-emitter sample on diffuse lanes
    const bool do_extra = !((eta >= 1.f) || (metallic > 0.f));
    const float sgn = dot3(dx, dy, dz, nx, ny, nz) > 0.f ? -1.f : 1.f;
    float d2[3], pdf2;
    hemi_cos(u3, u4, nx * sgn, ny * sgn, nz * sgn, d2[0], d2[1], d2[2], pdf2);
#pragma unroll
    for (int li = 0; li < kLights; ++li) {
      occluded[li] = false;
      delta_light(s_lights + 16 * li, hx, hy, hz, wi[li], lrad[li]);
    }
    const float nd[3] = {ndx, ndy, ndz};
    int slot_next, slot2;
    trace_queries<kLights>(planes, fp, hx, hy, hz, dep + 1 < depth, nd,
                           slot_next, do_extra, d2, slot2, wi, occluded);

    const float em2 =
        (slot2 >= 0 && do_extra) ? shade[(size_t)slot2 * kShadeRows + kRowEm]
                                 : 0.f;
    float dr = em2, dg = em2, db = em2;
#pragma unroll
    for (int li = 0; li < kLights; ++li) {
      dr = dr + (occluded[li] ? 0.f : br * lrad[li][0]);
      dg = dg + (occluded[li] ? 0.f : bg * lrad[li][1]);
      db = db + (occluded[li] ? 0.f : bb * lrad[li][2]);
    }
    rr = rr + tr * wr * dr;
    rg = rg + tg * wg * dg;
    rb = rb + tb * wb * db;
    if constexpr (kSaveHits) {
      float occ = 0.f;
#pragma unroll
      for (int li = 0; li < kLights; ++li)
        occ = occ + (occluded[li] ? (float)(1 << li) : 0.f);
      store_hit(hits, n, i, dep, (float)slot, tw, uw, vw,
                (do_extra && slot2 >= 0) ? (float)slot2 : -1.f, occ);
      rows_done = dep + 1;
    }
    tr = tr * wr;
    tg = tg * wg;
    tb = tb * wb;
    ox = hx;
    oy = hy;
    oz = hz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    slot = slot_next;
  }
  if constexpr (kSaveHits) {
    for (int dep = rows_done; dep < depth; ++dep)
      store_hit(hits, n, i, dep, -1.f, tpt::kRealMax, 0.f, 0.f, -1.f, 0.f);
  }
  const float res[9] = {rr, rg, rb, mr, mg, mb, dx, dy, dz};
#pragma unroll
  for (int k = 0; k < 16; ++k) out[(size_t)k * n + i] = k < 9 ? res[k] : 0.f;
}

constexpr int kThreads = 128;

template <int kLights, bool kSaveHits>
void launch(const float* rays8, const float* u8d, const float* planes,
            const float* shade, const float* lights, int n, int fp, int depth,
            float* out, float* hits, cudaStream_t stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  mega_kernel<kLights, kSaveHits><<<blocks, kThreads, 0, stream>>>(
      rays8, u8d, planes, shade, lights, n, fp, depth, out, hits);
}

template <int kLights, bool kSaveHits>
cudaError_t attributes(cudaFuncAttributes* attr) {
  return cudaFuncGetAttributes(attr, mega_kernel<kLights, kSaveHits>);
}

using Launch = void (*)(const float*, const float*, const float*,
                        const float*, const float*, int, int, int, float*,
                        float*, cudaStream_t);
using Attributes = cudaError_t (*)(cudaFuncAttributes*);
// [save_hits][n_lights]
constexpr Launch kLaunch[2][kMaxLights + 1] = {
    {launch<0, false>, launch<1, false>, launch<2, false>, launch<3, false>,
     launch<4, false>, launch<5, false>, launch<6, false>},
    {launch<0, true>, launch<1, true>, launch<2, true>, launch<3, true>,
     launch<4, true>, launch<5, true>, launch<6, true>}};
constexpr Attributes kAttributes[2][kMaxLights + 1] = {
    {attributes<0, false>, attributes<1, false>, attributes<2, false>,
     attributes<3, false>, attributes<4, false>, attributes<5, false>,
     attributes<6, false>},
    {attributes<0, true>, attributes<1, true>, attributes<2, true>,
     attributes<3, true>, attributes<4, true>, attributes<5, true>,
     attributes<6, true>}};

}  // namespace

// rays8 [8, N], u8d [8*depth, N], planes [Fp, 12] and shade [Fp, 32]
// (face-major, 16-byte aligned), lights [max(L,1), 16] with L <= 6;
// out [16, N]: radiance rgb, throughput at miss rgb, final direction, 0;
// hits: NULL, or [8*depth, N] for the per-bounce hit residuals (the
// kSaveHits instance). Returns cudaGetLastError() after the launch.
extern "C" int tpt_mega_trace(const float* rays8, const float* u8d,
                              const float* planes, const float* shade,
                              const float* lights, int n, int fp, int depth,
                              int n_lights, float* out, float* hits,
                              void* stream) {
  if (n_lights < 0 || n_lights > kMaxLights) return cudaErrorInvalidValue;
  kLaunch[hits != nullptr][n_lights](rays8, u8d, planes, shade, lights, n,
                                     fp, depth, out, hits,
                                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread and local (spill) bytes per thread of one instance.
extern "C" int tpt_mega_resources(int n_lights, int save_hits, int* regs,
                                  int* local_bytes) {
  if (n_lights < 0 || n_lights > kMaxLights) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = kAttributes[save_hits != 0][n_lights](&attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
