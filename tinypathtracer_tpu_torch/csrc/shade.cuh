// Reference-mode shading shared by the port's kernels: kernel B (mega.cu)
// and the modular bounce's kernels (shade.cu).
//
// Each function transcribes the plain PyTorch code of ops/shading_c.py and
// ops/lights.py in the same order, with the same association: the files are
// compiled with --fmad=false and IEEE division and square root, so every
// expression rounds as the eager torch operation it mirrors does on the
// card. sinf, cosf, atan2f and acosf are the CUDA math library's, which
// torch's elementwise kernels call too.
#pragma once

#include <cuda_runtime.h>

namespace tpt {

constexpr int kMaxLights = 6;  // rows of the [L, 16] lights table
constexpr float kPi = 3.14159265358979f;
// 1 / pi and 1 / (2 pi) rounded to float32 (ops/shading_c.py INV_PI,
// INV_2PI): the JAX package's `x / pi` is `x * (1 / pi)` once XLA has
// compiled it
constexpr float kInvPi = 0x1.45f306p-2f;
constexpr float kInv2Pi = 0x1.45f306p-3f;

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

// The equirect texel of a direction in an h x w environment
// (ops/shading_c.py env_texel_c): +Y up, u = atan2(z, x) / 2pi wrapped to
// [0, 1), v = 1 - acos(y) / pi; the flat index row * w + col. A float
// converts to int as torch's `.to(torch.int32)` does on the card
// (truncating, saturating, NaN to 0).
__device__ __forceinline__ int env_texel(int h, int w, float dx, float dy,
                                         float dz) {
  float u = atan2f(dz, dx) * kInv2Pi;
  u = u < 0.f ? u + 1.f : u;
  const float v = 1.f - acosf(nan_min(nan_max(dy, -1.f), 1.f)) * kInvPi;
  const int col = min(max(static_cast<int>(u * static_cast<float>(w)), 0),
                      w - 1);
  const int row = min(
      max(static_cast<int>((1.f - v) * static_cast<float>(h)), 0), h - 1);
  return row * w + col;
}

}  // namespace tpt
