// Device code shared by the whole-trace kernel (trace_kernel.cu) and the
// per-bounce shade kernel (bounce_kernel.cu), so that the two cannot drift:
// 3-vectors, the hash RNG with the reference's log and cos, the nearest
// sphere and plane, and the BSDF sample.  Each function repeats the float
// operations of the plain PyTorch version in its order (ops/vec.py,
// ops/rng.py, ops/intersect.py, ops/bsdf.py); both kernels build with
// --fmad=false and no fast math.  Shading a triangle is not here: the
// whole-trace kernel interpolates at MT's (u, v), the per-bounce kernel at
// the barycentric weights of the hit position, as their plain versions do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// cos(2 pi y) polynomial in y^2 (ops/rng.py: COS2PI_C)
constexpr float kCos0 = -0x1.b6e25p+0f;
constexpr float kCos1 = 0x1.f9d38ap+2f;
constexpr float kCos2 = -0x1.a6d1f2p+4f;
constexpr float kCos3 = 0x1.e1f506p+5f;
constexpr float kCos4 = -0x1.55d3c8p+6f;
constexpr float kCos5 = 0x1.03c1fp+6f;
constexpr float kCos6 = -0x1.3bd3ccp+4f;
constexpr float kCos7 = 0x1p+0f;

// the reference's f32 log (ops/rng.py: LOG_*)
constexpr float kLogMinNormal = 0x1p-126f;
constexpr float kLogSqrtHf = 0x1.6a09e6p-1f;
constexpr float kLogP0 = 0x1.204376p-4f;
constexpr float kLogP1 = -0x1.d7a370p-4f;
constexpr float kLogP2 = 0x1.de4a34p-4f;
constexpr float kLogP3 = -0x1.fcba9ep-4f;
constexpr float kLogP4 = 0x1.23d37ep-3f;
constexpr float kLogP5 = -0x1.555ca0p-3f;
constexpr float kLogP6 = 0x1.999d58p-3f;
constexpr float kLogP7 = -0x1.fffff8p-3f;
constexpr float kLogP8 = 0x1.555554p-2f;
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.630000p-1f;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 v;
  v.x = x;
  v.y = y;
  v.z = z;
  return v;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return mk(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V3 neg(V3 a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, 1.0f / sqrtf(dot(v, v)));
}
__device__ __forceinline__ V3 reflect(V3 v, V3 n) {
  return sub(v, scale(n, 2.0f * dot(v, n)));
}
__device__ __forceinline__ V3 mix(V3 a, V3 b, float t) {
  return add(a, scale(sub(b, a), t));
}
__device__ __forceinline__ V3 load3(const float* p) {
  return mk(p[0], p[1], p[2]);
}

__device__ __forceinline__ bool is_nan(float a) { return a != a; }
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? a : b));
}
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

// ---- the hash RNG (ops/rng.py) -------------------------------------------

__device__ __forceinline__ float u32_to_f32(uint32_t x) {
  float hi = (float)(int32_t)(x >> 16);
  float lo = (float)(int32_t)(x & 0xFFFFu);
  return hi * 65536.0f + lo;
}

__device__ __forceinline__ float next_uniform(uint32_t& seed) {
  seed = seed * 747796405u + 2891336453u;
  uint32_t shift = (seed >> 28) + 4u;
  uint32_t r = ((seed >> shift) ^ seed) * 277803737u;
  r = (r >> 22) ^ r;
  return u32_to_f32(r) * 0x1p-32f;
}

__device__ __forceinline__ float cos_2pi(float u) {
  float w = u - rintf(u);
  float a = fabsf(w);
  bool flip = a > 0.25f;
  float y = flip ? 0.5f - a : a;
  float y2 = y * y;
  float p = kCos0;
  p = p * y2 + kCos1;
  p = p * y2 + kCos2;
  p = p * y2 + kCos3;
  p = p * y2 + kCos4;
  p = p * y2 + kCos5;
  p = p * y2 + kCos6;
  p = p * y2 + kCos7;
  return flip ? -p : p;
}

__device__ __forceinline__ float log_ref(float x) {
  float xc = x > kLogMinNormal ? x : kLogMinNormal;
  int32_t bits = __float_as_int(xc);
  float e = (float)((bits >> 23) - 127);
  e = 1.0f + e;
  float m = __int_as_float((bits & (int32_t)0x807FFFFF) | 0x3F000000);
  bool low = m < kLogSqrtHf;
  e = e - (low ? 1.0f : 0.0f);
  float r = (m - 1.0f) + (low ? m : 0.0f);
  float r2 = r * r;
  float r3 = r2 * r;
  float y = __fmaf_rn(r, kLogP0, kLogP1);
  float y1 = __fmaf_rn(r, kLogP3, kLogP4);
  float y2 = __fmaf_rn(r, kLogP6, kLogP7);
  y = __fmaf_rn(r, y, kLogP2);
  y1 = __fmaf_rn(r, y1, kLogP5);
  y2 = __fmaf_rn(r, y2, kLogP8);
  y = __fmaf_rn(r3, y, y1);
  y = __fmaf_rn(r3, y, y2);
  y = __fmaf_rn(r3, y, kLogQ1 * e);
  float out = __fmaf_rn(-0.5f, r2, r) + y;
  out = __fmaf_rn(kLogQ2, e, out);
  if (x >= 0.0f && x < kLogMinNormal) out = -INFINITY;
  if (x == INFINITY) out = INFINITY;
  if (x < 0.0f || is_nan(x)) out = NAN;
  return out;
}

// Box-Muller; u2 == 0 gives an infinite sample, as in the reference
__device__ __forceinline__ float next_normal(uint32_t& seed) {
  float u1 = next_uniform(seed);
  float u2 = next_uniform(seed);
  float rho = sqrtf(-2.0f * log_ref(u2));
  return rho * cos_2pi(u1);
}

__device__ __forceinline__ V3 next_direction_hemisphere(V3 normal,
                                                        uint32_t& seed) {
  float nx = next_normal(seed);
  float ny = next_normal(seed);
  float nz = next_normal(seed);
  V3 d = normalize(mk(nx, ny, nz));
  return scale(d, sign_of(dot(normal, d)));
}

// ---- BSDF (ops/bsdf.py) ---------------------------------------------------

__device__ __forceinline__ float shlick_reflectance(float mu, float cos_theta) {
  float r0 = (1.0f - mu) / (1.0f + mu);
  r0 = r0 * r0;
  float m = 1.0f - cos_theta;
  float m2 = m * m;
  return r0 + (1.0f - r0) * (m2 * m2 * m);
}

// ---- spheres and planes (ops/intersect.py) -------------------------------

// the nearest sphere of an (n, 8) table [center, radius, material, active,
// 0, 0], the first of an exact tie (intersect_spheres); t_s = +inf and
// i_s = 0 when none is hit
__device__ __forceinline__ void nearest_sphere(const float* sph, int n, V3 o,
                                               V3 d, float& t_s, int& i_s) {
  t_s = INFINITY;
  i_s = 0;
  for (int j = 0; j < n; ++j) {
    const float* q = sph + 8 * j;
    V3 rc = mk(q[0] - o.x, q[1] - o.y, q[2] - o.z);
    float b = dot(rc, d);
    float c = dot(rc, rc) - q[3] * q[3];
    float disc = b * b - c;
    float sq = sqrtf(max_nan(disc, 0.0f));
    float t0 = b - sq;
    float t1 = b + sq;
    float t = t0 < 0.0f ? t1 : t0;
    if (disc >= 0.0f && t >= 0.0f && q[5] > 0.0f && t < t_s) {
      t_s = t;
      i_s = j;
    }
  }
}

// the nearest plane of an (n, 8) table [position, normal, material,
// active] (intersect_planes)
__device__ __forceinline__ void nearest_plane(const float* pln, int n, V3 o,
                                              V3 d, float& t_p, int& i_p) {
  t_p = INFINITY;
  i_p = 0;
  for (int j = 0; j < n; ++j) {
    const float* q = pln + 8 * j;
    V3 nv = mk(q[3], q[4], q[5]);
    float denom = dot(nv, d);
    float t = dot(nv, mk(q[0] - o.x, q[1] - o.y, q[2] - o.z)) / denom;
    if (denom != 0.0f && t >= 0.0f && q[7] > 0.0f && t < t_p) {
      t_p = t;
      i_p = j;
    }
  }
}

// a sphere's normal at a point of it: (pos - center) / radius
__device__ __forceinline__ V3 sphere_normal(const float* q, V3 pos) {
  return mk((pos.x - q[0]) / q[3], (pos.y - q[1]) / q[3],
            (pos.z - q[2]) / q[3]);
}

// ---- the BSDF sample (ops/bsdf.py: sample_material) ----------------------

struct Scatter {
  V3 dir;       // the new unit direction
  V3 mask_mul;  // the factor on the path throughput
};

// one stochastic material interaction; ``normal`` faces the ray, ``front``
// is the side hit, ``mt`` the material's 16-float row [smoothness,
// metallic, specular, emission_strength, transmittance, ior, color,
// emission, 0 x4]; advances ``seed``
__device__ __forceinline__ Scatter sample_bsdf(V3 normal, bool front, V3 d,
                                               const float* mt,
                                               uint32_t& seed) {
  const V3 mat_color = load3(mt + 6);
  const V3 hemi = next_direction_hemisphere(normal, seed);
  const V3 random_dir = normalize(add(normal, hemi));
  const V3 reflected_dir = reflect(d, normal);
  const float u_metal = next_uniform(seed);
  const float u_spec = next_uniform(seed);
  const bool is_metallic = mt[1] > u_metal;
  const bool is_specular = mt[2] > u_spec;
  const V3 rough_dir = mix(random_dir, reflected_dir, mt[0]);
  const float u_trans = next_uniform(seed);
  const bool is_transparent = mt[4] > u_trans;
  V3 new_dir, mask_mul;
  if (!is_transparent) {
    new_dir = mix(random_dir, rough_dir,
                  (is_metallic || is_specular) ? 1.0f : 0.0f);
    mask_mul = mix(mat_color, mk(1.0f, 1.0f, 1.0f),
                   is_specular ? 1.0f : 0.0f);
  } else {
    const V3 refl_smooth = reflect(rough_dir, normal);
    const float mu = front ? 1.0f / mt[5] : mt[5];
    const float cos_theta = min_nan(dot(refl_smooth, neg(normal)), 1.0f);
    const float sin_theta = sqrtf(1.0f - cos_theta * cos_theta);
    const bool tir = mu * sin_theta > 1.0f;
    // the Schlick uniform is consumed only without total reflection
    uint32_t seed_schlick = seed;
    const float u_schlick = next_uniform(seed_schlick);
    if (!tir) seed = seed_schlick;
    if (tir || shlick_reflectance(mu, cos_theta) > u_schlick) {
      new_dir = rough_dir;
      mask_mul = mk(1.0f, 1.0f, 1.0f);
    } else {
      const V3 out_perp = scale(add(refl_smooth, scale(normal, cos_theta)),
                                mu);
      const V3 out_parallel = scale(
          normal, -sqrtf(fabsf(1.0f - dot(out_perp, out_perp))));
      new_dir = add(out_perp, out_parallel);
      mask_mul = mat_color;
    }
  }
  Scatter out;
  out.dir = normalize(new_dir);
  out.mask_mul = mask_mul;
  return out;
}

// the scattered ray's origin: off the surface, to the new direction's side
__device__ __forceinline__ V3 scatter_origin(V3 pos, V3 normal, V3 dir) {
  return add(pos, scale(normal, sign_of(dot(normal, dir)) * 0.001f));
}

}  // namespace
