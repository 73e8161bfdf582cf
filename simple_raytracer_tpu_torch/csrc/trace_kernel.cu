// Whole-trace path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU megakernel simple_raytracer_tpu/ops/pallas/bounce_kernel.py
// :_trace_kernel with the gradient sky evaluated in the kernel: ray
// generation (inverting the ray-tile order), every bounce (nearest sphere,
// plane or triangle, emission, the BSDF sample) and the environment term, in
// one launch that writes 3 radiance floats per ray.  Triangles come in one of
// three compile-time variants of the same kernel (TriMode):
//   - kNoTris: a triangle-free scene;
//   - kSmallTris (bounce_kernel.py:_tris_small): at most 64 triangles, a
//     dense Moller-Trumbore loop over a table staged in shared memory;
//   - kClusteredTris (bounce_kernel.py:_tris_clustered): a BVH-clustered mesh
//     of at most 8192 slots; the cluster boxes sit in shared memory, the
//     front-to-back order of their groups of 8 comes by value in the launch
//     parameters, the slot table stays in global memory (read-only path),
//     and each ray slab-tests a group's 8 boxes against its own live best t
//     and runs MT over the K slots of each admitted cluster.
//
// Design: one thread per ray, because the per-ray bounce loop diverges; a
// 1-D grid of ceil(n_rays / 256) blocks, one launch for all rays.  The
// sphere, plane and material tables (a few hundred bytes) and the small
// triangle table or the cluster boxes are staged into shared memory once per
// block; above the default 48 KB the launch opts in to more, up to the
// device's limit (227 KB on an H100), which the wrapper checks first.  A ray that dies leaves its loop at once, which changes no result.
// The TPU gates a cluster for a whole 1536-ray block; here each ray gates
// alone, so its slab test carries a margin (kSlabMargin, see tris_clustered)
// that only adds MT work: it covers the slab test's own rounding and MT's
// acceptance of a ray that passes within the margin of a triangle's edge.
// A hit that MT finds farther outside the triangle than that (a ray almost
// parallel to its plane) can still be dropped where the dense plain version
// keeps it; chip_smoke.py phase 4 bounds the difference.
//
// Bound on the H100: per-ray FP32 arithmetic (every primitive tested per
// segment, every slot of an admitted cluster, the hash RNG, the BSDF); the
// only device-memory traffic it must make is the 12 bytes written per ray
// (the cluster table, 320 KB at most, stays in L2).  Left for later:
// divergence across the warp (rays that die early idle their lanes, and
// secondary rays admit different clusters) and register pressure.
//
// Arithmetic: built with --fmad=false and no fast math, and written in the
// operation order of the plain PyTorch version (ops/camera.py, ops/rng.py,
// ops/intersect.py, ops/bsdf.py, ops/sky.py, ops/trace.py), so each float
// operation rounds as the plain version's does.  The only fused
// multiply-adds are the reference log's (ops/rng.py:log), written out as
// __fmaf_rn.  min/max/clamp propagate NaN, as torch.minimum and torch.clamp
// do, and sign() returns its argument for +-0 and NaN, as jnp.sign does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the wrapper derives it from the parameter block (ops/cuda/trace_kernel.py:
// MAX_GROUPS) and passes it with -D
#ifndef SRT_MAX_GROUPS
#error "SRT_MAX_GROUPS must be defined"
#endif

struct TraceParams {
  float rot[9];           // camera rotation, row-major
  float cam_pos[3];
  float aspect_ratio;
  float fov_scale;
  float height;           // full image height: the NDC y divisor
  float horizon[3];
  float zenith[3];
  float ground[3];
  float sun_color[3];
  float sun_direction[3];
  float sun_focus;
  float sun_intensity;
  int32_t width;
  int32_t num_samples;
  int32_t num_bounces;
  int32_t n_rays;
  int32_t tile_h;         // 0: row-major ray order
  int32_t tile_w;
  int32_t row0;           // first image row of this band
  uint32_t time;
  int32_t n_spheres;      // table rows: spheres (n, 8), planes (n, 8),
  int32_t n_planes;       // materials (n, 16), as ops/cuda/trace_kernel.py
  int32_t n_materials;    // prim_tables packs them
  int32_t tri_mode;       // TriMode
  int32_t n_tris;         // kSmallTris: rows of the triangle table
  int32_t n_clusters;     // kClusteredTris: clusters (a multiple of 8)
  int32_t cluster_k;      // kClusteredTris: slots per cluster
  float cluster_extent;   // kClusteredTris: largest |coordinate| of a box
  // kClusteredTris: the groups of 8 clusters, front to back; as many as
  // the parameter block holds beside the rest
  uint16_t group_order[SRT_MAX_GROUPS];
};

// the launch's parameters: 6 pointers and TraceParams, within the 4 KB that
// a kernel takes on every architecture
static_assert(6 * sizeof(void*) + sizeof(TraceParams) <= 4096,
              "TraceParams overflows the kernel parameter block");

enum TriMode { kNoTris = 0, kSmallTris = 1, kClusteredTris = 2 };

namespace {

constexpr int kBlock = 256;
// a triangle row (ops/scene_types.py: TRI_COLS): v0 (0-2), e1 (3-5),
// e2 (6-8), n0 n1 n2 (9-17), material (18), active (19)
constexpr int kTriCols = 20;
// the slab test's margin, a share of the largest coordinate magnitude it
// meets: 2^-16 is 256 ulps, against the at most 6 ulps of rounding in
// t = (b - o) / d
constexpr float kSlabMargin = 0x1p-16f;

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

// ---- sky (ops/sky.py) -----------------------------------------------------

__device__ __forceinline__ float smoothstep_t(float t) {
  t = min_nan(max_nan(t, 0.0f), 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

__device__ __forceinline__ V3 sky_gradient(V3 d, const TraceParams& p) {
  // smoothstep(0, 0.4, y) and smoothstep(-0.01, 0, y)
  float t = powf(smoothstep_t((d.y - 0.0f) / 0.4f), 0.35f);
  V3 grad = mix(load3(p.horizon), load3(p.zenith), t);
  float g2s = smoothstep_t((d.y - (-0.01f)) / 0.01f);
  float sun_cos = max_nan(dot(d, neg(load3(p.sun_direction))), 0.0f);
  float sun_term = powf(sun_cos, p.sun_focus) * p.sun_intensity
                   * (g2s >= 1.0f ? 1.0f : 0.0f);
  return add(mix(load3(p.ground), grad, g2s),
             scale(load3(p.sun_color), sun_term));
}

// ---- triangles (ops/intersect.py: intersect_triangles) --------------------

// the best triangle so far: t, its table row, and MT's (u, v) there
struct TriHit {
  float t;
  int row;
  float u, v;
};

// a table load: through the read-only path from global memory, or shared
template <bool kGlobal>
__device__ __forceinline__ float ld(const float* q) {
  if constexpr (kGlobal) {
    return __ldg(q);
  } else {
    return *q;
  }
}

// Moller-Trumbore against table row q; a valid hit strictly nearer than
// best.t replaces it, so the first row of an exact tie stays
template <bool kGlobal>
__device__ __forceinline__ void mt_update(const float* q, int row, V3 o, V3 d,
                                          TriHit& best) {
  const float e1x = ld<kGlobal>(q + 3), e1y = ld<kGlobal>(q + 4),
              e1z = ld<kGlobal>(q + 5);
  const float e2x = ld<kGlobal>(q + 6), e2y = ld<kGlobal>(q + 7),
              e2z = ld<kGlobal>(q + 8);
  const float hx = d.y * e2z - d.z * e2y;
  const float hy = d.z * e2x - d.x * e2z;
  const float hz = d.x * e2y - d.y * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / a;
  const float sx = o.x - ld<kGlobal>(q + 0);
  const float sy = o.y - ld<kGlobal>(q + 1);
  const float sz = o.z - ld<kGlobal>(q + 2);
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (d.x * qx + d.y * qy + d.z * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  if (a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
      && t > 0.0f && ld<kGlobal>(q + 19) > 0.0f && t < best.t) {
    best.t = t;
    best.row = row;
    best.u = u;
    best.v = v;
  }
}

// The clustered mesh (bounce_kernel.py:_tris_clustered): groups of 8
// clusters in the wrapper's front-to-back order; a group's 8 boxes are
// slab-tested against the live best t (seeded with the nearest sphere or
// plane), then MT runs over every slot of each admitted cluster.  The first
// cluster visited wins an exact tie, the lowest slot within a cluster.
// Each box is grown by kSlabMargin times the larger of the ray origin's and
// the boxes' largest coordinate magnitude: in t that is `pad` times the
// largest |1 / d|, which widens each axis's slab at least as much.  A zero
// direction component makes pad infinite and admits every real box.
__device__ __forceinline__ void tris_clustered(
    const float* __restrict__ table, const float* s_box, const TraceParams& p,
    V3 o, V3 d, TriHit& best) {
  const float inx = 1.0f / d.x;
  const float iny = 1.0f / d.y;
  const float inz = 1.0f / d.z;
  const float mag = fmaxf(fmaxf(fabsf(o.x), fabsf(o.y)),
                          fmaxf(fabsf(o.z), p.cluster_extent));
  const float pad = kSlabMargin * mag
                    * fmaxf(fmaxf(fabsf(inx), fabsf(iny)), fabsf(inz));
  const int n_groups = p.n_clusters / 8;
  for (int gi = 0; gi < n_groups; ++gi) {
    const int g = p.group_order[gi];
    unsigned word = 0;
    for (int k = 0; k < 8; ++k) {
      const float* b = s_box + 8 * (g * 8 + k);
      const float t1x = (b[0] - o.x) * inx;
      const float t2x = (b[3] - o.x) * inx;
      const float t1y = (b[1] - o.y) * iny;
      const float t2y = (b[4] - o.y) * iny;
      const float t1z = (b[2] - o.z) * inz;
      const float t2z = (b[5] - o.z) * inz;
      const float near = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                                 max_nan(min_nan(t1z, t2z), 0.0f));
      const float far = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                                min_nan(max_nan(t1z, t2z), best.t));
      // NaN (0 * inf on a box plane) keeps the cluster; padding clusters
      // (every plane at 3e38) fall to the b[0] >= 1e38 term
      if (!((near - pad > far + pad) || (b[0] >= 1.0e38f))) word |= 1u << k;
    }
    while (word) {
      const int c = g * 8 + __ffs(word) - 1;
      word &= word - 1;
      const int row0 = c * p.cluster_k;
      for (int s = 0; s < p.cluster_k; ++s)
        mt_update<true>(table + kTriCols * (row0 + s), row0 + s, o, d, best);
    }
  }
}

template <int TRI>
__global__ void __launch_bounds__(kBlock)
trace_kernel(const float* __restrict__ sph, const float* __restrict__ pln,
             const float* __restrict__ mat, const float* __restrict__ tri,
             const float* __restrict__ box, float* __restrict__ out,
             const TraceParams p) {
  extern __shared__ float smem[];
  float* s_sph = smem;
  float* s_pln = s_sph + 8 * p.n_spheres;
  float* s_mat = s_pln + 8 * p.n_planes;
  float* s_tri = s_mat + 16 * p.n_materials;   // kSmallTris
  float* s_box = s_tri;                        // kClusteredTris
  for (int k = threadIdx.x; k < 8 * p.n_spheres; k += blockDim.x)
    s_sph[k] = sph[k];
  for (int k = threadIdx.x; k < 8 * p.n_planes; k += blockDim.x)
    s_pln[k] = pln[k];
  for (int k = threadIdx.x; k < 16 * p.n_materials; k += blockDim.x)
    s_mat[k] = mat[k];
  if (TRI == kSmallTris) {
    for (int k = threadIdx.x; k < kTriCols * p.n_tris; k += blockDim.x)
      s_tri[k] = tri[k];
  }
  if (TRI == kClusteredTris) {
    for (int k = threadIdx.x; k < 8 * p.n_clusters; k += blockDim.x)
      s_box[k] = box[k];
  }
  __syncthreads();

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= p.n_rays) return;

  // ---- ray generation (ops/camera.py: generate_rays) ----
  const int s = g % p.num_samples;
  const int pix = g / p.num_samples;
  int px, py;
  if (p.tile_h > 0) {
    // invert tiled_pixel_order's (band/th, W/tw, th, tw) enumeration
    const int th = p.tile_h, tw = p.tile_w, cc = p.width / tw;
    px = ((pix / (tw * th)) % cc) * tw + pix % tw;
    py = (pix / (tw * th * cc)) * th + (pix / tw) % th;
  } else {
    px = pix % p.width;
    py = pix / p.width;
  }
  const uint32_t pixel_id = (uint32_t)(py * p.width + px)
                            + (uint32_t)p.row0 * (uint32_t)p.width;
  uint32_t seed = ((uint32_t)s + pixel_id * (uint32_t)p.num_samples)
                  * p.time * 5304u;
  const float u1 = next_uniform(seed);
  const float u2 = next_uniform(seed);
  const float ndc_x = ((float)px + u1) / (float)p.width;
  const float ndc_y = ((float)(py + p.row0) + u2) / p.height;
  const float sx = (2.0f * ndc_x - 1.0f) * p.aspect_ratio * p.fov_scale;
  const float sy = (1.0f - 2.0f * ndc_y) * p.fov_scale;
  V3 d = normalize(mk(p.rot[0] * sx + p.rot[1] * sy + p.rot[2] * -1.0f,
                      p.rot[3] * sx + p.rot[4] * sy + p.rot[5] * -1.0f,
                      p.rot[6] * sx + p.rot[7] * sy + p.rot[8] * -1.0f));
  V3 o = load3(p.cam_pos);

  // ---- the bounce loop (ops/trace.py: trace_rays) ----
  V3 color = mk(0.0f, 0.0f, 0.0f);
  V3 mask = mk(1.0f, 1.0f, 1.0f);
  V3 sky_mask = mk(0.0f, 0.0f, 0.0f);
  V3 sky_dir = mk(0.0f, 0.0f, 1.0f);
  for (int bounce = 0; bounce < p.num_bounces; ++bounce) {
    // nearest sphere, first minimum (ops/intersect.py: intersect_spheres)
    float t_s = INFINITY;
    int i_s = 0;
    for (int j = 0; j < p.n_spheres; ++j) {
      const float* q = s_sph + 8 * j;
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
    // nearest plane (intersect_planes)
    float t_p = INFINITY;
    int i_p = 0;
    for (int j = 0; j < p.n_planes; ++j) {
      const float* q = s_pln + 8 * j;
      V3 n = mk(q[3], q[4], q[5]);
      float denom = dot(n, d);
      float t = dot(n, mk(q[0] - o.x, q[1] - o.y, q[2] - o.z)) / denom;
      if (denom != 0.0f && t >= 0.0f && q[7] > 0.0f && t < t_p) {
        t_p = t;
        i_p = j;
      }
    }
    // nearest triangle (+inf when none beats the sphere/plane seed)
    TriHit th;
    th.t = INFINITY;
    th.row = -1;
    th.u = th.v = 0.0f;
    float t_t = INFINITY;
    if (TRI == kSmallTris) {
      for (int j = 0; j < p.n_tris; ++j)
        mt_update<false>(s_tri + kTriCols * j, j, o, d, th);
      t_t = th.t;
    }
    if (TRI == kClusteredTris) {
      th.t = min_nan(t_s, t_p);
      tris_clustered(tri, s_box, p, o, d, th);
      if (th.row >= 0) t_t = th.t;
    }
    const float t = min_nan(min_nan(t_s, t_p), t_t);  // never NaN
    if (t == INFINITY) {
      // a miss: the sky is evaluated once after the loop, and the ray dies
      sky_mask = mask;
      sky_dir = d;
      break;
    }
    // closest_hit: ties go to the sphere, then the plane
    const V3 pos = add(o, scale(d, t));
    V3 normal;
    int m;
    if (t_s == t) {
      const float* q = s_sph + 8 * i_s;
      normal = mk((pos.x - q[0]) / q[3], (pos.y - q[1]) / q[3],
                  (pos.z - q[2]) / q[3]);
      m = (int)q[4];
    } else if (TRI == kNoTris || t_p == t) {
      const float* q = s_pln + 8 * i_p;
      normal = mk(q[3], q[4], q[5]);
      m = (int)q[6];
    } else {
      // the smooth normal from MT's own (u, v) (ops/intersect.py:
      // triangle_normal), then normalized
      const float* q = (TRI == kSmallTris ? s_tri : tri) + kTriCols * th.row;
      const float w0 = 1.0f - th.u - th.v;
      normal = normalize(add(add(scale(load3(q + 9), w0),
                                 scale(load3(q + 12), th.u)),
                             scale(load3(q + 15), th.v)));
      m = (int)q[18];
    }
    const bool front = dot(normal, d) < 0.0f;
    normal = scale(normal, front ? 1.0f : -1.0f);

    const float* mt = s_mat + 16 * m;
    const V3 mat_color = load3(mt + 6);
    color = add(color, scale(mul(mask, load3(mt + 9)), mt[3]));
    if (bounce == p.num_bounces - 1) break;  // emission only, no new ray

    // ---- the BSDF sample (ops/bsdf.py: sample_material) ----
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
    new_dir = normalize(new_dir);
    o = add(pos, scale(normal, sign_of(dot(normal, new_dir)) * 0.001f));
    d = new_dir;
    mask = mul(mask, mask_mul);
  }

  color = add(color, mul(sky_mask, sky_gradient(sky_dir, p)));
  out[g] = color.x;
  out[p.n_rays + g] = color.y;
  out[2 * p.n_rays + g] = color.z;
}

// launch one variant, opting in to more than the default dynamic shared
// memory when its tables need it
template <int TRI>
cudaError_t launch_variant(int blocks, size_t bytes, cudaStream_t st,
                           const float* sph, const float* pln,
                           const float* mat, const float* tri,
                           const float* box, float* out,
                           const TraceParams& p) {
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_kernel<TRI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
  }
  trace_kernel<TRI><<<blocks, kBlock, bytes, st>>>(sph, pln, mat, tri, box,
                                                    out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int srt_trace_launch(const float* sph, const float* pln,
                                const float* mat, const float* tri,
                                const float* box, float* out, TraceParams p,
                                void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  const int blocks = (p.n_rays + kBlock - 1) / kBlock;
  size_t words = 8 * (size_t)p.n_spheres + 8 * (size_t)p.n_planes
                 + 16 * (size_t)p.n_materials;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.tri_mode) {
    case kNoTris:
      return (int)launch_variant<kNoTris>(blocks, sizeof(float) * words, st,
                                          sph, pln, mat, tri, box, out, p);
    case kSmallTris:
      words += kTriCols * (size_t)p.n_tris;
      return (int)launch_variant<kSmallTris>(blocks, sizeof(float) * words,
                                             st, sph, pln, mat, tri, box, out,
                                             p);
    case kClusteredTris:
      if (p.n_clusters > 8 * SRT_MAX_GROUPS)
        return (int)cudaErrorInvalidValue;
      words += 8 * (size_t)p.n_clusters;
      return (int)launch_variant<kClusteredTris>(
          blocks, sizeof(float) * words, st, sph, pln, mat, tri, box, out, p);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory a block of the device may opt in to
extern "C" int srt_shared_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
