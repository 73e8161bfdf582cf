// Whole-trace path-tracing kernel for Hopper (sm_90a).
//
// Replaces the TPU megakernel simple_raytracer_tpu/ops/pallas/bounce_kernel.py
// :_trace_kernel in both its output forms: ray generation (inverting the
// ray-tile order) and every bounce (nearest sphere, plane or triangle,
// emission, the BSDF sample) in one launch, which then either
//   - evaluates the gradient sky on each ray's miss (fold_sky=True) and
//     writes 3 radiance floats per ray, or
//   - for a scene with a texture skybox (fold_sky=False, bounce_kernel.py
//     :811-836) writes 9 rows per ray: the emission gathered, and the
//     throughput and direction at the miss; the wrapper then samples the
//     texture once on them in PyTorch (ops/sky.py: sky_color) and adds
//     sky_mask * sky, as bounce_kernel.py:981-988 does.  The kernel never
//     samples the texture: a texture fetch's hardware filter has 8-bit
//     fixed-point weights, which cannot match the f32 taps.
// Triangles come in one of three compile-time variants of the same kernel
// (TriMode):
//   - kNoTris: a triangle-free scene;
//   - kSmallTris (bounce_kernel.py:_tris_small): at most 64 triangles, a
//     dense Moller-Trumbore loop over a table staged in shared memory;
//   - kClusteredTris (bounce_kernel.py:_tris_clustered): a BVH-clustered mesh
//     of at most 8192 slots, or under tri_backend="fused" at most 853
//     clusters of at most 128 slots (config 6's 98,304: the TPU's packed
//     form of the table, bounce_kernel.py:376, which the card needs no
//     layout for); the cluster boxes sit in shared memory (24.6 KB at 768
//     clusters), the front-to-back order of their groups of 8 comes by value
//     in the launch parameters, the slot table stays in global memory
//     (read-only path), and each ray slab-tests a group's 8 boxes against
//     its own live best t and runs MT over the K slots of each admitted
//     cluster.
//
// Design: one thread per ray, because the per-ray bounce loop diverges; a
// 1-D grid of ceil(n_rays / 256) blocks, one launch for all rays.  The
// sphere, plane and material tables (a few hundred bytes) and the small
// triangle table or the cluster boxes are staged into shared memory once per
// block; above the default 48 KB the launch opts in to more, up to the
// device's limit (227 KB on an H100), which the wrapper checks first.  A ray
// that dies leaves its loop at once, which changes no result.  The RNG, the
// sphere and plane loops and the BSDF sample are path_common.cuh's, which
// the per-bounce shade kernel (bounce_kernel.cu) shares.
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
// only device-memory traffic it must make is the 12 bytes written per ray,
// 36 in the nine-row form (the cluster table, 7.9 MB at most, stays in L2).  Left for later:
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

#include "path_common.cuh"

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
  int32_t sky_rows;       // 1: write the 9 rows, no sky (a texture skybox)
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
    // the nearest sphere and plane (path_common.cuh)
    float t_s, t_p;
    int i_s, i_p;
    nearest_sphere(s_sph, p.n_spheres, o, d, t_s, i_s);
    nearest_plane(s_pln, p.n_planes, o, d, t_p, i_p);
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
      normal = sphere_normal(q, pos);
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
    color = add(color, scale(mul(mask, load3(mt + 9)), mt[3]));
    if (bounce == p.num_bounces - 1) break;  // emission only, no new ray

    // ---- the BSDF sample (path_common.cuh: sample_bsdf) ----
    const Scatter sc = sample_bsdf(normal, front, d, mt, seed);
    o = scatter_origin(pos, normal, sc.dir);
    d = sc.dir;
    mask = mul(mask, sc.mask_mul);
  }

  const size_t n = (size_t)p.n_rays;
  if (p.sky_rows) {
    // color, sky_mask, sky_dir: the sky is the wrapper's
    const float rows[9] = {color.x, color.y, color.z, sky_mask.x,
                           sky_mask.y, sky_mask.z, sky_dir.x, sky_dir.y,
                           sky_dir.z};
    for (int k = 0; k < 9; ++k) out[k * n + g] = rows[k];
    return;
  }
  color = add(color, mul(sky_mask, sky_gradient(sky_dir, p)));
  out[g] = color.x;
  out[n + g] = color.y;
  out[2 * n + g] = color.z;
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
