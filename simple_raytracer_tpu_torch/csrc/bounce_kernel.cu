// Per-bounce shade kernel for Hopper (sm_90a): one bounce of the fused
// per-bounce path (ops/trace.py: trace_rays_fused) over the ray state.
//
// Replaces simple_raytracer_tpu/ops/pallas/bounce_kernel.py:584
// _bounce_kernel (through bounce_step :991): the bounce body _bounce_body
// (:500) over the (20, Rp) f32 state, with the nearest triangle coming from
// the BVH kernel (csrc/bvh_kernel.cu) as its winner's (t, table slot).
// State rows (rays on columns):
//    0-2  origin              8-10  path throughput (mask)
//    3-5  direction          11-13  accumulated color
//    6    RNG seed (uint32   14-16  deferred-sky throughput
//         bits in an f32)    17-19  deferred-sky direction
//    7    alive (0 or 1)
// For each live ray: the nearest sphere and plane (path_common.cuh), the
// nearest hit across the three (ties to the sphere, then the plane), the
// normal (a triangle's from its table row, interpolated at the barycentric
// weights of the hit position, as _bounce_kernel's tri_normal :619-640 and
// the split path's ops/intersect.shade_from_position do, not at MT's
// (u, v) as the whole-trace kernel does), emission, and, except on the last
// bounce, the BSDF sample (path_common.cuh: sample_bsdf).  A miss records
// the throughput and direction for the sky, which trace_rays_fused
// evaluates once after the last bounce, and the ray dies.  The kernel
// writes the next state into a second buffer; a dead ray's 20 rows pass
// through as raw bits (the TPU skips whole dead blocks; within a block its
// masked updates leave a dead ray's rows as they were, too).
//
// Design: one thread per ray, a 1-D grid over the Rp columns.  The state is
// read and written once, coalesced row by row; the winner's table row (80
// bytes) is gathered only for a ray whose nearest hit is a triangle, and no
// (20, Rp) attribute intermediate is built (the TPU's BVH kernel writes one
// for its bounce kernel to read).  The seed row moves only as uint32 bits:
// it is read and written through integer pointers and never passes through
// a float operation, which could change a NaN pattern.  The sphere, plane
// and material tables are read from global memory (a few hundred bytes,
// held in L1).
//
// Bound on the H100 (chip_smoke.py): the bytes it must move, 20 rows in, 20
// out and the winner's (t, slot), 168 bytes per ray; the arithmetic of a
// live ray (a few hundred float operations) is below that at the card's
// FP32 rate.
//
// Arithmetic: built with --fmad=false and no fast math, in the operation
// order of the plain version (ops/bounce.py: bounce_step_plain, which
// follows the split path's ops/intersect.py and ops/bsdf.py), so it gives
// the plain version's bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "path_common.cuh"

struct BounceParams {
  int32_t n_rays;       // Rp: the state's columns
  int32_t n_spheres;    // table rows: spheres (n, 8), planes (n, 8),
  int32_t n_planes;     // materials (n, 16), as ops/scene_types.py prim_tables
  int32_t n_materials;  // packs them
  int32_t has_tris;     // the BVH winner (tri_t, tri_slot) and the table
  int32_t is_last;      // the final bounce: emission only, no new ray
};

namespace {

constexpr int kBlock = 256;
constexpr int kStRows = 20;
// a triangle row (ops/scene_types.py: TRI_COLS): v0 (0-2), e1 (3-5),
// e2 (6-8), n0 n1 n2 (9-17), material (18), active (19)
constexpr int kTriCols = 20;

__global__ void __launch_bounds__(kBlock)
bounce_kernel(const float* __restrict__ state, float* __restrict__ out,
              const float* __restrict__ tri_t,
              const int32_t* __restrict__ tri_slot,
              const float* __restrict__ table, const float* __restrict__ sph,
              const float* __restrict__ pln, const float* __restrict__ mat,
              const BounceParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  const size_t n = (size_t)p.n_rays;
  const uint32_t* bits_in = reinterpret_cast<const uint32_t*>(state);
  uint32_t* bits_out = reinterpret_cast<uint32_t*>(out);
  // row k of ray i, as a float or as its bits
  auto at = [&](int k) { return state[k * n + i]; };
  auto copy = [&](int k, int from) {
    bits_out[k * n + i] = bits_in[from * n + i];
  };
  auto put = [&](int k, float v) { out[k * n + i] = v; };
  auto put3 = [&](int k, V3 v) {
    put(k, v.x);
    put(k + 1, v.y);
    put(k + 2, v.z);
  };

  if (!(at(7) > 0.0f)) {
    for (int k = 0; k < kStRows; ++k) copy(k, k);
    return;
  }
  const V3 o = mk(at(0), at(1), at(2));
  const V3 d = mk(at(3), at(4), at(5));
  const V3 mask = mk(at(8), at(9), at(10));

  // the nearest hit across spheres, planes and the BVH winner
  // (ops/intersect.py: _resolve)
  float t_s, t_p;
  int i_s, i_p;
  nearest_sphere(sph, p.n_spheres, o, d, t_s, i_s);
  nearest_plane(pln, p.n_planes, o, d, t_p, i_p);
  const float t_t = p.has_tris ? tri_t[i] : INFINITY;
  const float t = min_nan(min_nan(t_s, t_p), t_t);
  if (!(fabsf(t) < INFINITY)) {   // torch.isfinite: NaN is no hit
    // a miss: the sky term waits for the end of the trace, the ray dies
    for (int k = 0; k < 7; ++k) copy(k, k);
    put(7, 0.0f);
    for (int k = 8; k < 14; ++k) copy(k, k);
    for (int k = 0; k < 3; ++k) {
      copy(14 + k, 8 + k);   // sky_mask = mask
      copy(17 + k, 3 + k);   // sky_dir = d
    }
    return;
  }
  const bool is_s = t_s == t;
  const bool is_p = !is_s && t_p == t;
  const V3 pos = add(o, scale(d, t));
  V3 normal;
  int m;
  if (is_s) {
    const float* q = sph + 8 * i_s;
    normal = sphere_normal(q, pos);
    m = (int)q[4];
  } else if (is_p) {
    const float* q = pln + 8 * i_p;
    normal = mk(q[3], q[4], q[5]);
    m = (int)q[6];
  } else {
    // the winner's row; its smooth normal at the barycentric weights of
    // the hit position (ops/intersect.py: barycentric_weights_from_edges)
    const float* q = table + (size_t)kTriCols * tri_slot[i];
    const V3 ea = load3(q + 3);
    const V3 eb = load3(q + 6);
    const V3 c = sub(pos, load3(q));
    const float d00 = dot(ea, ea);
    const float d01 = dot(ea, eb);
    const float d11 = dot(eb, eb);
    const float d20 = dot(c, ea);
    const float d21 = dot(c, eb);
    const float denom = d00 * d11 - d01 * d01;
    const float w0 = (d11 * d20 - d01 * d21) / denom;
    const float w1 = (d00 * d21 - d01 * d20) / denom;
    const float w2 = 1.0f - w0 - w1;
    normal = normalize(add(add(scale(load3(q + 9), w2),
                               scale(load3(q + 12), w0)),
                           scale(load3(q + 15), w1)));
    m = (int)q[18];
  }
  const bool front = dot(normal, d) < 0.0f;
  normal = scale(normal, front ? 1.0f : -1.0f);

  const float* mt = mat + 16 * m;
  const V3 color = add(mk(at(11), at(12), at(13)),
                       scale(mul(mask, load3(mt + 9)), mt[3]));
  put3(11, color);
  for (int k = 14; k < 20; ++k) copy(k, k);   // the sky rows stay
  if (p.is_last) {
    // emission only, no new ray (render.cl:415-416)
    for (int k = 0; k < 7; ++k) copy(k, k);
    put(7, 0.0f);
    for (int k = 8; k < 11; ++k) copy(k, k);
    return;
  }
  uint32_t seed = bits_in[6 * n + i];
  const Scatter sc = sample_bsdf(normal, front, d, mt, seed);
  put3(0, scatter_origin(pos, normal, sc.dir));
  put3(3, sc.dir);
  bits_out[6 * n + i] = seed;
  put(7, 1.0f);
  put3(8, mul(mask, sc.mask_mul));
}

}  // namespace

extern "C" int srt_bounce_launch(const float* state, float* out,
                                 const float* tri_t, const int32_t* tri_slot,
                                 const float* table, const float* sph,
                                 const float* pln, const float* mat,
                                 BounceParams p, void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  if (p.n_materials <= 0 || (p.has_tris && (tri_t == nullptr
                                            || tri_slot == nullptr
                                            || table == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_rays + kBlock - 1) / kBlock;
  bounce_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      state, out, tri_t, tri_slot, table, sph, pln, mat, p);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
