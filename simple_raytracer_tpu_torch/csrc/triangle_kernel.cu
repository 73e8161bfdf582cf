// Brute-force nearest-triangle kernel for Hopper (sm_90a): the
// tri_backend="pallas" route of the split per-bounce path.
//
// Replaces simple_raytracer_tpu/ops/pallas/triangle_kernel.py:_kernel
// (through intersect_triangles_pallas): for every ray of the batch, over
// every triangle of the packed (16, T) table (rows v0, e1 = v1 - v0,
// e2 = v2 - v0, active, 6 rows of zeros; ops/triangle.py:pack_triangles),
// the nearest Moller-Trumbore hit under the reference's rules (a == 0
// rejected, u in [0, 1], v >= 0, u + v <= 1, t > 0 strictly, inactive
// triangles skipped).  It writes t (+inf on a miss) and the triangle's
// index as int32 (0 on a miss); the earliest triangle wins an exact tie.
// There is no alive mask and no far bound: every ray is tested against
// every triangle, as the TPU kernel does.  Shading is not here: the caller
// gathers the winner's row from the triangle-indexed table.
//
// Design: one thread per ray, a 1-D grid over the rays; the TPU's grid of
// (ray blocks x triangle blocks) with a running (t, argmin) carried across
// the triangle blocks in VMEM becomes a loop inside the block over tiles of
// kTile triangles.  Each tile is staged once per block into shared memory
// (coalesced along T: thread j loads column base + j of each of the 10 rows
// MT reads) as three float4s per triangle, which every thread of the block
// then reads at the same address (a broadcast).  Each ray keeps its
// running (t, index) in registers and replaces it only on a strictly
// nearer hit, so the triangles' index order decides ties, as the first
// minimum (jnp.argmin, torch.min) does in the plain version.  An inactive
// triangle is skipped before MT: the branch is the same for the whole warp.
//
// Bound on the H100 (chip_smoke.py): FP32 arithmetic, 46 operations per
// (ray, active triangle) pair; the bytes (the rays' 24 in and 8 out, the
// table's 40 a triangle) are far below.  Left for later: tensor cores
// (a Plucker-form product), skipping dead rays, and culling: the route is
// brute force by definition.
//
// Arithmetic: built with --fmad=false and no fast math, in the operation
// order of the plain version (ops/triangle.py: nearest_triangle), so each
// float operation rounds as the plain version's does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct TriParams {
  int32_t n_rays;   // rays: the (6, n_rays) f32 origins and directions
  int32_t n_tris;   // columns of the (16, n_tris) f32 packed table
};

namespace {

constexpr int kBlock = 128;
constexpr int kTile = 256;   // triangles per shared tile: 12 KB

__global__ void __launch_bounds__(kBlock)
triangle_kernel(const float* __restrict__ rays, const float* __restrict__ tri,
                float* __restrict__ t_out, int32_t* __restrict__ idx_out,
                const TriParams p) {
  __shared__ float4 s_tri[3 * kTile];
  const int g = blockIdx.x * kBlock + threadIdx.x;
  const bool live = g < p.n_rays;
  const size_t nr = (size_t)p.n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = rays[g];
    oy = rays[nr + g];
    oz = rays[2 * nr + g];
    dx = rays[3 * nr + g];
    dy = rays[4 * nr + g];
    dz = rays[5 * nr + g];
  }
  float best_t = INFINITY;
  int best_i = 0;
  const size_t nt = (size_t)p.n_tris;
  for (int base = 0; base < p.n_tris; base += kTile) {
    const int n = min(kTile, p.n_tris - base);
    __syncthreads();   // the previous tile is no longer read
    for (int j = threadIdx.x; j < n; j += kBlock) {
      const float* q = tri + base + j;   // row r of this column at q[r * nt]
      s_tri[3 * j] = make_float4(q[0], q[nt], q[2 * nt], q[3 * nt]);
      s_tri[3 * j + 1] = make_float4(q[4 * nt], q[5 * nt], q[6 * nt],
                                     q[7 * nt]);
      s_tri[3 * j + 2] = make_float4(q[8 * nt], q[9 * nt], 0.0f, 0.0f);
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float4 c = s_tri[3 * j + 2];
      if (!(c.y > 0.0f)) continue;   // inactive: the whole warp skips it
      const float4 a0 = s_tri[3 * j];
      const float4 a1 = s_tri[3 * j + 1];
      // v0 = a0.xyz, e1 = (a0.w, a1.x, a1.y), e2 = (a1.z, a1.w, c.x)
      const float e1x = a0.w, e1y = a1.x, e1z = a1.y;
      const float e2x = a1.z, e2y = a1.w, e2z = c.x;
      const float hx = dy * e2z - dz * e2y;
      const float hy = dz * e2x - dx * e2z;
      const float hz = dx * e2y - dy * e2x;
      const float a = e1x * hx + e1y * hy + e1z * hz;
      const float f = 1.0f / a;
      const float sx = ox - a0.x;
      const float sy = oy - a0.y;
      const float sz = oz - a0.z;
      const float u = f * (sx * hx + sy * hy + sz * hz);
      const float qx = sy * e1z - sz * e1y;
      const float qy = sz * e1x - sx * e1z;
      const float qz = sx * e1y - sy * e1x;
      const float v = f * (dx * qx + dy * qy + dz * qz);
      const float t = f * (e2x * qx + e2y * qy + e2z * qz);
      if (a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
          && t > 0.0f && t < best_t) {
        best_t = t;
        best_i = base + j;
      }
    }
  }
  if (live) {
    t_out[g] = best_t;
    idx_out[g] = best_i;
  }
}

}  // namespace

extern "C" int srt_triangle_launch(const float* rays, const float* tri,
                                   float* t_out, int32_t* idx_out,
                                   TriParams p, void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  if (p.n_tris < 0) return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_rays + kBlock - 1) / kBlock;
  triangle_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      rays, tri, t_out, idx_out, p);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
