// BVH nearest-hit kernel for Hopper (sm_90a): the per-bounce paths'
// triangle intersection.
//
// Replaces three TPU kernels of simple_raytracer_tpu/ops/pallas/
// bvh_kernel.py, as three compile-time variants of one kernel (Variant):
//   - kFlat (bvh_kernel.py:201 _kernel, tables of at most 8192 slots): the
//     clusters in the wrapper's front-to-back order, each box slab-tested
//     against the ray's live best t (_reslab_flag), then Moller-Trumbore
//     over the cluster's K slots;
//   - kTwoLevel (bvh_kernel.py:1040 _kernel_packed, config 6): the groups of
//     16 supers in front-to-back order, each group box, then each of its 16
//     super boxes, then each of their 16 cluster boxes slab-tested against
//     the live best t, then MT over the admitted cluster's slots;
//   - kStreamed (bvh_kernel.py:678 _kernel_hbm, config 7 and
//     tri_backend="clustered"): the same three gates per ray, walked by the
//     warp together: a gate is passed when any of the warp's 32 rays admits
//     it, and each cluster that some ray admits is staged into the warp's
//     slice of shared memory (the 40 bytes of each slot that MT reads, and
//     its index), kChunk slots at a time, where the rays that admitted it
//     run MT.  It is the counterpart of the TPU's DMA ring, which stages
//     each visited cluster's tile (one (24, 128) packet after another)
//     from HBM into VMEM: config 7's table (1,409,024 slots, 112.7 MB) is
//     beyond the 50 MB L2, so each admitted cluster is read from device
//     memory once per warp, not once per ray.  The chunks let a cluster
//     hold any number of slots (K = 256: two chunks, as two packets).
// Each of kTwoLevel and kStreamed has a second, Plucker form (PLUCKER,
// params.plucker; bvh_kernel.py:629 _mt_update_sub_mxu and :582
// _plucker_lt, row 5a, SRT_BVH_MT=plucker): the same predicate from the
// slot's 20 Plucker coefficients (ops/bvh.py: plucker_table, built once
// per scene; the TPU builds LT per visited cluster) dotted with the ray's
// [d, m = o x d, o, 1]: u*a and v*a over [d, m], a over d, t*a over
// [o, 1], each a dot product in that index order over the nonzero
// coefficients, then f = 1/a and the same tests and commit.  A row of
// the coefficient table: [w2, e2 | -w1, -e1 | -n | n, -pd | active] with
// n = e1 x e2, w1 = v0 x e1, w2 = v0 x e2, pd = n . v0 (80 bytes: five
// float4 loads in kTwoLevel; kStreamed stages the 80 bytes in place of
// the 40 MT bytes).  The TPU evaluates the dot products on its MXU; here
// they are FP32 on the CUDA cores, in the plain version's order (no
// tensor cores: TF32 keeps too few bits for the t and u/v tests).
// For each ray in its list it finds the nearest triangle strictly closer
// than the ray's t_init and writes (t, table slot), or (+inf, -1) when none
// is; a dead ray (alive == 0) is a miss.  Shading is not here: the
// wrapper's caller gathers the winner's table row at its slot.
//
// Design: one thread per ray, a 1-D grid over the ray list.  The slot table
// (C * K rows of 20 f32) and the boxes are read from global memory through
// the read-only path.  The TPU gates a cluster for a 128-ray sub-block and
// reads a packed table through one-hot MXU transposes; here each ray gates
// alone (in kStreamed the warp only shares the walk and the staging, every
// ray keeps its own gates) and reads its slots directly.  The global
// triangle index of each slot comes as an int32 table (it never rides in
// an f32 row), and decides exact ties: the least (t, index) wins, seeded
// with (t_init, -1), so the visiting order never changes a result
// (_mt_update's commit).  Every index product is taken in size_t or stays
// below 2^31: at config 7, 1,409,024 slots x 20 columns is 28.2M words.
//
// Ray compaction: with a permutation, thread i takes ray perm[i]; threads at
// or past *count (read from device memory, so the host never waits) write a
// miss to their ray and exit.  Every result goes to its own ray's place in
// the output, so no scatter follows.
//
// Bound on the H100 (chip_smoke.py): counted from what a launch's walked
// rays open, the clusters whose box they may meet before their result t:
// the MT tests of those clusters' real slots (46 FLOP a pair, the Plucker
// form 38 and 9 a walked ray for m) and the root boxes' slab tests of
// every walked ray; 32 bytes per walked ray in, 8 out per ray, and the
// opened clusters' 44 bytes a slot once (the Plucker form 84).  Left for
// later: warp divergence (the rays of a warp admit different clusters),
// the table's 80-byte rows of which MT reads 40, and staging boxes in
// shared memory.
//
// Arithmetic: built with --fmad=false and no fast math, in the operation
// order of the plain version (ops/bvh.py: slab_maybe, _mt, _mt_plucker),
// so it gives the plain version's bits.  min/max propagate NaN, as
// torch.minimum does, so a NaN slab (0 * inf on a box plane) admits the
// box.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct BvhParams {
  int32_t n_rays;      // length of the ray list (the grid)
  int32_t n_order;     // entries of the visiting order: clusters or groups
  int32_t n_clusters;  // clusters of the slot table
  int32_t k;           // slots per cluster
  int32_t variant;     // Variant
  int32_t plucker;     // 1: the Plucker form (kTwoLevel, kStreamed)
};

enum Variant { kFlat = 0, kTwoLevel = 1, kStreamed = 2 };

namespace {

constexpr int kBlock = 128;
constexpr int kSuper = 16;   // clusters per super (ops/bvh.py: SUPER)
constexpr int kGroup = 16;   // supers per group (ops/bvh.py: GROUP)
// a slot row (ops/scene_types.py: TRI_COLS): v0 (0-2), e1 (3-5), e2 (6-8),
// n0 n1 n2 (9-17), material (18), active (19)
constexpr int kTriCols = 20;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kAll = 0xffffffffu;
// a slot's Plucker coefficients (ops/bvh.py: PLUCKER_COLS)
constexpr int kPluckerCols = 20;
// kStreamed: the slots it stages at a time, and the columns it stages per
// slot: v0 (0-2), e1 (3-5), e2 (6-8) and active (from 19), or the Plucker
// coefficients
constexpr int kChunk = 128;
constexpr int kMtCols = 10;

__device__ __forceinline__ bool is_nan(float a) { return a != a; }
__device__ __forceinline__ float max_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a > b ? a : b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return is_nan(a) ? a : (is_nan(b) ? b : (a < b ? a : b));
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float inx, iny, inz;
  float mx, my, mz;  // o x d, the Plucker form's moment
};

// may the ray meet box b before t_far?  (_visit_prepass's slab test)
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float t_far) {
  const float t1x = (__ldg(b + 0) - r.ox) * r.inx;
  const float t2x = (__ldg(b + 3) - r.ox) * r.inx;
  const float t1y = (__ldg(b + 1) - r.oy) * r.iny;
  const float t2y = (__ldg(b + 4) - r.oy) * r.iny;
  const float t1z = (__ldg(b + 2) - r.oz) * r.inz;
  const float t2z = (__ldg(b + 5) - r.oz) * r.inz;
  const float near = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                             max_nan(min_nan(t1z, t2z), 0.0f));
  const float far = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                            min_nan(max_nan(t1z, t2z), t_far));
  return !((near > far) || (near >= 1.0e38f));
}

struct Best {
  float t;
  int32_t idx;   // global triangle index: decides exact ties
  int32_t slot;  // its table slot: the result
};

// the commit of a valid hit at t (global index g, table slot): the least
// (t, index) wins
__device__ __forceinline__ void commit(float t, int32_t g, int slot,
                                       Best& best) {
  if (t <= best.t && (t < best.t || g < best.idx)) {
    best.t = t;
    best.idx = g;
    best.slot = slot;
  }
}

// Moller-Trumbore against one slot (v0, e1, e2, active; its global index
// g and table slot)
__device__ __forceinline__ void mt_slot(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float active, int32_t g, int slot,
                                        const Ray& r, Best& best) {
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.0f / a;
  const float sx = r.ox - v0x;
  const float sy = r.oy - v0y;
  const float sz = r.oz - v0z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  const float t = f * (e2x * qx + e2y * qy + e2z * qz);
  if (a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
      && t > 0.0f && active > 0.0f)
    commit(t, g, slot, best);
}

// The Plucker form against one slot, from its kPluckerCols coefficients q
// (_mt_update_sub_mxu: the dot products in the ray vector's index order)
__device__ __forceinline__ void plucker_slot(const float* q, int32_t g,
                                             int slot, const Ray& r,
                                             Best& best) {
  const float unum = q[0] * r.dx + q[1] * r.dy + q[2] * r.dz + q[3] * r.mx
                     + q[4] * r.my + q[5] * r.mz;
  const float vnum = q[6] * r.dx + q[7] * r.dy + q[8] * r.dz + q[9] * r.mx
                     + q[10] * r.my + q[11] * r.mz;
  const float a = q[12] * r.dx + q[13] * r.dy + q[14] * r.dz;
  const float tnum = q[15] * r.ox + q[16] * r.oy + q[17] * r.oz + q[18];
  const float f = 1.0f / a;
  const float u = f * unum;
  const float v = f * vnum;
  const float t = f * tnum;
  if (a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
      && t > 0.0f && q[19] > 0.0f)
    commit(t, g, slot, best);
}

// Moller-Trumbore over the K slots of cluster c, read from global memory:
// the MT columns of the slot table, or each slot's Plucker coefficients
// as five float4 loads
template <bool PLUCKER>
__device__ __forceinline__ void mt_cluster(const float* __restrict__ table,
                                           const float* __restrict__ coeffs,
                                           const int32_t* __restrict__ gidx,
                                           int c, int k, const Ray& r,
                                           Best& best) {
  const int row0 = c * k;
  for (int s = 0; s < k; ++s) {
    if constexpr (PLUCKER) {
      const float4* q4 = reinterpret_cast<const float4*>(
          coeffs + (size_t)kPluckerCols * (row0 + s));
      float q[kPluckerCols];
#pragma unroll
      for (int j = 0; j < kPluckerCols / 4; ++j) {
        const float4 w = __ldg(q4 + j);
        q[4 * j] = w.x;
        q[4 * j + 1] = w.y;
        q[4 * j + 2] = w.z;
        q[4 * j + 3] = w.w;
      }
      plucker_slot(q, __ldg(gidx + row0 + s), row0 + s, r, best);
    } else {
      const float* q = table + (size_t)kTriCols * (row0 + s);
      mt_slot(__ldg(q + 0), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3),
              __ldg(q + 4), __ldg(q + 5), __ldg(q + 6), __ldg(q + 7),
              __ldg(q + 8), __ldg(q + 19), __ldg(gidx + row0 + s), row0 + s,
              r, best);
    }
  }
}

// kStreamed's walk: the groups in front-to-back order, then supers, then
// clusters, each gate passed by the warp when any of its rays admits it;
// an admitted cluster is staged into the warp's shared slice kChunk slots
// at a time, and every ray that admitted it runs MT there on each chunk.
// Each ray's own gates and commits are those of kTwoLevel, in the same
// order, so it writes the same result.  Called by the whole warp (control
// flow is warp-uniform).
template <bool PLUCKER>
__device__ __forceinline__ void streamed_walk(
    const float* __restrict__ table, const float* __restrict__ coeffs,
    const int32_t* __restrict__ gidx, const float* __restrict__ boxes,
    const float* __restrict__ supers, const float* __restrict__ groups,
    const int32_t* __restrict__ order, bool listed, const Ray& r, Best& best,
    const BvhParams& p) {
  constexpr int kCols = PLUCKER ? kPluckerCols : kMtCols;
  __shared__ float s_rows[kWarps][kChunk * kCols];
  __shared__ int32_t s_gidx[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  float* rows = s_rows[threadIdx.x >> 5];
  int32_t* gx = s_gidx[threadIdx.x >> 5];
  for (int j = 0; j < p.n_order; ++j) {
    const int g = order[j];
    const bool g_ok = listed && slab(groups + 8 * g, r, best.t);
    if (!__any_sync(kAll, g_ok)) continue;
    for (int s = g * kGroup; s < (g + 1) * kGroup; ++s) {
      const bool s_ok = g_ok && slab(supers + 8 * s, r, best.t);
      if (!__any_sync(kAll, s_ok)) continue;
      for (int c = s * kSuper; c < (s + 1) * kSuper; ++c) {
        const bool c_ok = s_ok && slab(boxes + 8 * c, r, best.t);
        if (!__any_sync(kAll, c_ok)) continue;
        // a NaN ray admits the sentinel boxes past the table too;
        // visiting the last cluster again changes nothing
        const int row0 = min(c, p.n_clusters - 1) * p.k;
        for (int base = 0; base < p.k; base += kChunk) {
          const int n = min(kChunk, p.k - base);
          const int first = row0 + base;
          __syncwarp();   // every lane is done with the last staged chunk
          for (int e = lane; e < n * kCols; e += 32) {
            if constexpr (PLUCKER) {
              rows[e] = __ldg(coeffs + (size_t)kPluckerCols * first + e);
            } else {
              const int slot = e / kMtCols;
              const int col = e - slot * kMtCols;
              rows[e] = __ldg(table + (size_t)kTriCols * (first + slot)
                              + (col < 9 ? col : 19));
            }
          }
          for (int e = lane; e < n; e += 32) gx[e] = __ldg(gidx + first + e);
          __syncwarp();
          if (c_ok) {
            for (int sl = 0; sl < n; ++sl) {
              const float* q = rows + kCols * sl;
              if constexpr (PLUCKER)
                plucker_slot(q, gx[sl], first + sl, r, best);
              else
                mt_slot(q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8],
                        q[9], gx[sl], first + sl, r, best);
            }
          }
        }
      }
    }
  }
}

template <int VARIANT, bool PLUCKER>
__global__ void __launch_bounds__(kBlock)
bvh_kernel(const float* __restrict__ rays, const float* __restrict__ table,
           const float* __restrict__ coeffs,
           const int32_t* __restrict__ gidx, const float* __restrict__ boxes,
           const float* __restrict__ supers, const float* __restrict__ groups,
           const int32_t* __restrict__ order, const int32_t* __restrict__ perm,
           const int32_t* __restrict__ count, float* __restrict__ t_out,
           int32_t* __restrict__ slot_out, const BvhParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < p.n_rays;
  // kStreamed keeps every lane of the warp to the end: its walk is shared
  if (VARIANT != kStreamed && !in_range) return;
  const int ray = !in_range ? 0 : (perm != nullptr ? perm[i] : i);
  const int n = p.n_rays;
  Best best;
  best.t = in_range ? rays[7 * n + ray] : 0.0f;
  best.idx = -1;
  best.slot = -1;
  const bool listed = in_range && (perm == nullptr || i < *count)
                      && rays[6 * n + ray] > 0.0f;
  Ray r = {};
  if (listed) {
    r.ox = rays[ray];
    r.oy = rays[n + ray];
    r.oz = rays[2 * n + ray];
    r.dx = rays[3 * n + ray];
    r.dy = rays[4 * n + ray];
    r.dz = rays[5 * n + ray];
    r.inx = 1.0f / r.dx;
    r.iny = 1.0f / r.dy;
    r.inz = 1.0f / r.dz;
    if constexpr (PLUCKER) {
      r.mx = r.oy * r.dz - r.oz * r.dy;
      r.my = r.oz * r.dx - r.ox * r.dz;
      r.mz = r.ox * r.dy - r.oy * r.dx;
    }
  }
  if constexpr (VARIANT == kStreamed) {
    if (__any_sync(kAll, listed))
      streamed_walk<PLUCKER>(table, coeffs, gidx, boxes, supers, groups,
                             order, listed, r, best, p);
  } else if (listed) {
    if constexpr (VARIANT == kFlat) {
      for (int j = 0; j < p.n_order; ++j) {
        const int c = order[j];
        if (slab(boxes + 8 * c, r, best.t))
          mt_cluster<false>(table, coeffs, gidx, c, p.k, r, best);
      }
    } else {
      for (int j = 0; j < p.n_order; ++j) {
        const int g = order[j];
        if (!slab(groups + 8 * g, r, best.t)) continue;
        for (int s = g * kGroup; s < (g + 1) * kGroup; ++s) {
          if (!slab(supers + 8 * s, r, best.t)) continue;
          for (int c = s * kSuper; c < (s + 1) * kSuper; ++c) {
            // a NaN ray admits the sentinel boxes past the table too;
            // visiting the last cluster again changes nothing
            if (slab(boxes + 8 * c, r, best.t))
              mt_cluster<PLUCKER>(table, coeffs, gidx,
                                  min(c, p.n_clusters - 1), p.k, r, best);
          }
        }
      }
    }
  }
  if (!in_range) return;
  t_out[ray] = best.idx < 0 ? INFINITY : best.t;
  slot_out[ray] = best.idx < 0 ? -1 : best.slot;
}

}  // namespace

extern "C" int srt_bvh_launch(const float* rays, const float* table,
                              const float* coeffs, const int32_t* gidx,
                              const float* boxes, const float* supers,
                              const float* groups, const int32_t* order,
                              const int32_t* perm, const int32_t* count,
                              float* t_out, int32_t* slot_out, BvhParams p,
                              void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  if (p.k <= 0 || p.n_clusters <= 0 || (perm == nullptr) != (count == nullptr)
      || (p.plucker != 0) != (coeffs != nullptr)
      || (p.plucker && p.variant == kFlat))
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.n_rays + kBlock - 1) / kBlock;
  cudaStream_t st = (cudaStream_t)stream;
#define SRT_BVH_LAUNCH(VARIANT, PLUCKER)                                  \
  bvh_kernel<VARIANT, PLUCKER><<<blocks, kBlock, 0, st>>>(                \
      rays, table, coeffs, gidx, boxes, supers, groups, order, perm, count, \
      t_out, slot_out, p)
  switch (p.variant) {
    case kFlat:
      SRT_BVH_LAUNCH(kFlat, false);
      break;
    case kTwoLevel:
      if (p.plucker)
        SRT_BVH_LAUNCH(kTwoLevel, true);
      else
        SRT_BVH_LAUNCH(kTwoLevel, false);
      break;
    case kStreamed:
      if (p.plucker)
        SRT_BVH_LAUNCH(kStreamed, true);
      else
        SRT_BVH_LAUNCH(kStreamed, false);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRT_BVH_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
