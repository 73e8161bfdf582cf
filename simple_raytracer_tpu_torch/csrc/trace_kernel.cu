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
//   - kClusteredTris (bounce_kernel.py:_tris_clustered, and its packed form
//     :376 under tri_backend="fused"): a BVH-clustered mesh of at most 8192
//     slots, or under "fused" at most 853 clusters of at most 128 slots
//     (config 6's 98,304), walked by the warp over the clusters' hierarchy
//     (below).
//
// Design: one launch for all rays, each path's bounce loop inside it.  The
// sphere, plane and material tables (a few hundred bytes) and the small
// triangle table are staged into shared memory once per block (kNoTris
// and kSmallTris: only their active rows, which cut config 3's MT rows
// from 16 to 12 and config 2's planes from 4 to 1; stage_active); above
// the default 48 KB the launch opts in to more, up to the device's limit
// (227 KB on an H100), which the wrapper checks first.  The RNG, the
// sphere and plane loops and the BSDF sample are path_common.cuh's, which
// the per-bounce shade kernel (bounce_kernel.cu) shares.
//
// kSmallTris: persistent warps with path regeneration (trace_paths; Aila
// and Laine, "Understanding the Efficiency of Ray Traversal on GPUs", HPG
// 2009).  One thread a ray, each leaving its loop when its path ended,
// kept a warp (and its block's SM slots) until its longest path ended: on
// config 3 after bounce 1 only 6-19% of a warp-step's lanes carried a ray
// (PERF.md section 6).  Here the grid is the blocks the SMs hold at once;
// each lane traces one path at a time and, when it ends, writes its rows
// and takes the next path index at the warp's next refill, the warp
// fetching kFetch indices at a time from the launch's own counter
// (TraceArgs::next_path).  A path's seed comes from its index and its rows
// go to its index, so no result depends on which lane takes it.  kNoTris,
// whose lanes stay busy to their warps' ends (configs 1 and 2), traces one
// thread a ray (trace_one): persistent warps cost it more than the refills
// saved (PERF.md section 6).
//
// The clustered traversal: a warp walk.  One thread a ray walking alone
// left each warp running the union of its lanes' clusters, one dependent
// 80-byte row load after another, most lanes masked off (1.5-2.4% of its
// FP32 floor; its counts per bounce in PERF.md section 6).  Here the 32
// lanes of a warp walk each bounce together, as the BVH kernel's warp walk
// does (bvh_kernel.cu, which it copies rather than shares: its gates carry
// the margin below, its walk runs once a bounce inside the bounce loop with
// the ring's barrier phases carried from one walk to the next, and rows 4,
// 5 and 5a keep the build they were measured on):
//   - every lane stays in the bounce loop until no lane of its warp is
//     alive (__ballot_sync over the full warp; a lane past the rays or
//     whose ray died is a dead lane, which gates nothing but lends its lane
//     to the split MT below, and writes its own rows as before);
//   - the gates go down the scene's hierarchy (ops/bvh.py: build_hierarchy:
//     groups of 16 supers, supers of 16 clusters), in index order: each
//     level's boxes are slab-tested as one batch (loads issued together)
//     when the walk enters their parent, a gate passing when any lane
//     admits it; each lane keeps its own gates and tests a cluster's box
//     again, with its t then, at the turn of each of its chunks.  A parent
//     box is the min/max of its children's planes and (b - o) * inv rounds
//     monotonically in b, so a parent admits whatever a child admits.  The
//     slab test's min and max are one instruction each (slab_pad says why
//     that changes no result);
//   - Moller-Trumbore reads the 48-byte rows of the staged table
//     (ops/bvh.py: stage_slots: v0 and the global triangle index, e1 and the
//     active flag, e2), kChunk slots at a time, each chunk one bulk copy
//     (TMA) into one of the warp's kStages shared buffers, a ring: the
//     next chunk is found, and its copy issued, before the current chunk's
//     MT (the lookahead gates with the t of that moment, which admits at
//     least what the walk would);
//   - MT is split across the warp: for each admitting ray in turn the 32
//     lanes test every 32nd slot of the chunk with that ray and merge their
//     least (t, index) by a warp minimum over one 64-bit key (t bits << 32
//     | index: t > 0, so its bits order as the floats do).  The sweep found
//     splitting always (kSplitMax = 32) the fastest; a build with a lower
//     kSplitMax lets each admitting lane test every slot itself when more
//     lanes admit a chunk;
//   - the least (t, global triangle index) wins, seeded with (the nearest
//     sphere or plane's t, -1), so a triangle must be strictly nearer and
//     an exact tie goes to the lowest index, as in the dense plain version
//     (ops/intersect.py: closest_hit): the visiting order changes no result;
//   - the walk carries (t, index, slot) only: MT runs once more on the
//     winner's 80-byte row for the (u, v) of the smooth normal, the same
//     operations on the same values, so the same bits.
// The plain version has no gate at all, so each slab test carries a margin
// (kSlabMargin, see slab_pad) that only adds MT work: it covers the slab
// test's own rounding and MT's acceptance of a ray that passes within the
// margin of a triangle's edge.  A hit that MT finds farther outside the
// triangle than that (a ray almost parallel to its plane) can still be
// dropped where the dense plain version keeps it; chip_smoke.py phase 4
// reports every pixel that differs.
// Shared memory of the walk: each warp's ring, kStages x kChunk x 48 bytes
// (48 KB a 128-thread block at 2 x 128: a chunk holds a whole cluster of up
// to 128 slots, one copy), and its barriers, before the tables; the launch
// opts in above the default 48 KB.  Its constants (the block, the ring and
// the split point) are -D defaults that chip_smoke.py's sweep sets on extra
// builds (PERF.md section 6).
//
// Bound on the H100 (chip_smoke.py): per-ray FP32 arithmetic (every sphere
// and plane tested per segment, the root boxes of the hierarchy, MT over
// the real slots of each cluster whose box the ray may meet before its
// final t, the hash RNG, the BSDF); the only device-memory traffic it must
// make is the 12 bytes written per ray, 36 in the nine-row form (the slot
// tables, 4.7 and 7.9 MB at most, stay in L2).
//
// Arithmetic: built with --fmad=false and no fast math, and written in the
// operation order of the plain PyTorch version (ops/camera.py, ops/rng.py,
// ops/intersect.py, ops/bsdf.py, ops/sky.py, ops/trace.py), so each float
// operation rounds as the plain version's does.  The only fused
// multiply-adds are the reference log's (ops/rng.py:log), written out as
// __fmaf_rn.  min/max/clamp propagate NaN, as torch.minimum and torch.clamp
// do (but in the walk's gates, slab_pad), and sign() returns its argument
// for +-0 and NaN, as jnp.sign does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "bulk_copy.cuh"
#include "path_common.cuh"

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
  int32_t n_clusters;     // kClusteredTris: clusters of the slot table
  int32_t cluster_k;      // kClusteredTris: slots per cluster
  int32_t n_groups;       // kClusteredTris: groups of the hierarchy
  float cluster_extent;   // kClusteredTris: largest |coordinate| of a box
  int32_t sky_rows;       // 1: write the 9 rows, no sky (a texture skybox)
};

// the tables of a launch: spheres, planes, materials, the triangle rows
// (kSmallTris; kClusteredTris: the slot table), and for kClusteredTris the
// staged MT rows, the cluster boxes padded to whole groups, the supers and
// the groups; the output rows; for kSmallTris the launch's own counter of
// the path indices handed out (one word, which the launch zeroes on its
// stream first, so launches on other streams never share it)
struct TraceArgs {
  const float* sph;
  const float* pln;
  const float* mat;
  const float* tri;
  const float4* staged;
  const float* boxes;
  const float* supers;
  const float* groups;
  float* out;
  unsigned* next_path;
};

enum TriMode { kNoTris = 0, kSmallTris = 1, kClusteredTris = 2 };

// The counting instance of each variant (srt_trace_count_launch, which
// only chip_smoke.py calls; the route never launches it): what a launch
// did, per bounce, into (num_bounces, kCounters) int64 counters.  The walk
// counters are kClusteredTris's; kNoTris and kSmallTris count the live
// rays, the warps and the cycles of their sections, each added once for
// the lanes that run it together.
enum Count {
  kCountLive = 0,    // live rays that entered the bounce
  kCountWarps,       // warps with a live lane (persistent warps:
                     // warp-steps with a lane at the bounce)
  kCountBoxTests,    // boxes slab-tested by live lanes (every level)
  kCountAdmitted,    // (ray, cluster) pairs that ran MT
  kCountUnion,       // (warp, cluster) visits that ran MT
  kCountMtSteps,     // warp-wide MT steps issued (32 lanes x one slot)
  kCountLaneSteps,   // lane-slot MT tests of an admitting ray
  kCountChunks,      // chunk copies
  kCountSplit,       // chunks whose MT the lanes split slot by slot
  kCountWasted,      // chunks copied that no lane admitted at their turn
  kCountCyclesWalk,  // SM cycles the warps spent in the walk
  kCountCyclesWait,  // of them, waiting for a chunk's copy
  kCountCyclesMt,    // of them, in MT (mt_chunk)
  kCountCyclesBounce,  // SM cycles the warps spent in the bounce (walk)
  kCountCyclesPrims,   // SM cycles in the sphere and plane tests
  kCountCyclesTris,    // SM cycles in kSmallTris's MT loop
  kCountCyclesBsdf,    // SM cycles in the BSDF sample (these three: in
                       // bounce 0's row over the launch for persistent
                       // warps, whose warp-steps mix bounces)
  kCountCyclesGen,     // bounce 0's row only: SM cycles in ray generation
  kCountCyclesFinish,  // bounce 0's row only: SM cycles in the sky and
                       // the writes after a path
  kCountSteps,       // bounce 0's row only: warp-steps of the path loop
  kCountStepLanes,   // bounce 0's row only: their lanes with a path
  kCountFetches,     // bounce 0's row only: fetches of path indices
  kCountCyclesWarp,  // bounce 0's row only: SM cycles from each warp's
                     // start to its end, summed over the warps
  kCountCyclesBlock,   // bounce 0's row only: each block's warps times
                       // its longest warp's cycles, summed over blocks
  kCounters
};
// the most bounces a counting launch counts (its counters sit in shared
// memory until the block ends)
constexpr int kCountBounces = 16;

namespace {

// The path variants' constants (kNoTris, kSmallTris), chosen by
// chip_smoke.py's sweep on the card (PERF.md section 6; a -D flag of the
// same name sets each): the block of persistent warps (kSmallTris) and the
// block of one thread a ray (kNoTris), and the path indices a persistent
// warp takes from the launch's counter at a time.
#ifndef SRT_TRACE_PATH_BLOCK
#define SRT_TRACE_PATH_BLOCK 128
#endif
#ifndef SRT_TRACE_RAY_BLOCK
#define SRT_TRACE_RAY_BLOCK 256
#endif
#ifndef SRT_TRACE_FETCH
#define SRT_TRACE_FETCH 32
#endif
constexpr int kPathBlock = SRT_TRACE_PATH_BLOCK;
constexpr int kRayBlock = SRT_TRACE_RAY_BLOCK;
constexpr unsigned kFetch = SRT_TRACE_FETCH;
static_assert(kPathBlock % 32 == 0 && kPathBlock <= 1024, "bad path block");
static_assert(kRayBlock % 32 == 0 && kRayBlock <= 1024, "bad ray block");
static_assert(kFetch >= 32, "a refill must fit one fetch");
constexpr unsigned kAll = 0xffffffffu;
// a triangle row (ops/scene_types.py: TRI_COLS): v0 (0-2), e1 (3-5),
// e2 (6-8), n0 n1 n2 (9-17), material (18), active (19)
constexpr int kTriCols = 20;
// the slab test's margin, a share of the largest coordinate magnitude it
// meets: 2^-16 is 256 ulps, against the at most 6 ulps of rounding in
// t = (b - o) / d
constexpr float kSlabMargin = 0x1p-16f;
// The warp walk's constants, chosen by chip_smoke.py's sweep on the card
// (PERF.md section 6; a -D flag of the same name sets each for the
// sweep): the block (kClusteredTris), the slots of a chunk, the warp's
// ring of chunk buffers, the most lanes admitting a chunk for which the
// warp splits each admitting ray's MT across its lanes.
#ifndef SRT_TRACE_BLOCK
#define SRT_TRACE_BLOCK 128
#endif
#ifndef SRT_TRACE_CHUNK
#define SRT_TRACE_CHUNK 128
#endif
#ifndef SRT_TRACE_STAGES
#define SRT_TRACE_STAGES 2
#endif
#ifndef SRT_TRACE_SPLIT_MAX
#define SRT_TRACE_SPLIT_MAX 32
#endif
constexpr int kWalkBlock = SRT_TRACE_BLOCK;
constexpr int kWalkWarps = kWalkBlock / 32;
constexpr int kChunk = SRT_TRACE_CHUNK;
constexpr int kStages = SRT_TRACE_STAGES;
constexpr int kSplitMax = SRT_TRACE_SPLIT_MAX;
constexpr int kSuper = 16;   // clusters per super (ops/bvh.py: SUPER)
constexpr int kGroup = 16;   // supers per group (ops/bvh.py: GROUP)
constexpr int kBatch = 16;   // groups slab-tested together
// a staged slot (ops/bvh.py: STAGED_COLS = 12), in float4s
constexpr int kRowF4 = 3;
static_assert(kWalkBlock % 32 == 0 && kWalkBlock <= 1024, "bad block");
static_assert(kChunk % 32 == 0 && kStages >= 1, "bad ring");

// does the variant run persistent warps?  kSmallTris does; kNoTris, whose
// lanes stay busy to the end of their warps, traces one thread a ray.
template <int TRI>
constexpr bool kPersistent = TRI == kSmallTris;

// the block of each variant
#define SRT_TRACE_BLOCK_OF(TRI)                                             \
  ((TRI) == kClusteredTris ? kWalkBlock                                    \
                           : (kPersistent<TRI> ? kPathBlock : kRayBlock))

// the walk's dynamic shared memory before the tables: each warp's ring of
// chunk buffers, then its barriers
constexpr size_t kRingFloat4s = (size_t)kWalkWarps * kStages * kChunk * kRowF4;
constexpr size_t kWalkBytes =
    kRingFloat4s * 16 + (size_t)kWalkWarps * kStages * 8;

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


// ---- the clustered traversal: the warp walk (kClusteredTris) ------------

// a lane's ray for the walk: o, d, 1 / d and its slab margin in t
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float inx, iny, inz;
  float pad;
};

// The lane's ray.  Its slab margin is kSlabMargin times the larger of the
// ray origin's and the boxes' largest coordinate magnitude: in t that is
// `pad` times the largest |1 / d|, which widens each axis's slab at least
// as much.  A zero direction component makes pad infinite and admits every
// real box.
__device__ __forceinline__ Ray walk_ray(V3 o, V3 d, float extent) {
  Ray r;
  r.ox = o.x;
  r.oy = o.y;
  r.oz = o.z;
  r.dx = d.x;
  r.dy = d.y;
  r.dz = d.z;
  r.inx = 1.0f / d.x;
  r.iny = 1.0f / d.y;
  r.inz = 1.0f / d.z;
  const float mag = fmaxf(fmaxf(fabsf(o.x), fabsf(o.y)),
                          fmaxf(fabsf(o.z), extent));
  r.pad = kSlabMargin * mag
          * fmaxf(fmaxf(fabsf(r.inx), fabsf(r.iny)), fabsf(r.inz));
  return r;
}

// May the ray meet the box [lo, hi] before t_far, within the margin?  A
// padding box (every plane at 3e38) falls to the lo.x >= 1e38 term.  The
// min and max are fminf and fmaxf, one instruction each, which drop a NaN
// operand; that changes no admission that matters: with 1 / d finite and
// o and the planes finite no t here is NaN (a product of finite values,
// or an overflow to +-inf); a zero (or denormal) direction component
// makes 1 / d infinite and pad infinite, and near - pad > far + pad is
// then false (or NaN) for every box, which admits it; and a ray with a
// NaN in o or d, which a box may now refuse, has no valid MT hit anywhere.
__device__ __forceinline__ bool slab_pad(float lx, float ly, float lz,
                                         float hx, float hy, float hz,
                                         const Ray& r, float t_far) {
  const float t1x = (lx - r.ox) * r.inx;
  const float t2x = (hx - r.ox) * r.inx;
  const float t1y = (ly - r.oy) * r.iny;
  const float t2y = (hy - r.oy) * r.iny;
  const float t1z = (lz - r.oz) * r.inz;
  const float t2z = (hz - r.oz) * r.inz;
  const float near = fmaxf(fmaxf(fminf(t1x, t2x), fminf(t1y, t2y)),
                           fmaxf(fminf(t1z, t2z), 0.0f));
  const float far = fminf(fminf(fmaxf(t1x, t2x), fmaxf(t1y, t2y)),
                          fminf(fmaxf(t1z, t2z), t_far));
  return !((near - r.pad > far + r.pad) || (lx >= 1.0e38f));
}

// the test of box row b (8 floats: lo, hi, 0, 0, read as two float4s)
__device__ __forceinline__ bool slab_box(const float* __restrict__ b,
                                         const Ray& r, float t_far) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b) + 1);
  return slab_pad(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, t_far);
}

// the lane's gates of N consecutive box rows against t_far, bit i for box
// i: all loads issued together, so a batch costs one trip to memory
template <int N>
__device__ __forceinline__ unsigned slab_mask(const float* __restrict__ b,
                                              const Ray& r, float t_far) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 lo = __ldg(b4 + 2 * i);       // lo.xyz, hi.x
    const float4 hi = __ldg(b4 + 2 * i + 1);   // hi.yz, 0, 0
    m |= (unsigned)slab_pad(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, t_far)
         << i;
  }
  return m;
}

// a warp-uniform count of the counting instance, added by lane 0
template <bool COUNT>
__device__ __forceinline__ void count(unsigned long long* cnt, int i,
                                      unsigned long long n) {
  if constexpr (COUNT) {
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(cnt + i, n);
  }
}

// The counting instance's span of a section: its start, once the lanes
// that run it together are at it, and its SM cycles, added once for them
// by the lowest (kNoTris and kSmallTris leave their lanes free to part)
template <bool COUNT>
__device__ __forceinline__ long long span_start() {
  if constexpr (COUNT) {
    __syncwarp(__activemask());
    return clock64();
  }
  return 0;
}
template <bool COUNT>
__device__ __forceinline__ void span_end(unsigned long long* cnt, int i,
                                         long long t0) {
  if constexpr (COUNT) {
    const unsigned m = __activemask();
    __syncwarp(m);
    if ((threadIdx.x & 31) == __ffs(m) - 1)
      atomicAdd(cnt + i, (unsigned long long)(clock64() - t0));
  }
}

// the best triangle of the walk: t, its global index (decides exact ties)
// and its table slot
struct Best {
  float t;
  int32_t idx;
  int32_t slot;
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

// Moller-Trumbore against one staged slot: is it a valid hit, at t?  The
// operations of mt_update, in its order.
__device__ __forceinline__ bool staged_hit(const float4* __restrict__ buf,
                                           int sl, const Ray& r, float& t,
                                           int32_t& g) {
  const float4 a = buf[kRowF4 * sl];       // v0, global index
  const float4 b = buf[kRowF4 * sl + 1];   // e1, active
  const float4 e = buf[kRowF4 * sl + 2];   // e2
  g = __float_as_int(a.w);
  const float hx = r.dy * e.z - r.dz * e.y;
  const float hy = r.dz * e.x - r.dx * e.z;
  const float hz = r.dx * e.y - r.dy * e.x;
  const float aa = b.x * hx + b.y * hy + b.z * hz;
  const float f = 1.0f / aa;
  const float sx = r.ox - a.x;
  const float sy = r.oy - a.y;
  const float sz = r.oz - a.z;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * b.z - sz * b.y;
  const float qy = sz * b.x - sx * b.z;
  const float qz = sx * b.y - sy * b.x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (e.x * qx + e.y * qy + e.z * qz);
  return aa != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
         && t > 0.0f && b.w > 0.0f;
}

// The admitting lanes' MT over one staged chunk of n slots (first: its
// first table slot).  Few lanes admitting (at most kSplitMax): for each
// admitting ray in turn every lane tests every 32nd slot with that ray,
// and the least (t, index) of the warp is committed by the ray's own lane.
// Many: each admitting lane tests every slot (the whole warp reads one
// address).  Called by the whole warp.
template <bool COUNT>
__device__ __forceinline__ void mt_chunk(const float4* __restrict__ buf,
                                         int n, int first, unsigned admit,
                                         bool ok, const Ray& r, Best& best,
                                         unsigned long long* cnt) {
  const int lane = threadIdx.x & 31;
  const int n_admit = __popc(admit);
  count<COUNT>(cnt, kCountLaneSteps, (unsigned long long)n_admit * n);
  if (n_admit > kSplitMax) {
    count<COUNT>(cnt, kCountMtSteps, n);
    if (ok) {
      for (int sl = 0; sl < n; ++sl) {
        float t;
        int32_t g;
        if (staged_hit(buf, sl, r, t, g)) commit(t, g, first + sl, best);
      }
    }
    return;
  }
  count<COUNT>(cnt, kCountSplit, 1);
  count<COUNT>(cnt, kCountMtSteps,
               (unsigned long long)n_admit * ((n + 31) / 32));
  for (unsigned m = admit; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    Ray q;
    q.ox = __shfl_sync(kAll, r.ox, src);
    q.oy = __shfl_sync(kAll, r.oy, src);
    q.oz = __shfl_sync(kAll, r.oz, src);
    q.dx = __shfl_sync(kAll, r.dx, src);
    q.dy = __shfl_sync(kAll, r.dy, src);
    q.dz = __shfl_sync(kAll, r.dz, src);
    // this lane's least candidate as one key: t > 0, so its bits order
    // as the floats do, then the global index (>= 0 for an active slot)
    unsigned long long key = ~0ull;
    int slot = -1;
    for (int sl = lane; sl < n; sl += 32) {
      float t;
      int32_t g;
      if (staged_hit(buf, sl, q, t, g)) {
        const unsigned long long k2 =
            ((unsigned long long)__float_as_uint(t) << 32) | (uint32_t)g;
        if (k2 < key) {
          key = k2;
          slot = first + sl;
        }
      }
    }
    const unsigned any = __ballot_sync(kAll, key != ~0ull);
    if (!any) continue;
    unsigned long long least = key;
    int from = __ffs(any) - 1;
    if (any & (any - 1)) {
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kAll, least, off);
        least = o < least ? o : least;
      }
      from = __ffs(__ballot_sync(kAll, key == least)) - 1;
    } else {
      least = __shfl_sync(kAll, key, from);
    }
    const int won = __shfl_sync(kAll, slot, from);
    if (lane == src)
      commit(__uint_as_float((uint32_t)(least >> 32)),
             (int32_t)(uint32_t)least, won, best);
  }
}

// the walk's place: a batch of up to kBatch groups from j0, the current
// group g's supers and the current super s's clusters, each as this lane's
// gates (bit i: member i admitted) and the warp's union, less the members
// visited
struct Walk {
  int j0 = -kBatch;
  unsigned g_mask = 0, g_any = 0;
  int g = 0;
  unsigned s_mask = 0, s_any = 0;
  int s = -1;
  unsigned c_mask = 0, c_any = 0;
};

// one staged chunk: slots [base, base + kChunk) of cluster c, and whether
// this lane admitted the cluster when it was found
struct Item {
  int c;
  int base;
  bool ok;
};

// the ring's place, carried from one walk of the warp to the next: chunks
// copied, chunks consumed (equal between walks) and each buffer's next
// barrier parity (bit b)
struct Ring {
  uint32_t issued = 0, done = 0, phase = 0;
};

// The next chunk to stage: the current cluster's next chunk, else the next
// cluster some lane admits, through the group, super and cluster gates in
// index order.  A level's gates are tested together when the walk enters
// its parent, each against the lane's best t then: a t can only fall, so
// that admits at least what gating each box at its turn would, and the
// chunk's own turn tests its cluster's box again.  Called by the whole
// warp; false at the end.
template <bool COUNT>
__device__ __forceinline__ bool next_item(
    Walk& w, Item& it, const TraceArgs& a, const TraceParams& p, bool live,
    const Ray& r, float best_t, unsigned long long* cnt) {
  if (it.c >= 0 && it.base + kChunk < p.cluster_k) {
    it.base += kChunk;
    return true;
  }
  for (;;) {
    if (w.c_any) {
      const int i = __ffs(w.c_any) - 1;
      w.c_any &= w.c_any - 1;
      it.c = w.s * kSuper + i;
      it.base = 0;
      it.ok = (w.c_mask >> i) & 1u;
      return true;
    }
    if (w.s_any) {
      const int i = __ffs(w.s_any) - 1;
      w.s_any &= w.s_any - 1;
      w.s = w.g * kGroup + i;
      const bool in = (w.s_mask >> i) & 1u;
      w.c_mask = in ? slab_mask<kSuper>(a.boxes + 8 * kSuper * w.s, r, best_t)
                    : 0u;
      w.c_any = __reduce_or_sync(kAll, w.c_mask);
      if constexpr (COUNT)
        count<COUNT>(cnt, kCountBoxTests,
                     kSuper * __popc(__ballot_sync(kAll, in)));
      continue;
    }
    if (w.g_any) {
      const int i = __ffs(w.g_any) - 1;
      w.g_any &= w.g_any - 1;
      w.g = w.j0 + i;
      const bool in = (w.g_mask >> i) & 1u;
      w.s_mask = in ? slab_mask<kGroup>(a.supers + 8 * kGroup * w.g, r,
                                        best_t)
                    : 0u;
      w.s_any = __reduce_or_sync(kAll, w.s_mask);
      if constexpr (COUNT)
        count<COUNT>(cnt, kCountBoxTests,
                     kGroup * __popc(__ballot_sync(kAll, in)));
      continue;
    }
    w.j0 += kBatch;
    if (w.j0 >= p.n_groups) return false;
    const int n = min(kBatch, p.n_groups - w.j0);
    w.g_mask = 0;
    if (live) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (i < n && slab_box(a.groups + 8 * (w.j0 + i), r, best_t))
          w.g_mask |= 1u << i;
    }
    w.g_any = __reduce_or_sync(kAll, w.g_mask);
    if constexpr (COUNT)
      count<COUNT>(cnt, kCountBoxTests,
                   (unsigned long long)n * __popc(__ballot_sync(kAll, live)));
  }
}

// The warp walk of one bounce: the warp visits, in order, every chunk of
// every cluster that some lane's gates admit (next_item); each chunk is one
// bulk copy of its staged rows into the next buffer of the warp's ring, so
// that while a chunk's MT runs the copies of the next kStages - 1 are in
// flight.  At a chunk's turn each lane tests the cluster's box again with
// its t then, and the lanes that still admit it run MT (mt_chunk).  Called
// by the whole warp, live lanes or not.
template <bool COUNT>
__device__ __forceinline__ void walk(const TraceArgs& a, const TraceParams& p,
                                     bool live, const Ray& r, Best& best,
                                     float4* __restrict__ s_ring,
                                     uint64_t* __restrict__ s_bar, Ring& ring,
                                     unsigned long long* cnt) {
  const int lane = threadIdx.x & 31;
  Walk w;
  Item last = {-1, 0, false};   // the chunk found last
  Item q[kStages];              // the chunks staged, oldest first
  int n_q = 0;
  bool more = true;
  // find the next chunk and copy it into the next buffer of the ring
  auto stage_next = [&]() {
    more = next_item<COUNT>(w, last, a, p, live, r, best.t, cnt);
    if (!more) return;
#pragma unroll
    for (int i = 0; i < kStages; ++i)
      if (i == n_q) q[i] = last;
    ++n_q;
    const int b = ring.issued++ % kStages;
    const int first = min(last.c, p.n_clusters - 1) * p.cluster_k + last.base;
    const int n = min(kChunk, p.cluster_k - last.base);
    count<COUNT>(cnt, kCountChunks, 1);
    __syncwarp();   // every lane is done with buffer b's last chunk
    if (lane == 0)
      bulk_load(s_ring + b * kChunk * kRowF4,
                a.staged + (size_t)first * kRowF4,
                static_cast<uint32_t>(n * kRowF4 * 16), &s_bar[b]);
  };
  while (more && n_q < kStages) stage_next();
  while (n_q > 0) {
    const Item cur = q[0];
#pragma unroll
    for (int i = 0; i + 1 < kStages; ++i) q[i] = q[i + 1];
    --n_q;
    const int b = ring.done++ % kStages;
    const long long t_wait = COUNT ? clock64() : 0;
    bar_wait(&s_bar[b], (ring.phase >> b) & 1u);
    ring.phase ^= 1u << b;
    if constexpr (COUNT) {
      __syncwarp();
      count<COUNT>(cnt, kCountCyclesWait, clock64() - t_wait);
    }
    const bool ok = cur.ok && slab_box(a.boxes + 8 * cur.c, r, best.t);
    if constexpr (COUNT)
      count<COUNT>(cnt, kCountBoxTests, __popc(__ballot_sync(kAll, cur.ok)));
    const unsigned admit = __ballot_sync(kAll, ok);
    if (admit) {
      if (cur.base == 0) {
        count<COUNT>(cnt, kCountUnion, 1);
        count<COUNT>(cnt, kCountAdmitted, __popc(admit));
      }
      const int first = min(cur.c, p.n_clusters - 1) * p.cluster_k + cur.base;
      const long long t_mt = COUNT ? clock64() : 0;
      mt_chunk<COUNT>(s_ring + b * kChunk * kRowF4,
                      min(kChunk, p.cluster_k - cur.base), first, admit, ok,
                      r, best, cnt);
      if constexpr (COUNT) {
        __syncwarp();
        count<COUNT>(cnt, kCountCyclesMt, clock64() - t_mt);
      }
    } else {
      count<COUNT>(cnt, kCountWasted, 1);
    }
    if (more) stage_next();   // into buffer b, just read
  }
}

// the counting instance's cycles of one bounce of the warp, from t0; every
// lane of the warp ends the bounce here, live or not
template <bool COUNT>
__device__ __forceinline__ void bounce_cycles(unsigned long long* cnt,
                                              long long t0) {
  if constexpr (COUNT) {
    __syncwarp();
    count<COUNT>(cnt, kCountCyclesBounce, clock64() - t0);
  }
}

// ---- one path: its ray, a bounce's shading, its rows -------------------

// the tables in shared memory and their rows
struct Tables {
  const float* sph;
  const float* pln;
  const float* mat;
  const float* tri;   // kSmallTris
  int n_sph, n_pln, n_tri;
};

// Warp 0 copies the rows of an (n, cols) table whose column `flag` is > 0
// into dst, in order, and returns their count.  A row whose flag fails
// its test (intersect_spheres, intersect_planes, MT: `active > 0`) never
// wins, so a loop over these rows finds what the loop over every row
// finds, in the same order: the first of an exact tie stays first.
__device__ __forceinline__ int stage_active(float* dst, const float* src,
                                            int n, int cols, int flag) {
  const int lane = threadIdx.x & 31;
  int out = 0;
  for (int base = 0; base < n; base += 32) {
    const int row = base + lane;
    const bool keep = row < n && src[(size_t)row * cols + flag] > 0.0f;
    const unsigned m = __ballot_sync(kAll, keep);
    if (keep) {
      const int at = out + __popc(m & ((1u << lane) - 1u));
      for (int c = 0; c < cols; ++c)
        dst[(size_t)at * cols + c] = src[(size_t)row * cols + c];
    }
    out += __popc(m);
  }
  return out;
}

// a path's state between bounces (ops/trace.py: trace_rays_rows); its
// sky rows are the throughput and direction of its miss, which ends it,
// so they are not kept apart (path_finish)
struct Path {
  V3 o, d;
  V3 color, mask;
  uint32_t seed;
};

// how a bounce left its path
enum Outcome { kGoesOn = 0, kMissed, kEnded };

// Ray g of the launch (ops/camera.py: generate_rays) and its path before
// the first bounce
__device__ __forceinline__ Path path_start(const TraceParams& p, int g) {
  // the index arithmetic in unsigned ints (every operand is >= 0, so the
  // same values; an unsigned division is the shorter sequence)
  const uint32_t w = (uint32_t)p.width, ns = (uint32_t)p.num_samples;
  const uint32_t s = (uint32_t)g % ns;
  const uint32_t pix = (uint32_t)g / ns;
  uint32_t px, py;
  if (p.tile_h > 0) {
    // invert tiled_pixel_order's (band/th, W/tw, th, tw) enumeration
    const uint32_t th = (uint32_t)p.tile_h, tw = (uint32_t)p.tile_w,
                   cc = w / tw;
    px = ((pix / (tw * th)) % cc) * tw + pix % tw;
    py = (pix / (tw * th * cc)) * th + (pix / tw) % th;
  } else {
    px = pix % w;
    py = pix / w;
  }
  const uint32_t pixel_id = (py * w + px) + (uint32_t)p.row0 * w;
  Path q;
  q.seed = (s + pixel_id * ns) * p.time * 5304u;
  const float u1 = next_uniform(q.seed);
  const float u2 = next_uniform(q.seed);
  const float ndc_x = ((float)(int)px + u1) / (float)p.width;
  const float ndc_y = ((float)((int)py + p.row0) + u2) / p.height;
  const float sx = (2.0f * ndc_x - 1.0f) * p.aspect_ratio * p.fov_scale;
  const float sy = (1.0f - 2.0f * ndc_y) * p.fov_scale;
  q.d = normalize(mk(p.rot[0] * sx + p.rot[1] * sy + p.rot[2] * -1.0f,
                     p.rot[3] * sx + p.rot[4] * sy + p.rot[5] * -1.0f,
                     p.rot[6] * sx + p.rot[7] * sy + p.rot[8] * -1.0f));
  q.o = load3(p.cam_pos);
  q.color = mk(0.0f, 0.0f, 0.0f);
  q.mask = mk(1.0f, 1.0f, 1.0f);
  return q;
}

// One bounce's shading (ops/trace.py: trace_rays_rows) from the nearest
// sphere (t_s, i_s), plane (t_p, i_p) and triangle (t_t and th; t_t =
// +inf when no triangle beats the sphere and plane) of the path's ray,
// the triangle rows at `tri`: a miss ends the path (its throughput and
// direction are the sky's); a hit adds its emission and, before the last
// bounce, samples the BSDF for the next ray.
template <int TRI, bool COUNT>
__device__ __forceinline__ Outcome path_bounce(
    Path& q, int bounce, const TraceParams& p, float t_s, int i_s, float t_p,
    int i_p, float t_t, const TriHit& th, const float* s_sph,
    const float* s_pln, const float* s_mat, const float* tri,
    unsigned long long* cnt) {
  const float t = min_nan(min_nan(t_s, t_p), t_t);  // never NaN
  if (t == INFINITY) return kMissed;
  // closest_hit: ties go to the sphere, then the plane
  const V3 pos = add(q.o, scale(q.d, t));
  V3 normal;
  int m;
  if (t_s == t) {
    const float* r = s_sph + 8 * i_s;
    normal = sphere_normal(r, pos);
    m = (int)r[4];
  } else if (TRI == kNoTris || t_p == t) {
    const float* r = s_pln + 8 * i_p;
    normal = mk(r[3], r[4], r[5]);
    m = (int)r[6];
  } else {
    // the smooth normal from MT's own (u, v) (ops/intersect.py:
    // triangle_normal), then normalized
    const float* r = tri + (size_t)kTriCols * th.row;
    const float w0 = 1.0f - th.u - th.v;
    normal = normalize(add(add(scale(load3(r + 9), w0),
                               scale(load3(r + 12), th.u)),
                           scale(load3(r + 15), th.v)));
    m = (int)r[18];
  }
  const bool front = dot(normal, q.d) < 0.0f;
  normal = scale(normal, front ? 1.0f : -1.0f);

  const float* mt = s_mat + 16 * m;
  q.color = add(q.color, scale(mul(q.mask, load3(mt + 9)), mt[3]));
  if (bounce == p.num_bounces - 1) return kEnded;  // emission only

  // ---- the BSDF sample (path_common.cuh: sample_bsdf) ----
  const long long t_bsdf = span_start<COUNT>();
  const Scatter sc = sample_bsdf(normal, front, q.d, mt, q.seed);
  q.o = scatter_origin(pos, normal, sc.dir);
  q.d = sc.dir;
  q.mask = mul(q.mask, sc.mask_mul);
  span_end<COUNT>(cnt, kCountCyclesBsdf, t_bsdf);
  return kGoesOn;
}

// Path g's rows: its radiance with the gradient sky, or for a texture
// skybox the nine the wrapper samples it from (color, sky_mask, sky_dir):
// the throughput and direction of its miss, or for a path that never
// missed (0, 0, 0) and (0, 0, 1), as trace_rays_rows starts them.
__device__ __forceinline__ void path_finish(const TraceArgs& a,
                                            const TraceParams& p, int g,
                                            V3 color, V3 sky_mask,
                                            V3 sky_dir) {
  const size_t n = (size_t)p.n_rays;
  if (p.sky_rows) {
    const float rows[9] = {color.x,    color.y,    color.z,
                           sky_mask.x, sky_mask.y, sky_mask.z,
                           sky_dir.x,  sky_dir.y,  sky_dir.z};
    for (int k = 0; k < 9; ++k) a.out[k * n + g] = rows[k];
    return;
  }
  const V3 c = add(color, mul(sky_mask, sky_gradient(sky_dir, p)));
  a.out[g] = c.x;
  a.out[n + g] = c.y;
  a.out[2 * n + g] = c.z;
}

// the rows of a path variant's path that ended at a bounce
__device__ __forceinline__ void path_end(const TraceArgs& a,
                                         const TraceParams& p, int g,
                                         const Path& q, bool missed) {
  path_finish(a, p, g, q.color, missed ? q.mask : mk(0.0f, 0.0f, 0.0f),
              missed ? q.d : mk(0.0f, 0.0f, 1.0f));
}

// ---- kClusteredTris: a warp's paths through the walk --------------------

// One ray's whole path through the warp walk, its rows written: ray g of
// the launch (a lane past the rays walks as a dead lane of its warp and
// writes nothing).  Called by the whole warp, whose ring it uses.
template <bool COUNT>
__device__ __forceinline__ void trace_walk(
    const TraceArgs& a, const TraceParams& p, int g, const float* s_sph,
    const float* s_pln, const float* s_mat, float4* __restrict__ s_ring,
    uint64_t* __restrict__ s_bar, Ring& ring,
    unsigned long long* __restrict__ counters) {
  const bool in_range = g < p.n_rays;
  bool alive = in_range;
  V3 sky_mask = mk(0.0f, 0.0f, 0.0f);
  V3 sky_dir = mk(0.0f, 0.0f, 1.0f);
  const long long t_gen = span_start<COUNT>();
  Path q = path_start(p, g);
  span_end<COUNT>(counters, kCountCyclesGen, t_gen);
  for (int bounce = 0; bounce < p.num_bounces; ++bounce) {
    unsigned long long* cnt =
        COUNT ? counters + (size_t)bounce * kCounters : nullptr;
    // the warp goes on while any of its lanes is alive
    const unsigned lanes = __ballot_sync(kAll, alive);
    if (!lanes) break;
    long long t_bounce = 0;
    if constexpr (COUNT) {
      count<COUNT>(cnt, kCountLive, __popc(lanes));
      count<COUNT>(cnt, kCountWarps, 1);
      t_bounce = clock64();
    }
    // the nearest sphere and plane (path_common.cuh)
    float t_s = INFINITY, t_p = INFINITY;
    int i_s = 0, i_p = 0;
    const long long t_prims = span_start<COUNT>();
    if (alive) {
      nearest_sphere(s_sph, p.n_spheres, q.o, q.d, t_s, i_s);
      nearest_plane(s_pln, p.n_planes, q.o, q.d, t_p, i_p);
    }
    span_end<COUNT>(cnt, kCountCyclesPrims, t_prims);
    // the nearest triangle (+inf when none beats the sphere/plane seed)
    TriHit th = {INFINITY, -1, 0.0f, 0.0f};
    float t_t = INFINITY;
    Best best = {min_nan(t_s, t_p), -1, -1};
    const long long t_walk = COUNT ? clock64() : 0;
    walk<COUNT>(a, p, alive, walk_ray(q.o, q.d, p.cluster_extent), best,
                s_ring, s_bar, ring, cnt);
    if constexpr (COUNT) {
      __syncwarp();
      count<COUNT>(cnt, kCountCyclesWalk, clock64() - t_walk);
    }
    if (best.idx >= 0) {
      // the winner's (u, v): MT again on its row, the same operations on
      // the same values, so the same bits as the walk's test
      mt_update<true>(a.tri + (size_t)kTriCols * best.slot, best.slot, q.o,
                      q.d, th);
      th.row = best.slot;
      t_t = best.t;
    }
    if (alive) {
      const Outcome out = path_bounce<kClusteredTris, COUNT>(
          q, bounce, p, t_s, i_s, t_p, i_p, t_t, th, s_sph, s_pln, s_mat,
          a.tri, cnt);
      alive = out == kGoesOn;
      if (out == kMissed) {
        sky_mask = q.mask;
        sky_dir = q.d;
      }
    }
    bounce_cycles<COUNT>(cnt, t_bounce);
  }
  if (in_range) {
    const long long t_finish = span_start<COUNT>();
    path_finish(a, p, g, q.color, sky_mask, sky_dir);
    span_end<COUNT>(counters, kCountCyclesFinish, t_finish);
  }
}

// ---- kNoTris and kSmallTris: one bounce of a path ----------------------

// One bounce of path g, its ray q at `bounce`: the nearest sphere and
// plane, kSmallTris's nearest triangle (MT over every row, +inf when none
// beats the sphere/plane seed), then the shading; a path that ended
// writes its rows.  The counting instance adds the bounce's spans to
// `cnt` and the rows' to `counters`.
template <int TRI, bool COUNT>
__device__ __forceinline__ Outcome path_step(
    const TraceArgs& a, const TraceParams& p, const Tables& tab, Path& q,
    int g, int bounce, unsigned long long* cnt,
    unsigned long long* counters) {
  // the nearest sphere and plane (path_common.cuh)
  float t_s, t_p;
  int i_s, i_p;
  const long long t_prims = span_start<COUNT>();
  nearest_sphere(tab.sph, tab.n_sph, q.o, q.d, t_s, i_s);
  nearest_plane(tab.pln, tab.n_pln, q.o, q.d, t_p, i_p);
  span_end<COUNT>(cnt, kCountCyclesPrims, t_prims);
  TriHit th = {INFINITY, -1, 0.0f, 0.0f};
  if (TRI == kSmallTris) {
    const long long t_tris = span_start<COUNT>();
    for (int j = 0; j < tab.n_tri; ++j)
      mt_update<false>(tab.tri + kTriCols * j, j, q.o, q.d, th);
    span_end<COUNT>(cnt, kCountCyclesTris, t_tris);
  }
  const Outcome out = path_bounce<TRI, COUNT>(
      q, bounce, p, t_s, i_s, t_p, i_p, th.t, th, tab.sph, tab.pln,
      tab.mat, tab.tri, cnt);
  if (out != kGoesOn) {
    const long long t_finish = span_start<COUNT>();
    path_end(a, p, g, q, out == kMissed);
    span_end<COUNT>(counters, kCountCyclesFinish, t_finish);
  }
  return out;
}

// ---- kSmallTris: persistent warps that refill their lanes ---------------

// The warp's paths, each lane one at a time, until the launch has none
// left: a lane whose path ends writes its rows and takes a new index at
// the warp's next refill (the next step, as soon as one lane waits); the
// warp takes kFetch indices at a time from the launch's own counter
// a.next_path (one atomic; zeroed on the launch's stream before it) and
// hands them to its waiting lanes in lane order.  Ray g's path makes the
// same float operations as in any other order, its seed from g, its rows
// written at g: no result depends on which lane or warp takes it.
// Called by the whole warp.
template <int TRI, bool COUNT>
__device__ __forceinline__ void trace_paths(
    const TraceArgs& a, const TraceParams& p, const Tables& tab,
    unsigned long long* __restrict__ counters) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned n = (unsigned)p.n_rays;
  Path q;
  int g = -1;          // the lane's path, -1 for none
  int bounce = 0;      // its bounce
  // the warp's indices fetched and not yet handed out, [pool, pool_end),
  // and whether every index of the launch is handed out (warp-uniform)
  unsigned pool = 0, pool_end = 0;
  bool drained = false;
  for (;;) {
    const unsigned idle = __ballot_sync(kAll, g < 0);
    if (!drained && idle) {
      const unsigned k = __popc(idle);
      const unsigned avail = pool_end - pool;
      unsigned base = 0;
      if (avail < k) {
        if (lane == 0) base = atomicAdd(a.next_path, kFetch);
        base = __shfl_sync(kAll, base, 0);
        count<COUNT>(counters, kCountFetches, 1);
      }
      if (g < 0) {
        const unsigned r = __popc(idle & ((1u << lane) - 1u));
        const unsigned i = r < avail ? pool + r : base + (r - avail);
        if (i < n) {
          const long long t_gen = span_start<COUNT>();
          g = (int)i;
          bounce = 0;
          q = path_start(p, g);
          span_end<COUNT>(counters, kCountCyclesGen, t_gen);
        }
      }
      if (avail < k) {
        pool = base + (k - avail);
        pool_end = base + kFetch;
      } else {
        pool += k;
      }
      drained = pool >= n;
    }
    const unsigned live = __ballot_sync(kAll, g >= 0);
    if (!live) break;   // drained, and every path of the warp done
    count<COUNT>(counters, kCountSteps, 1);
    count<COUNT>(counters, kCountStepLanes, __popc(live));
    if (g < 0) continue;
    if constexpr (COUNT) {
      // the live rays and the warp-steps of each bounce
      const unsigned same = __match_any_sync(live, bounce);
      if (lane == __ffs(same) - 1) {
        unsigned long long* row = counters + (size_t)bounce * kCounters;
        atomicAdd(row + kCountLive, (unsigned long long)__popc(same));
        atomicAdd(row + kCountWarps, 1ull);
      }
    }
    // a warp-step mixes bounces: its spans go to bounce 0's row
    if (path_step<TRI, COUNT>(a, p, tab, q, g, bounce, counters, counters)
        == kGoesOn)
      ++bounce;
    else
      g = -1;
  }
}

// ---- kNoTris: one thread a ray -------------------------------------------

// Ray g's whole path, its rows written; a thread past the rays does
// nothing.  The counting instance returns the bounces the ray was live in
// (bit b: bounce b).
template <int TRI, bool COUNT>
__device__ __forceinline__ unsigned trace_one(
    const TraceArgs& a, const TraceParams& p, int g, const Tables& tab,
    unsigned long long* __restrict__ counters) {
  if (g >= p.n_rays) return 0;
  unsigned seen = 0;
  const long long t_gen = span_start<COUNT>();
  Path q = path_start(p, g);
  span_end<COUNT>(counters, kCountCyclesGen, t_gen);
  for (int bounce = 0; bounce < p.num_bounces; ++bounce) {
    unsigned long long* cnt =
        COUNT ? counters + (size_t)bounce * kCounters : nullptr;
    if constexpr (COUNT) {
      // the lanes still in the loop; the kernel counts the warps from
      // `seen`
      const unsigned m = __activemask();
      if ((threadIdx.x & 31) == __ffs(m) - 1)
        atomicAdd(cnt + kCountLive, (unsigned long long)__popc(m));
      seen |= 1u << bounce;
    }
    if (path_step<TRI, COUNT>(a, p, tab, q, g, bounce, cnt, counters)
        != kGoesOn)
      break;
  }
  return seen;
}

template <int TRI, bool COUNT = false>
__global__ void __launch_bounds__(SRT_TRACE_BLOCK_OF(TRI))
trace_kernel(const TraceArgs a, const TraceParams p,
             unsigned long long* __restrict__ counters) {
  constexpr bool kWalk = TRI == kClusteredTris;
  extern __shared__ __align__(128) float4 s_dyn[];
  // kClusteredTris: the warps' rings (16-byte aligned for the bulk copies)
  // and barriers come first
  float4* s_ring = s_dyn;
  uint64_t* s_bars = reinterpret_cast<uint64_t*>(s_dyn + kRingFloat4s);
  float* s_sph = kWalk ? reinterpret_cast<float*>(
                             reinterpret_cast<char*>(s_dyn) + kWalkBytes)
                       : reinterpret_cast<float*>(s_dyn);
  float* s_pln = s_sph + 8 * p.n_spheres;
  float* s_mat = s_pln + 8 * p.n_planes;
  float* s_tri = s_mat + 16 * p.n_materials;   // kSmallTris
  // the walk stages every sphere and plane row; the path variants only
  // the active rows of the sphere, plane and triangle tables (warp 0)
  __shared__ int s_rows[3];
  if constexpr (kWalk) {
    for (int k = threadIdx.x; k < 8 * p.n_spheres; k += blockDim.x)
      s_sph[k] = a.sph[k];
    for (int k = threadIdx.x; k < 8 * p.n_planes; k += blockDim.x)
      s_pln[k] = a.pln[k];
  } else if (threadIdx.x < 32) {
    const int n_sph = stage_active(s_sph, a.sph, p.n_spheres, 8, 5);
    const int n_pln = stage_active(s_pln, a.pln, p.n_planes, 8, 7);
    const int n_tri = TRI == kSmallTris
                          ? stage_active(s_tri, a.tri, p.n_tris, kTriCols, 19)
                          : 0;
    if (threadIdx.x == 0) {
      s_rows[0] = n_sph;
      s_rows[1] = n_pln;
      s_rows[2] = n_tri;
    }
  }
  for (int k = threadIdx.x; k < 16 * p.n_materials; k += blockDim.x)
    s_mat[k] = a.mat[k];
  // the counting instance's counters, added up in shared memory and then
  // into `counters` once a block, and its longest warp
  __shared__ unsigned long long s_cnt[COUNT ? kCountBounces * kCounters : 1];
  __shared__ unsigned long long s_longest;
  if constexpr (COUNT) {
    for (int k = threadIdx.x; k < kCountBounces * kCounters; k += blockDim.x)
      s_cnt[k] = 0;
    if (threadIdx.x == 0) s_longest = 0;
  }
  if constexpr (kWalk) {
    if (threadIdx.x < kWalkWarps * kStages) bar_init(s_bars + threadIdx.x);
    bar_init_fence();
  }
  __syncthreads();

  const Tables tab = {s_sph, s_pln, s_mat, s_tri, kWalk ? 0 : s_rows[0],
                      kWalk ? 0 : s_rows[1], kWalk ? 0 : s_rows[2]};
  const long long t_start = COUNT ? clock64() : 0;
  unsigned seen = 0;
  // every lane of the block stays to the end: the walk and the refills
  // are the warp's
  if constexpr (kWalk) {
    const int warp = threadIdx.x >> 5;
    Ring ring;
    trace_walk<COUNT>(a, p, blockIdx.x * blockDim.x + threadIdx.x, s_sph,
                      s_pln, s_mat,
                      s_ring + (size_t)warp * kStages * kChunk * kRowF4,
                      s_bars + warp * kStages, ring,
                      COUNT ? s_cnt : nullptr);
  } else if constexpr (kPersistent<TRI>) {
    trace_paths<TRI, COUNT>(a, p, tab, COUNT ? s_cnt : nullptr);
  } else {
    seen = trace_one<TRI, COUNT>(a, p, blockIdx.x * blockDim.x + threadIdx.x,
                                 tab, COUNT ? s_cnt : nullptr);
  }
  if constexpr (COUNT) {
    // the warps with a live lane, per bounce (one thread a ray); the
    // warp's life, and the block's: its warps hold their SM slots until
    // its longest warp ends
    __syncwarp();
    const unsigned long long life = clock64() - t_start;
    const unsigned bounces = __reduce_or_sync(kAll, seen);
    if ((threadIdx.x & 31) == 0) {
      for (unsigned b = bounces; b; b &= b - 1)
        atomicAdd(s_cnt + (__ffs(b) - 1) * kCounters + kCountWarps, 1ull);
      atomicAdd(s_cnt + kCountCyclesWarp, life);
      atomicMax(&s_longest, life);
    }
    __syncthreads();
    if (threadIdx.x == 0)
      s_cnt[kCountCyclesBlock] += s_longest * (blockDim.x / 32);
    __syncthreads();
    for (int k = threadIdx.x; k < p.num_bounces * kCounters; k += blockDim.x)
      if (s_cnt[k]) atomicAdd(counters + k, s_cnt[k]);
  }
}

// the dynamic shared memory of a launch: the walk's rings and barriers
// (kClusteredTris), then the tables
size_t shared_bytes(const TraceParams& p) {
  size_t words = 8 * (size_t)p.n_spheres + 8 * (size_t)p.n_planes
                 + 16 * (size_t)p.n_materials;
  if (p.tri_mode == kSmallTris) words += kTriCols * (size_t)p.n_tris;
  return sizeof(float) * words
         + (p.tri_mode == kClusteredTris ? kWalkBytes : 0);
}

// the blocks of one instance an SM holds at once
template <int TRI, bool COUNT>
cudaError_t occupancy(int shared, int* blocks) {
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_kernel<TRI, COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, trace_kernel<TRI, COUNT>, SRT_TRACE_BLOCK_OF(TRI), shared);
}

// the devices a process may launch on (triangle_kernel.cu's bound)
constexpr int kMaxDevices = 64;

// the blocks of an instance that a device's SMs hold at once with
// `shared` bytes of dynamic shared memory: cached per device (for the last
// size asked there) under a lock, so that launches on several devices, from
// one host thread or several, neither race nor recompute it in turn
template <int TRI, bool COUNT>
cudaError_t resident_blocks(int shared, int* blocks) {
  struct Entry {
    int shared = -1, blocks = 0;
  };
  static Entry cache[kMaxDevices];
  static std::mutex lock;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> guard(lock);
  Entry& c = cache[dev];
  if (c.shared != shared) {
    int per_sm = 0, sms = 0;
    e = occupancy<TRI, COUNT>(shared, &per_sm);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    c.shared = shared;
    c.blocks = per_sm * sms;
  }
  *blocks = c.blocks;
  return cudaSuccess;
}

// launch one variant, opting in to more than the default dynamic shared
// memory when its tables need it
template <int TRI, bool COUNT = false>
cudaError_t launch_variant(cudaStream_t st, const TraceArgs& a,
                           const TraceParams& p,
                           unsigned long long* counters = nullptr) {
  constexpr int block = SRT_TRACE_BLOCK_OF(TRI);
  int blocks = (p.n_rays + block - 1) / block;
  const size_t bytes = shared_bytes(p);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trace_kernel<TRI, COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
  }
  if constexpr (kPersistent<TRI>) {
    // the persistent grid: the blocks the SMs hold at once, at most one a
    // block of paths; the launch's counter starts at 0
    if (a.next_path == nullptr) return cudaErrorInvalidValue;
    int resident = 0;
    cudaError_t e = resident_blocks<TRI, COUNT>((int)bytes, &resident);
    if (e == cudaSuccess)
      e = cudaMemsetAsync(a.next_path, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return e;
    blocks = min(blocks, max(resident, 1));
  }
  trace_kernel<TRI, COUNT><<<blocks, block, bytes, st>>>(a, p, counters);
  return cudaGetLastError();
}

// a kClusteredTris launch's tables and parameters, as the walk reads them
bool clustered_ok(const TraceArgs& a, const TraceParams& p) {
  return a.tri != nullptr && a.staged != nullptr && a.boxes != nullptr
         && a.supers != nullptr && a.groups != nullptr
         && reinterpret_cast<uintptr_t>(a.staged) % 16 == 0
         && p.cluster_k > 0 && p.n_clusters > 0 && p.n_groups > 0
         && p.n_clusters <= p.n_groups * kGroup * kSuper;
}

}  // namespace

// The version of this C interface (ops/cuda/trace_kernel.py: INTERFACE),
// raised whenever an argument or TraceParams changes, so a caller can tell
// which interface a build has (ops/cuda/build.py: interface).
extern "C" int srt_trace_interface() { return 2; }

// One launch on the stream.  Tables: (n, 8) spheres and planes, (n, 16)
// materials; tri: the (n_tris, 20) triangle rows (kSmallTris) or the
// (C * K, 20) slot table (kClusteredTris); kClusteredTris also takes the
// staged MT rows ((C * K, 12) f32, 16-byte aligned), the cluster boxes
// padded to whole groups ((n_groups * 256, 8)), the supers and the groups;
// out: (3 or 9, n_rays) f32; next_path: kSmallTris's counter, one 4-byte
// word of the device that no other launch uses while this one runs (the
// launch zeroes it on its stream; other variants take null).
extern "C" int srt_trace_launch(const float* sph, const float* pln,
                                const float* mat, const float* tri,
                                const float* staged, const float* boxes,
                                const float* supers, const float* groups,
                                float* out, unsigned* next_path,
                                TraceParams p, void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  const TraceArgs a = {sph, pln, mat, tri,
                       reinterpret_cast<const float4*>(staged), boxes, supers,
                       groups, out, next_path};
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.tri_mode) {
    case kNoTris:
      return (int)launch_variant<kNoTris>(st, a, p);
    case kSmallTris:
      return (int)launch_variant<kSmallTris>(st, a, p);
    case kClusteredTris:
      if (!clustered_ok(a, p)) return (int)cudaErrorInvalidValue;
      return (int)launch_variant<kClusteredTris>(st, a, p);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The counting instance of a variant: the same launch, which also adds
// what it did to counters ((num_bounces, kCounters) int64, Count; at most
// kCountBounces bounces); chip_smoke.py's only
extern "C" int srt_trace_count_launch(const float* sph, const float* pln,
                                      const float* mat, const float* tri,
                                      const float* staged, const float* boxes,
                                      const float* supers,
                                      const float* groups, float* out,
                                      unsigned* next_path,
                                      unsigned long long* counters,
                                      TraceParams p, void* stream) {
  const TraceArgs a = {sph, pln, mat, tri,
                       reinterpret_cast<const float4*>(staged), boxes, supers,
                       groups, out, next_path};
  if (counters == nullptr || p.num_bounces > kCountBounces)
    return (int)cudaErrorInvalidValue;
  if (p.n_rays <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.tri_mode) {
    case kNoTris:
      return (int)launch_variant<kNoTris, true>(st, a, p, counters);
    case kSmallTris:
      return (int)launch_variant<kSmallTris, true>(st, a, p, counters);
    case kClusteredTris:
      if (!clustered_ok(a, p)) return (int)cudaErrorInvalidValue;
      return (int)launch_variant<kClusteredTris, true>(st, a, p, counters);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The blocks of a variant's route (counting: 0) or counting instance (1)
// that one SM holds at once with `shared` bytes of dynamic shared memory
// (the occupancy chip_smoke.py reports)
extern "C" int srt_trace_occupancy(int tri_mode, int counting, int shared,
                                   int* blocks) {
  switch (tri_mode * 2 + (counting != 0)) {
    case 0: return (int)occupancy<kNoTris, false>(shared, blocks);
    case 1: return (int)occupancy<kNoTris, true>(shared, blocks);
    case 2: return (int)occupancy<kSmallTris, false>(shared, blocks);
    case 3: return (int)occupancy<kSmallTris, true>(shared, blocks);
    case 4: return (int)occupancy<kClusteredTris, false>(shared, blocks);
    case 5: return (int)occupancy<kClusteredTris, true>(shared, blocks);
    default: return (int)cudaErrorInvalidValue;
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
