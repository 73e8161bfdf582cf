// BVH nearest-hit kernel for Hopper (sm_90a): the per-bounce paths'
// triangle intersection.
//
// Replaces three TPU kernels of simple_raytracer_tpu/ops/pallas/
// bvh_kernel.py, as three variants of one kernel (Variant):
//   - kFlat (bvh_kernel.py:201 _kernel, tables of at most 8192 slots,
//     configs 4 and 5 under tri_backend="bvh"): on the TPU the clusters in
//     front-to-back order, each box slab-tested against the ray's live best
//     t (_reslab_flag), then Moller-Trumbore over the cluster's K slots;
//   - kTwoLevel (bvh_kernel.py:1040 _kernel_packed, config 6, a table the
//     TPU keeps resident): the groups of 16 supers in front-to-back order,
//     each group box, then each of its 16 super boxes, then each of their
//     16 cluster boxes slab-tested against the live best t, then MT over
//     the admitted cluster's slots;
//   - kStreamed (bvh_kernel.py:678 _kernel_hbm, config 7 and
//     tri_backend="clustered", a table the TPU streams from HBM): the same
//     gates and MT.
// All three launch one warp walk (below), down the hierarchy of groups,
// supers and clusters; the three names keep the TPU's routes and the
// kernels they replace.  kTwoLevel and kStreamed have a second, Plucker
// form (PLUCKER, params.plucker; bvh_kernel.py:629 _mt_update_sub_mxu and
// :582 _plucker_lt, row 5a, SRT_BVH_MT=plucker): the same predicate from the
// slot's 20 Plucker coefficients (ops/bvh.py: plucker_table, built once
// per scene; the TPU builds LT per visited cluster) dotted with the ray's
// [d, m = o x d, o, 1]: u*a and v*a over [d, m], a over d, t*a over
// [o, 1], each a dot product in that index order over the nonzero
// coefficients, then f = 1/a and the same tests and commit.  A row of
// the coefficient table: [w2, e2 | -w1, -e1 | -n | n, -pd | active] with
// n = e1 x e2, w1 = v0 x e1, w2 = v0 x e2, pd = n . v0 (80 bytes, five
// float4s).  The TPU evaluates the dot products on its MXU; here they are
// FP32 on the CUDA cores, in the plain version's order (no tensor cores:
// TF32 keeps too few bits for the t and u/v tests).
// kTwoLevel and kStreamed also have a sub-box form (SUBBOX,
// params.sub_rows > 0; bvh_kernel.py:437 _subbox_word and :474
// _mt_gated_sub, SRT_BVH_SUBBOX, MT form only): the per-cluster table of
// sub-boxes (ops/bvh.py: coarsen_sub_aabb, 8 rows of 32 bytes a cluster,
// its first div = k / sub_rows the boxes of slot ranges [j * sub_rows,
// (j + 1) * sub_rows)) adds a fourth gate inside the cluster.  The words
// decide which chunks are copied at all (a cluster no lane's word wants is
// never copied, nor a chunk of it without a wanted range), so they must
// be known before a cluster's first copy.  Made one cluster at a time
// where the walk finds it, from __ldg loads, they would put a dependent
// trip to L2 and eight slab tests between finding each cluster and issuing
// its copy (PERF.md section 6).  So they are made a super at a time
// (super_words): when the walk takes a super, one lane issues one 1-D
// bulk copy of its 16 clusters' sub-box rows (4 KB, contiguous in the
// table; the last super's copy clamped to the table's end) into the
// warp's own shared buffer, on an mbarrier of its own, and the copy runs
// under the slab tests of the super's 16 cluster boxes.  Then the warp
// makes each lane's words of the clusters it admits, from shared memory,
// with the lane's best t of that moment (at least its t when the cluster
// is found later, so the gate admits at least what a word made there
// would): the lanes share the slab tests, 32 (lane, cluster, sub-box)
// tests a step from a list of the warp's (lane, cluster) pairs, so a
// sparse bounce's few pairs cost the warp a step or two, not 8 slab tests
// for each cluster some lane admits.  Each lane keeps its words 8 bits a
// cluster in four 32-bit registers, with the warp's union per cluster
// beside them; clusters no lane wants leave the walk there.
// Finding a cluster then reads its word, its skip and its chunks' skips
// from registers: no load stands before its copy.  The buffer's phase
// follows the supers taken; a super whose clusters no lane admits leaves
// its copy to be waited for before the next one.  At a chunk's turn a
// lane runs MT only if its word wants a range of the chunk, and only over
// the slots of its ranges: each admitting lane over the ranges some
// admitting lane wants, or, split pair by pair, each admitting ray's
// wanted slots 32 at a time (its word shuffled with the ray).  The TPU ORs
// a sub-box's slab over a 128-ray sub-block; here each ray keeps its own,
// as it does every other gate.  kFlat (_kernel) has no sub-box form.  The
// form is off by default, as in the JAX package; PERF.md section 6 holds
// its times against the ungated walk's.
// For each ray in its list it finds the nearest triangle strictly closer
// than the ray's t_init and writes (t, table slot), or (+inf, -1) when none
// is; a dead ray (alive == 0) is a miss.  Shading is not here: the
// wrapper's caller gathers the winner's table row at its slot.
//
// One launch (srt_bvh_launch) is a few kernels on the stream, nothing read
// back to the host:
//   1. ray_partials and rank_boxes: the visiting order, the boxes by
//      ascending squared distance of their centers from the mean live-ray
//      origin (ops/bvh.py: front_to_back; the order changes no result),
//      descending under BvhOptions.reverse (SRT_BVH_ORDER=rev), which never
//      reverses the admission boxes' rank;
//   2. with admission boxes, the ray compaction (the plain version is
//      ops/bvh.py: compact_order, which admits the same rays;
//      tests/test_torch_bvh_streamed.py: compact_buckets transcribes these
//      kernels): bucket_rays gives each live ray the bucket 8 x (rank of
//      the first admission box it may meet before its t_init) + its
//      direction octant, or the last bucket, and counts the buckets;
//      scan_buckets places them; scatter_rays writes each ray to its
//      bucket's next place (any order within a bucket) and leaves the
//      admitted rays first, their count in device memory.  Under the
//      Morton key (BvhOptions.morton, SRT_BVH_COMPACT_KEY=morton) the
//      launch takes perm and count as given: srt_bvh_morton_keys wrote
//      each ray's packed key and the count before it (morton_keys), and
//      the caller sorted the keys (ops/cuda/bvh_kernel.py; the JAX
//      package's lax.sort), since the key's 2^(31 - index bits) buckets
//      outgrow a counting sort's shared memory;
//   3. the walk over the ray list: lane i takes ray perm[i] (or ray i), a
//      lane at or past the count writes a miss.  Every result goes to its
//      own ray's place in the output.
//
// The TPU gates a cluster for a 128-ray sub-block and reads a packed table
// through one-hot MXU transposes; here each ray keeps its own gates and its
// result does not depend on its neighbours.  The global triangle index of
// each slot comes as an int32 (it never rides in an f32 value) and decides
// exact ties: the least (t, index) wins, seeded with (t_init, -1), so the
// visiting order never changes a result (_mt_update's commit).  Every
// index product is taken in size_t or stays below 2^31: at config 7,
// 1,409,024 slots x 20 columns is 28.2M words.
//
// The warp walk (every variant), designed for this card.  One
// thread a ray walking alone leaves a warp running the union of its lanes'
// clusters with most lanes masked off, each gate one dependent load and
// each cluster a chain of K dependent MT steps; a secondary bounce walks
// only 2-45 thousand rays (60-1,400 warps on 132 SMs), so what costs is
// (a) issuing MT for lanes that did not admit a cluster, (b) the chains of
// dependent loads and (c) for kStreamed, config 7's table (1,409,024
// slots, 112.7 MB) beyond the 50 MB L2.  The warp walks the gates together
// (a gate passes when any lane admits it; each lane keeps its own gates),
// tests a level's boxes as one batch when it enters their parent
// (next_item: 16 groups of the order, a group's 16 supers, a super's 16
// clusters, all loads issued at once), and
//   - feeds MT a cluster kChunk slots at a time from a per-scene table of
//     exactly the bytes MT reads (ops/bvh.py: stage_slots: v0 and the
//     index, e1 and active, e2, 48 bytes a slot; the Plucker form its
//     80-byte coefficient rows), each chunk one 1-D bulk copy (TMA) into
//     one of the warp's two shared buffers, on an mbarrier whose wait
//     traps if it outlasts kSpinLimit polls; the next chunk is found and
//     its copy issued before the current chunk's MT, so the copy runs
//     under it (the lookahead gates with the t from before that MT, which
//     admits at least what the walk would; each lane tests the box again
//     at the chunk's turn).  kTwoLevel's table stays in L2 (config 6:
//     98,304 slots, 4.7 MB, or 7.9 MB of Plucker coefficients), and so
//     do kFlat's (configs 4 and 5: 2,048 and 4,096 slots, 0.1 and 0.2
//     MB), and MT could read each chunk's rows where they lie instead,
//     but the sweep (PERF.md section 6) found that 13-20% (MT) and 24-44%
//     (Plucker) slower a pass than the ring on config 6 and 11-14% slower
//     on configs 4 and 5, whose copy runs ahead of the MT steps that read
//     it.  So every variant takes the ring, with the same constants (each
//     variant's best split point and ring within the spread of its own
//     turns), and kFlat walks the hierarchy too (one group of 16 supers,
//     2 to 4 of them real): its clusters in front-to-back order without
//     the hierarchy, 16 gates a batch, were 1-12% slower (PERF.md names
//     the commit whose source builds both layouts);
//   - splits MT pair by pair when few lanes admit a chunk (at most
//     kSplitMax): for each admitting ray in turn the 32 lanes test every
//     32nd slot with that ray (neighbouring lanes on neighbouring rows)
//     and merge their least (t, index) by a warp minimum over one 64-bit
//     key, which the ray's lane commits.  When more lanes admit, each
//     admitting lane tests every slot, all reading one address.
// Shared memory of the ring: 2 buffers x kChunk slots x 48 (80) bytes a
// warp, 24 KB (40 KB) a block of 4 warps in the MT (Plucker) form, and in
// the sub-box form a warp's 4 KB super block and 1 KB pair list more,
// 44 KB.
//
// Bound on the H100 (chip_smoke.py): counted from what a launch's walked
// rays open, the clusters whose box they may meet before their result t:
// the MT tests of those clusters' real slots (46 FLOP a pair, the Plucker
// form 38 and 9 a walked ray for m) and the root boxes' slab tests of
// every walked ray; a live ray's o, d and t_init read once, every ray's
// alive flag read and (t, slot) written once, and the opened clusters' 44
// bytes a slot once in either form.
//
// Arithmetic: built with --fmad=false and no fast math, in the operation
// order of the plain version (ops/bvh.py: slab_maybe, _mt, _mt_plucker),
// so it gives the plain version's bits.  min/max propagate NaN, as
// torch.minimum does, so a NaN slab (0 * inf on a box plane) admits the
// box.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

struct BvhParams {
  int32_t n_rays;       // rays: the grid
  int32_t n_order;      // boxes of the visiting order: the groups
  int32_t n_clusters;   // clusters of the slot table
  int32_t k;            // slots per cluster
  int32_t variant;      // Variant
  int32_t plucker;      // 1: the Plucker form (not kFlat)
  int32_t n_admission;  // admission boxes of the ray compaction; 0: none
  int32_t alive_u8;     // 1: alive is one byte a ray (bool), 0: f32
  int32_t sub_rows;     // slots a sub-box bounds (the sub-box form: not
                        // kFlat, not PLUCKER); 0: no sub-box gate
};

// The launch's opt-in switches, beside BvhParams (which the walk takes, so
// they leave its code as it was); both 0 by default
struct BvhOptions {
  int32_t reverse;      // 1: the visiting order back to front
  int32_t morton;       // 1: the compaction's Morton key (perm and count
                        // given: srt_bvh_morton_keys and the caller's sort)
};

enum Variant { kFlat = 0, kTwoLevel = 1, kStreamed = 2 };

// the rays of a launch, one (R,) array each
struct RayIn {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* t_init;
  const void* alive;   // bytes (BvhParams.alive_u8) or f32
};

namespace {

constexpr int kBlock = 128;
constexpr int kSuper = 16;   // clusters per super (ops/bvh.py: SUPER)
constexpr int kGroup = 16;   // supers per group (ops/bvh.py: GROUP)
constexpr int kWarps = kBlock / 32;
constexpr unsigned kAll = 0xffffffffu;
// a slot's Plucker coefficients (ops/bvh.py: PLUCKER_COLS)
constexpr int kPluckerCols = 20;
// the warp walk's rows, in float4s a slot: the MT table (ops/bvh.py:
// staged_slots, STAGED_COLS = 12: v0 and the global index's bits, e1 and
// active, e2 and 0) or the Plucker coefficients
constexpr int kMtRowF4 = 3;
constexpr int kPluckerRowF4 = kPluckerCols / 4;
// The warp walk's constants, chosen by chip_smoke.py's sweep on the card
// (PERF.md section 6; a -D flag of the same name sets each for the
// sweep): the slots of a chunk, the warp's ring of chunk buffers, and the
// most lanes admitting a chunk for which the warp splits each admitting
// ray's MT across its lanes (above it each admitting lane tests every slot
// itself).
#ifndef SRT_BVH_CHUNK
#define SRT_BVH_CHUNK 64
#endif
#ifndef SRT_BVH_STAGES
#define SRT_BVH_STAGES 2
#endif
#ifndef SRT_BVH_SPLIT_MAX
#define SRT_BVH_SPLIT_MAX 16
#endif
constexpr int kChunk = SRT_BVH_CHUNK;
constexpr int kStages = SRT_BVH_STAGES;
constexpr int kSplitMax = SRT_BVH_SPLIT_MAX;
// the ring's parities are the bits of one word; any depth from 2 works
// (SRT_BVH_DMA_SLOTS builds one of its own: ops/cuda/bvh_kernel.py)
static_assert(kStages >= 2 && kStages <= 32, "the ring holds 2 to 32 chunks");
// the ray compaction and the visiting orders (ops/bvh.py: ADMISSION_MAX;
// ops/cuda/bvh_kernel.py: RANK_MAX)
constexpr int kAdmissionMax = 256;
constexpr int kBuckets = 8 * kAdmissionMax + 1;
constexpr int kRankMax = 8192;
constexpr int kThreads = 256;      // the compaction kernels' blocks
constexpr int kPartials = 512;     // ray_partials' blocks, at most

// The counting instance of each walk (srt_bvh_count_launch, which only
// chip_smoke.py calls; the route never launches it): what the walk did,
// summed over the launch's warps into (kCounters,) int64 counters.
enum Count {
  kCountWalked = 0,    // rays walked (listed lanes)
  kCountStagings,      // (warp, cluster) visits that ran MT
  kCountChunks,        // chunk copies
  kCountSlots,         // slots copied
  kCountPairs,         // (ray, cluster) pairs that ran MT
  kCountMtSteps,       // warp-wide MT steps issued (32 lanes x one slot)
  kCountGroupTests,    // warp-wide slab tests of groups
  kCountSuperTests,    // of supers
  kCountClusterTests,  // of clusters
  kCountSplit,         // chunks whose MT the lanes split pair by pair
  kCountWasted,        // chunks copied that no lane admitted at their turn
  kCountWarps,         // warps that walked (some lane listed)
  kCountBoxTests,      // slab tests of walking lanes (each box whose parent
                       // the lane admitted, and each chunk's re-test)
  kCountSubTests,      // sub-box slab tests of lanes admitting a cluster
  kCountSubSkipped,    // clusters admitted that no lane's sub-box word wanted
  kCountChunksSkipped, // chunks of found clusters that held no wanted range
  kCountWalkCycles,    // SM cycles of the warp's walk (clock64, each warp)
  kCountSubWaitCycles, // of them, waiting for a super's sub-box block
  kCountSubWordCycles, // and making a super's words (slabs, packing, votes)
  kCountHist,          // visits by admitting lanes: 1, 2, 3-4, 5-8,
                       // 9-16, 17-24, 25-31, 32
  kCounters = kCountHist + 8
};

// the histogram bin of a staging that n lanes admit (1 <= n <= 32)
__device__ __forceinline__ int hist_bin(int n) {
  return n <= 2 ? n - 1 : n <= 4 ? 2 : n <= 8 ? 3 : n <= 16 ? 4
         : n <= 24 ? 5 : n < 32 ? 6 : 7;
}

// a warp's counts, kept alike by every lane (every count is warp-uniform)
// and added to the launch's counters by lane 0 at the end of the walk
template <bool COUNT>
struct WarpCounts {
  __device__ __forceinline__ void add(int, unsigned long long) {}
  __device__ __forceinline__ void add_lanes(int, unsigned) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

template <>
struct WarpCounts<true> {
  unsigned long long v[kCounters] = {};
  __device__ __forceinline__ void add(int i, unsigned long long n) {
    v[i] += n;
  }
  // a count that differs by lane: the warp's sum (called by every lane)
  __device__ __forceinline__ void add_lanes(int i, unsigned n) {
    v[i] += __reduce_add_sync(kAll, n);
  }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if ((threadIdx.x & 31) == 0)
      for (int i = 0; i < kCounters; ++i)
        if (v[i]) atomicAdd(out + i, v[i]);
  }
};

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

__device__ __forceinline__ bool ray_alive(const RayIn& in, int i, int u8) {
  return u8 ? static_cast<const uint8_t*>(in.alive)[i] != 0
            : static_cast<const float*>(in.alive)[i] > 0.0f;
}

// may the ray meet the box [lo, hi] before t_far?  (_visit_prepass's slab
// test)
__device__ __forceinline__ bool slab6(float lx, float ly, float lz,
                                      float hx, float hy, float hz,
                                      const Ray& r, float t_far) {
  const float t1x = (lx - r.ox) * r.inx;
  const float t2x = (hx - r.ox) * r.inx;
  const float t1y = (ly - r.oy) * r.iny;
  const float t2y = (hy - r.oy) * r.iny;
  const float t1z = (lz - r.oz) * r.inz;
  const float t2z = (hz - r.oz) * r.inz;
  const float near = max_nan(max_nan(min_nan(t1x, t2x), min_nan(t1y, t2y)),
                             max_nan(min_nan(t1z, t2z), 0.0f));
  const float far = min_nan(min_nan(max_nan(t1x, t2x), max_nan(t1y, t2y)),
                            min_nan(max_nan(t1z, t2z), t_far));
  return !((near > far) || (near >= 1.0e38f));
}

// the slab test of box row b (8 floats: lo, hi, 0, 0) in device memory
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float t_far) {
  return slab6(__ldg(b + 0), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3),
               __ldg(b + 4), __ldg(b + 5), r, t_far);
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

// Moller-Trumbore against one slot (v0, e1, e2, active): is it a valid
// hit, at t?
__device__ __forceinline__ bool mt_hit(float v0x, float v0y, float v0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       float active, const Ray& r,
                                       float& t) {
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
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  return a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
         && t > 0.0f && active > 0.0f;
}

// The Plucker form against one slot, from its kPluckerCols coefficients q
// (_mt_update_sub_mxu: the dot products in the ray vector's index order)
__device__ __forceinline__ bool plucker_hit(const float* q, const Ray& r,
                                            float& t) {
  const float unum = q[0] * r.dx + q[1] * r.dy + q[2] * r.dz + q[3] * r.mx
                     + q[4] * r.my + q[5] * r.mz;
  const float vnum = q[6] * r.dx + q[7] * r.dy + q[8] * r.dz + q[9] * r.mx
                     + q[10] * r.my + q[11] * r.mz;
  const float a = q[12] * r.dx + q[13] * r.dy + q[14] * r.dz;
  const float tnum = q[15] * r.ox + q[16] * r.oy + q[17] * r.oz + q[18];
  const float f = 1.0f / a;
  const float u = f * unum;
  const float v = f * vnum;
  t = f * tnum;
  return a != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f
         && t > 0.0f && q[19] > 0.0f;
}

// ---- the ray compaction and the visiting orders, before the walk ----

// Per block, the sums over its rays (a grid-stride loop) of o * w and of w
// (w: alive as 0 or 1): the mean live-ray origin's parts, summed again in
// a fixed order by rank_boxes, so every block of it gets the same origin.
__global__ void __launch_bounds__(kThreads)
ray_partials(const RayIn in, const BvhParams p, float4* __restrict__ part) {
  __shared__ float4 s_sum[kThreads];
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.n_rays;
       i += gridDim.x * kThreads) {
    if (ray_alive(in, i, p.alive_u8)) {
      acc.x += in.ox[i];
      acc.y += in.oy[i];
      acc.z += in.oz[i];
      acc.w += 1.0f;
    }
  }
  s_sum[threadIdx.x] = acc;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) {
      const float4 b = s_sum[threadIdx.x + h];
      float4& a = s_sum[threadIdx.x];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) part[blockIdx.x] = s_sum[0];
}

// the squared distance of box row b's center from the origin, negated
// under `neg` (front_to_back's key, reversed); a NaN sorts last, as +inf
// does
__device__ __forceinline__ float center_d2(const float* __restrict__ b,
                                           const float* o, bool neg) {
  const float cx = (__ldg(b + 0) + __ldg(b + 3)) * 0.5f - o[0];
  const float cy = (__ldg(b + 1) + __ldg(b + 4)) * 0.5f - o[1];
  const float cz = (__ldg(b + 2) + __ldg(b + 5)) * 0.5f - o[2];
  const float d2 = cx * cx + cy * cy + cz * cz;
  const float key = neg ? -d2 : d2;
  return is_nan(key) ? INFINITY : key;
}

// The visiting order of the visit boxes (the groups) and the admission
// boxes in their front-to-back rank (ops/bvh.py: front_to_back: ascending
// squared distance of the centers from the mean live-ray origin, ties by
// index; the visit boxes descending under `reverse`, the admission boxes
// never): thread t < n_visit places visit box t, the next n_admission
// threads admission box t - n_visit.
__global__ void __launch_bounds__(kThreads)
rank_boxes(const float4* __restrict__ part, const int n_part,
           const float* __restrict__ visit, const int n_visit,
           const float* __restrict__ adm, const int n_adm, const bool reverse,
           int32_t* __restrict__ visit_order,
           int32_t* __restrict__ adm_order) {
  __shared__ float s_d2[kRankMax + kAdmissionMax];
  __shared__ float s_origin[3];
  if (threadIdx.x < 32) {
    // warp 0: the partial sums, in a fixed order
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = threadIdx.x; j < n_part; j += 32) {
      const float4 b = part[j];
      acc.x += b.x;
      acc.y += b.y;
      acc.z += b.z;
      acc.w += b.w;
    }
    for (int off = 16; off > 0; off >>= 1) {
      acc.x += __shfl_xor_sync(kAll, acc.x, off);
      acc.y += __shfl_xor_sync(kAll, acc.y, off);
      acc.z += __shfl_xor_sync(kAll, acc.z, off);
      acc.w += __shfl_xor_sync(kAll, acc.w, off);
    }
    if (threadIdx.x == 0) {
      const float w = fmaxf(acc.w, 1.0f);
      s_origin[0] = acc.x / w;
      s_origin[1] = acc.y / w;
      s_origin[2] = acc.z / w;
    }
  }
  __syncthreads();
  const int n_all = n_visit + n_adm;
  for (int j = threadIdx.x; j < n_all; j += kThreads)
    s_d2[j] = j < n_visit ? center_d2(visit + 8 * j, s_origin, reverse)
                          : center_d2(adm + 8 * (j - n_visit), s_origin,
                                      false);
  __syncthreads();
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n_all) return;
  const int lo = t < n_visit ? 0 : n_visit;
  const int hi = t < n_visit ? n_visit : n_all;
  const float d = s_d2[t];
  int rank = 0;
  for (int j = lo; j < hi; ++j) {
    const float e = s_d2[j];
    rank += (e < d) || (e == d && j < t);
  }
  if (t < n_visit)
    visit_order[rank] = t;
  else
    adm_order[rank] = t - n_visit;
}

// Each ray's bucket: 8 x the rank of the first admission box (in
// front-to-back order) that the live ray may meet before its t_init, plus
// its direction octant, or kNone = 8 x n_admission when it meets none or
// is dead (tests/test_torch_bvh_streamed.py: compact_buckets); the
// buckets' sizes into counts.
__global__ void __launch_bounds__(kThreads)
bucket_rays(const RayIn in, const BvhParams p, const float* __restrict__ adm,
            const int32_t* __restrict__ adm_order,
            int32_t* __restrict__ bucket, int32_t* __restrict__ counts) {
  __shared__ float s_box[kAdmissionMax * 6];
  __shared__ int32_t s_hist[kBuckets];
  const int n_adm = p.n_admission;
  const int none = 8 * n_adm;
  for (int j = threadIdx.x; j < n_adm * 6; j += kThreads)
    s_box[j] = __ldg(adm + 8 * adm_order[j / 6] + j % 6);
  for (int j = threadIdx.x; j <= none; j += kThreads) s_hist[j] = 0;
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < p.n_rays) {
    int b = none;
    if (ray_alive(in, i, p.alive_u8)) {
      Ray r;
      r.ox = in.ox[i];
      r.oy = in.oy[i];
      r.oz = in.oz[i];
      r.dx = in.dx[i];
      r.dy = in.dy[i];
      r.dz = in.dz[i];
      r.inx = 1.0f / r.dx;
      r.iny = 1.0f / r.dy;
      r.inz = 1.0f / r.dz;
      const float t_far = in.t_init[i];
      for (int j = 0; j < n_adm; ++j) {
        const float* q = s_box + 6 * j;
        if (slab6(q[0], q[1], q[2], q[3], q[4], q[5], r, t_far)) {
          b = 8 * j + (r.dx < 0.0f) * 4 + (r.dy < 0.0f) * 2
              + (r.dz < 0.0f);
          break;
        }
      }
    }
    bucket[i] = b;
    atomicAdd(&s_hist[b], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j <= none; j += kThreads)
    if (s_hist[j]) atomicAdd(&counts[j], s_hist[j]);
}

// One block: the exclusive scan of the bucket sizes into each bucket's
// first place in the order (cursor), and the admitted rays' count, the
// place of kNone.
__global__ void __launch_bounds__(1024)
scan_buckets(const int32_t* __restrict__ counts, const int n_buckets,
             int32_t* __restrict__ cursor, int32_t* __restrict__ count) {
  constexpr int kPer = (kBuckets + 1023) / 1024;
  __shared__ int32_t s_warp[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int own[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = t * kPer + j;
    own[j] = b < n_buckets ? counts[b] : 0;
    sum += own[j];
  }
  int incl = sum;   // the warp's inclusive scan of the threads' sums
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kAll, w, off);
      if (lane >= off) w += v;
    }
    s_warp[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  int at = incl - sum + (warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int b = t * kPer + j;
    if (b < n_buckets) {
      cursor[b] = at;
      if (b == n_buckets - 1) *count = at;
    }
    at += own[j];
  }
}

// Each ray to its place: the next free place of its bucket, taken with one
// atomicAdd per bucket a warp holds (the places within a bucket come in
// any order, which changes no result).
__global__ void __launch_bounds__(kThreads)
scatter_rays(const int32_t* __restrict__ bucket, const int n,
             int32_t* __restrict__ cursor, int32_t* __restrict__ perm) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int b = i < n ? bucket[i] : -1;
  const unsigned peers = __match_any_sync(kAll, b);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && b >= 0) base = atomicAdd(&cursor[b], __popc(peers));
  base = __shfl_sync(kAll, base, leader);
  if (b >= 0) perm[base + __popc(peers & ((1u << lane) - 1u))] = i;
}

// The compaction's Morton key (BvhOptions.morton; ops/bvh.py: compact_order
// with key "morton", morton_cells): each ray's packed key (bucket <<
// idx_bits) | ray, its bucket 8 x the Morton cell of its origin over the
// bounds of the real admission boxes (lo below 1e37) plus its direction
// octant, clamped to the last real bucket, or the last bucket when the ray
// is dead or may meet no admission box before its t_init; the admitted
// rays added to count.  The cell: the 31 - idx_bits - 3 bits split x, y, z
// as (mb + 2) / 3, (mb + 1) / 3, mb / 3, each axis ((v - lo) / span *
// cells) converted with truncation (a saturating conversion, NaN to 0, as
// XLA's) and clipped, the bits interleaved MSB first.
__global__ void __launch_bounds__(kThreads)
morton_keys(const RayIn in, const BvhParams p, const float* __restrict__ adm,
            const int idx_bits, int32_t* __restrict__ keys,
            int32_t* __restrict__ count) {
  __shared__ float s_box[kAdmissionMax * 6];
  __shared__ float s_lo[3], s_span[3];
  const int n_adm = p.n_admission;
  for (int j = threadIdx.x; j < n_adm * 6; j += kThreads)
    s_box[j] = __ldg(adm + 8 * (j / 6) + j % 6);
  __syncthreads();
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float lo = 3.0e38f, hi = -3.0e38f;
    for (int j = 0; j < n_adm; ++j)
      if (s_box[6 * j] < 1.0e37f) {
        lo = fminf(lo, s_box[6 * j + a]);
        hi = fmaxf(hi, s_box[6 * j + 3 + a]);
      }
    s_lo[a] = lo;
    s_span[a] = fmaxf(hi - lo, 1.0e-20f);
  }
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool admitted = false;
  if (i < p.n_rays) {
    Ray r;
    r.ox = in.ox[i];
    r.oy = in.oy[i];
    r.oz = in.oz[i];
    r.dx = in.dx[i];
    r.dy = in.dy[i];
    r.dz = in.dz[i];
    if (ray_alive(in, i, p.alive_u8)) {
      r.inx = 1.0f / r.dx;
      r.iny = 1.0f / r.dy;
      r.inz = 1.0f / r.dz;
      const float t_far = in.t_init[i];
      for (int j = 0; j < n_adm && !admitted; ++j) {
        const float* q = s_box + 6 * j;
        admitted = slab6(q[0], q[1], q[2], q[3], q[4], q[5], r, t_far);
      }
    }
    const int bucket_bits = 31 - idx_bits;
    const unsigned n_buckets = 1u << bucket_bits;
    unsigned bucket = n_buckets - 1u;
    if (admitted) {
      const int mb = bucket_bits - 3;
      const int nb[3] = {(mb + 2) / 3, (mb + 1) / 3, mb / 3};
      const float v[3] = {r.ox, r.oy, r.oz};
      int q[3];
      for (int a = 0; a < 3; ++a) {
        const float cells = (float)(1 << nb[a]);
        const int c = __float2int_rz((v[a] - s_lo[a]) / s_span[a] * cells);
        q[a] = min(max(c, 0), (1 << nb[a]) - 1);
      }
      unsigned cell = 0;
      int pos = mb;
      for (int level = 0; level < nb[0]; ++level)   // nb[0] is the most
        for (int a = 0; a < 3; ++a)
          if (level < nb[a]) {
            --pos;
            cell |= (unsigned)((q[a] >> (nb[a] - 1 - level)) & 1) << pos;
          }
      const unsigned octant = (r.dx < 0.0f) * 4 + (r.dy < 0.0f) * 2
                              + (r.dz < 0.0f);
      bucket = min(cell * 8u + octant, n_buckets - 2u);
    }
    keys[i] = (int32_t)((bucket << idx_bits) | (unsigned)i);
  }
  const int n = __syncthreads_count(admitted);
  if (threadIdx.x == 0 && n) atomicAdd(count, n);
}

// ---- the warp walk (kTwoLevel, kStreamed) ----

// the lane's gates of n consecutive boxes (rows of 8 floats: lo, hi, 0, 0,
// read as two float4s) against t_far, bit i for box i: all loads issued
// together, so a batch costs one trip to memory
template <int N>
__device__ __forceinline__ unsigned slab_mask(const float* __restrict__ b,
                                              const Ray& r, float t_far) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 lo = __ldg(b4 + 2 * i);       // lo.xyz, hi.x
    const float4 hi = __ldg(b4 + 2 * i + 1);   // hi.yz, 0, 0
    m |= (unsigned)slab6(lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, r, t_far) << i;
  }
  return m;
}

// the walk's place: a batch of up to kBatch groups from order[j0], the
// current group g's supers and the current super s's clusters, each as
// this lane's gates (bit i: member i admitted) and the warp's union, less
// the members visited
constexpr int kBatch = 16;
struct Walk {
  int j0 = -kBatch;
  unsigned g_mask = 0, g_any = 0;
  int g = 0;
  unsigned s_mask = 0, s_any = 0;
  int s = 0;
  unsigned c_mask = 0, c_any = 0;
  unsigned sub_any = 0;   // the sub-box form: the warp's union of the
                          // current cluster's words
  // the sub-box form's super block (unused in the other forms): the
  // warp's shared buffer of a super's sub-box rows and its mbarrier, the
  // barrier's next parity and whether a copy on it is not yet waited for,
  // and the current super's words, 8 bits a cluster (bits 8 * (i % 4) of
  // word i / 4 for cluster i), this lane's and the warp's union
  float4* sub_buf = nullptr;
  uint64_t* sub_bar = nullptr;
  uint16_t* sub_pairs = nullptr;   // the word batch's pair list
  uint32_t sub_parity = 0;
  bool sub_pending = false;
  unsigned sub_w[4] = {}, sub_u[4] = {};
};

// one staged chunk: slots [base, base + kChunk) of cluster c (padded
// index), whether this lane admitted the cluster when it was found, and
// in the sub-box form the lane's sub-box word of the cluster and whether
// it is the first chunk of the cluster the warp visits
struct Item {
  int c;
  int base;
  bool ok;
  unsigned word;
  bool first;
};

// the bits of the sub-box ranges (of `rows` slots) that slots [base,
// base + n) of a cluster fall in
__device__ __forceinline__ unsigned chunk_ranges(int base, int n, int rows) {
  const int lo = base / rows;
  const int hi = (base + n - 1) / rows;
  return ((2u << hi) - 1u) & ~((1u << lo) - 1u);
}

// the sub-box form: a cluster's rows in the sub-box table (8 rows of 8
// floats: lo, hi, 0, 0), in float4s, a super's block of them, and the
// word batch's list of (lane, cluster) pairs, 2 bytes each, in float4s
constexpr int kSubClusterF4 = 16;
constexpr int kSubBlockF4 = kSuper * kSubClusterF4;   // 4 KB
constexpr int kSubPairsF4 = 32 * kSuper * 2 / 16;     // 1 KB

// byte i of the packed words v (cluster i of the super)
__device__ __forceinline__ unsigned word_of(const unsigned (&v)[4], int i) {
  const unsigned x = i < 8 ? (i < 4 ? v[0] : v[1]) : (i < 12 ? v[2] : v[3]);
  return (x >> (8 * (i & 3))) & 0xffu;
}

// The first cluster of super s's sub-box block and its clusters: the
// super's 16, clamped to the table's end (a super past it, whose sentinel
// boxes only a NaN ray admits, copies the last cluster's rows), so the
// block's cluster i is min(s * 16 + i, n_clusters - 1) - first, the
// cluster the walk stages for it
__device__ __forceinline__ int2 sub_block(int s, int n_clusters) {
  const int first = min(s * kSuper, n_clusters - 1);
  return make_int2(first, min(kSuper, n_clusters - first));
}

// One lane issues the copy of super s's sub-box block into the warp's
// buffer (after waiting for a copy of an earlier super never waited for:
// every lane is done with the buffer).  Called by the whole warp.
__device__ __forceinline__ void issue_sub_block(
    Walk& w, const float* __restrict__ subboxes, int s, const BvhParams& p) {
  if (w.sub_pending) {
    bar_wait(w.sub_bar, w.sub_parity);
    w.sub_parity ^= 1u;
  }
  const int2 blk = sub_block(s, p.n_clusters);
  __syncwarp();
  if ((threadIdx.x & 31) == 0)
    bulk_load(w.sub_buf,
              reinterpret_cast<const float4*>(subboxes)
                  + (size_t)blk.x * kSubClusterF4,
              static_cast<uint32_t>(blk.y * kSubClusterF4 * 16), w.sub_bar);
  w.sub_pending = true;
}

// The words of super s's admitted clusters (w.c_any), as one batch from
// its block in shared memory: for each cluster a lane admits (w.c_mask),
// bit j when its ray may meet sub-box j (of div) before its t_far
// (_subbox_word's slab, for this ray alone).  The lanes share the slab
// tests: every lane lists its (lane, cluster) pairs in the warp's pair
// list (at its place by a scan of the lanes' counts), then the warp takes
// the list 32 / div pairs a step, lane l sub-box l % div of pair l / div
// with the pair's ray and t_far shuffled from its lane, and one ballot
// gives the step's words, written back over their pairs; each lane then
// reads its own words.  A sparse bounce's few pairs a lane so cost the
// warp about (pairs x div) / 32 steps.  Then the warp's union per
// cluster, and the clusters no lane wants taken out of w.c_any.  Called
// by the whole warp once the block has landed.
template <bool COUNT>
__device__ __forceinline__ void super_words(Walk& w, int s, int div,
                                            const Ray& r, float t_far,
                                            const BvhParams& p,
                                            WarpCounts<COUNT>& cnt) {
  const int lane = threadIdx.x & 31;
  const int first = sub_block(s, p.n_clusters).x;
  const int log_div = __ffs(div) - 1;
  const int per = 32 >> log_div;          // pairs a step
  const int mine = lane >> log_div;       // this lane's pair of a step
  const int j = lane & (div - 1);         // and its sub-box
  const unsigned byte = (1u << div) - 1u;
  uint16_t* pairs = w.sub_pairs;
  // this lane's pairs' place in the list: the scan of the lanes' counts
  const int own = __popc(w.c_mask);
  int end = own;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kAll, end, off);
    if (lane >= off) end += v;
  }
  const int total = __shfl_sync(kAll, end, 31);
  __syncwarp();   // every lane is done with the last super's list
  int at = end - own;
  for (unsigned m = w.c_mask; m; m &= m - 1)
    pairs[at++] = (uint16_t)((lane << 4) | (__ffs(m) - 1));
  __syncwarp();
  for (int p0 = 0; p0 < total; p0 += per) {
    const int k = p0 + mine;
    const int e = k < total ? pairs[k] : 0;
    const int src = e >> 4;
    const int i = e & 15;
    Ray q;
    q.ox = __shfl_sync(kAll, r.ox, src);
    q.oy = __shfl_sync(kAll, r.oy, src);
    q.oz = __shfl_sync(kAll, r.oz, src);
    q.inx = __shfl_sync(kAll, r.inx, src);
    q.iny = __shfl_sync(kAll, r.iny, src);
    q.inz = __shfl_sync(kAll, r.inz, src);
    const float tf = __shfl_sync(kAll, t_far, src);
    const float4* b4 =
        w.sub_buf + (min(s * kSuper + i, p.n_clusters - 1) - first)
                        * kSubClusterF4 + 2 * j;
    const float4 x = b4[0];   // lo.xyz, hi.x
    const float4 y = b4[1];   // hi.yz, 0, 0
    const bool meet = k < total && slab6(x.x, x.y, x.z, x.w, y.x, y.y, q, tf);
    const unsigned bits = __ballot_sync(kAll, meet);
    if (j == 0 && k < total)
      pairs[k] = (uint16_t)((bits >> (mine << log_div)) & byte);
  }
  __syncwarp();
  // this lane's words of clusters 0-7 and 8-15, 8 bits each
  unsigned long long lo = 0ull, hi = 0ull;
  at = end - own;
  for (unsigned m = w.c_mask; m; m &= m - 1) {
    const int i = __ffs(m) - 1;
    const unsigned long long word = (unsigned long long)pairs[at++]
                                    << (8 * (i & 7));
    if (i < 8)
      lo |= word;
    else
      hi |= word;
  }
  w.sub_w[0] = (unsigned)lo;
  w.sub_w[1] = (unsigned)(lo >> 32);
  w.sub_w[2] = (unsigned)hi;
  w.sub_w[3] = (unsigned)(hi >> 32);
  unsigned wanted = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w.sub_u[k] = __reduce_or_sync(kAll, w.sub_w[k]);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      wanted |= (unsigned)(((w.sub_u[k] >> (8 * b)) & 0xffu) != 0u)
                << (4 * k + b);
  }
  cnt.add_lanes(kCountSubTests, own * div);
  cnt.add(kCountSubSkipped, __popc(w.c_any & ~wanted));
  w.c_any &= wanted;
}

// Does the sub-box form skip the chunk at base (no lane wants a range of
// it)?
__device__ __forceinline__ bool skip_chunk(const Walk& w, int base,
                                           const BvhParams& p) {
  return !(w.sub_any
           & chunk_ranges(base, min(kChunk, p.k - base), p.sub_rows));
}

// The next chunk to stage: the current cluster's next chunk, else the
// next cluster some lane admits, through the group, super and cluster
// gates in order.  A level's gates are tested together when the walk
// enters its parent (the next kBatch groups of the order; a group's 16
// supers; a super's 16 clusters), each against the lane's best t then: a
// t can only fall, so that admits at least what gating each box at its
// turn would, and the chunk's own turn tests its cluster's box again.
// The sub-box form copies a super's sub-box block when it takes the
// super, under the slab tests of its cluster boxes, and makes the words of
// every cluster some lane admits there (super_words, with the lanes' best
// t then); a found cluster takes its word from them, and each chunk of it
// that holds no range some lane wants is skipped.  Called by the whole
// warp (control flow is warp-uniform); false at the end of the walk.
template <bool SUBBOX, bool COUNT>
__device__ __forceinline__ bool next_item(
    Walk& w, Item& it, const float* __restrict__ boxes,
    const float* __restrict__ supers, const float* __restrict__ groups,
    const float* __restrict__ subboxes, const int32_t* __restrict__ order,
    bool listed, const Ray& r, float best_t, const BvhParams& p,
    WarpCounts<COUNT>& cnt) {
  if constexpr (SUBBOX) {
    if (it.c >= 0) {
      for (int base = it.base + kChunk; base < p.k; base += kChunk) {
        if (skip_chunk(w, base, p)) {
          cnt.add(kCountChunksSkipped, 1);
          continue;
        }
        it.base = base;
        it.first = false;
        return true;
      }
    }
  } else if (it.c >= 0 && it.base + kChunk < p.k) {
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
      if constexpr (SUBBOX) {
        // its word and the warp's union, made when the walk took the
        // super (some lane wants a range: the others left c_any there)
        it.first = true;
        it.word = word_of(w.sub_w, i);
        w.sub_any = word_of(w.sub_u, i);
        while (skip_chunk(w, it.base, p)) {
          cnt.add(kCountChunksSkipped, 1);
          it.base += kChunk;
        }
      }
      return true;
    }
    if (w.s_any) {
      const int i = __ffs(w.s_any) - 1;
      w.s_any &= w.s_any - 1;
      w.s = w.g * kGroup + i;
      if constexpr (SUBBOX) issue_sub_block(w, subboxes, w.s, p);
      w.c_mask = (w.s_mask >> i) & 1u
                 ? slab_mask<kSuper>(boxes + 8 * kSuper * w.s, r, best_t)
                 : 0u;
      w.c_any = __reduce_or_sync(kAll, w.c_mask);
      cnt.add(kCountClusterTests, kSuper);
      cnt.add_lanes(kCountBoxTests, (w.s_mask >> i) & 1u ? kSuper : 0u);
      if constexpr (SUBBOX) {
        if (w.c_any) {
          const long long t0 = COUNT ? clock64() : 0;
          bar_wait(w.sub_bar, w.sub_parity);
          w.sub_parity ^= 1u;
          w.sub_pending = false;
          const long long t1 = COUNT ? clock64() : 0;
          super_words<COUNT>(w, w.s, p.k / p.sub_rows, r, best_t, p, cnt);
          if constexpr (COUNT) {
            cnt.add(kCountSubWaitCycles, t1 - t0);
            cnt.add(kCountSubWordCycles, clock64() - t1);
          }
        }
      }
      continue;
    }
    if (w.g_any) {
      const int i = __ffs(w.g_any) - 1;
      w.g_any &= w.g_any - 1;
      w.g = order[w.j0 + i];
      w.s_mask = (w.g_mask >> i) & 1u
                 ? slab_mask<kGroup>(supers + 8 * kGroup * w.g, r, best_t)
                 : 0u;
      w.s_any = __reduce_or_sync(kAll, w.s_mask);
      cnt.add(kCountSuperTests, kGroup);
      cnt.add_lanes(kCountBoxTests, (w.g_mask >> i) & 1u ? kGroup : 0u);
      continue;
    }
    w.j0 += kBatch;
    if (w.j0 >= p.n_order) {
      // no copy may still be in flight when the warp is done
      if constexpr (SUBBOX)
        if (w.sub_pending) bar_wait(w.sub_bar, w.sub_parity);
      return false;
    }
    const int n = min(kBatch, p.n_order - w.j0);
    w.g_mask = 0;
    if (listed) {
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
        if (i < n && slab(groups + 8 * order[w.j0 + i], r, best_t))
          w.g_mask |= 1u << i;
    }
    w.g_any = __reduce_or_sync(kAll, w.g_mask);
    cnt.add(kCountGroupTests, n);
    cnt.add_lanes(kCountBoxTests, listed ? n : 0);
  }
}

// the staged slot sl's test for ray q: (valid, t, global index, read from
// the staged row, or for the Plucker form from gidx only on a valid hit)
template <bool PLUCKER>
__device__ __forceinline__ bool staged_hit(const float4* __restrict__ buf,
                                           int sl, const Ray& q,
                                           const int32_t* __restrict__ gidx,
                                           int row, float& t, int32_t& g) {
  if constexpr (PLUCKER) {
    float c[kPluckerCols];
#pragma unroll
    for (int j = 0; j < kPluckerRowF4; ++j) {
      const float4 w = buf[kPluckerRowF4 * sl + j];
      c[4 * j] = w.x;
      c[4 * j + 1] = w.y;
      c[4 * j + 2] = w.z;
      c[4 * j + 3] = w.w;
    }
    const bool hit = plucker_hit(c, q, t);
    g = hit ? __ldg(gidx + row) : -1;
    return hit;
  } else {
    const float4 a = buf[kMtRowF4 * sl];       // v0, global index
    const float4 b = buf[kMtRowF4 * sl + 1];   // e1, active
    const float4 e = buf[kMtRowF4 * sl + 2];   // e2
    g = __float_as_int(a.w);
    return mt_hit(a.x, a.y, a.z, b.x, b.y, b.z, e.x, e.y, e.z, b.w, q, t);
  }
}

// The admitting lanes' MT over one staged chunk of n slots (first: its
// first table slot; base: its first slot in the cluster).  Few lanes
// admitting (at most kSplitMax): for each admitting ray in turn every lane
// tests every 32nd slot with that ray, and the lexicographic least (t,
// index) of the warp is committed by the ray's own lane.  Many: each
// admitting lane tests every slot (the chunk is read at one address by
// the whole warp).  The sub-box form tests a ray only on the slots of the
// ranges its word wants: each admitting lane over the ranges of the chunk
// some admitting lane wants, the slots of a range it does not want
// skipped; split, the ray's wanted slots of the chunk, numbered in order,
// each lane every 32nd of them.
template <bool PLUCKER, bool SUBBOX, bool COUNT>
__device__ __forceinline__ void mt_chunk(const float4* __restrict__ buf,
                                         int n, int first, int base,
                                         unsigned admit, bool ok,
                                         unsigned word, const Ray& r,
                                         Best& best,
                                         const int32_t* __restrict__ gidx,
                                         const BvhParams& p,
                                         WarpCounts<COUNT>& cnt) {
  const int lane = threadIdx.x & 31;
  if (__popc(admit) > kSplitMax) {
    if constexpr (SUBBOX) {
      const unsigned want = __reduce_or_sync(kAll, ok ? word : 0u)
                            & chunk_ranges(base, n, p.sub_rows);
      for (unsigned m = want; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const int s0 = max(j * p.sub_rows - base, 0);
        const int s1 = min((j + 1) * p.sub_rows - base, n);
        cnt.add(kCountMtSteps, s1 - s0);
        if (ok && ((word >> j) & 1u)) {
          for (int sl = s0; sl < s1; ++sl) {
            float t;
            int32_t g;
            if (staged_hit<PLUCKER>(buf, sl, r, gidx, first + sl, t, g))
              commit(t, g, first + sl, best);
          }
        }
      }
      return;
    }
    cnt.add(kCountMtSteps, n);
    if (ok) {
      for (int sl = 0; sl < n; ++sl) {
        float t;
        int32_t g;
        if (staged_hit<PLUCKER>(buf, sl, r, gidx, first + sl, t, g))
          commit(t, g, first + sl, best);
      }
    }
    return;
  }
  cnt.add(kCountSplit, 1);
  for (unsigned m = admit; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    Ray q;
    q.ox = __shfl_sync(kAll, r.ox, src);
    q.oy = __shfl_sync(kAll, r.oy, src);
    q.oz = __shfl_sync(kAll, r.oz, src);
    q.dx = __shfl_sync(kAll, r.dx, src);
    q.dy = __shfl_sync(kAll, r.dy, src);
    q.dz = __shfl_sync(kAll, r.dz, src);
    if constexpr (PLUCKER) {
      q.mx = __shfl_sync(kAll, r.mx, src);
      q.my = __shfl_sync(kAll, r.my, src);
      q.mz = __shfl_sync(kAll, r.mz, src);
    }
    if constexpr (!SUBBOX) cnt.add(kCountMtSteps, (n + 31) / 32);
    // this lane's least candidate as one key: t > 0, so its bits order
    // as the floats do, then the global index (>= 0 for an active slot)
    unsigned long long key = ~0ull;
    int slot = -1;
    if constexpr (SUBBOX) {
      // the ray's wanted slots, numbered in order from 0: this lane takes
      // those numbered lane, lane + 32, ...
      const unsigned want = __shfl_sync(kAll, word, src)
                            & chunk_ranges(base, n, p.sub_rows);
      int acc = 0;
      for (unsigned mm = want; mm; mm &= mm - 1) {
        const int j = __ffs(mm) - 1;
        const int s0 = max(j * p.sub_rows - base, 0);
        const int len = min((j + 1) * p.sub_rows - base, n) - s0;
        for (int x = (lane - acc) & 31; x < len; x += 32) {
          const int sl = s0 + x;
          float t;
          int32_t g;
          if (staged_hit<PLUCKER>(buf, sl, q, gidx, first + sl, t, g)) {
            const unsigned long long k2 =
                ((unsigned long long)__float_as_uint(t) << 32) | (uint32_t)g;
            if (k2 < key) {
              key = k2;
              slot = first + sl;
            }
          }
        }
        acc += len;
      }
      cnt.add(kCountMtSteps, (acc + 31) / 32);
    } else {
      for (int sl = lane; sl < n; sl += 32) {
        float t;
        int32_t g;
        if (staged_hit<PLUCKER>(buf, sl, q, gidx, first + sl, t, g)) {
          const unsigned long long k2 =
              ((unsigned long long)__float_as_uint(t) << 32) | (uint32_t)g;
          if (k2 < key) {
            key = k2;
            slot = first + sl;
          }
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

// The warp walk (every variant): the warp visits, in order, every
// chunk of every cluster that some lane's gates admit (next_item); each
// chunk is one 1-D bulk copy from the staged table (rows: kMtRowF4 or
// kPluckerRowF4 float4s a slot) into one of the warp's kStages shared
// buffers, a ring: while a chunk's MT runs, the copies of the next kStages
// - 1 chunks are in flight.  A chunk is found (and its copy issued) with
// the lanes' best t of that moment, before the MT of the chunks ahead of
// it (a t can only fall, so that admits at least what the walk would); at
// its turn each lane tests the cluster's box again with its t then, and
// the lanes that still admit it (in the sub-box form: and whose word wants
// a range of the chunk) run MT (mt_chunk).  Each ray's gates and commits
// are the plain version's, so it writes the same result.  The sub-box
// form's super blocks go to the buffer after the ring's, on
// s_bar[kStages].  Called by the whole warp (control flow is
// warp-uniform).
template <bool PLUCKER, bool SUBBOX, bool COUNT>
__device__ __forceinline__ void warp_walk(
    const float4* __restrict__ rows, const int32_t* __restrict__ gidx,
    const float* __restrict__ boxes, const float* __restrict__ supers,
    const float* __restrict__ groups, const float* __restrict__ subboxes,
    const int32_t* __restrict__ order, bool listed, const Ray& r,
    Best& best, const BvhParams& p, float4* __restrict__ s_buf,
    uint64_t* __restrict__ s_bar, unsigned long long* counters) {
  constexpr int kRowF4 = PLUCKER ? kPluckerRowF4 : kMtRowF4;
  WarpCounts<COUNT> cnt;
  const long long t_walk = COUNT ? clock64() : 0;
  if constexpr (COUNT) {
    cnt.add(kCountWalked, __popc(__ballot_sync(kAll, listed)));
    cnt.add(kCountWarps, 1);
  }
  const int lane = threadIdx.x & 31;
  Walk w;
  if constexpr (SUBBOX) {
    w.sub_buf = s_buf + kStages * kChunk * kRowF4;
    w.sub_bar = s_bar + kStages;
    w.sub_pairs = reinterpret_cast<uint16_t*>(w.sub_buf + kSubBlockF4);
  }
  Item last = {-1, 0, false, kAll, false};   // the chunk found last
  Item q[kStages];              // the chunks staged, oldest first
  int n_q = 0;
  bool more = true;
  uint32_t issued = 0, phase = 0;   // phase bit b: buffer b's next parity
  // find the next chunk and copy it into the next buffer of the ring (a
  // NaN ray admits the sentinel boxes past the table too; staging the
  // last cluster again changes nothing)
  auto stage_next = [&]() {
    more = next_item<SUBBOX, COUNT>(w, last, boxes, supers, groups, subboxes,
                                    order, listed, r, best.t, p, cnt);
    if (!more) return;
#pragma unroll
    for (int i = 0; i < kStages; ++i)
      if (i == n_q) q[i] = last;
    ++n_q;
    const int b = issued++ % kStages;
    const int first = min(last.c, p.n_clusters - 1) * p.k + last.base;
    const int n = min(kChunk, p.k - last.base);
    cnt.add(kCountChunks, 1);
    cnt.add(kCountSlots, n);
    __syncwarp();   // every lane is done with buffer b's last chunk
    if (lane == 0)
      bulk_load(s_buf + b * kChunk * kRowF4, rows + (size_t)first * kRowF4,
                static_cast<uint32_t>(n * kRowF4 * 16), &s_bar[b]);
  };
  while (more && n_q < kStages) stage_next();
  for (uint32_t done = 0; n_q > 0; ++done) {
    const Item cur = q[0];
#pragma unroll
    for (int i = 0; i + 1 < kStages; ++i) q[i] = q[i + 1];
    --n_q;
    const int b = done % kStages;
    bar_wait(&s_bar[b], (phase >> b) & 1u);
    phase ^= 1u << b;
    const int n = min(kChunk, p.k - cur.base);
    const bool in_box = cur.ok && slab(boxes + 8 * cur.c, r, best.t);
    bool ok = in_box;
    if constexpr (SUBBOX)
      ok = in_box && (cur.word & chunk_ranges(cur.base, n, p.sub_rows));
    const unsigned admit = __ballot_sync(kAll, ok);
    cnt.add_lanes(kCountBoxTests, cur.ok);
    if constexpr (COUNT) {
      // the (ray, cluster) pairs: the lanes that still admit the cluster
      // at its first visited chunk (in the sub-box form: with a range)
      const unsigned pairs =
          SUBBOX ? __ballot_sync(kAll, in_box && cur.word != 0u) : admit;
      if ((SUBBOX ? cur.first : cur.base == 0) && pairs) {
        cnt.add(kCountStagings, 1);
        cnt.add(kCountPairs, __popc(pairs));
        cnt.add(kCountHist + hist_bin(__popc(pairs)), 1);
      }
    }
    if (admit) {
      const int first = min(cur.c, p.n_clusters - 1) * p.k + cur.base;
      mt_chunk<PLUCKER, SUBBOX, COUNT>(s_buf + b * kChunk * kRowF4, n, first,
                                       cur.base, admit, ok, cur.word, r,
                                       best, gidx, p, cnt);
    } else {
      cnt.add(kCountWasted, 1);
    }
    if (more) stage_next();   // into buffer b, just read
  }
  if constexpr (COUNT) cnt.add(kCountWalkCycles, clock64() - t_walk);
  cnt.flush(counters);
}

// The walk over the ray list: ray perm[i] for thread i (perm and count
// from the compaction, or ray i), a miss for a ray past the admitted count
// or dead.
template <int VARIANT, bool PLUCKER, bool SUBBOX, bool COUNT = false>
__global__ void __launch_bounds__(kBlock)
bvh_kernel(const RayIn in, const float4* __restrict__ staged,
           const float* __restrict__ coeffs,
           const int32_t* __restrict__ gidx, const float* __restrict__ boxes,
           const float* __restrict__ supers, const float* __restrict__ groups,
           const float* __restrict__ subboxes,
           const int32_t* __restrict__ order, const int32_t* __restrict__ perm,
           const int32_t* __restrict__ count, float* __restrict__ t_out,
           int32_t* __restrict__ slot_out, const BvhParams p,
           unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(128) float4 s_dyn[];
  // each warp's ring barriers, and in the sub-box form its super block's
  constexpr int kBars = kStages + (SUBBOX ? 1 : 0);
  __shared__ __align__(8) uint64_t s_bar[kWarps][kBars];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = i < p.n_rays;
  // every lane of the block stays to the end: the walk is the warp's
  if (threadIdx.x < kWarps * kBars) bar_init(&s_bar[0][0] + threadIdx.x);
  bar_init_fence();
  __syncthreads();
  const int ray = !in_range ? 0 : (perm != nullptr ? perm[i] : i);
  Best best;
  best.t = in_range ? in.t_init[ray] : 0.0f;
  best.idx = -1;
  best.slot = -1;
  const bool listed = in_range && (perm == nullptr || i < *count)
                      && ray_alive(in, ray, p.alive_u8);
  Ray r = {};
  if (listed) {
    r.ox = in.ox[ray];
    r.oy = in.oy[ray];
    r.oz = in.oz[ray];
    r.dx = in.dx[ray];
    r.dy = in.dy[ray];
    r.dz = in.dz[ray];
    r.inx = 1.0f / r.dx;
    r.iny = 1.0f / r.dy;
    r.inz = 1.0f / r.dz;
    if constexpr (PLUCKER) {
      r.mx = r.oy * r.dz - r.oz * r.dy;
      r.my = r.oz * r.dx - r.ox * r.dz;
      r.mz = r.ox * r.dy - r.oy * r.dx;
    }
  }
  constexpr int kRowF4 = PLUCKER ? kPluckerRowF4 : kMtRowF4;
  const int warp = threadIdx.x >> 5;
  if (__any_sync(kAll, listed))
    warp_walk<PLUCKER, SUBBOX, COUNT>(
        PLUCKER ? reinterpret_cast<const float4*>(coeffs) : staged, gidx,
        boxes, supers, groups, subboxes, order, listed, r, best, p,
        s_dyn + warp * (kStages * kChunk * kRowF4
                        + (SUBBOX ? kSubBlockF4 + kSubPairsF4 : 0)),
        s_bar[warp], counters);
  if (!in_range) return;
  t_out[ray] = best.idx < 0 ? INFINITY : best.t;
  slot_out[ray] = best.idx < 0 ? -1 : best.slot;
}

// the dynamic shared memory a block of the warp walk takes: each warp's
// ring of buffers, followed in the sub-box form by its super block (the
// route's fit, with the mbarriers, the 48 KB a launch may take without
// opting in; a larger ring of the sweep opts in)
template <bool PLUCKER, bool SUBBOX>
constexpr int walk_smem() {
  return (kWarps * kStages * kChunk * (PLUCKER ? kPluckerRowF4 : kMtRowF4)
          + (SUBBOX ? kWarps * (kSubBlockF4 + kSubPairsF4) : 0)) * 16;
}

// the work scratch's int32 words: partial sums, the two visiting orders,
// the bucket sizes and cursors, and each ray's bucket
size_t work_words(const BvhParams& p) {
  return (size_t)kPartials * 4 + kRankMax + kAdmissionMax + 2 * kBuckets
         + (p.n_admission > 0 ? (size_t)p.n_rays : 0);
}

int launch_bvh(const RayIn& in, const float* staged,
               const float* coeffs, const int32_t* gidx, const float* boxes,
               const float* supers, const float* groups,
               const float* admission, const float* subboxes, int32_t* work,
               int32_t* perm,
               int32_t* count, float* t_out, int32_t* slot_out,
               const BvhParams& p, const BvhOptions& opt,
               unsigned long long* counters, void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  // the warp walk, over the staged MT table or (not kFlat) the Plucker
  // coefficients
  const bool compact = p.n_admission > 0;
  if (p.k <= 0 || p.n_clusters <= 0 || p.n_order <= 0
      || p.n_order > kRankMax || p.n_admission < 0
      || p.n_admission > kAdmissionMax || work == nullptr
      || compact != (perm != nullptr) || compact != (count != nullptr)
      || (compact && admission == nullptr)
      || (p.plucker != 0) != (coeffs != nullptr)
      || (p.plucker && p.variant == kFlat)
      || (!p.plucker
          && (staged == nullptr
              || reinterpret_cast<uintptr_t>(staged) % 16 != 0))
      || (p.plucker && reinterpret_cast<uintptr_t>(coeffs) % 16 != 0)
      || p.sub_rows < 0 || (p.sub_rows != 0) != (subboxes != nullptr)
      || (p.sub_rows
          && (p.plucker || p.variant == kFlat || p.k % p.sub_rows != 0
              || p.k / p.sub_rows > 8
              || reinterpret_cast<uintptr_t>(subboxes) % 16 != 0))
      || (opt.reverse != 0 && opt.reverse != 1)
      || (opt.morton != 0 && opt.morton != 1) || (opt.morton && !compact))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the work scratch (work_words)
  float4* part = reinterpret_cast<float4*>(work);
  int32_t* visit_order = work + kPartials * 4;
  int32_t* adm_order = visit_order + kRankMax;
  int32_t* counts = adm_order + kAdmissionMax;
  int32_t* cursor = counts + kBuckets;
  int32_t* bucket = cursor + kBuckets;
  const int ray_blocks = (p.n_rays + kThreads - 1) / kThreads;
  const int n_part = min(ray_blocks, kPartials);
  ray_partials<<<n_part, kThreads, 0, st>>>(in, p, part);
  // the Morton key's order came with perm: no admission rank
  const int n_adm_rank = opt.morton ? 0 : p.n_admission;
  const int n_rank = p.n_order + n_adm_rank;
  rank_boxes<<<(n_rank + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      part, n_part, groups, p.n_order, admission, n_adm_rank,
      opt.reverse != 0, visit_order, adm_order);
  if (compact && !opt.morton) {
    cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int32_t) * kBuckets,
                                      st);
    if (err != cudaSuccess) return (int)err;
    bucket_rays<<<ray_blocks, kThreads, 0, st>>>(in, p, admission, adm_order,
                                                 bucket, counts);
    scan_buckets<<<1, 1024, 0, st>>>(counts, 8 * p.n_admission + 1, cursor,
                                     count);
    scatter_rays<<<ray_blocks, kThreads, 0, st>>>(bucket, p.n_rays, cursor,
                                                  perm);
  }
  const int blocks = (p.n_rays + kBlock - 1) / kBlock;
  const float4* st4 = reinterpret_cast<const float4*>(staged);
#define SRT_BVH_LAUNCH(VARIANT, PLUCKER, SUBBOX, COUNT)                      \
  do {                                                                       \
    constexpr int smem = walk_smem<PLUCKER, SUBBOX>();                       \
    if (smem + kWarps * (kStages + SUBBOX) * 8 > 48 * 1024) {                \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          bvh_kernel<VARIANT, PLUCKER, SUBBOX, COUNT>,                       \
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);                \
      if (e != cudaSuccess) return (int)e;                                   \
    }                                                                        \
    bvh_kernel<VARIANT, PLUCKER, SUBBOX, COUNT>                              \
        <<<blocks, kBlock, smem, st>>>(                                      \
            in, st4, coeffs, gidx, boxes, supers, groups, subboxes,          \
            visit_order, compact ? perm : nullptr,                           \
            compact ? count : nullptr, t_out, slot_out, p, counters);        \
  } while (0)
#define SRT_BVH_FORMS(VARIANT, COUNT)                \
  if (p.plucker)                                     \
    SRT_BVH_LAUNCH(VARIANT, true, false, COUNT);     \
  else if (p.sub_rows)                               \
    SRT_BVH_LAUNCH(VARIANT, false, true, COUNT);     \
  else                                               \
    SRT_BVH_LAUNCH(VARIANT, false, false, COUNT)
#define SRT_BVH_WALK(VARIANT)         \
  if (counters != nullptr) {          \
    SRT_BVH_FORMS(VARIANT, true);     \
  } else {                            \
    SRT_BVH_FORMS(VARIANT, false);    \
  }
  switch (p.variant) {
    case kFlat:       // the same warp walk
    case kTwoLevel:
    case kStreamed:
      SRT_BVH_WALK(kStreamed);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRT_BVH_WALK
#undef SRT_BVH_FORMS
#undef SRT_BVH_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// The version of this C interface (ops/cuda/bvh_kernel.py: INTERFACE),
// raised whenever an argument or BvhParams changes, so a caller can tell
// which interface a build has (ops/cuda/build.py: interface).
extern "C" int srt_bvh_interface() { return 4; }

// The int32 words of the work scratch a launch with these parameters
// needs (the wrapper allocates it).
extern "C" long long srt_bvh_work_words(BvhParams p) {
  return (long long)work_words(p);
}

// One launch: the visiting order (and, with admission boxes, the ray
// compaction into perm and count) on the stream, then the walk.  Rays:
// (R,) f32 o, d, alive (bytes or f32) and t_init; staged: the warp walk's
// MT table ((C * K, 12) f32; null for the Plucker form); coeffs: the
// Plucker form's (C * K, 20) table, or null; subboxes: the sub-box form's
// (C * 8, 8) f32 table (params.sub_rows > 0), or null; work:
// srt_bvh_work_words int32 words; perm (R,) and count (1,) int32 with
// admission boxes (under opt.morton, given: srt_bvh_morton_keys and the
// caller's sort).
extern "C" int srt_bvh_launch(const float* ox, const float* oy,
                              const float* oz, const float* dx,
                              const float* dy, const float* dz,
                              const void* alive, const float* t_init,
                              const float* staged, const float* coeffs,
                              const int32_t* gidx, const float* boxes,
                              const float* supers, const float* groups,
                              const float* admission, const float* subboxes,
                              int32_t* work, int32_t* perm, int32_t* count,
                              float* t_out, int32_t* slot_out,
                              BvhOptions opt, BvhParams p, void* stream) {
  const RayIn in = {ox, oy, oz, dx, dy, dz, t_init, alive};
  return launch_bvh(in, staged, coeffs, gidx, boxes, supers, groups,
                    admission, subboxes, work, perm, count, t_out, slot_out,
                    p, opt, nullptr, stream);
}

// The Morton key's half of a compaction (BvhOptions.morton): each ray's
// packed key into keys ((R,) int32) and the admitted rays' count into
// count ((1,) int32, zeroed here), on the stream; the caller sorts the keys
// into the order srt_bvh_launch takes as perm (the ray index is each key's
// low bits, idx_bits = max(bit length of R - 1, 1)).  Rays and admission
// boxes as srt_bvh_launch's.
extern "C" int srt_bvh_morton_keys(const float* ox, const float* oy,
                                   const float* oz, const float* dx,
                                   const float* dy, const float* dz,
                                   const void* alive, const float* t_init,
                                   const float* admission, int32_t* keys,
                                   int32_t* count, BvhParams p,
                                   void* stream) {
  int idx_bits = 1;
  while (idx_bits < 31 && (1u << idx_bits) < (unsigned)p.n_rays) ++idx_bits;
  if (p.n_rays <= 0 || p.n_admission <= 0
      || p.n_admission > kAdmissionMax || admission == nullptr
      || keys == nullptr || count == nullptr || 31 - idx_bits < 6)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const RayIn in = {ox, oy, oz, dx, dy, dz, t_init, alive};
  morton_keys<<<(p.n_rays + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      in, p, admission, idx_bits, keys, count);
  return (int)cudaGetLastError();
}

// The counting instance (every variant): the same launch, which also adds
// what the walk did to counters ((kCounters,) int64, Count);
// chip_smoke.py's only
extern "C" int srt_bvh_count_launch(
    const float* ox, const float* oy, const float* oz, const float* dx,
    const float* dy, const float* dz, const void* alive, const float* t_init,
    const float* staged, const float* coeffs, const int32_t* gidx,
    const float* boxes, const float* supers, const float* groups,
    const float* admission, const float* subboxes, int32_t* work,
    int32_t* perm, int32_t* count, float* t_out, int32_t* slot_out,
    unsigned long long* counters, BvhOptions opt, BvhParams p,
    void* stream) {
  if (counters == nullptr) return (int)cudaErrorInvalidValue;
  const RayIn in = {ox, oy, oz, dx, dy, dz, t_init, alive};
  return launch_bvh(in, staged, coeffs, gidx, boxes, supers, groups,
                    admission, subboxes, work, perm, count, t_out, slot_out,
                    p, opt, counters, stream);
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
