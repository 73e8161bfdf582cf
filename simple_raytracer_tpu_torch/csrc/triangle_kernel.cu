// Brute-force nearest-triangle kernel for Hopper (sm_90a): the
// tri_backend="pallas" route of the split per-bounce path.
//
// Replaces simple_raytracer_tpu/ops/pallas/triangle_kernel.py:_kernel
// (pallas_call at :138, through intersect_triangles_pallas): for each live
// ray, over every active triangle, the nearest Moller-Trumbore hit under
// the reference's rules (a == 0 rejected, u in [0, 1], v >= 0,
// u + v <= 1, t > 0 strictly, inactive triangles skipped).  It writes t
// (+inf on a miss) and the triangle's column index in the packed (16, T)
// table as int32 (0 on a miss); the earliest triangle wins an exact tie.
// A dead ray gets (+inf, 0), which its caller never reads.  No culling and
// no far bound: every live ray meets every active triangle.  Shading is
// not here: the caller gathers the winner's row from the triangle-indexed
// table.  The plain version is ops/triangle.py:intersect_packed_plain.
//
// Bound on the H100: FP32 arithmetic over 67 TFLOP/s, counted over the
// (live ray, active triangle) pairs (the TPU route tests dead rays too;
// the bound counts the pairs whose result is read) in this kernel's exact
// form: 23 operations a pair to the early-out (MT to a and x, the margin
// multiply), then 2 (f, u) for a pair it keeps, 16 (q, v, u + v) where u
// passes and 6 (t) where v passes, the shares counted on sampled warps
// of each launch (chip_smoke.py phase 6): 45.00 ms a pass on config 6
// under "pallas" (1.31e11 live pairs, 23.03 operations each), 1.48 ms on
// config 5.  Full MT on every live pair (46 operations; 89.91 and 2.94
// ms) and on every ray slot are printed beside it.  The bytes (a ray's 24
// in and 8 out, a triangle's 48) are far below.
//
// Design, in the order of its gains (all four built):
// 1. Live rays only.  With an alive mask, compact_live first writes the
//    live rays' indices and their count on the device (a ballot and one
//    atomicAdd a block; nothing is read back to the host; the blocks land
//    in any order, which changes no ray's result); a triangle_kernel block
//    takes kBlockRays consecutive positions of that list.  Every ray's key
//    is the miss (+inf, 0) before the launch, so a dead ray needs no work;
//    a block past the live positions exits at once.
// 2. An exact early-out.  A pair first runs MT up to a = e1.h and
//    x = s.h (22 operations, the plain version's own intermediates), then
//    the division-free reject test mt_may_hit, the kernel's form of
//    ops/triangle.py:pretest_rejects (tests/test_torch_triangle_live.py
//    proves its margins).  With xs = x * sign(a), exact:
//    - xs > RN(|a| * (1 + 2^-20)): RN(1/a) and RN(|a| * c) each err by
//      at most 2^-22 relatively (2^-24 where normal; a subnormal one is
//      2^-150 absolute on a value of at least 2^-128), so the exact
//      product RN(1/a) * x exceeds (1 + 2^-20)(1 - 2^-22)(1 - 2^-24) >
//      1 + 2^-22 and u = RN(.) > 1 (or +inf where 1/a overflows);
//    - xs <= -2^-64 with |a| <= 2^64: |RN(1/a)| >= 2^-64, so
//      |RN(1/a) * x| >= 2^-128 cannot round to -0.0 and u < 0.
//    A NaN rejects nothing.  a == 0 needs no test of its own: 1/a is then
//    +-inf and u is +-inf or NaN, which the u test rejects (MT's a != 0
//    rule changes no result).  A warp skips a triangle when none of its
//    lanes survives (__any_sync); survivors run the rest of MT in the
//    plain version's order, f = 1/a, u, then q and v, then t, leaving as
//    soon as a test fails.
// 3. Asynchronous tile staging.  The per-scene staged table
//    (ops/triangle.py:stage_triangles: active triangles only, 48 bytes
//    each, three float4s: v0 and the column index, e1, e2) is read in
//    tiles of kTile triangles, each one 1-D bulk copy (TMA, cp.async.bulk)
//    into one of two shared buffers, completed on that buffer's mbarrier:
//    tile k + 1 arrives while tile k is tested.  Every thread reads a
//    triangle at the same address (a broadcast).  A block of kThreads
//    threads takes kRays rays a thread (one triangle's loads, vote and
//    loop serve kRays pairs).
// 4. Split triangle ranges.  A late bounce has few live rays, so few
//    blocks, each walking the whole table; and a full bounce ends in a
//    part-filled last wave.  Each live block's tile range is cut into
//    parts, one block each, about kWaves waves of the card's resident
//    blocks in all (at most one part a tile); the parts of a ray merge
//    with a 64-bit atomicMin on (t bits << 32) | index, which keeps the
//    nearest hit and, on a tie, the first triangle.
//
// Measured (chip_smoke.py phase 6; H100 80GB HBM3, 700 W; config 6 under
// "pallas", 960x540 at 2 spp, 6 bounces, a pass's six launches): 135.11 ms
// a pass, the compaction included, 33.3% of the bound (45.00 ms; full MT
// over the live pairs 89.91 ms); the design before this one took 1352.97
// ms.  Item by item, on the same launches (phase 6 of an earlier
// chip_smoke.py, which also swept block shapes and turned the split off):
// 1. every ray live: 523.61 ms, 3.88x;
// 2. the early-out keeps 0.15% of bounce 0's pairs, the vote passes on
//    about 5% of (warp, triangle) pairs; a triangle no lane keeps costs 117
//    instructions for 4 rays (29.25 a pair, cuobjdump), about 75 before;
// 3. block shapes (threads x rays a thread) 128x1 180.93 ms, 256x1
//    179.76, 128x2 152.32, 256x2 138.05, 128x4 135.00, 64x4 144.80, 64x8
//    147.16, 128x8 148.11; the asynchronous copies were not timed apart;
// 4. without the split: 213.62 ms, bounces 2 to 5 68.31 ms (with it, 3.58).
// What holds it back is the instruction stream: with --fmad=false each of
// a pair's 23 FP32 operations on the fast path issues alone, at most half
// the FMA rate the 67 TFLOP/s counts, and 6.25 more instructions a pair
// (loads, compares, the vote) issue beside them.
//
// Arithmetic: built with --fmad=false and no fast math, in the operation
// order of the plain version (ops/triangle.py:moller_trumbore), so each
// float operation of a surviving pair rounds as the plain version's does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"

struct TriParams {
  int32_t n_rays;            // rays: the (6, n_rays) f32 origins, directions
  int32_t n_tris;            // rows of the (n_tris, 12) f32 staged table
};

namespace {

constexpr int kThreads = 128;               // threads a block
constexpr int kRays = 4;                    // rays a thread
constexpr int kBlockRays = kThreads * kRays;
constexpr int kCompactThreads = 256;        // compact_live's block
constexpr int kTile = 256;                  // triangles a tile: 12 KB
constexpr int kRowFloat4 = 3;               // a staged row: three float4s
constexpr uint32_t kRowBytes = 16 * kRowFloat4;
constexpr float kUpper = 1.0f + 0x1p-20f;   // the u > 1 margin
constexpr float kXMin = 0x1p-64f;           // the u < 0 margins
constexpr float kAMax = 0x1p64f;
// the split aims at this many waves of the card's resident blocks, so the
// last wave's idle share stays near 1 / (kWaves + 1) at most
constexpr int kWaves = 8;

// MT certainly rejects (a, x) unless this holds (ops/triangle.py:
// pretest_rejects, negated): the margins are argued above.
__device__ __forceinline__ bool mt_may_hit(float a, float x) {
  const float aa = fabsf(a);
  const float xs = __uint_as_float(__float_as_uint(x)
                                   ^ (__float_as_uint(a) & 0x80000000u));
  return !(xs > aa * kUpper) && !(xs <= -kXMin && aa <= kAMax);
}

// The live rays' indices into order[0, *count), each block's in index
// order at the offset one atomicAdd on *count (zero before) gives it.
__global__ void __launch_bounds__(kCompactThreads)
compact_live(const uint8_t* __restrict__ alive, const int n,
             int32_t* __restrict__ order, int32_t* __restrict__ count) {
  __shared__ int s_warp[kCompactThreads / 32];
  __shared__ int s_base;
  const int i = blockIdx.x * kCompactThreads + threadIdx.x;
  const bool live = i < n && alive[i] != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t vote = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_warp[warp] = __popc(vote);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kCompactThreads / 32; ++w) {
      const int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_base = total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (live)
    order[s_base + s_warp[warp] + __popc(vote & ((1u << lane) - 1u))] = i;
}

// thread 0: the tile of n rows at src into dst, completing on bar
__device__ __forceinline__ void tile_load(float4* dst, const float4* src,
                                          int n, uint64_t* bar) {
  bulk_load(dst, src, static_cast<uint32_t>(n) * kRowBytes, bar);
}

// order and count: compact_live's list, or null for every ray
__global__ void __launch_bounds__(kThreads)
triangle_kernel(const float* __restrict__ rays,
                const float4* __restrict__ tri,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ count,
                unsigned long long* __restrict__ key_out, const TriParams p,
                const int fill) {
  __shared__ __align__(128) float4 s_tri[2][kRowFloat4 * kTile];
  __shared__ __align__(8) uint64_t s_bar[2];
  const int64_t n_live = count != nullptr ? *count : p.n_rays;
  const int64_t n_tiles = (p.n_tris + kTile - 1) / kTile;
  // the live rays' blocks, each over `splits` parts of the triangle range:
  // about kWaves * fill blocks in all (fill: the card's resident blocks),
  // within the grid and at most one part a tile
  const int64_t live_blocks = (n_live + kBlockRays - 1) / kBlockRays;
  if (live_blocks == 0) return;
  const int64_t want = (int64_t)kWaves * fill;
  const int64_t splits = max((int64_t)1, min(min(
      (want + live_blocks - 1) / live_blocks,
      (int64_t)gridDim.x / live_blocks), n_tiles));
  if (blockIdx.x >= live_blocks * splits) return;   // uniform: exits at once
  const int64_t first = blockIdx.x / splits * kBlockRays;
  const int64_t part = blockIdx.x % splits;
  const int64_t k0 = part * n_tiles / splits;
  const int64_t k1 = (part + 1) * n_tiles / splits;
  const size_t nr = (size_t)p.n_rays;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float best_t[kRays];
  int best_i[kRays], ray[kRays];
  bool live[kRays];
  bool any_live = false;
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    // a slot past the live rays repeats the last live ray, so its lanes
    // reject what a live ray rejects; its result is not written
    const int64_t pos = first + threadIdx.x + r * kThreads;
    live[r] = pos < n_live;
    const int64_t src = live[r] ? pos : n_live - 1;
    ray[r] = order != nullptr ? order[src] : (int)src;
    const int g = ray[r];
    ox[r] = rays[g];
    oy[r] = rays[nr + g];
    oz[r] = rays[2 * nr + g];
    dx[r] = rays[3 * nr + g];
    dy[r] = rays[4 * nr + g];
    dz[r] = rays[5 * nr + g];
    best_t[r] = INFINITY;
    best_i[r] = 0;
    any_live |= live[r];
  }
  const bool warp_live = __any_sync(0xffffffffu, any_live);

  if (threadIdx.x == 0) {
    bar_init(&s_bar[0]);
    bar_init(&s_bar[1]);
    bar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int64_t k) {   // thread 0: tile k into buffer (k - k0) & 1
    tile_load(s_tri[(k - k0) & 1], tri + k * kTile * kRowFloat4,
              (int)min((int64_t)kTile, p.n_tris - k * kTile),
              &s_bar[(k - k0) & 1]);
  };
  if (threadIdx.x == 0 && k0 < k1) issue(k0);
  for (int64_t k = k0; k < k1; ++k) {
    const int b = (int)((k - k0) & 1);
    // buffer b ^ 1 was last read in tile k - 1, before the barrier that
    // closed it
    if (threadIdx.x == 0 && k + 1 < k1) issue(k + 1);
    bar_wait(&s_bar[b], (uint32_t)(((k - k0) >> 1) & 1));
    const float4* s = s_tri[b];
    const int n = (int)min((int64_t)kTile, p.n_tris - k * kTile);
    if (warp_live) {
      for (int j = 0; j < n; ++j) {
        const float4 c0 = s[kRowFloat4 * j];       // v0, column index
        const float4 c1 = s[kRowFloat4 * j + 1];   // e1
        const float4 c2 = s[kRowFloat4 * j + 2];   // e2
        float a[kRays], sx[kRays], sy[kRays], sz[kRays], x[kRays];
        bool may[kRays];
        bool any_may = false;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          const float hx = dy[r] * c2.z - dz[r] * c2.y;
          const float hy = dz[r] * c2.x - dx[r] * c2.z;
          const float hz = dx[r] * c2.y - dy[r] * c2.x;
          a[r] = c1.x * hx + c1.y * hy + c1.z * hz;
          sx[r] = ox[r] - c0.x;
          sy[r] = oy[r] - c0.y;
          sz[r] = oz[r] - c0.z;
          x[r] = sx[r] * hx + sy[r] * hy + sz[r] * hz;
          may[r] = mt_may_hit(a[r], x[r]);
          any_may |= may[r];
        }
        if (!__any_sync(0xffffffffu, any_may)) continue;
#pragma unroll
        for (int r = 0; r < kRays; ++r) {
          if (!may[r]) continue;
          const float f = 1.0f / a[r];
          const float u = f * x[r];
          if (!(u >= 0.0f && u <= 1.0f)) continue;   // a == 0 too
          const float qx = sy[r] * c1.z - sz[r] * c1.y;
          const float qy = sz[r] * c1.x - sx[r] * c1.z;
          const float qz = sx[r] * c1.y - sy[r] * c1.x;
          const float v = f * (dx[r] * qx + dy[r] * qy + dz[r] * qz);
          if (!(v >= 0.0f && u + v <= 1.0f)) continue;
          const float t = f * (c2.x * qx + c2.y * qy + c2.z * qz);
          if (t > 0.0f && t < best_t[r]) {
            best_t[r] = t;
            best_i[r] = __float_as_int(c0.w);
          }
        }
      }
    }
    __syncthreads();   // buffer b is free for tile k + 2
  }
  // (t, index) as one key: t > 0, so its bits order as the floats do, and
  // the least key is the nearest hit, the first triangle on a tie
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    if (live[r] && best_t[r] < INFINITY) {
      atomicMin(&key_out[ray[r]],
                ((unsigned long long)__float_as_uint(best_t[r]) << 32)
                    | (unsigned int)best_i[r]);
    }
  }
}

constexpr int kMaxDevices = 64;

}  // namespace

// key_out: (n_rays,) u64, (t bits << 32) | index, set by the caller to the
// miss (+inf, 0) before the launch; the kernel lowers a live ray's key to
// its nearest hit with atomicMin (the triangle range may be split across
// blocks), so a dead ray keeps the miss.  alive: (n_rays,) bytes, or null
// for every ray; with it, order ((n_rays,) int32) and count (one int32)
// are the device scratch of the live-ray list.
extern "C" int srt_triangle_launch(const float* rays, const float* tri,
                                   const uint8_t* alive, int32_t* order,
                                   int32_t* count,
                                   unsigned long long* key_out, TriParams p,
                                   void* stream) {
  if (p.n_rays <= 0) return (int)cudaSuccess;
  if (p.n_tris < 0 || reinterpret_cast<uintptr_t>(tri) % 16 != 0
      || (alive != nullptr && (order == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  // the card's resident blocks, once per device
  static int fill[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (fill[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, triangle_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    fill[dev] = sms * max(per_sm, 1);
  }
  if (alive != nullptr) {
    err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
    compact_live<<<(p.n_rays + kCompactThreads - 1) / kCompactThreads,
                   kCompactThreads, 0, s>>>(alive, p.n_rays, order, count);
  } else {
    order = count = nullptr;
  }
  // every ray's block, and room for kWaves * fill more: live_blocks *
  // splits < kWaves * fill + live_blocks
  const int blocks = (p.n_rays + kBlockRays - 1) / kBlockRays
                     + kWaves * fill[dev];
  triangle_kernel<<<blocks, kThreads, 0, s>>>(
      rays, reinterpret_cast<const float4*>(tri), order, count, key_out, p,
      fill[dev]);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
