// Hopper counterparts (sm_90a) of the TPU lowering probes of
// scripts/probe_kernel_ops.py:55 run (kernel_a :18, kernel_b :29,
// kernel_c :38): what the per-cluster decisions of a BVH walk cost on this
// card.  Each probe computes its TPU probe's function on any (512, 128)
// f32 array x into a (512, 128) f32 output (probe_kernel_ops.py:
// probe_plain):
//   - kColumnSum (A): the array's sum through 128 reads of one column at a
//     runtime index (p.cols bounds the loop, as pl.ds(c, 1) slices),
//     broadcast to the output;
//   - kScalarSum (B): the same sum through a (128,) shared scratch of
//     column sums read one scalar at a time, broadcast to the output;
//   - kGatedLoop (C): out[r, j] is the sum, in ascending c, of x[r, c] over
//     the columns c with an entry above 2 in any of the 512 rows (the TPU
//     probe's jnp.any over the whole column, :47, then out += m, :49);
//     zeros where no column fires.  A 128-step loop reads one column an
//     iteration and takes the decision column by column at run time.
// Each loop runs p.cols iterations of one column (A, C) or one scalar (B),
// not unrolled, as the TPU probes' fori_loop does.  kEmptyLaunch launches
// a kernel of the same shape that does nothing: the floor under a call's
// time.
//
// Bound: the bytes, 256 KB in and 256 KB out, 0.16 us at 3.35 TB/s.  No
// launch reaches half of that: a launch alone costs microseconds, which
// the empty launch measures beside the probes (chip_smoke.py phase 6).
//
// Design.  One thread-block cluster of kCluster = 8 CTAs, one an SM, holds
// the whole array in shared memory at once: CTA `rank` holds rows
// [64 rank, 64 rank + 64), one row a thread.  The rows come in by one TMA
// tensor copy a CTA, a box 132 columns wide and 64 rows deep whose 4
// columns past the array's 128 the TMA fills with zeros, completed on the
// CTA's mbarrier: a row is padded to kStride = 132 floats (528 bytes).  A
// warp's read of one column over its 32 rows then touches 8 banks, 4 rows
// a bank (any stride a TMA box allows is a multiple of 4 floats, so no
// layout of whole 16-byte groups does better for a column); a 16-byte read
// of one group of four columns over 32 rows touches every bank once (row
// r's group g lies in bank group (33 r + g) mod 8), which C's mask build
// uses.  Each CTA writes its own 64 rows of the output with 16-byte
// stores.
//   A: each thread sums its row in ascending c; the CTA sums its rows in a
//      fixed tree; the CTAs trade their partials through distributed
//      shared memory (DSMEM, Inbox), and every CTA adds the 8 in rank
//      order, so every CTA gets the same total and the result does not
//      vary from run to run.
//   B: each thread sums two columns down the CTA's rows into the scratch;
//      the loop reads it one scalar at a time; the partials as in A.
//   C: the gate covers all 512 rows across the cluster, batched: each CTA
//      builds a 128-bit mask of the columns its rows fire, the CTAs trade
//      their masks once (the Inbox) and OR them, and the loop tests one
//      bit a column.  Each row adds its fired columns in ascending c, the
//      TPU kernel's order.
// PERF.md (row P) records the alternatives this design was chosen over:
// a bulk copy a row, dense rows, a pull of the partials after a cluster
// barrier, and a cluster vote at every column.
// The timing instance (a non-null `cycles`) reads clock64 in thread 0 and
// writes each CTA's SM cycles from its entry to each Mark: its rows
// landed, the loop's start and end (each after a block barrier: the
// loop's own cost, apart from the copies, the reductions and the fill),
// the fill's start and end, its exit.
//
// The launch is one cluster through cudaLaunchKernelEx: a cluster the card
// cannot schedule fails the launch, and the error is returned; there is no
// single-block fallback.  A CTA takes 33 KB of dynamic shared memory,
// below the 48 KB a launch gets without an attribute.  The host encodes
// x's tensor map once for the last x it saw (under a lock), so a call
// from a loop on one array pays for the launch alone.
//
// Arithmetic: the sums are exact in any order on integer-valued inputs
// below 2^24, so there each output equals its plain version bit for bit.
// On other inputs A and B add in another order than x.sum() (rtol 1e-6 of
// the sum, probe_kernel_ops.RTOL); C adds in the plain version's order and
// equals it bit for bit.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "bulk_copy.cuh"

struct ProbeParams {
  int32_t rows;    // 512
  int32_t cols;    // 128
  int32_t which;   // Probe
};

enum Probe { kColumnSum = 0, kScalarSum = 1, kGatedLoop = 2,
             kEmptyLaunch = 3 };

// the timing instance's marks, cycles[kMarks * rank + mark]: SM cycles
// from the CTA's entry
enum Mark { kMarkStaged = 0, kMarkLoopStart = 1, kMarkLoopEnd = 2,
            kMarkFillStart = 3, kMarkFillEnd = 4, kMarkExit = 5,
            kMarks = 6 };

namespace {

namespace cg = cooperative_groups;

constexpr int kRows = 512;
constexpr int kCols = 128;
constexpr int kCluster = 8;                 // CTAs of the cluster
constexpr int kCtaRows = kRows / kCluster;  // 64: a CTA's rows
constexpr int kThreads = kCtaRows;          // one row a thread
constexpr int kWarps = kThreads / 32;
constexpr int kStride = kCols + 4;          // floats a shared row
constexpr int kGroups = kCols / 4;          // 16-byte groups a row
constexpr size_t kSharedBytes = sizeof(float) * kCtaRows * kStride;
constexpr uint32_t kRowBytes = sizeof(float) * kCols;
constexpr int kMaskWords = kCols / 32;      // C's 128-bit mask

static_assert(kSharedBytes <= 48 * 1024, "no attribute is set");
static_assert(kCluster * kMaskWords <= kThreads, "a thread a word a CTA");

__device__ __forceinline__ long long clock_now() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

// the address of `p`'s counterpart in CTA `rank`'s shared memory
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(addr) : "r"(smem(p)), "r"(rank));
  return addr;
}

// The CTAs' trade of a value of N words (A and B: the CTA's partial sum;
// C: the columns its rows fire): afterwards every CTA holds every CTA's
// value in `slots`, by rank.  At its entry a CTA initialises `bar` for
// kCluster x N arrivals and arrives at a cluster barrier, on which it
// waits only before its first push, long after the others have started.
// Then each of kCluster x N threads writes one word of the CTA's value
// into one CTA's slot for this rank (DSMEM) and arrives on that CTA's
// `bar` (release, cluster scope); a CTA reads its own slots when its `bar`
// completes.  No CTA reads another's shared memory, and a CTA leaves only
// after every write to it has landed, so no barrier is needed at the exit.
template <typename T, int N>
struct Inbox {
  uint64_t bar;
  T mine[N];
  T slots[kCluster][N];

  __device__ void open() {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   ::"r"(smem(&bar)), "r"(kCluster * N) : "memory");
      bar_init_fence();
    }
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }

  // after `mine` is written and a block barrier
  __device__ void trade(int rank) {
    const int t = threadIdx.x, r = t / N, i = t % N;
    // every CTA has started and initialised `bar`
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    if (t < kCluster * N) {
      static_assert(sizeof(T) == 4, "a word");
      asm volatile("st.shared::cluster.b32 [%0], %1;"
                   ::"r"(remote(&slots[rank][i], r)),
                     "r"(*reinterpret_cast<const uint32_t*>(&mine[i]))
                   : "memory");
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
          ::"r"(remote(&bar, r)) : "memory");
    }
    for (uint32_t spin = 0;; ++spin) {
      uint32_t done;
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64"
          " p, [%1], 0;\n"
          " selp.u32 %0, 1, 0, p;\n}"
          : "=r"(done) : "r"(smem(&bar)) : "memory");
      if (done) break;
      if (spin == kSpinLimit) __trap();
    }
  }
};

// the CTA's rows of x into the padded shared copy: one tensor copy of the
// box of `map`, on one mbarrier
__device__ void stage_rows(const CUtensorMap& map, float* rows, int rank) {
  __shared__ uint64_t bar;
  if (threadIdx.x == 0) {
    bar_init(&bar);
    bar_init_fence();
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem(&bar)), "r"((uint32_t)kSharedBytes) : "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
        ::"r"(smem(rows)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(0),
          "r"(rank * kCtaRows), "r"(smem(&bar)) : "memory");
  }
  __syncthreads();    // every thread waits on an initialised barrier
  bar_wait(&bar, 0);
}

// the sum of one value a thread over the CTA, in a fixed order
__device__ float cta_sum(float v) {
  __shared__ float warp_sums[kWarps];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;
}

// the cluster's sum of the CTAs' partials, added in rank order (every CTA
// gets the same bits)
__device__ float cluster_total(Inbox<float, 1>& in, float partial,
                               int rank) {
  if (threadIdx.x == 0) in.mine[0] = partial;
  __syncthreads();
  in.trade(rank);
  float total = 0.0f;
  for (int r = 0; r < kCluster; ++r) total += in.slots[r][0];
  return total;
}

// the CTA's rows of the output, every element `value`
__device__ void fill(float* __restrict__ out, int rank, float value) {
  float4* dst = reinterpret_cast<float4*>(out + (size_t)rank * kCtaRows
                                          * kCols);
  const float4 v = make_float4(value, value, value, value);
  for (int e = threadIdx.x; e < kCtaRows * kGroups; e += kThreads)
    dst[e] = v;
}

// the timing instance's clock readings in thread 0 of a CTA
template <int TIMED>
struct Timer {
  long long entry = 0;
  long long at[kMarks] = {};
  __device__ Timer() {
    if (TIMED) entry = clock_now();
  }
  __device__ void mark(int m) {
    if (TIMED) at[m] = clock_now();
  }
  // after a block barrier: every thread has reached it
  __device__ void mark_all(int m) {
    if (!TIMED) return;
    __syncthreads();
    at[m] = clock_now();
  }
  // the marks, as the CTA leaves
  __device__ void write(long long* cycles, int rank) {
    if (!TIMED || threadIdx.x != 0) return;
    mark(kMarkExit);
#pragma unroll
    for (int m = 0; m < kMarks; ++m)
      cycles[kMarks * rank + m] = at[m] - entry;
  }
};

template <int TIMED>
__global__ void __launch_bounds__(kThreads)
column_sum(float* __restrict__ out, long long* cycles, const ProbeParams p,
           const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) float rows[];
  __shared__ Inbox<float, 1> inbox;
  Timer<TIMED> timer;
  const int rank = (int)cg::this_cluster().block_rank();
  inbox.open();
  stage_rows(map, rows, rank);
  timer.mark(kMarkStaged);
  const float* row = rows + threadIdx.x * kStride;
  timer.mark_all(kMarkLoopStart);
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < p.cols; ++c) acc += row[c];
  timer.mark_all(kMarkLoopEnd);
  const float total = cluster_total(inbox, cta_sum(acc), rank);
  timer.mark(kMarkFillStart);
  fill(out, rank, total);
  timer.mark(kMarkFillEnd);
  timer.write(cycles, rank);
}

template <int TIMED>
__global__ void __launch_bounds__(kThreads)
scalar_sum(float* __restrict__ out, long long* cycles, const ProbeParams p,
           const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) float rows[];
  __shared__ float col_sums[kCols];
  __shared__ Inbox<float, 1> inbox;
  Timer<TIMED> timer;
  const int rank = (int)cg::this_cluster().block_rank();
  inbox.open();
  stage_rows(map, rows, rank);
  timer.mark(kMarkStaged);
  for (int c = threadIdx.x; c < kCols; c += kThreads) {
    float s = 0.0f;
    for (int r = 0; r < kCtaRows; ++r) s += rows[r * kStride + c];
    col_sums[c] = s;
  }
  __syncthreads();
  timer.mark_all(kMarkLoopStart);
  float total = 0.0f;
#pragma unroll 1
  for (int c = 0; c < p.cols; ++c) total += col_sums[c];
  timer.mark_all(kMarkLoopEnd);
  total = cluster_total(inbox, total, rank);
  timer.mark(kMarkFillStart);
  fill(out, rank, total);
  timer.mark(kMarkFillEnd);
  timer.write(cycles, rank);
}

template <int TIMED>
__global__ void __launch_bounds__(kThreads)
gated_loop(float* __restrict__ out, long long* cycles, const ProbeParams p,
           const __grid_constant__ CUtensorMap map) {
  extern __shared__ __align__(128) float rows[];
  __shared__ Inbox<uint32_t, kMaskWords> inbox;   // the columns that fire
  __shared__ float sums[kCtaRows];
  Timer<TIMED> timer;
  const int rank = (int)cg::this_cluster().block_rank();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kMaskWords) inbox.mine[threadIdx.x] = 0;
  inbox.open();
  stage_rows(map, rows, rank);               // its barrier orders the zeros
  timer.mark(kMarkStaged);
  const float* row = rows + threadIdx.x * kStride;
  // the CTA's mask from its rows, four columns a 16-byte read
  uint32_t words[kMaskWords] = {};
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const float4 v = reinterpret_cast<const float4*>(row)[g];
    const uint32_t bits = (v.x > 2.0f) | (v.y > 2.0f) << 1
                          | (v.z > 2.0f) << 2 | (v.w > 2.0f) << 3;
    words[g / 8] |= bits << (g % 8 * 4);
  }
#pragma unroll
  for (int w = 0; w < kMaskWords; ++w) {
    const uint32_t any = __reduce_or_sync(0xffffffffu, words[w]);
    if (lane == 0) atomicOr(&inbox.mine[w], any);
  }
  __syncthreads();            // the CTA's mask is complete
  inbox.trade(rank);
  // word w of the cluster's mask in lane w (mod kMaskWords)
  uint32_t gate = inbox.slots[lane / kMaskWords][lane % kMaskWords];
  for (int off = kMaskWords; off < 32; off <<= 1)
    gate |= __shfl_xor_sync(0xffffffffu, gate, off);
  timer.mark_all(kMarkLoopStart);
  float s = 0.0f;
#pragma unroll 1
  for (int c = 0; c < p.cols; ++c) {
    const float m = row[c];
    if (__shfl_sync(0xffffffffu, gate, c >> 5) >> (c & 31) & 1) s += m;
  }
  timer.mark_all(kMarkLoopEnd);
  sums[threadIdx.x] = s;
  __syncthreads();
  timer.mark(kMarkFillStart);
  float4* dst = reinterpret_cast<float4*>(out + (size_t)rank * kCtaRows
                                          * kCols);
  for (int e = threadIdx.x; e < kCtaRows * kGroups; e += kThreads) {
    const float v = sums[e / kGroups];
    dst[e] = make_float4(v, v, v, v);
  }
  timer.mark(kMarkFillEnd);
  timer.write(cycles, rank);
}

__global__ void __launch_bounds__(kThreads)
empty_cluster(float*, long long*, const ProbeParams,
              const __grid_constant__ CUtensorMap) {}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query (no link against libcuda)
typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  static cudaError_t err = cudaSuccess;
  static std::once_flag once;
  std::call_once(once, [] {
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", (void**)&found, 12000, cudaEnableDefault,
        &status);
#else
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&found,
                                  cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status != cudaDriverEntryPointSuccess)
      err = cudaErrorSymbolNotFound;
  });
  *fn = found;
  return err;
}

// the tensor map of x's padded rows: boxes kStride columns wide (the
// columns past kCols read as zeros) and kCtaRows rows deep.  The map of
// the last x is kept: it depends on x's address alone (the shape is
// fixed), and a device address names one allocation of one device.
cudaError_t padded_rows_map(const float* x, CUtensorMap* map) {
  static std::mutex lock;
  static const float* last_x = nullptr;
  static CUtensorMap last_map;
  std::lock_guard<std::mutex> guard(lock);
  if (x != last_x) {
    EncodeTiled encode;
    const cudaError_t err = encode_tiled(&encode);
    if (err != cudaSuccess) return err;
    const cuuint64_t dims[2] = {kCols, kRows};
    const cuuint64_t strides[1] = {kRowBytes};
    const cuuint32_t box[2] = {kStride, kCtaRows};
    const cuuint32_t steps[2] = {1, 1};
    const CUresult res = encode(
        &last_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)x, dims,
        strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) {
      last_x = nullptr;
      return cudaErrorInvalidValue;
    }
    last_x = x;
  }
  *map = last_map;
  return cudaSuccess;
}

// one cluster of `fn` on `stream`; the empty launch takes no tensor map
template <typename Fn>
cudaError_t launch_cluster(Fn fn, const float* x, float* out,
                           long long* cycles, ProbeParams p,
                           cudaStream_t stream) {
  CUtensorMap map = {};
  if (p.which != kEmptyLaunch) {
    const cudaError_t err = padded_rows_map(x, &map);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSharedBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fn, out, cycles, p, map);
}

}  // namespace

// The version of this C interface (scripts/probe_kernel_ops.py:
// INTERFACE): 2 added `cycles`; a build without this function is 1.
extern "C" int srt_probe_interface() { return 2; }

// Probe p.which on x into out, one cluster on `stream`; with a non-null
// `cycles` (kCluster x kMarks int64s) the timing instance, which writes
// each CTA's SM cycles from its entry to each Mark.  x and out are
// 16-byte aligned.
extern "C" int srt_probe_launch(const float* x, float* out,
                                long long* cycles, ProbeParams p,
                                void* stream) {
  if (p.rows != kRows || p.cols != kCols) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)x | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const bool timed = cycles != nullptr;
  switch (p.which) {
    case kColumnSum:
      err = launch_cluster(timed ? &column_sum<1> : &column_sum<0>, x, out,
                           cycles, p, st);
      break;
    case kScalarSum:
      err = launch_cluster(timed ? &scalar_sum<1> : &scalar_sum<0>, x, out,
                           cycles, p, st);
      break;
    case kGatedLoop:
      err = launch_cluster(timed ? &gated_loop<1> : &gated_loop<0>, x, out,
                           cycles, p, st);
      break;
    case kEmptyLaunch:
      err = launch_cluster(empty_cluster, x, out, cycles, p, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
