// Hopper counterparts (sm_90a) of the TPU lowering probes of
// scripts/probe_kernel_ops.py:55 run (kernel_a :18, kernel_b :29,
// kernel_c :38): what the per-cluster decisions of a BVH walk cost on this
// card.  Each probe is one thread block over a (512, 128) f32 array (the
// probes' input is all ones) and writes a (512, 128) f32 output:
//   - kColumnSum (A): the array's sum through 128 dynamically indexed
//     column reads of a shared-memory copy (each thread one row), then a
//     block reduction, broadcast to the output;
//   - kScalarSum (B): the column sums into a (128,) shared scratch, then
//     128 scalar reads of it at a dynamic index, broadcast to the output;
//   - kGatedLoop (C): zeros out, then a 128-step loop over the columns of
//     the shared copy gated by a block vote (__syncthreads_or of col > 2),
//     which never fires for the probes' input.
// The column index is the loop's runtime counter (params.cols), never a
// compile-time constant, as the TPU probes slice at pl.ds(c, 1).
//
// A block may hold 227 KB of shared memory, less than the array's 256 KB,
// so A and C stage it as two halves of 256 rows (a row padded to 129
// floats, so that a column read touches 32 banks), and loop over the 128
// columns of each half: 256 iterations a call; B reads the array once from
// global memory and loops 128 times.  Bound: the bytes, 256 KB in and
// 256 KB out (0.16 us at 3.35 TB/s); the probes measure latency, not that.
//
// Arithmetic: the sums are exact for the probes' input (integers below
// 2^24), so each output equals its plain version (probe_kernel_ops.py:
// probe_plain) bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

struct ProbeParams {
  int32_t rows;    // 512
  int32_t cols;    // 128
  int32_t which;   // Probe
};

enum Probe { kColumnSum = 0, kScalarSum = 1, kGatedLoop = 2 };

namespace {

constexpr int kThreads = 256;       // one row of a half per thread
constexpr int kRows = 512;
constexpr int kCols = 128;
constexpr int kHalf = kRows / 2;
constexpr int kStride = kCols + 1;  // padded shared row
constexpr size_t kSharedBytes = sizeof(float) * kHalf * kStride;
constexpr int kMaxDevices = 64;

// the block's sum of one value per thread, in a fixed order
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
  return total;
}

// rows [half * kHalf, (half + 1) * kHalf) of x into the padded shared copy
__device__ void stage_half(const float* __restrict__ x, float* scr,
                           int half) {
  __syncthreads();   // every thread is done with the last half
  const float* src = x + (size_t)half * kHalf * kCols;
  for (int e = threadIdx.x; e < kHalf * kCols; e += kThreads)
    scr[(e / kCols) * kStride + e % kCols] = src[e];
  __syncthreads();
}

__device__ void fill(float* __restrict__ out, float value) {
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) out[e] = value;
}

__global__ void __launch_bounds__(kThreads)
column_sum(const float* __restrict__ x, float* __restrict__ out,
           const ProbeParams p) {
  extern __shared__ float scr[];
  float acc = 0.0f;
  for (int half = 0; half < 2; ++half) {
    stage_half(x, scr, half);
    for (int c = 0; c < p.cols; ++c) acc += scr[threadIdx.x * kStride + c];
  }
  fill(out, block_sum(acc));
}

__global__ void __launch_bounds__(kThreads)
scalar_sum(const float* __restrict__ x, float* __restrict__ out,
           const ProbeParams p) {
  __shared__ float col_sums[kCols];
  if (threadIdx.x < kCols) {
    float s = 0.0f;
    for (int r = 0; r < p.rows; ++r) s += x[r * kCols + threadIdx.x];
    col_sums[threadIdx.x] = s;
  }
  __syncthreads();
  float total = 0.0f;
  for (int c = 0; c < p.cols; ++c) total += col_sums[c];
  fill(out, total);
}

__global__ void __launch_bounds__(kThreads)
gated_loop(const float* __restrict__ x, float* __restrict__ out,
           const ProbeParams p) {
  extern __shared__ float scr[];
  fill(out, 0.0f);
  for (int half = 0; half < 2; ++half) {
    stage_half(x, scr, half);
    const int row = half * kHalf + threadIdx.x;
    for (int c = 0; c < p.cols; ++c) {
      const float m = scr[threadIdx.x * kStride + c];
      if (__syncthreads_or(m > 2.0f)) {
        for (int j = 0; j < kCols; ++j) out[row * kCols + j] += m;
      }
    }
  }
}

}  // namespace

extern "C" int srt_probe_launch(const float* x, float* out, ProbeParams p,
                                void* stream) {
  if (p.rows != kRows || p.cols != kCols) return (int)cudaErrorInvalidValue;
  // A and C stage half the array: above the 48 KB a launch gets by
  // default.  The attribute belongs to the current device, so it is set
  // once for each device, under a lock (launches may come from several
  // threads)
  static bool configured[kMaxDevices] = {};
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> guard(lock);
    if (!configured[dev]) {
      const void* staged[] = {(const void*)column_sum,
                              (const void*)gated_loop};
      for (const void* fn : staged) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)kSharedBytes);
        if (err != cudaSuccess) return (int)err;
      }
      configured[dev] = true;
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (p.which) {
    case kColumnSum:
      column_sum<<<1, kThreads, kSharedBytes, st>>>(x, out, p);
      break;
    case kScalarSum:
      scalar_sum<<<1, kThreads, 0, st>>>(x, out, p);
      break;
    case kGatedLoop:
      gated_loop<<<1, kThreads, kSharedBytes, st>>>(x, out, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* srt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
