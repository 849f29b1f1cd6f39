// Strided sliding-window sums for NVIDIA Hopper (sm_90a).
//
// Replaces cornetto_tpu/kernels/pallas_window.py::sliding_window_sum_pallas
// (body `kernel` over _doubling_body) together with the strided gather that
// cornetto_tpu/kernels/window_sum.py::_window_sums_strided applies to its
// output.  For each row r of x (R rows of n elements, int32 or uint16):
//
//   out[r, j] = sum(x[r, j*S : min(j*S + W, n)])   for j < nw,
//
// positions past the end counting as zero.  With S = 1 and nw = n this is
// exactly the TPU kernel's result; the window-stats path calls it with
// S = window_inc, so the card writes the nw ~ n/S window sums and never the
// n-long sliding-sum array the TPU kernel writes before its gather.  Sums
// are int64, exact for any W (the TPU path is int32 and stops at W = 32767).
// Plain PyTorch version: cornetto_tpu_torch/kernels/window_sum.py::
// window_sums_ref.
//
// What bounds it: at the defaults (W = 2500, S = 50) a row of n depths is
// read about 1.05 times and nw = n/50 int64 sums are written, so device
// memory traffic is ~2.3 B per base for uint16 tracks; the work per element
// is a warp shuffle scan, so the card is bound by shuffle and load issue,
// not by bandwidth.  Design:
//
// - one block per tile of kTile consecutive windows of one row (blockIdx.y
//   is the row, so one launch covers a contig's depth and MQ tracks);
// - the block walks the tile's input span [j0*S, (j1-1)*S + W) in chunks of
//   kChunk elements: each warp loads 32 neighbouring elements at a time
//   (coalesced), scans them with shuffles in int64, and the eight warps'
//   totals give the chunk's inclusive prefix sums, staged in shared memory
//   behind a running carry;
// - each thread owns kWinPerThread windows and picks the prefix at its
//   windows' start and end positions as the chunk holding them goes by, so
//   a window of any width costs two reads of shared memory;
// - out = P[end] - P[start]; the TPU kernel's binary-decomposition doubling
//   pyramid in VMEM is not carried over.
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/_build.py);
// the caller allocates the output and passes its current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = 8;                        // rounds of 32 per warp
constexpr int kChunk = kThreads * kPerLane;        // elements per chunk
constexpr int kWinPerThread = 4;
constexpr int kTile = kThreads * kWinPerThread;    // windows per block
constexpr unsigned kFull = 0xFFFFFFFFu;

enum DType { kInt32 = 0, kUInt16 = 1 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_sums_kernel(const T* __restrict__ x, long long n, int window,
                   long long stride, long long nw,
                   long long* __restrict__ out) {
  __shared__ long long scan[kChunk];
  __shared__ long long warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* xr = x + static_cast<long long>(blockIdx.y) * n;
  long long* outr = out + static_cast<long long>(blockIdx.y) * nw;

  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long j1 = min(j0 + kTile, nw);
  const long long s0 = min(j0 * stride, n);
  const long long span = min((j1 - 1) * stride + window, n) - s0;

  // window boundaries relative to s0 and the prefix sums found at them;
  // P[0] = 0, so a boundary at 0 (and an unused slot) needs no lookup
  long long st_rel[kWinPerThread], en_rel[kWinPerThread];
  long long st_val[kWinPerThread], en_val[kWinPerThread];
#pragma unroll
  for (int q = 0; q < kWinPerThread; ++q) {
    const long long j = j0 + q * kThreads + threadIdx.x;
    st_rel[q] = en_rel[q] = 0;
    st_val[q] = en_val[q] = 0;
    if (j < j1) {
      st_rel[q] = min(j * stride, n) - s0;
      en_rel[q] = min(j * stride + window, n) - s0;
    }
  }

  long long carry = 0;                   // sum of the chunks before c0
  for (long long c0 = 0; c0 < span; c0 += kChunk) {
    long long v[kPerLane];
    long long run = 0;                   // this warp's sum so far
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const long long i = c0 + (warp * kPerLane + k) * 32 + lane;
      long long a = i < span ? static_cast<long long>(xr[s0 + i]) : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const long long t = __shfl_up_sync(kFull, a, d);
        if (lane >= d) a += t;
      }
      v[k] = run + a;
      run += __shfl_sync(kFull, a, 31);
    }
    if (lane == 0) warp_tot[warp] = run;
    __syncthreads();
    long long before = carry, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const long long t = warp_tot[w];
      if (w < warp) before += t;
      total += t;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k)
      scan[(warp * kPerLane + k) * 32 + lane] = before + v[k];
    __syncthreads();
    // scan[i] = P[c0 + i + 1]: boundaries in (c0, c0 + kChunk]
#pragma unroll
    for (int q = 0; q < kWinPerThread; ++q) {
      if (st_rel[q] > c0 && st_rel[q] <= c0 + kChunk)
        st_val[q] = scan[st_rel[q] - c0 - 1];
      if (en_rel[q] > c0 && en_rel[q] <= c0 + kChunk)
        en_val[q] = scan[en_rel[q] - c0 - 1];
    }
    carry += total;
    __syncthreads();                     // scan and warp_tot are reused
  }

#pragma unroll
  for (int q = 0; q < kWinPerThread; ++q) {
    const long long j = j0 + q * kThreads + threadIdx.x;
    if (j < j1) outr[j] = en_val[q] - st_val[q];
  }
}

template <typename T>
cudaError_t launch(const void* x, int rows, long long n, int window,
                   long long stride, long long nw, void* out,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((nw + kTile - 1) / kTile),
                  static_cast<unsigned>(rows));
  window_sums_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, window, stride, nw,
      static_cast<long long*>(out));
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) int32 (dtype 0) or uint16 (dtype 1), out (rows, nw) int64,
// both contiguous on the current device; window >= 1, stride >= 1, nw >= 1.
// Returns a cudaError_t (0 = launched).
extern "C" int cornetto_window_sums(const void* x, int dtype, int rows,
                                    long long n, int window, long long stride,
                                    long long nw, void* out, void* stream) {
  if (rows < 1 || rows > 65535 || n < 0 || window < 1 || stride < 1 ||
      nw < 1 || (nw + kTile - 1) / kTile > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kInt32)
    return static_cast<int>(
        launch<int32_t>(x, rows, n, window, stride, nw, out, s));
  if (dtype == kUInt16)
    return static_cast<int>(
        launch<uint16_t>(x, rows, n, window, stride, nw, out, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
