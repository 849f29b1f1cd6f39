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
// read about 1.05 times and nw = n/50 int64 sums are written, ~2.2 B of
// device memory traffic per base for uint16 tracks, so the kernel is meant
// to be bound by bandwidth.  The work per element has to stay a few
// instructions for that: a scan with one warp shuffle chain per element is
// bound by shuffle and load issue instead.  Design:
//
// - one block per tile of kTile consecutive windows of one row (blockIdx.y
//   is the row, so one launch covers a contig's depth and MQ tracks);
// - the block walks the tile's input span [j0*S, (j1-1)*S + W) in chunks of
//   kChunk elements; each thread loads 16 bytes at a time (8 uint16 or 4
//   int32), neighbouring threads on neighbouring addresses, in kRounds
//   rounds per chunk.  The span's first address is rounded down to 16
//   bytes (rows and tiles start anywhere) and the elements outside the span
//   are zeroed, so the prefix runs over "virtual" positions shifted by the
//   `lead` elements before the span's start;
// - each thread sums its vector first; one warp scan of those sums then
//   serves kVec elements (for uint16 in int32: a chunk of 8,192 sums to at
//   most 536,862,720 < 2^31; int32 input scans in int64, its values may be
//   negative or large); the warps' totals meet in shared memory, and each
//   thread writes its elements' chunk-relative inclusive prefix there
//   (int32 for uint16, int64 for int32) behind a running int64 carry;
// - the next chunk's vectors are loaded into registers before the current
//   chunk is scanned, so loads stay in flight through the scan;
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
constexpr int kRounds = 4;                         // vectors a thread a chunk
constexpr int kWinPerThread = 4;
constexpr int kTile = kThreads * kWinPerThread;    // windows per block
constexpr unsigned kFull = 0xFFFFFFFFu;

enum DType { kInt32 = 0, kUInt16 = 1 };

// Acc: the chunk-relative sums; kVec: elements in 16 bytes
template <typename T> struct Traits;
template <> struct Traits<uint16_t> {
  using Acc = int;
  static constexpr int kVec = 8;
};
template <> struct Traits<int32_t> {
  using Acc = long long;
  static constexpr int kVec = 4;
};

// element e of a 16-byte vector
template <typename T>
__device__ __forceinline__ typename Traits<T>::Acc elem(const uint4& v,
                                                        int e);
template <>
__device__ __forceinline__ int elem<uint16_t>(const uint4& v, int e) {
  const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return static_cast<int>((e & 1) ? w >> 16 : w & 0xFFFFu);
}
template <>
__device__ __forceinline__ long long elem<int32_t>(const uint4& v, int e) {
  const unsigned w = e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  return static_cast<long long>(static_cast<int>(w));
}

// keep-masks of the four 32-bit words of a vector for its elements in
// [lo, hi) (element indices of the vector)
template <typename T>
__device__ __forceinline__ unsigned word_mask(int k, long long lo,
                                              long long hi);
template <>
__device__ __forceinline__ unsigned word_mask<uint16_t>(int k, long long lo,
                                                        long long hi) {
  return (2 * k >= lo && 2 * k < hi ? 0x0000FFFFu : 0u) |
         (2 * k + 1 >= lo && 2 * k + 1 < hi ? 0xFFFF0000u : 0u);
}
template <>
__device__ __forceinline__ unsigned word_mask<int32_t>(int k, long long lo,
                                                       long long hi) {
  return k >= lo && k < hi ? 0xFFFFFFFFu : 0u;
}

// the 16 bytes holding pre[h * kVec / 2 ...] (h = 0, 1): 4 int or 2 int64
__device__ __forceinline__ uint4 half_of(const int* pre, int h) {
  return make_uint4(pre[4 * h], pre[4 * h + 1], pre[4 * h + 2],
                    pre[4 * h + 3]);
}
__device__ __forceinline__ uint4 half_of(const long long* pre, int h) {
  const unsigned long long a = pre[2 * h], b = pre[2 * h + 1];
  return make_uint4(static_cast<unsigned>(a), static_cast<unsigned>(a >> 32),
                    static_cast<unsigned>(b), static_cast<unsigned>(b >> 32));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
window_sums_kernel(const T* __restrict__ x, long long n, int window,
                   long long stride, long long nw,
                   long long* __restrict__ out) {
  using Acc = typename Traits<T>::Acc;
  constexpr int kVec = Traits<T>::kVec;
  constexpr int kChunk = kThreads * kRounds * kVec;   // elements per chunk
  __shared__ __align__(16) Acc scan[kChunk];
  __shared__ Acc warp_tot[kRounds][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const T* xr = x + static_cast<long long>(blockIdx.y) * n;
  long long* outr = out + static_cast<long long>(blockIdx.y) * nw;

  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long j1 = min(j0 + kTile, nw);
  const long long s0 = min(j0 * stride, n);
  const long long span = min((j1 - 1) * stride + window, n) - s0;

  // the span from its 16-byte-aligned start: virtual position p holds
  // x[s0 + p - lead] for lead <= p < vend, zero elsewhere
  const uintptr_t first = reinterpret_cast<uintptr_t>(xr + s0);
  const uint4* vec = reinterpret_cast<const uint4*>(first & ~uintptr_t(15));
  const int lead = static_cast<int>((first & 15) / sizeof(T));
  const long long vend = span > 0 ? lead + span : 0;

  // window boundaries as virtual positions; P at virtual position b (the
  // sum of the span's elements before it) is the inclusive prefix at b - 1,
  // and P = 0 at b <= lead, so an unused slot needs no lookup
  long long st_v[kWinPerThread], en_v[kWinPerThread], acc[kWinPerThread];
#pragma unroll
  for (int q = 0; q < kWinPerThread; ++q) {
    const long long j = j0 + q * kThreads + threadIdx.x;
    st_v[q] = en_v[q] = acc[q] = 0;
    if (j < j1) {
      st_v[q] = min(j * stride, n) - s0 + lead;
      en_v[q] = min(j * stride + window, n) - s0 + lead;
    }
  }

  // round r of a chunk: vector r * kThreads + threadIdx.x of it
  uint4 nxt[kRounds];
  auto load = [&](long long c0) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const long long p = c0 + (r * kThreads + threadIdx.x) * kVec;
      nxt[r] = make_uint4(0, 0, 0, 0);
      if (p < vend) {
        uint4 v = __ldg(vec + p / kVec);
        if (p < lead || p + kVec > vend) {
          v.x &= word_mask<T>(0, lead - p, vend - p);
          v.y &= word_mask<T>(1, lead - p, vend - p);
          v.z &= word_mask<T>(2, lead - p, vend - p);
          v.w &= word_mask<T>(3, lead - p, vend - p);
        }
        nxt[r] = v;
      }
    }
  };

  load(0);
  long long carry = 0;                   // sum of the chunks before c0
  for (long long c0 = 0; c0 < vend; c0 += kChunk) {
    uint4 cur[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) cur[r] = nxt[r];
    if (c0 + kChunk < vend) load(c0 + kChunk);

    // each vector's sum, then a warp scan of those per round
    Acc incl[kRounds], own[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      Acc s = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += elem<T>(cur[r], e);
      own[r] = incl[r] = s;
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const Acc t = __shfl_up_sync(kFull, incl[r], d);
        if (lane >= d) incl[r] += t;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int r = 0; r < kRounds; ++r) warp_tot[r][warp] = incl[r];
    }
    __syncthreads();

    // the vectors' chunk-relative inclusive prefixes into shared memory;
    // lanes 4-7 of each 8 write their second 16 bytes first, so the eight
    // lanes of a store cover all 32 banks once
    Acc base = 0;
    const bool swap = (lane >> 2) & 1;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      Acc before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const Acc t = warp_tot[r][w];
        if (w < warp) before += t;
        total += t;
      }
      Acc run = base + before + incl[r] - own[r];
      Acc pre[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        run += elem<T>(cur[r], e);
        pre[e] = run;
      }
      uint4* dst = reinterpret_cast<uint4*>(
          scan + (r * kThreads + threadIdx.x) * kVec);
      const uint4 lo = half_of(pre, 0), hi = half_of(pre, 1);
      dst[swap] = swap ? hi : lo;
      dst[!swap] = swap ? lo : hi;
      base += total;
    }
    __syncthreads();

    // scan[i] = P at virtual position c0 + i + 1 (minus carry)
#pragma unroll
    for (int q = 0; q < kWinPerThread; ++q) {
      const unsigned long long si = st_v[q] - c0 - 1;
      const unsigned long long ei = en_v[q] - c0 - 1;
      if (si < kChunk) acc[q] -= carry + scan[si];
      if (ei < kChunk) acc[q] += carry + scan[ei];
    }
    carry += base;
    // the next chunk writes warp_tot after this chunk's last read of it
    // (before the barrier above) and scan after its own first barrier
  }

#pragma unroll
  for (int q = 0; q < kWinPerThread; ++q) {
    const long long j = j0 + q * kThreads + threadIdx.x;
    if (j < j1) outr[j] = acc[q];
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
