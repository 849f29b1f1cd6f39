// Telomere-motif scans for NVIDIA Hopper (sm_90a): the match mask and the
// per-read run statistics, one build with two entry points.
//
// Replaces cornetto_tpu/kernels/pallas_telo.py::telo_match_mask_pallas
// (body _mask_kernel) and ::telo_run_stats_pallas (body _stats_kernel),
// which equal cornetto_tpu/kernels/telo_scan.py's XLA functions.  Plain
// PyTorch versions: cornetto_tpu_torch/kernels/telo.py::telo_match_mask_ref
// and ::telo_run_stats_ref.
//
// match[i] = AND_j codes[i + j] == motif[j] for i < m = L - k + 1, else 0
// (codes >= 4 never match; the motif is 0-3 codes in a device buffer of any
// length k).
//
// - Mask: one thread per position of the (B, L) batch, int64 indexing, k
//   byte compares through the read-only cache (neighbouring threads share
//   the bytes).  The TPU version tiles a contig into 64 Kb rows with a k - 1
//   halo; here a contig is one row of any length.  Bound by device memory:
//   one byte read and one written per base.
// - Run stats: one block per read.  Threads stride over the positions,
//   count the matches and, at each start of a stride-k run (a match with no
//   match k before it), walk the run; the block reduces the count, the
//   longest run and the run at position 0.  The TPU kernel builds the run
//   length at every position with steps = ceil(log2(max(m // k, 1)))
//   doubling passes, which cap it at 2^steps copies; the result here is
//   capped the same way (longest = min(run, 2^steps), terminal =
//   min(run[0], 2^steps) >= thresh), so it is bit-equal to
//   telo_run_stats_jax.  Bound by the k compares per base and the walks
//   (~3k byte compares per base in all).
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/_build.py);
// the caller allocates the outputs and passes its current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaskThreads = 256;
constexpr int kStatsThreads = 128;

__device__ __forceinline__ bool match_at(const uint8_t* __restrict__ row,
                                         long long i,
                                         const uint8_t* __restrict__ motif,
                                         int k) {
  for (int j = 0; j < k; ++j)
    if (__ldg(row + i + j) != __ldg(motif + j)) return false;
  return true;
}

__global__ void __launch_bounds__(kMaskThreads)
mask_kernel(const uint8_t* __restrict__ codes, long long B, long long L,
            const uint8_t* __restrict__ motif, int k,
            int8_t* __restrict__ out) {
  const long long m = L - k + 1;
  const long long total = B * L;
  for (long long p = static_cast<long long>(blockIdx.x) * kMaskThreads +
                     threadIdx.x;
       p < total; p += static_cast<long long>(gridDim.x) * kMaskThreads) {
    const long long row = p / L;
    const long long i = p - row * L;
    out[p] = (i < m && match_at(codes + row * L, i, motif, k)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kStatsThreads)
stats_kernel(const uint8_t* __restrict__ codes, long long L,
             const uint8_t* __restrict__ motif, int k, long long cap,
             int thresh, int32_t* __restrict__ n_out,
             int32_t* __restrict__ longest_out,
             uint8_t* __restrict__ terminal_out) {
  __shared__ long long s_n[kStatsThreads / 32];
  __shared__ long long s_max[kStatsThreads / 32];
  const uint8_t* row = codes + static_cast<long long>(blockIdx.x) * L;
  const long long m = L - k + 1;
  long long n = 0, best = 0, run0 = 0;    // run0: thread 0's position 0
  for (long long i = threadIdx.x; i < m; i += kStatsThreads) {
    if (!match_at(row, i, motif, k)) continue;
    ++n;
    if (i >= k && match_at(row, i - k, motif, k)) continue;  // not a start
    long long run = 1;
    for (long long p = i + k; p < m && match_at(row, p, motif, k); p += k)
      ++run;
    best = max(best, run);
    if (i == 0) run0 = run;
  }
  for (int d = 16; d > 0; d >>= 1) {
    n += __shfl_down_sync(0xFFFFFFFFu, n, d);
    best = max(best, __shfl_down_sync(0xFFFFFFFFu, best, d));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_n[warp] = n;
    s_max[warp] = best;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long tn = 0, tb = 0;
    for (int w = 0; w < kStatsThreads / 32; ++w) {
      tn += s_n[w];
      tb = max(tb, s_max[w]);
    }
    n_out[blockIdx.x] = static_cast<int32_t>(tn);
    longest_out[blockIdx.x] = static_cast<int32_t>(min(tb, cap));
    terminal_out[blockIdx.x] = min(run0, cap) >= thresh ? 1 : 0;
  }
}

}  // namespace

// codes (B, L) uint8 and out (B, L) int8, contiguous on the current device;
// motif: k codes 0-3 on the device.  Returns a cudaError_t (0 = launched).
extern "C" int cornetto_telo_mask(const void* codes, long long B, long long L,
                                  const void* motif, int k, void* out,
                                  void* stream) {
  if (B < 1 || L < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = B * L;
  const long long want = (total + kMaskThreads - 1) / kMaskThreads;
  const unsigned blocks =
      static_cast<unsigned>(want < (1LL << 20) ? want : (1LL << 20));
  mask_kernel<<<blocks, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), B, L,
      static_cast<const uint8_t*>(motif), k, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// codes (B, L) uint8 on the current device, motif k codes 0-3 there;
// steps = ceil(log2(max((L - k + 1) // k, 1))) (the TPU kernel's doubling
// passes), thresh = ceil(min_run_bases / k).  Writes n (B,) int32, longest
// (B,) int32, terminal (B,) uint8.  Returns a cudaError_t (0 = launched).
extern "C" int cornetto_telo_stats(const void* codes, int B, long long L,
                                   const void* motif, int k, int steps,
                                   int thresh, void* n, void* longest,
                                   void* terminal, void* stream) {
  if (B < 1 || L < 1 || k < 1 || steps < 0 || steps > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  stats_kernel<<<static_cast<unsigned>(B), kStatsThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), L,
      static_cast<const uint8_t*>(motif), k, 1LL << steps, thresh,
      static_cast<int32_t*>(n), static_cast<int32_t*>(longest),
      static_cast<uint8_t*>(terminal));
  return static_cast<int>(cudaGetLastError());
}
