// Minimizer extraction for NVIDIA Hopper (sm_90a).
//
// Replaces cornetto_tpu/kernels/pallas_extract.py::extract_minima_pallas
// (kernel bodies _extract_kernel, _extract_kernel_nfree and
// _extract_kernel_len over _doubling_minimizers).  For each read of 2-bit
// packed codes it builds every canonical k-mer, hashes it with the
// minimap2-style 32-bit finalizer and writes the minimum hash of each
// stride-w window, 0xFFFFFFFF where a window holds no valid k-mer.
// Output equals the TPU kernel's bit for bit; plain PyTorch version:
// cornetto_tpu_torch/kernels/extract.py::extract_minima_ref.
//
// What bounds it: at the decision loop's shapes (L=450, k=15, w=10) a read
// brings 113 B of packed codes and takes away 43 minima (172 B of uint32 +
// 43 B of flags), while each of its 436 k-mers costs a k-step word build and
// a 7-step hash: roughly 4e8 integer operations per 4096-read batch against
// 1.3 MB of device-memory traffic.  Integer issue, not bandwidth, is the
// limit, so the design keeps every intermediate on chip:
//
// - one block per tile of up to kMaxRows reads; the tile's packed bytes
//   (and N bitmap) are contiguous in device memory and staged in shared
//   memory with one coalesced copy;
// - one thread per k-mer start builds the forward word and its reverse
//   complement with a direct loop over the k bases, hashes min(fwd, rev)
//   and stages the hash in shared memory (the TPU kernel's lane-roll
//   doubling pyramid is a Mosaic idiom, not needed here);
// - one thread per window takes the min of its w hashes and writes only the
//   nwin minima, not the TPU kernel's full (B, Lp) sliding-min array.
//
// CUDA has an unsigned min, so the TPU kernel's sortable-signed int32
// transform (a workaround for Mosaic's missing unsigned vector min) is gone.
//
// Validity selects one of three template variants: N-free (all k-mers
// valid), per-read lengths (k-mer i valid iff i + k - 1 < length) or an N
// bitmap (valid iff none of its k bases is flagged).
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/_build.py);
// the caller allocates the outputs and passes its current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 4;                   // reads per block
constexpr size_t kTileBudget = 32 * 1024;     // shared bytes aimed at per block
constexpr size_t kDefaultSmemLimit = 48 * 1024;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;

enum Validity { kNFree = 0, kLengths = 1, kNMask = 2 };

// hash32_jax (cornetto_tpu/kernels/minimizer.py), wrapping uint32 math
__device__ __forceinline__ uint32_t hash32(uint32_t x) {
  x = (~x) + (x << 21);
  x = x ^ (x >> 24);
  x = x + (x << 3) + (x << 8);
  x = x ^ (x >> 14);
  x = x + (x << 2) + (x << 4);
  x = x ^ (x >> 28);
  x = x + (x << 31);
  return x;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
extract_minima_kernel(const uint8_t* __restrict__ packed,
                      const uint8_t* __restrict__ nmask,
                      const int32_t* __restrict__ lengths,
                      int B, int L, int k, int w, int rows,
                      uint32_t* __restrict__ hmin,
                      uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t smem[];
  const int m = L - k + 1;
  const int nwin = m / w;
  const int pb = (L + 3) >> 2;
  const int nb = (L + 7) >> 3;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int nrows = static_cast<int>(
      row0 + rows <= B ? rows : B - row0);

  uint32_t* hs = smem;                                    // rows * m
  uint8_t* ps = reinterpret_cast<uint8_t*>(hs + static_cast<size_t>(rows) * m);
  uint8_t* ns = ps + static_cast<size_t>(rows) * pb;      // rows * nb

  const uint8_t* gp = packed + row0 * pb;
  for (int i = threadIdx.x; i < nrows * pb; i += kThreads) ps[i] = gp[i];
  if (V == kNMask) {
    const uint8_t* gn = nmask + row0 * nb;
    for (int i = threadIdx.x; i < nrows * nb; i += kThreads) ns[i] = gn[i];
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nrows * m; t += kThreads) {
    const int r = t / m;
    const int i = t - r * m;
    const uint8_t* p = ps + r * pb;
    uint32_t fwd = 0, rev = 0;
    bool ok = true;
    for (int j = 0; j < k; ++j) {
      const int q = i + j;
      const uint32_t c = (p[q >> 2] >> ((q & 3) << 1)) & 3u;
      fwd = (fwd << 2) | c;                 // big-endian forward word
      rev |= (3u - c) << (j << 1);          // complement, little-endian
      if (V == kNMask) ok = ok && !((ns[r * nb + (q >> 3)] >> (q & 7)) & 1);
    }
    if (V == kLengths) ok = i + k - 1 < lengths[row0 + r];
    hs[t] = ok ? hash32(min(fwd, rev)) : kSentinel;
  }
  __syncthreads();

  for (int t = threadIdx.x; t < nrows * nwin; t += kThreads) {
    const int r = t / nwin;
    const int j = t - r * nwin;
    const uint32_t* h = hs + r * m + j * w;
    uint32_t best = h[0];
    for (int q = 1; q < w; ++q) best = min(best, h[q]);
    const long long o = (row0 + r) * nwin + j;
    hmin[o] = best;
    valid[o] = best != kSentinel;
  }
}

template <int V>
cudaError_t launch(const void* packed, const void* nmask, const void* lengths,
                   int B, int L, int k, int w, void* hmin, void* valid,
                   cudaStream_t stream) {
  const size_t m = static_cast<size_t>(L - k + 1);
  const size_t per_row = m * sizeof(uint32_t) + (L + 3) / 4 +
                         (V == kNMask ? (L + 7) / 8 : 0);
  size_t rows = kTileBudget / per_row;
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const size_t smem = rows * per_row;
  if (smem > kDefaultSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        extract_minima_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = static_cast<unsigned>((B + rows - 1) / rows);
  extract_minima_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(nmask),
      static_cast<const int32_t*>(lengths), B, L, k, w, static_cast<int>(rows),
      static_cast<uint32_t*>(hmin), static_cast<uint8_t*>(valid));
  return cudaGetLastError();
}

}  // namespace

// packed (B, ceil(L/4)) uint8; nmask (B, ceil(L/8)) uint8 or NULL; lengths
// (B,) int32 or NULL (nmask wins when both are given); hmin (B, nwin) uint32
// and valid (B, nwin) uint8 outputs, nwin = (L - k + 1) / w.  All arrays
// contiguous on the current device.  Returns a cudaError_t (0 = launched).
extern "C" int cornetto_extract_minima(const void* packed, const void* nmask,
                                       const void* lengths, int B, int L,
                                       int k, int w, void* hmin, void* valid,
                                       void* stream) {
  if (B < 1 || k < 1 || k > 15 || w < 1 || L < k || (L - k + 1) / w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nmask != nullptr)
    return static_cast<int>(
        launch<kNMask>(packed, nmask, lengths, B, L, k, w, hmin, valid, s));
  if (lengths != nullptr)
    return static_cast<int>(
        launch<kLengths>(packed, nmask, lengths, B, L, k, w, hmin, valid, s));
  return static_cast<int>(
      launch<kNFree>(packed, nmask, lengths, B, L, k, w, hmin, valid, s));
}
