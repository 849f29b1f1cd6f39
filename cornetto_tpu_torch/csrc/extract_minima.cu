// Minimizer extraction for NVIDIA Hopper (sm_90a).
//
// Replaces cornetto_tpu/kernels/pallas_extract.py::extract_minima_pallas
// (kernel bodies _extract_kernel, _extract_kernel_nfree and
// _extract_kernel_len over _doubling_minimizers).  For each read of 2-bit
// packed codes it writes the minimum canonical k-mer hash of each stride-w
// window, 0xFFFFFFFF where a window holds no valid k-mer, and the window's
// valid flag.  Output equals the TPU kernel's bit for bit; plain PyTorch
// version: cornetto_tpu_torch/kernels/extract.py::extract_minima_ref.
//
// The decision loop runs this routine inside csrc/decide.cu, fused with
// its consumer, so the minima never leave the SM; this standalone kernel
// is the routine's unit check and the extraction of any caller that wants
// the minima themselves.
//
// What bounds it: at the decision loop's shapes (L=450, k=15, w=10) a read
// brings 113 B of packed codes and takes away 43 minima (172 B of uint32 +
// 43 B of flags), while each of its 436 k-mers costs a base step and a
// 7-step hash: integer issue, not bandwidth, is the limit.  The design
// (csrc/minimizer.cuh): a group of 8-32 lanes a read, the read staged in
// shared memory once, a lane a window, the forward and reverse-complement
// words rolled one base at a time (k + w - 1 base steps a window, not k a
// k-mer) and the minimum kept in a register; one coalesced store per
// window.
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/
// _build.py); the caller allocates the outputs and passes its current
// stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "minimizer.cuh"

namespace {

using namespace cornetto;

constexpr int kThreads = 256;
constexpr size_t kDefaultSmemLimit = 48 * 1024;
constexpr size_t kMaxSmem = 227 * 1024;

// shared words a group stages: its read's codes and, for kNMask, N flags
template <int V>
__host__ __device__ __forceinline__ int group_words(int L) {
  return code_words(L) + (V == kNMask ? nbit_words(L) : 0);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
extract_minima_kernel(const uint8_t* __restrict__ packed,
                      const uint8_t* __restrict__ nmask,
                      const int32_t* __restrict__ lengths,
                      int B, int L, int k, int w, int gsize, int groups,
                      uint32_t* __restrict__ hmin,
                      uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t smem[];
  const Group g = make_group(gsize);
  const int gid = threadIdx.x / gsize;
  const long long row = static_cast<long long>(blockIdx.x) * groups + gid;
  if (gid >= groups || row >= B) return;           // whole groups leave
  uint32_t* codes = smem + gid * group_words<V>(L);
  const ReadView r = stage_read<V>(g, row, L, packed, nmask, lengths, codes,
                                   codes + code_words(L));
  __syncwarp(g.mask);
  const int nwin = (L - k + 1) / w;
  for (int j = g.lane; j < nwin; j += g.size) {
    const uint32_t h = window_min<V>(r, j, k, w);
    const long long o = row * nwin + j;
    hmin[o] = h;
    valid[o] = h != kSentinel;
  }
}

template <int V>
cudaError_t launch(const void* packed, const void* nmask, const void* lengths,
                   int B, int L, int k, int w, void* hmin, void* valid,
                   cudaStream_t stream) {
  const int gsize = group_size((L - k + 1) / w);
  const size_t per_group = group_words<V>(L) * sizeof(uint32_t);
  if (per_group > kMaxSmem) return cudaErrorInvalidValue;
  size_t groups = kDefaultSmemLimit / per_group;
  const size_t most = kThreads / gsize;
  groups = groups < 1 ? 1 : (groups > most ? most : groups);
  const size_t smem = groups * per_group;
  if (smem > kDefaultSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        extract_minima_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = static_cast<unsigned>((B + groups - 1) / groups);
  extract_minima_kernel<V><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(nmask),
      static_cast<const int32_t*>(lengths), B, L, k, w, gsize,
      static_cast<int>(groups), static_cast<uint32_t*>(hmin),
      static_cast<uint8_t*>(valid));
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
