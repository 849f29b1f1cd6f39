// The fused decision step for NVIDIA Hopper (sm_90a): packed reads in,
// decisions out, one launch a batch.
//
// Replaces, in one kernel, cornetto_tpu/kernels/pallas_extract.py::
// extract_minima_pallas (the TPU kernel; csrc/minimizer.cuh here) and its
// only consumer, cornetto_tpu/livefish/decide.py::_lookup_votes +
// _decide_from_minima (XLA there): the fingerprinted two-choice bucket
// lookup of every window minimum, the per-contig votes with split position
// sums, the best contig and the panel policy.  Output equals
// cornetto_tpu_torch/kernels/decide.py::decide_packed_ref bit for bit.
//
// What bounds it: at the decision loop's shapes (4096 reads of 450 bases,
// k=15, w=10, 2^27 buckets x 4 slots) a batch reads 0.46 MB of packed codes
// and gathers 4096 x 43 x 2 rows of 32 B (11.3 MB) from a 4.29 GB table,
// then writes 32 KB: bytes, and random 32-byte sectors at that, which are
// latency-bound gathers.  The plain version was ~250 launches of small
// torch ops a batch, dispatch-bound on the host; here nothing between the
// packed codes and the decision leaves the SM.  The design:
//
// - a group of G lanes a read (G = 16 for the 43 windows of a 450-base
//   read: csrc/minimizer.cuh's group_size), 256 lanes a block; the read is
//   staged in shared memory once;
// - lane l takes windows l, l + G, ...: it rolls the window's minimum in
//   registers (csrc/minimizer.cuh), then issues both probes' row loads
//   (16-byte read-only loads, all before the first use) and matches the
//   slots in the reference's order: probe 1's slots 0..K-1, then probe 2's;
// - a hit (contig, ambiguity, first and second position) goes to the
//   group's hit list in shared memory at a ballot-compacted slot;
// - each lane counts, for the hits it holds, the hits of the same contig
//   over the list (the read's <= nwin hits, not C dense contigs); a group
//   max then min picks (most votes, smallest contig id), as torch.argmax /
//   jnp.argmax take the first maximum; a read with no hit gets contig 0;
// - the nine planes of the best contig are group sums (exact integer sums,
//   so their order does not matter); the group's lane 0 takes the split
//   means, the panel test and writes the read's outputs.
//
// The lookup and the policy are csrc/decide.cuh's, shared with the sharded
// engine's kernels (csrc/votes.cu).
//
// Nothing depends on the number of contigs C but the panel's shape: the
// plain version's one-hot (C <= 64) and (9, B*C) scatter-add go away.  A
// table entry whose contig id is >= C is not a hit (the one-hot drops it).
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/
// _build.py); the caller allocates the outputs and passes its current
// stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "decide.cuh"
#include "minimizer.cuh"

namespace {

using namespace cornetto;

constexpr int kThreads = 256;
constexpr size_t kDefaultSmemLimit = 48 * 1024;
constexpr size_t kBlockSmemBudget = 100 * 1024;  // 2 blocks an SM
constexpr size_t kMaxSmem = 227 * 1024;
constexpr uint32_t kAmbig = 1u << 16;          // hit flag above the contig

struct Params {
  const uint8_t* packed;
  const uint8_t* nmask;
  const int32_t* lengths;
  const int32_t* btable;       // (2^log2nb, 2K) rows
  const uint8_t* panel;        // (C, bins) bool
  int B, L, k, w;
  int log2nb, bucket_shift, two_choice;
  int C, bins, min_hits, bin_size;
  int gsize, groups;           // lanes a read, reads a block
  int32_t* fused;              // (2, B) or NULL
  int8_t* decision;            // the six (B,) outputs, when fused is NULL
  int32_t* best;
  int32_t* est;
  int32_t* nhits;
  int32_t* nhits_hq;
  int32_t* est2;
};

// shared words a group holds: its read (codes, N flags for kNMask) and
// its hit list (three words a window: contig | ambiguity flag, p1, p2)
template <int V>
__host__ __device__ __forceinline__ int read_words(int L) {
  return code_words(L) + (V == kNMask ? nbit_words(L) : 0);
}
template <int V>
__host__ __device__ __forceinline__ int group_words(int L, int nwin) {
  return read_words<V>(L) + 3 * nwin;
}

template <int V, int K>
__global__ void __launch_bounds__(kThreads) decide_kernel(Params p) {
  extern __shared__ uint32_t smem[];
  const Group g = make_group(p.gsize);
  const int gid = threadIdx.x / p.gsize;
  const long long row = static_cast<long long>(blockIdx.x) * p.groups + gid;
  if (gid >= p.groups || row >= p.B) return;       // whole groups leave
  const int L = p.L;
  const int nwin = (L - p.k + 1) / p.w;
  uint32_t* base = smem + gid * group_words<V>(L, nwin);
  uint32_t* hit_ct = base + read_words<V>(L);
  int32_t* hit_p1 = reinterpret_cast<int32_t*>(hit_ct + nwin);
  int32_t* hit_p2 = hit_p1 + nwin;
  const ReadView r = stage_read<V>(g, row, L, p.packed, p.nmask, p.lengths,
                                   base, base + code_words(L));
  __syncwarp(g.mask);

  int nhit = 0;                                    // uniform in the group
  for (int j0 = 0; j0 < nwin; j0 += g.size) {
    const int j = j0 + g.lane;
    Match m = {false, false, 0u, 0, 0};
    if (j < nwin) {
      const uint32_t q = window_min<V>(r, j, p.k, p.w);
      if (q != kSentinel)
        m = lookup<K>(p.btable, q, p.log2nb, p.bucket_shift,
                      p.two_choice != 0, p.C);
    }
    const unsigned ball = group_ballot(g, m.found);
    if (m.found) {
      const int at = nhit + __popc(ball & ((1u << g.lane) - 1u));
      hit_ct[at] = m.contig | (m.pos1 < 0 ? kAmbig : 0u);
      const int32_t p1 = m.pos1 & 0x7FFFFFFF;
      hit_p1[at] = p1;
      hit_p2[at] = m.has2 ? (m.pos2 & 0x7FFFFFFF) : p1;
    }
    nhit += __popc(ball);
  }
  __syncwarp(g.mask);

  // votes: each lane counts its hits' contigs over the whole list and
  // keeps its best (most votes, then smallest id)
  uint32_t my_votes = 0, my_ctg = 0;
  for (int i = g.lane; i < nhit; i += g.size) {
    const uint32_t c = hit_ct[i] & 0xFFFFu;
    uint32_t n = 0;
    for (int t = 0; t < nhit; ++t) n += (hit_ct[t] & 0xFFFFu) == c;
    if (n > my_votes || (n == my_votes && c < my_ctg)) {
      my_votes = n;
      my_ctg = c;
    }
  }
  const uint32_t votes = __reduce_max_sync(g.mask, my_votes);
  const uint32_t best =
      __reduce_min_sync(g.mask, my_votes == votes ? my_ctg : 0xFFFFFFFFu);

  // the best contig's planes (votes is plane 0)
  uint32_t un = 0, nu_hi = 0, nu_lo = 0, am = 0;
  uint32_t a1_hi = 0, a1_lo = 0, a2_hi = 0, a2_lo = 0;
  for (int i = g.lane; i < nhit; i += g.size) {
    const uint32_t h = hit_ct[i];
    if ((h & 0xFFFFu) != best) continue;
    const uint32_t p1 = static_cast<uint32_t>(hit_p1[i]);
    if (h & kAmbig) {
      const uint32_t p2 = static_cast<uint32_t>(hit_p2[i]);
      am += 1;
      a1_hi += p1 >> 16;
      a1_lo += p1 & 0xFFFFu;
      a2_hi += p2 >> 16;
      a2_lo += p2 & 0xFFFFu;
    } else {
      un += 1;
      nu_hi += p1 >> 16;
      nu_lo += p1 & 0xFFFFu;
    }
  }
  un = __reduce_add_sync(g.mask, un);
  nu_hi = __reduce_add_sync(g.mask, nu_hi);
  nu_lo = __reduce_add_sync(g.mask, nu_lo);
  am = __reduce_add_sync(g.mask, am);
  a1_hi = __reduce_add_sync(g.mask, a1_hi);
  a1_lo = __reduce_add_sync(g.mask, a1_lo);
  a2_hi = __reduce_add_sync(g.mask, a2_hi);
  a2_lo = __reduce_add_sync(g.mask, a2_lo);
  if (g.lane != 0) return;

  // the policy (_decide_from_minima)
  const int32_t planes[9] = {
      static_cast<int32_t>(votes), static_cast<int32_t>(un),
      static_cast<int32_t>(nu_hi), static_cast<int32_t>(nu_lo),
      static_cast<int32_t>(am), static_cast<int32_t>(a1_hi),
      static_cast<int32_t>(a1_lo), static_cast<int32_t>(a2_hi),
      static_cast<int32_t>(a2_lo)};
  const Policy pol =
      policy(planes, best, p.panel, p.bins, p.min_hits, p.bin_size);
  const int32_t nhits = planes[0];
  const int32_t hq = planes[1];
  const int32_t decision = pol.decision;
  const int32_t est = pol.est;
  const int32_t est2 = pol.est2;
  if (p.fused != nullptr) {
    const int32_t nh = nhits < 0x3FFF ? nhits : 0x3FFF;
    p.fused[row] = (decision << 30) | (nh << 16) |
                   static_cast<int32_t>(best & 0xFFFFu);
    p.fused[p.B + row] = est;
  } else {
    p.decision[row] = static_cast<int8_t>(decision);
    p.best[row] = static_cast<int32_t>(best);
    p.est[row] = est;
    p.nhits[row] = nhits;
    p.nhits_hq[row] = hq;
    p.est2[row] = est2;
  }
}

template <int V, int K>
cudaError_t launch(Params p, cudaStream_t stream) {
  const int nwin = (p.L - p.k + 1) / p.w;
  p.gsize = group_size(nwin);
  const size_t per_group = group_words<V>(p.L, nwin) * sizeof(uint32_t);
  if (per_group > kMaxSmem) return cudaErrorInvalidValue;
  const size_t most = kThreads / p.gsize;
  size_t groups = kBlockSmemBudget / per_group;
  groups = groups < 1 ? 1 : (groups > most ? most : groups);
  const size_t smem = groups * per_group;
  if (smem > kDefaultSmemLimit) {
    const cudaError_t e = cudaFuncSetAttribute(
        decide_kernel<V, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  p.groups = static_cast<int>(groups);
  const unsigned grid = static_cast<unsigned>((p.B + groups - 1) / groups);
  decide_kernel<V, K><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_k(const Params& p, int K, cudaStream_t stream) {
  switch (K) {
    case 4: return launch<V, 4>(p, stream);
    case 8: return launch<V, 8>(p, stream);
    case 16: return launch<V, 16>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// packed (B, ceil(L/4)) uint8; nmask (B, ceil(L/8)) uint8 or NULL; lengths
// (B,) int32 or NULL (nmask wins when both are given); btable (2^log2nb, 2K)
// int32 with K in {4, 8, 16}, 16-byte aligned; panel (C, bins) bool.
// Outputs: fused (2, B) int32 (row 0 = decision<<30 | min(nhits,
// 0x3FFF)<<16 | best & 0xFFFF, row 1 = est) when fused is not NULL, else
// decision (B,) int8 and best, est, nhits, nhits_hq, est2 (B,) int32.  All
// arrays contiguous on the current device.  Returns a cudaError_t (0 =
// launched).
extern "C" int cornetto_decide_packed(
    const void* packed, const void* nmask, const void* lengths,
    const void* btable, int log2nb, int K, const void* panel, int C,
    int bins, int B, int L, int k, int w, int min_hits, int bin_size,
    int bucket_shift, int two_choice, void* fused, void* decision,
    void* best, void* est, void* nhits, void* nhits_hq, void* est2,
    void* stream) {
  if (B < 1 || k < 1 || k > 15 || w < 1 || L < k || (L - k + 1) / w < 1 ||
      log2nb < 0 || log2nb > 31 || bucket_shift < 0 || C < 1 || bins < 1 ||
      bin_size < 1 ||
      (fused == nullptr && (decision == nullptr || best == nullptr ||
                            est == nullptr || nhits == nullptr ||
                            nhits_hq == nullptr || est2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.packed = static_cast<const uint8_t*>(packed);
  p.nmask = static_cast<const uint8_t*>(nmask);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.btable = static_cast<const int32_t*>(btable);
  p.panel = static_cast<const uint8_t*>(panel);
  p.B = B;
  p.L = L;
  p.k = k;
  p.w = w;
  p.log2nb = log2nb;
  p.bucket_shift = bucket_shift;
  p.two_choice = two_choice != 0;
  p.C = C;
  p.bins = bins;
  p.min_hits = min_hits;
  p.bin_size = bin_size;
  p.gsize = 32;
  p.groups = 1;
  p.fused = static_cast<int32_t*>(fused);
  p.decision = static_cast<int8_t*>(decision);
  p.best = static_cast<int32_t*>(best);
  p.est = static_cast<int32_t*>(est);
  p.nhits = static_cast<int32_t*>(nhits);
  p.nhits_hq = static_cast<int32_t*>(nhits_hq);
  p.est2 = static_cast<int32_t*>(est2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nmask != nullptr) return static_cast<int>(launch_k<kNMask>(p, K, s));
  if (lengths != nullptr)
    return static_cast<int>(launch_k<kLengths>(p, K, s));
  return static_cast<int>(launch_k<kNFree>(p, K, s));
}
