// The sharded decision engine's two device steps for NVIDIA Hopper
// (sm_90a): the shard-masked lookup and votes, and the policy on the votes
// summed over the shards.  With one shard (ep = 1) nothing is summed and
// the engine runs csrc/decide.cu's fused step instead.
//
// Replaces the XLA code of cornetto_tpu/livefish/decide.py::
// _decide_from_minima with ep_axis set (:254-296), which the JAX package
// runs inside make_sharded_engine's shard_map (:482-579): after the hashes
// of the ep group's reads are gathered, each shard looks up only the
// hashes it owns ((h & (ep - 1)) == shard) in its share of the table and
// reduces them to nine (b, C) int32 planes a contig (_lookup_votes); the
// planes are summed over the shards by one reduce-scatter, and the policy
// picks each read's best contig and decides.  Plain PyTorch versions:
// cornetto_tpu_torch/kernels/decide.py::_lookup_votes (with its owner
// filter) and _policy_from_stats; wrappers: kernels/votes.py.
//
// cornetto_sharded_votes.  Unlike csrc/decide.cu's hit list, its output is
// the dense (9, b, C) block, since it is summed across shards.  A group of
// G lanes a read (csrc/minimizer.cuh's group_size: 16 for the 43 windows
// of a 450-base read); lane l takes windows l, l + G, ...; a hit of the
// shard's own hashes adds to its contig's planes with integer atomics,
// which are exact, so the order of the adds does not matter.  The planes
// of a read live in shared memory (9 C int32, 3,132 B at C = 87) and leave
// in one coalesced write; where they do not fit a block (C > 6,456, see
// cornetto_votes_shared_limit), the group zeroes its read's rows of the
// output and adds into them with global atomics.  Contig ids are 16 bits:
// C < 65,536.  The rows can be written in `parts` blocks, (parts, 9,
// b / parts, C), so that each block is contiguous for the reduce-scatter
// that sends part i to the group's rank i; parts = 1 is (9, b, C).
//
// What bounds it: the table rows it gathers (one or two 32-byte rows a
// hash this shard owns: latency-bound random sectors of a table of GBs)
// and the dense planes it writes (9 b C 4 bytes: 12.8 MB at b = 4096, C =
// 87, more than the gathers).  It reaches about a third of that bound; a
// per-read hit list written out in int4 runs was slower on the human-scale
// index, where a read votes for many contigs (PERF.md §6).
//
// cornetto_policy_from_stats.  A warp a read: its lanes stride over the
// read's votes row (coalesced), a warp max then min picks the first
// maximum (torch.argmax and jnp.argmax take the first), lane 0 reads the
// best contig's other eight planes and runs csrc/decide.cuh's policy.
// Bound: the planes it reads (9 b C 4 bytes, of which it needs only the
// votes row and eight words a read).
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
constexpr int kMaxContigs = 65535;

struct VotesParams {
  const int32_t* hashes;       // (B, M) uint32 bit patterns
  const uint8_t* valid;        // (B, M) bool
  const int32_t* btable;       // (2^log2nb, 2K) rows of this shard
  int B, M, log2nb, bucket_shift, two_choice, ep, shard, C, parts;
  int gsize, groups;           // lanes a read, reads a block
  int shared;                  // planes in shared memory (else global)
  int32_t* out;                // (parts, 9, B / parts, C)
};

template <int K>
__global__ void __launch_bounds__(kThreads) votes_kernel(VotesParams p) {
  extern __shared__ int32_t planes_smem[];
  const Group g = make_group(p.gsize);
  const int gid = threadIdx.x / p.gsize;
  const long long row = static_cast<long long>(blockIdx.x) * p.groups + gid;
  if (gid >= p.groups || row >= p.B) return;       // whole groups leave
  const long long C = p.C;
  const long long rpp = p.B / p.parts;              // rows a part
  int32_t* const dst =
      p.out + ((row / rpp) * 9 * rpp + row % rpp) * C;  // plane 0 of the row
  const long long dst_stride = rpp * C;
  int32_t* base;
  long long stride;
  if (p.shared) {
    base = planes_smem + gid * 9 * C;
    stride = C;
  } else {
    base = dst;
    stride = dst_stride;
  }
  for (int pl = 0; pl < 9; ++pl)
    for (long long c = g.lane; c < C; c += g.size) base[pl * stride + c] = 0;
  __syncwarp(g.mask);

  const uint32_t own = static_cast<uint32_t>(p.ep - 1);
  const int32_t* hrow = p.hashes + row * p.M;
  const uint8_t* vrow = p.valid + row * p.M;
  for (int j = g.lane; j < p.M; j += g.size) {
    const uint32_t q = static_cast<uint32_t>(hrow[j]);
    if (!vrow[j] || (q & own) != static_cast<uint32_t>(p.shard)) continue;
    const Match m = lookup<K>(p.btable, q, p.log2nb, p.bucket_shift,
                              p.two_choice != 0, p.C);
    if (!m.found) continue;
    const uint32_t p1 = static_cast<uint32_t>(m.pos1) & 0x7FFFFFFFu;
    int32_t* at = base + m.contig;
    atomicAdd(at, 1);                                  // votes
    if (m.pos1 < 0) {                                  // ambiguous
      const uint32_t p2 =
          m.has2 ? (static_cast<uint32_t>(m.pos2) & 0x7FFFFFFFu) : p1;
      atomicAdd(at + 4 * stride, 1);
      atomicAdd(at + 5 * stride, static_cast<int32_t>(p1 >> 16));
      atomicAdd(at + 6 * stride, static_cast<int32_t>(p1 & 0xFFFFu));
      atomicAdd(at + 7 * stride, static_cast<int32_t>(p2 >> 16));
      atomicAdd(at + 8 * stride, static_cast<int32_t>(p2 & 0xFFFFu));
    } else {
      atomicAdd(at + 1 * stride, 1);
      atomicAdd(at + 2 * stride, static_cast<int32_t>(p1 >> 16));
      atomicAdd(at + 3 * stride, static_cast<int32_t>(p1 & 0xFFFFu));
    }
  }
  if (!p.shared) return;
  __syncwarp(g.mask);
  for (int pl = 0; pl < 9; ++pl)
    for (long long c = g.lane; c < C; c += g.size)
      dst[pl * dst_stride + c] = base[pl * C + c];
}

template <int K>
cudaError_t launch_votes(VotesParams p, cudaStream_t stream) {
  p.gsize = group_size(p.M);
  const size_t per_group = static_cast<size_t>(9) * p.C * sizeof(int32_t);
  const size_t most = kThreads / p.gsize;
  size_t groups = most, smem = 0;
  p.shared = per_group <= kMaxSmem;
  if (p.shared) {
    groups = kBlockSmemBudget / per_group;
    groups = groups < 1 ? 1 : (groups > most ? most : groups);
    smem = groups * per_group;
    if (smem > kDefaultSmemLimit) {
      const cudaError_t e = cudaFuncSetAttribute(
          votes_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
  }
  p.groups = static_cast<int>(groups);
  const unsigned grid = static_cast<unsigned>((p.B + groups - 1) / groups);
  votes_kernel<K><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

struct PolicyParams {
  const int32_t* stats;        // (9, B, C)
  const uint8_t* panel;        // (C, bins) bool
  int B, C, bins, min_hits, bin_size;
  int8_t* decision;            // the six (B,) outputs
  int32_t* best;
  int32_t* est;
  int32_t* nhits;
  int32_t* nhits_hq;
  int32_t* est2;
};

__global__ void __launch_bounds__(kThreads) policy_kernel(PolicyParams p) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (row >= p.B) return;                          // whole warps leave
  const long long C = p.C;
  const long long plane = static_cast<long long>(p.B) * C;
  const int32_t* votes = p.stats + row * C;
  // each lane's first maximum over its columns, then the warp's: the
  // largest value, and the smallest column holding it
  bool any = false;
  int32_t v_best = 0;
  uint32_t c_best = 0xFFFFFFFFu;
  for (long long c = lane; c < C; c += 32) {
    const int32_t v = votes[c];
    if (!any || v > v_best) {
      v_best = v;
      c_best = static_cast<uint32_t>(c);
      any = true;
    }
  }
  const int32_t top =
      __reduce_max_sync(0xFFFFFFFFu, any ? v_best : INT32_MIN);
  const uint32_t best = __reduce_min_sync(
      0xFFFFFFFFu, any && v_best == top ? c_best : 0xFFFFFFFFu);
  if (lane != 0) return;
  int32_t s[9];
#pragma unroll
  for (int pl = 0; pl < 9; ++pl) s[pl] = votes[pl * plane + best];
  const Policy pol = policy(s, best, p.panel, p.bins, p.min_hits,
                            p.bin_size);
  p.decision[row] = static_cast<int8_t>(pol.decision);
  p.best[row] = static_cast<int32_t>(best);
  p.est[row] = pol.est;
  p.nhits[row] = s[0];
  p.nhits_hq[row] = s[1];
  p.est2[row] = pol.est2;
}

}  // namespace

// The largest C whose nine planes of a read fit a block's shared memory;
// past it the votes accumulate in the output with global atomics.
extern "C" int cornetto_votes_shared_limit() {
  return static_cast<int>(kMaxSmem / (9 * sizeof(int32_t)));
}

// hashes (B, M) int32 and valid (B, M) bool (torch's one byte a flag): the
// ep group's gathered window minima; btable (2^log2nb, 2K) int32, this
// shard's table, K in {4, 8, 16}, 16-byte aligned; ep a power of two and
// 0 <= shard < ep; 1 <= C <= 65535; parts >= 1 dividing B.  Output: out
// (parts, 9, B / parts, C) int32, every element written.  All arrays
// contiguous on the current device.  Returns a cudaError_t (0 = launched).
extern "C" int cornetto_sharded_votes(
    const void* hashes, const void* valid, const void* btable, int log2nb,
    int K, int bucket_shift, int two_choice, int ep, int shard, int C, int B,
    int M, int parts, void* out, void* stream) {
  if (B < 1 || M < 1 || log2nb < 0 || log2nb > 31 || bucket_shift < 0 ||
      ep < 1 || (ep & (ep - 1)) != 0 || shard < 0 || shard >= ep || C < 1 ||
      C > kMaxContigs || parts < 1 || B % parts != 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  VotesParams p;
  p.hashes = static_cast<const int32_t*>(hashes);
  p.valid = static_cast<const uint8_t*>(valid);
  p.btable = static_cast<const int32_t*>(btable);
  p.B = B;
  p.M = M;
  p.log2nb = log2nb;
  p.bucket_shift = bucket_shift;
  p.two_choice = two_choice != 0;
  p.ep = ep;
  p.shard = shard;
  p.C = C;
  p.parts = parts;
  p.gsize = 32;
  p.groups = 1;
  p.shared = 1;
  p.out = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 4: return static_cast<int>(launch_votes<4>(p, s));
    case 8: return static_cast<int>(launch_votes<8>(p, s));
    case 16: return static_cast<int>(launch_votes<16>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// stats (9, B, C) int32; panel (C, bins) bool; outputs decision (B,) int8
// and best, est, nhits, nhits_hq, est2 (B,) int32.  All arrays contiguous
// on the current device.  Returns a cudaError_t (0 = launched).
extern "C" int cornetto_policy_from_stats(
    const void* stats, const void* panel, int B, int C, int bins,
    int min_hits, int bin_size, void* decision, void* best, void* est,
    void* nhits, void* nhits_hq, void* est2, void* stream) {
  if (B < 1 || C < 1 || C > kMaxContigs || bins < 1 || bin_size < 1 ||
      decision == nullptr || best == nullptr || est == nullptr ||
      nhits == nullptr || nhits_hq == nullptr || est2 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  PolicyParams p;
  p.stats = static_cast<const int32_t*>(stats);
  p.panel = static_cast<const uint8_t*>(panel);
  p.B = B;
  p.C = C;
  p.bins = bins;
  p.min_hits = min_hits;
  p.bin_size = bin_size;
  p.decision = static_cast<int8_t*>(decision);
  p.best = static_cast<int32_t*>(best);
  p.est = static_cast<int32_t*>(est);
  p.nhits = static_cast<int32_t*>(nhits);
  p.nhits_hq = static_cast<int32_t*>(nhits_hq);
  p.est2 = static_cast<int32_t*>(est2);
  const long long threads = static_cast<long long>(B) * 32;
  const unsigned grid =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  policy_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
