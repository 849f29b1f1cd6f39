// Minimizer extraction as a per-lane device routine for NVIDIA Hopper
// (sm_90a), shared by csrc/extract_minima.cu (the standalone kernel) and
// csrc/decide.cu (extraction fused with the lookup, votes and policy).
//
// What it computes is cornetto_tpu/kernels/pallas_extract.py::
// extract_minima_pallas: for each stride-w window of a read, the unsigned
// minimum over its w k-mers of hash32(min(forward word, reverse
// complement)), 0xFFFFFFFF where the window holds no valid k-mer.  Plain
// PyTorch version: cornetto_tpu_torch/kernels/extract.py::
// extract_minima_ref.
//
// Layout: a group of G lanes a read (G = 32, 16 or 8: group_size picks
// the one that leaves the fewest lanes idle over the read's windows, 16
// for the 43 windows of a 450-base read).  The group stages the read's
// 2-bit codes (and its N bitmap) in shared memory once (stage_read); lane
// l of the group then takes windows l, l + G, ...  A window's k-mers
// overlap, so the lane builds its first k-mer in k base steps and rolls
// the forward and reverse-complement words one base at a time for the
// other w - 1: k + w - 1 steps a window (24 at k = 15, w = 10), not a
// k-step rebuild of every k-mer.  When those steps fit in 32 bases the
// lane reads its window's codes (and N flags) from shared memory once,
// into a 64-bit register; the words, the hashes and the window minimum
// stay in registers.
//
// Correct for any k in 1..15, any w >= 1 and any read length the staging
// buffer holds.  Validity is a template parameter: N-free (every k-mer
// valid), per-read lengths (k-mer i valid iff i + k - 1 < length) or an N
// bitmap (valid iff none of its k bases is flagged; a rolling k-bit window
// of the flags).

#pragma once

#include <cstdint>

namespace cornetto {

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

// Lanes a read: 32, 16 or 8, whichever covers nwin windows in the fewest
// lane slots (the larger on a tie).
__host__ __device__ __forceinline__ int group_size(int nwin) {
  int best = 32;
  for (int g = 16; g >= 8; g >>= 1)
    if ((nwin + g - 1) / g * g < (nwin + best - 1) / best * best) best = g;
  return best;
}

// A read's group of lanes inside the warp.
struct Group {
  int size;        // G
  int lane;        // 0..G-1
  int base;        // the group's first lane in the warp
  unsigned mask;   // the group's lanes
};

__device__ __forceinline__ Group make_group(int size) {
  Group g;
  const int lane = threadIdx.x & 31;
  g.size = size;
  g.lane = lane & (size - 1);
  g.base = lane - g.lane;
  g.mask = size == 32 ? 0xFFFFFFFFu : ((1u << size) - 1u) << g.base;
  return g;
}

// Bit l of the result is the predicate of the group's lane l.
__device__ __forceinline__ unsigned group_ballot(const Group& g, bool p) {
  return (__ballot_sync(g.mask, p) & g.mask) >> g.base;
}

// 32-bit words of a read staged in shared memory: the codes (base i at
// bits 2*(i%16) of word i/16, the packing of kernels.minimizer.pack_reads
// read as little-endian words) and, for kNMask, the N flags (base i at bit
// i%32 of word i/32), each with zero words past the read so a window's
// 64-bit read never leaves it.
__host__ __device__ __forceinline__ int code_words(int L) {
  return ((L + 15) >> 4) + 2;
}
__host__ __device__ __forceinline__ int nbit_words(int L) {
  return ((L + 31) >> 5) + 1;
}

// One read as a lane sees it: its staged words and, for kLengths, its
// length.
struct ReadView {
  const uint32_t* codes;
  const uint32_t* nbits;
  int length;
};

// n bytes of src into dst, zero-padded to n_pad bytes, by the group's
// lanes; all four loads of a lane are in flight before its first store.
__device__ __forceinline__ void copy_bytes(const Group& g,
                                           const uint8_t* __restrict__ src,
                                           int n, uint8_t* dst, int n_pad) {
  for (int i0 = 0; i0 < n_pad; i0 += 4 * g.size) {
    uint8_t b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * g.size + g.lane;
      b[u] = i < n ? src[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * g.size + g.lane;
      if (i < n_pad) dst[i] = b[u];
    }
  }
}

// Copy row `row` of packed (B, ceil(L/4)) and, for kNMask, of nmask
// (B, ceil(L/8)) into the group's words; the caller syncs the group
// (__syncwarp(g.mask)) before reading them.  Global rows are byte-aligned
// only, so lanes move bytes: a read is ~113 B at L = 450.
template <int V>
__device__ __forceinline__ ReadView stage_read(
    const Group& g, long long row, int L, const uint8_t* __restrict__ packed,
    const uint8_t* __restrict__ nmask, const int32_t* __restrict__ lengths,
    uint32_t* codes, uint32_t* nbits) {
  const int pb = (L + 3) >> 2;
  copy_bytes(g, packed + row * pb, pb, reinterpret_cast<uint8_t*>(codes),
             code_words(L) * 4);
  if (V == kNMask) {
    const int nb = (L + 7) >> 3;
    copy_bytes(g, nmask + row * nb, nb, reinterpret_cast<uint8_t*>(nbits),
               nbit_words(L) * 4);
  }
  ReadView r;
  r.codes = codes;
  r.nbits = nbits;
  r.length = V == kLengths ? lengths[row] : L;
  return r;
}

// The rolling state of one window: forward and reverse-complement words,
// the k-mer's N flags and the minimum so far.
template <int V>
struct Roll {
  uint32_t kmask, nmask, fwd, rev, nrun, best;
  int rsh;

  __device__ __forceinline__ explicit Roll(int k)
      : kmask((1u << (2 * k)) - 1u), nmask((1u << k) - 1u), fwd(0), rev(0),
        nrun(0), best(kSentinel), rsh(2 * (k - 1)) {}

  // base q with code c and N flag n; a k-mer ends at q when `done`
  __device__ __forceinline__ void push(uint32_t c, uint32_t n, int q,
                                       bool done, int length) {
    fwd = ((fwd << 2) | c) & kmask;                  // big-endian forward
    rev = (rev >> 2) | ((3u - c) << rsh);            // complement, reversed
    if (V == kNMask) nrun = ((nrun << 1) | n) & nmask;
    if (done) {
      bool ok = true;
      if (V == kNMask) ok = nrun == 0u;
      if (V == kLengths) ok = q < length;
      best = min(best, ok ? hash32(min(fwd, rev)) : kSentinel);
    }
  }
};

// Minimum hash of window j (k-mers j*w .. j*w + w - 1), kSentinel where
// none of them is valid.  The caller guarantees j < (L - k + 1) / w.
template <int V>
__device__ __forceinline__ uint32_t window_min(const ReadView& r, int j,
                                               int k, int w) {
  const int steps = w + k - 1;
  const int q0 = j * w;                              // first base
  Roll<V> roll(k);
  if (steps <= 32) {
    // the window's <= 32 bases from shared memory once: 64 bits of codes
    // starting at q0 (three words funnel-shifted), 32 N flags
    const uint32_t* cw = r.codes + (q0 >> 4);
    const int s = 2 * (q0 & 15);
    uint64_t codes = (static_cast<uint64_t>(cw[1]) << 32) | cw[0];
    if (s) codes = (codes >> s) | (static_cast<uint64_t>(cw[2]) << (64 - s));
    uint32_t flags = 0;
    if (V == kNMask) {
      const uint32_t* nw = r.nbits + (q0 >> 5);
      flags = static_cast<uint32_t>(
          ((static_cast<uint64_t>(nw[1]) << 32) | nw[0]) >> (q0 & 31));
    }
    for (int t = 0; t < steps; ++t) {
      roll.push(static_cast<uint32_t>(codes) & 3u, flags & 1u, q0 + t,
                t >= k - 1, r.length);
      codes >>= 2;
      flags >>= 1;
    }
    return roll.best;
  }
  // longer windows: a word at a time
  int q = q0;
  uint32_t cw = r.codes[q >> 4] >> ((q & 15) << 1);
  uint32_t nw = V == kNMask ? r.nbits[q >> 5] >> (q & 31) : 0u;
  for (int t = 0; t < steps; ++t, ++q) {
    if (t > 0 && (q & 15) == 0) cw = r.codes[q >> 4];
    if (V == kNMask && t > 0 && (q & 31) == 0) nw = r.nbits[q >> 5];
    roll.push(cw & 3u, nw & 1u, q, t >= k - 1, r.length);
    cw >>= 2;
    nw >>= 1;
  }
  return roll.best;
}

}  // namespace cornetto
