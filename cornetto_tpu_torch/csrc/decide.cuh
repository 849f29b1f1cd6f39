// The decision step's lookup and policy as per-thread device routines for
// NVIDIA Hopper (sm_90a), shared by csrc/decide.cu (the fused step: one
// launch a batch on one device) and csrc/votes.cu (the sharded engine's
// shard-masked votes and its policy on the planes summed over the shards).
//
// What they compute is cornetto_tpu/livefish/decide.py::_lookup_votes (the
// fingerprinted, two-choice bucket lookup of one minimizer hash) and the
// policy of _decide_from_minima (:268-296: exact split-sum position means
// and the panel test on the best contig's planes).  Plain PyTorch versions:
// cornetto_tpu_torch/kernels/decide.py::_lookup_votes and
// _policy_from_stats.

#pragma once

#include <cstdint>

namespace cornetto {

__device__ __forceinline__ uint32_t shr64(uint32_t x, int s) {
  return s >= 32 ? 0u : x >> s;               // torch's int64 shift of u32
}

// floor division of int32 (torch.div(..., rounding_mode="floor"))
__device__ __forceinline__ int32_t floordiv(int32_t a, int32_t b) {
  int32_t q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// _mean_split: floor((hi*2^16 + lo) / n) in int32, n clamped to >= 1, with
// the reference's int32 wrapping
__device__ __forceinline__ int32_t mean_split(int32_t hi, int32_t lo,
                                              int32_t n) {
  n = n < 1 ? 1 : n;
  const int32_t q = floordiv(hi, n);
  const int32_t r = static_cast<int32_t>(static_cast<uint32_t>(hi) -
                                         static_cast<uint32_t>(q) *
                                             static_cast<uint32_t>(n));
  const int32_t num = static_cast<int32_t>(
      (static_cast<uint32_t>(r) << 16) + static_cast<uint32_t>(lo));
  return static_cast<int32_t>((static_cast<uint32_t>(q) << 16) +
                              static_cast<uint32_t>(floordiv(num, n)));
}

// one bucket row of 2K int32: K/2 words of fingerprint pairs, K/2 of
// contig pairs, K positions (livefish/index.py)
template <int K>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ bt,
                                         uint32_t bucket, int32_t (&row)[2 * K]) {
  const int4* p = reinterpret_cast<const int4*>(
      bt + static_cast<size_t>(bucket) * (2 * K));
#pragma unroll
  for (int i = 0; i < K / 2; ++i) {
    const int4 v = __ldg(p + i);
    row[4 * i] = v.x;
    row[4 * i + 1] = v.y;
    row[4 * i + 2] = v.z;
    row[4 * i + 3] = v.w;
  }
}

struct Match {
  bool found, has2;
  uint32_t contig;
  int32_t pos1, pos2;
};

// the reference's slot walk: the first match sets contig and pos1, the
// next one (the second slot of an ambiguous hash) sets pos2
template <int K>
__device__ __forceinline__ void match_row(const int32_t (&row)[2 * K],
                                          uint32_t want, Match& m) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const uint32_t fp =
        (static_cast<uint32_t>(row[s / 2]) >> (16 * (s % 2))) & 0xFFFFu;
    const uint32_t ct =
        (static_cast<uint32_t>(row[K / 2 + s / 2]) >> (16 * (s % 2))) &
        0xFFFFu;
    const bool hit = fp == want && ct != 0xFFFFu;
    const bool is2 = hit && m.found && !m.has2;
    const bool is1 = hit && !m.found;
    if (is1) {
      m.contig = ct;
      m.pos1 = row[K + s];
    }
    if (is2) m.pos2 = row[K + s];
    m.has2 = m.has2 || is2;
    m.found = m.found || hit;
  }
}

// Look up hash q in a (2^log2nb, 2K) table: its home bucket and, under
// two_choice, the alternate bucket with the tagged fingerprint (both rows
// in flight before the first use).  An entry whose contig id is >= C is
// not a hit (the plain version's one-hot has no column for it).
template <int K>
__device__ __forceinline__ Match lookup(const int32_t* __restrict__ bt,
                                        uint32_t q, int log2nb,
                                        int bucket_shift, bool two_choice,
                                        int C) {
  Match m = {false, false, 0u, 0, 0};
  const uint32_t nbm1 = (1u << log2nb) - 1u;
  const uint32_t b1 = shr64(q, bucket_shift) & nbm1;
  const uint32_t fp = shr64(q, bucket_shift + log2nb);
  int32_t row1[2 * K], row2[2 * K];
  load_row<K>(bt, b1, row1);
  uint32_t fp2 = 0;
  if (two_choice) {
    const uint32_t alt = shr64(fp * 0x9E3779B1u, 32 - log2nb) & nbm1;
    fp2 = fp | (1u << 15);
    load_row<K>(bt, b1 ^ alt, row2);              // in flight with row1
  }
  match_row<K>(row1, fp, m);
  if (two_choice) match_row<K>(row2, fp2, m);
  m.found = m.found && m.contig < static_cast<uint32_t>(C);
  return m;
}

// The policy's three results of one read.
struct Policy {
  int32_t decision, est, est2;
};

// The policy on the best contig's nine plane values (votes, votes_un,
// nu_hi, nu_lo, votes_amb, a1_hi, a1_lo, a2_hi, a2_lo): the unambiguous
// hits' mean position where there is one, else the two ambiguous
// occurrences' means; unblock (0) when the read maps (votes >= min_hits)
// into a panel bin of its best contig, else proceed (1).
__device__ __forceinline__ Policy policy(
    const int32_t (&s)[9], uint32_t best, const uint8_t* __restrict__ panel,
    int bins, int min_hits, int bin_size) {
  const int32_t nhits = s[0], hq = s[1], va = s[4];
  const bool have_un = hq > 0;
  const int32_t est_amb1 = mean_split(s[5], s[6], va);
  Policy r;
  r.est = have_un ? mean_split(s[2], s[3], hq) : est_amb1;
  r.est2 = have_un ? r.est : mean_split(s[7], s[8], va);
  int32_t bin = floordiv(r.est, bin_size);
  bin = bin < 0 ? 0 : (bin > bins - 1 ? bins - 1 : bin);
  const bool in_panel = panel[static_cast<size_t>(best) * bins + bin] != 0;
  r.decision = (nhits >= min_hits && in_panel) ? 0 : 1;
  return r;
}

}  // namespace cornetto
