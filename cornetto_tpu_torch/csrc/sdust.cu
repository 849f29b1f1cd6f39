// SDUST DP over independent chunks for NVIDIA Hopper (sm_90a).
//
// Replaces cornetto_tpu/kernels/pallas_sdust.py::sdust_pallas_chunks (body
// _sdust_kernel, jitted by _jit_kernel): the symmetric-DUST DP of lh3/sdust
// (src/sdust/sdust.c:66-160, transcribed in cornetto_tpu_torch/kernels/
// sdust_core.py) run independently on each row of codes (0-3 bases, 4 = N,
// the row's end an N).  Rows come from the exact chunk plan of
// cornetto_tpu_torch/kernels/sdust_chunked.py; the host clips and unions
// them.  Plain PyTorch version: cornetto_tpu_torch/kernels/sdust.py::
// sdust_dp_ref.
//
// The TPU kernel runs 128-512 chunks as vector lanes, so every
// data-dependent branch of the C becomes a masked plane operation.  Here the
// rows go through two passes on one stream, with no host sync between them.
//
// Light pass (sdust_light_kernel): one thread per row runs the sequential
// DP with plain loops, its state in shared memory thread-minor (448 bytes a
// thread: a 64-word ring, uint8 cv / cw, 64 start-group slots; 7 blocks of
// 64 threads fit an SM).  The C keeps the pending perfect intervals as a
// flat vector P that reaches ~1700 entries on homopolymers; the TPU kernel's
// start-group representation keeps what the DP reads of it: per start
// coordinate, the newest entry's finish and the group's strict-ratio winner
// (r, l).  Every pending start lies in [lo, lo + 63), so 64 slots keyed by
// start & 63 are exact (lo resets when P is empty: starts are not monotone
// across an N).  A slot packs finish - start (8 bits), l (8) and r (16).
// Random sequence costs a few dozen instructions per base; dense satellite
// sweeps up to 62 window rows in find_perfect at every base, one dependent
// shared-memory load after another, while the other 31 lanes of the warp
// wait in divergence, so one such row sets the time of a whole launch.  The
// light pass therefore counts the find_perfect row-steps of each row and,
// once a row's count passes `budget`, drops it: the row appends its index to
// a device list (atomicAdd) and leaves its outputs to the heavy pass.  With
// budget 0 the light pass runs every row to its end (the single-pass design
// this kernel had before the heavy pass).
//
// Heavy pass (sdust_heavy_kernel): one warp per listed row, launched over an
// upper bound of rows; each warp reads the list's length on the device and
// re-runs its rows from scratch.  Lane j holds in registers ring rows 2j and
// 2j + 1 (row 0 the newest word), the row masks of word values 2j and 2j + 1
// (bit rr set when row rr holds the value: cw and cv are their popcounts
// below lenw and L, so a window shift is a shift of each mask and a bit set
// by the owner of the new word), and group slots 2j and 2j + 1.
// - shift: the oldest row falls off the masks, the new word comes in by a
//   shuffle of the ring, the cv * 10 > 2T eviction is the highest set bit of
//   the word's mask below L (its oldest occurrence), and rw / rv are one
//   warp reduction of the pair counts;
// - save and flush take the lowest occupied slot below the threshold from a
//   ballot of the slots rotated to start at lo, by __ffsll;
// - find_perfect follows the plain version's formulation for all 62 rows at
//   once: each row's count of earlier equal words is a popcount of its
//   word's row mask below it (the two words of a lane can equal words of
//   either element of another lane, which __match_any_sync cannot pair);
//   r is a warp inclusive scan; the firing rows a ballot; a candidate is
//   inserted when its ratio is at least the exclusive prefix maximum of the
//   firing candidates' ratios and the suffix maximum, by d = start' - start,
//   of the pending groups' ratios.  Ratios are compared exactly as 32-bit
//   cross products (r <= 2016, l < 64): strict > among the groups, >= for a
//   candidate, as the C.  Inserts go to distinct slots (start + d) & 63.
// A dense row costs ~40 shuffles per base instead of ~60 dependent
// shared-memory sweeps, and each heavy row runs on its own warp.
//
// What bounds it: the integer work of the DP (base steps plus the
// find_perfect row-steps the data needs; bytes are ~1 per base) and, for
// the heavy rows, the latency of one warp's dependent shuffle chain per
// base.  sdust_dp's wrapper counts both launches.
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/_build.py);
// the caller allocates the outputs and the list and passes its current
// stream.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRing = 64;       // ring capacity and number of word values
constexpr int kGroups = 64;     // pending-interval start slots
constexpr int kGslotJax = 128;  // the TPU kernel's slots: its flush bound
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWarpsPerBlock = 4;

// ------------------------------------------------------------- light pass

struct Dp {
  // shared-memory columns of this thread: element e at [e * kThreads]
  uint8_t* ring;
  uint8_t* cv;
  uint8_t* cw;
  uint32_t* grp;
  int T, W, NW, maxi;
  int32_t* outs;
  int32_t* outf;
  int rv, rw, L, lenw, lo, ngroups;
  unsigned head;
  int res_s, res_f, nout;
  bool res_has;

  __device__ uint8_t& word(int rr) {           // rr-th newest word
    return ring[((head - 1u - static_cast<unsigned>(rr)) & (kRing - 1)) *
                kThreads];
  }
  __device__ uint8_t& CV(int v) { return cv[v * kThreads]; }
  __device__ uint8_t& CW(int v) { return cw[v * kThreads]; }
  __device__ uint32_t& G(int s) { return grp[(s & (kGroups - 1)) * kThreads]; }

  __device__ void emit(int s, int f) {
    if (nout < maxi) {
      outs[nout] = s;
      outf[nout] = f;
    }
    ++nout;
  }

  // sdust.c save_masked_regions(thresh): save the newest entry of the
  // lowest pending start below thresh into the merged tail, drop every
  // start below thresh
  __device__ void save(int thresh) {
    if (ngroups == 0 || thresh <= lo) return;
    const int hi = min(thresh, lo + kGroups);
    bool saved = false;
    for (int s = lo; s < hi; ++s) {
      uint32_t& g = G(s);
      if (g == 0u) continue;
      if (!saved) {
        const int f = s + static_cast<int>(g & 0xFFu);
        if (res_has && s <= res_f) {
          res_f = max(res_f, f);
        } else {
          if (res_has) emit(res_s, res_f);
          res_s = s;
          res_f = f;
          res_has = true;
        }
        saved = true;
      }
      g = 0u;
      --ngroups;
    }
    lo = thresh;
  }

  // the N / end-of-row flush: rising thresholds until nothing is pending
  // (bounded as the TPU kernel's loop; it always drains well before)
  __device__ void flush(int thresh0) {
    for (int k = 0; ngroups > 0 && k < W + kGslotJax + 8; ++k)
      save(thresh0 + k);
  }

  // sdust.c shift_window(t)
  __device__ void shift(int t) {
    if (lenw >= NW) {
      const int s = word(NW - 1);
      --CW(s);
      rw -= CW(s);
      if (L >= lenw) {
        --L;
        --CV(s);
        rv -= CV(s);
      }
    } else {
      ++lenw;
    }
    ring[(head & (kRing - 1)) * kThreads] = static_cast<uint8_t>(t);
    ++head;
    ++L;
    rw += CW(t);
    ++CW(t);
    rv += CV(t);
    ++CV(t);
    if (CV(t) * 10 > 2 * T) {
      // pop the v-window oldest-first up to the oldest occurrence of t
      for (;;) {
        const int s = word(L - 1);
        --CV(s);
        rv -= CV(s);
        --L;
        if (s == t) break;
      }
    }
  }

  // sdust.c find_perfect(start) over rows rr = max(L, 1) .. lenw - 1: the
  // TPU kernel's sweep starts at row 1, so with L = 0 (only reachable for
  // T < 5) row 0's word is not counted, as there; the C counts it
  __device__ void find_perfect(int start) {
    int r = rv;
    int maxr = 0, maxl = 0;
    int next = start + kGroups - 1;       // starts above next: taken
    if (ngroups == 0) lo = start;         // every insert is >= start
    const int rr0 = max(L, 1);
    for (int rr = rr0; rr < lenw; ++rr) {
      const int ti = word(rr);
      r += CV(ti);
      ++CV(ti);
      if (static_cast<long long>(r) * 10 <=
          static_cast<long long>(T) * rr)
        continue;
      const int es = lenw - 1 - rr + start;
      for (int s = next; s >= es; --s) {
        const uint32_t g = G(s);
        if (g == 0u) continue;
        const int gr = static_cast<int>(g >> 16);
        const int gl = static_cast<int>((g >> 8) & 0xFFu);
        if (maxr == 0 || gr * maxl > maxr * gl) {
          maxr = gr;
          maxl = gl;
        }
      }
      next = es - 1;
      if (maxr == 0 || r * maxl >= maxr * rr) {
        maxr = r;
        maxl = rr;
        const uint32_t off = static_cast<uint32_t>(rr + 3);  // ef - es
        uint32_t& g = G(es);
        if (g == 0u) {
          ++ngroups;
          g = (static_cast<uint32_t>(r) << 16) |
              (static_cast<uint32_t>(rr) << 8) | off;
        } else {
          const int gr = static_cast<int>(g >> 16);
          const int gl = static_cast<int>((g >> 8) & 0xFFu);
          g = r * gl > gr * rr
                  ? (static_cast<uint32_t>(r) << 16) |
                        (static_cast<uint32_t>(rr) << 8) | off
                  : (g & ~0xFFu) | off;
        }
      }
    }
    for (int rr = rr0; rr < lenw; ++rr) --CV(word(rr));
  }

  // the DP of one row; false when the row passed `budget` find_perfect
  // row-steps (budget > 0) and stopped, its outputs not written
  __device__ bool run(const uint8_t* __restrict__ row, int clen, int budget,
                      int32_t* count) {
    for (int e = 0; e < kRing; ++e) {
      ring[e * kThreads] = 0;
      CV(e) = 0;
      CW(e) = 0;
    }
    for (int e = 0; e < kGroups; ++e) grp[e * kThreads] = 0u;
    rv = rw = L = lenw = lo = ngroups = 0;
    head = 0u;
    res_s = res_f = nout = 0;
    res_has = false;
    int l = 0, t = 0, steps = 0;
    for (int i = 0; i < clen; ++i) {
      const int b = __ldg(row + i);
      if (b < 4) {
        ++l;
        t = ((t << 2) | b) & (kRing - 1);
        if (l >= 3) {
          const int start = max(l - W, 0) + (i + 1 - l);
          save(start);
          shift(t);
          if (static_cast<long long>(rw) * 10 >
              static_cast<long long>(L) * T) {
            steps += lenw - max(L, 1);
            if (budget > 0 && steps > budget) return false;
            find_perfect(start);
          }
        }
      } else {
        flush(max(l - W + 1, 0) + (i + 1 - l));
        l = t = 0;
      }
    }
    flush(max(l - W + 1, 0) + (clen + 1 - l));
    if (res_has) emit(res_s, res_f);
    *count = nout;
    return true;
  }
};

__global__ void __launch_bounds__(kThreads)
sdust_light_kernel(const uint8_t* __restrict__ codes,
                   const long long* __restrict__ row_off, int n, int clen,
                   int T, int W, int maxi, int budget,
                   int32_t* __restrict__ outs, int32_t* __restrict__ outf,
                   int32_t* __restrict__ outn, int32_t* __restrict__ heavy,
                   int32_t* __restrict__ n_heavy) {
  __shared__ uint8_t s_ring[kRing * kThreads];
  __shared__ uint8_t s_cv[kRing * kThreads];
  __shared__ uint8_t s_cw[kRing * kThreads];
  __shared__ uint32_t s_grp[kGroups * kThreads];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  Dp dp;
  dp.ring = s_ring + threadIdx.x;
  dp.cv = s_cv + threadIdx.x;
  dp.cw = s_cw + threadIdx.x;
  dp.grp = s_grp + threadIdx.x;
  dp.T = T;
  dp.W = W;
  dp.NW = W - 2;
  dp.maxi = maxi;
  dp.outs = outs + static_cast<long long>(r) * maxi;
  dp.outf = outf + static_cast<long long>(r) * maxi;
  if (!dp.run(codes + row_off[r], clen, budget, outn + r))
    heavy[atomicAdd(n_heavy, 1)] = r;
}

// ------------------------------------------------------------- heavy pass

__device__ __forceinline__ uint64_t low_mask(int n) {   // bits [0, n)
  return n >= 64 ? ~0ull : n <= 0 ? 0ull : (1ull << n) - 1ull;
}

__device__ __forceinline__ uint64_t spread(uint32_t x) {  // bit i -> 2i
  uint64_t v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

__device__ __forceinline__ uint64_t rotr(uint64_t x, int s) {  // 0 <= s < 64
  return s ? (x >> s) | (x << (64 - s)) : x;
}

// element idx (0..63) of a warp array held two per lane (2j, 2j + 1)
template <typename V>
__device__ __forceinline__ V pick(V x0, V x1, int idx) {
  const V a = __shfl_sync(kFull, x0, idx >> 1);
  const V b = __shfl_sync(kFull, x1, idx >> 1);
  return (idx & 1) ? b : a;
}

// ratios n / d packed as n << 8 | d (n <= 2016, 1 <= d < 64); none = 0 / 1
constexpr uint32_t kNone = 1u;
__device__ __forceinline__ uint32_t ratio(int n, int d) {
  return (static_cast<uint32_t>(n) << 8) | static_cast<uint32_t>(d);
}
__device__ __forceinline__ bool gt(uint32_t a, uint32_t b) {   // a > b
  return (a >> 8) * (b & 0xFFu) > (b >> 8) * (a & 0xFFu);
}
__device__ __forceinline__ uint32_t rmax(uint32_t a, uint32_t b) {
  return gt(b, a) ? b : a;
}

struct WarpDp {
  int lane;
  int T, W, NW, maxi;
  int32_t* outs;
  int32_t* outf;
  uint32_t w0, w1;   // words of ring rows 2 lane, 2 lane + 1 (row 0 newest)
  uint64_t m0, m1;   // rows holding word values 2 lane, 2 lane + 1
  uint32_t g0, g1;   // start-group slots 2 lane, 2 lane + 1
  // warp-uniform
  uint64_t occ;      // bit k: slot k is occupied
  int codes32;       // this lane's code of the current 32
  int L, lenw, lo, rv, rw;
  int res_s, res_f, nout;
  bool res_has;

  __device__ void emit(int s, int f) {
    if (nout < maxi && lane == 0) {
      outs[nout] = s;
      outf[nout] = f;
    }
    ++nout;
  }

  __device__ void save(int thresh) {
    if (occ == 0ull || thresh <= lo) return;
    const int span = thresh - lo;
    const int sh = lo & (kGroups - 1);
    // bit d: the slot of start lo + d
    const uint64_t below = rotr(occ, sh) & low_mask(span);
    if (below != 0ull) {
      const int s = lo + __ffsll(static_cast<long long>(below)) - 1;
      const uint32_t g = pick(g0, g1, s & (kGroups - 1));
      const int f = s + static_cast<int>(g & 0xFFu);
      if (res_has && s <= res_f) {
        res_f = max(res_f, f);
      } else {
        if (res_has) emit(res_s, res_f);
        res_s = s;
        res_f = f;
        res_has = true;
      }
      const uint64_t gone = rotr(low_mask(span), (kGroups - sh) & 63);
      occ &= ~gone;
      if ((gone >> (2 * lane)) & 1ull) g0 = 0u;
      if ((gone >> (2 * lane + 1)) & 1ull) g1 = 0u;
    }
    lo = thresh;
  }

  __device__ void flush(int thresh0) {
    for (int k = 0; k < W + kGslotJax + 8 && occ != 0ull; ++k)
      save(thresh0 + k);
  }

  __device__ void shift(int t) {
    const int lenw1 = min(lenw + 1, NW);
    int L1 = min(L + 1, lenw1);
    const uint32_t up = __shfl_up_sync(kFull, w1, 1);
    w1 = w0;
    w0 = lane ? up : static_cast<uint32_t>(t);
    const uint64_t keep = low_mask(lenw1);
    m0 = (m0 << 1) & keep;
    m1 = (m1 << 1) & keep;
    if ((t >> 1) == lane) {
      if (t & 1)
        m1 |= 1ull;
      else
        m0 |= 1ull;
    }
    lenw = lenw1;
    // the owner of t's mask finds the eviction: its highest row below L1
    const uint64_t mt = ((t & 1) ? m1 : m0) & low_mask(L1);
    const int evict = __popcll(mt) * 10 > 2 * T ? 63 - __clzll(mt) : L1;
    L = __shfl_sync(kFull, evict, t >> 1);
    const uint64_t vm = low_mask(L);
    const int c0 = __popcll(m0), c1 = __popcll(m1);
    const int v0 = __popcll(m0 & vm), v1 = __popcll(m1 & vm);
    const unsigned pairs =
        (static_cast<unsigned>((c0 * (c0 - 1) + c1 * (c1 - 1)) / 2) << 16) |
        static_cast<unsigned>((v0 * (v0 - 1) + v1 * (v1 - 1)) / 2);
    const unsigned sum = __reduce_add_sync(kFull, pairs);
    rw = static_cast<int>(sum >> 16);
    rv = static_cast<int>(sum & 0xFFFFu);
  }

  __device__ void find_perfect(int start) {
    if (occ == 0ull) lo = start;
    const int rr0 = max(L, 1);
    const uint64_t excl = L == 0 ? 1ull : 0ull;
    const int ra = 2 * lane, rb = ra + 1;
    const bool act_a = ra >= rr0 && ra < lenw;
    const bool act_b = rb >= rr0 && rb < lenw;
    // each row adds the count of its word among the rows before it; the
    // pending groups come in d = start' - start order (slot (start + d) &
    // 63).  The prefix sum of the counts and the suffix maximum of the
    // groups' ratios are independent scans, run in one loop.
    const uint64_t ma = pick(m0, m1, static_cast<int>(w0));
    const uint64_t mb = pick(m0, m1, static_cast<int>(w1));
    const int k = (start + ra) & (kGroups - 1);
    const uint32_t da = pick(g0, g1, k);
    const uint32_t db = pick(g0, g1, (k + 1) & (kGroups - 1));
    const int inc_a = act_a ? __popcll(ma & low_mask(ra) & ~excl) : 0;
    const int inc_b = act_b ? __popcll(mb & low_mask(rb) & ~excl) : 0;
    const uint32_t ga = da ? ratio(da >> 16, (da >> 8) & 0xFFu) : kNone;
    const uint32_t gb = db ? ratio(db >> 16, (db >> 8) & 0xFFu) : kNone;
    int s = inc_a + inc_b;
    uint32_t sfx = rmax(gb, ga);
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      const uint32_t z = __shfl_down_sync(kFull, sfx, o);
      if (lane >= o) s += y;
      if (lane + o < 32) sfx = rmax(sfx, z);
    }
    const int r_b = rv + s;
    const int r_a = r_b - inc_b;
    const bool fire_a = act_a && static_cast<long long>(r_a) * 10 >
                                     static_cast<long long>(T) * ra;
    const bool fire_b = act_b && static_cast<long long>(r_b) * 10 >
                                     static_cast<long long>(T) * rb;
    if (__ballot_sync(kFull, fire_a || fire_b) == 0u) return;
    // exclusive prefix maximum of the firing candidates' ratios
    const uint32_t ca = fire_a ? ratio(r_a, ra) : kNone;
    const uint32_t cb = fire_b ? ratio(r_b, rb) : kNone;
    uint32_t c = rmax(ca, cb);
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, c, o);
      if (lane >= o) c = rmax(y, c);
    }
    uint32_t ex = __shfl_up_sync(kFull, c, 1);
    if (lane == 0) ex = kNone;
    uint32_t exs = __shfl_down_sync(kFull, sfx, 1);
    if (lane == 31) exs = kNone;
    const uint32_t sm_b = rmax(gb, exs);   // groups with d >= rb
    const uint32_t sm_a = rmax(ga, sm_b);  // groups with d >= ra
    // row rr sees the candidates before it and the groups with
    // d >= lenw - 1 - rr
    const uint32_t best_a =
        rmax(ex, pick(sm_a, sm_b, (lenw - 1 - ra) & (kGroups - 1)));
    const uint32_t best_b = rmax(rmax(ex, ca),
        pick(sm_a, sm_b, (lenw - 1 - rb) & (kGroups - 1)));
    const bool ins_a = fire_a && !gt(best_a, ratio(r_a, ra));
    const bool ins_b = fire_b && !gt(best_b, ratio(r_b, rb));
    // row rr inserts into the slot of d = lenw - 1 - rr: the rows' ballot
    // reversed (bit rr -> 63 - rr) and rotated left by start + lenw
    const uint64_t rows = spread(__ballot_sync(kFull, ins_a)) |
                          (spread(__ballot_sync(kFull, ins_b)) << 1);
    occ |= rotr(__brevll(rows), (kGroups - ((start + lenw) & 63)) & 63);
    // slot of d takes row lenw - 1 - d
    const uint32_t ia = ins_a ? 0x80000000u | static_cast<uint32_t>(r_a) : 0u;
    const uint32_t ib = ins_b ? 0x80000000u | static_cast<uint32_t>(r_b) : 0u;
    const int d0 = (2 * lane - start) & (kGroups - 1);
    const int d1 = (2 * lane + 1 - start) & (kGroups - 1);
    const uint32_t x0 = pick(ia, ib, (lenw - 1 - d0) & (kGroups - 1));
    const uint32_t x1 = pick(ia, ib, (lenw - 1 - d1) & (kGroups - 1));
    if (d0 < lenw && (x0 & 0x80000000u)) g0 = insert(g0, x0, lenw - 1 - d0);
    if (d1 < lenw && (x1 & 0x80000000u)) g1 = insert(g1, x1, lenw - 1 - d1);
  }

  __device__ static uint32_t insert(uint32_t g, uint32_t x, int rr) {
    const uint32_t r = x & 0x7FFFFFFFu;
    const uint32_t off = static_cast<uint32_t>(rr + 3);  // ef - es
    const uint32_t gr = g >> 16, gl = (g >> 8) & 0xFFu;
    if (g == 0u || r * gl > gr * static_cast<uint32_t>(rr))
      return (r << 16) | (static_cast<uint32_t>(rr) << 8) | off;
    return (g & ~0xFFu) | off;
  }

  __device__ void run(const uint8_t* __restrict__ row, int clen,
                      int32_t* count) {
    w0 = w1 = g0 = g1 = 0u;
    m0 = m1 = occ = 0ull;
    L = lenw = lo = rv = rw = 0;
    res_s = res_f = nout = 0;
    res_has = false;
    int l = 0, t = 0;
    // lane j holds code i0 + j of the current 32, the next 32 in flight
    int next = lane < clen ? __ldg(row + lane) : 4;
    for (int i = 0; i < clen; ++i) {
      const int q = i & 31;
      if (q == 0) {
        const int ahead = i + 32 + lane;
        codes32 = next;
        next = ahead < clen ? __ldg(row + ahead) : 4;
      }
      const int b = __shfl_sync(kFull, codes32, q);
      if (b < 4) {
        ++l;
        t = ((t << 2) | b) & (kRing - 1);
        if (l >= 3) {
          const int start = max(l - W, 0) + (i + 1 - l);
          save(start);
          shift(t);
          if (static_cast<long long>(rw) * 10 >
              static_cast<long long>(L) * T)
            find_perfect(start);
        }
      } else {
        flush(max(l - W + 1, 0) + (i + 1 - l));
        l = t = 0;
      }
    }
    flush(max(l - W + 1, 0) + (clen + 1 - l));
    if (res_has) emit(res_s, res_f);
    if (lane == 0) *count = nout;
  }
};

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sdust_heavy_kernel(const uint8_t* __restrict__ codes,
                   const long long* __restrict__ row_off, int clen, int T,
                   int W, int maxi, int32_t* __restrict__ outs,
                   int32_t* __restrict__ outf, int32_t* __restrict__ outn,
                   const int32_t* __restrict__ heavy,
                   const int32_t* __restrict__ n_heavy) {
  const int n = *n_heavy;
  const int warps = gridDim.x * kWarpsPerBlock;
  WarpDp dp;
  dp.lane = static_cast<int>(threadIdx.x & 31u);
  dp.T = T;
  dp.W = W;
  dp.NW = W - 2;
  dp.maxi = maxi;
  for (int j = blockIdx.x * kWarpsPerBlock + static_cast<int>(threadIdx.x >> 5);
       j < n; j += warps) {
    const int r = heavy[j];
    dp.outs = outs + static_cast<long long>(r) * maxi;
    dp.outf = outf + static_cast<long long>(r) * maxi;
    dp.run(codes + row_off[r], clen, outn + r);
  }
}

}  // namespace

// codes: uint8 on the current device; row_off (n,) int64: row r is
// codes[row_off[r] .. row_off[r] + clen), inside the buffer; outs, outf
// (n, maxi) int32 zero-filled by the caller, outn (n,) int32; heavy (n,)
// int32 and n_heavy (1,) int32 zeroed by the caller.  3 <= W <= 66.
// budget > 0: a row past `budget` find_perfect row-steps is listed in
// heavy[0 .. *n_heavy) with its outputs unwritten; budget 0 runs every row.
// Returns a cudaError_t (0 = launched).
extern "C" int cornetto_sdust_light(const void* codes, const void* row_off,
                                    int n, int clen, int T, int W, int maxi,
                                    int budget, void* outs, void* outf,
                                    void* outn, void* heavy, void* n_heavy,
                                    void* stream) {
  if (n < 1 || clen < 1 || W < 3 || W - 2 > kRing || maxi < 1 || budget < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sdust_light_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const long long*>(row_off), n, clen, T, W, maxi, budget,
      static_cast<int32_t*>(outs), static_cast<int32_t*>(outf),
      static_cast<int32_t*>(outn), static_cast<int32_t*>(heavy),
      static_cast<int32_t*>(n_heavy));
  return static_cast<int>(cudaGetLastError());
}

// The rows listed by the light pass, from scratch: `max_rows` bounds the
// list's length (n of the light launch); the kernel reads the length on
// the device, so no host sync sits between the passes.
extern "C" int cornetto_sdust_heavy(const void* codes, const void* row_off,
                                    int max_rows, int clen, int T, int W,
                                    int maxi, void* outs, void* outf,
                                    void* outn, const void* heavy,
                                    const void* n_heavy, void* stream) {
  if (max_rows < 1 || clen < 1 || W < 3 || W - 2 > kRing || maxi < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int want = (max_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const unsigned blocks =
      static_cast<unsigned>(std::min(want, std::max(sms, 1) * 16));
  sdust_heavy_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const long long*>(row_off), clen, T, W, maxi,
      static_cast<int32_t*>(outs), static_cast<int32_t*>(outf),
      static_cast<int32_t*>(outn), static_cast<const int32_t*>(heavy),
      static_cast<const int32_t*>(n_heavy));
  return static_cast<int>(cudaGetLastError());
}
