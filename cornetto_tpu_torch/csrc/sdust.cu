// SDUST DP over independent chunks for NVIDIA Hopper (sm_90a).
//
// Replaces cornetto_tpu/kernels/pallas_sdust.py::sdust_pallas_chunks (body
// _sdust_kernel, jitted by _jit_kernel): the symmetric-DUST DP of lh3/sdust
// (src/sdust/sdust.c:66-160, transcribed in cornetto_tpu/kernels/
// sdust_core.py:32-127) run independently on each row of codes (0-3 bases,
// 4 = N, the row's end an N).  Rows come from the exact chunk plan of
// cornetto_tpu/kernels/sdust_chunked.py; the host clips and unions them.
// Plain PyTorch version: cornetto_tpu_torch/kernels/sdust.py::sdust_dp_ref.
//
// The TPU kernel runs 128-512 chunks as vector lanes, so every
// data-dependent branch of the C becomes a masked plane operation (a roll of
// the whole ring per base, one-hot histogram updates, iota-max evictions).
// Here each chunk is one thread running the sequential DP with plain loops:
//
// - state of one thread: a circular ring of 64 word codes (newest at
//   head - 1), the cv / cw counts of the 64 word values (<= 64, uint8), and
//   the pending perfect intervals.  The C keeps those as a flat vector P
//   that reaches ~1700 entries on homopolymers; the TPU kernel's start-group
//   representation keeps what the DP reads of it: per start coordinate, the
//   newest entry's finish and the group's strict-ratio winner (r, l).  A
//   sweep inserts starts in [start, start + lenw - 2] right after
//   save_masked_regions(start), and a flush empties P, so every pending
//   start lies in [lo, lo + 63) with lo the start of the sweep that found
//   the first of them, raised by each later threshold: 64 slots keyed by
//   start & 63 are exact (starts are not monotone across an N, so lo is
//   reset when P is empty).  A slot packs finish - start (8 bits), l (8)
//   and r (16) in one word, 0 when empty;
// - save_masked_regions walks the slots from lo up to its threshold (about
//   one slot per base), find_perfect's rescans of P become one descending
//   walk over the slots with the running maximum (groups are taken in
//   descending start order as the sweep's candidate start falls, as the TPU
//   kernel argues), and its copy of cv is undone after the sweep;
// - the state lives in shared memory, thread-minor ([element][thread]), 448
//   bytes per thread: 28 KB for a block of 64 threads, so 7 blocks (448
//   threads) fit an SM;
// - codes are read with one byte load per base per thread from the row's
//   offset in a padded sequence, so one upload of a contig serves all its
//   chunks (rows overlap by 5W + 8 bases), through the read-only cache.
//
// What bounds it: the DP is sequential per chunk, branchy and
// latency-bound on shared memory; the card's parallelism is the number of
// chunks (~121k for a 249 Mbp contig at core = 2048).  Dense satellite
// costs up to ~60 sweep steps per base in find_perfect; random sequence a
// few dozen instructions per base.
//
// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/_build.py);
// the caller allocates the outputs and passes its current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kRing = 64;       // ring capacity and number of word values
constexpr int kGroups = 64;     // pending-interval start slots
constexpr int kGslotJax = 128;  // the TPU kernel's slots: its flush bound

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

  __device__ void run(const uint8_t* __restrict__ row, int clen,
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
    int l = 0, t = 0;
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
    *count = nout;
  }
};

__global__ void __launch_bounds__(kThreads)
sdust_kernel(const uint8_t* __restrict__ codes,
             const long long* __restrict__ row_off, int n, int clen, int T,
             int W, int maxi, int32_t* __restrict__ outs,
             int32_t* __restrict__ outf, int32_t* __restrict__ outn) {
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
  dp.run(codes + row_off[r], clen, outn + r);
}

}  // namespace

// codes: uint8 on the current device; row_off (n,) int64: row r is
// codes[row_off[r] .. row_off[r] + clen), inside the buffer; outs, outf
// (n, maxi) int32 zero-filled by the caller, outn (n,) int32.  3 <= W <= 66.
// Returns a cudaError_t (0 = launched).
extern "C" int cornetto_sdust(const void* codes, const void* row_off, int n,
                              int clen, int T, int W, int maxi, void* outs,
                              void* outf, void* outn, void* stream) {
  if (n < 1 || clen < 1 || W < 3 || W - 2 > kRing || maxi < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  sdust_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes),
      static_cast<const long long*>(row_off), n, clen, T, W, maxi,
      static_cast<int32_t*>(outs), static_cast<int32_t*>(outf),
      static_cast<int32_t*>(outn));
  return static_cast<int>(cudaGetLastError());
}
