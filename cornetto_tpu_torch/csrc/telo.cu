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
// - Mask.  Bound by device memory: one byte read and one written per base
//   (0.149 ms for chr1 on an H100 SXM).  The TPU version tiles a contig
//   into 64 Kb rows with a k - 1 halo; here the (B, L) batch is one flat
//   array and a contig is one row of any length.  Design:
//   - a thread owns kGroups = 2 groups of kPer = 16 consecutive positions,
//     a block a tile of kTile = 8,192; the block stages the tile and a halo
//     of the next NV - 1 16-byte vectors (up to 64 motif codes) in shared
//     memory, every 16-byte load issued before the first store.  The tile
//     starts at the 16-byte boundary at or below its first byte (a view may
//     start anywhere), so each group reads NV vectors from shared memory
//     and realigns them to its first byte once, with funnel shifts
//     (`realign`, one branch on the misalignment, uniform over the launch).
//     Two groups a thread were the fastest of 1, 2, 4 and 8 on chr1 (more
//     bytes in flight a block against fewer blocks an SM);
//   - compares without an early exit: for each motif code j a group XORs
//     its 16 bytes shifted by j (four 32-bit words, a funnel shift each)
//     with the code repeated in every byte and ORs the differences; a
//     position matches where its difference byte is 0 (a code >= 4 XOR a
//     code 0-3 is never 0).  Two ops a word a motif code, unrolled to KMAX
//     codes at compile time (16 or 64, chosen by k);
//   - row and column once per group from the tile's column (one 64-bit
//     remainder per block): a group's 16 positions are zeroed past their
//     row's last start only when they reach it, so rows may end inside a
//     group, of any length, including rows shorter than 16;
//   - one 16-byte store per group (a byte loop for the array's tail).
//   A motif longer than 64 codes takes the same compares for its later
//   chunks of 64 codes, with each group's window read from device memory
//   (16-byte read-only loads) instead of the staged tile.
// - Run stats (per read: n matches, the longest stride-k run capped at
//   2^steps copies, terminal).  The TPU kernel builds the run length at
//   every position with steps = ceil(log2(max(m // k, 1))) doubling passes,
//   which cap it at 2^steps copies; the results here are capped the same
//   way (longest = min(run, 2^steps), terminal = min(run[0], 2^steps) >=
//   thresh, position 0 only), so they are bit-equal to telo_run_stats_jax.
//   Bound by its bytes, the rows read once (0.00056 ms at 4096 x 450 on
//   an H100); the bitset's operations, four bytes a compare and 32
//   positions a doubling step, take less.  Two kernels, chosen per call by
//   the row length and the motif:
//   - the bitset kernel (stats_bits_kernel), for rows of up to kStatsMaxL =
//     4,096 bases and motifs of up to kMotifMax = 64 codes: a warp
//     (kStatsLanes = 32 lanes) a read and up to 8 reads a block, no block
//     barrier.  The group stages its row in shared memory with 16-byte
//     loads (rows start at any byte), then computes the matches as a
//     bitset, 32 positions a word, with the mask's XOR compares four bytes
//     a word and no early exit, the motif a kernel argument (no upload);
//     n is a sum of popcounts.  Runs by doubling on the bitset: A_1 = M,
//     A_2w = A_w & (A_w >> w k), one level a step in shared memory,
//     stopping at the first empty level; the capped longest run comes from
//     lifting a set of positions from the top level down, and terminal
//     from lifting bit 0.  A warp a read beat 16 lanes, and the doubling
//     beat a per-start walk on the bitset (0.0060 vs 0.0075 and 0.0076 ms
//     at 4096 x 450 by graph replay on an H100);
//   - the row walk (stats_walk_kernel, the first design), for longer rows and
//     for motifs of more than 64 codes (then read from device memory): one
//     block a read, threads striding over the positions with byte compares
//     with an early exit; at each start of a stride-k run (a match with no
//     match k before it) a thread walks the run; the block reduces.
//   Either kernel is one launch, writing terminal as 0/1 bytes into the
//   caller's bool tensor.

// Plain C interface, loaded with ctypes (cornetto_tpu_torch/kernels/_build.py);
// the caller allocates the outputs and passes its current stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaskThreads = 256;
constexpr int kPer = 16;                        // positions a group
constexpr int kGroups = 2;                      // groups a thread
constexpr int kTile = kMaskThreads * kPer * kGroups;   // positions a block
constexpr int kStatsThreads = 128;               // the row walk's block
constexpr int kStatsLanes = 32;                 // the bitset: lanes a read
constexpr int kStatsBlock = 256;                // most threads a block
constexpr int kStatsMaxL = 4096;                // longest row of the bitset
constexpr int kMotifMax = 64;                   // codes passed by value
constexpr size_t kStatsSmem = 48 * 1024;        // a block's shared memory

struct Motif {
  uint8_t c[kMotifMax];
};

__device__ __forceinline__ void put_words(unsigned* w, const uint4& v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// r[q] = bytes 4 (q + S) + sh/8 ... + 3 of the words w
template <int S, int NR>
__device__ __forceinline__ void shift_words(const unsigned* w, unsigned sh,
                                            unsigned* r) {
#pragma unroll
  for (int q = 0; q < NR; ++q) r[q] = __funnelshift_r(w[q + S], w[q + S + 1], sh);
}

// r[q] = bytes mis + 4q ... mis + 4q + 3 of the window w (mis < 16)
template <int NR>
__device__ __forceinline__ void realign(const unsigned* w, int mis,
                                        unsigned* r) {
  const unsigned sh = 8u * static_cast<unsigned>(mis & 3);
  switch (mis >> 2) {
    case 0: shift_words<0, NR>(w, sh, r); break;
    case 1: shift_words<1, NR>(w, sh, r); break;
    case 2: shift_words<2, NR>(w, sh, r); break;
    default: shift_words<3, NR>(w, sh, r); break;
  }
}

// diff[q] |= (bytes 4q + j ... 4q + j + 3 of r) ^ rep[j] for j < kc: byte x
// of diff stays 0 while position x matches the motif codes seen so far
template <int KMAX, int NR>
__device__ __forceinline__ void compare(const unsigned* r,
                                        const unsigned* rep, int kc,
                                        unsigned* diff) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < kc) {
      const unsigned m = rep[j];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int a = q + (j >> 2);
        const unsigned s =
            (j & 3) ? __funnelshift_r(r[a], r[a + 1], 8u * (j & 3)) : r[a];
        diff[q] |= s ^ m;
      }
    }
  }
}

// KMAX: motif codes compared from one window (a multiple of 16); NR: a
// group's realigned words (16 + KMAX bytes); NV: the 16-byte vectors that
// hold them from the aligned address at or below its first byte.  Thread t
// owns the groups of 16 positions t + g * kMaskThreads of the block's tile.
template <int KMAX>
__global__ void __launch_bounds__(kMaskThreads)
mask_kernel(const uint8_t* __restrict__ codes, long long total, long long L,
            const uint8_t* __restrict__ motif, int k,
            int8_t* __restrict__ out) {
  constexpr int NR = 4 + KMAX / 4;
  constexpr int NV = (NR + 4 + 3) / 4;
  constexpr int kTileVec = kMaskThreads * kGroups + NV - 1;
  constexpr int kLoads = (kTileVec + kMaskThreads - 1) / kMaskThreads;
  __shared__ uint4 tile[kTileVec];
  __shared__ unsigned rep[KMAX];
  __shared__ long long tile_col;

  // vector i of `base` holds the codes-relative bytes [16 i - mis, +16);
  // it is read only if it holds a byte of the array
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(codes) & 15);
  const uint4* base = reinterpret_cast<const uint4*>(codes - mis);
  const long long nvec = (total + mis + 15) / 16;
  const long long P = static_cast<long long>(blockIdx.x) * kTile;
  const long long v0 = P / 16;                    // the tile's first vector
  const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);

  uint4 ld[kLoads];                    // every load in flight before a store
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = threadIdx.x + i * kMaskThreads;
    ld[i] = v < kTileVec && v0 + v < nvec ? __ldg(base + v0 + v) : none;
  }
  if (threadIdx.x == 0) tile_col = P % L;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int v = threadIdx.x + i * kMaskThreads;
    if (v < kTileVec) tile[v] = ld[i];
  }

  unsigned diff[kGroups][4] = {};
  for (int c0 = 0; c0 < k; c0 += KMAX) {
    const int kc = min(KMAX, k - c0);
    __syncthreads();                   // the last chunk's reads of rep
    if (threadIdx.x < kc)
      rep[threadIdx.x] = __ldg(motif + c0 + threadIdx.x) * 0x01010101u;
    __syncthreads();                   // rep, and at c0 = 0 the tile
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int tv = threadIdx.x + g * kMaskThreads;
      unsigned w[4 * NV], r[NR];
      if (c0 == 0) {
#pragma unroll
        for (int a = 0; a < NV; ++a) put_words(w + 4 * a, tile[tv + a]);
      } else {                         // motif codes past the staged halo
#pragma unroll
        for (int a = 0; a < NV; ++a) {
          const long long i = v0 + tv + c0 / 16 + a;
          put_words(w + 4 * a, i < nvec ? __ldg(base + i) : none);
        }
      }
      realign<NR>(w, mis, r);
      compare<KMAX, NR>(r, rep, kc, diff[g]);
    }
  }

  const long long m = L - k + 1;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int tv = threadIdx.x + g * kMaskThreads;
    const long long p0 = P + kPer * tv;
    if (p0 >= total) break;
    // the column of position p0; tile_col + 16 tv < L + kTile
    long long col = tile_col + kPer * tv;
    if (col >= L)
      col = L >= kTile ? col - L
                       : static_cast<long long>(static_cast<unsigned>(col) %
                                                static_cast<unsigned>(L));
    unsigned res[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {      // 0x01 where the difference byte is 0
      const unsigned t = ((diff[g][q] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) |
                         diff[g][q];
      res[q] = (~t & 0x80808080u) >> 7;
    }
    if (col + kPer > m) {              // a start past its row's last one
      unsigned valid = 0;
      long long c = col;
      for (int x = 0; x < kPer; ++x) {
        valid |= (c < m ? 1u : 0u) << x;
        if (++c == L) c = 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        res[q] &= (((valid >> (4 * q)) & 0xFu) * 0x00204081u) & 0x01010101u;
    }
    int8_t* dst = out + p0;
    if (p0 + kPer <= total) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(res[0], res[1], res[2],
                                                  res[3]);
    } else {
      for (int x = 0; x < total - p0; ++x)
        dst[x] = static_cast<int8_t>((res[x >> 2] >> (8 * (x & 3))) & 1u);
    }
  }
}

// the 32-bit word of the group's 32-bit-aligned words u starting at byte
// offset o (o < 4 in the first word)
__device__ __forceinline__ uint32_t word_at(const uint32_t* u, int a,
                                            unsigned o) {
  return o ? __funnelshift_r(u[a], u[a + 1], 8u * o) : u[a];
}

// diff[q] |= (bytes 4q + j ... 4q + j + 3 of r) ^ (motif code j in every
// byte) for j < k: byte x of diff stays 0 while position x matches
template <int KMAX>
__device__ __forceinline__ void compare32(const uint32_t* r,
                                          const Motif& motif, int k,
                                          uint32_t* diff) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      const uint32_t rep = motif.c[j] * 0x01010101u;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        diff[q] |= word_at(r, q + (j >> 2), j & 3) ^ rep;
    }
  }
}

// bit x of the result = 1 where byte x of diff[x / 4] is 0 (x < 32)
__device__ __forceinline__ uint32_t zero_bytes(const uint32_t* diff) {
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const uint32_t t = ((diff[q] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | diff[q];
    const uint32_t z = (~t & 0x80808080u) >> 7;          // bytes 0 or 1
    bits |= ((z * 0x01020408u) >> 24) << (4 * q);
  }
  return bits;
}

// word x of a level (nw words), 0 past its end
__device__ __forceinline__ uint32_t level_word(const uint32_t* lv, int x,
                                               int nw) {
  return x < nw ? lv[x] : 0u;
}

// bit i + s of a level as bit i of word j: word j of (lv >> s)
__device__ __forceinline__ uint32_t shifted_word(const uint32_t* lv, int j,
                                                 int s, int nw) {
  const int x = j + (s >> 5);
  return __funnelshift_r(level_word(lv, x, nw), level_word(lv, x + 1, nw),
                         static_cast<unsigned>(s & 31));
}

// One group of G lanes a read, groups = blockDim.x / G reads a block; a
// group's shared memory: its staged row (stage bytes), then levels 0 ..
// steps of the bitset, nw = ceil(m / 32) words each.  Lane l owns the words
// l, l + G, ... (at most W).  The bitset's bit i = a match starting at i.
template <int G, int KMAX>
__global__ void __launch_bounds__(kStatsBlock)
stats_bits_kernel(const uint8_t* __restrict__ codes, long long B, int L,
                  const __grid_constant__ Motif motif, int k, int steps,
                  int thresh, int stage, int group_bytes,
                  int32_t* __restrict__ n_out,
                  int32_t* __restrict__ longest_out,
                  uint8_t* __restrict__ terminal_out) {
  constexpr int W = (kStatsMaxL + 32 * G - 1) / (32 * G);
  constexpr int NR = 8 + KMAX / 4;       // realigned words: 32 + KMAX bytes
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % G;
  const int gid = threadIdx.x / G;
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x / G) + gid;
  if (row >= B) return;
  const unsigned gmask =
      G == 32 ? 0xFFFFFFFFu : (((1u << G) - 1u) << (threadIdx.x & 31 & -G));
  unsigned char* mine = smem + static_cast<size_t>(gid) * group_bytes;
  uint32_t* lv = reinterpret_cast<uint32_t*>(mine + stage);
  const int m = L - k + 1;
  const int nw = m > 0 ? (m + 31) >> 5 : 0;

  // the row's bytes [0, L) at stage byte mis + i, from the 16-byte vectors
  // that hold them
  const uint8_t* rp = codes + row * L;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(rp) & 15);
  const uint4* src = reinterpret_cast<const uint4*>(rp - mis);
  uint4* st4 = reinterpret_cast<uint4*>(mine);
  const int nvec = (mis + L + 15) >> 4;
#pragma unroll 4
  for (int v = lane; v < nvec; v += G) st4[v] = __ldg(src + v);
  __syncwarp(gmask);

  // level 0: the match bitset; word j holds positions 32 j .. 32 j + 31
  const uint32_t* st32 = reinterpret_cast<const uint32_t*>(mine);
  const unsigned sh = static_cast<unsigned>(mis & 3);
  uint32_t own[W];
  int n = 0;
  bool any = false;
#pragma unroll
  for (int a = 0; a < W; ++a) {
    const int j = lane + a * G;
    uint32_t bits = 0;
    if (j < nw) {
      const int w0 = (mis >> 2) + 8 * j;
      uint32_t u[NR + 1], r[NR];
#pragma unroll
      for (int x = 0; x <= NR; ++x) u[x] = st32[w0 + x];
#pragma unroll
      for (int x = 0; x < NR; ++x) r[x] = word_at(u, x, sh);
      uint32_t diff[8] = {};
      compare32<KMAX>(r, motif, k, diff);
      bits = zero_bytes(diff);
      if (m - 32 * j < 32) bits &= (1u << (m - 32 * j)) - 1u;  // past m
      lv[j] = bits;
    }
    own[a] = bits;
    n += __popc(bits);
    any |= bits != 0u;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) n += __shfl_xor_sync(gmask, n, o);
  int top = __any_sync(gmask, any) ? 0 : -1;   // the highest nonempty level
  __syncwarp(gmask);

  int longest = 0, run0 = 0;
  // level t + 1 = level t & (level t >> 2^t k): bit i set where the run
  // at i holds at least 2^(t+1) copies
  for (int t = 0; t < steps && top == t; ++t) {
    const uint32_t* P = lv + t * nw;
    uint32_t* Q = lv + (t + 1) * nw;
    bool nz = false;
#pragma unroll
    for (int a = 0; a < W; ++a) {
      const int j = lane + a * G;
      if (j < nw) {
        own[a] &= shifted_word(P, j, k << t, nw);
        Q[j] = own[a];
        nz |= own[a] != 0u;
      }
    }
    if (__any_sync(gmask, nz)) top = t + 1;
    __syncwarp(gmask);
  }
  if (top == steps) {
    longest = 1 << steps;
  } else if (top >= 0) {
    // lift: S = the positions whose run holds at least c copies; from the
    // top level down, c grows by 2^t where some position of S holds 2^t
    // more copies after its first c
    int c = 1 << top;
    uint32_t S[W];
#pragma unroll
    for (int a = 0; a < W; ++a) {
      const int j = lane + a * G;
      S[a] = level_word(lv + top * nw, j, nw);
    }
    for (int t = top - 1; t >= 0; --t) {
      uint32_t T[W];
      bool nz = false;
#pragma unroll
      for (int a = 0; a < W; ++a) {
        const int j = lane + a * G;
        T[a] = j < nw ? S[a] & shifted_word(lv + t * nw, j, c * k, nw) : 0u;
        nz |= T[a] != 0u;
      }
      if (__any_sync(gmask, nz)) {
        c += 1 << t;
#pragma unroll
        for (int a = 0; a < W; ++a) S[a] = T[a];
      }
    }
    longest = c;
  }
  // the run at position 0, lifted the same way on one bit
  if (lane == 0 && top >= 0) {
    if (top == steps && (lv[steps * nw] & 1u)) {
      run0 = 1 << steps;
    } else {
      for (int t = min(top, steps - 1); t >= 0; --t) {
        const int p = run0 * k;
        if (p < m && ((lv[t * nw + (p >> 5)] >> (p & 31)) & 1u))
          run0 += 1 << t;
      }
    }
  }
  if (lane == 0) {
    n_out[row] = n;
    longest_out[row] = longest;
    terminal_out[row] = run0 >= thresh ? 1 : 0;
  }
}

// The first design: one block a read, byte compares with an early exit; the
// motif from the kernel argument, or from device memory (mdev) when it is
// longer than kMotifMax codes
__device__ __forceinline__ bool match_at(const uint8_t* __restrict__ row,
                                         long long i, const Motif& motif,
                                         const uint8_t* __restrict__ mdev,
                                         int k) {
  for (int j = 0; j < k; ++j)
    if (__ldg(row + i + j) != (mdev ? __ldg(mdev + j) : motif.c[j]))
      return false;
  return true;
}

__global__ void __launch_bounds__(kStatsThreads)
stats_walk_kernel(const uint8_t* __restrict__ codes, long long L,
                  const __grid_constant__ Motif motif,
                  const uint8_t* __restrict__ mdev, int k, long long cap,
                  int thresh, int32_t* __restrict__ n_out,
                  int32_t* __restrict__ longest_out,
                  uint8_t* __restrict__ terminal_out) {
  __shared__ long long s_n[kStatsThreads / 32];
  __shared__ long long s_max[kStatsThreads / 32];
  const uint8_t* row = codes + static_cast<long long>(blockIdx.x) * L;
  const long long m = L - k + 1;
  long long n = 0, best = 0, run0 = 0;    // run0: thread 0's position 0
  for (long long i = threadIdx.x; i < m; i += kStatsThreads) {
    if (!match_at(row, i, motif, mdev, k)) continue;
    ++n;
    if (i >= k && match_at(row, i - k, motif, mdev, k))
      continue;                                    // not a start
    long long run = 1;
    for (long long p = i + k; p < m && match_at(row, p, motif, mdev, k);
         p += k)
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

template <int KMAX>
cudaError_t launch_bits(const uint8_t* codes, long long B, int L,
                        const Motif& motif, int k, int steps, int thresh,
                        int32_t* n, int32_t* longest, uint8_t* terminal,
                        cudaStream_t s) {
  constexpr int G = kStatsLanes;
  const int m = L - k + 1;
  const int nw = m > 0 ? (m + 31) / 32 : 0;
  // the staged row, and every word a group's compares read past it
  const int stage = 16 * ((32 * nw + KMAX + 64 + 15) / 16);
  const int group_bytes = stage + 16 * ((4 * nw * (steps + 1) + 15) / 16);
  int groups = kStatsBlock / G;
  while (groups > 32 / G &&
         static_cast<size_t>(groups) * group_bytes > kStatsSmem)
    groups -= 32 / G;
  const long long blocks = (B + groups - 1) / groups;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  stats_bits_kernel<G, KMAX>
      <<<static_cast<unsigned>(blocks), groups * G,
         static_cast<size_t>(groups) * group_bytes, s>>>(
          codes, B, L, motif, k, steps, thresh, stage, group_bytes, n,
          longest, terminal);
  return cudaGetLastError();
}

}  // namespace

// codes (B, L) uint8 and out (B, L) int8, contiguous on the current device,
// out 16-byte aligned (codes may start anywhere); motif: k codes 0-3 on the
// device.  Returns a cudaError_t (0 = launched).
extern "C" int cornetto_telo_mask(const void* codes, long long B, long long L,
                                  const void* motif, int k, void* out,
                                  void* stream) {
  if (B < 1 || L < 1 || k < 1 || B > (1LL << 62) / L)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(out) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long total = B * L;
  const long long blocks = (total + kTile - 1) / kTile;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const uint8_t* mt = static_cast<const uint8_t*>(motif);
  int8_t* o = static_cast<int8_t*>(out);
  if (k <= 16)
    mask_kernel<16><<<static_cast<unsigned>(blocks), kMaskThreads, 0, s>>>(
        c, total, L, mt, k, o);
  else
    mask_kernel<64><<<static_cast<unsigned>(blocks), kMaskThreads, 0, s>>>(
        c, total, L, mt, k, o);
  return static_cast<int>(cudaGetLastError());
}

// codes (B, L) uint8 on the current device; motif_host: k codes 0-3 in
// host memory, passed to the kernel by value when k <= kMotifMax; motif_dev:
// the same codes on the device, needed (and read) only when k > kMotifMax;
// steps = ceil(log2(max((L - k + 1) // k, 1))) (the TPU kernel's doubling
// passes), thresh = ceil(min_run_bases / k).  The bitset kernel runs for
// rows of up to kStatsMaxL bases and k <= kMotifMax, the row walk
// otherwise.  Writes n (B,) int32, longest (B,) int32, terminal (B,) bytes
// 0/1 (a bool tensor).  One launch; returns a cudaError_t (0 = launched).
extern "C" int cornetto_telo_stats(const void* codes, long long B,
                                   long long L, const void* motif_host,
                                   const void* motif_dev, int k, int steps,
                                   int thresh, void* n, void* longest,
                                   void* terminal, void* stream) {
  if (B < 1 || B > 0x7FFFFFFFLL || L < 1 || k < 1 || steps < 0 ||
      steps > 62 || (k <= kMotifMax ? motif_host == nullptr
                                    : motif_dev == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Motif mv = {};
  if (k <= kMotifMax) {
    const uint8_t* h = static_cast<const uint8_t*>(motif_host);
    for (int j = 0; j < k; ++j) mv.c[j] = h[j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  int32_t* no = static_cast<int32_t*>(n);
  int32_t* lo = static_cast<int32_t*>(longest);
  uint8_t* to = static_cast<uint8_t*>(terminal);
  if (L <= kStatsMaxL && k <= kMotifMax) {
    const int Li = static_cast<int>(L);
    return static_cast<int>(
        k > 16 ? launch_bits<64>(c, B, Li, mv, k, steps, thresh, no, lo, to,
                                 s)
               : launch_bits<16>(c, B, Li, mv, k, steps, thresh, no, lo, to,
                                 s));
  }
  stats_walk_kernel<<<static_cast<unsigned>(B), kStatsThreads, 0, s>>>(
      c, L, mv,
      k > kMotifMax ? static_cast<const uint8_t*>(motif_dev) : nullptr, k,
      1LL << steps, thresh, no, lo, to);
  return static_cast<int>(cudaGetLastError());
}
