/* Native host kernels for the livefish minimizer-index build.
 *
 * The index build is host-side protocol work (it runs once per assembly
 * iteration, producing the device lookup table the decision engine
 * loads); round-3 did it in NumPy and a 3 Gbp genome cost 1,936 s /
 * 31.9 GB (SCALE_3GBP.json livefish_index).  The three passes here are
 * exact twins of the NumPy reference implementations in
 * kernels/minimizer.py (minimizers_np) and livefish/index.py
 * (the dedup + _build_buckets logic), validated bit-for-bit by
 * tests/test_livefish_index_native.py.
 *
 * Build: cc -O3 -shared -fPIC -pthread minimizer_native.c -o _minimizer_native.so
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

/* minimap2-style invertible finalizer, exactly the masked-64-bit chain
 * of kernels/minimizer.py:_hash32_np (valid for any canonical width) */
static inline uint32_t hash32(uint64_t x)
{
    const uint64_t mask = 0xFFFFFFFFu;
    x = (~x + (x << 21)) & mask;
    x = x ^ (x >> 24);
    x = (x + (x << 3) + (x << 8)) & mask;
    x = x ^ (x >> 14);
    x = (x + (x << 2) + (x << 4)) & mask;
    x = x ^ (x >> 28);
    x = (x + (x << 31)) & mask;
    return (uint32_t)x;
}

typedef struct {
    const uint8_t *codes;
    int64_t n;
    int k, w;
    int64_t j0, j1;            /* window range [j0, j1) */
    uint32_t *hash_out;        /* per-window min hash (0xFFFFFFFF = none) */
    int32_t *pos_out;          /* per-window argmin position */
} mzx_t;

static void *mzx_worker(void *arg)
{
    mzx_t *t = (mzx_t *)arg;
    const uint8_t *codes = t->codes;
    const int k = t->k, w = t->w;
    const uint64_t fmask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
    uint64_t fwd = 0, rev = 0;
    int64_t run = 0;           /* consecutive non-N codes ending here */
    int64_t i0 = t->j0 * w;
    int64_t b;
    /* warm up the rolling k-mer over codes[i0 .. i0+k-2] */
    for (b = i0; b < i0 + k - 1; ++b) {
        uint8_t c = codes[b];
        uint8_t c3 = c < 4 ? c : 3;
        run = c < 4 ? run + 1 : 0;
        fwd = ((fwd << 2) | c3) & fmask;
        rev = (rev >> 2) | ((uint64_t)(3 - c3) << (2 * (k - 1)));
    }
    int64_t j;
    for (j = t->j0; j < t->j1; ++j) {
        uint32_t mn = 0xFFFFFFFFu;
        int32_t mp = 0;
        int64_t i = j * w;
        int s;
        for (s = 0; s < w; ++s, ++i) {
            uint8_t c = codes[i + k - 1];
            uint8_t c3 = c < 4 ? c : 3;
            run = c < 4 ? run + 1 : 0;
            fwd = ((fwd << 2) | c3) & fmask;
            rev = (rev >> 2) | ((uint64_t)(3 - c3) << (2 * (k - 1)));
            if (run >= k) {
                uint64_t canon = fwd < rev ? fwd : rev;
                uint32_t h = hash32(canon);
                if (h < mn) {      /* strict: first-occurrence argmin */
                    mn = h;
                    mp = (int32_t)i;
                }
            }
        }
        t->hash_out[j] = mn;
        t->pos_out[j] = mp;
    }
    return 0;
}

/* Windowed-minima minimizer extraction, threaded over window ranges
 * (windows are independent given a k-1 warm-up).  hash_out/pos_out are
 * caller buffers of nwin = (n-k+1)/w entries; windows whose every k-mer
 * touches an N get hash 0xFFFFFFFF (caller filters). */
void mz_extract(const uint8_t *codes, int64_t n, int k, int w, int nthreads,
                uint32_t *hash_out, int32_t *pos_out)
{
    enum { MAXT = 32 };
    mzx_t th[MAXT];
    pthread_t tid[MAXT];
    int64_t m = n - k + 1;
    int64_t nwin = m > 0 ? m / w : 0;
    if (nwin <= 0) return;
    int T = nthreads < 1 ? 1 : (nthreads > MAXT ? MAXT : nthreads);
    if (nwin < 4 * T) T = 1;
    int t;
    for (t = 0; t < T; ++t) {
        th[t].codes = codes;
        th[t].n = n;
        th[t].k = k;
        th[t].w = w;
        th[t].j0 = nwin * t / T;
        th[t].j1 = nwin * (t + 1) / T;
        th[t].hash_out = hash_out;
        th[t].pos_out = pos_out;
        pthread_create(&tid[t], 0, mzx_worker, &th[t]);
    }
    for (t = 0; t < T; ++t)
        pthread_join(tid[t], 0);
}

/* ---- threaded stable LSD radix sort by hash -------------------------
 *
 * np.argsort(kind="stable") on a 300M-entry uint32 key costs ~100 s
 * single-threaded plus an int64 index array and three fancy-index
 * copies; 4 stable 8-bit passes with (c, p) payloads are memory-bound
 * (~29 GB of traffic at 3 Gbp) and parallelize over entry ranges.
 * Produces the exact permutation of a stable sort by h (LSD radix is
 * stable), so the NumPy-twin equality tests hold bit-for-bit.  Arrays
 * ping-pong (h,c,p) <-> (h2,c2,p2); after the 4 (even) passes the
 * result is back in (h,c,p). */

typedef struct {
    const uint32_t *h;
    int64_t n0, n1;
    int shift;
    int64_t hist[256];
    int64_t off[256];
    const int32_t *c, *p;
    uint32_t *ho;
    int32_t *co, *po;
} rdx_t;

static void *rdx_count(void *arg)
{
    rdx_t *t = (rdx_t *)arg;
    int64_t i;
    memset(t->hist, 0, sizeof t->hist);
    for (i = t->n0; i < t->n1; ++i)
        t->hist[(t->h[i] >> t->shift) & 0xFF] += 1;
    return 0;
}

static void *rdx_scatter(void *arg)
{
    rdx_t *t = (rdx_t *)arg;
    int64_t i;
    for (i = t->n0; i < t->n1; ++i) {
        int b = (t->h[i] >> t->shift) & 0xFF;
        int64_t d = t->off[b]++;
        t->ho[d] = t->h[i];
        t->co[d] = t->c[i];
        t->po[d] = t->p[i];
    }
    return 0;
}

void mz_radix_sort(uint32_t *h, int32_t *c, int32_t *p, int64_t n,
                   uint32_t *h2, int32_t *c2, int32_t *p2, int nthreads)
{
    enum { MAXT = 32 };
    rdx_t th[MAXT];
    pthread_t tid[MAXT];
    int T = nthreads < 1 ? 1 : (nthreads > MAXT ? MAXT : nthreads);
    if (n < (1 << 16)) T = 1;
    uint32_t *ha = h, *hb = h2;
    int32_t *ca = c, *cb = c2, *pa = p, *pb = p2;
    int pass, t, b;
    for (pass = 0; pass < 4; ++pass) {
        int shift = 8 * pass;
        for (t = 0; t < T; ++t) {
            th[t].h = ha;
            th[t].n0 = n * t / T;
            th[t].n1 = n * (t + 1) / T;
            th[t].shift = shift;
            pthread_create(&tid[t], 0, rdx_count, &th[t]);
        }
        for (t = 0; t < T; ++t)
            pthread_join(tid[t], 0);
        /* stable global offsets: bucket-major, thread-minor */
        int64_t run = 0;
        for (b = 0; b < 256; ++b)
            for (t = 0; t < T; ++t) {
                th[t].off[b] = run;
                run += th[t].hist[b];
            }
        for (t = 0; t < T; ++t) {
            th[t].c = ca;
            th[t].p = pa;
            th[t].ho = hb;
            th[t].co = cb;
            th[t].po = pb;
            pthread_create(&tid[t], 0, rdx_scatter, &th[t]);
        }
        for (t = 0; t < T; ++t)
            pthread_join(tid[t], 0);
        { uint32_t *s = ha; ha = hb; hb = s; }
        { int32_t *s = ca; ca = cb; cb = s; }
        { int32_t *s = pa; pa = pb; pb = s; }
    }
    /* 4 passes: result is back in (h, c, p) */
}

/* Dedup over hash-sorted (h, c, p): keep the first TWO occurrences per
 * unique hash, mark multi-occurrence entries ambiguous via the position
 * sign bit, drop hashes occurring more than repeat_cap times entirely
 * (exact twin of livefish/index.py build_index's NumPy dedup).  Outputs
 * may alias inputs (write index never exceeds read index).  Returns the
 * kept count. */
int64_t mz_dedup(const uint32_t *h, const int32_t *c, const int32_t *p,
                 int64_t n, int64_t repeat_cap,
                 uint32_t *h2, int32_t *c2, int32_t *p2)
{
    int64_t i = 0, m = 0;
    while (i < n) {
        int64_t j = i + 1;
        uint32_t hv = h[i];
        while (j < n && h[j] == hv) ++j;
        int64_t cnt = j - i;
        if (cnt <= repeat_cap) {
            if (cnt == 1) {
                h2[m] = hv; c2[m] = c[i]; p2[m] = p[i]; ++m;
            } else {
                h2[m] = hv; c2[m] = c[i];
                p2[m] = p[i] | (int32_t)0x80000000; ++m;
                h2[m] = hv; c2[m] = c[i + 1];
                p2[m] = p[i + 1] | (int32_t)0x80000000; ++m;
            }
        }
        i = j;
    }
    return m;
}

/* (shard, bucket) histogram: hist[(h & (E-1)) << B | ((h >> log2e) & (2^B-1))]
 * over deduped hashes — used to pick the bucket directory width B without
 * materializing trial tables. */
void mz_bucket_hist(const uint32_t *h, int64_t n, int log2e, int B,
                    int32_t *hist)
{
    uint32_t emask = (1u << log2e) - 1;
    uint32_t bmask = (1u << B) - 1;
    int64_t i;
    for (i = 0; i < n; ++i) {
        uint32_t x = h[i];
        hist[(((uint64_t)(x & emask)) << B) | ((x >> log2e) & bmask)] += 1;
    }
}

typedef struct {
    int32_t *rows;
    int K;                         /* slots per bucket; row = 2K words */
    int64_t n0, n1;
} binit_t;

static void *binit_worker(void *arg)
{
    binit_t *t = (binit_t *)arg;
    const int K = t->K;
    int64_t r;
    int j;
    for (r = t->n0; r < t->n1; ++r) {
        int32_t *row = t->rows + r * 2 * K;
        for (j = 0; j < K / 2; ++j)
            row[j] = 0;                    /* fingerprint halves */
        for (j = K / 2; j < K; ++j)
            row[j] = -1;                   /* uint16 contig slots empty */
        for (j = K; j < 2 * K; ++j)
            row[j] = 0;                    /* positions */
    }
    return 0;
}

/* Sequential-bandwidth btable init (the NumPy strided contig-word = -1
 * over a multi-GB table was a visible fraction of the build).  K = slots
 * per bucket (row layout below); nrows = total buckets across shards. */
void mz_btable_init(int32_t *btable, int64_t nrows, int K, int nthreads)
{
    enum { MAXT = 32 };
    binit_t th[MAXT];
    pthread_t tid[MAXT];
    int T = nthreads < 1 ? 1 : (nthreads > MAXT ? MAXT : nthreads);
    if (nrows < (1 << 16)) T = 1;
    int t;
    for (t = 0; t < T; ++t) {
        th[t].rows = btable;
        th[t].K = K;
        th[t].n0 = nrows * t / T;
        th[t].n1 = nrows * (t + 1) / T;
        pthread_create(&tid[t], 0, binit_worker, &th[t]);
    }
    for (t = 0; t < T; ++t)
        pthread_join(tid[t], 0);
}

/* Single-pass bucket fill: entries arrive in ascending-hash order (the
 * dedup output), so slots within a bucket hold the lowest hashes first
 * and ambiguous first/second occurrences stay adjacent in slot order —
 * the invariants _lookup_votes relies on.  btable rows are 2K int32
 * (4K uint16 halves, little-endian); K = slots per bucket (a power of
 * two <= 16):
 *   halves 0..K-1   = uint16 fingerprints (h >> (log2e + B))
 *   halves K..2K-1  = uint16 contig ids (0xFFFF = empty slot)
 *   words  K..2K-1  = int32 positions (sign bit = ambiguous)
 * The caller pre-fills contig halves with 0xFFFF (mz_btable_init).
 * Returns the number of entries dropped to bucket overflow (> K slots). */
int64_t mz_bucket_fill(const uint32_t *h, const int32_t *c, const int32_t *p,
                       int64_t n, int log2e, int B, int K, int32_t *btable)
{
    uint32_t emask = (1u << log2e) - 1;
    uint32_t bmask = (1u << B) - 1;
    int fp_shift = log2e + B;
    int64_t dropped = 0;
    int64_t i;
    for (i = 0; i < n; ++i) {
        uint32_t x = h[i];
        uint64_t row = ((((uint64_t)(x & emask)) << B)
                        | ((x >> log2e) & bmask));
        uint16_t *r16 = (uint16_t *)(btable + row * 2 * K);
        int s;
        for (s = 0; s < K; ++s)
            if (r16[K + s] == 0xFFFF) break;
        if (s == K) {
            ++dropped;
            continue;
        }
        r16[s] = (uint16_t)(x >> fp_shift);
        r16[K + s] = (uint16_t)c[i];
        ((int32_t *)r16)[K + s] = p[i];
    }
    return dropped;
}

/* ---- two-choice placement (round-5 table shrink) --------------------
 *
 * Every entry has a HOME bucket b1 = (h >> log2e) & (2^B - 1) and an
 * ALTERNATE b2 = b1 ^ g(fp), g(fp) = (fp * 0x9E3779B1) >> (32 - B):
 * greedy two-choice filling (the less-full bucket wins, tie -> home)
 * keeps overflow drops under 0.5% up to ~72% slot occupancy where
 * single-choice needed <=27% — halving the directory bytes at the cost
 * of a second (independent, pipelineable) 32-byte row-gather at lookup.
 * The stored fingerprint carries a placement tag in bit 15
 * (fp | displaced<<15, so fp itself must fit 15 bits: B >= 17 - log2e);
 * tag + bucket + fp still pin the full hash, so lookups stay EXACT:
 * a b2-probe match implies b1(h') = b2(q) ^ g(fp) = b1(q), hence
 * h' == q.
 *
 * Pair rule (the two stored occurrences of an ambiguous hash, adjacent
 * in the input): the second occurrence follows its pair's bucket when
 * free, else tries the other, else is dropped (the lookup falls back to
 * pos2 = pos1).  Because a first occurrence only lands in b2 when b2 was
 * strictly emptier than b1, the second can never land in b1 afterwards —
 * so the probe scan order (b1 slots, then b2 slots) always sees the
 * first occurrence first, preserving the slot-order invariant
 * _lookup_votes relies on. */

static inline uint32_t tc_alt(uint32_t b1, uint32_t fp, int B)
{
    return b1 ^ ((fp * 0x9E3779B1u) >> (32 - B));
}

/* Count-only twin of mz_bucket_fill2: identical placement decisions via
 * per-bucket counters (cnt, caller-zeroed, n_shards << B bytes), so the
 * directory width B can be chosen without materializing trial tables.
 * Returns the dropped count. */
int64_t mz_bucket_count2(const uint32_t *h, int64_t n, int log2e, int B,
                         int K, uint8_t *cnt)
{
    uint32_t emask = (1u << log2e) - 1;
    uint32_t bmask = (1u << B) - 1;
    int fp_shift = log2e + B;
    int64_t dropped = 0;
    int64_t i;
    int64_t prev_row = -1;
    uint32_t prev_h = 0;
    for (i = 0; i < n; ++i) {
        uint32_t x = h[i];
        uint64_t shard = ((uint64_t)(x & emask)) << B;
        uint32_t b1 = (x >> log2e) & bmask;
        uint32_t fp = x >> fp_shift;
        uint32_t b2 = tc_alt(b1, fp, B) & bmask;
        int64_t r1 = shard | b1, r2 = shard | b2;
        int64_t t;
        if (i > 0 && x == prev_h) {
            /* second of an ambiguous pair: follow the first */
            t = (prev_row >= 0 && cnt[prev_row] < K) ? prev_row
                : ((prev_row == r1 ? r2 : r1));
            if (t < 0 || cnt[t] >= K) t = -1;
            if (prev_row < 0) t = -1;
        } else {
            t = (cnt[r1] <= cnt[r2]) ? (cnt[r1] < K ? r1
                                        : (cnt[r2] < K ? r2 : -1))
                : (cnt[r2] < K ? r2 : (cnt[r1] < K ? r1 : -1));
        }
        if (t < 0) {
            ++dropped;
            prev_row = -1;
        } else {
            cnt[t] += 1;
            prev_row = t;
        }
        prev_h = x;
    }
    return dropped;
}

/* Two-choice bucket fill; same decisions as mz_bucket_count2 (shared
 * rule, counters derived from the table itself).  Caller pre-inits the
 * table with mz_btable_init.  Returns the dropped count. */
int64_t mz_bucket_fill2(const uint32_t *h, const int32_t *c,
                        const int32_t *p, int64_t n, int log2e, int B,
                        int K, int32_t *btable)
{
    uint32_t emask = (1u << log2e) - 1;
    uint32_t bmask = (1u << B) - 1;
    int fp_shift = log2e + B;
    int64_t dropped = 0;
    int64_t i;
    int64_t prev_row = -1;
    uint32_t prev_h = 0;
    for (i = 0; i < n; ++i) {
        uint32_t x = h[i];
        uint64_t shard = ((uint64_t)(x & emask)) << B;
        uint32_t b1 = (x >> log2e) & bmask;
        uint32_t fp = x >> fp_shift;
        uint32_t b2 = tc_alt(b1, fp, B) & bmask;
        int64_t r1 = shard | b1, r2 = shard | b2;
        uint16_t *q1 = (uint16_t *)(btable + r1 * 2 * K);
        uint16_t *q2 = (uint16_t *)(btable + r2 * 2 * K);
        int f1 = 0, f2 = 0, s;
        for (s = 0; s < K; ++s) {
            f1 += q1[K + s] == 0xFFFF;
            f2 += q2[K + s] == 0xFFFF;
        }
        int64_t t;
        int free_t;
        if (i > 0 && x == prev_h) {
            t = prev_row;
            free_t = (t == r1) ? f1 : f2;
            if (t < 0 || free_t == 0) {
                t = (prev_row == r1) ? r2 : r1;
                free_t = (t == r1) ? f1 : f2;
                if (prev_row < 0 || free_t == 0) t = -1;
            }
        } else {
            int c1 = K - f1, c2 = K - f2;
            if (c1 <= c2)
                t = f1 ? r1 : (f2 ? r2 : -1);
            else
                t = f2 ? r2 : (f1 ? r1 : -1);
        }
        if (t < 0) {
            ++dropped;
            prev_row = -1;
        } else {
            uint16_t *rt = (uint16_t *)(btable + t * 2 * K);
            for (s = 0; s < K; ++s)
                if (rt[K + s] == 0xFFFF) break;
            rt[s] = (uint16_t)(fp | ((t == r2 && r2 != r1) ? 0x8000u
                                     : 0u));
            rt[K + s] = (uint16_t)c[i];
            ((int32_t *)rt)[K + s] = p[i];
            prev_row = t;
        }
        prev_h = x;
    }
    return dropped;
}
