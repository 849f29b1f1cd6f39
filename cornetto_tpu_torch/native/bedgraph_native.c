/* Fast 4-column bedgraph parser (chrom\tstart\tend\tdepth rows) for the
 * whole-genome depth load path — replaces the reference's fscanf loop
 * (reference: src/boringbits_main.c:204-287).  Multi-threaded: the byte
 * range is split at newline boundaries, chunks are counted and parsed in
 * parallel (the moral successor of the reference's batch work pool,
 * src/thread.c), and per-chunk contig tables are stitched serially.
 *
 * Build: cc -O3 -shared -fPIC -pthread bedgraph_native.c -o _bedgraph_native.so
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    const char *data;
    int64_t begin, end;        /* byte range, begin at a row start */
    int64_t row0;              /* global row index of first row    */
    int64_t nrows;             /* rows in this chunk (phase 1 out) */
    int64_t *starts, *ends, *depths;
    int64_t *ctg_row, *ctg_off, *ctg_len;  /* thread-local slices  */
    int64_t n_ctg;
    int64_t err;               /* 0 ok, else -(local_row+1)        */
} chunk_t;

static void *count_worker(void *arg)
{
    chunk_t *c = (chunk_t *)arg;
    const char *p = c->data + c->begin, *endp = c->data + c->end;
    int64_t n = 0;
    while (p < endp) {
        const char *nl = (const char *)memchr(p, '\n', endp - p);
        ++n;
        if (!nl) break;
        p = nl + 1;
    }
    c->nrows = n;
    return 0;
}

typedef struct {
    const char *p, *end;
    int64_t n;
} nlc_t;

static void *nl_worker(void *arg)
{
    nlc_t *c = (nlc_t *)arg;
    const char *p = c->p, *end = c->end;
    int64_t n = 0;
    const char *nl;
    while (p < end && (nl = (const char *)memchr(p, '\n', end - p))) {
        ++n;
        p = nl + 1;
    }
    c->n = n;
    return 0;
}

/* Parallel newline count (glibc memchr is SIMD): the Python side's
 * per-window row count was the load-path bottleneck (np.count_nonzero
 * over a == comparison materializes a bool array at ~140 MB/s; this
 * runs at memory bandwidth).  Split points need not be row-aligned —
 * only '\n' bytes are counted. */
int64_t bg_count_nl(const char *data, int64_t len, int nthreads)
{
    enum { MAXT = 32 };
    nlc_t ch[MAXT];
    pthread_t th[MAXT];
    int T = nthreads < 1 ? 1 : (nthreads > MAXT ? MAXT : nthreads);
    if (len < (1 << 16)) T = 1;
    int t;
    int64_t total = 0;
    for (t = 0; t < T; ++t) {
        ch[t].p = data + len * t / T;
        ch[t].end = data + len * (t + 1) / T;
        pthread_create(&th[t], 0, nl_worker, &ch[t]);
    }
    for (t = 0; t < T; ++t) {
        pthread_join(th[t], 0);
        total += ch[t].n;
    }
    return total;
}

static void *parse_worker(void *arg)
{
    chunk_t *c = (chunk_t *)arg;
    const char *data = c->data;
    int64_t i = c->begin, len = c->end;
    int64_t row = c->row0, n_ctg = 0;
    const char *prev_name = 0;
    int64_t prev_len = -1;
    while (i < len) {
        const char *name = data + i;
        int64_t nlen;
        int64_t j = i;
        /* fast path: same chrom as previous row */
        if (prev_len > 0 && i + prev_len < len
            && data[i + prev_len] == '\t'
            && memcmp(name, prev_name, prev_len) == 0) {
            nlen = prev_len;
            j = i + prev_len;
        } else {
            while (j < len && data[j] != '\t' && data[j] != '\n') ++j;
            if (j >= len || data[j] != '\t') { c->err = -(row + 1); return 0; }
            nlen = j - i;
        }
        ++j;
        int64_t v, k, field_start;
        for (k = 0; k < 3; ++k) {
            field_start = j;
            v = 0;
            while (j < len && (unsigned)(data[j] - '0') < 10u)
                v = v * 10 + (data[j++] - '0');
            if (j == field_start) { c->err = -(row + 1); return 0; }
            if (k < 2) {
                if (j >= len || data[j] != '\t') {
                    c->err = -(row + 1); return 0;
                }
                ++j;
            }
            if (k == 0) c->starts[row - c->row0] = v;
            else if (k == 1) c->ends[row - c->row0] = v;
            else c->depths[row - c->row0] = v;
        }
        if (j < len && data[j] == '\r') ++j;
        if (j < len) {
            if (data[j] != '\n') { c->err = -(row + 1); return 0; }
            ++j;
        }
        if (prev_len != nlen || memcmp(prev_name, name, nlen) != 0) {
            c->ctg_row[n_ctg] = row;
            c->ctg_off[n_ctg] = name - data;
            c->ctg_len[n_ctg] = nlen;
            ++n_ctg;
            prev_name = name;
            prev_len = nlen;
        }
        ++row;
        i = j;
    }
    c->n_ctg = n_ctg;
    return 0;
}

int64_t bg_parse(const char *data, int64_t len, int nthreads,
                 int64_t *starts, int64_t *ends, int64_t *depths,
                 int64_t *ctg_row, int64_t *ctg_off, int64_t *ctg_len,
                 int64_t *n_ctg_out)
{
    enum { MAXT = 32 };
    chunk_t ch[MAXT];
    pthread_t th[MAXT];
    int T = nthreads < 1 ? 1 : (nthreads > MAXT ? MAXT : nthreads);
    int t;
    if (len == 0) { *n_ctg_out = 0; return 0; }

    /* chunk boundaries aligned to row starts */
    int64_t pos = 0;
    for (t = 0; t < T; ++t) {
        ch[t].data = data;
        ch[t].begin = pos;
        int64_t want = len * (t + 1) / T;
        if (want < pos) want = pos;
        if (t == T - 1 || want >= len) {
            pos = len;
        } else {
            const char *nl = (const char *)memchr(data + want, '\n',
                                                  len - want);
            pos = nl ? (nl - data) + 1 : len;
        }
        ch[t].end = pos;
        ch[t].err = 0;
    }

    /* phase 1: count rows per chunk */
    for (t = 0; t < T; ++t)
        pthread_create(&th[t], 0, count_worker, &ch[t]);
    for (t = 0; t < T; ++t)
        pthread_join(th[t], 0);

    int64_t total = 0;
    for (t = 0; t < T; ++t) {
        ch[t].row0 = total;
        total += ch[t].nrows;
        ch[t].starts = starts + ch[t].row0;
        ch[t].ends = ends + ch[t].row0;
        ch[t].depths = depths + ch[t].row0;
        ch[t].ctg_row = ctg_row + ch[t].row0;
        ch[t].ctg_off = ctg_off + ch[t].row0;
        ch[t].ctg_len = ctg_len + ch[t].row0;
    }

    /* phase 2: parse chunks in parallel */
    for (t = 0; t < T; ++t)
        pthread_create(&th[t], 0, parse_worker, &ch[t]);
    for (t = 0; t < T; ++t)
        pthread_join(th[t], 0);
    for (t = 0; t < T; ++t)
        if (ch[t].err) return ch[t].err;

    /* stitch contig tables: drop a chunk's first entry when its name
     * continues the previous chunk's last contig */
    int64_t n_ctg = 0;
    const char *last_name = 0;
    int64_t last_len = -1;
    for (t = 0; t < T; ++t) {
        int64_t k0 = 0;
        if (ch[t].n_ctg > 0 && last_len >= 0
            && ch[t].ctg_len[0] == last_len
            && memcmp(data + ch[t].ctg_off[0], last_name, last_len) == 0)
            k0 = 1;
        int64_t k;
        for (k = k0; k < ch[t].n_ctg; ++k) {
            ctg_row[n_ctg] = ch[t].ctg_row[k];
            ctg_off[n_ctg] = ch[t].ctg_off[k];
            ctg_len[n_ctg] = ch[t].ctg_len[k];
            ++n_ctg;
        }
        if (ch[t].n_ctg > 0) {
            last_name = data + ch[t].ctg_off[ch[t].n_ctg - 1];
            last_len = ch[t].ctg_len[ch[t].n_ctg - 1];
        }
    }
    *n_ctg_out = n_ctg;
    return total;
}

/* ------------------------------------------------------------------ *
 * bg_fill: streaming whole-genome loader.  Unlike bg_parse (which
 * materializes int64 start/end/depth arrays — 24 B/row, ~72 GB for a
 * 3 Gbp 1-bp track), this validates rows on the fly and writes the
 * clamped uint16 depth directly: peak memory = 2 B/row + the mmap'd
 * file, matching the reference's streaming fscanf loop
 * (src/boringbits_main.c:204-287) at multi-threaded speed.
 * Validation (reference semantics): 4 columns; end == start+1;
 * per-contig starts incremental by 1.  Depths > 65535 clamp with the
 * row recorded for the caller's warning (up to tr_cap examples).
 * ------------------------------------------------------------------ */

typedef struct {
    const char *data;
    int64_t begin, end, row0, nrows;
    uint16_t *depth;                       /* global row-indexed buffer */
    int64_t *ctg_row, *ctg_off, *ctg_len, *ctg_first;  /* local slices */
    int64_t n_ctg;
    int64_t first_start, last_start;       /* chunk boundary stitching */
    int64_t sum;                           /* clamped depth sum */
    int64_t *tr_row, *tr_val, tr_cap, tr_n, tr_total;
    int64_t err_row, err_a, err_b, err_kind;   /* err_row<0: no error */
} fchunk_t;

static void *fill_worker(void *arg)
{
    fchunk_t *c = (fchunk_t *)arg;
    const char *data = c->data;
    int64_t i = c->begin, len = c->end;
    int64_t row = c->row0, n_ctg = 0;
    const char *prev_name = 0;
    int64_t prev_len = -1, prev_start = 0;
    c->err_row = -1;
    c->sum = 0;
    c->tr_n = 0;
    c->tr_total = 0;
    c->first_start = -1;
    while (i < len) {
        const char *name = data + i;
        int64_t nlen;
        int64_t j = i;
        if (prev_len > 0 && i + prev_len < len
            && data[i + prev_len] == '\t'
            && memcmp(name, prev_name, prev_len) == 0) {
            nlen = prev_len;
            j = i + prev_len;
        } else {
            while (j < len && data[j] != '\t' && data[j] != '\n') ++j;
            if (j >= len || data[j] != '\t') {
                c->err_row = row; c->err_kind = 0; return 0;
            }
            nlen = j - i;
        }
        ++j;
        int64_t start = 0, endv = 0, dep = 0, v, k, field_start;
        for (k = 0; k < 3; ++k) {
            field_start = j;
            v = 0;
            while (j < len && (unsigned)(data[j] - '0') < 10u)
                v = v * 10 + (data[j++] - '0');
            if (j == field_start) {
                c->err_row = row; c->err_kind = 0; return 0;
            }
            if (k < 2) {
                if (j >= len || data[j] != '\t') {
                    c->err_row = row; c->err_kind = 0; return 0;
                }
                ++j;
            }
            if (k == 0) start = v;
            else if (k == 1) endv = v;
            else dep = v;
        }
        if (j < len && data[j] == '\r') ++j;
        if (j < len) {
            if (data[j] != '\n') {
                c->err_row = row; c->err_kind = 0; return 0;
            }
            ++j;
        }
        if (endv != start + 1) {
            c->err_row = row; c->err_kind = 1;
            c->err_a = start; c->err_b = endv;
            return 0;
        }
        int same = (prev_len == nlen
                    && memcmp(prev_name, name, nlen) == 0);
        if (same) {
            if (start != prev_start + 1) {
                c->err_row = row; c->err_kind = 2;
                c->err_a = prev_start; c->err_b = start;
                return 0;
            }
        } else {
            c->ctg_row[n_ctg] = row;
            c->ctg_off[n_ctg] = name - data;
            c->ctg_len[n_ctg] = nlen;
            c->ctg_first[n_ctg] = start;
            ++n_ctg;
            prev_name = name;
            prev_len = nlen;
        }
        if (c->first_start < 0) c->first_start = start;
        prev_start = start;
        if (dep > 65535) {
            if (c->tr_n < c->tr_cap) {
                c->tr_row[c->tr_n] = row;
                c->tr_val[c->tr_n] = dep;
                ++c->tr_n;
            }
            ++c->tr_total;
            dep = 65535;
        }
        c->depth[row] = (uint16_t)dep;
        c->sum += dep;
        ++row;
        i = j;
    }
    c->n_ctg = n_ctg;
    c->last_start = prev_start;
    return 0;
}

/* Returns total rows (>= 0), or -1 on validation error with
 * err_out = {row, kind, a, b} (kind 0: columns, 1: end!=start+1,
 * 2: not incremental).  n_ctg_io: in = capacity, out = count (returns
 * -2 if capacity exceeded).  tr_*: caller buffers of tr_cap entries;
 * n_tr_out = {examples recorded, total truncations}. */
int64_t bg_fill(const char *data, int64_t len, int nthreads,
                uint16_t *depth,
                int64_t *ctg_row, int64_t *ctg_off, int64_t *ctg_len,
                int64_t *ctg_first, int64_t *n_ctg_io,
                int64_t *sum_out,
                int64_t *tr_row, int64_t *tr_val, int64_t tr_cap,
                int64_t *n_tr_out, int64_t *err_out)
{
    enum { MAXT = 32 };
    fchunk_t ch[MAXT];
    chunk_t cnt[MAXT];
    pthread_t th[MAXT];
    int T = nthreads < 1 ? 1 : (nthreads > MAXT ? MAXT : nthreads);
    int t;
    int64_t cap = *n_ctg_io;
    *n_ctg_io = 0;
    *sum_out = 0;
    n_tr_out[0] = n_tr_out[1] = 0;
    err_out[0] = -1;
    if (len == 0) return 0;

    int64_t pos = 0;
    for (t = 0; t < T; ++t) {
        cnt[t].data = data;
        cnt[t].begin = pos;
        int64_t want = len * (t + 1) / T;
        if (want < pos) want = pos;
        if (t == T - 1 || want >= len) {
            pos = len;
        } else {
            const char *nl = (const char *)memchr(data + want, '\n',
                                                  len - want);
            pos = nl ? (nl - data) + 1 : len;
        }
        cnt[t].end = pos;
    }
    for (t = 0; t < T; ++t)
        pthread_create(&th[t], 0, count_worker, &cnt[t]);
    for (t = 0; t < T; ++t)
        pthread_join(th[t], 0);

    int64_t total = 0;
    for (t = 0; t < T; ++t) {
        ch[t].data = data;
        ch[t].begin = cnt[t].begin;
        ch[t].end = cnt[t].end;
        ch[t].row0 = total;
        total += cnt[t].nrows;
        ch[t].nrows = cnt[t].nrows;
        ch[t].depth = depth;
    }
    /* per-chunk slices of the caller's contig/truncation buffers: contig
     * runs are bounded by rows, so slicing by row ranges is safe as long
     * as cap >= total rows is not required — we bound by cap/T each and
     * re-check during the stitch */
    int64_t tr_per = tr_cap / T;
    int64_t ctg_per = cap / T;
    for (t = 0; t < T; ++t) {
        ch[t].ctg_row = ctg_row + t * ctg_per;
        ch[t].ctg_off = ctg_off + t * ctg_per;
        ch[t].ctg_len = ctg_len + t * ctg_per;
        ch[t].ctg_first = ctg_first + t * ctg_per;
        ch[t].tr_row = tr_row + t * tr_per;
        ch[t].tr_val = tr_val + t * tr_per;
        ch[t].tr_cap = tr_per;
        ch[t].n_ctg = 0;
    }
    for (t = 0; t < T; ++t)
        pthread_create(&th[t], 0, fill_worker, &ch[t]);
    for (t = 0; t < T; ++t)
        pthread_join(th[t], 0);

    /* earliest error wins (streaming order) */
    for (t = 0; t < T; ++t) {
        if (ch[t].err_row >= 0
            && (err_out[0] < 0 || ch[t].err_row < err_out[0])) {
            err_out[0] = ch[t].err_row;
            err_out[1] = ch[t].err_kind;
            err_out[2] = ch[t].err_a;
            err_out[3] = ch[t].err_b;
        }
        if (ch[t].n_ctg > ctg_per) return -2;
    }
    if (err_out[0] >= 0) return -1;

    /* stitch contig runs + boundary incremental checks; compact the
     * per-chunk tables into the head of the caller buffers.  Copy to
     * temporaries first row-by-row is safe because destination index
     * never exceeds source position (t*ctg_per >= n_ctg so far). */
    int64_t n_ctg = 0;
    const char *last_name = 0;
    int64_t last_len = -1, last_start = 0;
    for (t = 0; t < T; ++t) {
        if (ch[t].nrows == 0) continue;
        int64_t k0 = 0;
        if (ch[t].n_ctg > 0 && last_len >= 0
            && ch[t].ctg_len[0] == last_len
            && ch[t].ctg_row[0] == ch[t].row0
            && memcmp(data + ch[t].ctg_off[0], last_name, last_len) == 0) {
            /* chunk starts inside the previous chunk's contig */
            if (ch[t].first_start != last_start + 1) {
                err_out[0] = ch[t].row0;
                err_out[1] = 2;
                err_out[2] = last_start;
                err_out[3] = ch[t].first_start;
                return -1;
            }
            k0 = 1;
        } else if (ch[t].n_ctg == 0 && last_len >= 0) {
            /* whole chunk continues previous contig (no runs recorded
             * means first row matched prev_name? cannot happen: a fresh
             * worker always records its first row as a run) */
        }
        int64_t k;
        for (k = k0; k < ch[t].n_ctg; ++k) {
            if (n_ctg >= cap) return -2;
            ctg_row[n_ctg] = ch[t].ctg_row[k];
            ctg_off[n_ctg] = ch[t].ctg_off[k];
            ctg_len[n_ctg] = ch[t].ctg_len[k];
            ctg_first[n_ctg] = ch[t].ctg_first[k];
            ++n_ctg;
        }
        if (ch[t].n_ctg > 0) {
            last_name = data + ch[t].ctg_off[ch[t].n_ctg - 1];
            last_len = ch[t].ctg_len[ch[t].n_ctg - 1];
        }
        last_start = ch[t].last_start;
        *sum_out += ch[t].sum;
        /* merge truncation examples in row order (chunks are ordered) */
        int64_t m;
        for (m = 0; m < ch[t].tr_n && n_tr_out[0] < tr_cap; ++m) {
            tr_row[n_tr_out[0]] = ch[t].tr_row[m];
            tr_val[n_tr_out[0]] = ch[t].tr_val[m];
            ++n_tr_out[0];
        }
        n_tr_out[1] += ch[t].tr_total;
    }
    *n_ctg_io = n_ctg;
    return total;
}
