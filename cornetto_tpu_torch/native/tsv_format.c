/* Native decision-TSV formatter for the livefish streaming path.
 *
 * The Python writer thread formats ~200k rows/s holding the GIL, which
 * starves the dispatch/prefetch threads and caps end-to-end streaming
 * (BENCH_KERNELS.json e2e_stream_decisions).  This kernel formats a whole
 * batch into one buffer in a single pass; ctypes releases the GIL for the
 * call's duration.
 *
 * Row format (must stay byte-identical to stream.py's Python fallback):
 *   <id>\t<proceed|unblock>\t<ctg-or-.>\t<est>\t<nhits>\n
 * where ctg is names[best] when nhits > 0 else "." (or the decimal best
 * index when no name table is given).
 *
 * Role in the reference: the readfish decision log the protocol tails
 * (reference: docs/protocol.md:137-161); the reference C itself streams
 * rows with fprintf (e.g. src/boringbits_main.c print loops).
 */
#include <stdint.h>
#include <string.h>

/* unsigned itoa into p, returns chars written (no terminator) */
static int u32s(char *p, uint32_t v) {
    char tmp[10];
    int n = 0;
    do { tmp[n++] = (char)('0' + v % 10u); v /= 10u; } while (v);
    for (int i = 0; i < n; i++) p[i] = tmp[n - 1 - i];
    return n;
}

static int i32s(char *p, int32_t v) {
    if (v < 0) { *p = '-'; return 1 + u32s(p + 1, (uint32_t)(-(int64_t)v)); }
    return u32s(p, (uint32_t)v);
}

/* Format `count` rows.  Returns bytes written, or -1 if `cap` would be
 * exceeded (caller re-allocates; it sizes generously so this is cold).
 * names may be NULL -> decimal best index.  Returns accepted-count via
 * *accepted (sum of dec). */
long tsv_format(const char *idb, const int64_t *id_off, const int32_t *id_len,
                const int32_t *dec, const int32_t *best, const int32_t *est,
                const int32_t *nhits,
                const char *nameb, const int64_t *name_off,
                const int32_t *name_len, int32_t n_names,
                int32_t count, char *out, long cap, int64_t *accepted) {
    char *p = out, *end = out + cap;
    int64_t acc = 0;
    for (int32_t i = 0; i < count; i++) {
        /* worst case: id + 1 + 7 + 1 + name/11 + 1 + 11 + 1 + 11 + 1 */
        long idl = id_len[i];
        long nml = 11;
        int32_t b = best[i];
        const char *nm = 0;
        if (nhits[i] > 0 && nameb && b >= 0 && b < n_names) {
            nm = nameb + name_off[b];
            nml = name_len[b];
        }
        if (p + idl + nml + 45 > end) return -1;
        memcpy(p, idb + id_off[i], (size_t)idl); p += idl;
        *p++ = '\t';
        if (dec[i]) { memcpy(p, "proceed", 7); p += 7; acc++; }
        else        { memcpy(p, "unblock", 7); p += 7; }
        *p++ = '\t';
        if (nhits[i] > 0) {
            if (nm) { memcpy(p, nm, (size_t)nml); p += nml; }
            else    { p += i32s(p, b); }
        } else {
            *p++ = '.';
        }
        *p++ = '\t';
        p += i32s(p, est[i]);
        *p++ = '\t';
        p += i32s(p, nhits[i]);
        *p++ = '\n';
    }
    if (accepted) *accepted = acc;
    return (long)(p - out);
}

/* Copy the read ids scattered through a parse chunk into one compact blob
 * (so a PackedBatch does not pin the multi-MB chunk buffer alive) and
 * rewrite the offsets to be blob-relative.  Returns bytes written or -1
 * if cap is too small. */
long compact_ids(const char *buf, const int64_t *off, const int32_t *len,
                 int32_t count, char *out, long cap, int64_t *out_off) {
    char *p = out, *end = out + cap;
    for (int32_t i = 0; i < count; i++) {
        if (p + len[i] > end) return -1;
        out_off[i] = (int64_t)(p - out);
        memcpy(p, buf + off[i], (size_t)len[i]);
        p += len[i];
    }
    return (long)(p - out);
}
