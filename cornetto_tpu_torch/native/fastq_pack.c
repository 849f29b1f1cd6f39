/* Native FASTQ -> packed-2-bit batch parser for the livefish streaming
 * pipeline.
 *
 * The decision engine consumes (B, ceil(L/4)) uint8 2-bit codes + per-read
 * lengths; producing those in Python (read_fastx + encode_seq + pack_reads)
 * tops out at ~90k reads/s — a quarter of the single-chip decide rate, so
 * the HOST becomes the end-to-end bottleneck.  This kernel does
 * parse+encode+pack in one pass over the raw text.  It is the moral
 * successor of the reference's kseq.h FASTQ reader (reference: src/kseq.h,
 * vendored ~3x) feeding its batch work pool (reference: src/thread.c:48-96),
 * fused with the 2-bit encoding the reference never needed.
 *
 * Strict single-line-FASTQ subset (what basecallers emit): any anomaly
 * (multi-line records, FASTA, '@'-less lines) returns -1 and the caller
 * falls back to the tolerant Python parser.  ctypes releases the GIL for
 * the call, so the Prefetcher thread's parse overlaps device compute.
 */

#include <stdint.h>
#include <string.h>

static unsigned char CODE[256];
static int code_init = 0;

static void init_code(void) {
    if (code_init) return;
    memset(CODE, 4, 256);
    CODE['A'] = 0; CODE['C'] = 1; CODE['G'] = 2; CODE['T'] = 3;
    CODE['a'] = 0; CODE['c'] = 1; CODE['g'] = 2; CODE['t'] = 3;
    code_init = 1;
}

/* Parse up to maxB records from buf[0..n).  Rows of `packed` are
 * stride bytes (= ceil(L/4)); rows of `nmask` are nstride (= ceil(L/8)).
 * lengths[i] = packed bases of read i (<= L).  name_off/name_len locate
 * each read id inside buf.  eof!=0 allows the final qual line to lack a
 * trailing newline.  *has_n is set when any read has a non-ACGT base
 * inside its packed length.  Returns bytes consumed (complete records
 * only), or -1 on malformed input. */
long fq_pack_batch(const char *buf, long n, int L, int maxB,
                   unsigned char *packed, int stride,
                   unsigned char *nmask, int nstride,
                   int *lengths, long *name_off, int *name_len,
                   int *out_count, int *has_n, int eof)
{
    init_code();
    long p = 0;
    int b = 0;
    int any_n = 0;
    while (b < maxB && p < n) {
        long rec0 = p;
        if (buf[p] != '@') return -1;
        const char *nl = memchr(buf + p, '\n', n - p);
        if (!nl) break;                       /* incomplete header */
        long he = nl - buf;
        long name0 = p + 1, ne = name0;
        while (ne < he && buf[ne] != ' ' && buf[ne] != '\t'
               && buf[ne] != '\r') ne++;
        long s0 = he + 1;
        nl = memchr(buf + s0, '\n', n - s0);
        if (!nl) break;                       /* incomplete seq line */
        long se = nl - buf;
        long slen = se - s0;
        if (slen > 0 && buf[se - 1] == '\r') slen--;
        long plus0 = se + 1;
        if (plus0 >= n) break;
        if (buf[plus0] != '+') return -1;     /* multi-line seq / FASTA */
        nl = memchr(buf + plus0, '\n', n - plus0);
        if (!nl) break;
        long q0 = (nl - buf) + 1;
        long qe;
        nl = memchr(buf + q0, '\n', n - q0);
        if (!nl) {
            if (!eof) break;                  /* incomplete qual line */
            qe = n;
        } else {
            qe = nl - buf;
        }
        long qlen = qe - q0;
        if (qlen > 0 && buf[qe - 1] == '\r') qlen--;
        if (qlen != slen) {
            if (!nl) break;                   /* qual possibly truncated */
            return -1;
        }
        /* complete record: encode + pack the first L bases */
        int take = slen < L ? (int)slen : L;
        unsigned char *row = packed + (long)b * stride;
        unsigned char *nrow = nmask + (long)b * nstride;
        memset(row, 0, stride);
        memset(nrow, 0, nstride);
        const unsigned char *s = (const unsigned char *)buf + s0;
        int j = 0;
        for (; j + 4 <= take; j += 4) {
            unsigned c0 = CODE[s[j]], c1 = CODE[s[j + 1]];
            unsigned c2 = CODE[s[j + 2]], c3 = CODE[s[j + 3]];
            unsigned nb = (c0 | c1 | c2 | c3) >> 2;  /* any code==4? */
            if (nb) {
                if (c0 > 3) { nrow[j >> 3] |= 1 << (j & 7); c0 = 0; }
                if (c1 > 3) { nrow[(j + 1) >> 3] |= 1 << ((j + 1) & 7); c1 = 0; }
                if (c2 > 3) { nrow[(j + 2) >> 3] |= 1 << ((j + 2) & 7); c2 = 0; }
                if (c3 > 3) { nrow[(j + 3) >> 3] |= 1 << ((j + 3) & 7); c3 = 0; }
                any_n = 1;
            }
            row[j >> 2] = (unsigned char)(c0 | (c1 << 2) | (c2 << 4)
                                          | (c3 << 6));
        }
        for (; j < take; j++) {
            unsigned c = CODE[s[j]];
            if (c > 3) { nrow[j >> 3] |= 1 << (j & 7); c = 0; any_n = 1; }
            row[j >> 2] |= (unsigned char)(c << ((j & 3) * 2));
        }
        lengths[b] = take;
        name_off[b] = name0;
        name_len[b] = (int)(ne - name0);
        b++;
        p = nl ? (nl - buf) + 1 : n;
        (void)rec0;
    }
    *out_count = b;
    *has_n = any_n;
    return p;
}
