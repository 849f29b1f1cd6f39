/* Native depth-row writer: the output half of the coverage-track stage.
 *
 * The reference generates per-base coverage tracks with
 * `samtools depth -aa | awk` (reference: shitflow/create-launch.pbs.sh:66-67)
 * — C-speed row emission.  Our depth tool's Python `"%s\t%d\t%d\t%d" % ...`
 * formatting runs ~0.5 us/row, i.e. ~25 min just to print a 3.1 Gbp
 * genome; this writer does it at buffer-fill speed.
 *
 * Modes:
 *   0  per-base bedgraph rows   name\t i \t i+1 \t v      (awk-converted)
 *   1  samtools-depth rows      name\t i+1 \t v           (1-based pos)
 *   2  run-length bedgraph      name\t st \t end \t v     (equal-v merged)
 * Positions are offset by start0 (ranged -b output).  Returns rows
 * written, or -1 on IO error.
 */

#include <stdint.h>
#include <stdio.h>
#include <string.h>

#define BUF_CAP (1 << 20)

static inline char *put_u64(char *p, uint64_t v) {
    char tmp[24];
    int i = 0;
    do { tmp[i++] = (char)('0' + v % 10); v /= 10; } while (v);
    while (i) *p++ = tmp[--i];
    return p;
}

static inline char *put_i64(char *p, int64_t v) {
    if (v < 0) { *p++ = '-'; return put_u64(p, (uint64_t)(-v)); }
    return put_u64(p, (uint64_t)v);
}

long depth_write(const char *path, int append, const char *name,
                 const int64_t *depth, long n, long start0, int mode)
{
    FILE *f = fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    char buf[BUF_CAP];   /* 1 MB stack buffer: re-entrant */
    size_t len = 0;
    size_t name_len = strlen(name);
    long rows = 0;
    long i = 0;
    while (i < n) {
        long j = i + 1;
        int64_t v = depth[i];
        if (mode == 2)
            while (j < n && depth[j] == v) j++;
        if (len + name_len + 80 > BUF_CAP) {
            if (fwrite(buf, 1, len, f) != len) { fclose(f); return -1; }
            len = 0;
        }
        char *p = buf + len;
        memcpy(p, name, name_len); p += name_len;
        *p++ = '\t';
        if (mode == 1) {
            p = put_i64(p, start0 + i + 1);
        } else {
            p = put_i64(p, start0 + i);
            *p++ = '\t';
            p = put_i64(p, start0 + (mode == 2 ? j : i + 1));
        }
        *p++ = '\t';
        p = put_i64(p, v);
        *p++ = '\n';
        len = (size_t)(p - buf);
        rows++;
        i = (mode == 2) ? j : i + 1;
    }
    if (len && fwrite(buf, 1, len, f) != len) { fclose(f); return -1; }
    if (fclose(f) != 0) return -1;
    return rows;
}
