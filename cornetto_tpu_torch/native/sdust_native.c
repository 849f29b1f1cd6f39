/* Native symmetric-DUST (SDUST, Morgulis et al. 2006) low-complexity
 * masker for the host tool path.
 *
 * ATTRIBUTION: this is a derived port of lh3/sdust (MIT license) as
 * vendored in the reference toolkit (reference: src/sdust/sdust.c:66-160).
 * The control flow, state variables (rv/rw/L/cv/cw, max/new r/l) and the
 * perfect-interval bookkeeping deliberately mirror that code because the
 * byte-exact golden outputs depend on its precise eviction/insertion
 * order; only the containers differ (flat ring buffer + fixed tables
 * instead of kdq/kvec, no arena allocator).  It is NOT an independent
 * re-derivation.  Exposed via ctypes.
 *
 * Build: cc -O3 -shared -fPIC sdust_native.c -o _sdust_native.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define WLEN 3
#define WTOT 64
#define WMSK 63

typedef struct { int start, finish, r, l; } pintv_t;

typedef struct {
    int *ring;        /* triplet ring buffer, power-of-2 capacity      */
    int ring_mask, ring_head, ring_n;
    pintv_t *P;       /* perfect intervals, desc start / asc finish    */
    int P_n, P_cap;
    int64_t *res;     /* packed (start<<32)|finish                     */
    int64_t res_n, res_cap;
} sd_state_t;

/* power-of-2 ring indexing: a modulo here costs ~2.4x end-to-end on
 * dense (satellite) input where find_perfect walks the ring per base */
static inline int ring_at(const sd_state_t *S, int i)
{
    return S->ring[(S->ring_head + i) & S->ring_mask];
}

static void res_push(sd_state_t *S, int64_t v)
{
    if (S->res_n == S->res_cap) {
        S->res_cap = S->res_cap ? S->res_cap * 2 : 64;
        S->res = (int64_t *)realloc(S->res, S->res_cap * sizeof(int64_t));
    }
    S->res[S->res_n++] = v;
}

static void save_masked(sd_state_t *S, int start)
{
    int i;
    pintv_t *p;
    if (S->P_n == 0 || S->P[S->P_n - 1].start >= start) return;
    p = &S->P[S->P_n - 1];
    if (S->res_n) {
        int s = (int)(S->res[S->res_n - 1] >> 32);
        int f = (int)(uint32_t)S->res[S->res_n - 1];
        if (p->start <= f) {
            int nf = f > p->finish ? f : p->finish;
            S->res[S->res_n - 1] = ((int64_t)s << 32) | (uint32_t)nf;
            goto trim;
        }
    }
    res_push(S, ((int64_t)p->start << 32) | (uint32_t)p->finish);
trim:
    for (i = S->P_n - 1; i >= 0 && S->P[i].start < start; --i);
    S->P_n = i + 1;
}

static void shift_win(sd_state_t *S, int t, int T, int W,
                      int *L, int *rw, int *rv, int *cw, int *cv)
{
    int s;
    if (S->ring_n >= W - WLEN + 1) {
        s = S->ring[S->ring_head];
        S->ring_head = (S->ring_head + 1) & S->ring_mask;
        S->ring_n--;
        *rw -= --cw[s];
        if (*L > S->ring_n) { --*L; *rv -= --cv[s]; }
    }
    S->ring[(S->ring_head + S->ring_n) & S->ring_mask] = t;
    S->ring_n++;
    ++*L;
    *rw += cw[t]++;
    *rv += cv[t]++;
    if (cv[t] * 10 > (T << 1)) {
        do {
            s = ring_at(S, S->ring_n - *L);
            *rv -= --cv[s];
            --*L;
        } while (s != t);
    }
}

static void find_perfect(sd_state_t *S, int T, int start, int L, int rv,
                         const int *cv)
{
    int c[WTOT], r = rv, i, max_r = 0, max_l = 0;
    memcpy(c, cv, sizeof(c));
    /* int (not int64) score cross-multiplies, as in the reference
     * (src/sdust/sdust.c:113-118): r <= W(W-1)/2 and l < W keep the
     * products far below overflow for any sane window, and the narrower
     * multiply is measurably faster in this per-base loop */
    const int *ring = S->ring, mask = S->ring_mask, head = S->ring_head;
    for (i = S->ring_n - L - 1; i >= 0; --i) {
        int j, t = ring[(head + i) & mask], new_r, new_l;
        r += c[t]++;
        new_r = r;
        new_l = S->ring_n - i - 1;
        if (new_r * 10 > T * new_l) {
            for (j = 0; j < S->P_n && S->P[j].start >= i + start; ++j) {
                pintv_t *p = &S->P[j];
                if (max_r == 0 || p->r * max_l > max_r * p->l)
                    max_r = p->r, max_l = p->l;
            }
            if (max_r == 0 || new_r * max_l >= max_r * new_l) {
                max_r = new_r, max_l = new_l;
                if (S->P_n == S->P_cap) {
                    S->P_cap = S->P_cap ? S->P_cap * 2 : 64;
                    S->P = (pintv_t *)realloc(S->P,
                                              S->P_cap * sizeof(pintv_t));
                }
                memmove(&S->P[j + 1], &S->P[j],
                        (S->P_n - j) * sizeof(pintv_t));
                S->P_n++;
                S->P[j].start = i + start;
                S->P[j].finish = S->ring_n + (WLEN - 1) + start;
                S->P[j].r = new_r;
                S->P[j].l = new_l;
            }
        }
    }
}

static const unsigned char NT4[256] = {
    /* A=0 C=1 G=2 T=3, else 4; upper+lower case */
    [0 ... 255] = 4,
    ['A'] = 0, ['C'] = 1, ['G'] = 2, ['T'] = 3,
    ['a'] = 0, ['c'] = 1, ['g'] = 2, ['t'] = 3,
};

/* Returns number of intervals written to out (cap out_cap);
 * negative if out_cap exceeded (call again with bigger buffer). */
int64_t sdust_mask(const unsigned char *seq, int64_t l_seq, int T, int W,
                   int64_t *out, int64_t out_cap)
{
    sd_state_t S;
    int cv[WTOT], cw[WTOT];
    int rv = 0, rw = 0, L = 0, t = 0;
    int64_t i, l = 0, n;
    int ring_cap = 4;
    while (ring_cap < W + 1) ring_cap <<= 1;
    memset(&S, 0, sizeof(S));
    S.ring_mask = ring_cap - 1;
    S.ring = (int *)malloc(ring_cap * sizeof(int));
    memset(cv, 0, sizeof(cv));
    memset(cw, 0, sizeof(cw));
    for (i = 0; i <= l_seq; ++i) {
        int b = i < l_seq ? NT4[seq[i]] : 4;
        if (b < 4) {
            ++l;
            t = ((t << 2) | b) & WMSK;
            if (l >= WLEN) {
                int start = (l - W > 0 ? (int)(l - W) : 0) + (int)(i + 1 - l);
                save_masked(&S, start);
                shift_win(&S, t, T, W, &L, &rw, &rv, cw, cv);
                if (rw * 10 > L * T)
                    find_perfect(&S, T, start, L, rv, cv);
            }
        } else {
            int start = (l - W + 1 > 0 ? (int)(l - W + 1) : 0)
                        + (int)(i + 1 - l);
            while (S.P_n) save_masked(&S, start++);
            l = t = 0;
        }
    }
    n = S.res_n;
    if (n > out_cap)
        n = -n;
    else if (n > 0)     /* S.res is NULL when nothing was masked */
        memcpy(out, S.res, n * sizeof(int64_t));
    free(S.ring);
    free(S.P);
    free(S.res);
    return n;
}
