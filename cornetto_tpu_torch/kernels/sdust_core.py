"""Symmetric DUST low-complexity masking (SDUST, Morgulis et al. 2006).

ATTRIBUTION: this module is a Python port of lh3/sdust (MIT license) as
vendored in the reference (reference: src/sdust/sdust.c:66-160), kept as
the bit-exact oracle for the golden suite.  The W-triplet ring window with
running duplicate-pair counts rw/rv, the cv*10 > 2T eviction rule,
perfect-interval enumeration kept sorted by descending start with the
r/l-ratio insertion test, and interval merging as windows slide all follow
that C code closely — the quirky DP's byte-exact output depends on its
precise ordering, so this is a derived transcription, not an independent
re-derivation.

This sequential DP is the one kernel in the suite without a trivially
parallel form (SURVEY.md §7 hard-parts list); the device strategy is vmap
over many sequences/chunks, with this implementation as the bit-exact oracle.
"""

from collections import deque
from typing import List, Tuple

import numpy as np

SD_WLEN = 3
SD_WTOT = 1 << (SD_WLEN << 1)  # 64

_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _NT4[ord(_c)] = _i
    _NT4[ord(_c.lower())] = _i


def sdust(seq: bytes, T: int = 20, W: int = 64) -> List[Tuple[int, int]]:
    """Masked intervals [(start, end)) for one sequence."""
    res: List[List[int]] = []
    P: List[List[int]] = []  # [start, finish, r, l] sorted by desc start
    w: deque = deque()
    cv = [0] * SD_WTOT
    cw = [0] * SD_WTOT
    rv = rw = L = 0
    l = 0
    t = 0
    codes = _NT4[np.frombuffer(seq, dtype=np.uint8)]
    l_seq = len(codes)

    def save_masked_regions(start: int) -> None:
        if not P or P[-1][0] >= start:
            return
        p = P[-1]
        saved = False
        if res:
            s, f = res[-1]
            if p[0] <= f:
                saved = True
                res[-1][1] = max(f, p[1])
        if not saved:
            res.append([p[0], p[1]])
        i = len(P) - 1
        while i >= 0 and P[i][0] < start:
            i -= 1
        del P[i + 1:]

    def shift_window(t: int) -> None:
        nonlocal rv, rw, L
        if len(w) >= W - SD_WLEN + 1:
            s = w.popleft()
            cw[s] -= 1
            rw -= cw[s]
            if L > len(w):
                L -= 1
                cv[s] -= 1
                rv -= cv[s]
        w.append(t)
        L += 1
        rw += cw[t]
        cw[t] += 1
        rv += cv[t]
        cv[t] += 1
        if cv[t] * 10 > (T << 1):
            while True:
                s = w[len(w) - L]
                cv[s] -= 1
                rv -= cv[s]
                L -= 1
                if s == t:
                    break

    def find_perfect(start: int) -> None:
        c = cv.copy()
        r = rv
        max_r = max_l = 0
        for i in range(len(w) - L - 1, -1, -1):
            t_i = w[i]
            r += c[t_i]
            c[t_i] += 1
            new_r = r
            new_l = len(w) - i - 1
            if new_r * 10 > T * new_l:
                j = 0
                while j < len(P) and P[j][0] >= i + start:
                    p = P[j]
                    if max_r == 0 or p[2] * max_l > max_r * p[3]:
                        max_r, max_l = p[2], p[3]
                    j += 1
                if max_r == 0 or new_r * max_l >= max_r * new_l:
                    max_r, max_l = new_r, new_l
                    P.insert(j, [i + start,
                                 len(w) + (SD_WLEN - 1) + start,
                                 new_r, new_l])

    for i in range(l_seq + 1):
        b = int(codes[i]) if i < l_seq else 4
        if b < 4:
            l += 1
            t = ((t << 2) | b) & (SD_WTOT - 1)
            if l >= SD_WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                save_masked_regions(start)
                shift_window(t)
                if rw * 10 > L * T:
                    find_perfect(start)
        else:
            start = max(l - W + 1, 0) + (i + 1 - l)
            while P:
                save_masked_regions(start)
                start += 1
            l = t = 0
    return [(a, b) for a, b in res]
