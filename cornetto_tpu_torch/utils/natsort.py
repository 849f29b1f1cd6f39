"""Natural (alphanumeric) comparators matching the two subtly different
variants in the reference:

- ``strnum_cmp``: samtools-style compare (reference: src/misc.c:139-171),
  used by asmstats chromosome ordering.
- ``mixed_numcompare``: miniasm's variant (reference: src/minidot/dotter.c:25-47),
  used by minidot target-axis ordering.  Differs from strnum_cmp in tie-breaks
  for equal-value numbers with different digit counts (e.g. "007" vs "7").
"""

import functools


def _is_digit(c: str) -> bool:
    return "0" <= c <= "9"


def strnum_cmp(a: str, b: str) -> int:
    pa, pb = 0, 0
    la, lb = len(a), len(b)
    while pa < la and pb < lb:
        ca, cb = a[pa], b[pb]
        if not (_is_digit(ca) and _is_digit(cb)):
            if ca != cb:
                return ord(ca) - ord(cb)
            pa += 1
            pb += 1
        else:
            while pa < la and a[pa] == "0":
                pa += 1
            while pb < lb and b[pb] == "0":
                pb += 1
            while pa < la and pb < lb and _is_digit(a[pa]) and a[pa] == b[pb]:
                pa += 1
                pb += 1
            diff = (ord(a[pa]) if pa < la else 0) - (ord(b[pb]) if pb < lb else 0)
            while pa < la and pb < lb and _is_digit(a[pa]) and _is_digit(b[pb]):
                pa += 1
                pb += 1
            if pa < la and _is_digit(a[pa]):
                return 1
            if pb < lb and _is_digit(b[pb]):
                return -1
            if diff:
                return diff
    if pa < la:
        return 1
    if pb < lb:
        return -1
    return 0


strnum_key = functools.cmp_to_key(strnum_cmp)


def mixed_numcompare(a: str, b: str) -> int:
    pa, pb = 0, 0
    la, lb = len(a), len(b)
    while pa < la and pb < lb:
        ca, cb = a[pa], b[pb]
        if _is_digit(ca) and _is_digit(cb):
            start_a, start_b = pa, pb
            while pa < la and a[pa] == "0":
                pa += 1
            while pb < lb and b[pb] == "0":
                pb += 1
            while (pa < la and pb < lb and _is_digit(a[pa]) and _is_digit(b[pb])
                   and a[pa] == b[pb]):
                pa += 1
                pb += 1
            da = pa < la and _is_digit(a[pa])
            db = pb < lb and _is_digit(b[pb])
            if da and db:
                i = 0
                while (pa + i < la and pb + i < lb
                       and _is_digit(a[pa + i]) and _is_digit(b[pb + i])):
                    i += 1
                if pa + i < la and _is_digit(a[pa + i]):
                    return 1
                if pb + i < lb and _is_digit(b[pb + i]):
                    return -1
                return ord(a[pa]) - ord(b[pb])
            elif da:
                return 1
            elif db:
                return -1
            elif (pa - start_a) != (pb - start_b):
                # equal values; more leading zeros skipped sorts first
                return 1 if (pa - start_a) < (pb - start_b) else -1
        else:
            if ca != cb:
                return ord(ca) - ord(cb)
            pa += 1
            pb += 1
    if pa < la:
        return 1
    if pb < lb:
        return -1
    return 0


mixed_key = functools.cmp_to_key(mixed_numcompare)
