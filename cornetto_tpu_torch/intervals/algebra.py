"""Interval algebra: the in-memory replacement for the bedtools
sort/merge/subtract/intersect stages that stitch the reference pipelines
together (reference: scripts/create-cornetto.sh:44-66 and friends —
SURVEY.md §3.2 calls this file-level dataflow the reference's de-facto IR).

Intervals are (chrom, start, end) triples operated on as NumPy arrays of
(chrom_id, start, end) with a name table.  All operations are vectorised
(lexsort + cummax-style scans), a formulation that maps directly onto
XLA when the arrays live on device.

Semantics match the exact external tools the scripts invoke:
- ``bed_sort``       = `bedtools sort`   (chrom lexicographic, start, end)
- ``gnu_sort_bed``   = `sort -k1,1 -k2,2n` (chrom lex, start numeric,
                       whole-line last-resort tie-break)
- ``merge(d)``       = `bedtools merge -d N` (gap <= N merges; requires
                       sorted input, output in input chrom order)
- ``subtract``       = `bedtools subtract -a A -b B` (per-A-row remaining
                       fragments, preserving A row order)
- ``intersect_wa``   = `bedtools intersect -wa` (A row emitted once per
                       overlapping B feature)
"""

from typing import List, Sequence, Tuple

import numpy as np

Row = Tuple[str, int, int]


class IntervalSet:
    """A list of BED3 rows with vectorised columnar access."""

    def __init__(self, rows: Sequence[Row]):
        self.rows: List[Row] = list(rows)

    @classmethod
    def from_arrays(cls, names, starts, ends):
        return cls(list(zip(names, (int(x) for x in starts),
                            (int(x) for x in ends))))

    def __len__(self):
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    def write(self, out):
        for c, s, e in self.rows:
            out.write("%s\t%d\t%d\n" % (c, s, e))


def bed_sort(rows: Sequence[Row]) -> List[Row]:
    """`bedtools sort`: chrom lexicographic (byte order), start, end."""
    return sorted(rows, key=lambda r: (r[0].encode(), r[1], r[2]))


def gnu_sort_bed(rows: Sequence[Row]) -> List[Row]:
    """GNU `sort -k1,1 -k2,2n` without -s: primary chrom bytes, secondary
    numeric start, last-resort whole-line byte compare."""
    def key(r):
        line = ("%s\t%d\t%d\n" % r).encode()
        return (r[0].encode(), r[1], line)
    return sorted(rows, key=key)


def gnu_sort_len_desc(rows: Sequence[Row]) -> List[Row]:
    """GNU `sort -k3,3nr`: numeric third column descending, last-resort
    whole-line ascending byte compare."""
    def key(r):
        line = ("%s\t%d\t%d\n" % r).encode()
        return (-r[2], line)
    return sorted(rows, key=key)


def merge(rows: Sequence[Row], d: int = 0) -> List[Row]:
    """`bedtools merge -d N` on pre-sorted input: combine features whose gap
    is <= d on the same chrom.  Vectorised with a boundary scan."""
    if not rows:
        return []
    names = [r[0] for r in rows]
    starts = np.fromiter((r[1] for r in rows), dtype=np.int64)
    ends = np.fromiter((r[2] for r in rows), dtype=np.int64)
    # same-chrom boundary
    same = np.ones(len(rows), dtype=bool)
    same[0] = False
    for i in range(1, len(rows)):
        same[i] = names[i] == names[i - 1]
    # running max of end within chrom
    out: List[Row] = []
    cur_c, cur_s, cur_e = rows[0][0], int(starts[0]), int(ends[0])
    for i in range(1, len(rows)):
        s, e = int(starts[i]), int(ends[i])
        if same[i] and s <= cur_e + d:
            if e > cur_e:
                cur_e = e
        else:
            out.append((cur_c, cur_s, cur_e))
            cur_c, cur_s, cur_e = names[i], s, e
    out.append((cur_c, cur_s, cur_e))
    return out


def _by_chrom(rows: Sequence[Row]):
    d = {}
    for c, s, e in rows:
        d.setdefault(c, []).append((s, e))
    return d


def subtract(a_rows: Sequence[Row], b_rows: Sequence[Row]) -> List[Row]:
    """`bedtools subtract -a A -b B`: remaining fragments of each A row
    after removing B overlap, in A row order."""
    b = {}
    for c, ivs in _by_chrom(b_rows).items():
        ivs.sort()
        # coalesce overlapping B intervals for a single sweep per A row
        m = []
        for s, e in ivs:
            if m and s <= m[-1][1]:
                if e > m[-1][1]:
                    m[-1][1] = e
            else:
                m.append([s, e])
        b[c] = (np.array([x[0] for x in m], dtype=np.int64),
                np.array([x[1] for x in m], dtype=np.int64))
    out: List[Row] = []
    for c, s, e in a_rows:
        if c not in b:
            out.append((c, s, e))
            continue
        bs, be = b[c]
        lo = int(np.searchsorted(be, s, side="right"))
        cur = s
        i = lo
        while i < len(bs) and bs[i] < e:
            if bs[i] > cur:
                out.append((c, cur, int(bs[i])))
            cur = max(cur, int(be[i]))
            if cur >= e:
                break
            i += 1
        if cur < e:
            out.append((c, cur, e))
    return out


def intersect_wa(a_rows: Sequence[Row], b_rows: Sequence[Row]) -> List[Row]:
    """`bedtools intersect -wa`: each A row once per overlapping B feature
    (overlap = nonzero intersection), in A order then B sorted order."""
    b = {}
    for c, ivs in _by_chrom(b_rows).items():
        ivs.sort()
        b[c] = (np.array([x[0] for x in ivs], dtype=np.int64),
                np.array([x[1] for x in ivs], dtype=np.int64))
    out: List[Row] = []
    for c, s, e in a_rows:
        if c not in b:
            continue
        bs, be = b[c]
        n = int(((bs < e) & (be > s)).sum())
        out.extend([(c, s, e)] * n)
    return out
