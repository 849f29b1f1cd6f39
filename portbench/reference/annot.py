"""Plain reference of the annotation cell: `sdust`'s rows by the sequential
SDUST DP (sdust.c, a frozen copy of the program's host DP) and
`telofind`'s rows by a left-to-right scan of the contig for the motif and
its reverse complement.  It imports nothing of the program.

sdust is checked on windows of each contig drawn from the seed: both contig
ends (the telomere arrays), some satellite arrays and N gaps with a margin,
and windows at random.  The DP of a whole contig takes minutes on its
satellites, so a window [a, b) runs the DP over [a - ctx, b + ctx) and
both sides' rows are clipped to [a, b): the DP's state is a function of
its last W pushed words, so with the ctx bases before a free of N it
agrees with the whole contig's from a - ctx + 2W on (kernels/
sdust_chunked.py of the program tiles its rows by the same property),
and no interval found before then reaches a (ctx > 2W + W + 3).  The
windows are moved right until the ctx bases before them hold no N.
"""

from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import harness
from portbench.reference import native

COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def windows(ck: dict, seed: int, ci: int, text: np.ndarray, feats):
    """One contig's sdust check windows [a, b), as ck (the mix's "check")
    sets their numbers and sizes."""
    n = len(text)
    rng = harness.rng(seed, harness.CHECK, ci)
    out = [(0, ck["end_len"]), (n - ck["end_len"], n)]
    for kind, count in (("sat", ck["satellite_windows"]),
                        ("gap", ck["gap_windows"])):
        pool = [f for f in feats if (f[1] == "N") == (kind == "gap")
                and f[1] not in ("TTAGGG", "CCCTAA")]
        for j in rng.choice(len(pool), size=min(count, len(pool)),
                            replace=False).tolist():
            s, _, ln = pool[j]
            out.append((s - ck["pad"], s + ln + ck["pad"]))
    for x in rng.integers(0, n - ck["window_len"], ck["random_windows"]):
        out.append((int(x), int(x) + ck["window_len"]))
    ctx, kept = ck["context"], []
    for a, b in out:
        a, b = max(a, 0), min(b, n)
        while a > 0:
            ns = np.flatnonzero(text[max(a - ctx, 0):a] == ord("N"))
            if not len(ns):
                break
            a = max(a - ctx, 0) + int(ns[-1]) + 1 + ctx
        if a < b:
            kept.append((a, b))
    return kept


def sdust(seq: bytes, T: int, W: int):
    """The sequential DP's rows of seq as (start, end) pairs."""
    lib = native.load("sdust")
    cap = max(len(seq) // 2 + 16, 64)
    out = np.empty(cap, dtype=np.int64)
    n = lib.pb_sdust_mask(seq, len(seq), T, W, out.ctypes.data, cap)
    return [(int(v >> 32), int(v & 0xFFFFFFFF)) for v in out[:n]]


def clip(rows, a: int, b: int):
    """rows cut to [a, b), touching ones joined: one set of bases has one
    form."""
    out = []
    for s, e in sorted(rows):
        s, e = max(s, a), min(e, b)
        if s >= e:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def sdust_window(text: np.ndarray, a: int, b: int, ctx: int, T: int, W: int,
                 chunk: int = 0):
    """The reference's rows in [a, b).  chunk > 0 is the control: the DP of
    each chunk-long piece alone, with no context and no overlap."""
    lo, hi = max(a - ctx, 0), min(b + ctx, len(text))
    if not chunk:
        rows = [(s + lo, e + lo) for s, e in
                sdust(text[lo:hi].tobytes(), T, W)]
    else:
        rows = [(s + x, e + x) for x in range(lo, hi, chunk)
                for s, e in sdust(text[x:min(x + chunk, hi)].tobytes(), T,
                                  W)]
    return clip(rows, a, b)


def sdust_windows(texts, wins, ctx: int, T: int, W: int, chunk: int = 0):
    """{(contig, a, b): rows} over every window, on a thread each."""
    keys = [(ci, a, b) for ci, ws in enumerate(wins) for a, b in ws]
    # the longest first, so the pool ends together
    order = sorted(keys, key=lambda k: -(k[2] - k[1]))
    with ThreadPoolExecutor() as ex:
        futs = {k: ex.submit(sdust_window, texts[k[0]], k[1], k[2], ctx, T,
                             W, chunk) for k in order}
        return {k: f.result() for k, f in futs.items()}


def runs(seq: bytes, motif: bytes):
    """Maximal tandem runs of motif, leftmost first: a run starts at a
    match found at or after the cursor and extends while the next copy
    matches; the search goes on one base past its end."""
    k, pos = len(motif), 0
    while True:
        pos = seq.find(motif, pos)
        if pos < 0:
            return
        start = pos
        while seq[pos:pos + k] == motif:
            pos += k
        yield start, pos, pos - start
        pos += 1


def telofind_rows(name: str, text: np.ndarray, motif: str):
    """telofind's rows of one contig: the motif's runs, then its reverse
    complement's."""
    seq = text.tobytes().upper()
    rmotif = "".join(COMPLEMENT.get(c, c) for c in reversed(motif))
    return ["%s\t%d\t%d\t%d\t%d\t%d" % (name, len(seq), strand, s, e, ln)
            for strand, m in ((0, motif), (1, rmotif))
            for s, e, ln in runs(seq, m.encode())]


def rows_off(got, want) -> int:
    """Rows in one list and not the other, counted with multiplicity."""
    a, b = Counter(got), Counter(want)
    return sum(((a - b) + (b - a)).values())
