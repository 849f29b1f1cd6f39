"""Seeded decision-step cases for the fused decision kernel
(cornetto_tpu_torch/kernels/decide.py): a small index and a batch of
packed reads made to reach every branch of the lookup, the votes and the
policy.  Used by tests/test_torch_decide_fused.py (against the JAX
package), tests/test_torch_cuda_kernels.py and chip_smoke.py (the kernel
against its plain version on the card), so it imports only numpy, torch
and the port.

The draft: contig 1 holds contig 0's first three quarters a quarter
further on (every hash of that copy is ambiguous: two stored occurrences
at different positions), contig 2 (with more than three contigs) starts
with contig 0's second half (ambiguous and unique hits in one read), the
last contig is the longest, a multiple of 128 kb, so a read at its end has
its estimate in the panel's last 1 kb bin, the others are uniform random.  The batch holds
genomic reads (half reverse-complemented), random reads with no hit, reads
wholly inside the copied part of contig 0 (ambiguous hits only), reads
made of two contigs whose votes tie (found by search with the plain
version), reads at the end of the last contig, and, by validity variant,
reads with Ns (one all N), or short lengths (one shorter than k, one of
length 0)."""

import numpy as np
import torch

from cornetto_tpu_torch.kernels.decide import _lookup_votes
from cornetto_tpu_torch.kernels.extract import extract_minima_ref
from cornetto_tpu_torch.kernels.minimizer import pack_reads
from cornetto_tpu_torch.livefish.index import build_index, build_panel_mask

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
LAST_LEN = 128_000      # the last contig's length is a multiple: its end
                        # is in the panel's last 1 kb bin
VARIANTS = ("nfree", "lengths", "nmask")


def draft(seed: int, n_ctg: int, L: int, total: int = 60_000):
    """(names, codes) of the seeded draft described above, about
    ``total`` bases besides the last contig."""
    rng = np.random.default_rng([seed, n_ctg, 1])
    size = max(total // n_ctg, 2 * L + 200)
    codes = [rng.integers(0, 4, size=size, dtype=np.uint8)
             for _ in range(n_ctg - 1)]
    last = max(LAST_LEN, -(-size // LAST_LEN) * LAST_LEN)   # the longest
    codes.append(rng.integers(0, 4, size=last, dtype=np.uint8))
    # copies at offsets a multiple of w = 10, so a copy's window minima are
    # the original's
    off = size // 40 * 10
    codes[1][off:] = codes[0][:size - off]
    if n_ctg > 3:
        half = size // 20 * 10
        codes[2][:size - half] = codes[0][half:]
    return ["c%d" % i for i in range(n_ctg)], codes


def index(seed: int, n_ctg: int, two_choice: bool, L: int = 450,
          slots: int = 4, total: int = 60_000):
    """(MinimizerIndex, panel (C, bins) bool, contig codes).  The panel
    holds every other contig whole and the last 2 kb of the last one."""
    names, codes = draft(seed, n_ctg, L, total)
    idx = build_index(((n, ACGT[c].tobytes().decode("ascii"))
                       for n, c in zip(names, codes)), n_shards=1,
                      two_choice=two_choice, bucket_slots=slots)
    rows = [(n, 0, len(c)) for n, c in zip(names[::2], codes[::2])]
    rows.append((names[-1], len(codes[-1]) - 2000, len(codes[-1])))
    return idx, build_panel_mask(idx, rows), codes


def _sample(rng, codes, ctg: int, L: int, start=None):
    c = codes[ctg]
    s = int(rng.integers(0, len(c) - L + 1)) if start is None else start
    return c[s:s + L].copy()


def _votes(idx, panel, reads, L):
    """(B, C) votes of the plain lookup on N-free reads."""
    packed, _ = pack_reads(reads)
    h, v = extract_minima_ref(torch.from_numpy(packed), None, L, idx.k,
                              idx.w)
    return _lookup_votes(torch.from_numpy(idx.btable[0]), idx.bucket_shift,
                         h, v, panel.shape[0], idx.two_choice)[0].numpy()


def _ties(rng, idx, panel, codes, L: int, want: int):
    """Reads of two contigs' halves whose top two vote counts are equal."""
    found = []
    n_ctg = len(codes)
    for _ in range(40):
        a = rng.integers(0, n_ctg, size=64)
        b = (a + rng.integers(1, n_ctg, size=64)) % n_ctg
        cut = rng.integers(L // 2 - 60, L // 2 + 60, size=64)
        reads = np.stack([np.concatenate([
            _sample(rng, codes, int(x), L)[:int(s)],
            _sample(rng, codes, int(y), L)[int(s):]])
            for x, y, s in zip(a, b, cut)])
        votes = _votes(idx, panel, reads, L)
        top = np.sort(votes, axis=1)
        tie = (top[:, -1] == top[:, -2]) & (top[:, -1] > 0)
        found.extend(reads[tie])
        if len(found) >= want:
            return np.stack(found[:want])
    raise AssertionError("no tied read found")


def batch(seed: int, idx, panel, codes, variant: str, B: int = 64,
          L: int = 450):
    """One batch of B reads of L bases in a validity variant.  Returns
    (packed, nmask or None, lengths or None, rows) with rows a dict of the
    special reads' row numbers: "junk", "ambiguous", "tie", "last_bin",
    "empty" (reads that can have no valid window)."""
    assert variant in VARIANTS and B >= 24
    rng = np.random.default_rng([seed, B, L, VARIANTS.index(variant)])
    n_ctg = len(codes)
    reads = np.empty((B, L), dtype=np.uint8)
    rows = {}
    at = 0

    def put(name, block):
        nonlocal at
        reads[at:at + len(block)] = block
        rows[name] = list(range(at, at + len(block)))
        at += len(block)
    junk = rng.integers(0, 4, size=(16, L), dtype=np.uint8)
    put("junk", junk[_votes(idx, panel, junk, L).sum(axis=1) == 0][:3])
    # the last start whose windows all lie inside the copy
    dup = len(codes[0]) - len(codes[0]) // 40 * 10 - L - 50
    put("ambiguous", np.stack([_sample(rng, codes, 0, L, int(s)) for s in
                               rng.integers(0, dup + 1, size=3)]))
    put("tie", _ties(rng, idx, panel, codes, L, 3))
    last = n_ctg - 1
    put("last_bin", np.stack([_sample(rng, codes, last, L,
                                      len(codes[last]) - L - s)
                              for s in (0, 7)]))
    rest = B - at
    ctg = rng.integers(0, n_ctg, size=rest)
    put("genomic", np.stack([_sample(rng, codes, int(c), L) for c in ctg]))
    rc = rng.random(B) < 0.5
    rc[rows["tie"] + rows["last_bin"]] = False
    reads[rc] = 3 - reads[rc, ::-1]
    lengths, use_nmask = None, variant == "nmask"
    if variant == "nmask":
        reads[rng.random((B, L)) < 0.01] = 4
        g = rows["genomic"]
        reads[g[0]] = 4                             # all N
        rows["empty"] = [g[0]]
    elif variant == "lengths":
        lengths = np.full(B, L, dtype=np.int32)
        g = np.array(rows["genomic"])
        short = g[3:][rng.random(len(g) - 3) < 0.3]
        lengths[short] = rng.integers(idx.k, L, size=len(short))
        lengths[g[0]], lengths[g[1]] = idx.k - 1, 0
        lengths[g[2]] = idx.k                       # one k-mer
        rows["empty"] = [g[0], g[1]]
    else:
        rows["empty"] = []
    packed, nmask = pack_reads(reads)
    return packed, (nmask if use_nmask else None), lengths, rows
