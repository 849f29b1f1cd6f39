"""Motif-occurrence scanning.

Replaces the reference's strstr scan loop (reference: src/find_telomere.c:44-74)
with a vectorised shifted-compare: match[i] = all_k(seq[i+k] == motif[k]).
The host path uses NumPy (``match_positions``, ``tandem_runs``); the port's
device path is the telomere kernels (kernels/telo.py).
"""

from typing import List, Tuple

import numpy as np

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def revcomp_motif(motif: str) -> str:
    """Reverse complement; unexpected characters pass through reversed
    (reference: src/find_telomere.c:24-42)."""
    return "".join(_COMPLEMENT.get(c, c) for c in reversed(motif))


def match_positions(seq_bytes: np.ndarray, motif: str) -> np.ndarray:
    """Positions i where seq[i:i+len(motif)] == motif. seq_bytes: uint8."""
    m = np.frombuffer(motif.encode(), dtype=np.uint8)
    L, k = len(seq_bytes), len(m)
    if L < k or k == 0:
        return np.empty(0, dtype=np.int64)
    ok = seq_bytes[:L - k + 1] == m[0]
    for j in range(1, k):
        ok &= seq_bytes[j:L - k + 1 + j] == m[j]
    return np.flatnonzero(ok)


def tandem_runs(positions: np.ndarray, motif_len: int,
                have: np.ndarray = None) -> List[Tuple[int, int, int]]:
    """Reproduce the reference scan-cursor semantics: walk matches left to
    right; at each match >= cursor report the maximal exact tandem run
    (steps of motif_len), then resume at run_end + 1
    (reference: src/find_telomere.c:49-58).

    Returns [(start, end, matched_len)].  ``have`` is unused (kept for the
    JAX package's signature).
    """
    out = []
    if len(positions) == 0:
        return out
    pset = set(int(p) for p in positions)
    idx = 0
    n = len(positions)
    cursor = 0
    while idx < n:
        if positions[idx] < cursor:
            idx += 1
            continue
        p = int(positions[idx])
        end = p
        length = 0
        while end in pset:
            end += motif_len
            length += motif_len
        out.append((p, end, length))
        cursor = end + 1
        idx = int(np.searchsorted(positions, cursor))
    return out
