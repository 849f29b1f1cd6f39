"""Motif-occurrence scanning.

Replaces the reference's strstr scan loop (reference: src/find_telomere.c:44-74)
with a vectorised shifted-compare: match[i] = all_k(seq[i+k] == motif[k]).
The host path uses NumPy; the device path (livefish) uses the same formulation
in JAX where it fuses into a handful of VPU compare/and ops.
"""

from typing import List, Tuple

_COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}


def revcomp_motif(motif: str) -> str:
    """Reverse complement; unexpected characters pass through reversed
    (reference: src/find_telomere.c:24-42)."""
    return "".join(_COMPLEMENT.get(c, c) for c in reversed(motif))
