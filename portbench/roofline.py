"""Peaks of the card and the work a kernel's inputs need, frozen here so
that a later change to the program cannot move the yardstick.

A kernel's least time (bound) is its bytes (each input byte read once and
each output byte written once) over the HBM rate of an H100 SXM, or its
integer operations over the card's int32 rate (64 INT32 lanes an SM x 132
SMs x 1.98 GHz boost clock), whichever is the larger.  Operations a unit
of work, counted from what the function must compute (as chip_smoke.py
counts them):

- a k-mer position of minimizer extraction: 2-bit decode, forward and
  reverse-complement update, canonical min, the 7-step hash finalizer,
  validity and window min (EXTRACT_OPS_KMER);
- a base of the SDUST DP: word update, save, window shift with its
  counters and the find_perfect test (SDUST_OPS_BASE); its find_perfect
  row-steps depend on the sequence and are not counted, so an SDUST share
  is a lower bound of the true one;
- a byte compare of the telomere motif match, counted as the input needs
  them when each start stops at its first mismatch (early_exit_compares);
  its bytes are the codes read once and the 8-byte positions of the
  matches (telo_mask_work), what telofind needs of it.

Roofline share = bound / the profiler's device time of the kernel.
"""

HBM_BYTES_PER_S = 3.35e12             # H100 SXM, NVIDIA's data sheet
INT32_OPS_PER_S = 132 * 64 * 1.98e9
EXTRACT_OPS_KMER = 25
SDUST_OPS_BASE = 20
ROW_BYTES = 32                        # a bucket row of 4 slots (2K int32)


def bound_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take for this work."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def decide_work(rows, L: int, k: int, w: int, two_choice: bool):
    """(bytes, ops) of fused decision steps of width L over reads, rows
    {length: count} (the rows the ticks decided; a batch's empty padding
    rows need none): the packed bases and a length a read, one bucket row
    a probe of each of the (L - k + 1) // w windows that holds a valid
    k-mer, a panel byte and the 8-byte fused output a read; extraction's
    operations a k-mer position."""
    probes = 2 if two_choice else 1
    nbytes = ops = 0
    for n, count in rows.items():
        kmers = max(n - k + 1, 0)
        windows = min(-(-kmers // w), (L - k + 1) // w)
        nbytes += count * (-(-n // 4) + 4 + windows * probes * ROW_BYTES
                           + 1 + 8)
        ops += count * kmers * EXTRACT_OPS_KMER
    return nbytes, ops


def sdust_work(n_bases: int, n_rows_out: int):
    """(bytes, ops) of the SDUST DP over n_bases: each base read once, 8
    bytes an output interval; SDUST_OPS_BASE a base."""
    return n_bases + 8 * n_rows_out, SDUST_OPS_BASE * n_bases


def early_exit_compares(x, motif) -> int:
    """Byte compares a match of motif at every start of the 1-D tensor x
    needs when each start stops at its first mismatch (starts past
    len - k included: they stop at the end)."""
    import torch
    L = x.shape[-1]
    alive = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    total = 0
    for j, m in enumerate(motif):
        total += int(alive[..., :L - j].sum(dtype=torch.int64))
        alive[..., :L - j] &= x[..., j:] == m
        alive[..., L - j:] = False
    return total


def telo_mask_work(x, motif):
    """(bytes, ops) of finding one strand's motif matches in the 1-D codes
    x: the codes read once and each match's position written (8 bytes; the
    mask that the kernel writes on the way is not what telofind needs);
    the early-exit byte compares."""
    import torch
    k, L = len(motif), x.shape[-1]
    hit = x[:L - k + 1] == motif[0]
    for j in range(1, k):
        hit &= x[j:L - k + 1 + j] == motif[j]
    matches = int(hit.sum(dtype=torch.int64))
    return L + 8 * matches, early_exit_compares(x, motif)
