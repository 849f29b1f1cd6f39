"""Exact chunked decomposition of the SDUST DP (SURVEY.md §7's named hard
kernel — reference: src/sdust/sdust.c:66-128).

The DP is sequential with data-dependent evictions, but its state is
WINDOWED: everything (ring of <=62 triplet words, cv/cw histograms, the
eviction suffix length L, pending perfect intervals P) is a function of
the last <=W pushed words, and two runs that agree on the last 2W N-free
bases converge to identical state regardless of earlier history — the
property the round-3 hybrid's region finisher already relies on and
fuzz-validates (cornetto_tpu/kernels/sdust_device.py).  This module
turns it into a DENSE tiling so the DP can run lane-parallel:

  - the sequence splits into fixed `core` spans (core >= 128);
  - each chunk runs the DP independently over
      [core_start - CTX, core_end + LOOK),   CTX = 4W, LOOK = W + 8
    (LOOK: find_perfect can still discover an interval starting up to ~W
    before the current position, so intervals reaching into this core
    keep appearing for W positions past core_end);
  - ownership is by CLIPPING, not by interval identity: the DP's final
    merged output is exactly the interval-set UNION of its raw saved
    intervals (save_masked_regions' merge rule is an ascending
    adjacency-joining sweep), every raw interval spans < W + 3 bases,
    and raw intervals produced after state convergence are identical
    between the chunk run and the global run.  Clipping each chunk's
    merged output to [core_start, core_end + 66) therefore keeps exactly
    the globally-correct coverage: possibly-wrong warm-up intervals from
    the first 2W of context cannot reach core_start (4W - 2W > W + 3),
    and every global raw interval overlapping a clip window starts in
    that chunk's core or an adjacent one.  A final ascending union sweep
    over all clipped pieces reproduces the global merge.
  - chunks whose LAST 2W of context contain an N are ineligible (the
    word window can span arbitrarily distant N runs in base coordinates,
    so bounded base context cannot reconstruct state there); consecutive
    ineligible cores coalesce into one span for the sequential DP,
    started from the end of the nearest 2W N-free stretch (exact by the
    same convergence property; N runs are assembly gaps, so this is the
    rare path).

The port's kernels/sdust.py runs the DP of each chunk as one row of its
CUDA kernel and reassembles the rows here; sdust_chunked_oracle() runs the
decomposition with the bit-exact sequential (native) DP per chunk, the
correctness harness of that tiling.
"""

from typing import List, Tuple

import numpy as np

SD_WLEN = 3
DEF_W = 64


def plan_chunks(codes: np.ndarray, core: int, W: int = DEF_W):
    """Split len(codes) into `core` spans.

    Returns (device_chunks, host_spans):
      device_chunks: (core_start, core_end, slice_start, slice_stop) —
        slice = [core_start - 4W (clamped), core_end + W + 8 (clamped)),
        with the last 2W before core_start guaranteed N-free;
      host_spans: (run_start, core_start, core_end) for the sequential
        fallback (run the DP from run_start, clip to the cores).
    """
    assert core >= 2 * W, "core must exceed one window"
    L = len(codes)
    ctx = 4 * W
    conv = 2 * W
    look = W + 8
    isn = codes >= 4
    cs = np.zeros(L + 1, dtype=np.int64)
    np.cumsum(isn, out=cs[1:])
    device = []
    host = []   # (run_start, core_start, core_end)
    for a in range(0, L, core):
        b = min(a + core, L)
        if cs[a] - cs[max(a - conv, 0)] == 0:
            device.append((a, b, max(a - ctx, 0), min(b + look, L)))
        else:
            # walk back to the end of a 2W N-free stretch (or pos 0): the
            # sequential DP from there carries exact state into the core
            q = a
            seen = 0
            while q > 0 and seen < conv:
                q -= 1
                seen = 0 if isn[q] else seen + 1
            if host and host[-1][2] == a:
                host[-1] = (min(host[-1][0], q), host[-1][1], b)
            else:
                host.append((q, a, b))
    return device, host


def clip(intervals, lo: int, hi: int):
    """Pieces of `intervals` overlapping [lo, hi)."""
    return [(max(s, lo), min(f, hi))
            for s, f in intervals if s < hi and f > lo]


def merge_sweep(pieces: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Ascending-start adjacency-joining union — the global shape of the
    DP's res merge rule (src/sdust/sdust.c save_masked_regions)."""
    out: List[Tuple[int, int]] = []
    for s, f in sorted(pieces):
        if out and s <= out[-1][1]:
            if f > out[-1][1]:
                out[-1] = (out[-1][0], f)
        else:
            out.append((s, f))
    return out


def assemble(per_chunk, device, host_parts, W: int = DEF_W):
    """Clip per-chunk interval lists to their owned windows and union."""
    pieces: List[Tuple[int, int]] = []
    for (a, b, c0, _stop), ivs in zip(device, per_chunk):
        pieces.extend(clip([(s + c0, f + c0) for s, f in ivs],
                           a, b + W + 2))
    for (q, a, b), ivs in host_parts:
        pieces.extend(clip([(s + q, f + q) for s, f in ivs],
                           a, b + W + 2))
    return merge_sweep(pieces)


def run_host_spans(seq: bytes, host, T: int, W: int):
    """Sequential-DP results for the ineligible spans (N-proximal)."""
    from cornetto_tpu_torch.native.sdust import sdust as sdust_exact
    out = []
    for q, a, b in host:
        stop = min(b + W + 8, len(seq))
        out.append(((q, a, b), sdust_exact(seq[q:stop], T=T, W=W)))
    return out


def sdust_chunked_oracle(seq: bytes, T: int = 20, W: int = DEF_W,
                         core: int = 512) -> List[Tuple[int, int]]:
    """The decomposition with the bit-exact sequential DP per chunk —
    must equal sdust(seq); the correctness harness of the kernel's
    tiling (a chunk a row)."""
    # the per-chunk DP is the native port: the pure-Python DP at
    # dense-satellite rates would make this harness minutes-slow
    from cornetto_tpu_torch.kernels.sdust_core import _NT4
    from cornetto_tpu_torch.native.sdust import sdust
    codes = _NT4[np.frombuffer(seq, dtype=np.uint8)]
    device, host = plan_chunks(codes, core, W)
    per_chunk = [sdust(seq[c0:stop], T=T, W=W)
                 for _a, _b, c0, stop in device]
    host_parts = [((q, a, b), sdust(seq[q:min(b + W + 8, len(codes))],
                                    T=T, W=W))
                  for q, a, b in host]
    return assemble(per_chunk, device, host_parts, W)
