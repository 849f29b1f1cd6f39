"""Telomere-motif scans: counterpart of cornetto_tpu/kernels/pallas_telo.py
(telo_match_mask_pallas, telo_match_mask_long, telo_run_stats_pallas) and
cornetto_tpu/kernels/telo_scan.py (telo_match_mask_jax, telo_run_stats_jax).

``telo_match_mask`` and ``telo_run_stats`` launch the hand-written CUDA
kernels (csrc/telo.cu) for tensors on a CUDA device and run their plain
PyTorch versions (``*_ref``) for tensors on the CPU; on a CUDA tensor they
launch or raise, never fall back.

The run statistics keep two behaviours of the JAX functions, which the port
is held to bit for bit: the tandem run is built with steps =
ceil(log2(max(m // k, 1))) doubling passes, so it is capped at 2^steps
copies (a read of L = 18 holding the motif 3 times reports 2), and
``terminal`` tests only the run that starts at position 0.

``_steps_for`` and the host walk ``scan_runs_from_mask`` are copies of the
JAX module's host helpers.  telofind's device path takes
``telo_match_positions`` (the mask compacted on the card) and walks the
positions with ``scan_runs_from_positions``.
"""

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.kernels import _build
from cornetto_tpu_torch.utils import profiling

_KERNEL = "telo"


def _steps_for(m: int, k: int) -> int:
    max_copies = max(m // k, 1)
    return max(int(np.ceil(np.log2(max_copies))), 0)


def scan_runs_from_mask(mask: np.ndarray, k: int):
    """Reconstruct tools/telofind.scan_runs' greedy walk from a match mask:
    next occurrence >= cursor, extend in k-steps while matching, resume at
    end+1 (reference: src/find_telomere.c:44-74).  O(#matches), exact."""
    idx = np.flatnonzero(mask)
    pos = 0
    out = []
    for q in idx:
        if q < pos:
            continue
        p = int(q)
        while p < len(mask) and mask[p]:
            p += k
        out.append((int(q), p, p - int(q)))
        pos = p + 1
    return out


def scan_runs_from_positions(pos, k: int, n: int):
    """``scan_runs_from_mask``'s walk over the sorted match positions of a
    sequence of n bases (a numpy array, list or tensor) instead of its
    mask: the same rows.  One cursor moves forward over the positions, both
    to test whether the run's next stride position matches and to skip the
    matches before end+1; O(#matches)."""
    lst = pos.tolist()
    out = []
    i, n_pos = 0, len(lst)
    while i < n_pos:
        q = lst[i]
        p = q + k
        while p < n:
            while i < n_pos and lst[i] < p:
                i += 1
            if i == n_pos or lst[i] != p:
                break
            p += k
        out.append((q, p, p - q))
        while i < n_pos and lst[i] <= p:
            i += 1
    return out


def _check(codes, motif_codes):
    if not isinstance(codes, torch.Tensor) or codes.dim() != 2 or \
            codes.dtype != torch.uint8:
        raise TypeError("codes must be a 2-D uint8 tensor")
    if not codes.is_contiguous():
        raise ValueError("codes must be contiguous")
    if codes.shape[0] < 1 or codes.shape[1] < 1:
        raise ValueError("codes must hold at least one base (got %s)"
                         % (tuple(codes.shape),))
    motif = tuple(int(c) for c in motif_codes)
    if not motif or any(not 0 <= c <= 3 for c in motif):
        raise ValueError("motif must be 1 or more codes 0-3 (got %s)"
                         % (motif,))
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % codes.device)
    return motif


def _motif_on(motif, dev) -> torch.Tensor:
    """The motif codes on the card, copied from pinned memory on the current
    stream: a copy from pageable memory would first wait for the stream to
    drain, leaving the card idle while the host prepares the launch."""
    return torch.tensor(motif, dtype=torch.uint8).pin_memory().to(
        dev, non_blocking=True)


def telo_match_mask_ref(codes: torch.Tensor, motif_codes) -> torch.Tensor:
    """Plain PyTorch version of ``telo_match_mask``: the shifted compares of
    telo_match_mask_jax, zero-padded to (B, L)."""
    motif = _check(codes, motif_codes)
    B, L = codes.shape
    m = L - len(motif) + 1
    out = torch.zeros((B, L), dtype=torch.int8, device=codes.device)
    if m > 0:
        ok = codes[:, 0:m] == motif[0]
        for j in range(1, len(motif)):
            ok &= codes[:, j:m + j] == motif[j]
        out[:, :m] = ok.to(torch.int8)
    return out


def telo_match_mask(codes: torch.Tensor, motif_codes) -> torch.Tensor:
    """codes (B, L) uint8 (0-3 bases; 4 and up never match), motif codes
    0-3.  Returns (B, L) int8, 1 where the motif matches starting at that
    position (positions >= L-k+1 are 0; all 0 when L < k):
    telo_match_mask_pallas' result.

    A CUDA input launches the kernel on the current stream without
    synchronising and adds one to ``telo_match_mask.launches``."""
    motif = _check(codes, motif_codes)
    if codes.device.type == "cpu":
        return telo_match_mask_ref(codes, motif)
    B, L = codes.shape
    out = torch.empty((B, L), dtype=torch.int8, device=codes.device)
    mt = _motif_on(motif, codes.device)
    fn = _build.bind(_KERNEL, "cornetto_telo_mask", "pllpipp")
    _build.launch(fn, "telomere mask kernel", codes.device, codes.data_ptr(),
                  B, L, mt.data_ptr(), len(motif), out.data_ptr())
    telo_match_mask.launches += 1
    return out


telo_match_mask.launches = 0


def telo_match_mask_long(seq_codes, motif_codes, device=None) -> np.ndarray:
    """Match mask of ONE sequence (a contig), (len,) bool: equal to
    pallas_telo.telo_match_mask_long for every length.  seq_codes: a numpy
    uint8 array (uploaded to ``device``, default device.resolve_device())
    or a 1-D uint8 tensor (used where it lies).  The whole contig is one
    row of ``telo_match_mask``: a launch needs no k-1 halo tiling."""
    if isinstance(seq_codes, torch.Tensor):
        codes = seq_codes
    else:
        codes = torch.from_numpy(np.ascontiguousarray(
            seq_codes, dtype=np.uint8)).to(resolve_device(device))
    n = codes.shape[0]
    if n < len(tuple(motif_codes)):
        return np.zeros(n, dtype=bool)
    mask = telo_match_mask(codes.reshape(1, n), motif_codes)
    return mask[0].to(torch.bool).cpu().numpy()


def telo_match_positions(codes: torch.Tensor, motif_codes,
                         stats: dict = None) -> torch.Tensor:
    """Sorted positions (int64, where ``codes`` lies) at which the motif
    starts a match in ONE sequence, codes a 1-D uint8 tensor: equal to
    np.flatnonzero(telo_match_mask_long(codes, motif_codes)).

    The mask is ``telo_match_mask`` of the sequence as one row (the kernel
    on a card, counted in ``telo_match_mask.launches``) and is compacted
    where it lies with ``torch.nonzero``, so only the positions, not a mask
    as long as the sequence, have to cross to the host.  (The JAX package
    compacts on the host with np.flatnonzero: no TPU kernel is replaced by
    the library call.)  stats: optional dict; the call adds the seconds of
    the mask ("kernel") and of the compaction ("compact") to it,
    synchronising the card at the end of each: the spans
    ``telofind.kernel`` and ``telofind.compact`` under a profiler."""
    if not isinstance(codes, torch.Tensor) or codes.dim() != 1:
        raise TypeError("codes must be a 1-D uint8 tensor")
    n = codes.shape[0]
    motif = tuple(int(c) for c in motif_codes)
    if n < len(motif):
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    with profiling.lap("telofind.kernel", stats, codes.device):
        mask = telo_match_mask(codes.reshape(1, n), motif)
    with profiling.lap("telofind.compact", stats, codes.device):
        return torch.nonzero(mask[0], as_tuple=True)[0]


def telo_run_stats_ref(codes: torch.Tensor, motif_codes,
                       min_run_bases: int = 24):
    """Plain PyTorch version of ``telo_run_stats``: telo_scan's doubling
    loop over the (B, L) mask, as telo_run_stats_pallas runs it."""
    motif = _check(codes, motif_codes)
    k = len(motif)
    B, L = codes.shape
    run = telo_match_mask_ref(codes, motif).to(torch.int32)
    n = run.sum(dim=1, dtype=torch.int32)
    width = 1
    for _ in range(_steps_for(L - k + 1, k)):
        s = width * k
        shifted = torch.nn.functional.pad(run[:, s:], (0, min(s, L)))
        run = torch.where(run == width, run + shifted, run)
        width *= 2
    longest = run.max(dim=1).values
    terminal = run[:, 0] >= -(-min_run_bases // k)
    return n, longest, terminal


MOTIF_BY_VALUE = 64         # motif codes the run-stats kernel takes by value


def telo_run_stats(codes: torch.Tensor, motif_codes,
                   min_run_bases: int = 24):
    """codes (B, L) uint8.  Returns (n_matches (B,) int32, longest tandem run
    (B,) int32 in motif copies, capped at 2^steps, terminal (B,) bool: the
    run at position 0 spans >= ceil(min_run_bases / k) copies), bit-equal
    to telo_run_stats_jax / telo_run_stats_pallas.

    A CUDA input is one kernel launch on the current stream, without
    synchronising, and adds one to ``telo_run_stats.launches``: the bitset
    kernel (a warp a read) for rows of up to 4,096 bases and motifs of up
    to 64 codes, the row walk (a block a read) otherwise.  A motif of up to
    64 codes is a kernel argument; a longer one is copied to the card
    first."""
    motif = _check(codes, motif_codes)
    if codes.device.type == "cpu":
        return telo_run_stats_ref(codes, motif, min_run_bases)
    B, L = codes.shape
    if B >= 1 << 31:
        raise ValueError("at most 2^31-1 reads (got %d)" % B)
    k = len(motif)
    dev = codes.device
    n = torch.empty(B, dtype=torch.int32, device=dev)
    longest = torch.empty(B, dtype=torch.int32, device=dev)
    terminal = torch.empty(B, dtype=torch.bool, device=dev)
    mt = _motif_on(motif, dev) if k > MOTIF_BY_VALUE else None
    fn = _build.bind(_KERNEL, "cornetto_telo_stats", "pllspiiipppp")
    _build.launch(fn, "telomere stats kernel", dev, codes.data_ptr(), B, L,
                  bytes(motif), None if mt is None else mt.data_ptr(), k,
                  _steps_for(L - k + 1, k), -(-min_run_bases // k),
                  n.data_ptr(), longest.data_ptr(), terminal.data_ptr())
    telo_run_stats.launches += 1
    return n, longest, terminal


telo_run_stats.launches = 0
