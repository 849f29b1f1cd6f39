"""Adaptive-sampling decision engine in PyTorch: counterpart of
cornetto_tpu/livefish/decide.py (single device).

One decision step on a batch of 2-bit packed reads:

1. minimizer extraction, the CUDA kernel on a card
   (kernels.extract.extract_minima);
2. lookup of each minimizer hash in the fingerprinted bucket table and the
   9-plane per-contig vote reduction (``_lookup_votes``);
3. the policy: best contig, exact split-sum position mean, panel test
   (``_decide_from_minima``).

The engine has no weights; its state is the index's bucket table, the
panel mask and the static index parameters (``EngineState``).  Results stay
on the engine's device; the streaming loop reads them back.
"""

from dataclasses import dataclass

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.kernels.extract import extract_minima
from cornetto_tpu_torch.kernels.minimizer import U32_MASK, as_u32, pack_reads
from cornetto_tpu_torch.livefish.index import MinimizerIndex


@dataclass
class DecisionParams:
    min_hits: int = 3
    bin_size: int = 1000


@dataclass
class EngineState:
    btable: torch.Tensor      # (2^B, 2K) int32 bucket rows (livefish.index)
    panel: torch.Tensor       # (C, bins) bool reject panel
    k: int
    w: int
    bucket_shift: int
    two_choice: bool


def state_from_index(index: MinimizerIndex, panel_mask: np.ndarray,
                     device) -> EngineState:
    """Move a single-shard index (as dist.checkpoint.load_index returns it)
    and its panel mask onto ``device``."""
    if index.n_shards != 1:
        raise ValueError("single-device engine needs a 1-shard index "
                         "(got %d shards)" % index.n_shards)
    if panel_mask.shape[0] >= (1 << 16):
        # the fused readback packs best_contig into 16 bits
        raise ValueError("too many contigs for the fused readback")
    device = torch.device(device)
    return EngineState(
        btable=torch.from_numpy(np.ascontiguousarray(
            index.btable[0], dtype=np.int32)).to(device),
        panel=torch.from_numpy(np.ascontiguousarray(
            panel_mask, dtype=bool)).to(device),
        k=int(index.k), w=int(index.w),
        bucket_shift=int(index.bucket_shift),
        two_choice=bool(getattr(index, "two_choice", False)))


def _lookup_votes(btable: torch.Tensor, bucket_shift: int,
                  q_hash: torch.Tensor, q_valid: torch.Tensor,
                  n_contigs: int, two_choice: bool):
    """Fingerprinted bucket-table lookup + per-contig vote reduction
    (cornetto_tpu.livefish.decide._lookup_votes, which documents the row
    layout and the 9 planes).  ``two_choice`` must match how the index was
    built (MinimizerIndex.two_choice) and has no default.

    q_hash (b, M) int32 uint32 bit patterns, q_valid (b, M) bool.  Returns
    9 (b, C) int32 planes: votes, votes_un, nu_hi, nu_lo, votes_amb,
    a1_hi, a1_lo, a2_hi, a2_lo."""
    b, M = q_hash.shape
    dev = q_hash.device
    n_buckets = btable.shape[0]
    K = btable.shape[1] // 2
    log2b = int(n_buckets).bit_length() - 1
    q = as_u32(q_hash.reshape(-1))            # logical shifts on uint32
    bucket = (q >> bucket_shift) & (n_buckets - 1)
    qfp = q >> (bucket_shift + log2b)
    if two_choice:
        g = (((qfp * 0x9E3779B1) & U32_MASK) >> (32 - log2b)) \
            & (n_buckets - 1)
        probes = ((bucket, qfp), (bucket ^ g, qfp | (1 << 15)))
    else:
        probes = ((bucket, qfp),)
    Q = q.shape[0]
    found = torch.zeros(Q, dtype=torch.bool, device=dev)
    has2 = torch.zeros_like(found)
    contig = torch.zeros(Q, dtype=torch.int32, device=dev)
    pos1 = torch.zeros_like(contig)
    pos2 = torch.zeros_like(contig)
    for bk, want in probes:
        row = btable.index_select(0, bk)                    # (Q, 2K)
        for s in range(K):
            fp = (row[:, s // 2] >> (16 * (s % 2))) & 0xFFFF
            ct = (row[:, K // 2 + s // 2] >> (16 * (s % 2))) & 0xFFFF
            m = (fp == want) & (ct != 0xFFFF)
            is2 = m & found & ~has2   # second slot of an ambiguous hash
            is1 = m & ~found
            contig = torch.where(is1, ct, contig)
            pos1 = torch.where(is1, row[:, K + s], pos1)
            pos2 = torch.where(is2, row[:, K + s], pos2)
            has2 = has2 | is2
            found = found | m
    found = found & q_valid.reshape(-1)
    ambig = found & (pos1 < 0)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    p1 = torch.where(found, pos1 & 0x7FFFFFFF, zero)
    # 2nd occurrence may have been bucket-overflow-dropped: fall back to p1
    p2 = torch.where(found & has2, pos2 & 0x7FFFFFFF, p1)
    contig = torch.where(found, contig, zero)

    un = found & ~ambig
    am = found & ambig
    # the nine (b, M) int32 contributions, one per plane
    vals = torch.stack([found.to(torch.int32), un.to(torch.int32),
                        un * (p1 >> 16), un * (p1 & 0xFFFF),
                        am.to(torch.int32),
                        am * (p1 >> 16), am * (p1 & 0xFFFF),
                        am * (p2 >> 16), am * (p2 & 0xFFFF)]
                       ).reshape(9, b, M)
    cr = contig.reshape(b, M)
    if n_contigs <= 64:
        # dense one-hot reduction for small contig counts, one plane at a
        # time so the (b, M, C) intermediate exists once
        oh = cr[:, :, None] == torch.arange(n_contigs, dtype=torch.int32,
                                            device=dev)
        stats = torch.stack([(v[:, :, None] * oh).sum(dim=1,
                                                      dtype=torch.int32)
                             for v in vals])
    else:
        # scatter-add: integer atomics are exact, so order does not matter
        flat = (torch.arange(b, device=dev)[:, None] * n_contigs
                + cr.to(torch.int64)).reshape(1, -1).expand(9, -1)
        stats = torch.zeros((9, b * n_contigs), dtype=torch.int32,
                            device=dev)
        stats.scatter_add_(1, flat, vals.reshape(9, -1))
        stats = stats.reshape(9, b, n_contigs)
    return tuple(stats.unbind(0))


def _mean_split(hi, lo, n):
    """floor((hi*2^16 + lo) / n) in overflow-free int32
    (cornetto_tpu.livefish.decide._mean_split)."""
    n = n.clamp(min=1)
    q = torch.div(hi, n, rounding_mode="floor")
    r = hi - q * n
    return (q << 16) + torch.div((r << 16) + lo, n, rounding_mode="floor")


def _decide_from_minima(btable, h, valid, panel_mask, min_hits: int,
                        bin_size: int, bucket_shift: int, two_choice: bool):
    """Votes + decision from extracted minimizer hashes.  Returns
    (decision (b,) int8 — 1 proceed / 0 unblock, best_contig, est_pos,
    nhits, nhits_hq, est_pos2), each (b,) int32 but the decision."""
    stats9 = _lookup_votes(btable, bucket_shift, h, valid,
                           panel_mask.shape[0], two_choice)
    (votes, votes_un, nu_hi, nu_lo, votes_amb,
     a1_hi, a1_lo, a2_hi, a2_lo) = stats9
    # argmax returns the first maximum, as jnp.argmax does
    best = torch.argmax(votes, dim=1)

    def _pick(a):
        return torch.gather(a, 1, best[:, None])[:, 0]
    nhits = _pick(votes)
    nhits_hq = _pick(votes_un)          # MAPQ>=20 analog: unambiguous hits
    va = _pick(votes_amb)
    # prefer unambiguous hits; an all-ambiguous read gets both copies'
    # estimates (est == est2 whenever the read has a unique anchor)
    have_un = nhits_hq > 0
    est_amb1 = _mean_split(_pick(a1_hi), _pick(a1_lo), va)
    est = torch.where(have_un,
                      _mean_split(_pick(nu_hi), _pick(nu_lo), nhits_hq),
                      est_amb1)
    est2 = torch.where(have_un, est,
                       _mean_split(_pick(a2_hi), _pick(a2_lo), va))
    mapped = nhits >= min_hits
    est_bin = torch.div(est, bin_size, rounding_mode="floor").clamp(
        0, panel_mask.shape[1] - 1)
    in_panel = panel_mask[best, est_bin.to(torch.int64)]
    # adaptive-sampling policy: unblock reads mapping into the boring
    # (already-resolved) panel; keep sequencing everything else
    reject = mapped & in_panel
    decision = (~reject).to(torch.int8)
    return decision, best.to(torch.int32), est, nhits, nhits_hq, est2


def decision_core_packed(btable, packed, nmask, panel_mask, L: int, k: int,
                         w: int, min_hits: int, bin_size: int,
                         bucket_shift: int, two_choice: bool,
                         lengths=None):
    """Decision step on 2-bit packed reads (device tensors): the extraction
    kernel, then lookup, votes and policy.  nmask None = N-free batch,
    optionally with per-read ``lengths``."""
    h, valid = extract_minima(packed, nmask, L, k, w, lengths=lengths)
    return _decide_from_minima(btable, h, valid, panel_mask, min_hits,
                               bin_size, bucket_shift, two_choice)


def decision_core_packed_fused(btable, packed, nmask, panel_mask,
                               lengths=None, **kw):
    """decision_core_packed with the outputs the TSV needs packed into ONE
    (2, B) int32 tensor, one readback per batch:

    row 0 = decision<<30 | min(nhits, 0x3FFF)<<16 | best_contig
    row 1 = est position

    Decode on the host with ``unpack_fused``."""
    d, b, e, nh, _, _ = decision_core_packed(btable, packed, nmask,
                                             panel_mask, lengths=lengths,
                                             **kw)
    w0 = ((d.to(torch.int32) << 30) | (nh.clamp(max=0x3FFF) << 16)
          | (b & 0xFFFF))
    return torch.stack([w0, e])


def unpack_fused(arr):
    """Decode a host-side (2, B) fused result array back into
    (decision, best_contig, est_pos, nhits) int32 vectors."""
    w0 = np.asarray(arr[0])
    est = np.asarray(arr[1])
    d = (w0 >> 30) & 1
    nhits = (w0 >> 16) & 0x3FFF
    best = w0 & 0xFFFF
    return d, best, est, nhits


class SingleChipEngine:
    """Single-device decision engine over an index held on ``device``
    (``cuda`` by default; see device.resolve_device).  Takes numpy host
    batches, returns tensors on the device."""

    def __init__(self, index: MinimizerIndex, panel_mask: np.ndarray,
                 params: DecisionParams = DecisionParams(), device=None):
        self.device = resolve_device(device)
        self.state = state_from_index(index, panel_mask, self.device)
        self.params = params
        self.contig_names = None

    def _kw(self, L: int):
        st, p = self.state, self.params
        return dict(L=L, k=st.k, w=st.w, min_hits=p.min_hits,
                    bin_size=p.bin_size, bucket_shift=st.bucket_shift,
                    two_choice=st.two_choice)

    def _put(self, a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(self.device)

    def decide(self, reads: np.ndarray):
        """(B, L) uint8 codes (4 = N) -> the 6 decision outputs.  Packs on
        the host and takes the packed path, so extraction runs the kernel
        on a card."""
        packed, nmask = pack_reads(reads)
        return self.decide_packed(packed, nmask, reads.shape[1])

    def decide_packed(self, packed: np.ndarray, nmask, L: int,
                      lengths=None):
        """Packed input: nmask None for N-free batches, lengths (B,) int32
        for short reads.  Returns the 6 decision outputs."""
        st = self.state
        return decision_core_packed(
            st.btable, self._put(packed), self._put(nmask), st.panel,
            lengths=self._put(lengths), **self._kw(L))

    def decide_packed_fused(self, packed: np.ndarray, nmask, L: int,
                            lengths=None):
        """decide_packed with the TSV outputs in one (2, B) int32 tensor
        (decision_core_packed_fused)."""
        st = self.state
        return decision_core_packed_fused(
            st.btable, self._put(packed), self._put(nmask), st.panel,
            lengths=self._put(lengths), **self._kw(L))
