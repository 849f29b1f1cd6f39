"""The fused decision step: packed reads in, decisions out.  Counterpart of
cornetto_tpu/livefish/decide.py::decision_core_packed (and its fused
(2, B) form), whose extraction is the TPU kernel
cornetto_tpu/kernels/pallas_extract.py::extract_minima_pallas and whose
lookup, votes and policy are XLA.

``decide_packed`` launches the hand-written CUDA kernel (csrc/decide.cu:
extraction, lookup, votes and policy in one launch) for tensors on a CUDA
device and runs the plain PyTorch version ``decide_packed_ref`` for
tensors on the CPU; on a CUDA tensor it launches or raises, never falls
back.  The plain version is ``extract_minima_ref`` followed by
``_lookup_votes`` (the fingerprinted bucket-table lookup and the 9-plane
per-contig vote reduction) and ``_decide_from_minima`` (best contig, exact
split-sum position mean, panel test).
"""

import torch

from cornetto_tpu_torch.kernels import _build
from cornetto_tpu_torch.kernels.extract import _check as _check_reads
from cornetto_tpu_torch.kernels.extract import extract_minima_ref
from cornetto_tpu_torch.kernels.minimizer import U32_MASK, as_u32

_KERNEL = "decide"
SLOTS = (4, 8, 16)          # bucket_slots an index may have (livefish.index)


def _lookup_votes(btable: torch.Tensor, bucket_shift: int,
                  q_hash: torch.Tensor, q_valid: torch.Tensor,
                  n_contigs: int, two_choice: bool, owner=None):
    """Fingerprinted bucket-table lookup + per-contig vote reduction
    (cornetto_tpu.livefish.decide._lookup_votes, which documents the row
    layout and the 9 planes).  ``two_choice`` must match how the index was
    built (MinimizerIndex.two_choice) and has no default.

    q_hash (b, M) int32 uint32 bit patterns, q_valid (b, M) bool.  Returns
    9 (b, C) int32 planes: votes, votes_un, nu_hi, nu_lo, votes_amb,
    a1_hi, a1_lo, a2_hi, a2_lo.

    ``owner`` = (ep, shard) makes this one shard's share of a table
    hash-sharded over ep (the extract-once sharded protocol,
    cornetto_tpu/livefish/decide.py:254-259): a query counts only where
    (hash & (ep - 1)) == shard, the hashes this shard owns, which also
    makes its fingerprint comparison exact.  The shards' planes summed are
    the planes of the whole table."""
    b, M = q_hash.shape
    dev = q_hash.device
    n_buckets = btable.shape[0]
    K = btable.shape[1] // 2
    log2b = int(n_buckets).bit_length() - 1
    q = as_u32(q_hash.reshape(-1))            # logical shifts on uint32
    if owner is not None:
        ep, shard = owner
        q_valid = q_valid & ((q & (ep - 1)) == shard).reshape(b, M)
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
    """Votes + decision from extracted minimizer hashes: ``_lookup_votes``
    then ``_policy_from_stats``.  Returns (decision (b,) int8 — 1 proceed /
    0 unblock, best_contig, est_pos, nhits, nhits_hq, est_pos2), each (b,)
    int32 but the decision."""
    stats9 = _lookup_votes(btable, bucket_shift, h, valid,
                           panel_mask.shape[0], two_choice)
    return _policy_from_stats(stats9, panel_mask, min_hits, bin_size)


def _policy_from_stats(stats9, panel_mask, min_hits: int, bin_size: int):
    """The policy on the 9 (b, C) int32 planes of ``_lookup_votes`` (summed
    over the shards on a sharded engine): best contig (the first maximum
    of the votes, as jnp.argmax), exact split-sum position means, panel
    test (cornetto_tpu/livefish/decide.py:268-296).  Returns the six (b,)
    outputs of ``_decide_from_minima``."""
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


def pack_fused(decision, best, est, nhits):
    """The (2, B) int32 readback: row 0 = decision<<30 | min(nhits,
    0x3FFF)<<16 | best & 0xFFFF, row 1 = est."""
    w0 = ((decision.to(torch.int32) << 30) | (nhits.clamp(max=0x3FFF) << 16)
          | (best & 0xFFFF))
    return torch.stack([w0, est])


def decide_packed_ref(btable, packed, nmask, panel_mask, L: int, k: int,
                      w: int, min_hits: int, bin_size: int,
                      bucket_shift: int, two_choice: bool, lengths=None,
                      fused: bool = False):
    """Plain PyTorch version of the kernel (same arguments and results as
    ``decide_packed``); runs on any device."""
    h, valid = extract_minima_ref(packed, nmask, L, k, w, lengths=lengths)
    out = _decide_from_minima(btable, h, valid, panel_mask, min_hits,
                              bin_size, bucket_shift, two_choice)
    if fused:
        d, b, e, nh, _, _ = out
        return pack_fused(d, b, e, nh)
    return out


def _check(btable, packed, nmask, panel_mask, L, k, w, bin_size, lengths):
    _check_reads(packed, nmask, L, k, w, lengths)
    dev = packed.device
    for name, t, dtype in (("btable", btable, torch.int32),
                           ("panel_mask", panel_mask, torch.bool)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2:
            raise ValueError("%s must be a 2-D tensor" % name)
        if t.device != dev:
            raise ValueError("%s is on %s, packed on %s"
                             % (name, t.device, dev))
        if t.dtype != dtype:
            raise TypeError("%s must be %s (got %s)" % (name, dtype, t.dtype))
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    nb, width = btable.shape
    if nb < 1 or nb & (nb - 1):
        raise ValueError("btable must have a power-of-two number of rows "
                         "(got %d)" % nb)
    if width // 2 not in SLOTS or width % 2:
        raise ValueError("btable rows must hold 2K int32 with K in %s "
                         "(got %d)" % (SLOTS, width))
    C, bins = panel_mask.shape
    if not 1 <= C < (1 << 16) or bins < 1:
        raise ValueError("panel_mask must be (C, bins) with 1 <= C < 65536 "
                         "and bins >= 1 (got %s)" % (tuple(panel_mask.shape),))
    if bin_size < 1:
        raise ValueError("bin_size must be >= 1 (got %d)" % bin_size)


def decide_packed(btable, packed, nmask, panel_mask, L: int, k: int, w: int,
                  min_hits: int, bin_size: int, bucket_shift: int,
                  two_choice: bool, lengths=None, fused: bool = False):
    """One decision step on 2-bit packed reads.

    btable (2^b, 2K) int32 bucket rows (livefish.index); packed (B,
    ceil(L/4)) uint8 (kernels.minimizer.pack_reads); nmask (B, ceil(L/8))
    uint8 N bitmap or None; lengths (B,) int32 read lengths or None (nmask
    wins when both are given; neither = N-free); panel_mask (C, bins) bool.
    Returns the six (B,) outputs of decision_core_packed (decision int8 —
    1 proceed / 0 unblock; best contig, est, nhits, nhits_hq, est2 int32),
    or with ``fused`` one (2, B) int32 tensor (``pack_fused``), equal bit
    for bit to the JAX package's decision_core_packed(_fused).

    A CUDA input launches the kernel on the current stream without
    synchronising and adds one to ``decide_packed.launches``."""
    _check(btable, packed, nmask, panel_mask, L, k, w, bin_size, lengths)
    args = dict(L=L, k=k, w=w, min_hits=min_hits, bin_size=bin_size,
                bucket_shift=bucket_shift, two_choice=two_choice,
                lengths=lengths, fused=fused)
    if packed.device.type == "cpu":
        return decide_packed_ref(btable, packed, nmask, panel_mask, **args)
    if packed.device.type != "cuda":
        raise ValueError("unsupported device %s" % packed.device)
    if btable.data_ptr() % 16:
        raise ValueError("btable must be 16-byte aligned")
    if nmask is not None:
        lengths = None
    B = packed.shape[0]
    dev = packed.device
    if fused:
        outs = [torch.empty((2, B), dtype=torch.int32, device=dev)]
        ptrs = [outs[0].data_ptr()] + [None] * 6
    else:
        outs = [torch.empty(B, dtype=torch.int8, device=dev)] + \
            [torch.empty(B, dtype=torch.int32, device=dev) for _ in range(5)]
        ptrs = [None] + [o.data_ptr() for o in outs]
    C, bins = panel_mask.shape
    fn = _build.bind(_KERNEL, "cornetto_decide_packed",
                     "ppppiipiiiiiiiiiipppppppp")
    _build.launch(fn, "decide kernel", dev, packed.data_ptr(),
                  None if nmask is None else nmask.data_ptr(),
                  None if lengths is None else lengths.data_ptr(),
                  btable.data_ptr(), btable.shape[0].bit_length() - 1,
                  btable.shape[1] // 2, panel_mask.data_ptr(), C, bins, B, L,
                  k, w, min_hits, bin_size, bucket_shift, int(two_choice),
                  *ptrs)
    decide_packed.launches += 1
    return outs[0] if fused else tuple(outs)


decide_packed.launches = 0
