"""Aligner-free coverage estimation on the PyTorch engine: counterpart of
cornetto_tpu/livefish/coverage.py, whose docstring states the contract
(bin resolution, the unambiguous-hit MQ>=20 proxy, repeat-only reads split
across both stored copies).

The tally is a (2, C, bins) int32 tensor [total, hq] on
device.resolve_device(), the engine's default device; every decided batch
scatter-adds its read lengths into it with ``index_put_(...,
accumulate=True)`` (integer atomics on a card, so the order does not
matter and the sums are exact).  ``CoverageParams`` and the bedgraph
writer are copies of the JAX module's host code.
"""

from dataclasses import dataclass

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device

__all__ = ["CoverageParams", "CoverageTally", "stream_coverage"]


@dataclass
class CoverageParams:
    bin_size: int = 1000
    min_hits: int = 3       # mapped (total-coverage track)
    hq_hits: int = 8        # high-confidence (the MQ>=20 track proxy)


class CoverageTally:
    """Device-resident (2, C, BINS) int32 base tallies [total, hq]."""

    def __init__(self, index, params: CoverageParams = CoverageParams()):
        self.params = params
        self.device = resolve_device()
        self.contig_names = list(index.contig_names)
        self.contig_lens = np.asarray(index.contig_lens, dtype=np.int64)
        C = len(self.contig_names)
        bins = int(-(-int(self.contig_lens.max()) // params.bin_size)) \
            if C else 1
        bins = max(-(-bins // 128) * 128, 128)
        self._tally = torch.zeros((2, C, bins), dtype=torch.int32,
                                  device=self.device)

    def update(self, best, est, est2, nhits, nhits_hq, lengths) -> None:
        """Fold one decided batch in (tensors on the engine's device plus
        per-read true lengths as numpy; rows not in the batch must have
        length 0)."""
        p = self.params
        top = self._tally.shape[2] - 1
        ln = torch.from_numpy(np.ascontiguousarray(
            lengths, dtype=np.int32)).to(self.device)
        b1 = torch.div(est, p.bin_size, rounding_mode="floor").clamp(0, top)
        b2 = torch.div(est2, p.bin_size, rounding_mode="floor").clamp(0, top)
        mapped = nhits >= p.min_hits
        hq = nhits_hq >= p.hq_hits
        # repeat-only reads (no unambiguous anchor -> est2 != est) split
        # their bases across both stored copies
        split = mapped & (b2 != b1)
        zero = torch.zeros_like(ln)
        w1 = torch.where(mapped, torch.where(split, ln - ln // 2, ln), zero)
        w2 = torch.where(split, ln // 2, zero)
        best, b1, b2 = best.long(), b1.long(), b2.long()
        total, high = self._tally[0], self._tally[1]
        total.index_put_((best, b1), w1, accumulate=True)
        total.index_put_((best, b2), w2, accumulate=True)
        high.index_put_((best, b1), torch.where(hq, ln, zero),
                        accumulate=True)

    def counts(self) -> np.ndarray:
        return self._tally.cpu().numpy()

    def write_bedgraphs(self, total_path: str, mq_path: str) -> None:
        """Emit cov-total / cov-mq20 style bedgraphs (1-bp-resolution rows
        are what boringbits expects; we emit bin-sized rows, which the
        bedgraph reader expands identically)."""
        t = self.counts()
        bs = self.params.bin_size
        for track, path in ((t[0], total_path), (t[1], mq_path)):
            with open(path, "w") as out:
                for ci, name in enumerate(self.contig_names):
                    ln = int(self.contig_lens[ci])
                    nb = -(-ln // bs)
                    depth = track[ci, :nb] // bs
                    # run-length encode equal-depth neighbouring bins
                    st = 0
                    for b in range(1, nb + 1):
                        if b == nb or depth[b] != depth[st]:
                            out.write("%s\t%d\t%d\t%d\n"
                                      % (name, st * bs, min(b * bs, ln),
                                         int(depth[st])))
                            st = b


def stream_coverage(engine, tally: CoverageTally, fastq_path: str,
                    batch: int = 4096, read_len: int = 450, out=None):
    """Run streaming decisions over a FASTQ while folding every batch into
    the coverage tally; one batch stays in flight behind the one being read
    back.  Returns (n_reads, n_accepted)."""
    from cornetto_tpu_torch.kernels.minimizer import pack_reads
    from cornetto_tpu_torch.livefish.stream import (Prefetcher, _drain_host,
                                                    _has_interior_n,
                                                    batches_from_fastq)
    total = accepted = 0
    pending = None

    def _settle(entry, total, accepted):
        if out is not None:
            return _drain_host(entry, out, total, accepted, engine)
        rb, res = entry
        dd = res[0].cpu().numpy()
        return total + rb.count, accepted + int(dd[:rb.count].sum())

    for rb in Prefetcher(batches_from_fastq(fastq_path, batch, read_len)):
        packed, nmask = pack_reads(rb.codes)
        if rb.lengths is not None and not _has_interior_n(rb):
            res = engine.decide_packed(packed, None, read_len,
                                       lengths=rb.lengths)
        else:
            res = engine.decide_packed(packed, nmask, read_len)
        d, best, est, nhits, nhits_hq, est2 = res
        lens = rb.lengths if rb.lengths is not None else \
            np.full(rb.codes.shape[0], read_len, np.int32)
        lens = lens.copy()
        lens[rb.count:] = 0
        tally.update(best, est, est2, nhits, nhits_hq, lens)
        if pending is not None:
            total, accepted = _settle(pending, total, accepted)
        pending = (rb, res)
    if pending is not None:
        total, accepted = _settle(pending, total, accepted)
    return total, accepted
