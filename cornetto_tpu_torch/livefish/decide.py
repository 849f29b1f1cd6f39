"""Adaptive-sampling decision engine in PyTorch: counterpart of
cornetto_tpu/livefish/decide.py (single device).

One decision step on a batch of 2-bit packed reads:

1. minimizer extraction;
2. lookup of each minimizer hash in the fingerprinted bucket table and the
   9-plane per-contig vote reduction (``_lookup_votes``);
3. the policy: best contig, exact split-sum position mean, panel test
   (``_decide_from_minima``).

On a card the three are one CUDA kernel, one launch a batch
(kernels.decide.decide_packed); on the CPU its plain version runs them as
torch ops (kernels.decide.decide_packed_ref, where the three functions
live).

The engine has no weights; its state is the index's bucket table, the
panel mask and the static index parameters (``EngineState``).  Results stay
on the engine's device; the streaming loop reads them back.

The read-until chunk engine (livefish.chunks.DeviceChunkEngine) keeps each
channel's packed chunks on the device (``init_chunk_state``); a tick
(``decide_chunk_tick``, ``chunk_tick_core``) scatters the new chunks into
that buffer, gathers the prefixes to decide and runs the same fused step.
"""

from dataclasses import dataclass

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.kernels.decide import (  # noqa: F401 (re-exported)
    _decide_from_minima, _lookup_votes, _mean_split, decide_packed)
from cornetto_tpu_torch.kernels.minimizer import pack_reads
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


def decision_core_packed(btable, packed, nmask, panel_mask, L: int, k: int,
                         w: int, min_hits: int, bin_size: int,
                         bucket_shift: int, two_choice: bool,
                         lengths=None):
    """Decision step on 2-bit packed reads (device tensors): extraction,
    lookup, votes and policy, one kernel launch on a card
    (kernels.decide.decide_packed).  nmask None = N-free batch, optionally
    with per-read ``lengths``.  Returns the six (B,) outputs."""
    return decide_packed(btable, packed, nmask, panel_mask, L=L, k=k, w=w,
                         min_hits=min_hits, bin_size=bin_size,
                         bucket_shift=bucket_shift, two_choice=two_choice,
                         lengths=lengths)


def decision_core_packed_fused(btable, packed, nmask, panel_mask,
                               lengths=None, **kw):
    """decision_core_packed with the outputs the TSV needs packed into ONE
    (2, B) int32 tensor, one readback per batch:

    row 0 = decision<<30 | min(nhits, 0x3FFF)<<16 | best_contig
    row 1 = est position

    Decode on the host with ``unpack_fused``."""
    return decide_packed(btable, packed, nmask, panel_mask, lengths=lengths,
                         fused=True, **kw)


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
        the host and takes the packed path (one kernel launch on a
        card)."""
        packed, nmask = pack_reads(reads)
        return self.decide_packed(packed, nmask, reads.shape[1])

    def decide_packed(self, packed: np.ndarray, nmask, L: int,
                      lengths=None):
        """Packed input: nmask None for N-free batches, lengths (B,) int32
        for short reads.  Returns the 6 decision outputs.  One kernel
        launch on a card."""
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

    def init_chunk_state(self, n_channels: int, chunk_len: int,
                         max_chunks: int) -> torch.Tensor:
        """Allocate the packed chunk buffer of livefish.chunks.
        DeviceChunkEngine on the engine's device: (n_channels + 1,
        max_chunks, chunk_len // 4) uint8, row n_channels the scatter
        target of a batch's padding rows."""
        if chunk_len % 4:
            raise ValueError("chunk_len must pack to whole bytes (got %d)"
                             % chunk_len)
        return torch.zeros((n_channels + 1, max_chunks, chunk_len // 4),
                           dtype=torch.uint8, device=self.device)

    def decide_chunk_tick(self, buf, rows, s_chans, s_slots, d_chans,
                          lengths):
        """One tick of DeviceChunkEngine: upload this tick's new packed
        chunk rows (B, chunk_len // 4) uint8 and the four (B,) index
        vectors, scatter the rows into ``buf`` in place and decide the
        accumulated prefixes of d_chans (chunk_tick_core).  Returns (buf,
        fused (2, B) int32 on the device); decode fused with unpack_fused.

        The upload is one copy: the rows, the three index vectors (int64)
        and the lengths (int32) packed into one host buffer, pinned and
        copied without blocking when the device is a card."""
        B, nb = rows.shape
        off = -(-B * nb // 8) * 8               # int64 vectors 8-aligned
        host = np.empty(off + 28 * B, dtype=np.uint8)
        host[:B * nb] = np.ascontiguousarray(rows, dtype=np.uint8).reshape(-1)
        host[off:off + 24 * B].view(np.int64)[:] = np.concatenate(
            [s_chans, s_slots, d_chans])
        host[off + 24 * B:].view(np.int32)[:] = lengths
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        idx = t[off:off + 24 * B].view(torch.int64).view(3, B)
        st = self.state
        return chunk_tick_core(
            buf, st.btable, t[:B * nb].view(B, nb), idx[0], idx[1], idx[2],
            t[off + 24 * B:].view(torch.int32), st.panel,
            **self._kw(buf.shape[1] * buf.shape[2] * 4))


def chunk_tick_core(buf, btable, rows, s_chans, s_slots, d_chans, lengths,
                    panel_mask, **kw):
    """One read-until tick with the accumulated per-channel chunk state on
    the device (livefish.chunks.DeviceChunkEngine): the counterpart of
    cornetto_tpu/livefish/decide.py::chunk_tick_core.

    buf: (C+1, max_chunks, chunk_len//4) uint8, 2-bit packed chunk slots
    per channel, updated IN PLACE (the JAX program's ``.at[].set`` on a
    donated buffer); row C is the scatter target of pad rows and of
    channels with nothing new.  rows (B, chunk_len//4) uint8 and s_chans /
    s_slots (B,): this tick's new chunk bytes and where they land.  d_chans
    / lengths (B,): the channels to decide and their accumulated read
    lengths (int32), kept apart from the scatter targets because a
    pipelined channel can need a re-decision with no new chunk to write.

    Pad rows scatter many duplicates into row C, and PyTorch does not
    define which write wins for duplicate indices on a card.  That is
    harmless only because row C's decisions are dropped
    (livefish.chunks.ChunkDecisionEngine._resolve skips channel -1): a real
    channel lands in one (channel, slot) at most once a tick.

    Then the channels' prefixes are gathered into (B, max_chunks *
    chunk_len // 4) packed reads and decided by one call of the fused
    decision step (kernels.decide.decide_packed, fused=True: one kernel
    launch on a card); ``kw`` carries L = max_chunks * chunk_len and the
    index parameters.  An L the kernel cannot take raises there.  Returns
    (buf, fused (2, B) int32)."""
    buf[s_chans, s_slots] = rows
    g = buf.index_select(0, d_chans).reshape(d_chans.shape[0], -1)
    return buf, decision_core_packed_fused(btable, g, None, panel_mask,
                                           lengths=lengths, **kw)
