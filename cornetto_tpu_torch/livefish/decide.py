"""Adaptive-sampling decision engine in PyTorch: counterpart of
cornetto_tpu/livefish/decide.py, on one device (``SingleChipEngine``) and
sharded over a (dp, ep) mesh of processes (``make_sharded_engine``).

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

The sharded engine keeps the JAX package's extract-once protocol: each
rank extracts the minimizers of its own rows, the ep group all-gathers
them, each rank looks up the hashes its shard of the table owns
(kernels.votes.sharded_votes), one reduce-scatter sums the nine vote
planes back to the rows' owners, the policy runs there
(kernels.votes.policy_from_stats) and one all-gather gives every rank the
whole batch's outputs.  With one shard (ep = 1) nothing is summed across
shards: the rank's rows go through the single-device fused step
(kernels.decide.decide_packed, one launch), with no gather, planes or
reduce-scatter.
"""

from dataclasses import dataclass

import numpy as np
import torch

from cornetto_tpu_torch.device import resolve_device
from cornetto_tpu_torch.dist import collectives
from cornetto_tpu_torch.dist.multihost import local_device
from cornetto_tpu_torch.kernels.decide import (  # noqa: F401 (re-exported)
    _decide_from_minima, _lookup_votes, _mean_split, decide_packed,
    pack_fused)
from cornetto_tpu_torch.kernels.extract import extract_minima
from cornetto_tpu_torch.kernels.minimizer import pack_codes, pack_reads
from cornetto_tpu_torch.kernels.votes import policy_from_stats, sharded_votes
from cornetto_tpu_torch.livefish.index import MinimizerIndex
from cornetto_tpu_torch.utils import profiling


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
    return shard_state(index, 0, panel_mask, device)


def shard_state(index: MinimizerIndex, shard: int, panel_mask: np.ndarray,
                device) -> EngineState:
    """Shard ``shard`` of an index's table, its panel mask and parameters
    on ``device``."""
    if panel_mask.shape[0] >= (1 << 16):
        # the fused readback packs best_contig into 16 bits
        raise ValueError("too many contigs for the fused readback")
    device = torch.device(device)
    return EngineState(
        btable=torch.from_numpy(np.ascontiguousarray(
            index.btable[shard], dtype=np.int32)).to(device),
        panel=torch.from_numpy(np.ascontiguousarray(
            panel_mask, dtype=bool)).to(device),
        k=int(index.k), w=int(index.w),
        bucket_shift=int(index.bucket_shift),
        two_choice=bool(getattr(index, "two_choice", False)))


def decision_core(btable, reads, panel_mask, k: int, w: int, min_hits: int,
                  bin_size: int, bucket_shift: int, two_choice: bool = True):
    """Decision step on unpacked reads: (b, L) uint8 codes (4 = N), packed
    on their own device (kernels.minimizer.pack_codes), then
    ``decision_core_packed``.  Returns the six (b,) outputs: decision,
    best contig, est position, hits, unambiguous hits and the second
    position estimate.  The JAX function's ep_axis / ep_size (a shard of
    the table inside shard_map) are the sharded engine's here."""
    packed, nmask = pack_codes(reads)
    return decision_core_packed(btable, packed, nmask, panel_mask,
                                L=reads.shape[1], k=k, w=w,
                                min_hits=min_hits, bin_size=bin_size,
                                bucket_shift=bucket_shift,
                                two_choice=two_choice)


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
        copied without blocking when the device is a card: the span
        ``decide.upload`` under a profiler."""
        B, nb = rows.shape
        off = -(-B * nb // 8) * 8               # int64 vectors 8-aligned
        with profiling.span("decide.upload"):
            host = np.empty(off + 28 * B, dtype=np.uint8)
            host[:B * nb] = np.ascontiguousarray(
                rows, dtype=np.uint8).reshape(-1)
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
    (the chunk engines' _resolve, livefish.chunks, skips channel -1): a real
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


class ShardedEngine:
    """The decision step sharded over a (dp, ep) mesh of processes
    (make_sharded_engine).  Every rank of the mesh calls it with the same
    global batch and gets the whole batch's six outputs on its device."""

    def __init__(self, mesh, index: MinimizerIndex, panel_mask: np.ndarray,
                 params: DecisionParams = DecisionParams()):
        self.ep = mesh.shape["ep"]
        assert index.n_shards == self.ep, (index.n_shards, self.ep)
        self.mesh = mesh
        self.shard = mesh.index("ep")
        # rows are split over both axes, dp-major (P(("dp", "ep")))
        self.block = mesh.index("dp") * self.ep + self.shard
        self.n_blocks = mesh.shape["dp"] * self.ep
        self.device = local_device()
        # this rank's shard of the table only
        self.state = shard_state(index, self.shard, panel_mask, self.device)
        self.params = params

    def __call__(self, reads: np.ndarray):
        return self.decide(reads)

    def decide(self, reads: np.ndarray):
        """(B, L) uint8 codes (4 = N), B divisible by dp * ep -> the six
        (B,) decision outputs.  Packs this rank's rows on the host."""
        B, L = reads.shape
        self._check(B)
        packed, nmask = pack_reads(self._block_of(reads))
        return self.step(self._put(packed), self._put(nmask), None, L)

    def decide_packed(self, packed: np.ndarray, nmask, L: int,
                      lengths=None):
        """Packed input (kernels.minimizer.pack_reads): nmask None for
        N-free batches, lengths (B,) int32 for short reads (nmask wins when
        both are given).  Uploads only this rank's rows."""
        return self.step(*self.upload(packed, nmask, lengths), L)

    def decide_packed_fused(self, packed: np.ndarray, nmask, L: int,
                            lengths=None):
        """decide_packed with the TSV outputs in one (2, B) int32 tensor,
        as SingleChipEngine.decide_packed_fused: kernels.decide.pack_fused
        of the step's first four outputs (nhits clamped at 0x3FFF)."""
        d, best, est, nhits, _, _ = self.decide_packed(packed, nmask, L,
                                                       lengths)
        return pack_fused(d, best, est, nhits)

    def upload(self, packed: np.ndarray, nmask, lengths=None):
        """This rank's rows of a global packed batch, on its device:
        (packed, nmask or None, lengths or None), the lengths dropped when
        there is an N bitmap."""
        B = packed.shape[0]
        self._check(B)
        pick = lambda a: None if a is None else self._put(  # noqa: E731
            self._block_of(a))
        nm = pick(nmask)
        return pick(packed), nm, None if nm is not None else pick(lengths)

    def _check(self, B: int):
        if B % self.n_blocks:
            raise ValueError("batch of %d rows: must be divisible by dp * ep "
                             "= %d" % (B, self.n_blocks))

    def _block_of(self, a: np.ndarray) -> np.ndarray:
        b = a.shape[0] // self.n_blocks
        return a[self.block * b:(self.block + 1) * b]

    def _put(self, a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(self.device)

    def step(self, packed, nmask, lengths, L: int, mark=None):
        """The sharded step on this rank's rows (device tensors): returns
        the whole batch's six outputs.  ``mark``, when given, is called with
        each stage's name as the stage is issued: "extract", "gather",
        "votes", "reduce", "policy", "outputs"."""
        mark = mark or (lambda name: None)
        st, p = self.state, self.params
        if self.ep == 1:
            # one shard holds the whole table: the fused single-device step
            # (one launch, no planes) times under "votes"; the other marks
            # time nothing
            mark("extract")
            mark("gather")
            outs = decide_packed(st.btable, packed, nmask, st.panel, L,
                                 st.k, st.w, p.min_hits, p.bin_size,
                                 st.bucket_shift, st.two_choice,
                                 lengths=lengths)
            mark("votes")
            mark("reduce")
            mark("policy")
            return self._gather_outputs(outs, mark)
        C = st.panel.shape[0]
        h, valid = extract_minima(packed, nmask, L, st.k, st.w,
                                  lengths=lengths)
        mark("extract")
        # the hashes and the valid flags in one all-gather: b rows of 4 M
        # hash bytes and M flag bytes
        b, M = h.shape
        ep_group = self.mesh.groups["ep"]
        both = collectives.all_gather(
            torch.cat([h.view(torch.uint8), valid.view(torch.uint8)], dim=1),
            ep_group)
        h_all = both[:, :4 * M].contiguous().view(torch.int32)
        valid_all = both[:, 4 * M:].contiguous().view(torch.bool)
        mark("gather")
        planes = sharded_votes(h_all, valid_all, st.btable, st.bucket_shift,
                               st.two_choice, self.ep, self.shard, C,
                               parts=self.ep)
        mark("votes")
        stats = collectives.reduce_scatter_sum(planes, ep_group)
        mark("reduce")
        outs = policy_from_stats(stats, st.panel, p.min_hits, p.bin_size)
        mark("policy")
        return self._gather_outputs(outs, mark)

    def _gather_outputs(self, outs, mark):
        """The rank's six (b,) outputs all-gathered over the mesh into the
        whole batch's."""
        b = outs[0].shape[0]
        six = collectives.all_gather(
            torch.stack([o.to(torch.int32) for o in outs]), self.mesh.group)
        six = six.view(self.n_blocks, 6, b).transpose(0, 1).reshape(6, -1)
        mark("outputs")
        return (six[0].to(torch.int8),) + tuple(six[1:].unbind(0))


def make_sharded_engine(mesh, index: MinimizerIndex, panel_mask: np.ndarray,
                        params: DecisionParams = DecisionParams()
                        ) -> ShardedEngine:
    """The decision step over a ("dp", "ep") mesh (dist.mesh.make_mesh) of
    processes: counterpart of cornetto_tpu/livefish/decide.py::
    make_sharded_engine.

    The returned engine takes reads (B, L) uint8 (``engine(reads)`` or
    ``engine.decide``) or packed reads (``engine.decide_packed(packed,
    nmask, L, lengths=None)``, or ``decide_packed_fused`` for the (2, B)
    form), B divisible by dp * ep, the same global
    batch on every rank of the mesh; each rank uploads and extracts only
    its own block of rows (block dp_idx * ep + ep_idx, the row order of
    P(("dp", "ep"))) and holds only its shard of the table,
    index.btable[ep_idx] (index.n_shards must equal ep), on its device
    (dist.multihost.local_device).  Every rank gets
    the whole batch's six outputs, as the JAX callable returns one global
    array, so the chunk engine (livefish.chunks) and any caller written for
    SingleChipEngine run unchanged on every rank.

    At ep > 1 a step launches the extraction kernel, the votes kernel and
    the policy kernel once each, and runs three collectives: an all-gather
    of the minimizers over ep, a reduce-scatter of the int32 vote planes
    over ep (sums wrap as JAX's psum_scatter does), an all-gather of the
    outputs over the mesh.  At ep = 1 nothing is summed across shards: a
    step launches the fused single-device step (kernels.decide.
    decide_packed, no planes) and runs the outputs' all-gather alone."""
    if not mesh.member:
        raise ValueError("this rank is outside the mesh")
    return ShardedEngine(mesh, index, panel_mask, params)
