"""Iterative chunk-by-chunk adaptive-sampling decisions (read-until): the
PyTorch port's copy of cornetto_tpu/livefish/chunks.py.

The reference protocol hands live decisions to readfish, whose operating
model is: the sequencer surfaces each in-progress read as a growing series
of ~1 s basecalled chunks per channel, and the controller answers every
chunk with one of three actions (reference: docs/protocol.md:137-161 and
the readfish TOML it configures):

  - ``unblock``         — eject the read (it maps into the boring panel);
  - ``stop_receiving``  — keep sequencing but stop streaming chunks
                          (decision made: the read is wanted);
  - ``proceed``         — no confident mapping yet, wait for more data.

This module supplies that per-channel state machine on top of the batch
decision engine (livefish.decide.SingleChipEngine): every tick gathers the
accumulated prefixes of all channels with fresh data into ONE fixed-shape
packed batch — one launch of the fused decision kernel per batch on a card
(kernels.decide.decide_packed), however many channels fired — and
host-side state is plain numpy per-channel arrays.  The engine's results
are tensors on its device; each batch's (2, B) result is read back once,
when the batch is resolved.
"""

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from cornetto_tpu_torch.kernels.minimizer import (encode_bytes, encode_seq,
                                                  pack_2bit, pack_reads)
from cornetto_tpu_torch.livefish.decide import unpack_fused
from cornetto_tpu_torch.utils import profiling

# actions
PROCEED = 0
UNBLOCK = 1
STOP_RECEIVING = 2
ACTION_NAMES = {PROCEED: "proceed", UNBLOCK: "unblock",
                STOP_RECEIVING: "stop_receiving"}


@dataclass
class ChunkPolicy:
    """readfish-equivalent control knobs."""
    min_hits: int = 3           # confidence threshold (engine min_hits)
    max_chunks: int = 4         # give up deciding after this many chunks
    # what to do with a still-unmapped read at max_chunks: readfish's
    # "no_map" conditions — proceed (leave it alone) or unblock
    no_map_action: int = PROCEED


@dataclass
class ChunkEvent:
    """One basecalled chunk from one channel."""
    channel: int
    read_id: str
    seq: str                    # the NEW bases of this chunk only


@dataclass
class ChunkDecision:
    channel: int
    read_id: str
    action: int
    n_chunks: int               # chunks consumed to reach this decision
    contig: int = -1
    pos: int = -1
    nhits: int = 0


class _ChunkEngine:
    """The per-channel read-until state machine the two chunk engines
    share: the policy, each channel's accumulated length, chunk count, read
    id and done flag, the batches in flight, ``process``, ``drain`` and
    ``_resolve``.  A subclass stages a tick's events (``_stage``) and
    launches each batch (``_submit``), which appends (channels, fused
    result, chunk counts, read ids) to ``_inflight``.

    engine: SingleChipEngine or ShardedEngine (livefish.decide), whose
    fused result, (2, B) int32 (decision_core_packed_fused), is read back
    once a batch.  It clamps nhits at 0x3FFF; a prefix of max_len bases has
    at most (max_len - k + 1) // w windows, so the clamp binds only past
    ~163,000 bases at w = 10.  batch is the fixed device batch per tick
    (one kernel launch); channels beyond it queue to the next tick.
    max_len = chunk_len * policy.max_chunks bounds the accumulated prefix
    re-decided each tick.
    """

    def __init__(self, engine, n_channels: int, chunk_len: int,
                 policy: ChunkPolicy = ChunkPolicy(), batch: int = 512,
                 pipeline_depth: int = 0):
        self.engine = engine
        self.policy = policy
        self.chunk_len = chunk_len
        self.batch = batch
        self.max_len = chunk_len * policy.max_chunks
        # pipeline_depth device batches stay in flight before the host
        # blocks on a readback: kernel launches are asynchronous, so at
        # depth >= 1 the host returns before the card has decided and
        # decisions surface up to `depth` ticks later.  This hides decide
        # latency when the host multiplexes other work between ticks
        # (coverage folding, IO); in an offline replay it instead ADDS work
        # (lagged channels keep re-deciding), so the default stays 0
        # (decide synchronously every tick).
        self.pipeline_depth = pipeline_depth
        self._inflight: List[tuple] = []
        C = self.n_channels = n_channels
        self._blen = np.zeros(C, dtype=np.int64)
        self._chunks = np.zeros(C, dtype=np.int64)
        self._read_id: List[str] = [""] * C
        self._done = np.zeros(C, dtype=bool)   # decision already emitted

    def process(self, events: Sequence[ChunkEvent]) -> List[ChunkDecision]:
        """Consume one tick's chunks, return decisions for every event
        (channels whose read is already decided get their standing action
        STOP_RECEIVING silently skipped — readfish stops receiving chunks
        for them, so emitting nothing is the faithful behavior).

        Under a profiler the tick is the span ``chunks.process``, tiled by
        ``chunks.stage`` (the events staged; DeviceChunkEngine counts
        ``events`` handed in and the ``runs`` of distinct channels they were
        cut into), ``chunks.submit`` (a batch's launch; counts ``rows``
        launched and ``live`` rows that decide a channel),
        ``chunks.readback`` (the host waiting on the card and the result's
        copy) and ``chunks.resolve`` (the decisions built)."""
        with profiling.span("chunks.process"):
            with profiling.span("chunks.stage") as sp:
                batches = self._stage(events, sp)
            for batch in batches:
                self._submit(*batch)
            out: List[ChunkDecision] = []
            while len(self._inflight) > self.pipeline_depth:
                out.extend(self._resolve(self._inflight.pop(0)))
        return out

    def drain(self) -> List[ChunkDecision]:
        """Resolve every in-flight batch (end of run / idle tick)."""
        out: List[ChunkDecision] = []
        while self._inflight:
            out.extend(self._resolve(self._inflight.pop(0)))
        return out

    def _resolve(self, entry) -> List[ChunkDecision]:
        chans, res, chunks_at, rids = entry
        with profiling.span("chunks.readback"):
            d, best, est, nhits = unpack_fused(_host(res))
        out: List[ChunkDecision] = []
        with profiling.span("chunks.resolve"):
            for i, c in enumerate(chans):
                if c < 0:
                    continue   # scatter-only row (device engine duplicates)
                if self._read_id[c] != rids[i] or self._done[c]:
                    continue   # read gone or decided by an older batch
                mapped = int(nhits[i]) >= self.policy.min_hits
                if mapped:
                    action = UNBLOCK if d[i] == 0 else STOP_RECEIVING
                elif chunks_at[i] >= self.policy.max_chunks:
                    action = self.policy.no_map_action
                    if action == PROCEED:
                        # terminal proceed: stop re-deciding, let it run out
                        self._done[c] = True
                else:
                    action = PROCEED
                if action != PROCEED:
                    self._done[c] = True
                out.append(ChunkDecision(
                    channel=c, read_id=rids[i], action=action,
                    n_chunks=int(chunks_at[i]),
                    contig=int(best[i]) if mapped else -1,
                    pos=int(est[i]) if mapped else -1,
                    nhits=int(nhits[i])))
        return out


class ChunkDecisionEngine(_ChunkEngine):
    """The chunk engine with the accumulated prefixes on the host: each
    tick packs every pending channel's whole (max_len) prefix, N codes
    included, and decides it with the engine's decide_packed_fused."""

    def __init__(self, engine, n_channels: int, chunk_len: int,
                 policy: ChunkPolicy = ChunkPolicy(), batch: int = 512,
                 pipeline_depth: int = 0):
        super().__init__(engine, n_channels, chunk_len, policy, batch,
                         pipeline_depth)
        self._buf = np.full((n_channels, self.max_len), 4, dtype=np.uint8)

    def _reset_channel(self, c: int, read_id: str) -> None:
        self._buf[c] = 4
        self._blen[c] = 0
        self._chunks[c] = 0
        self._read_id[c] = read_id
        self._done[c] = False

    def _stage(self, events: Sequence[ChunkEvent], sp) -> List[tuple]:
        """The event loop: each event's codes into its channel's buffer;
        returns the arguments of each batch's _submit.  sp: the span
        chunks.stage, for counts."""
        pending: List[int] = []
        for ev in events:
            c = ev.channel
            if ev.read_id != self._read_id[c]:
                self._reset_channel(c, ev.read_id)
            if self._done[c]:
                continue
            codes = encode_seq(ev.seq)
            n = int(self._blen[c])
            take = min(len(codes), self.max_len - n)
            if take > 0:
                self._buf[c, n:n + take] = codes[:take]
                self._blen[c] = n + take
            self._chunks[c] += 1
            pending.append(c)
        return [(pending[i:i + self.batch],)
                for i in range(0, len(pending), self.batch)]

    def _submit(self, chans: List[int]) -> None:
        with profiling.span("chunks.submit", rows=self.batch,
                            live=len(chans)):
            rows = np.full((self.batch, self.max_len), 4, dtype=np.uint8)
            rows[:len(chans)] = self._buf[chans]
            packed, nmask = pack_reads(rows)
            res = self.engine.decide_packed_fused(packed, nmask,
                                                  self.max_len)
            # snapshot read ids + chunk counts: by the time this batch is
            # harvested the channel may have moved on to a new read
            # (decision arrives too late — dropped, as on a real
            # sequencer) or received more chunks (decision still valid for
            # its prefix)
            self._inflight.append((list(chans), res,
                                   self._chunks[chans].copy(),
                                   [self._read_id[c] for c in chans]))


class DeviceChunkEngine(_ChunkEngine):
    """Read-until state machine with the accumulated per-channel prefixes
    resident ON DEVICE.

    ChunkDecisionEngine re-uploads every pending channel's FULL
    accumulated prefix each tick: max_len/4 packed bytes per channel per
    tick.  Here the device holds a (C+1, max_chunks, chunk_len/4)
    2-bit-packed buffer and each tick ships only the NEW chunk (chunk_len/4
    bytes + 28 B of indices/lengths per channel) — up to max_chunks x fewer
    uploaded bytes — then the scatter, the prefix gather and the fused
    decision kernel run on the card (decide.chunk_tick_core), with a single
    (2, B) fused readback.

    Decisions are bit-identical to ChunkDecisionEngine (the per-read
    lengths mask reproduces the host padding exactly; tested).

    Constraints (both are the sequencer operating model, asserted here):
    - chunk_len % 4 == 0 (the engine's init_chunk_state refuses another)
      and chunks arrive as fixed chunk_len-sized pieces, except a read's
      final piece which may be shorter;
    - chunks are pure ACGT (the basecaller norm): 2-bit chunk slots
      cannot carry N.  Use ChunkDecisionEngine for N-containing input.
    """

    def __init__(self, engine, n_channels: int, chunk_len: int,
                 policy: ChunkPolicy = ChunkPolicy(), batch: int = 512,
                 pipeline_depth: int = 0):
        super().__init__(engine, n_channels, chunk_len, policy, batch,
                         pipeline_depth)
        self._dev_buf = engine.init_chunk_state(n_channels, chunk_len,
                                                policy.max_chunks)
        self._pad_chan = n_channels          # sacrificial scatter row

    def _stage(self, events: Sequence[ChunkEvent], sp) -> List[tuple]:
        """The call's events as arrays, in their order; returns the
        arguments of each batch's _submit.  A call in which a channel
        repeats (out of the sequencer's one-chunk-a-tick model, but it must
        not diverge from the host engine) is cut into consecutive runs of
        distinct channels, each staged in turn by _stage_run; sp (the span
        chunks.stage) counts the ``events`` and the ``runs``."""
        chans = [ev.channel for ev in events]
        rids = [ev.read_id for ev in events]
        seqs = [ev.seq for ev in events]
        runs = _distinct_runs(chans)
        if profiling.recording():
            sp.count(events=len(events), runs=len(runs))
        parts = [self._stage_run(chans[a:b], rids[a:b], seqs[a:b])
                 for a, b in runs]
        if not parts:
            return []
        ch, codes, sc, slots, lengths, chunks_at = (
            x[0] if len(x) == 1 else np.concatenate(x)
            for x in zip(*(p[:6] for p in parts)))
        ids = [r for p in parts for r in p[6]]
        if len(parts) > 1:
            # One decision per channel per call, at its FINAL accumulated
            # prefix -- matching the host engine, whose _submit reads the
            # accumulated buffer after the whole event loop: a channel's
            # non-final entries keep their SCATTER but decide the pad row,
            # and _resolve skips them (channel -1).  The final entry sits
            # in the last batch, so every earlier scatter has landed by
            # then.  (Within one run every entry is its channel's last.)
            last = np.zeros(len(ch), dtype=bool)
            last[len(ch) - 1 - np.unique(ch[::-1], return_index=True)[1]] \
                = True
            ch = np.where(last, ch, -1)
            chunks_at = np.where(last, chunks_at, 0)
            for i in np.flatnonzero(~last).tolist():
                ids[i] = ""
        B = self.batch
        return [(ch[i:i + B], codes[i:i + B], sc[i:i + B], slots[i:i + B],
                 lengths[i:i + B], chunks_at[i:i + B], ids[i:i + B])
                for i in range(0, len(ch), B)]

    def _stage_run(self, chans: List[int], rids: List[str],
                   seqs: List[str]) -> tuple:
        """Stage events on distinct channels: the read-id resets, one
        encode of every kept chunk (a decided channel's is skipped), the
        input checks, then the channels' lengths and chunk counts.  Nothing
        is written when a check fails.  Returns, for the kept events in
        order: the channels, the codes (a chunk_len row each), the scatter
        channels and slots, the post-write lengths, the chunk counts and
        the read ids.  seqs is the caller's own list: short pieces are
        padded in it."""
        L = self.chunk_len
        c = np.array(chans, dtype=np.int64)
        ids = self._read_id
        reset = np.array([r != ids[x] for x, r in zip(chans, rids)],
                         dtype=bool)
        keep = reset | ~self._done[c]
        if not keep.all():
            kept = np.flatnonzero(keep).tolist()
            c, reset = c[keep], reset[keep]
            rids, seqs = [rids[i] for i in kept], [seqs[i] for i in kept]
        n = np.where(reset, 0, self._blen[c])
        lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
        for i in np.flatnonzero(lens != L).tolist():
            # a read's final piece, padded with code 0 (the host engine's
            # zero padding); a piece too long, cut (it raises below)
            seqs[i] = seqs[i][:L].ljust(L, "A")
        codes = encode_bytes("".join(seqs).encode("latin-1")).reshape(-1, L)
        acgt = codes.max(axis=1) < 4
        bad = (lens > L) | ~acgt | (n % L != 0)
        if bad.any():
            i = int(np.argmax(bad))
            if lens[i] > L:
                raise ValueError(
                    "chunk of %d bases on channel %d exceeds chunk_len=%d"
                    % (lens[i], c[i], L))
            if not acgt[i]:
                raise ValueError(
                    "non-ACGT base in chunk on channel %d: the on-device "
                    "2-bit state cannot carry N (use ChunkDecisionEngine)"
                    % c[i])
            raise ValueError(
                "channel %d got a new chunk after a short piece "
                "(accumulated %d bases): short chunks must be final"
                % (c[i], n[i]))
        # a new read: no device buffer to clear, the previous read's stale
        # chunk slots are masked out by the per-read lengths
        for i in np.flatnonzero(reset).tolist():
            ids[c[i]] = rids[i]
        self._done[c[reset]] = False
        # the whole chunk or nothing: lengths stay multiples of chunk_len
        # until a short final piece, and max_len is max_chunks of them; a
        # full buffer (a pipelined channel awaiting its decision) or an
        # empty chunk writes nothing and still re-decides
        write = (lens > 0) & (n < self.max_len)
        blen = n + np.where(write, lens, 0)
        chunks = np.where(reset, 0, self._chunks[c]) + 1
        self._blen[c] = blen
        self._chunks[c] = chunks
        codes[~write] = 0
        return (c, codes, np.where(write, c, self._pad_chan),
                np.where(write, n // L, 0), blen, chunks, rids)

    def _submit(self, chans, codes, s_chans, slots, lengths, chunks_at,
                rids) -> None:
        """Launch one batch of _stage's: its first len(chans) rows are the
        staged events', the rest zero rows that scatter into and decide
        the pad row."""
        B, k, pad = self.batch, len(chans), self._pad_chan
        with profiling.span("chunks.submit", rows=B) as sp:
            packed = np.zeros((B, self.chunk_len // 4), dtype=np.uint8)
            packed[:k] = pack_2bit(codes)
            sc = np.full(B, pad, dtype=np.int32)
            sc[:k] = s_chans
            sl = np.zeros(B, dtype=np.int32)
            sl[:k] = slots
            dc = np.full(B, pad, dtype=np.int32)
            dc[:k] = np.where(chans >= 0, chans, pad)
            ln = np.zeros(B, dtype=np.int32)
            ln[:k] = lengths
            if profiling.recording():
                sp.count(live=np.count_nonzero(chans >= 0))
            self._dev_buf, fused = self.engine.decide_chunk_tick(
                self._dev_buf, packed, sc, sl, dc, ln)
            self._inflight.append((chans.tolist(), fused, chunks_at, rids))


# ---------------------------------------------------------------------------
# read-until replay simulation (the test/benchmark harness the reference
# lacks: it validates the control loop end-to-end without a sequencer)
# ---------------------------------------------------------------------------

@dataclass
class ReplayMetrics:
    n_reads: int = 0
    n_unblocked: int = 0
    n_stop_receiving: int = 0
    n_no_decision: int = 0
    bases_sequenced: int = 0            # with adaptive sampling
    bases_without_as: int = 0           # counterfactual: full reads
    mean_decision_chunks: float = 0.0
    true_reject: int = 0                # unblocked AND truly panel-origin
    false_reject: int = 0               # unblocked but NOT panel-origin


def replay_read_until(engine: _ChunkEngine,
                      reads: Sequence[Tuple[str, str, bool]],
                      unblock_overhead: int = 500) -> ReplayMetrics:
    """Replay full reads through the chunk engine as a sequencer would.

    reads: (read_id, full_sequence, is_panel_origin) triples.
    Channels are recycled: a new read starts on a channel as soon as the
    previous one finishes (unblocked early or sequenced to the end).
    unblock_overhead: bases already sequenced by the time an unblock takes
    effect (pore traversal + basecall latency), charged to every unblock.
    """
    C = engine.n_channels
    chunk_len = engine.chunk_len
    m = ReplayMetrics()
    queue = deque(reads)
    # (read_id, seq, panel, next_offset, decided_action)
    active: Dict[int, list] = {}
    decision_chunks: List[int] = []

    def load(c: int):
        if queue:
            rid, seq, panel = queue.popleft()
            active[c] = [rid, seq, panel, 0, None]
        elif c in active:
            del active[c]

    for c in range(min(C, len(queue))):
        load(c)
    while active:
        events = []
        for c, st in list(active.items()):
            rid, seq, panel, off, decided = st
            if decided is None and off < len(seq):
                events.append(ChunkEvent(c, rid,
                                         seq[off:off + chunk_len]))
            st[3] = off + chunk_len
        decs = engine.process(events)
        if not events:
            # nothing new this tick: block on whatever is still in flight
            # so lagging decisions can land before their reads run out
            decs += engine.drain()
        for dec in decs:
            st = active.get(dec.channel)
            if st is None or st[0] != dec.read_id:
                continue
            if dec.action == UNBLOCK:
                m.n_unblocked += 1
                if st[2]:
                    m.true_reject += 1
                else:
                    m.false_reject += 1
                sequenced = min(len(st[1]),
                                dec.n_chunks * chunk_len + unblock_overhead)
                m.bases_sequenced += sequenced
                m.bases_without_as += len(st[1])
                m.n_reads += 1
                decision_chunks.append(dec.n_chunks)
                load(dec.channel)
            elif dec.action == STOP_RECEIVING:
                m.n_stop_receiving += 1
                st[4] = STOP_RECEIVING
                decision_chunks.append(dec.n_chunks)
        # finish reads that ran to their end (stop_receiving or undecided)
        for c, st in list(active.items()):
            rid, seq, panel, off, decided = st
            if off >= len(seq):
                if decided is None:
                    m.n_no_decision += 1
                m.bases_sequenced += len(seq)
                m.bases_without_as += len(seq)
                m.n_reads += 1
                load(c)
    engine.drain()   # late decisions have no read left to act on
    if decision_chunks:
        m.mean_decision_chunks = float(np.mean(decision_chunks))
    return m


def _distinct_runs(chans: List[int]) -> List[Tuple[int, int]]:
    """The [start, end) bounds of consecutive runs of ``chans`` in which no
    channel repeats, each as long as it can be."""
    if len(set(chans)) == len(chans):
        return [(0, len(chans))] if chans else []
    runs, seen, a = [], set(), 0
    for i, c in enumerate(chans):
        if c in seen:
            runs.append((a, i))
            seen, a = set(), i
        seen.add(c)
    runs.append((a, len(chans)))
    return runs


def _host(x) -> np.ndarray:
    """A result as a host numpy array: a tensor is read back (one copy from
    the card), an array is taken as it is."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)
