"""The read-until cell's runner: a sequencer of `channels` pores in a closed
loop over the program's live decision path (livefish/chunks.py
DeviceChunkEngine.process over SingleChipEngine.decide_chunk_tick), as
readfish runs it.

Set-up: the draft (draft.py), the program's own index build
(livefish/index.py build_index, build_panel_mask) and its upload
(SingleChipEngine), the read stream, and a warm-up of the tick's one shape
on a throwaway chunk engine.

The window: each tick hands every channel whose read is undecided its next
chunk (the read's next chunk_len bases), takes the decisions back, and moves
every read on by a chunk.  A decision other than proceed, or a proceed at
max_chunks, ends the read's decisions: an unblocked read leaves its channel
at once, any other runs to its end; a channel takes its next read as soon
as its read leaves.  Each chunk's latency is the time of the process() call
it was handed to (its decision comes back in that call).
"""

import contextlib
import json
import time

import numpy as np

from portbench import draft, harness
from portbench.reads import BLOCK, ReadStream, ReadText


class Sequencer:
    """The pores: which read each channel is on, how far it has got, and
    whether its decisions have ended; reads come from a ReadStream, their
    chunks' text from a ReadText."""

    def __init__(self, stream: ReadStream, text: ReadText, channels: int,
                 chunk_len: int, max_chunks: int):
        self.stream, self.text = stream, text
        self.chunk_len, self.max_chunks = chunk_len, max_chunks
        self.read = np.full(channels, -1, dtype=np.int64)
        self.off = np.zeros(channels, dtype=np.int64)
        self.length = np.zeros(channels, dtype=np.int64)
        self.sent = np.zeros(channels, dtype=np.int64)
        self.open = np.zeros(channels, dtype=bool)
        self.spec = [None] * channels       # (read id, parameters)
        self.next = 0
        self.undecided = 0          # reads still open after max_chunks
        # the reads' final decisions: (read, action, contig, chunks) rows,
        # in an array, so that a long window adds no objects to collect
        self.final = np.zeros((1 << 16, 4), dtype=np.int64)
        self.n_final = 0
        self._block = (-1, None)
        for c in range(channels):
            self._load(c)

    def _load(self, c: int) -> None:
        i = self.next
        self.next += 1
        b = i // BLOCK
        if self._block[0] != b:
            p = self.stream.block(b)
            self._block = (b, list(zip(*(p[f].tolist()
                                         for f in ReadStream.FIELDS))))
        read = self._block[1][i % BLOCK]
        self.spec[c] = ("r%d" % i, read)
        self.read[c] = i
        self.off[c] = 0
        self.sent[c] = 0
        self.length[c] = read[0]
        self.open[c] = True

    def chunks(self, event_cls):
        """This tick's chunk events (one a channel with an open read)."""
        out = []
        chunk, n = self.text.chunk, self.chunk_len
        for c in np.flatnonzero(self.open).tolist():
            rid, read = self.spec[c]
            out.append(event_cls(c, rid, chunk(read, int(self.off[c]), n)))
        self.sent[self.open] += 1
        return out

    def settle(self, decisions, proceed, unblock) -> None:
        """Apply a tick's decisions, move every read on by a chunk and
        replace the reads that left; final decisions go to self.final."""
        gone = []
        for d in decisions:
            c = d.channel
            if d.action == proceed and d.n_chunks < self.max_chunks:
                continue
            if self.n_final == len(self.final):
                self.final = np.concatenate([self.final,
                                             np.zeros_like(self.final)])
            self.final[self.n_final] = (self.read[c], d.action, d.contig,
                                        d.n_chunks)
            self.n_final += 1
            self.open[c] = False
            if d.action == unblock:
                gone.append(c)
        stuck = self.open & (self.sent >= self.max_chunks)
        self.undecided += int(stuck.sum())
        self.open &= ~stuck
        self.off += self.chunk_len
        ended = np.flatnonzero(self.off >= self.length).tolist()
        for c in sorted(set(gone) | set(ended)):
            self._load(c)


def inputs(cfg: dict, seed: int, device):
    """The draft's codes and contig starts, the planted repeat element and
    the panel rows."""
    codes, starts = draft.genome(cfg, seed, device)
    elem = draft.plant_repeats(cfg, seed, codes, starts)
    return codes, starts, elem, draft.panel_rows(cfg, seed)


def setup(run: harness.Run) -> dict:
    from cornetto_tpu_torch.livefish import chunks
    from cornetto_tpu_torch.livefish.decide import (DecisionParams,
                                                    SingleChipEngine)
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    cfg, mix, seed, dev = run.cfg, run.mix, run.seed, run.device
    ix, pol = cfg["index"], cfg["policy"]
    if mix["read_len"][0] < mix["chunk_len"] * pol["max_chunks"]:
        raise ValueError("reads shorter than max_chunks chunks")
    with run.part("draft"):
        codes, starts, elem, rows = inputs(cfg, seed, dev)
    with run.part("text"):
        text = ReadText(codes, elem)
    with run.part("index"):
        contigs = ((name, text.fwd[s:s + n])
                   for (name, n), s in zip(cfg["contigs"], starts))
        index = build_index(contigs, k=ix["k"], w=ix["w"],
                            repeat_cap=ix["repeat_cap"],
                            bucket_slots=ix["bucket_slots"],
                            max_overflow=ix["max_overflow"],
                            two_choice=ix["two_choice"], keep_tables=False)
        panel = build_panel_mask(index, rows, bin_size=pol["bin_size"])
    with run.part("upload"):
        engine = SingleChipEngine(
            index, panel, DecisionParams(min_hits=pol["min_hits"],
                                         bin_size=pol["bin_size"]),
            device=dev)
        run.counts["index_buckets"] = int(index.btable.shape[1])
        run.counts["index_dropped"] = float(index.dropped_frac)
        del index, panel

    def sequencer(stream_id):
        stream = ReadStream(cfg, mix, seed, starts, len(elem), rows,
                            stream_id)
        return Sequencer(stream, text, mix["channels"], mix["chunk_len"],
                         pol["max_chunks"])

    policy = chunks.ChunkPolicy(min_hits=pol["min_hits"],
                                max_chunks=pol["max_chunks"])

    def chunk_engine():
        return chunks.DeviceChunkEngine(engine, mix["channels"],
                                        mix["chunk_len"], policy,
                                        batch=mix["channels"])
    with run.part("traffic"):
        seq = sequencer(harness.READS)
    with run.part("warmup"):
        warm, ce = sequencer(harness.WARMUP), chunk_engine()
        for _ in range(mix["warmup_ticks"]):
            warm.settle(ce.process(warm.chunks(chunks.ChunkEvent)),
                        chunks.PROCEED, chunks.UNBLOCK)
        del warm, ce
    return dict(engine=engine, ce=chunk_engine(), seq=seq, chunks=chunks,
                codes=codes, starts=starts, elem=elem, rows=rows)


def window(run: harness.Run, st: dict) -> None:
    """The closed loop for run.seconds; a tick's latency is its process()
    call.  A traced run times its first half with the profiler off (the
    tick's times) and traces a second half as long."""
    chunks, ce, seq, trace = st["chunks"], st["ce"], st["seq"], run.trace
    lat, n_ev, ends, cpu = [], [], [], []
    by_chunks = np.zeros(seq.max_chunks + 1, dtype=np.int64)
    handed = answered = 0
    t0 = time.perf_counter()
    end = t0 + run.seconds
    split = t0 + run.seconds / 2 if run.trace_on else end
    untraced = None             # ticks timed before the trace began
    now = t0
    with contextlib.ExitStack() as traced, harness.HostMeter() as host:
        while now < end:
            if now >= split and untraced is None:
                # the profiler takes seconds to start: the traced half
                # runs its full length from when it has
                untraced = len(lat)
                by_chunks[:] = 0     # the rows of the traced ticks only
                traced.enter_context(trace.window())
                end = time.perf_counter() + run.seconds / 2
            with trace.span("sequencer"):
                events = seq.chunks(chunks.ChunkEvent)
                by_chunks += np.bincount(seq.sent[seq.open],
                                         minlength=seq.max_chunks + 1)
            with trace.span("process"):
                a = time.perf_counter()
                decisions = ce.process(events)
                now = time.perf_counter()
            lat.append(now - a)
            n_ev.append(len(events))
            ends.append(now - t0)
            cpu.append(time.thread_time())
            handed += len(events)
            answered += len(decisions)
            with trace.span("sequencer"):
                seq.settle(decisions, chunks.PROCEED, chunks.UNBLOCK)
        window_s = now - t0
    n = len(lat) if untraced is None else untraced
    lat, n_ev = np.array(lat), np.array(n_ev)
    run.attempted, run.failed = handed, handed - answered
    run.metrics["chunk_decisions_per_s"] = answered / window_s
    run.counts.update(window_s=window_s, ticks=len(lat), untraced_ticks=n,
                      decision_p95_ms=1e3 * harness.percentile(
                          lat[:n], n_ev[:n], 0.95),
                      tick_host_ms=1e3 * float(lat[:n].mean()),
                      decide_rows_by_chunks=by_chunks.tolist(),
                      reads_final=seq.n_final, reads_started=seq.next,
                      reads_undecided=seq.undecided, host=host.summary)
    st["final"] = seq.final[:seq.n_final]
    sec = np.minimum(np.array(ends).astype(np.int64),
                     max(int(window_s), 1) - 1)
    per = np.bincount(sec)
    busy = np.bincount(sec, weights=np.diff(np.array(cpu), prepend=cpu[0]))
    print("window: chunks decided a second %s; mean process() ms a second "
          "%s; main thread's share of a core a second %s; host %s" % (
              np.bincount(sec, weights=n_ev).astype(np.int64).tolist(),
              np.round(1e3 * np.bincount(sec, weights=lat)
                       / np.maximum(per, 1), 2).tolist(),
              np.round(busy / np.maximum(np.bincount(
                  sec, weights=np.diff(np.array(ends), prepend=0.0)),
                  1e-9), 3).tolist(), json.dumps(host.summary)),
          flush=True)


def release(st: dict) -> None:
    for key in ("ce", "engine", "seq"):
        st.pop(key, None)


def check(run: harness.Run, st: dict, control: bool = False) -> None:
    """The reference's decisions for a seeded sample of the reads decided
    in the window (with the reads decided latest among them) against the
    program's: action, contig and chunks consumed.  control: the
    reference's decisions on the control's narrower table (the
    configuration's control.narrower bits: it drops more entries than
    max_overflow allows) in the program's place."""
    from portbench.reference import readuntil as ref
    cfg, mix, seed = run.cfg, run.mix, run.seed
    final, pol, ck = st["final"], cfg["policy"], mix["check"]
    run.checks.append(("chunks_unanswered", run.failed, 0))
    run.checks.append(("reads_undecided", run.counts["reads_undecided"], 0))
    run.checks.append(("no_read_decided", int(len(final) == 0), 0))
    if not len(final):
        return
    rng = harness.rng(seed, harness.CHECK)
    pick = rng.choice(len(final), size=min(ck["sample"], len(final)),
                      replace=False)
    latest = np.flatnonzero(final[:, 3] == final[:, 3].max())[:ck["longest"]]
    got = final[np.union1d(pick, latest)]
    lens = [n for _, n in cfg["contigs"]]
    t0 = time.perf_counter()
    table = ref.build_table(st["codes"], st["starts"], lens, cfg["index"],
                            run.device)
    t1 = time.perf_counter()
    stream = ReadStream(cfg, mix, seed, st["starts"], len(st["elem"]),
                        st["rows"])
    lengths, heads = stream.reads(got[:, 0], st["codes"], st["elem"])
    panel = ref.panel_mask(cfg["contigs"], st["rows"], pol["bin_size"])

    def decide(tab):
        return ref.read_decisions(tab, heads, lengths, panel, len(lens),
                                  cfg["index"], pol, mix["chunk_len"],
                                  run.device)
    want = decide(table)
    if control:
        narrow = ref.build_table(st["codes"], st["starts"], lens,
                                 cfg["index"], run.device,
                                 cfg["control"]["narrower"])
        got = np.stack([got[:, 0], *decide(narrow)], axis=1)
        run.counts.update(control_dropped=narrow.dropped)
    off = ~((got[:, 1] == want[0]) & (got[:, 2] == want[1])
            & (got[:, 3] == want[2]))
    run.counts.update(ref_table_s=t1 - t0,
                      ref_decide_s=time.perf_counter() - t1,
                      checked_reads=len(got),
                      checked_later=int((got[:, 3] > 1).sum()),
                      ref_dropped=table.dropped, ref_entries=table.entries)
    run.checks.insert(0, ("reads_off", int(off.sum()), 0))
