"""Streaming FASTQ -> decision TSV loop for the PyTorch engine:
counterpart of cornetto_tpu/livefish/stream.py.

The host stages are copies of the JAX package's (the native parse+pack
kernel, Prefetcher, _RowWriter's native TSV formatter, the Python
fallback's batching and row format).  What differs is the readback: the
engine returns tensors on its device, and the drain side copies them to
the host with ``.cpu()``.  Dispatch and drain threads both use the
device's default stream, so the copy is ordered after the step that made
the result, and a result tensor stays referenced in the queue until it has
been read back.
"""

import itertools
import queue
import sys
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from cornetto_tpu_torch.io.fasta import read_fastx
from cornetto_tpu_torch.kernels.minimizer import encode_seq, pack_reads
from cornetto_tpu_torch.livefish.decide import unpack_fused


@dataclass
class ReadBatch:
    ids: List[str]
    codes: np.ndarray   # (B, L) uint8, padded with 4 (N)
    count: int          # valid rows
    lengths: np.ndarray = None   # (B,) int32 true read lengths


def batches_from_fastq(path: str, batch: int, read_len: int
                       ) -> Iterator[ReadBatch]:
    """Pack the first `read_len` bases of each read (the adaptive-sampling
    chunk) into fixed (batch, read_len) blocks."""
    ids: List[str] = []
    codes = np.full((batch, read_len), 4, dtype=np.uint8)
    lens = np.zeros(batch, dtype=np.int32)
    n = 0
    for rec in read_fastx(path):
        c = encode_seq(rec.seq[:read_len])
        codes[n, :len(c)] = c
        lens[n] = len(c)
        ids.append(rec.name)
        n += 1
        if n == batch:
            yield ReadBatch(ids, codes, n, lens)
            ids = []
            codes = np.full((batch, read_len), 4, dtype=np.uint8)
            lens = np.zeros(batch, dtype=np.int32)
            n = 0
    if n:
        yield ReadBatch(ids, codes, n, lens)


class Prefetcher:
    """Producer thread + bounded queue so host packing overlaps device
    compute."""

    _DONE = object()

    def __init__(self, it: Iterator[ReadBatch], depth: int = 4):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._fill, args=(it,),
                                        daemon=True)
        self._err: Optional[BaseException] = None
        self._thread.start()

    def _fill(self, it):
        try:
            for b in it:
                self._q.put(b)
        except BaseException as e:  # propagate to consumer
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                if self._err is not None:
                    raise self._err
                return
            yield item


class _RowWriter:
    """FIFO formatting+writing thread: keeps TSV formatting off the device
    dispatch thread.  Batches carrying a compact id blob format natively
    (tsv_format.c releases the GIL, ~10M rows/s); others take the Python
    row loop (byte-identical output, tested)."""

    _DONE = object()

    def __init__(self, out, names):
        from cornetto_tpu_torch.native import tsv_format as _tf
        self._out = out
        self._names = names
        self._tf = _tf if _tf.available() else None
        self._ntable = _tf.NameTable(names) if self._tf else None
        self._q: "queue.Queue" = queue.Queue(maxsize=8)
        self.total = self.accepted = 0
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def put(self, pb, arrs) -> None:
        if self._err is not None:
            raise self._err
        self._q.put((pb, arrs))

    def _run(self):
        try:
            while True:
                item = self._q.get()
                if item is self._DONE:
                    return
                pb, arrs = item
                d, best, est, nhits = arrs[:4]
                if self._tf is not None and \
                        getattr(pb, "id_blob", None) is not None:
                    data, acc = self._tf.format_batch(
                        pb.id_blob, pb.id_off, pb.id_len,
                        d, best, est, nhits, self._ntable, pb.count)
                    self._out.write(data.decode("ascii"))
                    self.accepted += acc
                    self.total += pb.count
                    continue
                names = self._names
                rows = []
                for i in range(pb.count):
                    ctg = (names[best[i]] if names is not None
                           else str(int(best[i])))
                    rows.append("%s\t%s\t%s\t%d\t%d\n"
                                % (pb.ids[i],
                                   "proceed" if d[i] else "unblock",
                                   ctg if nhits[i] > 0 else ".",
                                   int(est[i]), int(nhits[i])))
                    self.accepted += int(d[i])
                self._out.write("".join(rows))
                self.total += pb.count
        except BaseException as e:
            self._err = e

    def close(self):
        self._q.put(self._DONE)
        self._t.join()
        if self._err is not None:
            raise self._err


def _to_host(t) -> np.ndarray:
    return t.cpu().numpy()


def _readback(entry):
    pb, res = entry
    if isinstance(res, tuple):
        return pb, tuple(_to_host(x) for x in res[:4])
    return pb, unpack_fused(_to_host(res))     # fused (2, B) int32


def stream_decisions(engine, fastq_path: str, batch: int = 4096,
                     read_len: int = 450, out=None) -> Tuple[int, int]:
    """Run the decision engine over a FASTQ, writing
    `read_id\\tdecision\\tcontig\\tpos\\tnhits` rows; returns (n_reads,
    n_accepted).  Single-line FASTQ takes the native parse+pack path;
    anything else (FASTA, multi-line records, no C toolchain) the tolerant
    Python path — as cornetto_tpu.livefish.stream.stream_decisions."""
    out = out or sys.stdout
    from cornetto_tpu_torch.native.fastq_pack import (NativeParseError,
                                                      iter_packed_batches)
    gen = iter_packed_batches(fastq_path, batch, read_len)
    try:
        # probe the first batch before any output: a non-FASTQ file falls
        # back cleanly; a parse error later is a hard error
        first = next(gen, None)
    except NativeParseError:
        return _stream_decisions_py(engine, fastq_path, batch, read_len, out)
    if first is None:
        return 0, 0
    return _stream_decisions_native(engine, first, gen, read_len, out)


def _stream_decisions_native(engine, first, gen, read_len: int,
                             out) -> Tuple[int, int]:
    """Prefetcher thread parses+packs, this thread uploads and enqueues the
    device step, a drain thread reads results back, the _RowWriter thread
    formats TSV natively."""
    writer = _RowWriter(out, engine.contig_names)
    dq: "queue.Queue" = queue.Queue(maxsize=4)
    _DONE = object()
    drain_err: List[BaseException] = []

    def _drain_loop():
        while True:
            item = dq.get()
            if item is _DONE:
                return
            if drain_err:
                continue        # swallow queue to unblock the producer
            try:
                writer.put(*_readback(item))
            except BaseException as e:
                drain_err.append(e)

    drain = threading.Thread(target=_drain_loop, daemon=True)
    drain.start()
    try:
        for pb in Prefetcher(itertools.chain([first], gen)):
            if pb.nmask is None:
                lens = pb.lengths
                if lens is not None and bool(
                        np.all(lens[:pb.count] == read_len)):
                    # all chunks full length: skip the lengths upload; pad
                    # rows beyond count decide garbage that is never written
                    lens = None
                res = engine.decide_packed_fused(pb.packed, None, read_len,
                                                 lengths=lens)
            else:
                # interior Ns: bitmap path, with the length bound folded
                # into the bitmap (pad positions are packed as code 0)
                nm = pb.nmask.copy()
                pos = np.arange(nm.shape[1] * 8, dtype=np.int32)
                pad = (pos[None, :] >= pb.lengths[:, None])
                nm |= np.packbits(pad, axis=1,
                                  bitorder="little")[:, :nm.shape[1]]
                res = engine.decide_packed_fused(pb.packed, nm, read_len)
            dq.put((pb, res))
            if drain_err:
                break
    finally:
        dq.put(_DONE)
        drain.join()
        writer.close()
    if drain_err:
        raise drain_err[0]
    return writer.total, writer.accepted


def _stream_decisions_py(engine, fastq_path: str, batch: int,
                         read_len: int, out) -> Tuple[int, int]:
    """Tolerant Python parse path, one batch in flight behind the one being
    written."""
    total = accepted = 0
    pending = None
    for rb in Prefetcher(batches_from_fastq(fastq_path, batch, read_len)):
        packed, nmask = pack_reads(rb.codes)
        # the N bitmap goes up only when a read has an interior N; pad-to-
        # batch tails are covered by per-read lengths
        if not _has_interior_n(rb):
            res = engine.decide_packed(packed, None, read_len,
                                       lengths=rb.lengths)
        else:
            res = engine.decide_packed(packed, nmask, read_len)
        if pending is not None:
            total, accepted = _drain_host(pending, out, total, accepted,
                                          engine)
        pending = (rb, res)
    if pending is not None:
        total, accepted = _drain_host(pending, out, total, accepted, engine)
    return total, accepted


def _drain_host(entry, out, total, accepted, engine):
    rb, res = _readback(entry)
    return _drain(rb, res, out, total, accepted, engine)


def _has_interior_n(rb: ReadBatch) -> bool:
    pos = np.arange(rb.codes.shape[1], dtype=np.int32)
    within = pos[None, :] < rb.lengths[:, None]
    return bool(np.any((rb.codes >= 4) & within))


def _drain(rb: ReadBatch, res, out, total, accepted, engine):
    d, best, est, nhits = (np.asarray(x) for x in res[:4])
    names = getattr(engine, "contig_names", None)
    for i in range(rb.count):
        ctg = (names[best[i]] if names is not None else str(int(best[i])))
        out.write("%s\t%s\t%s\t%d\t%d\n"
                  % (rb.ids[i],
                     "proceed" if d[i] else "unblock",
                     ctg if nhits[i] > 0 else ".",
                     int(est[i]), int(nhits[i])))
        total += 1
        accepted += int(d[i])
    return total, accepted
