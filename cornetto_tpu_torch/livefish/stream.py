"""Streaming FASTQ -> decision TSV loop for the PyTorch engine:
counterpart of cornetto_tpu/livefish/stream.py.

The host stages are shared with the JAX package (the native parse+pack
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
from typing import List, Tuple

import numpy as np

from cornetto_tpu.kernels.minimizer import pack_reads
from cornetto_tpu.livefish.decide import unpack_fused
from cornetto_tpu.livefish.stream import (Prefetcher, _drain, _has_interior_n,
                                          _RowWriter, batches_from_fastq)


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
    from cornetto_tpu.native.fastq_pack import (NativeParseError,
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
