"""ctypes binding for the native FASTQ->packed-batch parser, with a pure
Python fallback path (io.fasta.read_fastx + kernels.minimizer packing).

Yields device-ready batches: 2-bit packed codes + per-read lengths (+ the
N bitmap only when a read actually contains an interior non-ACGT base),
i.e. exactly the fast-path inputs of livefish.decide.decide_packed.
Handles plain and gzip/BGZF-compressed FASTQ (decompressed streamwise in
Python; the hot parse+encode+pack stays native).
"""

import ctypes
import zlib
from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np

from cornetto_tpu_torch import native

_lib = None
_init = False


def _get():
    global _lib, _init
    if not _init:
        _lib = native.load("fastq_pack", "fastq_pack.c")
        if _lib is not None:
            _lib.fq_pack_batch.restype = ctypes.c_long
            _lib.fq_pack_batch.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int]
        _init = True
    return _lib


@dataclass
class PackedBatch:
    packed: np.ndarray            # (B, ceil(L/4)) uint8
    nmask: Optional[np.ndarray]   # (B, ceil(L/8)) uint8, None if N-free
    lengths: np.ndarray           # (B,) int32
    count: int                    # valid rows
    # read ids as one compact blob + offsets (native tsv_format consumes
    # these directly; Python-string ids are decoded lazily on demand)
    id_blob: Optional[bytes] = None
    id_off: Optional[np.ndarray] = None   # (count,) int64 into id_blob
    id_len: Optional[np.ndarray] = None   # (count,) int32
    _ids: Optional[List[str]] = None

    @property
    def ids(self) -> List[str]:
        if self._ids is None:
            if self.id_blob is None:
                return []
            blob, off, ln = self.id_blob, self.id_off, self.id_len
            self._ids = [
                blob[int(off[i]):int(off[i]) + int(ln[i])].decode()
                for i in range(self.count)]
        return self._ids


class NativeParseError(Exception):
    """Input is not single-line FASTQ — use the tolerant Python parser."""


def _chunks(path: str, chunk: int) -> Iterator[bytes]:
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            d = zlib.decompressobj(wbits=47)   # gzip or BGZF members
            while True:
                raw = f.read(chunk)
                if not raw:
                    break
                out = d.decompress(raw)
                while d.unused_data:           # next concatenated member
                    tail = d.unused_data
                    d = zlib.decompressobj(wbits=47)
                    out += d.decompress(tail)
                if out:
                    yield out
            out = d.flush()
            if out:
                yield out
        else:
            while True:
                raw = f.read(chunk)
                if not raw:
                    break
                yield raw


def iter_packed_batches(path: str, batch: int, read_len: int,
                        chunk: int = 8 << 20) -> Iterator[PackedBatch]:
    """Stream device-ready packed batches off a FASTQ file via the native
    parser.  Raises NativeParseError if the kernel is unavailable or the
    input is not strict single-line FASTQ (caller falls back)."""
    lib = _get()
    if lib is None:
        raise NativeParseError("native kernel unavailable")
    L = read_len
    stride = -(-L // 4)
    nstride = -(-L // 8)
    packed = np.zeros((batch, stride), dtype=np.uint8)
    nmask = np.zeros((batch, nstride), dtype=np.uint8)
    lengths = np.zeros(batch, dtype=np.int32)
    name_off = np.zeros(batch, dtype=np.int64)
    name_len = np.zeros(batch, dtype=np.int32)
    cnt = ctypes.c_int(0)
    has_n = ctypes.c_int(0)

    def flush(buf: bytes, eof: bool):
        """Parse as many FULL batches as the buffer holds (partial batches
        are emitted only at EOF — mid-stream their records stay in the tail
        and re-parse with the next chunk); returns (tail, batches)."""
        base_ptr = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
        pos = 0
        n = len(buf)
        out = []
        while pos < n:
            consumed = lib.fq_pack_batch(
                base_ptr + pos, n - pos, L, batch,
                packed.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                stride,
                nmask.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                nstride,
                lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
                name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                ctypes.byref(cnt), ctypes.byref(has_n), int(eof))
            if consumed < 0:
                raise NativeParseError("not single-line FASTQ: %s" % path)
            c = cnt.value
            if c == 0:
                break
            if c < batch and not eof:
                break   # partial mid-stream: re-parse with the next chunk
            from cornetto_tpu_torch.native.tsv_format import compact_ids
            blob, ooff = compact_ids(buf, pos, name_off, name_len, c)
            out.append(PackedBatch(
                packed.copy(),
                nmask.copy() if has_n.value else None,
                lengths.copy(), c,
                id_blob=blob, id_off=ooff, id_len=name_len[:c].copy()))
            pos += consumed
        return buf[pos:], out

    tail = b""
    for blk in _chunks(path, chunk):
        buf = tail + blk if tail else blk
        tail, batches = flush(buf, eof=False)
        for pb in batches:
            yield pb
    if tail:
        tail, batches = flush(tail, eof=True)
        for pb in batches:
            yield pb
        if tail:
            raise NativeParseError("unparsed trailing bytes in %s" % path)
