"""BAM reader + per-base depth, replacing the `samtools depth -aa` stage of
the reference protocol (reference: shitflow/create-launch.pbs.sh:66-67
generates the two coverage bedgraphs with `samtools depth -aa` /
`samtools depth -Q 20 -aa` piped through awk to 1-bp bedgraph rows).

Built on the BGZF block layer (io.bgzf): whole-file loads inflate blocks in
parallel, and `fetch(ref, beg, end)` uses the .bai index to touch only the
blocks containing the region — the working replacement for the reference's
dead htslib skeleton (src/depth_main.c:162-194 is commented out).

The reference repo ships test/example.bam but NOT the derived
test/cov-total.bg + test/cov-mq20.bg consumed by its golden tests
(reference: test/test.sh:25,29), so this module regenerates them
deterministically.  Validated end-to-end: feeding the regenerated bedgraphs
through the boringbits tool reproduces test/example_boring_t1.exp and
test/example_fun_t2.exp byte-for-byte.
"""

import os
import struct
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from cornetto_tpu_torch.io.bgzf import BaiIndex, BgzfFile, region_chunks

# CIGAR op codes
_CONSUME_REF = (0, 2, 3, 7, 8)   # M, D, N, =, X
_COVER_OPS = (0, 7, 8)           # M, =, X count toward depth
_FLAG_FILTER = 0x704             # UNMAP | SECONDARY | QCFAIL | DUP


@dataclass
class BamAlignment:
    ref_id: int
    pos: int
    mapq: int
    flag: int
    cigar: List[Tuple[int, int]]  # (op, length)

    @property
    def ref_len(self) -> int:
        return sum(ln for op, ln in self.cigar if op in _CONSUME_REF)


def _parse_records(data, off: int, stop: int) -> Iterator[BamAlignment]:
    n = min(len(data), stop)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        off += 4
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag,
         _l_seq, _nref, _npos, _tlen) = struct.unpack_from(
            "<iiBBHHHiiii", data, off)
        coff = off + 32 + l_read_name
        cigar = []
        for k in range(n_cigar):
            (cg,) = struct.unpack_from("<I", data, coff + 4 * k)
            cigar.append((cg & 0xF, cg >> 4))
        yield BamAlignment(ref_id, pos, mapq, flag, cigar)
        off += block_size


class BamFile:
    def __init__(self, path: str, nthreads: int = None):
        self.path = path
        self._bgzf = BgzfFile(path, nthreads=nthreads)
        self._data = None
        self._bai = None
        # header lives in the first block(s): inflate lazily until parsed
        hdr = b""
        nb = 0
        while nb < self._bgzf.n_blocks:
            hdr += self._bgzf.decompress_blocks(nb, nb + 1)
            nb += 1
            try:
                self._parse_header(hdr)
                break
            except struct.error:
                continue
        else:
            self._parse_header(hdr)   # raise cleanly on truncated files

    def _parse_header(self, data: bytes) -> None:
        if data[:4] != b"BAM\x01":
            raise ValueError("not a BAM file: %s" % self.path)
        off = 4
        (l_text,) = struct.unpack_from("<i", data, off)
        self.header_text = data[off + 4:off + 4 + l_text]
        off += 4 + l_text
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        names: List[str] = []
        lens: List[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", data, off)
            off += 4
            if off + l_name + 4 > len(data):
                # a block boundary split the ref list: need more blocks
                raise struct.error("truncated reference list")
            names.append(data[off:off + l_name - 1].decode())
            off += l_name
            (l_ref,) = struct.unpack_from("<i", data, off)
            off += 4
            lens.append(l_ref)
        self.ref_names = names
        self.ref_lens = lens
        self._aln_off = off

    def _all(self) -> bytes:
        if self._data is None:
            self._data = self._bgzf.decompress_all()
        return self._data

    def alignments(self) -> Iterator[BamAlignment]:
        data = self._all()
        return _parse_records(data, self._aln_off, len(data))

    # -- ranged access ----------------------------------------------------
    def _index(self) -> BaiIndex:
        if self._bai is None:
            for cand in (self.path + ".bai",
                         os.path.splitext(self.path)[0] + ".bai"):
                if os.path.exists(cand):
                    self._bai = BaiIndex(cand)
                    break
            else:
                raise FileNotFoundError("no .bai index next to %s"
                                        % self.path)
        return self._bai

    def has_index(self) -> bool:
        try:
            self._index()
            return True
        except FileNotFoundError:
            return False

    def fetch(self, ref, beg: int, end: int) -> Iterator[BamAlignment]:
        """Alignments overlapping [beg, end) on `ref` (name or id), via
        the BAI: only the named BGZF blocks are inflated."""
        ref_id = self.ref_names.index(ref) if isinstance(ref, str) else ref
        for vbeg, vend in region_chunks(self._index(), ref_id, beg, end):
            data = self._bgzf.read_voffset_range(vbeg, vend)
            for a in _parse_records(data, 0, len(data)):
                if a.ref_id != ref_id or a.pos >= end:
                    continue
                if a.pos + a.ref_len > beg:
                    yield a


# ---------------------------------------------------------------------------
# writing: BGZF-compressed BAM output + BAI indexing + sorted merge
# (the reference only ever READS alignments via its dead htslib skeleton;
# writing closes the loop for pipelines that re-emit them)
# ---------------------------------------------------------------------------

_SEQ_NIBBLE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_CIGAR_OPS = "MIDNSHP=X"


_SEQ_NIB = "=ACMGRSVTWYHKDBN"
_COMP_TAB = str.maketrans("ACGTN", "TGCAN")


def decode_read(payload: bytes):
    """Decode a raw record payload (as yielded by _iter_raw_records,
    without the leading block_size) into (name, flag, seq, qual_string) —
    the fields `samtools fastq` needs.  Reverse-strand records are
    reverse-complemented back to read orientation, as samtools fastq does.
    """
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", payload, 0)
    off = 32
    name = payload[off:off + l_read_name - 1].decode()
    off += l_read_name + 4 * n_cigar
    nib = payload[off:off + (l_seq + 1) // 2]
    seq = "".join(_SEQ_NIB[(nib[i // 2] >> (4 * (1 - i % 2))) & 0xF]
                  for i in range(l_seq))
    off += (l_seq + 1) // 2
    qraw = payload[off:off + l_seq]
    if qraw[:1] == b"\xff":
        qual = "I" * l_seq          # missing quality
    else:
        qual = "".join(chr(q + 33) for q in qraw)
    if flag & 0x10:                 # reverse strand -> read orientation
        seq = seq.translate(_COMP_TAB)[::-1]
        qual = qual[::-1]
    return name, flag, seq, qual


def iter_reads_fastq(path: str, nthreads: int = None):
    """Yields (name, flag, seq, qual) for every record of a BAM —
    the `samtools fastq` input side (works on unmapped/unsorted BAMs)."""
    bam = BamFile(path, nthreads=nthreads)
    data = bam._all()
    for payload, _rid, _pos, _end in _iter_raw_records(data, bam._aln_off):
        yield decode_read(payload)


def _iter_raw_records(data, off: int):
    """Yield (payload, ref_id, pos, ref_end) for every record; payload is
    the record bytes WITHOUT the leading block_size int32."""
    n = len(data)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, off)
        payload = data[off + 4:off + 4 + block_size]
        ref_id, pos = struct.unpack_from("<ii", data, off + 4)
        l_read_name = data[off + 12]
        (n_cigar,) = struct.unpack_from("<H", data, off + 16)
        coff = off + 4 + 32 + l_read_name
        rlen = 0
        for k in range(n_cigar):
            (cg,) = struct.unpack_from("<I", data, coff + 4 * k)
            if (cg & 0xF) in _CONSUME_REF:
                rlen += cg >> 4
        yield payload, ref_id, pos, pos + max(rlen, 1)
        off += 4 + block_size


def reg2bin(beg: int, end: int) -> int:
    """BAI bin for [beg, end) (SAM spec 6-level binning, min shift 14)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BaiBuilder:
    """Accumulates (ref, beg, end, vbeg, vend) spans into a .bai."""

    def __init__(self, n_ref: int):
        self._bins = [{} for _ in range(n_ref)]
        self._linear = [{} for _ in range(n_ref)]

    def add(self, ref_id: int, beg: int, end: int,
            vbeg: int, vend: int) -> None:
        if ref_id < 0:
            return
        chunks = self._bins[ref_id].setdefault(reg2bin(beg, end), [])
        # merge chunks that continue inside the same compressed block (the
        # htslib rule) — keeps bins compact for position-sorted input
        if chunks and (chunks[-1][1] >> 16) == (vbeg >> 16) \
                and chunks[-1][1] <= vbeg:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vbeg, vend))
        lin = self._linear[ref_id]
        for w in range(beg >> 14, ((end - 1) >> 14) + 1):
            if w not in lin or vbeg < lin[w]:
                lin[w] = vbeg
    def write(self, path: str) -> None:
        out = [b"BAI\x01", struct.pack("<i", len(self._bins))]
        for bmap, lin in zip(self._bins, self._linear):
            out.append(struct.pack("<i", len(bmap)))
            for bin_id in sorted(bmap):
                chunks = bmap[bin_id]
                out.append(struct.pack("<Ii", bin_id, len(chunks)))
                for cbeg, cend in chunks:
                    out.append(struct.pack("<QQ", cbeg, cend))
            n_intv = max(lin) + 1 if lin else 0
            ioff = [0] * n_intv
            for w, v in lin.items():
                ioff[w] = v
            # fill unset windows with the previous offset so linear-index
            # lookups lower-bound correctly inside gaps
            for i in range(1, n_intv):
                if ioff[i] == 0:
                    ioff[i] = ioff[i - 1]
            out.append(struct.pack("<i", n_intv))
            out.append(struct.pack("<%dQ" % n_intv, *ioff))
        with open(path, "wb") as f:
            f.write(b"".join(out))


class BamWriter:
    """BAM writer over the pipelined-deflate BGZF layer (io.bgzf), with
    optional on-the-fly BAI indexing for position-sorted output."""

    def __init__(self, path: str, ref_names, ref_lens, header_text=b"",
                 nthreads: int = None, level: int = 6,
                 build_index: bool = False):
        from cornetto_tpu_torch.io.bgzf import BgzfWriter
        if isinstance(header_text, str):
            header_text = header_text.encode()
        self.path = path
        self.ref_names = list(ref_names)
        self.ref_lens = list(ref_lens)
        self._w = BgzfWriter(path, nthreads=nthreads, level=level)
        hdr = [b"BAM\x01", struct.pack("<i", len(header_text)), header_text,
               struct.pack("<i", len(self.ref_names))]
        for name, ln in zip(self.ref_names, self.ref_lens):
            nm = name.encode() + b"\x00"
            hdr.append(struct.pack("<i", len(nm)))
            hdr.append(nm)
            hdr.append(struct.pack("<i", ln))
        self._w.write(b"".join(hdr))
        # header and alignments never share a block: ranged fetches then
        # always start at a record boundary
        self._w.flush()
        self._bai = BaiBuilder(len(self.ref_names)) if build_index else None

    def write_raw(self, payload: bytes, ref_id: int = None, pos: int = None,
                  ref_end: int = None) -> None:
        """Append one record (payload excludes the leading size int32)."""
        if self._bai is not None:
            if ref_id is None:
                ref_id, pos = struct.unpack_from("<ii", payload, 0)
            vbeg = self._w.tell()
        self._w.write(struct.pack("<i", len(payload)) + payload)
        if self._bai is not None and ref_id >= 0:
            if ref_end is None:
                ref_end = pos + 1
                l_read_name = payload[8]
                (n_cigar,) = struct.unpack_from("<H", payload, 12)
                coff = 32 + l_read_name
                rlen = 0
                for k in range(n_cigar):
                    (cg,) = struct.unpack_from("<I", payload, coff + 4 * k)
                    if (cg & 0xF) in _CONSUME_REF:
                        rlen += cg >> 4
                ref_end = pos + max(rlen, 1)
            self._bai.add(ref_id, pos, ref_end, vbeg, self._w.tell())

    def write_record(self, name: str, flag: int, ref_id: int, pos: int,
                     mapq: int, cigar, seq: str = "", qual=None,
                     next_ref_id: int = -1, next_pos: int = -1,
                     tlen: int = 0, tags: bytes = b"") -> None:
        """Encode one alignment from fields.  cigar: [(op, len)] with op as
        int code or one of 'MIDNSHP=X'; qual: bytes/list of phred values or
        None (missing, 0xFF-filled)."""
        cig = [(op if isinstance(op, int) else _CIGAR_OPS.index(op), ln)
               for op, ln in cigar]
        rname = name.encode() + b"\x00"
        l_seq = len(seq)
        nib = bytearray((l_seq + 1) // 2)
        for i, c in enumerate(seq.upper()):
            v = _SEQ_NIBBLE.get(c, 15)
            nib[i // 2] |= v << (4 if i % 2 == 0 else 0)
        if qual is None:
            q = b"\xff" * l_seq
        else:
            q = bytes(qual)
        end = pos + max(sum(ln for op, ln in cig if op in _CONSUME_REF), 1)
        payload = b"".join((
            struct.pack("<iiBBHHHiiii", ref_id, pos, len(rname), mapq,
                        reg2bin(pos, end) if ref_id >= 0 else 0,
                        len(cig), flag, l_seq, next_ref_id, next_pos, tlen),
            rname,
            b"".join(struct.pack("<I", (ln << 4) | op) for op, ln in cig),
            bytes(nib), q, tags))
        self.write_raw(payload, ref_id, pos, end)

    def close(self) -> None:
        self._w.close()
        if self._bai is not None:
            self._bai.write(self.path + ".bai")
            self._bai = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_bai(bam: BamFile, out_path: str = None) -> None:
    """Index an existing position-sorted BAM: walk records in the
    decompressed stream, map their spans back to virtual offsets via the
    BGZF block table, and emit the .bai."""
    out_path = out_path or bam.path + ".bai"
    data = bam._all()
    ucum = bam._bgzf.ucum
    coffs = bam._bgzf.coffs
    nb = len(coffs)

    def voff(u: int) -> int:
        i = min(int(np.searchsorted(ucum, u, side="right")) - 1, nb - 1)
        return (int(coffs[i]) << 16) | (u - int(ucum[i]))

    bai = BaiBuilder(len(bam.ref_names))
    off = bam._aln_off
    for payload, ref_id, pos, ref_end in _iter_raw_records(data, off):
        bai.add(ref_id, pos, ref_end, voff(off), voff(off + 4 + len(payload)))
        off += 4 + len(payload)
    bai.write(out_path)


def merge_sorted_bams(paths, out_path: str, nthreads: int = None,
                      build_index: bool = True) -> None:
    """K-way merge of position-sorted BAMs sharing a reference set into one
    sorted BAM (+.bai), the `samtools merge` step of multi-flowcell runs.
    Unmapped (ref_id<0) records sort last, as samtools orders them."""
    import heapq
    bams = [BamFile(p, nthreads=nthreads) for p in paths]
    first = bams[0]
    for b in bams[1:]:
        if b.ref_names != first.ref_names or b.ref_lens != first.ref_lens:
            raise ValueError("reference sets differ: %s vs %s"
                             % (paths[0], b.path))

    def keyed(b, src):
        for payload, ref_id, pos, ref_end in _iter_raw_records(
                b._all(), b._aln_off):
            k = (ref_id if ref_id >= 0 else len(b.ref_names), pos)
            yield k, src, payload, ref_id, pos, ref_end

    with BamWriter(out_path, first.ref_names, first.ref_lens,
                   header_text=first.header_text, nthreads=nthreads,
                   build_index=build_index) as w:
        for k, src, payload, ref_id, pos, ref_end in heapq.merge(
                *[keyed(b, i) for i, b in enumerate(bams)],
                key=lambda t: (t[0], t[1])):
            w.write_raw(payload, ref_id, pos, ref_end)


def _add_alignment(d: np.ndarray, a: BamAlignment,
                   include_dels: bool) -> None:
    rpos = a.pos
    for op, ln in a.cigar:
        if op in _COVER_OPS or (include_dels and op == 2):
            d[rpos:rpos + ln] += 1
        if op in _CONSUME_REF:
            rpos += ln


def _keep(a: BamAlignment, min_mapq: int) -> bool:
    return not (a.flag & _FLAG_FILTER) and a.mapq >= min_mapq \
        and a.ref_id >= 0


def depth_arrays(bam: BamFile, min_mapq: int = 0,
                 include_dels: bool = False) -> List[np.ndarray]:
    """Per-reference depth as `samtools depth` computes it: excludes
    unmapped/secondary/qcfail/duplicate reads, counts aligned bases
    (M/=/X ops; D too when include_dels)."""
    depth = [np.zeros(l, dtype=np.int64) for l in bam.ref_lens]
    for a in bam.alignments():
        if _keep(a, min_mapq):
            _add_alignment(depth[a.ref_id], a, include_dels)
    return depth


def depth_region(bam: BamFile, ref, beg: int, end: int, min_mapq: int = 0,
                 include_dels: bool = False) -> np.ndarray:
    """Depth over [beg, end) of `ref` only, via the BAI (falls back to a
    full scan when no index exists).  Returns an (end-beg,) int64 array."""
    ref_id = bam.ref_names.index(ref) if isinstance(ref, str) else ref
    end = min(end, bam.ref_lens[ref_id])
    pad = np.zeros(end - beg, dtype=np.int64)
    if bam.has_index():
        it = bam.fetch(ref_id, beg, end)
    else:
        it = (a for a in bam.alignments() if a.ref_id == ref_id
              and a.pos < end and a.pos + a.ref_len > beg)
    full = np.zeros(bam.ref_lens[ref_id], dtype=np.int64)
    for a in it:
        if _keep(a, min_mapq):
            _add_alignment(full, a, include_dels)
    pad[:] = full[beg:end]
    return pad


def write_depth_bedgraph(bam: BamFile, out_path: str, min_mapq: int = 0,
                         include_dels: bool = False,
                         ref_order: List[str] = None) -> None:
    """Write the awk-converted `samtools depth -aa` bedgraph
    (chrom, pos-1, pos, depth rows for every base of every reference)."""
    from cornetto_tpu_torch.native import depth_write as dw
    depth = depth_arrays(bam, min_mapq=min_mapq, include_dels=include_dels)
    order = range(len(bam.ref_names))
    if ref_order is not None:
        name_to_i = {n: i for i, n in enumerate(bam.ref_names)}
        order = [name_to_i[n] for n in ref_order]
    open(out_path, "w").close()   # truncate; rows append per contig
    for i in order:
        dw.write_rows(out_path, bam.ref_names[i], depth[i],
                      mode=dw.PER_BASE_BEDGRAPH, append=True)
