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
