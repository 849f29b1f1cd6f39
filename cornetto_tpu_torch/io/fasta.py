"""FASTA/FASTQ streaming reader with kseq-equivalent record semantics
(reference: src/kseq.h — name is up to the first whitespace, the rest of the
header line is the comment, sequence lines are concatenated; works on plain
or gzip-compressed files)."""

import gzip
from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional


def open_maybe_gzip(path: str, mode: str = "rt"):
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, mode)
    return open(path, mode)


@dataclass
class FastxRecord:
    name: str
    comment: Optional[str]
    seq: str
    qual: Optional[str] = None

    def __len__(self) -> int:
        return len(self.seq)


class FastaBytes(NamedTuple):
    """A FASTA record as bytes (read_fasta): the name, the comment (None
    where the header has none) and the sequence; squeezed is whether the
    sequence took a second copy to drop the line ends inside it."""
    name: bytes
    comment: Optional[bytes]
    seq: bytes
    squeezed: bool


CHUNK = 32 << 20     # bytes a read of the FASTA reader asks for


def read_fastx(path: str) -> Iterator[FastxRecord]:
    """Stream records from a FASTA or FASTQ file (auto-detected per record
    by its '>' / '@' header, like kseq).  Plain FASTA is read_fasta's
    records decoded; FASTQ streams line-by-line."""
    with open_maybe_gzip(path, "rb") as fp:
        first = fp.read(1)
        if not first:
            return
        if first == b">":
            for r in _fasta_records(fp):
                yield FastxRecord(
                    r.name.decode("latin-1"),
                    None if r.comment is None else r.comment.decode("latin-1"),
                    r.seq.decode("latin-1"), None)
        else:
            import io as _io
            import itertools
            text = _io.TextIOWrapper(fp, encoding="latin-1")
            yield from parse_fastx(
                itertools.chain([first.decode("latin-1") + text.readline()],
                                text))


def read_fasta(path: str) -> Iterator[FastaBytes]:
    """read_fastx's records as bytes, for callers that want the sequence's
    bytes and no str.  A plain-FASTA file (first byte '>') streams through
    one buffer that holds about a record and one read: a record's sequence
    leaves it as one bytes copy, and as a second, squeezed one only where a
    line end lies inside it (a multi-line or CRLF body; a one-line body's
    own line end is not inside it).  Any other file takes read_fastx's line
    parser, whose records count as squeezed."""
    with open_maybe_gzip(path, "rb") as fp:
        if fp.read(1) == b">":
            yield from _fasta_records(fp)
            return
    for r in read_fastx(path):
        yield FastaBytes(
            r.name.encode("latin-1"),
            None if r.comment is None else r.comment.encode("latin-1"),
            r.seq.encode("latin-1"), True)


def timed_reads(recs: Iterator[FastaBytes], lap,
                stats: dict = None) -> Iterator[FastaBytes]:
    """The records of ``recs`` (read_fasta's), each read inside ``lap()``
    (a utils.profiling.lap), whose span counts it as ``records`` and, where
    it was squeezed, as ``squeezed``; so does ``stats`` where given."""
    acc = {} if stats is None else stats
    while True:
        with lap() as span:
            rec = next(recs, None)
            if rec is not None:
                span.count(records=1, squeezed=int(rec.squeezed))
        if rec is None:
            return
        acc["records"] = acc.get("records", 0) + 1
        acc["squeezed"] = acc.get("squeezed", 0) + int(rec.squeezed)
        yield rec


def _fasta_records(fp) -> Iterator[FastaBytes]:
    """The records of a binary stream positioned after the first '>'.  A
    record ends at a '\\n>' whose '>' is not the stream's last byte (so a
    '>' that ends the file stays in the last sequence, as the JAX package's
    reader has it).  A record's '\\n's are found by memchr ('\\n' alone)
    until one inside the body shows it multi-line, and then by the slower
    two-byte search for '\\n>'.  Peak memory: the largest record and one
    read."""
    buf = bytearray()
    pad = memoryview(bytes(CHUNK))
    want = min(1 << 16, CHUNK)  # the next read's size: doubles to CHUNK
    scan = 0        # the '\n's before this are placed
    nl = -1         # the header's '\n', once placed
    lines = False   # a '\n' placed inside the body
    eof = False
    while True:
        # a '\n' is placed once its next byte is read and is not the last
        i = (buf.find(b"\n>", scan, len(buf) - 1) if lines
             else buf.find(b"\n", scan, len(buf) - 2))
        if i < 0:
            if eof:
                break
            scan = max(len(buf) - 2, 0)
            eof = _read_into(fp, buf, pad[:want]) == 0
            want = min(2 * want, CHUNK)
        elif lines or buf[i + 1] == 62:         # '>'
            yield _record(buf, i + 1, nl, lines, i)
            del buf[:i + 2]
            scan, nl, lines = 0, -1, False
        elif nl < 0:
            nl, scan = i, i + 1
        else:
            lines, scan = True, i + 1
    if buf:
        yield _record(buf, len(buf), nl, lines, scan)


def _read_into(fp, buf: bytearray, pad: memoryview) -> int:
    """Append up to len(pad) bytes of fp to buf, read in place (pad's zeros
    make the room); the count."""
    old = len(buf)
    buf += pad
    with memoryview(buf) as mv:
        n = fp.readinto(mv[old:])
    del buf[old + n:]
    return n


def _record(buf: bytearray, end: int, nl: int, lines: bool,
            placed: int) -> FastaBytes:
    """The record of buf[:end], its header's '\\n' at nl (-1: not placed)
    and lines whether a '\\n' placed before ``placed`` lies in its body:
    the header line, and the body with every '\\n' and '\\r' taken out."""
    if nl < 0:
        nl = buf.find(b"\n", 0, end)
        if nl < 0:
            nl = end
    name, comment = _split_ws(bytes(buf[:nl]).rstrip(b"\r"))
    s, e = nl + 1, end
    for c in b"\n\r":              # the body's own last line end
        if e > s and buf[e - 1] == c:
            e -= 1
    with memoryview(buf) as mv:
        seq = bytes(mv[s:e])
    cr = buf.find(b"\r", s, e) >= 0
    squeezed = cr or lines or buf.find(b"\n", max(s, placed), e) >= 0
    if cr:
        seq = seq.translate(None, b"\r\n")
    elif squeezed:
        seq = seq.replace(b"\n", b"")
    return FastaBytes(name, comment, seq, squeezed)


def parse_fastx(fp) -> Iterator[FastxRecord]:
    header = None
    for line in fp:
        line = line.rstrip("\r\n")
        if line.startswith(">") or line.startswith("@"):
            header = line
            break
    if header is None:
        return
    while header is not None:
        is_fastq = header.startswith("@")
        hdr = header[1:]
        sp = _split_ws(hdr)
        name, comment = sp
        seq_parts = []
        qual = None
        header = None
        if is_fastq:
            for line in fp:
                line = line.rstrip("\r\n")
                if line.startswith("+"):
                    break
                seq_parts.append(line)
            seq = "".join(seq_parts)
            qual_parts = []
            qlen = 0
            for line in fp:
                line = line.rstrip("\r\n")
                qual_parts.append(line)
                qlen += len(line)
                if qlen >= len(seq):
                    break
            qual = "".join(qual_parts)
            for line in fp:
                line = line.rstrip("\r\n")
                if line.startswith("@") or line.startswith(">"):
                    header = line
                    break
        else:
            for line in fp:
                line = line.rstrip("\r\n")
                if line.startswith(">") or line.startswith("@"):
                    header = line
                    break
                seq_parts.append(line)
            seq = "".join(seq_parts)
        yield FastxRecord(name, comment, seq, qual)


def _split_ws(hdr):
    """(name, comment) of a header, str or bytes: cut at its first space or
    tab, the comment None where there is neither."""
    sp, tab = (" ", "\t") if isinstance(hdr, str) else (b" ", b"\t")
    cuts = [i for i in (hdr.find(sp), hdr.find(tab)) if i >= 0]
    if not cuts:
        return hdr, None
    i = min(cuts)
    return hdr[:i], hdr[i + 1:]


def write_fasta_record(out, name: str, seq: str) -> None:
    """Single-line sequence output, as the reference's fixasm writes
    (reference: src/fixasm.c:395)."""
    out.write(">%s\n%s\n" % (name, seq))
