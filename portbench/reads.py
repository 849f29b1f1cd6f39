"""The sequencer's reads: an endless seeded stream of full-length reads of the
draft, as chip_smoke.py's write_replay_reads draws them (length uniform in
the mix's range, a contig by length, about half starting inside a panel
block, half reverse-complemented, a share opening with a piece of the
planted repeat element).  Their parameters are drawn in blocks of BLOCK
reads, so read i is the same whoever asks for it; a read's bases are
sliced from the draft when they are needed: as text, chunk by chunk, for
the program (ReadText), and as codes of its first bases for the reference
(ReadStream.reads).
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import harness
from portbench.draft import ASCII

BLOCK = 4096
RC_ASCII = np.frombuffer(b"TGCA", dtype=np.uint8)


class ReadStream:
    """Read i: its length; g, the draft position its forward span starts at
    (the draft's contigs end to end); rc, whether it is that span's reverse
    complement; hl bases of the repeat element from o (reverse-complemented
    where hrc) in place of its first hl bases (hl 0: none)."""

    FIELDS = ("length", "g", "rc", "hl", "o", "hrc")

    def __init__(self, cfg, mix, seed, starts, elem_len, panel_rows,
                 stream=harness.READS):
        if mix["repeat_head_len"][1] > elem_len:
            raise ValueError("a repeat head longer than the element")
        self.mix, self.seed, self.stream = mix, seed, stream
        self.starts, self.elem_len = starts, elem_len
        self.lens = np.array([n for _, n in cfg["contigs"]], dtype=np.int64)
        if mix["read_len"][1] > self.lens.min():
            raise ValueError("reads longer than a contig")
        self.head = mix["chunk_len"] * cfg["policy"]["max_chunks"]
        self.block_size = block = cfg["panel"]["block"]
        self.panel = [np.array([s // block for nm, s, _ in panel_rows
                                if nm == name], dtype=np.int64)
                      for name, _ in cfg["contigs"]]

    def block(self, b: int) -> dict:
        """The parameters of reads b * BLOCK ... (b + 1) * BLOCK - 1, each
        field a (BLOCK,) int64 array."""
        mix, n = self.mix, BLOCK
        rng = harness.rng(self.seed, self.stream, b)
        lo, hi = mix["read_len"]
        length = rng.integers(lo, hi + 1, n)
        ctg = rng.choice(len(self.lens), size=n, p=self.lens / self.lens.sum())
        want_panel = rng.random(n) < mix["panel_start_share"]
        u_block, u_off = rng.random(n), rng.random(n)
        rc = rng.random(n) < mix["rc_share"]
        head = rng.random(n) < mix["repeat_head_share"]
        hlo, hhi = mix["repeat_head_len"]
        hl = rng.integers(hlo, hhi + 1, n)
        o = (rng.random(n) * (self.elem_len - hl + 1)).astype(np.int64)
        hrc = rng.random(n) < 0.5
        cl = self.lens[ctg]
        start = (u_off * cl).astype(np.int64)
        for c, blocks in enumerate(self.panel):
            pick = want_panel & (ctg == c)
            if len(blocks) and pick.any():
                b_ = blocks[(u_block[pick] * len(blocks)).astype(np.int64)]
                start[pick] = b_ * self.block_size + \
                    (u_off[pick] * self.block_size).astype(np.int64)
        start = np.clip(start, 0, cl - length)
        return dict(length=length, g=self.starts[ctg] + start,
                    rc=rc.astype(np.int64), hl=np.where(head, hl, 0),
                    o=o, hrc=hrc.astype(np.int64))

    def params(self, reads) -> dict:
        """The parameters of the reads with these indices."""
        reads = np.asarray(reads, dtype=np.int64)
        out = {f: np.empty(len(reads), dtype=np.int64) for f in self.FIELDS}
        for b in np.unique(reads // BLOCK).tolist():
            sel = reads // BLOCK == b
            p = self.block(b)
            for f in self.FIELDS:
                out[f][sel] = p[f][reads[sel] % BLOCK]
        return out

    def reads(self, reads, codes, elem):
        """(lengths, (n, head) codes of each read's first bases) of the
        reads with these indices, from the draft's codes."""
        p = self.params(reads)
        j = np.arange(self.head, dtype=np.int64)
        g, L, rc = p["g"][:, None], p["length"][:, None], p["rc"][:, None]
        heads = codes[np.where(rc == 1, g + L - 1 - j, g + j)]
        heads = np.where(rc == 1, 3 - heads, heads)
        o, hl, hrc = p["o"][:, None], p["hl"][:, None], p["hrc"][:, None]
        e = elem[np.clip(np.where(hrc == 1, o + hl - 1 - j, o + j), 0,
                         len(elem) - 1)]
        e = np.where(hrc == 1, 3 - e, e)
        return p["length"], np.where(j < hl, e, heads).astype(np.uint8)


class ReadText:
    """The draft and the repeat element as text, forward and reverse
    complement, for slicing reads' chunks with no per-base work."""

    def __init__(self, codes, elem):
        self.fwd = text(ASCII, codes)
        self.rev = text(RC_ASCII, codes[::-1])
        self.efwd = text(ASCII, elem)
        self.erev = text(RC_ASCII, elem[::-1])

    def chunk(self, read, off: int, n: int) -> str:
        """Bases off ... off + n - 1 of a read (length, g, rc, hl, o, hrc)."""
        length, g, rc, hl, o, hrc = read
        end = min(off + n, length)
        a = max(off, hl)
        if rc:
            base = len(self.rev) - g - length
            body = self.rev[base + a:base + end]
        else:
            body = self.fwd[g + a:g + end]
        if off >= hl:
            return body
        if hrc:
            base = len(self.erev) - o - hl
            return self.erev[base + off:base + min(end, hl)] + body
        return self.efwd[o + off:o + min(end, hl)] + body


def text(lut, codes) -> str:
    """lut[codes] as one str, the lookup in threads (numpy's take lets go
    of the interpreter lock)."""
    out = np.empty(len(codes), dtype=np.uint8)
    step = -(-len(codes) // 8) or 1
    with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as ex:
        list(ex.map(lambda i: np.take(lut, codes[i:i + step],
                                      out=out[i:i + step]),
                    range(0, len(codes), step)))
    return str(memoryview(out), "ascii")
