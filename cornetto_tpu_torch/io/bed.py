"""BED / bedgraph readers with the reference's validation semantics, plus a
fast NumPy bedgraph-pair loader for the boringbits depth path.

The reference's get_depths streams two 1-bp-resolution bedgraphs in lockstep
into per-contig uint16 arrays (reference: src/boringbits_main.c:180-301); here
the parse is vectorised with NumPy so a whole-genome load is IO-bound instead
of fscanf-bound.
"""

import os
import sys
from typing import Iterator, List, Tuple

import numpy as np

from cornetto_tpu_torch.utils import logging as log


def read_bed3(path: str, context: str = "bed") -> Iterator[Tuple[str, int, int]]:
    """Stream (chrom, start, end) validating like the reference BED readers
    (reference: src/bigenough_main.c:106-143): 3+ columns, non-negative,
    start < end; malformed input is a fatal error."""
    with open(path) as fp:
        for line_no, line in enumerate(fp):
            fields = line.split()
            if len(fields) < 3:
                log.error("Malformed bed entry at line %d" % line_no)
                sys.exit(1)
            ref = fields[0]
            try:
                beg = int(fields[1])
                end = int(fields[2])
            except ValueError:
                log.error("Malformed bed entry at line %d" % line_no)
                sys.exit(1)
            if beg < 0 or end < 0:
                log.error("Malformed bed entry at %s:%d. Coordinates cannot "
                          "be negative" % (path, line_no))
                sys.exit(1)
            if beg >= end:
                log.error("Malformed bed entry at %s:%d. start must be "
                          "smaller than end coordinate" % (path, line_no))
                sys.exit(1)
            yield ref, beg, end


class DepthArrays:
    """Per-contig uint16 depth arrays for a (total, mq) bedgraph pair."""

    def __init__(self):
        self.names: List[str] = []
        self.depth: List[np.ndarray] = []     # uint16 per contig
        self.mq_depth: List[np.ndarray] = []  # uint16 per contig
        self.mean_depth: int = 0              # round() of global mean
        self.mean_mq_depth: int = 0


def _parse_bedgraph_native(path: str):
    """C-kernel parse over an mmap'd file (zero-copy, multi-threaded):
    returns (names, starts, ends, depths, contig row bounds) or None if the
    native library is unavailable."""
    import ctypes
    import mmap
    import os as _os
    from cornetto_tpu_torch import native
    lib = native.load("bedgraph_native", "bedgraph_native.c")
    if lib is None:
        return None
    lib.bg_parse.restype = ctypes.c_int64
    size = _os.path.getsize(path)
    if size == 0:
        return [], np.empty(0, np.int64), np.empty(0, np.int64), \
            np.empty(0, np.int64), np.empty(1, np.int64)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    view = np.frombuffer(mm, dtype=np.uint8)
    n_lines = int(np.count_nonzero(view == 10))
    if size and mm[size - 1:size] != b"\n":
        n_lines += 1
    if n_lines == 0:
        return [], np.empty(0, np.int64), np.empty(0, np.int64), \
            np.empty(0, np.int64), np.empty(1, np.int64)
    starts = np.empty(n_lines, dtype=np.int64)
    ends = np.empty(n_lines, dtype=np.int64)
    depths = np.empty(n_lines, dtype=np.int64)
    ctg_row = np.empty(n_lines, dtype=np.int64)
    ctg_off = np.empty(n_lines, dtype=np.int64)
    ctg_len = np.empty(n_lines, dtype=np.int64)
    n_ctg = ctypes.c_int64(0)
    p = ctypes.POINTER(ctypes.c_int64)
    nthreads = min(_os.cpu_count() or 1, 16)
    rows = lib.bg_parse(
        ctypes.c_void_p(view.ctypes.data), ctypes.c_int64(size),
        ctypes.c_int(nthreads),
        starts.ctypes.data_as(p), ends.ctypes.data_as(p),
        depths.ctypes.data_as(p), ctg_row.ctypes.data_as(p),
        ctg_off.ctypes.data_as(p), ctg_len.ctypes.data_as(p),
        ctypes.byref(n_ctg))
    if rows < 0:
        log.error("The depth files should have 4 columns. Had fewer at row "
                  "%d." % (-rows - 1))
        sys.exit(1)
    nc = n_ctg.value
    names = [bytes(mm[int(ctg_off[k]):int(ctg_off[k] + ctg_len[k])]).decode()
             for k in range(nc)]
    bounds = np.append(ctg_row[:nc], rows)
    return names, starts[:rows], ends[:rows], depths[:rows], bounds


def _parse_bedgraph_pandas(data: bytes):
    import io as _io
    import pandas as pd
    df = pd.read_csv(_io.BytesIO(data), sep="\t", header=None,
                     names=["c", "s", "e", "d"],
                     dtype={"c": "object", "s": np.int64,
                            "e": np.int64, "d": np.int64})
    chroms = df["c"].to_numpy()
    starts = df["s"].to_numpy()
    ends = df["e"].to_numpy()
    depths = df["d"].to_numpy()
    change = np.empty(len(chroms), dtype=bool)
    if len(chroms):
        change[0] = True
        change[1:] = chroms[1:] != chroms[:-1]
    rows = np.flatnonzero(change)
    names = [str(chroms[i]) for i in rows]
    bounds = np.append(rows, len(chroms))
    return names, starts, ends, depths, bounds


def _parse_bedgraph_numpy(path: str, ranged: bool = False):
    """Parse a 4-column 1-bp bedgraph (native C kernel when available,
    pandas otherwise).

    Returns (names_in_order, per-contig start arrays, per-contig depth
    arrays) with the reference's validation: 4 columns, end=start+1,
    per-contig positions incremental from the first row of the contig
    (reference: src/boringbits_main.c:204-287).

    ranged=True is OUR extension for aligner-free approximate-panel
    tracks (livefish.coverage emits run-length rows): contiguous
    [start, end) ranges are expanded to per-base arrays instead of being
    rejected.  The strict default stays byte-parity with the C binary.
    """
    if _is_gzip(path):
        import gzip
        with gzip.open(path, "rb") as fp:
            data = fp.read()
        parsed = _parse_bedgraph_pandas(data) if data else None
        if parsed is None:
            return [], [], []
    else:
        parsed = _parse_bedgraph_native(path)
    if parsed is None:
        with open(path, "rb") as fp:
            data = fp.read()
        if not data:
            return [], [], []
        parsed = _parse_bedgraph_pandas(data)
    names, starts, ends, depths, bounds = parsed
    if not ranged and not np.all(starts + 1 == ends):
        bad = int(np.argmin(starts + 1 == ends))
        log.error("The depth files should have end=start+1. Found %d to %d"
                  % (starts[bad], ends[bad]))
        sys.exit(1)
    seg_starts = []
    seg_depths = []
    for k in range(len(names)):
        a, b = bounds[k], bounds[k + 1]
        st = starts[a:b]
        if ranged:
            en = ends[a:b]
            if not np.all(en > st) or (b - a > 1
                                       and not np.all(st[1:] == en[:-1])):
                log.error("Ranged bedgraph rows must be contiguous "
                          "[start, end) runs per contig")
                sys.exit(1)
            seg_starts.append(np.arange(st[0], en[-1], dtype=st.dtype))
            seg_depths.append(np.repeat(depths[a:b], en - st))
            continue
        if b - a > 1 and not np.all(np.diff(st) == 1):
            bad = int(np.argmin(np.diff(st) == 1))
            log.error("The depth files should be incremantal at one base "
                      "resolution. Found %d to %d"
                      % (st[bad], st[bad + 1]))
            sys.exit(1)
        seg_starts.append(st)
        seg_depths.append(depths[a:b])
    return names, seg_starts, seg_depths


def _is_gzip(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _bg_fill_error(err, row_base: int) -> None:
    kind = int(err[1])
    if kind == 0:
        log.error("The depth files should have 4 columns. Had fewer "
                  "at row %d." % (int(err[0]) + row_base))
    elif kind == 1:
        log.error("The depth files should have end=start+1. Found %d "
                  "to %d" % (int(err[2]), int(err[3])))
    else:
        log.error("The depth files should be incremantal at one base "
                  "resolution. Found %d to %d"
                  % (int(err[2]), int(err[3])))
    sys.exit(1)


def _row_windows(fp, window: int = 64 << 20):
    """Windowed buffered reader: yields (base_ptr, blen, wrows, bufmem)
    row-aligned text windows from any file-like `fp` using one persistent
    readinto buffer (a bytes concat/slice shuffle costs three full copies
    of the stream).  Shared IO skeleton of the depth loaders below."""
    import ctypes
    from cornetto_tpu_torch import native
    lib = native.load("bedgraph_native", "bedgraph_native.c")
    nthreads = min(os.cpu_count() or 1, 16)
    bufmem = bytearray(window + (1 << 16))
    npbuf = np.frombuffer(bufmem, dtype=np.uint8)
    base = ctypes.c_void_p(npbuf.ctypes.data)
    tail_len = 0
    eof = False
    with fp:
        while True:
            nread = 0 if eof else (fp.readinto(
                memoryview(bufmem)[tail_len:tail_len + window]) or 0)
            total_b = tail_len + nread
            if nread == 0:
                eof = True
                if total_b == 0:
                    return
                blen = total_b          # final rows, maybe no trailing LF
            else:
                cut = bufmem.rfind(b"\n", 0, total_b)
                if cut < 0:
                    # no full row yet (window smaller than one row): grow
                    # into a FRESH bytearray — extend() would raise
                    # BufferError while the np.frombuffer export is alive
                    if total_b + window > len(bufmem):
                        grown = bytearray(len(bufmem) * 2)
                        grown[:total_b] = bufmem[:total_b]
                        bufmem = grown
                        npbuf = np.frombuffer(bufmem, dtype=np.uint8)
                        base = ctypes.c_void_p(npbuf.ctypes.data)
                    tail_len = total_b
                    continue
                blen = cut + 1
            wrows = int(lib.bg_count_nl(base, ctypes.c_int64(blen),
                                        ctypes.c_int(nthreads)))
            if bufmem[blen - 1] != 10:
                wrows += 1
            if wrows:
                yield base, blen, wrows, bufmem
            if eof:
                return
            tail_len = total_b - blen
            if tail_len:
                bufmem[0:tail_len] = bufmem[blen:total_b]


class _FillState:
    """Cross-window contig stitching shared by the streaming consumers:
    wraps one bg_fill call per window and tracks contig continuations +
    the incremental-start validation across window boundaries."""

    def __init__(self, lib):
        import ctypes
        self.lib = lib
        lib.bg_fill.restype = ctypes.c_int64
        self.ct = ctypes
        self.p = ctypes.POINTER(ctypes.c_int64)
        self.u16p = ctypes.POINTER(ctypes.c_uint16)
        self.nthreads = min(os.cpu_count() or 1, 16)
        self.ctg_cap, self.tr_cap = 1 << 20, 1 << 16
        self.ctg_row = np.empty(self.ctg_cap, np.int64)
        self.ctg_off = np.empty(self.ctg_cap, np.int64)
        self.ctg_len = np.empty(self.ctg_cap, np.int64)
        self.ctg_first = np.empty(self.ctg_cap, np.int64)
        self.tr_row = np.empty(self.tr_cap, np.int64)
        self.tr_val = np.empty(self.tr_cap, np.int64)
        self.prev_name = None
        self.prev_last_start = -1
        self.rows_total = 0

    def fill(self, base, blen, depth_dst):
        """Parse one window into depth_dst (>= wrows uint16 slots).
        Returns (rows, segments, ssum, (tr_rows_local, tr_vals, tr_tot))
        where segments = [(name_or_None_for_continuation, first_start,
        row_lo, row_hi)] with window-local row indices."""
        ctypes = self.ct
        n_ctg = np.array([self.ctg_cap], np.int64)
        ssum = np.zeros(1, np.int64)
        n_tr = np.zeros(2, np.int64)
        err = np.zeros(4, np.int64)
        rows = self.lib.bg_fill(
            base, ctypes.c_int64(blen), ctypes.c_int(self.nthreads),
            depth_dst.ctypes.data_as(self.u16p),
            self.ctg_row.ctypes.data_as(self.p),
            self.ctg_off.ctypes.data_as(self.p),
            self.ctg_len.ctypes.data_as(self.p),
            self.ctg_first.ctypes.data_as(self.p),
            n_ctg.ctypes.data_as(self.p), ssum.ctypes.data_as(self.p),
            self.tr_row.ctypes.data_as(self.p),
            self.tr_val.ctypes.data_as(self.p),
            ctypes.c_int64(self.tr_cap), n_tr.ctypes.data_as(self.p),
            err.ctypes.data_as(self.p))
        if rows == -2:
            return None    # > 1M contigs in one window: generic path
        if rows == -1:
            _bg_fill_error(err, self.rows_total)
        rows = int(rows)
        nc = int(n_ctg[0])
        segments = []
        # mm buffer names must be copied out before the window is reused
        for k in range(nc):
            off = int(self.ctg_off[k])
            nm = bytes(memoryview(self._buf)[off:off
                                             + int(self.ctg_len[k])]) \
                .decode()
            fs = int(self.ctg_first[k])
            lo = int(self.ctg_row[k])
            hi = int(self.ctg_row[k + 1]) if k + 1 < nc else rows
            if k == 0 and self.prev_name is not None \
                    and nm == self.prev_name:
                # contig continues across the window boundary
                if fs != self.prev_last_start + 1:
                    log.error("The depth files should be incremantal "
                              "at one base resolution. Found %d to %d"
                              % (self.prev_last_start, fs))
                    sys.exit(1)
                segments.append((None, fs, lo, hi))
            else:
                segments.append((nm, fs, lo, hi))
                self.prev_name = nm
        self.prev_last_start = (int(self.ctg_first[nc - 1])
                                + (rows - int(self.ctg_row[nc - 1]) - 1))
        ne = int(n_tr[0])
        tr = (self.tr_row[:ne].copy(), self.tr_val[:ne].copy(),
              int(n_tr[1]))
        self.rows_total += rows
        return rows, segments, int(ssum[0]), tr


def scan_depth_track(path: str, window: int = 64 << 20):
    """PASS 1 of the low-memory mode: stream the whole track computing
    per-contig (name, length, first_start), the clamped global sum and
    the truncation warnings — with NO depth storage (peak = one window).
    Returns (names, lengths, firsts, clamped_sum,
    [(contig_idx, pos, value)] truncations, trunc_total) or None if the
    native kernel is unavailable."""
    from cornetto_tpu_torch import native
    lib = native.load("bedgraph_native", "bedgraph_native.c")
    if lib is None or not hasattr(lib, "bg_fill"):
        return None
    fp = (_gz_reader(path) if _is_gzip(path)
          else open(path, "rb"))
    st = _FillState(lib)
    scratch = np.empty(1, np.uint16)
    names, lengths, firsts = [], [], []
    sum_total = 0
    truncs = []
    tr_total = 0
    for base, blen, wrows, bufmem in _row_windows(fp, window):
        if wrows > len(scratch):
            scratch = np.empty(wrows, np.uint16)
        st._buf = bufmem
        got = st.fill(base, blen, scratch)
        if got is None:
            return None
        rows, segments, ssum, (trr, trv, trt) = got
        row0 = st.rows_total - rows
        for nm, fs, lo, hi in segments:
            if nm is None:
                lengths[-1] += hi - lo
            else:
                names.append(nm)
                firsts.append(fs)
                lengths.append(hi - lo)
            # truncation rows inside this segment -> absolute positions
            for r, v in zip(trr, trv):
                if lo <= r < hi:
                    pos = firsts[-1] + (lengths[-1] - (hi - r))
                    truncs.append((len(names) - 1, int(pos), int(v)))
        sum_total += ssum
        tr_total += trt
    return names, lengths, firsts, sum_total, truncs, tr_total


def iter_depth_contigs(path: str, lengths, window: int = 64 << 20):
    """PASS 2 of the low-memory mode: yield one uint16 depth array per
    contig, in file order, peak memory = the largest contig + one window
    (lengths from scan_depth_track pre-size each buffer exactly)."""
    from cornetto_tpu_torch import native
    lib = native.load("bedgraph_native", "bedgraph_native.c")
    fp = (_gz_reader(path) if _is_gzip(path)
          else open(path, "rb"))
    st = _FillState(lib)
    scratch = np.empty(1, np.uint16)
    ci = -1
    cur = None
    filled = 0
    for base, blen, wrows, bufmem in _row_windows(fp, window):
        if wrows > len(scratch):
            scratch = np.empty(wrows, np.uint16)
        st._buf = bufmem
        rows, segments, _ssum, _tr = st.fill(base, blen, scratch)
        for nm, fs, lo, hi in segments:
            if nm is not None:
                if cur is not None:
                    yield cur
                ci += 1
                cur = np.empty(lengths[ci], np.uint16)
                filled = 0
            cur[filled:filled + (hi - lo)] = scratch[lo:hi]
            filled += hi - lo
    if cur is not None:
        yield cur


def _gz_reader(path: str):
    """Decompressing reader for a coverage track: BGZF tracks (bgzip'd —
    concatenated independent gzip members) inflate block-parallel across
    threads (io.bgzf.BgzfStreamReader); plain gzip is inherently a
    single serial stream."""
    from cornetto_tpu_torch.io.bgzf import BgzfStreamReader, is_bgzf
    if is_bgzf(path):
        return BgzfStreamReader(path)
    import gzip
    return gzip.GzipFile(fileobj=open(path, "rb"))


def _load_depth_windows(fp, size_hint: int = 0, window: int = 64 << 20,
                        raw_tell=None):
    """Shared windowed streaming loader behind _load_depth_streaming:
    reads `window`-byte row-aligned slices from any file-like `fp`
    (plain file or gzip stream) and runs the native bg_fill parser per
    slice, stitching contig continuations and the incremental-start
    validation across slice boundaries.

    Peak memory = 2 B/row (the uint16 depth array) + one window of text,
    never the whole file: the round-3 plain-text path mmap'd the entire
    track, which counted ~file-size pages toward peak RSS and lost the
    at-scale RAM comparison to the reference's fscanf loop
    (src/boringbits_main.c:204-287).  `size_hint` (the raw file size)
    sizes the depth array from the observed bytes/row so growth
    reallocations are rare.  Returns the _load_depth_streaming tuple, or
    None if the native kernel is unavailable."""
    import ctypes
    from cornetto_tpu_torch import native
    lib = native.load("bedgraph_native", "bedgraph_native.c")
    if lib is None or not hasattr(lib, "bg_fill"):
        return None
    lib.bg_fill.restype = ctypes.c_int64
    lib.bg_count_nl.restype = ctypes.c_int64
    p = ctypes.POINTER(ctypes.c_int64)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    nthreads = min(os.cpu_count() or 1, 16)
    ctg_cap, tr_cap = 1 << 20, 1 << 16
    ctg_row = np.empty(ctg_cap, np.int64)
    ctg_off = np.empty(ctg_cap, np.int64)
    ctg_len = np.empty(ctg_cap, np.int64)
    ctg_first = np.empty(ctg_cap, np.int64)
    tr_row = np.empty(tr_cap, np.int64)
    tr_val = np.empty(tr_cap, np.int64)

    cap = 1 << 22
    depth = np.empty(cap, np.uint16)
    rows_total = 0
    bytes_seen = 0
    names, firsts, bound_rows = [], [], []
    tr_rows_all, tr_vals_all = [], []
    tr_total = 0
    sum_total = 0
    prev_name = None
    prev_last_start = -1
    bufmem = bytearray(window + (1 << 16))
    npbuf = np.frombuffer(bufmem, dtype=np.uint8)
    base = ctypes.c_void_p(npbuf.ctypes.data)
    tail_len = 0
    eof = False
    with fp:
        while True:
            # persistent buffer + readinto: a bytes concat/slice shuffle
            # here costs three full copies of the stream (2x the read
            # itself); instead the short carried tail is moved to the
            # buffer head and the window is read in place after it
            nread = 0 if eof else (fp.readinto(
                memoryview(bufmem)[tail_len:tail_len + window]) or 0)
            total_b = tail_len + nread
            if nread == 0:
                eof = True
                if total_b == 0:
                    break
                blen = total_b          # final rows, maybe no trailing LF
            else:
                cut = bufmem.rfind(b"\n", 0, total_b)
                if cut < 0:
                    # no full row yet (window smaller than one row): grow
                    # into a FRESH bytearray — extend() would raise
                    # BufferError while the np.frombuffer export is alive
                    if total_b + window > len(bufmem):
                        grown = bytearray(len(bufmem) * 2)
                        grown[:total_b] = bufmem[:total_b]
                        bufmem = grown
                        npbuf = np.frombuffer(bufmem, dtype=np.uint8)
                        base = ctypes.c_void_p(npbuf.ctypes.data)
                    tail_len = total_b
                    continue
                blen = cut + 1
            wrows = int(lib.bg_count_nl(base, ctypes.c_int64(blen),
                                        ctypes.c_int(nthreads)))
            if bufmem[blen - 1] != 10:
                wrows += 1
            if wrows == 0:
                tail_len = 0 if eof else total_b - blen
                continue

            def projected():
                # total-row projection from bytes/row so far; size_hint is
                # the raw file size (for gz, raw_tell reports compressed
                # bytes consumed, scaling the hint to decompressed bytes)
                seen = bytes_seen + blen
                total = size_hint
                if raw_tell is not None:
                    done = raw_tell()
                    if done <= 0:
                        return 0
                    total = size_hint * ((seen + (total_b - blen)) / done)
                rate = (rows_total + wrows) / seen
                return int(rate * total * 1.03) + 4096

            if rows_total == 0 and size_hint > blen:
                cap = max(cap, projected())
            need = rows_total + wrows
            if need > cap:
                cap = max(need, projected(), cap + (cap >> 2))
            if cap > len(depth):
                nd = np.empty(cap, np.uint16)
                nd[:rows_total] = depth[:rows_total]
                depth = nd
            bytes_seen += blen
            n_ctg = np.array([ctg_cap], np.int64)
            ssum = np.zeros(1, np.int64)
            n_tr = np.zeros(2, np.int64)
            err = np.zeros(4, np.int64)
            rows = lib.bg_fill(
                base, ctypes.c_int64(blen), ctypes.c_int(nthreads),
                depth[rows_total:].ctypes.data_as(u16p),
                ctg_row.ctypes.data_as(p), ctg_off.ctypes.data_as(p),
                ctg_len.ctypes.data_as(p), ctg_first.ctypes.data_as(p),
                n_ctg.ctypes.data_as(p), ssum.ctypes.data_as(p),
                tr_row.ctypes.data_as(p), tr_val.ctypes.data_as(p),
                ctypes.c_int64(tr_cap), n_tr.ctypes.data_as(p),
                err.ctypes.data_as(p))
            if rows == -2:
                return None    # > 1M contigs in one window: generic path
            if rows == -1:
                _bg_fill_error(err, rows_total)
            nc = int(n_ctg[0])
            for k in range(nc):
                nm = bytes(bufmem[int(ctg_off[k]):
                                  int(ctg_off[k] + ctg_len[k])]).decode()
                fs = int(ctg_first[k])
                if k == 0 and prev_name is not None and nm == prev_name:
                    # contig continues across the window boundary
                    if fs != prev_last_start + 1:
                        log.error("The depth files should be incremantal "
                                  "at one base resolution. Found %d to %d"
                                  % (prev_last_start, fs))
                        sys.exit(1)
                else:
                    names.append(nm)
                    firsts.append(fs)
                    bound_rows.append(rows_total + int(ctg_row[k]))
            prev_name = names[-1]
            prev_last_start = (int(ctg_first[nc - 1])
                               + (rows - int(ctg_row[nc - 1]) - 1))
            ne = int(n_tr[0])
            if ne:
                tr_rows_all.append(tr_row[:ne] + rows_total)
                tr_vals_all.append(tr_val[:ne].copy())
            tr_total += int(n_tr[1])
            sum_total += int(ssum[0])
            rows_total += int(rows)
            if eof:
                tail_len = 0
            else:
                tail_len = total_b - blen
                if tail_len:
                    bufmem[0:tail_len] = bufmem[blen:total_b]

    bounds = np.append(np.array(bound_rows, np.int64), rows_total)
    trr = (np.concatenate(tr_rows_all) if tr_rows_all
           else np.empty(0, np.int64))
    trv = (np.concatenate(tr_vals_all) if tr_vals_all
           else np.empty(0, np.int64))
    if len(depth) > rows_total + (rows_total >> 2):
        depth = depth[:rows_total].copy()   # drop large over-allocation
    return (names, np.array(firsts, np.int64), depth[:rows_total], bounds,
            sum_total, (trr, trv, tr_total))


def _load_depth_streaming_gz(path: str, window: int = 64 << 20):
    """Gzip/BGZF entry to _load_depth_windows (kept callable with a small
    `window` so tests can exercise the cross-window stitching).  The raw
    handle's compressed-progress tell() lets the loader project total
    rows, avoiding doubling-growth over-allocation.  BGZF tracks inflate
    block-parallel (io.bgzf.BgzfStreamReader)."""
    from cornetto_tpu_torch.io.bgzf import BgzfStreamReader, is_bgzf
    if is_bgzf(path):
        rd = BgzfStreamReader(path)
        return _load_depth_windows(rd, size_hint=os.path.getsize(path),
                                   window=window, raw_tell=rd.raw_tell)
    import gzip
    with open(path, "rb") as raw:
        gz = gzip.GzipFile(fileobj=raw)
        return _load_depth_windows(gz, size_hint=os.path.getsize(path),
                                   window=window, raw_tell=raw.tell)


def _load_depth_streaming(path: str):
    """Whole-genome streaming load via the native bg_fill kernel: peak
    memory 2 B/row (uint16 depths written directly, no int64 row arrays —
    the difference between ~6 GB and ~72 GB for a 3 Gbp track) plus one
    text window, for BOTH plain and gzipped tracks
    (`samtools depth -aa [| gzip]`) — see _load_depth_windows.  Returns
    (names, first_starts, depth_u16, row_bounds, clamped_sum,
    (trunc_rows, trunc_vals, trunc_total)) or None if the native kernel is
    unavailable."""
    if _is_gzip(path):
        return _load_depth_streaming_gz(path)
    size = os.path.getsize(path)
    if size == 0:
        return ([], np.empty(0, np.int64), np.empty(0, np.uint16),
                np.empty(1, np.int64), 0,
                (np.empty(0, np.int64), np.empty(0, np.int64), 0))
    return _load_depth_windows(open(path, "rb"), size_hint=size)


def _emit_trunc_warnings(name: str, first_start: int, row0: int,
                         rows: np.ndarray, vals: np.ndarray) -> None:
    for r, v in zip(rows, vals):
        pos = int(first_start + (r - row0))
        log.warning("The depth at %s:%d-%d was truncated to 65535. "
                    "Found %d" % (name, pos, pos + 1, int(v)))


def _pair_from_streaming(a, b) -> DepthArrays:
    """Assemble DepthArrays from two _load_depth_streaming results with
    the reference's lockstep validation and per-contig warning order."""
    n1, f1, dep1, b1, sum1, tr1 = a
    n2, f2, dep2, b2, sum2, tr2 = b
    if n1 != n2 or len(n1) != len(n2) \
            or not np.array_equal(np.diff(b1), np.diff(b2)) \
            or not np.array_equal(f1, f2):
        log.error("The two files are not in the same order")
        sys.exit(1)
    out = DepthArrays()
    tr_rows1, tr_vals1, tot1 = tr1
    tr_rows2, tr_vals2, tot2 = tr2
    for k, name in enumerate(n1):
        lo, hi = int(b1[k]), int(b1[k + 1])
        for rows_, vals_, b_, f_ in ((tr_rows1, tr_vals1, b1, f1),
                                     (tr_rows2, tr_vals2, b2, f2)):
            i0, i1 = np.searchsorted(rows_, [lo, hi])
            _emit_trunc_warnings(name, int(f_[k]), lo,
                                 rows_[i0:i1], vals_[i0:i1])
        out.names.append(name)
        out.depth.append(dep1[lo:hi])
        out.mq_depth.append(dep2[lo:hi])
    if tot1 > len(tr_rows1) or tot2 > len(tr_rows2):
        log.warning("%d additional depth truncations not listed"
                    % ((tot1 - len(tr_rows1)) + (tot2 - len(tr_rows2))))
    tot_len = int(b1[-1])
    if tot_len:
        from cornetto_tpu_torch.utils.cformat import c_round
        out.mean_depth = c_round(float(sum1) / float(tot_len))
        out.mean_mq_depth = c_round(float(sum2) / float(tot_len))
    return out


def read_bedgraph_pair(cov_total_path: str, cov_mq_path: str,
                       ranged: bool = False) -> DepthArrays:
    """Load the two bedgraphs with the reference's lockstep validation and
    uint16 truncation (reference: src/boringbits_main.c:261-268 clamps depth
    at 65535 with a warning; :293-294 rounds the global means).
    ranged=True accepts run-length rows (aligner-free approx mode)."""
    if not ranged:
        # load the two tracks concurrently: gzip inflate is single-threaded
        # per stream (the 3 Gbp wall-clock driver), and both zlib and the
        # native parser release the GIL, so the pair overlaps cleanly
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(2) as ex:
            fa = ex.submit(_load_depth_streaming, cov_total_path)
            fb = ex.submit(_load_depth_streaming, cov_mq_path)
            a, b = fa.result(), fb.result()
        if a is not None and b is not None:
            return _pair_from_streaming(a, b)
    n1, s1, d1 = _parse_bedgraph_numpy(cov_total_path, ranged=ranged)
    n2, s2, d2 = _parse_bedgraph_numpy(cov_mq_path, ranged=ranged)
    if n1 != n2 or len(s1) != len(s2):
        log.error("The two files are not in the same order")
        sys.exit(1)
    out = DepthArrays()
    tot_len = 0
    tot_depth = 0
    tot_mq = 0
    for name, sa, da, sb, db in zip(n1, s1, d1, s2, d2):
        if len(sa) != len(sb) or sa[0] != sb[0]:
            log.error("The two files are not in the same order")
            sys.exit(1)
        for arr, st in ((da, sa), (db, sb)):
            over = arr > 65535
            if np.any(over):
                for i in np.flatnonzero(over):
                    log.warning("The depth at %s:%d-%d was truncated to "
                                "65535. Found %d"
                                % (name, st[i], st[i] + 1, arr[i]))
        # clamp BEFORE accumulating, as the reference does
        # (src/boringbits_main.c:261-285)
        tot_depth += int(np.minimum(da, 65535).sum())
        tot_mq += int(np.minimum(db, 65535).sum())
        tot_len += len(da)
        out.names.append(name)
        out.depth.append(np.minimum(da, 65535).astype(np.uint16))
        out.mq_depth.append(np.minimum(db, 65535).astype(np.uint16))
    if tot_len:
        # C accumulates in double then round()s (half away from zero)
        from cornetto_tpu_torch.utils.cformat import c_round
        out.mean_depth = c_round(float(tot_depth) / float(tot_len))
        out.mean_mq_depth = c_round(float(tot_mq) / float(tot_len))
    return out
