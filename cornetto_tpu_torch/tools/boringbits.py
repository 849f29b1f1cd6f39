"""boringbits / noboringbits on the port: counterpart of
cornetto_tpu/tools/boringbits.py.

The four scan functions (``run``, ``_run_streaming``, ``iter_fun_windows``,
``_iter_fun_windows_streaming``) and ``main`` are the JAX module's, with the
window scan on the port's ``kernels.window_sum.window_stats`` (the CUDA
window-sum kernel on a card) instead of window_stats_jax.  The options,
thresholds, printers and help text are copies of the JAX module's host
code, so the output stays byte-identical to the C tool's.  The uint16
tracks go to the card as they are.
"""

import sys
from dataclasses import dataclass

import numpy as np

from cornetto_tpu_torch.io.bed import read_bedgraph_pair
from cornetto_tpu_torch.kernels.window_sum import (resolve_backend,
                                                   window_stats,
                                                   window_stats_numpy)
from cornetto_tpu_torch.utils import logging as log
from cornetto_tpu_torch.utils.cformat import c_round

__all__ = ["BoringbitsOptions", "run", "iter_fun_windows", "main"]


@dataclass
class BoringbitsOptions:
    window_size: int = 2500
    window_inc: int = 50
    low_cov_thresh: float = 0.4
    high_cov_thresh: float = 2.5
    low_mq_cov_thresh: float = 0.4
    min_ctg_len: int = 1000000
    edge_len: int = 100000
    boring: bool = True
    backend: str = "auto"  # "auto" | "numpy" ("jax" exits 1)
    # two-pass streaming: pass 1 scans sums/means with NO depth storage,
    # pass 2 re-parses yielding one contig pair at a time — peak memory
    # drops from 2 B/base held for the whole genome to the largest
    # contig, at the cost of parsing the tracks twice.  "auto" (default)
    # enables it for plain-text pairs over ~4 GB, where the second parse
    # is cheap (500 Mbp measured: 67 s / 0.7 GB two-pass vs 54 s /
    # 2.3 GB in-memory vs reference C 227 s / 2.0 GB); gz tracks pay the
    # inflate twice, so they stay in-memory unless forced
    low_mem: str = "auto"   # "auto" | "yes" | "no"
    # accept run-length bedgraph rows (aligner-free approx-panel tracks
    # from livefish.coverage); the strict default is reference parity
    ranged_bedgraph: bool = False


def _want_low_mem(opt: BoringbitsOptions, ct: str, cm: str) -> bool:
    if opt.ranged_bedgraph or opt.low_mem in (False, "no"):
        return False
    if opt.low_mem in (True, "yes"):
        return True
    import os as _os
    from cornetto_tpu_torch.io.bed import _is_gzip
    try:
        big = _os.path.getsize(ct) + _os.path.getsize(cm) > (4 << 30)
        return big and not _is_gzip(ct) and not _is_gzip(cm)
    except OSError:
        return False


def _prefetch(gen, depth: int = 2):
    """Run a generator on its own thread with a small queue so the two
    per-contig track streams parse concurrently (peak memory grows by at
    most `depth` extra contigs).  Worker failures (including the
    SystemExit a parse error raises) are re-raised in the consumer — a
    swallowed pass-2 error would end the zip early and emit TRUNCATED
    output with exit status 0."""
    import queue
    import threading
    q = queue.Queue(maxsize=depth)
    DONE = object()
    err = []

    def work():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:
            err.append(e)
        finally:
            q.put(DONE)

    threading.Thread(target=work, daemon=True).start()
    while True:
        item = q.get()
        if item is DONE:
            if err:
                raise err[0]
            return
        yield item


def _violations(st, end, d, mq, thresh_low, thresh_high, low_mq_factor):
    # mq/depth < factor with C double division against a C *float* threshold
    # (promoted to double — src/boringbits_main.c:439); depth==0 gives
    # inf/nan: 0/0.0 is NaN (comparison false), x/0.0 is +inf (false).
    factor = float(np.float32(low_mq_factor))
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = mq.astype(np.float64) / d.astype(np.float64)
        low_mq = ratio < factor
        low_mq = np.where(np.isnan(ratio), False, low_mq)
    return (d < thresh_low) | (d > thresh_high) | low_mq


def _print_fun(out, name, ctg_len, st, end, d, mq, thresh_low, thresh_high,
               opt: BoringbitsOptions):
    # reference: print_fun_bits (src/boringbits_main.c:425-445).  NB quirk:
    # small contigs print 0..min_ctg_len even when shorter than that.
    if ctg_len < opt.min_ctg_len:
        out.write("%s\t%d\t%d\t.\t.\n" % (name, 0, opt.min_ctg_len))
        return
    out.write("%s\t%d\t%d\t.\t.\n" % (name, 0, opt.edge_len))
    out.write("%s\t%d\t%d\t.\t.\n" % (name, ctg_len - opt.edge_len, ctg_len))
    viol = _violations(st, end, d, mq, thresh_low, thresh_high,
                       opt.low_mq_cov_thresh)
    idx = np.flatnonzero(viol)
    if len(idx):
        out.write("".join("%s\t%d\t%d\t%d\t%d\n"
                          % (name, st[j], end[j], d[j], mq[j])
                          for j in idx))


def _print_boring(out, name, ctg_len, st, end, d, mq, thresh_low, thresh_high,
                  opt: BoringbitsOptions):
    # reference: print_boring_bits (src/boringbits_main.c:463-481)
    if ctg_len <= opt.min_ctg_len:
        return
    viol = _violations(st, end, d, mq, thresh_low, thresh_high,
                       opt.low_mq_cov_thresh)
    inner = (st > opt.edge_len) & (end < ctg_len - opt.edge_len)
    keep = inner & ~viol
    idx = np.flatnonzero(keep)
    if len(idx):
        out.write("".join("%s\t%d\t%d\t%d\t%d\n"
                          % (name, st[j], end[j], d[j], mq[j])
                          for j in idx))


def _stats_fn(opt: BoringbitsOptions):
    return window_stats if resolve_backend(opt.backend) == "torch" \
        else window_stats_numpy


def _thresholds(opt: BoringbitsOptions, mean_depth: int):
    # The C thresholds are computed in *float* arithmetic (the option fields
    # are C floats — src/boringbits_main.c:71-73), then round()ed as double
    return (c_round(float(np.float32(opt.low_cov_thresh)
                          * np.float32(mean_depth))),
            c_round(float(np.float32(opt.high_cov_thresh)
                          * np.float32(mean_depth))))


def _write_header(opt: BoringbitsOptions, n_contigs: int, mean_depth: int,
                  mean_mq: int) -> None:
    sys.stderr.write("Number of contigs: %d\n" % n_contigs)
    sys.stderr.write("Average depth: %d\n" % mean_depth)
    sys.stderr.write("Average mq depth: %d\n" % mean_mq)
    sys.stderr.write("Window size: %d\n" % opt.window_size)
    sys.stderr.write("Window increment: %d\n" % opt.window_inc)
    sys.stderr.write("Low coverage threshold: %.1fx%d\n"
                     % (opt.low_cov_thresh, mean_depth))
    sys.stderr.write("High coverage threshold: %.1fx%d\n"
                     % (opt.high_cov_thresh, mean_depth))
    sys.stderr.write("Low mapq coverage threshold: %.1f\n"
                     % opt.low_mq_cov_thresh)
    sys.stderr.write("Min contig length: %d\n" % opt.min_ctg_len)
    sys.stderr.write("Edge length: %d\n" % opt.edge_len)


def _print_contig(out, name, depth, mq_depth, stats_fn, thresh_low,
                  thresh_high, opt: BoringbitsOptions) -> None:
    st, end, d, mq = stats_fn(depth, mq_depth, opt.window_size,
                              opt.window_inc)
    printer = _print_boring if opt.boring else _print_fun
    printer(out, name, len(depth), st, end, d, mq, thresh_low, thresh_high,
            opt)


def run(cov_total_path: str, cov_mq_path: str, opt: BoringbitsOptions,
        out=None) -> None:
    out = out or sys.stdout
    stats_fn = _stats_fn(opt)
    if _want_low_mem(opt, cov_total_path, cov_mq_path):
        if _run_streaming(cov_total_path, cov_mq_path, opt, out, stats_fn):
            return
        # native kernel unavailable: fall through to the in-memory path
    depths = read_bedgraph_pair(cov_total_path, cov_mq_path,
                                ranged=opt.ranged_bedgraph)
    _write_header(opt, len(depths.names), depths.mean_depth,
                  depths.mean_mq_depth)
    thresh_low, thresh_high = _thresholds(opt, depths.mean_depth)
    for name, depth, mq_depth in zip(depths.names, depths.depth,
                                     depths.mq_depth):
        _print_contig(out, name, depth, mq_depth, stats_fn, thresh_low,
                      thresh_high, opt)


def _scan_pair(cov_total_path: str, cov_mq_path: str):
    """Pass 1 of the low-memory scheme over both tracks (zlib and the native
    parser release the GIL, so they overlap); None when the native kernel
    is missing."""
    from concurrent.futures import ThreadPoolExecutor
    from cornetto_tpu_torch.io.bed import scan_depth_track
    with ThreadPoolExecutor(2) as ex:
        fa = ex.submit(scan_depth_track, cov_total_path)
        fb = ex.submit(scan_depth_track, cov_mq_path)
        a, b = fa.result(), fb.result()
    if a is None or b is None:
        return None
    if a[0] != b[0] or a[1] != b[1] or a[2] != b[2]:
        log.error("The two files are not in the same order")
        sys.exit(1)
    return a, b


def _iter_pass2(cov_total_path: str, cov_mq_path: str, names, lens):
    """Pass 2: one contig pair at a time; never ends early unnoticed."""
    from cornetto_tpu_torch.io.bed import iter_depth_contigs
    n_done = 0
    for item in zip(names,
                    _prefetch(iter_depth_contigs(cov_total_path, lens)),
                    _prefetch(iter_depth_contigs(cov_mq_path, lens))):
        n_done += 1
        yield item
    if n_done != len(names):
        # pass 2 saw fewer contigs than pass 1 (file changed between
        # passes?) — never emit truncated output with exit status 0
        log.error("low-mem pass 2 yielded %d of %d contigs"
                  % (n_done, len(names)))
        sys.exit(1)


def _run_streaming(cov_total_path: str, cov_mq_path: str,
                   opt: BoringbitsOptions, out, stats_fn) -> bool:
    """Two-pass low-memory noboringbits: byte-identical stdout/stderr to
    the in-memory path, peak host RSS = largest contig x 2 tracks + one
    parse window."""
    scanned = _scan_pair(cov_total_path, cov_mq_path)
    if scanned is None:
        return False
    (n1, len1, _f1, sum1, tr1, tot1), (_n2, _l2, _f2, sum2, tr2, tot2) = \
        scanned
    # truncation warnings in the in-memory path's order: per contig,
    # file A then file B
    for k, name in enumerate(n1):
        for truncs in (tr1, tr2):
            for ci, pos, v in truncs:
                if ci == k:
                    log.warning("The depth at %s:%d-%d was truncated to "
                                "65535. Found %d" % (name, pos, pos + 1, v))
    if tot1 > len(tr1) or tot2 > len(tr2):
        log.warning("%d additional depth truncations not listed"
                    % ((tot1 - len(tr1)) + (tot2 - len(tr2))))
    tot_len = sum(len1)
    mean_depth = c_round(float(sum1) / float(tot_len)) if tot_len else 0
    mean_mq = c_round(float(sum2) / float(tot_len)) if tot_len else 0
    _write_header(opt, len(n1), mean_depth, mean_mq)
    thresh_low, thresh_high = _thresholds(opt, mean_depth)
    for name, depth, mq_depth in _iter_pass2(cov_total_path, cov_mq_path,
                                             n1, len1):
        _print_contig(out, name, depth, mq_depth, stats_fn, thresh_low,
                      thresh_high, opt)
    return True


def _fun_rows(name, depth, mq_depth, stats_fn, thresh_low, thresh_high,
              opt: BoringbitsOptions):
    st, end, d, mq = stats_fn(depth, mq_depth, opt.window_size,
                              opt.window_inc)
    viol = _violations(st, end, d, mq, thresh_low, thresh_high,
                       opt.low_mq_cov_thresh)
    for j in np.flatnonzero(viol):
        yield (name, int(st[j]), int(end[j]))


def iter_fun_windows(cov_total_path: str, cov_mq_path: str,
                     opt: BoringbitsOptions):
    """Yield (name, st, end) for threshold-violating windows of contigs
    >= min_ctg_len — i.e. the noboringbits rows whose 4th column is numeric,
    as selected by the create-cornetto pipeline's awk filter
    (reference: scripts/create-cornetto.sh:41)."""
    stats_fn = _stats_fn(opt)
    if _want_low_mem(opt, cov_total_path, cov_mq_path):
        got = _iter_fun_windows_streaming(cov_total_path, cov_mq_path, opt,
                                          stats_fn)
        if got is not None:
            yield from got
            return
    depths = read_bedgraph_pair(cov_total_path, cov_mq_path,
                                ranged=opt.ranged_bedgraph)
    thresh_low, thresh_high = _thresholds(opt, depths.mean_depth)
    for name, depth, mq_depth in zip(depths.names, depths.depth,
                                     depths.mq_depth):
        if len(depth) >= opt.min_ctg_len:
            yield from _fun_rows(name, depth, mq_depth, stats_fn,
                                 thresh_low, thresh_high, opt)


def _iter_fun_windows_streaming(cov_total_path, cov_mq_path,
                                opt: BoringbitsOptions, stats_fn):
    """Low-memory twin of iter_fun_windows (same two-pass scheme as
    _run_streaming; returns None when the native kernel is missing)."""
    scanned = _scan_pair(cov_total_path, cov_mq_path)
    if scanned is None:
        return None
    n1, len1, _f1, sum1 = scanned[0][:4]

    def gen():
        tot_len = sum(len1)
        mean_depth = c_round(float(sum1) / float(tot_len)) if tot_len \
            else 0
        thresh_low, thresh_high = _thresholds(opt, mean_depth)
        for name, depth, mq_depth in _iter_pass2(cov_total_path,
                                                 cov_mq_path, n1, len1):
            if len(depth) >= opt.min_ctg_len:
                yield from _fun_rows(name, depth, mq_depth, stats_fn,
                                     thresh_low, thresh_high, opt)
    return gen()


def main(argv, boring: bool) -> int:
    """CLI entry matching `cornetto boringbits|noboringbits`
    (reference: src/boringbits_main.c:558-660)."""
    import getopt as _getopt
    from cornetto_tpu_torch.utils.parsing import (c_atof, c_atoi,
                                                  parse_num_suffix)
    opt = BoringbitsOptions(boring=boring)
    covmq = None
    fp_help = sys.stderr
    try:
        opts, args = _getopt.gnu_getopt(
            argv, "t:B:K:v:o:q:Q:H:L:w:i:e:m:hV",
            ["threads=", "batchsize=", "max-bytes=", "verbose=", "help",
             "version", "output=", "debug-break=", "profile-cpu=", "accel=",
             "qual=", "window-size=", "window-inc=", "low-thresh=",
             "high-thresh=", "low-mq-thresh=", "min-ctg-len=", "edge-len=",
             "backend=", "low-mem"])
    except _getopt.GetoptError as e:
        log.error(str(e))
        return 1
    for flag, val in opts:
        if flag in ("-q", "--qual"):
            covmq = val
        elif flag in ("-w", "--window-size"):
            opt.window_size = c_atoi(val)
        elif flag in ("-i", "--window-inc"):
            opt.window_inc = c_atoi(val)
        elif flag in ("-L", "--low-thresh"):
            opt.low_cov_thresh = c_atof(val)
        elif flag in ("-H", "--high-thresh"):
            opt.high_cov_thresh = c_atof(val)
        elif flag in ("-Q", "--low-mq-thresh"):
            opt.low_mq_cov_thresh = c_atof(val)
        elif flag in ("-m", "--min-ctg-len"):
            opt.min_ctg_len = c_atoi(val)
        elif flag in ("-e", "--edge-len"):
            opt.edge_len = c_atoi(val)
        elif flag in ("-v", "--verbose"):
            log.set_log_level(c_atoi(val))
        elif flag == "--backend":
            opt.backend = val
        elif flag == "--low-mem":
            opt.low_mem = "yes"
        elif flag in ("-V", "--version"):
            from cornetto_tpu_torch.version import __version__
            sys.stdout.write("cornetto-tpu %s\n" % __version__)
            return 0
        elif flag in ("-h", "--help"):
            fp_help = sys.stdout
        elif flag == "-B":
            parse_num_suffix(val)
    if len(args) != 1 or fp_help is sys.stdout or covmq is None:
        _help(fp_help, opt)
        return 0 if fp_help is sys.stdout else 1
    run(args[0], covmq, opt)
    return 0


def _help(fp, opt: BoringbitsOptions):
    fp.write("Usage: cornetto boringbits cov-total.bg -q cov-mq20.bg\n")
    fp.write("\nbasic options:\n")
    fp.write("   -q FILE                    depth file with high mapq read coverage\n")
    fp.write("   -w INT                     window size [%d]\n" % opt.window_size)
    fp.write("   -i INT                     window increment [%d]\n" % opt.window_inc)
    fp.write("   -L FLOAT                   low coverage threshold factor [%.1f]\n" % opt.low_cov_thresh)
    fp.write("   -H FLOAT                   high coverage threshold factor [%.1f]\n" % opt.high_cov_thresh)
    fp.write("   -Q FLOAT                   mapq low coverage threshold factor [%.1f]\n" % opt.low_mq_cov_thresh)
    fp.write("   -m INT                     minimum contig length [%d]\n" % opt.min_ctg_len)
    fp.write("   -e INT                     edge length to ignore [%d]\n" % opt.edge_len)
    fp.write("   -h                         help\n")
    fp.write("   --verbose INT              verbosity level [%d]\n" % log.get_log_level())
