"""minidot: PAF -> EPS dotplot (miniasm's dotter).

Reference behavior: src/minidot/dotter.c — stream-filter PAF hits
(min span/match/identity), order the target axis by mixed natural-number
name sort and the query axis by weighted mean target coordinate so hits fall
on the diagonal (weight .01*ml^2), then emit an EPS with grid, labels and
red-forward/blue-reverse hit segments.
"""

import sys
from dataclasses import dataclass
from typing import List

import numpy as np

from cornetto_tpu_torch.io import eps
from cornetto_tpu_torch.io.paf import read_paf_minidot
from cornetto_tpu_torch.utils.natsort import mixed_key


@dataclass
class _Hit:
    qn: int
    qs: int
    qe: int
    tn: int
    ts: int
    te: int
    ml: int


class _SeqDict:
    def __init__(self):
        self.index = {}
        self.names: List[str] = []
        self.lens: List[int] = []

    def put(self, name: str, length: int) -> int:
        i = self.index.get(name)
        if i is None:
            i = self.index[name] = len(self.names)
            self.names.append(name)
            self.lens.append(length)
        return i

    @property
    def n_seq(self):
        return len(self.names)


def run(paf_path: str, min_match=100, min_iden=0.1, min_span=1000,
        width=600, font_size=11, no_label=False, diagonal=True,
        out=None) -> int:
    out = out or sys.stdout
    d = [_SeqDict(), _SeqDict()]  # 0 target, 1 query
    hits: List[_Hit] = []
    min_iden_f = np.float32(min_iden)
    for r in read_paf_minidot(paf_path):
        if (r.qe - r.qs < min_span or r.te - r.ts < min_span
                or r.ml < min_match):
            continue
        # C compares int < int*float in float arithmetic
        if np.float32(r.ml) < np.float32(r.bl) * min_iden_f:
            continue
        qn = d[1].put(r.qn, r.ql)
        tn = d[0].put(r.tn, r.tl)
        ts, te = (r.te, r.ts) if r.rev else (r.ts, r.te)
        hits.append(_Hit(qn, r.qs, r.qe, tn, ts, te, r.ml))

    acclen = [None, None]
    totlen = [0, 0]
    order = [None, None]  # sorted list of original ids
    for i in (0, 1):
        n = d[i].n_seq
        if i == 0 or not diagonal:
            order[i] = sorted(range(n), key=lambda j: mixed_key(d[i].names[j]))
        else:
            tot = [0.0] * n
            wsum = [0] * n
            for p in hits:
                coor = acclen[0][p.tn] + (p.ts + p.te) // 2
                w = int(0.01 * p.ml * p.ml + 0.499)
                tot[p.qn] += float(coor) * w
                wsum[p.qn] += w
            keyvals = []
            with np.errstate(divide="ignore", invalid="ignore"):
                for j in range(n):
                    keyvals.append(tot[j] / wsum[j] if wsum[j]
                                   else (float("nan") if tot[j] == 0
                                         else float("inf")))
            order[i] = sorted(range(n), key=lambda j: keyvals[j])
        acc = [0] * n
        l = 0
        for j in order[i]:
            acc[j] = l
            l += d[i].lens[j]
        acclen[i] = acc
        totlen[i] = l

    if totlen[0] == 0 or totlen[1] == 0:
        # C would divide by zero producing inf/nan geometry; real inputs
        # always have hits.  Emit an empty plot header for robustness.
        height = 0
    else:
        height = int(float(width) / totlen[0] * totlen[1] + 0.499)
    sx = float(width) / totlen[0] if totlen[0] else 0.0
    sy = float(height) / totlen[1] if totlen[1] else 0.0

    eps.header(out, width, height, 0.2)
    eps.font(out, "Helvetica-Narrow", font_size)
    eps.gray(out, 0.8)

    if not no_label:
        for j in order[0]:
            eps.mstr(out, (acclen[0][j] + 0.5 * d[0].lens[j]) * sx,
                     font_size * 0.5, d[0].names[j])
        eps.stroke(out)
        out.write("gsave %g 0 translate 90 rotate\n" % (font_size * 1.25))
        for j in order[1]:
            # NB the reference scales y labels by sx as well (:156)
            eps.mstr(out, (acclen[1][j] + 0.5 * d[1].lens[j]) * sx, 0,
                     d[1].names[j])
        out.write("grestore\n")
        eps.stroke(out)

    eps.linewidth(out, 0.1)
    for idx, j in enumerate(order[1]):
        eps.linex(out, 1, width, 1 if idx == 0 else acclen[1][j] * sy)
    eps.linex(out, 1, width, totlen[1] * sy)
    for idx, j in enumerate(order[0]):
        eps.liney(out, 1, height, 1 if idx == 0 else acclen[0][j] * sx)
    eps.liney(out, 1, height, totlen[0] * sx)
    eps.stroke(out)

    eps.linewidth(out, 0.1)
    for jcol, col in ((0, 0xFF0000), (1, 0x0080FF)):
        eps.color(out, col)
        for p in hits:
            if jcol == 0 and p.ts > p.te:
                continue
            if jcol == 1 and p.ts < p.te:
                continue
            xo, yo = acclen[0][p.tn], acclen[1][p.qn]
            eps.line(out, (p.ts + xo) * sx, (p.qs + yo) * sy,
                     (p.te + xo) * sx, (p.qe + yo) * sy)
        eps.stroke(out)
    eps.bottom(out)
    return 0


def main(argv) -> int:
    import getopt as _getopt
    from cornetto_tpu_torch.utils.parsing import c_atof, c_atoi
    kw = {}
    png_path = None
    try:
        opts, args = _getopt.gnu_getopt(argv, "m:i:s:w:f:Ld", ["png="])
    except _getopt.GetoptError:
        return 1
    for flag, val in opts:
        if flag == "--png":
            # our extension over the reference (EPS-only): also rasterize
            # the dotplot to a PNG via io.raster (no ghostscript needed)
            png_path = val
        elif flag == "-m":
            kw["min_match"] = c_atoi(val)
        elif flag == "-i":
            kw["min_iden"] = c_atof(val)
        elif flag == "-s":
            kw["min_span"] = c_atoi(val)
        elif flag == "-w":
            kw["width"] = c_atoi(val)
        elif flag == "-f":
            kw["font_size"] = c_atoi(val)
        elif flag == "-L":
            kw["no_label"] = True
        elif flag == "-d":
            kw["diagonal"] = False
    if not args:
        e = sys.stderr
        e.write("Usage: minidot [options] <in.paf>\n")
        e.write("Options:\n")
        e.write("  -m INT      min match length [%d]\n" % 100)
        e.write("  -i FLOAT    min identity [%.2f]\n" % 0.1)
        e.write("  -s INT      min span [%d]\n" % 1000)
        e.write("  -w INT      image width [%d]\n" % 600)
        e.write("  -f INT      font size [%d]\n" % 11)
        e.write("  -L          don't print labels\n")
        e.write("  -D          don't try to put hits onto the diagonal\n")
        e.write("  --png FILE  also rasterize the plot to a PNG\n")
        return 1
    if png_path is None:
        return run(args[0], **kw)
    import io as _io
    buf = _io.StringIO()
    ret = run(args[0], out=buf, **kw)
    sys.stdout.write(buf.getvalue())
    from cornetto_tpu_torch.io.raster import rasterize_eps, write_png
    write_png(png_path, rasterize_eps(buf.getvalue()))
    return ret
