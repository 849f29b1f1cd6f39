"""Encapsulated PostScript emitters matching the reference's eps.h macros
byte-for-byte (reference: src/minidot/eps.h — every coordinate is cast to C
float before %g formatting)."""

from cornetto_tpu_torch.utils.cformat import fmt_g


def header(out, x, y, linewidth):
    out.write("%!PS-Adobe-3.0 EPSF-3.0\n")
    out.write("%%BoundingBox:")
    out.write(" 1 1 %s %s\n\n" % (fmt_g(x), fmt_g(y)))
    out.write("/C { dup 255 and 255 div exch dup -8 bitshift 255 and 255 div 3 1 roll -16 bitshift 255 and 255 div 3 1 roll setrgbcolor } bind def\n")
    out.write("/L { 4 2 roll moveto lineto } bind def\n")
    out.write("/LX { dup 4 -1 roll exch moveto lineto } bind def\n")
    out.write("/LY { dup 4 -1 roll moveto exch lineto } bind def\n")
    out.write("/LS { 3 1 roll moveto show } bind def\n")
    out.write("/MS { dup stringwidth pop 2 div 4 -1 roll exch sub 3 -1 roll moveto show } bind def\n")
    out.write("/RS { dup stringwidth pop 4 -1 roll exch sub 3 -1 roll moveto show } bind def\n")
    out.write("/B { 4 copy 3 1 roll exch 6 2 roll 8 -2 roll moveto lineto lineto lineto closepath } bind def\n")
    out.write("%s setlinewidth\n\n" % fmt_g(linewidth))


def font(out, f, s):
    out.write("/FS %d def\n" % s)
    out.write("/FS4 FS 4 div def\n")
    out.write("/%s findfont FS scalefont setfont\n\n" % f)


def gray(out, g):
    out.write("%s setgray\n" % fmt_g(g))


def linewidth(out, lw):
    out.write("%s setlinewidth\n" % fmt_g(lw))


def mstr(out, x, y, s):
    out.write("%s %s (%s) MS\n" % (fmt_g(x), fmt_g(y), s))


def linex(out, x1, x2, y):
    out.write("%s %s %s LX\n" % (fmt_g(x1), fmt_g(x2), fmt_g(y)))


def liney(out, y1, y2, x):
    out.write("%s %s %s LY\n" % (fmt_g(y1), fmt_g(y2), fmt_g(x)))


def line(out, x1, y1, x2, y2):
    out.write("%s %s %s %s L\n" % (fmt_g(x1), fmt_g(y1), fmt_g(x2),
                                   fmt_g(y2)))


def color(out, col):
    out.write("stroke %d C\n" % col)


def stroke(out):
    out.write("stroke\n")


def bottom(out):
    out.write("stroke showpage\n")
