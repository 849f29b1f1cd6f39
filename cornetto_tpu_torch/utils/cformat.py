"""C-semantics numeric helpers for byte-identical output parity.

The reference C toolkit leans on C integer/float semantics in several output
paths (reference: src/boringbits_main.c:293-294,360-361,518-519;
src/bigenough_main.c:206).  These helpers reproduce them exactly.
"""

import math


def c_round(x: float) -> int:
    """C round(): half away from zero (reference: round() in
    src/boringbits_main.c:293,518-519)."""
    if x >= 0:
        return int(math.floor(x + 0.5))
    return int(math.ceil(x - 0.5))


def c_div(a: int, b: int) -> int:
    """C integer division: truncation toward zero."""
    q = abs(a) // abs(b)
    if (a < 0) != (b < 0):
        q = -q
    return int(q)


def wrap_i32(x: int) -> int:
    """Wrap a Python int to signed 32-bit two's-complement, mimicking C int
    overflow as produced by gcc (reference: the `(end-start)*threshold`
    product in src/bigenough_main.c:206 overflows int for contigs > ~42 Mb
    at the default threshold of 50; the golden outputs bake this in)."""
    x &= 0xFFFFFFFF
    if x >= 0x80000000:
        x -= 0x100000000
    return x
