"""telobreaks: internal telomere-break (misjoin) detection.

Reference behavior: src/telomere_breaks.c — per-scaffold low-complexity
bitsets from sdust intervals; telomere runs >= 24 bp whose +/-100 bp
neighbourhood is entirely low-complexity are extended maximally through the
low-complexity run and reported.  The report loop iterates the scaffold map
in khash order (reference :133-148), reproduced via utils.khash.KHashStr.
"""

import sys

import numpy as np

from cornetto_tpu_torch.utils.khash import KHashStr
from cornetto_tpu_torch.utils.parsing import c_atoi

MIN_TEL = 24


def run(lens_path: str, sdust_path: str, telomere_path: str, out=None) -> None:
    out = out or sys.stdout
    scaff = KHashStr()      # name -> low-complexity bitmap
    final = KHashStr()      # name -> final marked bitmap
    lengths = {}
    with open(lens_path) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            name = parts[0]
            length = c_atoi(parts[1]) if len(parts) > 1 else 0
            scaff[name] = np.zeros(max(length, 0), dtype=bool)
            final[name] = np.zeros(max(length, 0), dtype=bool)
            lengths[name] = length

    with open(sdust_path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) < 3:
                continue
            name = parts[0]
            if name in scaff:
                start, end = c_atoi(parts[1]), c_atoi(parts[2])
                scaff[name][start:end] = True

    with open(telomere_path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) < 6:
                continue
            name = parts[0]
            start, end, matched_len = (c_atoi(parts[3]), c_atoi(parts[4]),
                                       c_atoi(parts[5]))
            if matched_len < MIN_TEL or name not in scaff:
                continue
            bits = scaff[name]
            length = lengths[name]
            r_start = max(start - 100, 0)
            r_end = min(end + 100, len(bits))
            if not np.all(bits[r_start:r_end]):
                continue
            # extend maximally through the low-complexity run
            lo = start
            while lo > 0 and bits[lo - 1]:
                lo -= 1
            hi = end
            while hi < length and bits[hi]:
                hi += 1
            final[name][lo:hi] = True

    for name, bits in final.items():
        length = lengths[name]
        marked = np.flatnonzero(bits[:length])
        if len(marked) == 0:
            continue
        # runs of consecutive marked positions
        breaks = np.flatnonzero(np.diff(marked) > 1)
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [len(marked) - 1]])
        for s_i, e_i in zip(starts, ends):
            run_start = int(marked[s_i])
            run_end = int(marked[e_i]) + 1  # exclusive
            lo = max(run_start - 1, 0)
            out.write("Found telomere positions %d to %d is a telomere in "
                      "%s of length %d\n" % (lo, run_end - 1, name, length))


def main(argv) -> int:
    if len(argv) < 3:
        sys.stderr.write("Usage: telobreaks <lens_file> <sdust_file> "
                         "<telomere_file>\n")
        return 1
    run(argv[0], argv[1], argv[2])
    return 0
