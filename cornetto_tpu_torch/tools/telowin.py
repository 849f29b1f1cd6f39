"""telowin: telomere-coverage sliding windows.

Reference behavior: src/telomere_windows.c — per-scaffold coverage bitmap,
1000-bp windows stepped by 200, pass threshold scaled by identity^6, output
``Window name len start end frac`` with %.3g fraction.
"""

import sys

import numpy as np

WINDOW_SIZE = 1000
MIN_OFFSET = 0


def process_scaffold(out, name: str, bitmap, length: int,
                     threshold: float) -> None:
    if bitmap is None:
        return
    # prefix sums for O(1) window counts (replaces the per-window bit loop,
    # reference :31-43)
    cs = np.zeros(length + 1, dtype=np.int64)
    if length:
        np.cumsum(bitmap[:length], out=cs[1:])
    step = WINDOW_SIZE // 5
    i = MIN_OFFSET
    while i <= length:
        hi = min(i + WINDOW_SIZE, length)
        car = int(cs[hi] - cs[i]) if i < length else 0
        den = WINDOW_SIZE if (i + WINDOW_SIZE < length) else (length - i)
        if den != 0 and car / den >= threshold:
            out.write("Window\t%s\t%d\t%d\t%d\t%.3g\n"
                      % (name, length, i, i + den, car / den))
        elif den == 0:
            # C computes 0/0 (NaN) or x/0; NaN >= t is false, inf >= t true —
            # car is 0 when den is 0 here, so NaN: never printed.
            pass
        if i + WINDOW_SIZE >= length:
            break
        i += step


def run(input_path: str, identity_pct: float, threshold: float,
        out=None) -> None:
    out = out or sys.stdout
    identity = identity_pct / 100.0
    threshold = threshold * (identity ** 6)
    sys.stderr.write("Given error rate of %.6f running with adjusted "
                     "threshold of %.6f due to survival prob %.6f\n"
                     % (identity, threshold, identity ** 6))
    name = ""
    bitmap = None
    length = 0
    with open(input_path) as fp:
        for line in fp:
            parts = line.split()
            if len(parts) < 6:
                parts = parts + [""] * (6 - len(parts))
            if bitmap is None or parts[0] != name:
                process_scaffold(out, name, bitmap, length, threshold)
                from cornetto_tpu_torch.utils.parsing import c_atoi
                length = c_atoi(parts[1])
                bitmap = np.zeros(max(length, 1), dtype=np.uint8)
                name = parts[0]
            from cornetto_tpu_torch.utils.parsing import c_atoi
            start = c_atoi(parts[3])
            end = c_atoi(parts[4])
            if end > start:
                bitmap[start:end] = 1
    process_scaffold(out, name, bitmap, length, threshold)


def main(argv) -> int:
    from cornetto_tpu_torch.utils.parsing import c_atof
    if len(argv) < 2:
        sys.stderr.write("Usage: cornetto telowin <input_file> <identity> "
                         "<threshold>\n")
        sys.stderr.write("This program analyzes telomere windows in a genome "
                         "assembly.\n")
        sys.stderr.write("Example usage: cornetto telowin input.telomere "
                         "99.9 0.4\n")
        return 1
    threshold = 0.4
    if len(argv) >= 3:
        threshold = c_atof(argv[2])
    run(argv[0], c_atof(argv[1]), threshold)
    return 0
