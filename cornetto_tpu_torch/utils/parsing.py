"""Option/number parsing helpers matching reference semantics."""


def parse_num_suffix(s: str) -> int:
    """Parse a number with optional K/M/G suffix (reference: mm_parse_num,
    src/misc.c:72-84): strtod then scale, then (int64)(x + .499)."""
    i = 0
    n = len(s)
    # strtod prefix scan
    seen_digit = False
    if i < n and s[i] in "+-":
        i += 1
    while i < n and (s[i].isdigit() or s[i] == "."):
        if s[i].isdigit():
            seen_digit = True
        i += 1
    if i < n and s[i] in "eE" and seen_digit:
        j = i + 1
        if j < n and s[j] in "+-":
            j += 1
        if j < n and s[j].isdigit():
            while j < n and s[j].isdigit():
                j += 1
            i = j
    x = float(s[:i]) if seen_digit else 0.0
    suffix = s[i] if i < n else ""
    if suffix in "Gg":
        x *= 1e9
    elif suffix in "Mm":
        x *= 1e6
    elif suffix in "Kk":
        x *= 1e3
    return int(x + 0.499)


def c_atoi(s: str) -> int:
    """C atoi: parse optional sign + leading digits, 0 on no digits."""
    s = s.lstrip(" \t\n\r\v\f")
    i = 0
    if i < len(s) and s[i] in "+-":
        i += 1
    j = i
    while j < len(s) and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


def c_atof(s: str) -> float:
    """C atof: strtod prefix, 0.0 on no parse."""
    s = s.lstrip(" \t\n\r\v\f")
    import re
    m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    if not m:
        return 0.0
    return float(m.group(0))
