"""The seeded draft assembly both configurations share: chromosome lengths
from the configuration, random sequence made on the device in one call,
then what the configuration plants in it.  The generators are those of
chip_smoke.py (human_draft, genome_codes, plant_repeats, panel_rows,
write_annotation_draft), frozen here; the sequence itself is drawn with a
torch.Generator on the run's device instead of numpy on the host.
"""

import numpy as np

from portbench import harness

ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)
SAT_UNITS = ["A", "AT", "ATT", "AATG", "ATTCC", "GGAATC"]


def genome(cfg: dict, seed: int, device):
    """(codes, starts): the contigs' 2-bit codes (0-3) end to end as one
    host uint8 array, and each contig's start in it."""
    import torch
    lens = [n for _, n in cfg["contigs"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(harness.torch_seed(seed, harness.DRAFT))
    codes = torch.randint(0, 4, (sum(lens),), generator=gen, device=device,
                          dtype=torch.uint8).cpu().numpy()
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return codes, starts


def plant_repeats(cfg: dict, seed: int, codes, starts):
    """Write cfg["repeat"]["copies"] seeded copies of one seeded element of
    cfg["repeat"]["len"] bases into the codes, in place, half of them
    reverse-complemented, in a seeded order; returns the element."""
    rep = cfg["repeat"]
    n, copies = rep["len"], rep["copies"]
    rng = harness.rng(seed, harness.REPEAT)
    elem = rng.integers(0, 4, size=n, dtype=np.uint8)
    lens = np.array([m for _, m in cfg["contigs"]], dtype=np.int64)
    ctg = rng.choice(len(lens), size=copies, p=lens / lens.sum())
    at = starts[ctg] + (rng.random(copies) * (lens[ctg] - n)).astype(np.int64)
    flip = rng.random(copies) < 0.5
    relem = (3 - elem[::-1]).copy()
    for s, f in zip(at.tolist(), flip.tolist()):
        codes[s:s + n] = relem if f else elem
    return elem


def panel_rows(cfg: dict, seed: int):
    """A seeded share of each contig's blocks as (name, start, end) rows."""
    block, share = cfg["panel"]["block"], cfg["panel"]["share"]
    rng = harness.rng(seed, harness.PANEL)
    rows = []
    for name, n in cfg["contigs"]:
        nb = -(-n // block)
        for b in np.flatnonzero(rng.random(nb) < share).tolist():
            rows.append((name, b * block, min((b + 1) * block, n)))
    return rows


def _tile(unit: str, n: int) -> np.ndarray:
    return np.frombuffer((unit * (n // len(unit) + 1))[:n].encode(),
                         dtype=np.uint8)


def annotation_features(cfg: dict, seed: int, ci: int, n: int):
    """One contig's features as (start, unit, length) in the order they are
    written (satellites, then telomere arrays, then N gaps on top): about
    cfg's share of bases in short-period satellite arrays, (CCCTAA)n and
    (TTAGGG)n arrays at the two ends, interstitial telomere arrays and N
    gaps at seeded places at least cfg's margin from the ends."""
    f = cfg["features"]
    rng = harness.rng(seed, harness.FEATURES, ci)
    lo, hi = f["margin"], n - f["margin"]

    def loglen(a, b):
        return int(np.exp(rng.uniform(np.log(a), np.log(b))))
    telo = [(int(rng.integers(lo, hi)), unit, int(ln)) for unit, ln in zip(
        rng.choice(["TTAGGG", "CCCTAA"], f["interstitial_telomeres"]),
        rng.integers(f["interstitial_len"][0], f["interstitial_len"][1] + 1,
                     f["interstitial_telomeres"]))]
    telo.append((0, "CCCTAA", int(rng.integers(f["end_telomere_len"][0],
                                               f["end_telomere_len"][1] + 1))))
    end = int(rng.integers(f["end_telomere_len"][0],
                           f["end_telomere_len"][1] + 1))
    telo.append((n - end, "TTAGGG", end))
    gaps = [(int(rng.integers(lo, hi)), "N", loglen(*f["gap_len"]))
            for _ in range(f["gaps"])]
    sat, bp = [], 0
    while bp < n * f["satellite_share"]:
        p = int(rng.integers(f["satellite_period"][0],
                             f["satellite_period"][1] + 1))
        unit = SAT_UNITS[p - 1] if rng.random() < 0.5 else \
            "".join("ACGT"[j] for j in rng.integers(0, 4, p))
        ln = loglen(*f["satellite_len"])
        sat.append((int(rng.integers(lo, hi)), unit, ln))
        bp += ln
    return sat + sorted(telo) + sorted(gaps)


def annotation_text(cfg: dict, seed: int, codes, starts):
    """Each contig as uppercase ASCII (N in the gaps) with its features
    written in, and the features as (start, unit, written length)."""
    texts, feats = [], []
    for ci, (name, n) in enumerate(cfg["contigs"]):
        text = ASCII[codes[starts[ci]:starts[ci] + n]]
        done = []
        for s, unit, ln in annotation_features(cfg, seed, ci, n):
            ln = min(ln, n - s)
            text[s:s + ln] = _tile(unit, ln)
            done.append((s, unit, ln))
        texts.append(text)
        feats.append(done)
    return texts, feats
