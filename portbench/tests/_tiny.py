"""Tiny cells of both runners, added to a copy of the benchmark as new files
only (a configuration, a traffic mix and BENCHMARK.json entries), for the
CPU tests."""

import json
import shutil
from pathlib import Path

from portbench import harness

RU, AN = "readuntil-tiny", "annot-tiny"


def _dump(path: Path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def add_tiny_cells(root: Path) -> None:
    """Write the tiny configurations, mixes and cells into root, a copy of
    the checkout's BENCHMARK.json and portbench/."""
    pb = root / "portbench"
    ci = harness.config("synth-chr1-3-index")
    ci.update(name="tiny-index", contigs=[["c1", 300000], ["c2", 200000]],
              repeat={"len": 300, "copies": 400},
              panel={"block": 50000, "share": 0.5})
    # 400 copies of the element put each of its minimizers ~20 times into
    # the index, over this cap: the element is masked, as at full size
    ci["index"]["repeat_cap"] = 8
    # the table's floor (2^17 buckets) leaves it nearly empty: the control
    # takes one 64 times narrower, so that it drops most entries
    ci["control"]["narrower"] = 6
    _dump(pb / "configs" / "tiny-index.json", ci)
    ca = harness.config("synth-chr1-3-annot")
    ca.update(name="tiny-annot", contigs=[["c1", 60000], ["c2", 40000]])
    ca["features"].update(satellite_share=0.02, satellite_len=[600, 3000],
                          gaps=2, gap_len=[100, 1000],
                          end_telomere_len=[1000, 3000],
                          interstitial_telomeres=1,
                          interstitial_len=[300, 600], margin=8000)
    _dump(pb / "configs" / "tiny-annot.json", ca)
    t = harness.traffic("pore-3000ch")
    t.update(channels=64, read_len=[2000, 8000], repeat_head_len=[200, 300],
             warmup_ticks=2, check={"sample": 48, "longest": 8})
    _dump(pb / "traffic" / "pore-tiny.json", t)
    t = harness.traffic("contig-jobs")
    t.update(warmup_bases=6000,
             check={"end_len": 4000, "satellite_windows": 2,
                    "gap_windows": 2, "pad": 1000, "random_windows": 2,
                    "window_len": 8000, "context": 512,
                    "control_core": 512})
    _dump(pb / "traffic" / "jobs-tiny.json", t)
    b = harness.load_json(root / "BENCHMARK.json")
    b["configs"] += [
        {"name": "tiny-index", "source": "tests",
         "file": "portbench/configs/tiny-index.json", "reduced": [],
         "why": "tests"},
        {"name": "tiny-annot", "source": "tests",
         "file": "portbench/configs/tiny-annot.json", "reduced": [],
         "why": "tests"}]
    b["workloads"] += [
        {"name": RU, "config": "tiny-index", "traffic": "pore-tiny",
         "chips": 1, "why": "tests"},
        {"name": AN, "config": "tiny-annot", "traffic": "jobs-tiny",
         "chips": 1, "why": "tests"}]
    for m in b["end_to_end"] + b["per_layer"]:
        cells = m.get("workloads", [])
        if "readuntil-3000ch" in cells:
            cells.append(RU)
        if "annot-chr1-3" in cells:
            cells.append(AN)
    _dump(root / "BENCHMARK.json", b)


def data_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json and portbench's data and readers (the
    code runs from the checkout's package), with the tiny cells added."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for d in ("configs", "traffic", "layers"):
        shutil.copytree(harness.PKG / d, tmp / "portbench" / d)
    add_tiny_cells(tmp)
    return tmp
