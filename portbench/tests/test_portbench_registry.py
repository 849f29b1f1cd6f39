"""The registry: every cell, configuration, traffic mix and per-layer
reader is found by name, BENCHMARK.json keeps to its limits, a cell added
as new files runs with no edit to a file that was there, and a run without
the program or without a card prints no result."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import _tiny
from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return harness.load_json(ROOT / "BENCHMARK.json")


def test_every_cell_finds_its_files():
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert harness.config(c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        cfg = harness.config(w["config"])
        mix = harness.traffic(w["traffic"])
        assert w["config"] in configs
        assert (harness.PKG / "runners" / (mix["runner"] + ".py")).is_file()
        assert (harness.PKG / "reference" /
                (cfg["reference"] + ".py")).is_file()
        rnr = harness.runner(mix["runner"])
        for fn in ("setup", "window", "release", "check"):
            assert callable(getattr(rnr, fn))
    for m in b["per_layer"]:
        assert callable(harness.layer_reader(m["name"]))


def test_benchmark_json_keeps_to_its_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(w["config"] == c["name"] for w in b["workloads"])
        cfg = harness.config(c["name"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in b["end_to_end"])
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert UNIT.match(m["unit"])
        layers.setdefault(m["layer"], m["layer"])
        moved = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].split(".")[0].endswith("_roofline_pct"):
            assert m["unit"] == "%"
    for w in cells:
        mine = [m for m in b["end_to_end"] if w in m.get("workloads", [w])]
        assert len(mine) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 << 10


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _copy(tmp: Path, with_program: bool) -> Path:
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(harness.PKG, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        os.symlink(ROOT / "cornetto_tpu_torch", root / "cornetto_tpu_torch")
    return root


def _run(root: Path, workload: str, seconds: str = "1"):
    code = ("import sys; sys.path.insert(0, %r); from portbench import run; "
            "sys.exit(run.main(['--workload', %r, '--seed', '2147483659', "
            "'--seconds', %r, '--trace', '0'], allow_cpu=True))"
            % (str(root), workload, seconds))
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)


def test_new_cell_runs_as_new_files(tmp_path):
    root = _copy(tmp_path, with_program=True)
    before = _digests(root / "portbench")
    _tiny.add_tiny_cells(root)
    after = _digests(root / "portbench")
    assert all(after[k] == v for k, v in before.items())
    assert set(after) - set(before) == {
        "configs/tiny-index.json", "configs/tiny-annot.json",
        "traffic/pore-tiny.json", "traffic/jobs-tiny.json"}
    p = _run(root, _tiny.RU)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"chunk_decisions_per_s", "setup_s"}
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


def test_without_the_program_a_run_prints_no_result(tmp_path):
    root = _copy(tmp_path, with_program=False)
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "readuntil-3000ch", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_without_a_card_a_run_exits_2(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run
    assert run.main(["--workload", "annot-chr1-3", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert '"correct"' not in capsys.readouterr().out


def test_reference_and_harness_import_no_jax():
    """No file under portbench imports jax, jaxlib, flax or the JAX package
    (top-level names compared whole: cornetto_tpu_torch is the program),
    and the reference imports nothing of the program either."""
    banned = {"jax", "jaxlib", "flax", "cornetto_tpu"}
    for path in harness.PKG.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & banned, (path, tops)
            if "reference" in path.parts:
                assert "cornetto_tpu_torch" not in tops, (path, tops)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run
    fake = type(sys)("x")
    for name in ("cornetto_tpu_torch.fake", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "cornetto_tpu.cli", fake)
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    assert run.forbidden_modules() == ["cornetto_tpu", "jax"]
