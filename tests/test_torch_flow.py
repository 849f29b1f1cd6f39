"""The iteration flow on the port (cornetto_tpu_torch.flow.runner) against
the JAX package's on the setup of tests/test_flow.py, with
CORNETTO_FORCE_CPU=1: byte-identical panel, coverage tracks and telomere
stats; resume; and the whole panel path through the port's CLI in a fresh
interpreter without JAX."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from cornetto_tpu.flow import runner as jrunner
from cornetto_tpu_torch.flow import runner as trunner

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASES = np.array(list("ACGT"))
OUTPUTS = ["draft.boringbits.bed", "draft.boringbits.txt",
           "draft.cov-total.bg", "draft.cov-mq20.bg", "draft.telostats.txt"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")


def _setup(d, big_len=2_500_000, small_len=300_000, depth=6, seed=23):
    """tests/test_flow.py's aligner-free inputs: a draft of `big` and
    `small`, uniform reads over `big` only, an empty lowQ BED."""
    rng = np.random.default_rng(seed)
    big = "".join(BASES[rng.integers(0, 4, big_len)])
    small = "".join(BASES[rng.integers(0, 4, small_len)])
    d.mkdir(parents=True, exist_ok=True)
    fasta = d / "draft.fasta"
    fasta.write_text(">big\n%s\n>small\n%s\n" % (big, small))
    (d / "draft.bp.p_ctg.lowQ.bed").write_text("")
    L = 450
    reads = d / "reads.fastq"
    with reads.open("w") as f:
        for i in range(big_len * depth // L):
            s = int(rng.integers(0, big_len - L))
            f.write("@r%d\n%s\n+\n%s\n" % (i, big[s:s + L], "I" * L))
    return str(fasta), str(reads)


def _state(wd):
    with open(os.path.join(wd, ".flow.iteration.json")) as f:
        return json.load(f)


def test_aligner_free_matches_jax_and_resumes(tmp_path):
    fasta, reads = _setup(tmp_path)
    cfg = {"aligner_free": True, "cov_batch": 2048}
    # both flows run in the same workdir (telostats prints its path); the
    # JAX one is moved aside afterwards
    wd = str(tmp_path / "wd")
    wds = {"jax": str(tmp_path / "wd_jax"), "torch": wd}
    for name, mod in (("jax", jrunner), ("torch", trunner)):
        flow = mod.iteration_flow(wd, fasta, reads, cfg)
        assert [s.name for s in flow.steps] == [
            "depth", "panel", "telostats", "livefish-index"]
        assert flow.run() == 0
        if name == "jax":
            os.rename(wd, wds["jax"])
    for out in OUTPUTS:
        got = pathlib.Path(wds["torch"], out).read_bytes()
        assert got == pathlib.Path(wds["jax"], out).read_bytes(), out
    rows = [r.split("\t") for r in pathlib.Path(
        wds["torch"], "draft.boringbits.bed").read_text().splitlines()]
    assert rows and all(r[0] == "big" for r in rows)
    assert sum(int(r[2]) - int(r[1]) for r in rows) > 1_000_000
    assert os.path.exists(os.path.join(wds["torch"], "draft.livefish.npz"))
    # resume: a second run re-does nothing (all artifacts present)
    state = _state(wds["torch"])
    stamps = {o: os.stat(os.path.join(wds["torch"], o)).st_mtime_ns
              for o in OUTPUTS}
    flow2 = trunner.iteration_flow(wds["torch"], fasta, reads,
                                   {"aligner_free": True})
    for step in flow2.steps:
        step.run = None                          # any call would raise
    assert flow2.run() == 0
    assert _state(wds["torch"]) == state
    assert stamps == {o: os.stat(os.path.join(wds["torch"], o)).st_mtime_ns
                      for o in OUTPUTS}


def test_aligned_flow_runs_port_panel(tmp_path):
    """Without aligner_free the DAG keeps align -> depth (host BAM steps) and
    only the panel step is the port's; tracks from a stand-in depth step give
    the JAX flow's outputs byte for byte."""
    rng = np.random.default_rng(11)
    n = 1_200_000
    fasta = tmp_path / "draft.fasta"
    fasta.write_text(">ptg1\n%s\n" % "".join(BASES[rng.integers(0, 4, n)]))
    (tmp_path / "draft.bp.p_ctg.lowQ.bed").write_text("ptg1\t100\t9000\n")
    depth = np.clip(30 + rng.integers(-2, 3, n), 0, None)
    depth[500_000:560_000] = 3

    def fake_align(ctx):
        open(ctx.path("draft.bam"), "w").close()

    def fake_depth(ctx):
        for name, arr in (("draft.cov-total.bg", depth),
                          ("draft.cov-mq20.bg", np.maximum(depth - 1, 0))):
            with open(ctx.path(name), "w") as f:
                f.write("".join("ptg1\t%d\t%d\t%d\n" % (i, i + 1, v)
                                for i, v in enumerate(arr)))
    outs = {}
    for name, mod in (("jax", jrunner), ("torch", trunner)):
        wd = tmp_path / ("wd_" + name)
        flow = mod.iteration_flow(str(wd), str(fasta), str(tmp_path / "r"))
        assert [s.name for s in flow.steps] == [
            "align", "depth", "panel", "telostats", "livefish-index"]
        flow.steps[0].run = fake_align
        flow.steps[1].run = fake_depth
        assert flow.run() == 0
        outs[name] = {o: (wd / o).read_bytes() for o in OUTPUTS[:2]}
        assert set(_state(str(wd))["done"]) == {
            "align", "depth", "panel", "telostats", "livefish-index"}
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]["draft.boringbits.bed"]


def test_panel_path_imports_no_jax(tmp_path, synth):
    """`flow`, `livefish cov`, `create-panel` and `noboringbits` through the
    port's CLI leave jax and the JAX package out of sys.modules (a fresh
    interpreter: the test process itself has both loaded)."""
    fasta, reads = _setup(tmp_path, big_len=1_200_000, small_len=100_000,
                          depth=2, seed=5)
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"aligner_free": True, "cov_batch": 1024}))
    wd, panel_dir = tmp_path / "wd", tmp_path / "panel"
    panel_dir.mkdir()
    code = (
        "import contextlib, os, shutil, sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "wd, fasta, reads, cfg, pd, synth = sys.argv[1:]\n"
        "assert main(['cornetto', 'flow', wd, fasta, reads, '--config',"
        " cfg]) == 0\n"
        "assert main(['cornetto', 'livefish', 'cov', wd + '/draft.livefish',"
        " reads, '-o', pd + '/draft', '-b', '1024']) == 0\n"
        "shutil.copy(fasta, pd + '/draft.fasta')\n"
        "shutil.copy(wd + '/draft.bp.p_ctg.lowQ.bed', pd)\n"
        "os.chdir(pd)\n"
        "assert main(['cornetto', 'create-panel', 'draft.fasta',"
        " '--ranged-bedgraph']) == 0\n"
        "with open('fun.txt', 'w') as f, contextlib.redirect_stdout(f):\n"
        "    assert main(['cornetto', 'noboringbits', synth +"
        " '/cov-total.bg', '-q', synth + '/cov-mq20.bg']) == 0\n"
        "assert 'torch' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CORNETTO_FORCE_CPU="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(wd), fasta, reads, str(cfg),
         str(panel_dir), str(synth)], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (wd / "draft.livefish.npz").exists()
    # `livefish cov` over the same reads writes the flow's tracks
    for suffix in (".cov-total.bg", ".cov-mq20.bg"):
        assert (panel_dir / ("draft" + suffix)).read_bytes() == \
            (wd / ("draft" + suffix)).read_bytes()
    assert (panel_dir / "draft.boringbits.bed").read_bytes() == \
        (wd / "draft.boringbits.bed").read_bytes()
    assert (panel_dir / "fun.txt").read_text() == \
        (ROOT / "test_data" / "golden" / "fun_default.txt").read_text()
