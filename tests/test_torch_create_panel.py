"""create-panel on the port (cornetto_tpu_torch.pipelines.create_cornetto)
with CORNETTO_FORCE_CPU=1: the reference-scale synth_pipe assembly gives
the golden panel of tests/test_pipeline_parity.py and every
tmp_create_cornetto/ intermediate byte-equal to the JAX pipeline's; a small
ranged-bedgraph (aligner-free) draft goes through the port's CLI."""

import os
import sys

import numpy as np
import pytest

from cornetto_tpu.pipelines import create_cornetto as jcc
from cornetto_tpu_torch import cli as torch_cli
from cornetto_tpu_torch.pipelines import create_cornetto as tcc

HERE = os.path.dirname(os.path.abspath(__file__))
TD = os.path.join(os.path.dirname(HERE), "test_data")
GOLD = os.path.join(TD, "golden", "pipelines", "create")

sys.path.insert(0, TD)
import gen_synth_pipe  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")


@pytest.fixture(scope="session")
def pipe_synth():
    return gen_synth_pipe.ensure()


def _tree(d):
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _link(dst, src_dir, names):
    os.makedirs(dst)
    for name in names:
        os.symlink(os.path.join(src_dir, name), os.path.join(dst, name))


@pytest.mark.parametrize("low_mem", ["auto", "yes"])
def test_synth_pipe_matches_golden_and_jax(pipe_synth, tmp_path,
                                           monkeypatch, low_mem):
    names = ("pasm.fasta", "pasm.cov-total.bg", "pasm.cov-mq20.bg",
             "pasm.bp.p_ctg.lowQ.bed")
    for sub, mod in (("jax", jcc), ("torch", tcc)):
        d = str(tmp_path / sub)
        _link(d, pipe_synth, names)
        monkeypatch.chdir(d)
        backend = "numpy" if mod is jcc else "auto"
        assert mod.run("pasm.fasta", backend=backend, low_mem=low_mem) == 0
    for name in ("pasm.boringbits.bed", "pasm.boringbits.txt"):
        with open(os.path.join(GOLD, name), "rb") as f:
            assert (tmp_path / "torch" / name).read_bytes() == f.read()
    got = _tree(str(tmp_path / "torch" / "tmp_create_cornetto"))
    want = _tree(str(tmp_path / "jax" / "tmp_create_cornetto"))
    assert len(got) == 10 and got == want
    assert got["1_tmp.bed"]                       # interesting windows found


def _ranged_draft(d):
    """A 2 Mb contig with a 100 kb coverage hole and a 300 kb contig, as
    1 kb ranged tracks (what `livefish cov` writes), plus one lowQ row."""
    rng = np.random.default_rng(12)
    os.makedirs(d)
    contigs = [("big", 2_000_000), ("small", 300_000)]
    with open(os.path.join(d, "draft.fasta"), "w") as f:
        for name, n in contigs:
            f.write(">%s\n%s\n" % (name, "".join(
                np.array(list("ACGT"))[rng.integers(0, 4, n)])))
    for suffix, drop in ((".cov-total.bg", 0), (".cov-mq20.bg", 1)):
        with open(os.path.join(d, "draft" + suffix), "w") as f:
            for name, n in contigs:
                for b in range(0, n, 1000):
                    dep = int(rng.integers(6, 10)) - drop
                    if name == "big" and 900_000 <= b < 1_000_000:
                        dep = 0
                    f.write("%s\t%d\t%d\t%d\n" % (name, b, min(b + 1000, n),
                                                  dep))
    with open(os.path.join(d, "draft.bp.p_ctg.lowQ.bed"), "w") as f:
        f.write("big\t1500000\t1509000\n")


def test_ranged_bedgraph_cli_matches_jax(tmp_path, monkeypatch, capsys):
    for sub in ("jax", "torch"):
        d = str(tmp_path / sub)
        _ranged_draft(d)
        monkeypatch.chdir(d)
        if sub == "jax":
            assert jcc.main(["draft.fasta", "--ranged-bedgraph",
                             "--backend=numpy"]) == 0
        else:
            assert torch_cli.main(["cornetto", "create-panel", "draft.fasta",
                                   "--ranged-bedgraph"]) == 0
    got, want = _tree(str(tmp_path / "torch")), _tree(str(tmp_path / "jax"))
    assert got == want
    rows = [r.split(b"\t") for r in
            got["draft.boringbits.bed"].splitlines()]
    assert rows and all(r[0] == b"big" for r in rows)
    # the hole +-40 kb stays out of the reject panel
    assert all(int(r[2]) <= 860_000 or int(r[1]) >= 1_040_000
               for r in rows)
    capsys.readouterr()
    assert torch_cli.main(["cornetto", "create-panel"]) == 1
    assert "1 argument required" in capsys.readouterr().err
