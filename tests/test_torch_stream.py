"""The port's livefish slice end to end on the CPU: `cornetto_tpu_torch.cli
livefish run` against `cornetto_tpu.cli livefish run` (byte-identical TSV),
the port's main path without JAX, and the explicit device rule."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cornetto_tpu import cli as jax_cli
from cornetto_tpu_torch import cli as torch_cli
from cornetto_tpu_torch.device import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASES = np.array(list("ACGT"))


def _write_inputs(tmp_path, n_ctg, fmt, seed=5):
    """Draft FASTA + panel BED + reads (FASTQ or FASTA): genomic reads,
    some reverse-complemented, junk, and a count that leaves a partial last
    batch of 8.  In batches of 8 the native path takes each extraction
    variant: batch 0 has interior Ns (bitmap), batch 1 short reads
    (lengths), batches 2-3 neither (N-free)."""
    rng = np.random.default_rng(seed)
    size = 60000 // n_ctg
    genome = {"ctg%d" % i: "".join(BASES[rng.integers(0, 4, size)])
              for i in range(n_ctg)}
    draft = tmp_path / "draft.fa"
    draft.write_text("".join(">%s\n%s\n" % kv for kv in genome.items()))
    bed = tmp_path / "panel.bed"
    bed.write_text("ctg0\t0\t%d\nctg1\t%d\t%d\n" % (size // 2, size // 2,
                                                    size))
    comp = str.maketrans("ACGT", "TGCA")
    names = list(genome)
    recs = []
    for i in range(29):                      # 29 % 8 -> partial tail batch
        if i % 7 == 6:
            seq = "".join(BASES[rng.integers(0, 4, 450)])     # junk
        else:
            ctg = genome[names[i % len(names)]]
            ln = int(rng.integers(80, 450)) if i in (9, 13) else 500
            s = int(rng.integers(0, len(ctg) - ln))
            seq = ctg[s:s + ln]
            if i % 2:
                seq = seq.translate(comp)[::-1]
        if i in (2, 5):                      # interior Ns
            seq = list(seq)
            for p in rng.integers(10, len(seq) - 10, size=3):
                seq[int(p)] = "N"
            seq = "".join(seq)
        recs.append(("r%d" % i, seq))
    reads = tmp_path / ("reads.fq" if fmt == "fastq" else "reads.fa")
    with reads.open("w") as f:
        for name, seq in recs:
            if fmt == "fastq":
                f.write("@%s extra\n%s\n+\n%s\n" % (name, seq,
                                                     "I" * len(seq)))
            else:
                f.write(">%s\n%s\n" % (name, seq))
    return draft, bed, reads


def _build_index(tmp_path, draft, bed):
    idx = str(tmp_path / "idx")
    assert torch_cli.main(["cornetto", "livefish", "index", str(draft),
                           "-o", idx, "-p", str(bed)]) == 0
    return idx


@pytest.mark.parametrize("n_ctg,fmt", [(2, "fastq"), (70, "fastq"),
                                       (2, "fasta")])
def test_livefish_run_tsv_matches_jax(tmp_path, capsys, monkeypatch,
                                      n_ctg, fmt):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    draft, bed, reads = _write_inputs(tmp_path, n_ctg, fmt)
    idx = _build_index(tmp_path, draft, bed)
    from cornetto_tpu_torch.livefish import decide as td
    seen = []
    real = td.decide_packed

    def spy(btable, packed, nmask, panel, lengths=None, fused=False, **kw):
        seen.append("nmask" if nmask is not None else
                    "lengths" if lengths is not None else "nfree")
        return real(btable, packed, nmask, panel, lengths=lengths,
                    fused=fused, **kw)
    monkeypatch.setattr(td, "decide_packed", spy)
    capsys.readouterr()
    argv = ["cornetto", "livefish", "run", idx, str(reads), "-b", "8"]
    assert jax_cli.main(argv) == 0
    want = capsys.readouterr().out
    assert torch_cli.main(argv) == 0
    got = capsys.readouterr().out
    assert len(seen) == 4
    if fmt == "fastq":
        assert seen == ["nmask", "lengths", "nfree", "nfree"]
    rows = got.splitlines()
    assert len(rows) == 29
    assert got == want
    decisions = {r.split("\t")[1] for r in rows}
    assert decisions == {"proceed", "unblock"}


def test_main_path_imports_no_jax(tmp_path):
    """`livefish run` through the port leaves jax and the JAX package out
    of sys.modules (run in a fresh interpreter: the test process itself has
    both loaded)."""
    draft, bed, reads = _write_inputs(tmp_path, 2, "fastq")
    idx = _build_index(tmp_path, draft, bed)
    code = (
        "import sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "rc = main(['cornetto', 'livefish', 'run', %r, %r, '-b', '8'])\n"
        "assert rc == 0, rc\n"
        "assert 'torch' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n" % (idx, str(reads)))
    env = dict(os.environ, CORNETTO_FORCE_CPU="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.splitlines()) == 29


def test_package_sources_never_import_jax():
    for path in (ROOT / "cornetto_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax")
                        or s.startswith("from jax")), (path, line)


def test_default_device_without_cuda_raises(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("CORNETTO_FORCE_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CORNETTO_FORCE_CPU"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    draft, bed, reads = _write_inputs(tmp_path, 2, "fastq")
    idx = _build_index(tmp_path, draft, bed)
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cli.main(["cornetto", "livefish", "run", idx, str(reads)])
    assert capsys.readouterr().out == ""      # no rows decided on the CPU
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    assert resolve_device() == torch.device("cpu")


@pytest.mark.parametrize("argv", [["minidot", "x.paf"],
                                  ["minidotplot", "x.fa"],
                                  ["hapnetto", "x"],
                                  ["gfa2fa", "x.gfa"]])
def test_unported_commands_exit_1(argv, capsys):
    assert torch_cli.main(["cornetto"] + argv) == 1
    assert "not yet ported to cornetto_tpu_torch" in capsys.readouterr().err
