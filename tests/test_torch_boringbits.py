"""boringbits / noboringbits on the port (cornetto_tpu_torch.tools.
boringbits) with CORNETTO_FORCE_CPU=1: byte parity with the C-oracle
goldens (as tests/test_boringbits.py), the low-memory two-pass path against
the in-memory path on stdout and stderr (as tests/test_boringbits_lowmem.py),
iter_fun_windows against the JAX module's, and the CLI flags."""

import contextlib
import gzip
import io

import numpy as np
import pytest
import torch

from cornetto_tpu.tools import boringbits as jbb
from cornetto_tpu_torch import cli as torch_cli
from cornetto_tpu_torch.kernels.window_sum import window_sums
from cornetto_tpu_torch.tools import boringbits as tbb

CASES = [
    ("boring_t1.txt", dict(boring=True, min_ctg_len=10000, edge_len=1000,
                           low_cov_thresh=0.6, low_mq_cov_thresh=0.6,
                           high_cov_thresh=1.6)),
    ("fun_t2.txt", dict(boring=False, high_cov_thresh=2.5, low_cov_thresh=0.5,
                        low_mq_cov_thresh=0.5, min_ctg_len=10000,
                        edge_len=1000)),
    ("fun_default.txt", dict(boring=False)),
    ("boring_odd.txt", dict(boring=True, window_size=999, window_inc=37,
                            min_ctg_len=20000, edge_len=3000)),
]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")


def _run(mod, ct, cm, opt):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err):
        mod.run(str(ct), str(cm), opt, out=out)
    return out.getvalue(), err.getvalue()


@pytest.mark.parametrize("low_mem", ["no", "yes"])
@pytest.mark.parametrize("backend", ["auto", "numpy"])
@pytest.mark.parametrize("golden,kw", CASES)
def test_golden(synth, gold, golden, kw, backend, low_mem):
    opt = tbb.BoringbitsOptions(backend=backend, low_mem=low_mem, **kw)
    got, err = _run(tbb, synth / "cov-total.bg", synth / "cov-mq20.bg", opt)
    assert got == (gold / golden).read_text()
    _, want_err = _run(jbb, synth / "cov-total.bg", synth / "cov-mq20.bg",
                       jbb.BoringbitsOptions(backend="numpy",
                                             low_mem=low_mem, **kw))
    assert err == want_err


def _track_files(tmp_path, gz):
    def track(shift):
        rows = []
        for ctg, n, base in (("a", 5000, 5), ("b", 700, 70000),
                             ("c", 40, 3)):
            for i in range(n):
                rows.append("%s\t%d\t%d\t%d\n"
                            % (ctg, i, i + 1, max(base - shift, 0) + i))
        return "".join(rows).encode()
    ct = tmp_path / "t.bg"
    cm = tmp_path / "m.bg"
    if gz:
        with gzip.open(ct, "wb") as f:
            f.write(track(0))
    else:
        ct.write_bytes(track(0))
    cm.write_bytes(track(3))
    return ct, cm


@pytest.mark.parametrize("boring", [False, True])
@pytest.mark.parametrize("gz", [False, True])
def test_lowmem_matches_inmemory(tmp_path, gz, boring):
    ct, cm = _track_files(tmp_path, gz)
    kw = dict(boring=boring, min_ctg_len=1000, edge_len=100)
    o1, e1 = _run(tbb, ct, cm, tbb.BoringbitsOptions(low_mem="no", **kw))
    o2, e2 = _run(tbb, ct, cm, tbb.BoringbitsOptions(low_mem="yes", **kw))
    assert o2 == o1 and e2 == e1
    assert "truncated to 65535" in e1
    assert (o1, e1) == _run(jbb, ct, cm, jbb.BoringbitsOptions(
        backend="numpy", low_mem="no", **kw))


def _random_tracks(tmp_path):
    rng = np.random.default_rng(9)
    rows_a, rows_b = [], []
    for ctg, n in (("x", 4000), ("y", 2500), ("z", 900)):
        # contig y sits far below 0.4x the global mean -> guaranteed
        # low-coverage violations
        d = rng.integers(30, 40, n) if ctg != "y" else rng.integers(0, 3, n)
        m = np.maximum(d - rng.integers(0, 10, n), 0)
        for i in range(n):
            rows_a.append("%s\t%d\t%d\t%d\n" % (ctg, i, i + 1, d[i]))
            rows_b.append("%s\t%d\t%d\t%d\n" % (ctg, i, i + 1, m[i]))
    ct = tmp_path / "a.bg"
    cm = tmp_path / "b.bg"
    ct.write_text("".join(rows_a))
    cm.write_text("".join(rows_b))
    return ct, cm


@pytest.mark.parametrize("low_mem", ["no", "yes"])
def test_iter_fun_windows_matches_jax(tmp_path, synth, low_mem):
    ct, cm = _random_tracks(tmp_path)
    for a, b, kw in ((ct, cm, dict(min_ctg_len=1000)),
                     (synth / "cov-total.bg", synth / "cov-mq20.bg",
                      dict(min_ctg_len=10000, window_size=999,
                           window_inc=37))):
        got = list(tbb.iter_fun_windows(str(a), str(b), tbb.BoringbitsOptions(
            boring=False, low_mem=low_mem, **kw)))
        want = list(jbb.iter_fun_windows(str(a), str(b), jbb.BoringbitsOptions(
            boring=False, backend="numpy", low_mem=low_mem, **kw)))
        assert got == want and len(got) > 0


def test_cli_flags(tmp_path, synth, gold, capsys):
    ct, cm = str(synth / "cov-total.bg"), str(synth / "cov-mq20.bg")
    for extra in ([], ["--backend", "numpy"], ["--low-mem"],
                  ["--backend=auto", "--low-mem"]):
        assert torch_cli.main(["cornetto", "noboringbits", ct, "-q", cm]
                              + extra) == 0
        assert capsys.readouterr().out == (gold / "fun_default.txt") \
            .read_text()
    assert torch_cli.main(["cornetto", "boringbits", ct, "--qual", cm,
                           "-w", "999", "-i", "37", "-m", "20000",
                           "-e", "3000"]) == 0
    assert capsys.readouterr().out == (gold / "boring_odd.txt").read_text()
    # -q is required; -h prints the help on stdout
    assert tbb.main([ct], boring=False) == 1
    assert "Usage: cornetto boringbits" in capsys.readouterr().err
    assert tbb.main(["-h"], boring=False) == 0
    assert "-q FILE" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        tbb.main([ct, "-q", cm, "--backend", "jax"], boring=False)
    assert e.value.code == 1
    assert "not available in cornetto_tpu_torch" in capsys.readouterr().err


def test_auto_without_card_raises(synth, monkeypatch):
    monkeypatch.delenv("CORNETTO_FORCE_CPU")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = window_sums.launches
    with pytest.raises(RuntimeError, match="CORNETTO_FORCE_CPU"):
        tbb.run(str(synth / "cov-total.bg"), str(synth / "cov-mq20.bg"),
                tbb.BoringbitsOptions(), out=io.StringIO())
    assert window_sums.launches == before
