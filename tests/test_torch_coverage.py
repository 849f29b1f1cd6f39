"""Aligner-free coverage on the port (cornetto_tpu_torch.livefish.coverage
and `livefish cov`) against the JAX package's on the same index and FASTQ,
with CORNETTO_FORCE_CPU=1: identical tallies and byte-identical bedgraphs
(tolerance 0; every quantity is an integer), including repeat-only reads
that split their bases across both stored copies and a short final batch."""

import io

import numpy as np
import pytest

from cornetto_tpu import cli as jax_cli
from cornetto_tpu.livefish import coverage as jcov
from cornetto_tpu.livefish.decide import SingleChipEngine as JaxEngine
from cornetto_tpu.livefish.index import build_index
from cornetto_tpu_torch import cli as torch_cli
from cornetto_tpu_torch.livefish import coverage as tcov
from cornetto_tpu_torch.livefish.decide import SingleChipEngine

BASES = np.array(list("ACGT"))
REPEAT = (20000, 26000, 70000)        # ctgA[20000:26000] == ctgA[70000:76000]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The seeded genome of tests/test_livefish_coverage.py (ctgA 100 kb,
    ctgB 50 kb, reads over ctgA only) with one exact 6 kb repeat in ctgA,
    reads wholly inside it (all hits ambiguous), short reads and a read
    count that leaves a short final batch."""
    rng = np.random.default_rng(17)
    a = BASES[rng.integers(0, 4, 100000)]
    s, e, t = REPEAT
    a[t:t + e - s] = a[s:e]
    genome = {"ctgA": "".join(a),
              "ctgB": "".join(BASES[rng.integers(0, 4, 50000)])}
    L = 450
    d = tmp_path_factory.mktemp("tcov")
    fa = d / "draft.fa"
    fa.write_text("".join(">%s\n%s\n" % kv for kv in genome.items()))
    fq = d / "reads.fq"
    g = genome["ctgA"]
    with fq.open("w") as f:
        for i in range(3001):                        # 3001 % 512 = 441
            if i % 10 == 3:                          # inside the repeat
                st = int(rng.integers(s, e - L))
            else:
                st = int(rng.integers(0, 100000 - L))
            ln = int(rng.integers(120, L)) if i % 17 == 5 else L
            f.write("@r%d\n%s\n+\n%s\n" % (i, g[st:st + ln], "I" * ln))
    idx = build_index(genome, n_shards=1)
    return genome, idx, str(fa), str(fq), d


def _tallies(idx, fq, batch, out_jax=None, out_torch=None):
    panel = np.zeros((2, 128), dtype=bool)
    jt = jcov.CoverageTally(idx, jcov.CoverageParams())
    jr = jcov.stream_coverage(JaxEngine(idx, panel), jt, fq, batch=batch,
                              out=out_jax)
    tt = tcov.CoverageTally(idx, tcov.CoverageParams())
    tr = tcov.stream_coverage(SingleChipEngine(idx, panel), tt, fq,
                              batch=batch, out=out_torch)
    return jt, jr, tt, tr


@pytest.mark.parametrize("batch", [512, 3001])
def test_tally_counts_match_jax(setup, batch):
    _, idx, _, fq, _ = setup
    jo, to = io.StringIO(), io.StringIO()
    jt, jr, tt, tr = _tallies(idx, fq, batch, jo, to)
    assert tr == jr and tr[0] == 3001
    assert to.getvalue() == jo.getvalue()
    got = tt.counts()
    assert got.dtype == np.int32 and got.shape == (2, 2, 128)
    np.testing.assert_array_equal(got, jt.counts())
    # no read on ctgB; the repeat's second copy got bases from split reads
    assert int(got[0, 1].sum()) == 0
    assert got[0, 0, REPEAT[2] // 1000 + 1] > 0


def test_repeat_reads_split(setup):
    """Reads wholly inside the repeat have est2 != est: the split branch
    (ln - ln//2 to the first copy, ln//2 to the second) runs."""
    genome, idx, _, _, _ = setup
    from cornetto_tpu.kernels.minimizer import encode_seq
    s, e, t = REPEAT
    reads = np.stack([encode_seq(genome["ctgA"][p:p + 451])
                      for p in (s + 100, s + 2000, s + 4000)])
    eng = SingleChipEngine(idx, np.zeros((2, 128), dtype=bool))
    d, best, est, nhits, nhits_hq, est2 = eng.decide(reads)
    assert (nhits >= 3).all() and (nhits_hq == 0).all()
    assert ((est2 // 1000) != (est // 1000)).all()
    tt = tcov.CoverageTally(idx)
    tt.update(best, est, est2, nhits, nhits_hq, np.full(3, 451, np.int32))
    c = tt.counts()[0, 0]
    assert int(c.sum()) == 3 * 451
    np.testing.assert_array_equal(c[(est // 1000).numpy()], [226] * 3)
    np.testing.assert_array_equal(c[(est2 // 1000).numpy()], [225] * 3)


def test_update_matches_jax_on_random_batches(setup):
    """Random decisions folded in directly: bins past the end clamp to the
    last bin, pad rows (length 0) add nothing, unmapped reads add nothing."""
    import torch
    import jax.numpy as jnp
    _, idx, _, _, _ = setup
    rng = np.random.default_rng(4)
    jt = jcov.CoverageTally(idx, jcov.CoverageParams(bin_size=700,
                                                     min_hits=2, hq_hits=5))
    tt = tcov.CoverageTally(idx, tcov.CoverageParams(bin_size=700,
                                                     min_hits=2, hq_hits=5))
    for _ in range(5):
        B = 64
        arrs = [rng.integers(0, 2, B), rng.integers(0, 200000, B),
                rng.integers(0, 200000, B), rng.integers(0, 9, B),
                rng.integers(0, 9, B)]
        arrs = [a.astype(np.int32) for a in arrs]
        lens = rng.integers(0, 500, B).astype(np.int32)
        lens[-5:] = 0
        jt.update(*[jnp.asarray(a) for a in arrs], lens)
        tt.update(*[torch.from_numpy(a) for a in arrs], lens)
    np.testing.assert_array_equal(tt.counts(), jt.counts())


def test_cov_cli_bedgraphs_match_jax(setup, capsys):
    _, _, fa, fq, d = setup
    idx = str(d / "idx")
    assert torch_cli.main(["cornetto", "livefish", "index", fa, "-o",
                           idx]) == 0
    for name, cli in (("jax", jax_cli), ("torch", torch_cli)):
        assert cli.main(["cornetto", "livefish", "cov", idx, fq, "-o",
                         str(d / name), "-b", "512", "-l", "450"]) == 0
    assert "reads: 3001" in capsys.readouterr().err
    for suffix in (".cov-total.bg", ".cov-mq20.bg"):
        got = (d / ("torch" + suffix)).read_bytes()
        assert got == (d / ("jax" + suffix)).read_bytes()
        assert got.startswith(b"ctgA\t0\t1000\t")
    assert torch_cli.main(["cornetto", "livefish", "cov", idx]) == 1
    assert "Usage: cornetto livefish cov" in capsys.readouterr().err
