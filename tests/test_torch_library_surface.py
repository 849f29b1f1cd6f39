"""The port's counterparts of the JAX package's remaining public library
functions, held against the JAX functions on the CPU with seeded inputs and
tolerance 0: ``livefish.decide.decision_core`` (unpacked reads) and the
packing it runs on, ``kernels.motif.match_positions`` / ``tandem_runs``,
``kernels.sdust_chunked.sdust_chunked_oracle``,
``intervals.algebra.IntervalSet``, ``io.bed.write_bed3`` /
``read_bed_regions``, ``io.readfish.write_targets_csv``,
``utils.logging.debug`` and the re-exports of ``io``, ``intervals`` and
``utils``.  tests/test_torch_standalone.py imports each of them in a fresh
interpreter with neither ``jax`` nor ``cornetto_tpu`` loaded."""

import inspect
import io
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cornetto_tpu.intervals as jax_intervals
import cornetto_tpu.io as jax_io
import cornetto_tpu.utils as jax_utils
from cornetto_tpu.intervals import algebra as jax_algebra
from cornetto_tpu.io import bed as jax_bed
from cornetto_tpu.io import readfish as jax_readfish
from cornetto_tpu.kernels import minimizer as jax_mz
from cornetto_tpu.kernels import motif as jax_motif
from cornetto_tpu.kernels import sdust_chunked as jax_chunked
from cornetto_tpu.livefish import decide as jd
from cornetto_tpu.livefish.index import build_index, build_panel_mask
from cornetto_tpu.utils import logging as jax_logging
import cornetto_tpu_torch.intervals as t_intervals
import cornetto_tpu_torch.io as t_io
import cornetto_tpu_torch.utils as t_utils
from cornetto_tpu_torch.intervals import algebra
from cornetto_tpu_torch.io import bed, readfish
from cornetto_tpu_torch.kernels import minimizer as mz
from cornetto_tpu_torch.kernels import motif
from cornetto_tpu_torch.kernels import sdust_chunked as chunked
from cornetto_tpu_torch.livefish import decide as td
from cornetto_tpu_torch.native.sdust import sdust as native_sdust
from cornetto_tpu_torch.utils import logging as t_logging

ACGT = np.array(list("ACGT"))


def _genome(seed, sizes):
    rng = np.random.default_rng(seed)
    return {n: "".join(ACGT[rng.integers(0, 4, s)]) for n, s in sizes}


@pytest.mark.parametrize("L", [1, 7, 8, 9, 17, 450])
def test_pack_codes_matches_pack_reads(L):
    rng = np.random.default_rng(L)
    codes = rng.integers(0, 5, size=(6, L)).astype(np.uint8)
    want = jax_mz.pack_reads(codes)
    got = mz.pack_codes(torch.from_numpy(codes))
    for g, w in zip(got, want):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("variant", ["nfree", "nmask"])
@pytest.mark.parametrize("n_ctg", [2, 70])
def test_decision_core_matches_jax(variant, n_ctg):
    sizes = [("c1", 30000), ("c2", 20000)] if n_ctg == 2 else \
        [("c%d" % i, 1500) for i in range(n_ctg)]
    genome = _genome(21 + n_ctg, sizes)
    idx = build_index(genome, n_shards=1)
    panel = build_panel_mask(idx, [(sizes[0][0], 0, sizes[0][1] // 2)])
    rng = np.random.default_rng(22 + n_ctg)
    B, L = 24, 301
    reads = rng.integers(0, 4, size=(B, L)).astype(np.uint8)
    names = list(genome)
    for i in range(B // 2):
        ctg = genome[names[i % len(names)]]
        s = int(rng.integers(0, len(ctg) - L))
        reads[i] = jax_mz.encode_seq(ctg[s:s + L])
    if variant == "nmask":
        reads[rng.random(reads.shape) < 0.01] = 4
        reads[B - 1, 100:160] = 4
    kw = dict(k=idx.k, w=idx.w, min_hits=3, bin_size=1000,
              bucket_shift=idx.bucket_shift, two_choice=idx.two_choice)
    want = jd.decision_core(jnp.asarray(idx.btable[0]), jnp.asarray(reads),
                            jnp.asarray(panel), **kw)
    st = td.state_from_index(idx, panel, "cpu")
    got = td.decision_core(st.btable, torch.from_numpy(reads), st.panel,
                           **kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3][:B // 2].max()) >= 3       # reads from the draft hit


def _motif_seq(seed, n=5000):
    rng = np.random.default_rng(seed)
    s = ACGT[rng.integers(0, 4, n)]
    s[100:160] = np.tile(list("TTAGGG"), 10)
    s[1000:1019] = list("TTAGGGTTAGGGTTAGGGT")
    s[2000:2040] = "A"
    s[3000:3030] = np.tile(list("TA"), 15)
    s[n - 6:] = list("TTAGGG")
    return "".join(s).encode()


@pytest.mark.parametrize("m", ["TTAGGG", "CCCTAA", "AAAAAA", "TATATA", "A",
                               "", "ACGT" * 2000])
def test_match_positions_and_tandem_runs_match_jax(m):
    seq = np.frombuffer(_motif_seq(len(m)), dtype=np.uint8)
    got = motif.match_positions(seq, m)
    want = jax_motif.match_positions(seq, m)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert motif.tandem_runs(got, len(m)) == \
        jax_motif.tandem_runs(want, len(m))
    assert motif.revcomp_motif(m) == jax_motif.revcomp_motif(m)


def _sdust_seqs():
    rng = np.random.default_rng(16)
    out = []
    for n_len, gaps in ((9000, 0), (12_000, 5), (700, 1)):
        s = ACGT[rng.integers(0, 4, n_len)]
        s[100:400] = np.tile(list("ATTCC"), 60)
        s[n_len // 2:n_len // 2 + 200] = "A"
        for _ in range(gaps):
            p = int(rng.integers(0, n_len - 200))
            s[p:p + int(rng.integers(1, 150))] = "N"
        out.append("".join(s).encode())
    return out


@pytest.mark.parametrize("core,W,T", [(512, 64, 20), (128, 32, 14),
                                      (64, 3, 5)])
def test_sdust_chunked_oracle_matches_jax(core, W, T):
    for seq in _sdust_seqs():
        got = chunked.sdust_chunked_oracle(seq, T=T, W=W, core=core)
        assert got == jax_chunked.sdust_chunked_oracle(seq, T=T, W=W,
                                                       core=core)
        assert got == native_sdust(seq, T=T, W=W)


def test_interval_set_matches_jax():
    rng = np.random.default_rng(5)
    names = ["chr%d" % i for i in rng.integers(1, 4, 40)]
    starts = rng.integers(0, 10**9, 40)
    ends = starts + rng.integers(1, 10**5, 40)
    got = algebra.IntervalSet.from_arrays(names, starts, ends)
    want = jax_algebra.IntervalSet.from_arrays(names, starts, ends)
    assert len(got) == len(want) == 40
    assert list(got) == list(want) == got.rows
    assert all(type(s) is int and type(e) is int for _c, s, e in got)
    a, b = io.StringIO(), io.StringIO()
    got.write(a)
    want.write(b)
    assert a.getvalue() == b.getvalue()
    assert algebra.merge(algebra.bed_sort(got.rows), 0) == \
        jax_algebra.merge(jax_algebra.bed_sort(want.rows), 0)


def test_write_bed3_and_read_bed_regions_match_jax(tmp_path):
    rows = [("chr1", 0, 10), ("chrUn_x", 5, 1_000_000_007), ("c", 3, 4)]
    a, b = io.StringIO(), io.StringIO()
    bed.write_bed3(a, rows)
    jax_bed.write_bed3(b, rows)
    assert a.getvalue() == b.getvalue()
    path = tmp_path / "r.bed"
    path.write_text(a.getvalue() + "chr2\t7\t9\textra\n")
    got = bed.read_bed_regions(str(path))
    assert got == jax_bed.read_bed_regions(str(path))
    assert got[-1] == "chr2:7-9"


def test_write_targets_csv_matches_jax():
    rows = [("chr1", 0, 10), ("chrX", 123, 456789)]
    a, b = io.StringIO(), io.StringIO()
    readfish.write_targets_csv(a, rows)
    jax_readfish.write_targets_csv(b, iter(rows))
    assert a.getvalue() == b.getvalue()
    assert a.getvalue().count("\n") == 4


@pytest.mark.parametrize("level", [t_logging.LOG_INFO, t_logging.LOG_DBUG,
                                   t_logging.LOG_TRAC])
def test_debug_matches_jax(capsys, level):
    before = (t_logging.get_log_level(), jax_logging.get_log_level())
    try:
        t_logging.set_log_level(level)
        jax_logging.set_log_level(level)
        t_logging.debug("x = 1")
        got = capsys.readouterr().err
        jax_logging.debug("x = 1")
        assert got == capsys.readouterr().err
        assert got == ("[DEBUG] x = 1\n" if level >= t_logging.LOG_DBUG
                       else "")
    finally:
        t_logging.set_log_level(before[0])
        jax_logging.set_log_level(before[1])


def _exports(pkg):
    return {n for n, v in vars(pkg).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("pair", [(jax_io, t_io),
                                  (jax_intervals, t_intervals),
                                  (jax_utils, t_utils)],
                         ids=["io", "intervals", "utils"])
def test_package_reexports_match_jax(pair):
    jax_pkg, pkg = pair
    names = _exports(jax_pkg)
    assert names and names == _exports(pkg)
    for n in names:
        obj = getattr(pkg, n)
        assert obj is not getattr(jax_pkg, n), n
        # bound from one of the port package's own modules
        assert any(getattr(m, n, None) is obj for name, m in
                   list(sys.modules.items())
                   if name.startswith(pkg.__name__ + ".")), n
