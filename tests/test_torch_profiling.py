"""The port's profiling hook (cornetto_tpu_torch/utils/profiling.py)
against the JAX package's test of its own (tests/test_kernels_misc.py::
test_maybe_trace_logs), and its torch.profiler trace on the CPU; the
port's spans (span, lap, tally): nothing recorded without a profiler, the
chunk engine's tick, the index build and the annotation tools' laps under
one, and the CLI's trace under CORNETTO_PROFILE."""

import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cornetto_tpu_torch.utils import profiling
from cornetto_tpu_torch.utils.profiling import maybe_trace


def test_maybe_trace_logs(capsys, monkeypatch):
    monkeypatch.delenv("CORNETTO_PROFILE", raising=False)
    with maybe_trace("unit-test-section"):
        pass
    err = capsys.readouterr().err
    assert "unit-test-section in" in err


def test_maybe_trace_writes_a_chrome_trace(capsys, monkeypatch, tmp_path):
    """CORNETTO_PROFILE=<dir>: the region's torch.profiler trace lands in
    <dir>/<tag>/trace.json (CPU activity only when the device is the
    CPU), and the wall time is logged as without it."""
    monkeypatch.setenv("CORNETTO_PROFILE", str(tmp_path))
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    with maybe_trace("traced-section"):
        torch.arange(1000, dtype=torch.int64).sum()
    events = json.loads((tmp_path / "traced-section" / "trace.json")
                        .read_text())["traceEvents"]
    assert any(e.get("name") == "aten::sum" for e in events)
    assert "traced-section in" in capsys.readouterr().err


# ---- spans: utils.profiling.span / lap / tally ---------------------------

TICK_SPANS = {"chunks.process", "chunks.stage", "chunks.submit",
              "decide.upload", "chunks.readback", "chunks.resolve"}


@pytest.fixture
def cpu(monkeypatch):
    """The port's plain versions on the CPU, one intra-op thread (the
    suite's parallel workers would oversubscribe the cores), an empty
    tally."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    torch.set_num_threads(n)
    profiling.reset()


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_without_a_profiler_records_nothing(cpu, monkeypatch):
    """With no profiler recording, span and lap never enter
    record_function and the tally stays empty; a lap with stats still
    adds its seconds under the name's last part."""
    import torch.profiler

    def boom(*a, **k):
        raise AssertionError("record_function entered")
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    stats = {}
    with profiling.span("x.outer", rows=3) as sp:
        sp.count(live=1)
        with profiling.lap("x.part", stats):
            with profiling.lap("x.bare"):
                pass
    assert profiling.span("a") is profiling.span("b")
    assert not profiling.recording()
    assert profiling.tally() == {}
    assert set(stats) == {"part"} and stats["part"] >= 0


def test_span_tally_under_a_profiler(cpu):
    """Calls, total and self seconds (total less the children's), summed
    counts and the parent span, and a cornetto.<name> event in the
    trace."""
    with _recording() as prof:
        assert profiling.recording()
        for _ in range(2):
            with profiling.span("t.outer", rows=4) as sp:
                sp.count(live=1)
                with profiling.span("t.inner"):
                    torch.arange(100).sum()
    t = profiling.tally()
    outer, inner = t["t.outer"], t["t.inner"]
    assert outer["calls"] == inner["calls"] == 2
    assert outer["counts"] == {"rows": 8, "live": 2}
    assert inner["parent"] == "t.outer" and outer["parent"] is None
    assert inner["total_s"] <= outer["total_s"]
    assert outer["self_s"] == pytest.approx(
        outer["total_s"] - inner["total_s"])
    assert min(outer["self_s"], inner["self_s"]) >= 0
    names = {e.name for e in prof.events()}
    assert {"cornetto.t.outer", "cornetto.t.inner"} <= names
    profiling.reset()
    assert profiling.tally() == {}


# ---- the chunk engine's tick ---------------------------------------------

BASES = np.array(list("ACGT"))


@pytest.fixture(scope="module")
def engine():
    """A small index of two random contigs, a panel, and the port's
    decision engine over it on the CPU."""
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    from cornetto_tpu_torch.livefish.index import (build_index,
                                                   build_panel_mask)
    rng = np.random.default_rng(18)
    genome = {"ctgA": "".join(BASES[rng.integers(0, 4, 60000)]),
              "ctgB": "".join(BASES[rng.integers(0, 4, 40000)])}
    idx = build_index(genome)
    panel = build_panel_mask(idx, [("ctgA", 20000, 40000)])
    return genome, SingleChipEngine(idx, panel, device="cpu")


def _ticks(genome, n_ticks=3, channels=5):
    """Each tick a new read on each channel, so every event decides: a
    chunk from ctgA (half in the panel) or ctgB."""
    rng = np.random.default_rng(7)
    out = []
    for t in range(n_ticks):
        ev = []
        for c in range(channels):
            name = "ctgA" if c % 2 else "ctgB"
            s = int(rng.integers(0, 39000))
            ev.append((c, "r%d_%d" % (t, c), genome[name][s:s + 200]))
        out.append(ev)
    return out


def _run_ticks(engine_cls, eng, ticks):
    from cornetto_tpu_torch.livefish import chunks
    ce = engine_cls(eng, n_channels=8, chunk_len=200,
                    policy=chunks.ChunkPolicy(max_chunks=4), batch=8)
    return [[(d.channel, d.read_id, d.action, d.n_chunks, d.contig, d.pos,
              d.nhits) for d in ce.process([chunks.ChunkEvent(*e)
                                            for e in ev])]
            for ev in ticks]


@pytest.mark.parametrize("kind", ["DeviceChunkEngine",
                                  "ChunkDecisionEngine"])
def test_chunk_engine_tick_spans(cpu, engine, tmp_path, kind):
    """Three ticks under a profiler: chunks.process three calls, tiled by
    its children (at most one call each a tick, totals within the
    parent's, self times >= 0); chunks.submit counts the rows launched
    and the live rows (every event here); the Chrome trace holds the
    spans; and the decisions are those of the same ticks untraced."""
    from cornetto_tpu_torch.livefish import chunks
    genome, eng = engine
    cls = getattr(chunks, kind)
    ticks = _ticks(genome)
    untraced = _run_ticks(cls, eng, ticks)
    assert profiling.tally() == {}
    with _recording() as prof:
        traced = _run_ticks(cls, eng, ticks)
    assert traced == untraced and any(traced)
    t = profiling.tally()
    want = TICK_SPANS - ({"decide.upload"} if kind == "ChunkDecisionEngine"
                         else set())
    assert set(t) == want
    proc = t["chunks.process"]
    assert proc["calls"] == 3 and proc["parent"] is None
    for name in want - {"chunks.process"}:
        assert t[name]["calls"] <= 3
        assert t[name]["total_s"] <= proc["total_s"]
    assert all(e["self_s"] >= 0 for e in t.values())
    assert t["chunks.stage"]["parent"] == "chunks.process"
    if kind == "DeviceChunkEngine":
        assert t["decide.upload"]["parent"] == "chunks.submit"
    assert t["chunks.submit"]["counts"] == {
        "rows": 8 * len(ticks), "live": sum(len(ev) for ev in ticks)}
    if kind == "DeviceChunkEngine":
        assert t["chunks.stage"]["counts"] == {
            "events": sum(len(ev) for ev in ticks), "runs": len(ticks)}
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert {"cornetto." + n for n in want} <= names


def test_chunk_stage_counts_runs(cpu, engine):
    """A call in which a channel repeats is staged as two runs of distinct
    channels: chunks.stage counts its 3 events and 2 runs, and the
    repeated channel decides once."""
    from cornetto_tpu_torch.livefish import chunks
    genome, eng = engine
    s = genome["ctgA"][45000:45600]
    ce = chunks.DeviceChunkEngine(eng, n_channels=8, chunk_len=200, batch=8)
    with _recording():
        got = ce.process([chunks.ChunkEvent(0, "r0", s[:200]),
                          chunks.ChunkEvent(1, "r1", s[200:400]),
                          chunks.ChunkEvent(0, "r0", s[200:400])])
    t = profiling.tally()
    assert t["chunks.stage"]["counts"] == {"events": 3, "runs": 2}
    assert t["chunks.submit"]["counts"] == {"rows": 8, "live": 2}
    assert sorted((d.channel, d.n_chunks) for d in got) == [(0, 2), (1, 1)]


def test_index_build_spans(cpu):
    """build_index's stages are spans of one call each."""
    from cornetto_tpu_torch.livefish.index import build_index
    rng = np.random.default_rng(3)
    genome = {"a": "".join(BASES[rng.integers(0, 4, 5000)])}
    with _recording():
        build_index(genome)
    t = profiling.tally()
    for name in ("index.extract", "index.sort", "index.dedup",
                 "index.fill"):
        assert t[name]["calls"] == 1, name


# ---- the annotation tools' laps ------------------------------------------

SDUST_PARTS = ("read", "plan", "h2d", "kernel", "readback", "overflow",
               "host_spans", "assemble")
TELOFIND_PARTS = ("read", "encode", "h2d", "kernel", "compact", "readback",
                  "walk", "output")


@pytest.fixture
def small_fasta(cpu, monkeypatch, tmp_path):
    """A FASTA of one short contig with low-complexity stretches, an N gap
    and telomere arrays at both ends, and sdust's device DP on chunks of
    128 bases."""
    from cornetto_tpu_torch.tools import sdust
    monkeypatch.setattr(sdust, "CORE", 128)
    rng = np.random.default_rng(11)

    def rand(n):
        return "".join(BASES[rng.integers(0, 4, n)])
    seq = ("CCCTAA" * 10 + rand(200) + "CA" * 40 + rand(150) + "N" * 20
           + rand(150) + "AT" * 30 + rand(100) + "TTAGGG" * 10)
    path = tmp_path / "small.fa"
    path.write_text(">a\n%s\n" % seq)
    return path


@pytest.mark.parametrize("tool,parts", [("sdust", SDUST_PARTS),
                                        ("telofind", TELOFIND_PARTS)])
def test_annotation_laps_are_spans(small_fasta, tool, parts):
    """run(stats=) under a profiler: the same stats keys and rows as
    without one, and each part a span <tool>.<part> of one call or more."""
    import importlib
    mod = importlib.import_module("cornetto_tpu_torch.tools." + tool)
    got = []
    for traced in (False, True):
        out, stats = io.StringIO(), {}
        if traced:
            with _recording():
                mod.run(str(small_fasta), out=out, stats=stats)
        else:
            mod.run(str(small_fasta), out=out, stats=stats)
        got.append((out.getvalue(), stats))
    (rows, untraced), (traced_rows, stats) = got
    assert rows and traced_rows == rows
    assert set(stats) == set(untraced) and set(parts) <= set(stats)
    t = profiling.tally()
    for p in parts:
        assert t[tool + "." + p]["calls"] >= 1, p
        assert stats[p] >= 0
    # one one-line record: read, and not squeezed
    assert t[tool + ".read"]["counts"] == {"records": 1, "squeezed": 0}
    assert stats["records"] == 1 and stats["squeezed"] == 0


def test_cli_under_cornetto_profile_writes_the_spans(small_fasta,
                                                      monkeypatch, tmp_path,
                                                      capsys):
    """CORNETTO_PROFILE=<dir>: the subcommand runs under a trace written to
    <dir>/<subcommand>/trace.json, holding its spans, and the spans are
    logged at the end."""
    from cornetto_tpu_torch import cli
    monkeypatch.setenv("CORNETTO_PROFILE", str(tmp_path / "prof"))
    assert cli.main(["x", "sdust", str(small_fasta)]) == 0
    out, err = capsys.readouterr()
    assert out
    events = json.loads((tmp_path / "prof" / "sdust" / "trace.json")
                        .read_text())["traceEvents"]
    assert any(e.get("name") == "cornetto.sdust.plan" for e in events)
    assert "span sdust.plan:" in err and "sdust in" in err
