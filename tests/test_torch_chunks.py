"""The port's read-until chunk engine (cornetto_tpu_torch.livefish.chunks,
SingleChipEngine.init_chunk_state / decide_chunk_tick, chunk_tick_core and
``livefish replay``) against the JAX package's on the same events: the
cases of tests/test_livefish_chunks.py, each run through both packages'
engines over one index saved to ``.npz`` and loaded by both.  Decisions
(channel, read id, action, chunks, contig, position, hits), replay metrics
and the CLI's stdout must be equal; tolerance: exact equality.  Inputs from
a numpy seed.  The port runs its plain PyTorch versions on the CPU; the
fused kernel under the tick is held to them on the card
(tests/test_torch_cuda_kernels.py)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from cornetto_tpu.dist.checkpoint import load_index as jax_load_index
from cornetto_tpu.livefish import chunks as jchunks
from cornetto_tpu.livefish import cli as jax_lcli
from cornetto_tpu.livefish.decide import SingleChipEngine as JaxEngine
from cornetto_tpu_torch.dist.checkpoint import load_index, save_index
from cornetto_tpu_torch.livefish import chunks as tchunks
from cornetto_tpu_torch.livefish import cli as lcli
from cornetto_tpu_torch.livefish import decide as tdecide
from cornetto_tpu_torch.livefish.index import build_index, build_panel_mask

ROOT = pathlib.Path(__file__).resolve().parent.parent
BASES = np.array(list("ACGT"))
PROCEED, UNBLOCK, STOP = (tchunks.PROCEED, tchunks.UNBLOCK,
                          tchunks.STOP_RECEIVING)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain versions run many small ops that gain nothing from torch's
    intra-op threads, and the suite's parallel workers would oversubscribe
    the cores with them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """tests/test_livefish_chunks.py's genome and panel; one index built by
    the port, saved to .npz and loaded by both packages; an engine of
    each."""
    rng = np.random.default_rng(42)
    genome = {
        "ctgA": "".join(BASES[rng.integers(0, 4, 60000)]),
        "ctgB": "".join(BASES[rng.integers(0, 4, 40000)]),
    }
    panel_rows = [("ctgA", 20000, 40000)]
    idx = build_index(genome, n_shards=1)
    path = str(tmp_path_factory.mktemp("chunks") / "idx")
    save_index(path, idx, panel_mask=build_panel_mask(idx, panel_rows))
    jidx, jpanel, _ = jax_load_index(path)
    tidx, tpanel, _ = load_index(path)
    engines = {"jax": (jchunks, JaxEngine(jidx, jpanel)),
               "port": (tchunks, tdecide.SingleChipEngine(tidx, tpanel,
                                                          device="cpu"))}
    return genome, path, engines


def _dec(d):
    return (d.channel, d.read_id, d.action, d.n_chunks, d.contig, d.pos,
            d.nhits)


def _both(setup, scenario):
    """scenario(chunks module, engine) on both packages; returns the
    port's result after asserting it equals the JAX package's."""
    _, _, engines = setup
    out = {name: scenario(mod, eng) for name, (mod, eng) in engines.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def _mk_reads(genome, n_each=15, rlen=1600, seed=9):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_each):   # panel-origin (boring) reads
        s = int(rng.integers(21000, 38000 - rlen))
        reads.append(("b%d" % i, genome["ctgA"][s:s + rlen], True))
    for i in range(n_each):   # fun-region reads
        s = int(rng.integers(42000, 58000 - rlen))
        reads.append(("f%d" % i, genome["ctgA"][s:s + rlen], False))
    rng.shuffle(reads)
    return reads


def test_incremental_decisions(setup):
    genome = setup[0]
    s = genome["ctgA"][25000:26600]
    s1 = genome["ctgA"][45000:46600]

    def scenario(mod, eng):
        ce = mod.ChunkDecisionEngine(eng, n_channels=8, chunk_len=200,
                                     policy=mod.ChunkPolicy(max_chunks=4),
                                     batch=8)
        ev = mod.ChunkEvent
        return [[_dec(d) for d in ce.process(e)] for e in (
            [ev(0, "r0", s[:200])], [ev(1, "r1", s1[:200])],
            [ev(0, "r0", s[200:400]), ev(1, "r1", s1[200:400])],
            [ev(0, "r2", genome["ctgB"][100:300])])]
    got = _both(setup, scenario)
    assert [d[2] for d in got[0]] == [UNBLOCK] and got[0][0][3] == 1
    assert [d[2] for d in got[1]] == [STOP]
    assert got[2] == []                       # decided channels stay silent
    assert [d[2:4] for d in got[3]] == [(STOP, 1)]


@pytest.mark.parametrize("case", ["give_up", "short_first_chunk"])
def test_proceed_until_decided(setup, case):
    """Junk proceeds and gives up at max_chunks (no_map_action unblock); a
    24-base chunk holds one minimizer window, so a panel read proceeds
    until the accumulated prefix decides."""
    genome = setup[0]
    junk = "".join(BASES[np.random.default_rng(1).integers(0, 4, 1000)])

    def scenario(mod, eng):
        if case == "give_up":
            ce = mod.ChunkDecisionEngine(
                eng, n_channels=4, chunk_len=200, batch=4,
                policy=mod.ChunkPolicy(max_chunks=3,
                                       no_map_action=mod.UNBLOCK))
            seq, n, size = junk, 3, 200
        else:
            ce = mod.ChunkDecisionEngine(eng, n_channels=2, chunk_len=24,
                                         policy=mod.ChunkPolicy(max_chunks=8),
                                         batch=2)
            seq, n, size = genome["ctgA"][25000:25400], 8, 24
        acts = []
        for t in range(n):
            d = ce.process([mod.ChunkEvent(0, "r0",
                                           seq[t * size:(t + 1) * size])])
            acts.append(_dec(d[0]) if d else None)
        return acts
    acts = [a[2] if a else None for a in _both(setup, scenario)]
    if case == "give_up":
        assert acts == [PROCEED, PROCEED, UNBLOCK]
    else:
        decided = [a for a in acts if a is not None]
        assert UNBLOCK in decided and decided.index(UNBLOCK) >= 1


@pytest.mark.parametrize("engine,depth", [("host", 0), ("host", 2),
                                          ("device", 0), ("device", 2)])
def test_replay_metrics(setup, engine, depth):
    """replay_read_until over panel and fun reads: the same metrics from
    both packages, host or device state, synchronous or 2 deep."""
    genome = setup[0]
    reads = _mk_reads(genome, n_each=20)

    def scenario(mod, eng):
        cls = mod.DeviceChunkEngine if engine == "device" else \
            mod.ChunkDecisionEngine
        ce = cls(eng, n_channels=8, chunk_len=200,
                 policy=mod.ChunkPolicy(max_chunks=4), batch=8,
                 pipeline_depth=depth)
        m = mod.replay_read_until(ce, reads, unblock_overhead=100)
        return tuple(vars(m).items())
    m = dict(_both(setup, scenario))
    assert m["n_reads"] == 40 and m["false_reject"] == 0
    saved = 1 - m["bases_sequenced"] / m["bases_without_as"]
    if depth == 0:
        assert m["true_reject"] == 20 and m["n_stop_receiving"] == 20
        assert saved > 0.3 and m["mean_decision_chunks"] <= 2.0
    else:                        # latency may let a tail read slip
        assert m["true_reject"] >= 18 and saved > 0.2


def test_pipelined_decisions_lag_then_land(setup):
    s = setup[0]["ctgA"][25000:26600]

    def scenario(mod, eng):
        ce = mod.ChunkDecisionEngine(eng, n_channels=8, chunk_len=200,
                                     policy=mod.ChunkPolicy(max_chunks=6),
                                     batch=8, pipeline_depth=2)
        out = []
        for t in range(3):
            out.append([_dec(d) for d in ce.process(
                [mod.ChunkEvent(0, "r0", s[200 * t:200 * (t + 1)])])])
            out.append(len(ce._inflight))
        out.append([_dec(d) for d in ce.drain()])
        out.append(len(ce._inflight))
        return out
    got = _both(setup, scenario)
    assert got[:4] == [[], 1, [], 2]
    assert [d[2:4] for d in got[4]] == [(UNBLOCK, 1)]   # the chunk-1 prefix
    assert got[6:] == [[], 0]


def test_pipelined_late_decision_dropped_on_new_read(setup):
    genome = setup[0]
    s = genome["ctgA"][25000:25800]

    def scenario(mod, eng):
        ce = mod.ChunkDecisionEngine(eng, n_channels=4, chunk_len=200,
                                     batch=4, pipeline_depth=4)
        a = ce.process([mod.ChunkEvent(0, "old", s[:200])])
        b = ce.process([mod.ChunkEvent(0, "new",
                                       genome["ctgB"][100:300])])
        return a, b, [_dec(d) for d in ce.drain()]
    a, b, drained = _both(setup, scenario)
    assert a == b == [] and {d[1]: d[2] for d in drained} == {"new": STOP}


def test_device_chunk_engine_matches_host_engine(setup):
    """Both packages' DeviceChunkEngine and ChunkDecisionEngine through
    identical event sequences: four equal decision lists."""
    reads = _mk_reads(setup[0])

    def scenario(mod, eng):
        pol = mod.ChunkPolicy(max_chunks=4, no_map_action=mod.UNBLOCK)
        decs = {}
        for cls in (mod.ChunkDecisionEngine, mod.DeviceChunkEngine):
            ce = cls(eng, n_channels=8, chunk_len=200, policy=pol, batch=8)
            got, queue, active = [], list(reads), {}
            for c in range(8):
                active[c] = [queue.pop(0), 0]
            while active:
                events = []
                for c, (rd, off) in list(active.items()):
                    if off < len(rd[1]):
                        events.append(mod.ChunkEvent(c, rd[0],
                                                     rd[1][off:off + 200]))
                        active[c][1] = off + 200
                    elif queue:
                        active[c] = [queue.pop(0), 0]
                    else:
                        del active[c]
                got += [_dec(d)[1:] for d in ce.process(events)]
            got += [_dec(d)[1:] for d in ce.drain()]
            decs[cls.__name__] = sorted(got)
        return decs
    decs = _both(setup, scenario)
    assert decs["DeviceChunkEngine"] == decs["ChunkDecisionEngine"]
    assert len(decs["DeviceChunkEngine"]) >= 25


def test_device_two_chunks_one_call_across_batches(setup):
    """One channel with two chunks in one process() call, batch=1 forcing
    them into separate ticks: the pending entries carry post-write lengths,
    so both engines decide alike."""
    s = setup[0]["ctgA"][45000:45800]

    def scenario(mod, eng):
        outs = {}
        for cls in (mod.ChunkDecisionEngine, mod.DeviceChunkEngine):
            ce = cls(eng, n_channels=4, chunk_len=200,
                     policy=mod.ChunkPolicy(max_chunks=4), batch=1)
            ds = ce.process([mod.ChunkEvent(2, "rA", s[:200]),
                             mod.ChunkEvent(2, "rA", s[200:400]),
                             mod.ChunkEvent(3, "rB", s[400:600])])
            outs[cls.__name__] = sorted(_dec(d)[1:] for d in ds + ce.drain())
        return outs
    outs = _both(setup, scenario)
    assert outs["DeviceChunkEngine"] == outs["ChunkDecisionEngine"]
    assert any(t[0] == "rA" and t[2] == 2 for t in outs["DeviceChunkEngine"])


def test_device_chunk_engine_input_contract(setup):
    _, _, engines = setup
    eng = engines["port"][1]
    with pytest.raises(ValueError, match="chunk_len"):
        tchunks.DeviceChunkEngine(eng, n_channels=2, chunk_len=201)
    with pytest.raises(ValueError, match="chunk_len"):
        eng.init_chunk_state(2, 201, 4)
    ce = tchunks.DeviceChunkEngine(eng, n_channels=2, chunk_len=200, batch=2)
    assert ce._dev_buf.shape == (3, 4, 50) and ce._dev_buf.dtype == \
        torch.uint8 and ce._dev_buf.device == eng.device
    with pytest.raises(ValueError, match="non-ACGT"):
        ce.process([tchunks.ChunkEvent(0, "r0", "ACGTN" * 8)])
    with pytest.raises(ValueError, match="exceeds chunk_len"):
        ce.process([tchunks.ChunkEvent(1, "r1", "A" * 300)])
    with pytest.raises(ValueError, match="non-ACGT"):
        ce.process([tchunks.ChunkEvent(1, "r1", "acgtn" * 8)])
    # a short FINAL piece is fine; a follow-up chunk after it is not
    ce.process([tchunks.ChunkEvent(0, "r2", "ACGT" * 10)])
    with pytest.raises(ValueError, match="short"):
        ce.process([tchunks.ChunkEvent(0, "r2", "ACGT" * 50)])
    # a call of distinct channels whose last chunk is refused writes
    # nothing for the events before it: no reset, length or chunk count
    ce = tchunks.DeviceChunkEngine(eng, n_channels=3, chunk_len=200, batch=3)
    ce.process([tchunks.ChunkEvent(0, "a", "ACGT" * 50),
                tchunks.ChunkEvent(1, "b", "ACGT" * 50)])
    before = (list(ce._read_id), ce._blen.tolist(), ce._chunks.tolist(),
              ce._done.tolist(), ce._dev_buf.clone(), len(ce._inflight))
    with pytest.raises(ValueError, match="non-ACGT base .* on channel 2"):
        ce.process([tchunks.ChunkEvent(0, "a2", "ACGT" * 50),
                    tchunks.ChunkEvent(1, "b", "acgt" * 50),
                    tchunks.ChunkEvent(2, "c", "ACGTN" * 40)])
    after = (list(ce._read_id), ce._blen.tolist(), ce._chunks.tolist(),
             ce._done.tolist(), ce._dev_buf, len(ce._inflight))
    assert before[:4] == after[:4] == (["a", "b", ""], [200, 200, 0],
                                       [1, 1, 0], [False] * 3)
    assert torch.equal(before[4], after[4]) and before[5] == after[5]


def _tick_stream(genome, n_ticks=200, channels=24, chunk_len=200, seed=5):
    """A seeded stream of process() calls: each channel on a read of
    150-1500 bases (panel, other draft or junk, a quarter lower case), a
    new read as soon as one ends (a short final piece, then a reset);
    about one call in eight hands a channel two chunks (sometimes its
    read's end and the next read's start), and some reads open with an
    empty chunk.  Events ignore decisions, so decided channels keep
    sending and pipelined ones overrun max_chunks."""
    rng = np.random.default_rng(seed)
    n_read = [0]

    def new_read():
        n = int(rng.integers(150, 1500))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            s = int(rng.integers(20000, 40000 - n))
            seq = genome["ctgA"][s:s + n]
        elif kind == 1:
            s = int(rng.integers(40000, 60000 - n))
            seq = genome["ctgA"][s:s + n]
        else:
            seq = "".join(BASES[rng.integers(0, 4, n)])
        if rng.random() < 0.25:
            seq = seq.lower()
        n_read[0] += 1
        return ["r%d" % n_read[0], seq, 0, rng.random() < 0.1]

    reads = [new_read() for _ in range(channels)]

    def take(c):
        rd = reads[c]
        if rd[3]:                       # an empty chunk opens the read
            rd[3] = False
            return tchunks.ChunkEvent(c, rd[0], "")
        ev = tchunks.ChunkEvent(c, rd[0], rd[1][rd[2]:rd[2] + chunk_len])
        rd[2] += chunk_len
        if rd[2] >= len(rd[1]):
            reads[c] = new_read()
        return ev

    ticks = []
    for _ in range(n_ticks):
        chans = np.flatnonzero(rng.random(channels) < 0.7).tolist()
        ev = [take(c) for c in chans]
        if chans and rng.random() < 0.125:
            ev.insert(int(rng.integers(0, len(ev) + 1)),
                      take(int(rng.choice(chans))))
        ticks.append(ev)
    return ticks


@pytest.mark.parametrize("depth", [0, 2])
def test_device_tick_arguments_equal_jax(setup, monkeypatch, depth):
    """DeviceChunkEngine of both packages over _tick_stream: the five host
    arguments of every decide_chunk_tick (packed rows, scatter channels and
    slots, decide channels, lengths) equal in dtype, shape and bytes, and
    the decisions equal, at batch 8 under calls of ~17 events."""
    genome, _, engines = setup
    pad = 24                    # the channel count, the scatter pad row
    ticks = _tick_stream(genome, channels=pad)

    def scenario(mod, eng):
        args, tick = [], eng.decide_chunk_tick

        def spy(buf, *host):
            args.append(tuple((np.asarray(x).dtype.str, np.shape(x),
                               np.asarray(x).tobytes()) for x in host))
            return tick(buf, *host)
        monkeypatch.setattr(eng, "decide_chunk_tick", spy)
        ce = mod.DeviceChunkEngine(
            eng, n_channels=pad, chunk_len=200, batch=8,
            policy=mod.ChunkPolicy(max_chunks=4), pipeline_depth=depth)
        decs = [[_dec(d) for d in ce.process(
            [mod.ChunkEvent(e.channel, e.read_id, e.seq) for e in ev])]
            for ev in ticks]
        decs.append([_dec(d) for d in ce.drain()])
        monkeypatch.undo()
        return args, decs
    args, decs = _both(setup, scenario)
    assert len(args) > len(ticks) and sum(map(len, decs)) > 100
    assert {d[2] for t in decs for d in t} == {PROCEED, UNBLOCK, STOP}
    sc = [np.frombuffer(a[1][2], dtype=a[1][0]) for a in args]
    dc = [np.frombuffer(a[3][2], dtype=a[3][0]) for a in args]
    # rows that decide but scatter nothing: empty chunks, full buffers
    assert sum(((s == pad) & (d != pad)).sum() for s, d in zip(sc, dc))
    assert sum(len(ev) != len({e.channel for e in ev}) for ev in ticks) >= 10
    assert sum(len(ev) > 8 for ev in ticks) >= 100


def test_tick_never_duplicates_a_real_channel(setup, monkeypatch):
    """Over a whole replay, each tick scatters a real channel into at most
    one slot (pad rows all go to row C, whose decisions are dropped), and
    the tick's buffer holds what chunk_tick_core's plain scatter wrote."""
    genome, _, engines = setup
    eng = engines["port"][1]
    seen = []
    tick = eng.decide_chunk_tick

    def spy(buf, rows, s_chans, s_slots, d_chans, lengths):
        real = s_chans[s_chans != buf.shape[0] - 1]
        seen.append((len(real), len(np.unique(real)),
                     len(np.unique(d_chans[d_chans != buf.shape[0] - 1])),
                     int((d_chans != buf.shape[0] - 1).sum())))
        return tick(buf, rows, s_chans, s_slots, d_chans, lengths)
    monkeypatch.setattr(eng, "decide_chunk_tick", spy)
    ce = tchunks.DeviceChunkEngine(eng, n_channels=8, chunk_len=200,
                                   policy=tchunks.ChunkPolicy(max_chunks=4),
                                   batch=8, pipeline_depth=2)
    m = tchunks.replay_read_until(ce, _mk_reads(genome, n_each=10),
                                  unblock_overhead=100)
    assert m.n_reads == 20 and len(seen) > 10
    assert all(a == b and c == d for a, b, c, d in seen)


def test_chunk_tick_core_scatters_in_place():
    """The tick updates the buffer in place (the JAX program's donated
    .at[].set), gathers the decided channels' prefixes in slot order and
    hands them to the fused step with per-read lengths."""
    C, M, nb = 3, 2, 4
    buf = torch.zeros((C + 1, M, nb), dtype=torch.uint8)
    rows = torch.arange(1, 13, dtype=torch.uint8).reshape(3, nb)
    got = {}

    def fake(btable, packed, nmask, panel, lengths=None, **kw):
        got.update(packed=packed.clone(), lengths=lengths, L=kw["L"])
        return torch.zeros((2, packed.shape[0]), dtype=torch.int32)
    real = tdecide.decision_core_packed_fused
    tdecide.decision_core_packed_fused = fake
    try:
        out, fused = tdecide.chunk_tick_core(
            buf, None, rows, torch.tensor([1, 1, C]), torch.tensor([0, 1, 0]),
            torch.tensor([1, C]), torch.tensor([16, 0], dtype=torch.int32),
            None, L=M * nb * 4)
    finally:
        tdecide.decision_core_packed_fused = real
    assert out is buf and fused.shape == (2, 2)
    assert buf[1].reshape(-1).tolist() == list(range(1, 9))
    assert got["packed"].shape == (2, M * nb)
    assert got["packed"][0].tolist() == list(range(1, 9))
    assert got["lengths"].tolist() == [16, 0] and got["L"] == 32


def _fastq(path, reads):
    with open(path, "w") as f:
        for rid, seq, _ in reads:
            f.write("@%s\n%s\n+\n%s\n" % (rid, seq, "I" * len(seq)))


@pytest.mark.parametrize("argv", [
    ["-c", "200", "-n", "4", "--state", "host"],
    ["-c", "200", "-n", "4", "--state", "device"],
    ["-c", "200", "-n", "4", "--state", "device", "-d", "1"],
    ["-c", "200", "-n", "3", "-b", "2", "-m", "3", "-u", "50", "-d", "1"]])
def test_cli_replay_matches_jax_cli(setup, tmp_path, capsys, monkeypatch,
                                    argv):
    """`livefish replay` stdout byte-equal to the JAX CLI's on the same
    index and reads, in both states and pipelined; and --state device
    equals --state host."""
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    genome, path, _ = setup
    fq = str(tmp_path / "reads.fastq")
    _fastq(fq, _mk_reads(genome, n_each=6))
    outs = {}
    for name, mod in (("jax", jax_lcli), ("port", lcli)):
        assert mod.main(["replay", path, fq] + argv) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    assert "unblocked\t" in outs["port"]
    if "device" in argv:
        host = [a if a != "device" else "host" for a in argv]
        assert lcli.main(["replay", path, fq] + host) == 0
        assert capsys.readouterr().out == outs["port"]


def test_cli_replay_rejects_bad_state(setup, tmp_path, monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    _, path, _ = setup
    fq = str(tmp_path / "reads.fastq")
    _fastq(fq, _mk_reads(setup[0], n_each=1))
    for argv in (["--state", "disk"], ["--state", "device", "-c", "201"]):
        with pytest.raises(SystemExit):
            lcli.main(["replay", path, fq] + argv)
    assert lcli.main(["replay", path]) == 1            # usage


def test_replay_imports_no_jax(setup, tmp_path):
    """`python -m cornetto_tpu_torch.cli livefish replay` in both states
    leaves jax and the JAX package out of sys.modules (a fresh interpreter:
    the test process itself has both loaded)."""
    genome, path, _ = setup
    fq = str(tmp_path / "reads.fastq")
    _fastq(fq, _mk_reads(genome, n_each=3))
    code = (
        "import contextlib, io, sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "idx, fq = sys.argv[1:]\n"
        "for state in ('host', 'device'):\n"
        "    with contextlib.redirect_stdout(io.StringIO()) as out:\n"
        "        assert main(['cornetto', 'livefish', 'replay', idx, fq,"
        " '-c', '200', '-n', '4', '--state', state]) == 0\n"
        "    assert 'unblocked' in out.getvalue()\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, path, fq], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
