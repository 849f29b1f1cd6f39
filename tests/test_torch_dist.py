"""The port's multi-device runtime (cornetto_tpu_torch/dist/ and the sharded
decision engine) against the JAX package's, on the CPU.

The JAX side runs in this process on conftest's 8 virtual CPU devices.
The port's side runs in real processes: gloo process groups of 2, 4 and
8 ranks (tests/_torch_dist_worker.py, CORNETTO_FORCE_CPU=1, one intra-op
thread a rank), each spawned once for the module with a ``file://``
rendezvous under the test's temporary directory, running all of its
world size's cases in that one group.  The indexes are built and written
by the JAX package (the ``.npz`` both packages read).  Integers
throughout; tolerance 0."""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cornetto_tpu.dist.checkpoint import save_index
from cornetto_tpu.dist.mesh import decision_mesh as jax_decision_mesh
from cornetto_tpu.dist.mesh import make_mesh as jax_make_mesh
from cornetto_tpu.dist.scan import sharded_window_stats as jax_window_stats
from cornetto_tpu.kernels.minimizer import encode_seq, pack_reads
from cornetto_tpu.kernels.window_sum import window_stats_numpy
from cornetto_tpu.livefish import decide as jd
from cornetto_tpu.livefish.chunks import ChunkDecisionEngine, ChunkEvent
from cornetto_tpu.livefish.index import build_index, build_panel_mask
from cornetto_tpu_torch.dist import multihost
from cornetto_tpu_torch.dist.mesh import decision_axes
from cornetto_tpu_torch.kernels.decide import (_lookup_votes,
                                               _policy_from_stats)
from cornetto_tpu_torch.kernels.extract import extract_minima_ref
from cornetto_tpu_torch.kernels.votes import (policy_from_stats,
                                              sharded_votes)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
REPO = os.path.dirname(HERE)
BASES = np.array(list("ACGT"))
L = 400
FORMS = ("decide", "nmask", "lengths", "neither")
# (dp, ep) meshes by world size (tests/test_livefish.py:78 and :109)
LAYOUTS = {2: [(1, 2), (2, 1)],
           4: [(1, 2), (2, 1), (2, 2), (1, 4), (4, 1)],
           8: [(1, 4), (4, 1), (2, 4), (4, 2), (1, 8), (8, 1)]}
# sp scans by world size, each at tests/test_dist.py's (length, w, inc)
SCANS = {2: [1, 2], 4: [4], 8: [8]}
SCAN_CASES = [(100000, 2500, 50), (5000, 999, 37), (1000, 2500, 50)]
# meshes whose rank layout and groups are recorded, beside decision_mesh()
MESHES = {2: [{"dp": 1, "ep": 2}, {"dp": -1, "ep": 2}, {"sp": 1}],
          4: [{"dp": 2, "ep": 2}, {"dp": -1, "ep": 2}, {"dp": 1, "ep": 2},
              {"a": 2, "b": 1, "c": 2}],
          8: [{"dp": 2, "ep": 4}, {"dp": 4, "ep": 2}, {"dp": -1, "ep": 4},
              {"x": 2, "y": 2, "z": 2}]}
CHUNKS = {4: (2, 2)}
# the (dp, ep) engine whose rank shards go through save_sharded
SHARDED_CKPT = {2: (1, 2)}
TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(genome, rng, n, contig, lo, hi):
    seq = genome[contig]
    reads = np.zeros((n, L), dtype=np.uint8)
    for i in range(n):
        s = int(rng.integers(lo, hi - L))
        reads[i] = encode_seq(seq[s:s + L])
    return reads


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """The genome, the JAX-built indexes of 1-8 shards written as .npz,
    the batches and the depth tracks, in one work directory."""
    work = str(tmp_path_factory.mktemp("torch_dist"))
    rng = np.random.default_rng(99)
    genome = {"ctgA": "".join(BASES[rng.integers(0, 4, 60000)]),
              "ctgB": "".join(BASES[rng.integers(0, 4, 40000)])}
    rows = [("ctgA", 20000, 40000)]
    idx = {}
    for E in (1, 2, 4, 8):
        idx[E] = build_index(genome, n_shards=E)
        panel = build_panel_mask(idx[E], rows)
        save_index(os.path.join(work, "idx%d" % E), idx[E], panel_mask=panel)
    rng = np.random.default_rng(6)
    reads = np.concatenate([
        _sample(genome, rng, 8, "ctgA", 21000, 38000),
        _sample(genome, rng, 8, "ctgA", 42000, 59000),
        _sample(genome, rng, 8, "ctgB", 0, 39000),
        rng.integers(0, 4, size=(8, L)).astype(np.uint8)])
    rng = np.random.default_rng(13)
    short = np.full((32, L), 4, dtype=np.uint8)
    lengths = rng.integers(120, L + 1, size=32).astype(np.int32)
    for i in range(32):
        seq = genome["ctgA" if i % 3 else "ctgB"]
        s = int(rng.integers(0, len(seq) - L))
        short[i, :lengths[i]] = encode_seq(seq[s:s + int(lengths[i])])
    packed, nmask = pack_reads(short)
    inputs = dict(L=np.int64(L), reads=reads, packed=packed, nmask=nmask,
                  lengths=lengths, ctgA=encode_seq(genome["ctgA"]))
    for c, (length, _, _) in enumerate(SCAN_CASES):
        inputs["depth%d" % c] = np.random.default_rng(
            1000 + length).integers(0, 65536, size=length).astype(np.int32)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    return dict(work=work, genome=genome, rows=rows, idx=idx,
                panel=build_panel_mask(idx[1], rows), inputs=inputs)


def _start(shared, world):
    """Start the world's gloo processes; returns them."""
    work = shared["work"]
    plan = dict(engine=LAYOUTS[world],
                scan=[(n, c) for n in SCANS[world]
                      for c in range(len(SCAN_CASES))],
                scan_cases=SCAN_CASES, meshes=MESHES[world],
                chunks=CHUNKS.get(world),
                sharded_ckpt=SHARDED_CKPT.get(world), timeout=TIMEOUT_S)
    with open(os.path.join(work, "plan%d.json" % world), "w") as f:
        json.dump(plan, f)
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                              work], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, env=env, cwd=REPO)
            for r in range(world)]


def _finish(shared, world, procs):
    """Wait for the world's processes; returns each rank's results."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S + 60)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "rank %d of %d failed:\n%s" % (
            r, world, out[-4000:])
    return [dict(np.load(os.path.join(shared["work"], "w%d_r%d.npz"
                                      % (world, r))))
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(shared):
    """world size -> each rank's results.  The three process groups start
    together when the fixture is first used and run beside the JAX side;
    each is waited for at its first use."""
    started = {w: _start(shared, w) for w in sorted(LAYOUTS)}
    done = {}

    def get(world):
        if world not in done:
            done[world] = _finish(shared, world, started.pop(world))
        return done[world]
    yield get
    for world, procs in started.items():       # never waited for
        for p in procs:
            p.kill()
            p.wait()


@pytest.fixture(scope="module")
def jax_ref(shared):
    """(dp, ep, form) -> the JAX sharded engine's six outputs, and (0, 0,
    form) -> the JAX single-chip engine's, every one computed up front on
    four threads (XLA compiles outside the GIL: ~1 s a program here)."""
    import jax
    from concurrent.futures import ThreadPoolExecutor
    from jax.sharding import Mesh
    inp = shared["inputs"]
    args = {"nmask": (inp["packed"], inp["nmask"], None),
            "lengths": (inp["packed"], None, inp["lengths"]),
            "neither": (inp["packed"], None, None)}
    engines = {(0, 0): jd.SingleChipEngine(shared["idx"][1],
                                           shared["panel"])}
    for dp, ep in {lay for lays in LAYOUTS.values() for lay in lays}:
        mesh = Mesh(np.array(jax.devices()[:dp * ep]).reshape(dp, ep),
                    ("dp", "ep"))
        engines[(dp, ep)] = jd.make_sharded_engine(
            mesh, shared["idx"][ep],
            build_panel_mask(shared["idx"][ep], shared["rows"]))

    def run(key):
        eng, form = engines[key[:2]], key[2]
        if form == "decide":
            res = eng.decide(inp["reads"]) if key[:2] == (0, 0) \
                else eng(inp["reads"])
        else:
            pk, nm, ln = args[form]
            res = eng.decide_packed(pk, nm, L, lengths=ln)
        return [np.asarray(x) for x in res]
    # the single-chip engine's first two calls alone: its jit cache of
    # the packed forms is made at first use
    keys = [(0, 0, f) for f in FORMS]
    out = {k: run(k) for k in keys[:2]}
    keys = keys[2:] + [lay + (f,) for lay in engines if lay != (0, 0)
                       for f in FORMS]
    with ThreadPoolExecutor(4) as ex:
        out.update(zip(keys, ex.map(run, keys)))
    return lambda dp, ep, form: out[(dp, ep, form)]


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


ENGINE_CASES = [(w, dp, ep, f) for w, lays in LAYOUTS.items()
                for dp, ep in lays for f in FORMS]


@pytest.mark.parametrize("world,dp,ep,form", ENGINE_CASES)
def test_sharded_engine_matches_jax(runs, jax_ref, world, dp, ep, form):
    """Every rank of the mesh gets the whole batch's six outputs, equal to
    the JAX sharded engine's and the JAX single-chip engine's on the same
    reads: decide(reads), and decide_packed with the N bitmap, with the
    lengths, and with neither."""
    want = jax_ref(dp, ep, form)
    _same(want, jax_ref(0, 0, form))
    res = runs(world)
    for r in range(dp * ep):
        got = [res[r]["engine/%dx%d/%s/%d" % (dp, ep, form, i)]
               for i in range(6)]
        _same(got, want)
    for r in range(dp * ep, world):              # ranks past the mesh
        assert not any(k.startswith("engine/%dx%d/" % (dp, ep))
                       for k in res[r])


SCAN_TESTS = [(w, n, c) for w, ns in SCANS.items() for n in ns
              for c in range(len(SCAN_CASES))]


@pytest.mark.parametrize("world,n_sp,case", SCAN_TESTS)
def test_sharded_window_stats_matches_jax(runs, shared, world, n_sp, case):
    length, w, inc = SCAN_CASES[case]
    d = shared["inputs"]["depth%d" % case]
    want = jax_window_stats(jax_make_mesh({"sp": n_sp}), d, length, w, inc)
    st0, end0, m0, _ = window_stats_numpy(d, d, w, inc)
    _same(want, (st0, end0, m0))
    res = runs(world)
    for r in range(n_sp):
        got = [res[r]["scan/%d/%d/%s" % (n_sp, case, k)]
               for k in ("st", "end", "means")]
        _same(got, want)


@pytest.mark.parametrize("world", sorted(LAYOUTS))
def test_halo_exchange_and_psum(runs, world):
    """tests/_mp_worker.py's two checks across the process boundary: an
    all_reduce of ones (its psum) and each rank's shard of the stride-1
    halo-exchanged sums against the forward sums of the padded array."""
    W, n = 64, 256 * world
    depth = np.zeros(n, dtype=np.int32)
    depth[:n - W] = (np.arange(n - W) * 7) % 101
    want = np.convolve(depth, np.ones(W, np.int64))[W - 1:n + W - 1]
    for r, res in enumerate(runs(world)):
        assert int(res["allreduce"][0]) == world
        assert res["halo"].dtype == np.int32
        np.testing.assert_array_equal(res["halo"].astype(np.int64),
                                      want[r * 256:(r + 1) * 256])


@pytest.mark.parametrize("world", sorted(LAYOUTS))
def test_mesh_layout_is_row_major(runs, world):
    """Ranks fill the grid in row-major order (np.arange(world).reshape);
    an axis's group holds the ranks that share every other coordinate; -1
    absorbs the rest; ranks past a smaller mesh are outside it; the default
    decision mesh is JAX's."""
    res = runs(world)
    probes = [(json.dumps(a), a) for a in MESHES[world]]
    probes.append(("decision", decision_axes(world)))
    for key, axes in probes:
        sizes = [s if s != -1 else 0 for s in axes.values()]
        if 0 in sizes:
            known = int(np.prod([s for s in sizes if s]))
            sizes = [s or world // known for s in sizes]
        total = int(np.prod(sizes))
        grid = np.arange(total).reshape(sizes)
        for r in range(world):
            np.testing.assert_array_equal(res[r]["mesh/%s/sizes" % key],
                                          sizes)
            coords = res[r]["mesh/%s/coords" % key]
            if r >= total:
                assert (coords == -1).all()
                continue
            assert grid[tuple(coords)] == r
            for i, name in enumerate(axes):
                line = np.moveaxis(grid, i, -1)[
                    tuple(np.delete(coords, i))]
                np.testing.assert_array_equal(
                    res[r]["mesh/%s/%s" % (key, name)], line)


def test_decision_axes_match_jax_defaults():
    import jax
    for n in range(1, 9):
        want = jax_decision_mesh(devices=jax.devices()[:n]).shape
        assert decision_axes(n) == {"dp": want["dp"], "ep": want["ep"]}
    assert decision_axes(8, n_ep=2) == {"dp": 4, "ep": 2}
    assert decision_axes(8, n_dp=1, n_ep=4) == {"dp": 1, "ep": 4}


def test_chunks_over_sharded_engine(runs, shared):
    """tests/test_livefish_chunks.py:89-112 on the port: the chunk state
    machine over the (2, 2) sharded engine gives the single-device
    engine's actions on every rank, equal to the JAX package's."""
    genome = shared["genome"]
    ce = ChunkDecisionEngine(jd.SingleChipEngine(shared["idx"][1],
                                                 shared["panel"]),
                             n_channels=4, chunk_len=200, batch=4)
    s_boring = genome["ctgA"][25000:25800]
    s_fun = genome["ctgA"][45000:45800]
    want = []
    for t in range(4):
        ev = [ChunkEvent(0, "rb", s_boring[t * 200:(t + 1) * 200]),
              ChunkEvent(1, "rf", s_fun[t * 200:(t + 1) * 200])]
        want.append(sorted((d.channel, d.action) for d in ce.process(ev)))
    assert ce._done[0] and ce._done[1]
    dp, ep = CHUNKS[4]
    for res in runs(4)[:dp * ep]:
        for t in range(4):
            for name in ("single", "sharded"):
                got = [tuple(x) for x in res["chunks/%s/%d" % (name, t)]]
                assert got == want[t], (name, t)
        assert res["chunks/done"].all()


def test_sharded_checkpoint_round_trip_gloo(runs, shared, jax_ref):
    """save_sharded / load_sharded at gloo world size 2: each rank gets
    back its own table shard (the JAX-built index's btable[rank]) and the
    panel bit for bit, into given tensors and into new ones, and the (1,
    2) engine on the reloaded state decides the rows the JAX engines
    decide."""
    dp, ep = SHARDED_CKPT[2]
    want = jax_ref(dp, ep, "decide")
    panel = build_panel_mask(shared["idx"][ep], shared["rows"])
    for r, res in enumerate(runs(2)):
        for pre in ("ckpt/", "ckpt/fresh/"):
            for k, w in (("btable", shared["idx"][ep].btable[r]),
                         ("panel", panel)):
                assert res[pre + k].dtype == w.dtype, (r, pre, k)
                np.testing.assert_array_equal(res[pre + k], w)
        _same([res["ckpt/decide/%d" % i] for i in range(6)], want)


def test_sharded_checkpoint_round_trip_world_size_1(tmp_path, shared,
                                                    jax_ref):
    """save_sharded / load_sharded with no process group: a single-device
    engine's state round-trips bit for bit, overwriting an earlier
    checkpoint in place, and the engine on the reloaded state decides the
    JAX single-chip engine's rows."""
    import dataclasses
    import torch.distributed as dist
    from cornetto_tpu_torch.dist.checkpoint import (load_index,
                                                    load_sharded,
                                                    save_sharded)
    from cornetto_tpu_torch.livefish.decide import SingleChipEngine
    assert not dist.is_initialized()
    idx, panel, _ = load_index(os.path.join(shared["work"], "idx1"))
    eng = SingleChipEngine(idx, panel, device="cpu")
    tree = {"btable": eng.state.btable, "panel": eng.state.panel}
    path = str(tmp_path / "ckpt")
    assert save_sharded(path, {"btable": torch.zeros(3, dtype=torch.int64)})
    assert save_sharded(path, tree) is True
    back = load_sharded(path, {k: torch.full_like(v, -1)
                               for k, v in tree.items()})
    fresh = load_sharded(path)
    assert sorted(fresh) == ["btable", "panel"]
    for k, v in tree.items():
        for got in (back[k], fresh[k]):
            assert got.dtype == v.dtype and torch.equal(got, v)
    np.testing.assert_array_equal(back["btable"].numpy(), idx.btable[0])
    eng.state = dataclasses.replace(eng.state, **back)
    _same([r.numpy() for r in eng.decide(shared["inputs"]["reads"])],
          jax_ref(0, 0, "decide"))


@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("n_ctg", [2, 87])
def test_plain_split_matches_jax_sharded_step(shared, ep, n_ctg):
    """The plain versions of the sharded step in one process: the owner-
    filtered _lookup_votes of every shard summed, then _policy_from_stats,
    equal to the JAX _decide_from_minima with ep_axis under shard_map; both
    sides of the plain version's one-hot / scatter-add switch (C <= 64).
    The votes and policy wrappers' CPU paths agree with them."""
    import jax
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    sys.path.insert(0, HERE)
    import _decide_cases as dc
    if n_ctg == 2:
        genome, rows = shared["genome"], shared["rows"]
    else:
        names, codes = dc.draft(5, n_ctg, L)
        genome = {n: "".join(BASES[c]) for n, c in zip(names, codes)}
        rows = [(n, 0, len(genome[n])) for n in names[::2]]
    idx = shared["idx"][ep] if n_ctg == 2 else build_index(genome,
                                                          n_shards=ep)
    panel = build_panel_mask(idx, rows)
    rng = np.random.default_rng([ep, n_ctg])
    reads = np.stack([encode_seq(s[o:o + L]) for s, o in (
        (seq, int(rng.integers(0, len(seq) - L)))
        for seq in (genome[n] for n in rng.choice(list(genome), size=32)))])
    reads[::5] = rng.integers(0, 4, size=reads[::5].shape)
    packed, _ = pack_reads(reads)
    h, valid = extract_minima_ref(torch.from_numpy(packed), None, L, idx.k,
                                  idx.w)
    kw = dict(min_hits=3, bin_size=1000)
    mesh = Mesh(np.array(jax.devices()[:ep]), ("ep",))

    def local(bt, hh, vv, pn):
        return jd._decide_from_minima(bt[0], hh, vv, pn, kw["min_hits"],
                                      kw["bin_size"], idx.bucket_shift,
                                      ep_axis="ep", ep_size=ep,
                                      two_choice=idx.two_choice)
    fn = jax.jit(shard_map(local, mesh=mesh,
                           in_specs=(P("ep", None, None), P("ep", None),
                                     P("ep", None), P(None, None)),
                           out_specs=(P("ep"),) * 6, check_vma=False))
    want = [np.asarray(x) for x in fn(
        idx.btable, h.numpy().view(np.uint32), valid.numpy(), panel)]
    pn = torch.from_numpy(panel)
    planes = []
    for s in range(ep):
        bt = torch.from_numpy(idx.btable[s])
        planes.append(torch.stack(_lookup_votes(
            bt, idx.bucket_shift, h, valid, n_ctg, idx.two_choice,
            owner=(ep, s))))
        part = sharded_votes(h, valid, bt, idx.bucket_shift, idx.two_choice,
                             ep, s, n_ctg, parts=ep)
        assert part.shape == (ep, 9, 32 // ep, n_ctg)
        assert torch.equal(part.transpose(0, 1).reshape(9, 32, n_ctg),
                           planes[-1])
    stats = torch.stack(planes).sum(dim=0, dtype=torch.int32)
    got = _policy_from_stats(stats, pn, **kw)
    _same([g.numpy() for g in got], want)
    _same([g.numpy() for g in policy_from_stats(stats, pn, **kw)], want)


def test_votes_wrappers_check_their_arguments():
    h = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.ones((4, 3), dtype=torch.bool)
    bt = torch.zeros((8, 8), dtype=torch.int32)
    for kw in (dict(ep=3, shard=0), dict(ep=2, shard=2), dict(C=0),
               dict(C=65536), dict(parts=3)):
        args = dict(ep=2, shard=0, C=5, parts=1)
        args.update(kw)
        with pytest.raises(ValueError):
            sharded_votes(h, v, bt, 0, True, **args)
    stats = torch.zeros((9, 4, 5), dtype=torch.int32)
    with pytest.raises(ValueError):
        policy_from_stats(stats, torch.zeros((4, 2), dtype=torch.bool), 3,
                          1000)
    with pytest.raises(TypeError):
        policy_from_stats(stats.long(), torch.zeros((5, 2), dtype=torch.bool),
                          3, 1000)


def test_initialize_without_a_group_returns_false(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_reads_world_and_rank_from_the_environment(monkeypatch,
                                                              tmp_path):
    """World size and rank from torchrun's variables; gloo on the CPU."""
    import torch.distributed as dist
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert multihost.initialize(
        init_method="file://" + str(tmp_path / "rdv"),
        timeout=datetime.timedelta(seconds=60))
    try:
        assert dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
        x = torch.ones(3, dtype=torch.int32)
        dist.all_reduce(x)
        assert x.tolist() == [1, 1, 1]
        assert multihost.host_local_batch(8) == 8
    finally:
        dist.destroy_process_group()
