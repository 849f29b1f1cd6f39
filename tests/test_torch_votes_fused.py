"""The sharded engine's one-shard step on the CPU: ShardedEngine.step at
(dp, ep) = (1, 1), which runs the single-device fused step
(kernels.decide.decide_packed) with no extraction of its own, no planes
and no reduce-scatter, against the JAX package's single-device
decision_core_packed on the same packed reads.  Integer results,
tolerance 0; the indexes and reads come from numpy seeds
(tests/_decide_cases.py): all three validity variants, two_choice on and
off, C = 3, 64, 65 and 300 contigs, tables of 8 and 16 slots, min_hits 0
and 3, reads with no valid window, reads with ambiguous hits only and
two-contig vote ties.  The gloo process group is one rank in this
process."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax.numpy as jnp

from cornetto_tpu.livefish import decide as jd
from cornetto_tpu_torch.dist import multihost
from cornetto_tpu_torch.dist.mesh import make_mesh
from cornetto_tpu_torch.livefish import decide as td
import _decide_cases as dc  # tests/, on sys.path under pytest

L = 450
SEED = 8
# (C, two_choice, slots a bucket)
CASES = [(c, tc, 4) for c in (3, 64, 65, 300) for tc in (True, False)] + \
    [(5, True, 8), (5, False, 16)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A (1, 1) mesh over a one-rank gloo group on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CORNETTO_FORCE_CPU", "1")
        rdv = tmp_path_factory.mktemp("rdv") / "gloo"
        assert multihost.initialize(init_method="file://%s" % rdv,
                                    world_size=1, rank=0, backend="gloo")
        try:
            yield make_mesh({"dp": 1, "ep": 1})
        finally:
            dist.destroy_process_group()


@functools.lru_cache(maxsize=None)
def _index(C, two_choice, slots):
    return dc.index(SEED, C, two_choice, L=L, slots=slots)


@functools.lru_cache(maxsize=None)
def _batch(C, two_choice, slots, variant):
    idx, panel, codes = _index(C, two_choice, slots)
    return dc.batch(SEED, idx, panel, codes, variant, L=L)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _refuse(*a, **kw):
    raise AssertionError("the ep = 1 step ran an ep > 1 stage")


@pytest.mark.parametrize("min_hits", [0, 3])
@pytest.mark.parametrize("variant", dc.VARIANTS)
@pytest.mark.parametrize("case", CASES)
def test_one_shard_step_matches_jax_single_device(mesh, monkeypatch, case,
                                                  variant, min_hits):
    """At ep = 1 the sharded step (the fused single-device step, with no
    extraction, votes or policy launch of its own) equals the JAX
    package's single-device step on the same reads."""
    idx, panel, _ = _index(*case)
    packed, nmask, lengths, rows = _batch(*case, variant)
    want = jd.decision_core_packed(
        jnp.asarray(idx.btable[0]), jnp.asarray(packed), _j(nmask),
        jnp.asarray(panel), L=L, k=idx.k, w=idx.w, min_hits=min_hits,
        bin_size=1000, bucket_shift=idx.bucket_shift, use_pallas=False,
        lengths=_j(lengths), two_choice=idx.two_choice)
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    eng = td.make_sharded_engine(mesh, idx, panel,
                                 td.DecisionParams(min_hits=min_hits))
    for name in ("extract_minima", "sharded_votes", "policy_from_stats"):
        monkeypatch.setattr(td, name, _refuse)
    marks = []
    got = eng.step(*eng.upload(packed, nmask, lengths), L,
                   mark=marks.append)
    assert marks == ["extract", "gather", "votes", "reduce", "policy",
                     "outputs"]
    assert len(got) == len(want) == 6
    for g, w, dt in zip(got, want, [torch.int8] + [torch.int32] * 5):
        assert g.dtype == dt and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d, best, _, nh, _, _ = (o.numpy() for o in got)
    none = rows["junk"] + rows["empty"]
    assert (nh[none] == 0).all() and (best[none] == 0).all()
    assert (nh[rows["ambiguous"]] > 0).all()
