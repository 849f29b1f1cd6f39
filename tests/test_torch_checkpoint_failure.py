"""Checkpoint/resume of the port's sharded decision stream under real
process death: tests/test_checkpoint_failure.py's oracle on the port.

A life is two gloo processes (tests/_torch_ckpt_worker.py,
CORNETTO_FORCE_CPU=1) at (dp, ep) = (1, 2), joined through a fresh
``file://`` rendezvous.  They stream a FASTQ through make_sharded_engine;
rank 0 writes each batch's part file ahead of a dist/checkpoint.py
checkpoint and os._exit(9)s at the injected crash point: a torn part
write, after the part rename but before the checkpoint, and right after
the checkpoint.  Rank 1 then fails in its next collective.  A relaunched
life must resume from the last durable cursor, recompute only what was
not yet checkpointed, and produce decisions.tsv and final tallies
byte-identical to an uninterrupted life's, which in turn equal the JAX
worker's (tests/_ckpt_worker.py) on the same reads: tolerance 0."""

import os
import re
import subprocess
import sys
import uuid

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_ckpt_worker.py")
JAX_WORKER = os.path.join(HERE, "_ckpt_worker.py")
REPO = os.path.dirname(HERE)

N_READS = 70   # 4 full batches of 16 + one partial
TIMEOUT_S = 300


def _mk_fastq(path):
    """tests/test_checkpoint_failure.py's read mix, but drawn from the
    workers' own genome (seed 1234; that test's reads, from seed 77, hit
    nothing), so the decisions, contigs and positions vary."""
    bases = np.array(list("ACGT"))
    rng = np.random.default_rng(1234)
    genome = {"ctgA": "".join(bases[rng.integers(0, 4, 50000)]),
              "ctgB": "".join(bases[rng.integers(0, 4, 30000)])}
    rng = np.random.default_rng(77)
    with open(path, "w") as f:
        for i in range(N_READS):
            if i % 5 == 4:
                seq = "".join(bases[rng.integers(0, 4, 300)])
            else:
                ctg = "ctgA" if i % 2 == 0 else "ctgB"
                s = int(rng.integers(0, len(genome[ctg]) - 300))
                seq = genome[ctg][s:s + 300]
            f.write("@r%03d\n%s\n+\n%s\n" % (i, seq, "I" * len(seq)))


def _env():
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _life(workdir, fastq, crash):
    """One life: both ranks, a fresh rendezvous file.  Returns rank 0's
    exit code and output, and rank 1's exit code."""
    rdv = os.path.join(workdir, "rdv.%s" % uuid.uuid4().hex)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(rank), "2", rdv, workdir, fastq, crash,
         "--timeout", "60"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=REPO) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs[0].returncode, outs[0], procs[1].returncode, outs[1]


def _computed_batches(out):
    return [int(m) for m in re.findall(r"batch (\d+) computed", out)]


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The FASTQ and the uninterrupted life's decisions and tallies."""
    work = tmp_path_factory.mktemp("torch_ckpt")
    fastq = str(work / "reads.fq")
    _mk_fastq(fastq)
    odir = work / "oracle"
    odir.mkdir()
    rc, out, rc1, out1 = _life(str(odir), fastq, "none")
    assert rc == 0 and rc1 == 0 and "DONE" in out, (out + out1)[-3000:]
    assert _computed_batches(out) == [0, 1, 2, 3, 4]
    return dict(fastq=fastq, work=work,
                decisions=(odir / "decisions.tsv").read_bytes(),
                tally=re.search(r"tallies (.+)", out).group(1))


def test_oracle_equals_jax_worker(oracle):
    """The JAX worker's uninterrupted run (its engine on two virtual CPU
    devices, its index built by the JAX package from the same seed) on the
    same reads: the same decisions.tsv bytes and tallies."""
    jdir = oracle["work"] / "jax"
    jdir.mkdir()
    p = subprocess.run([sys.executable, JAX_WORKER, str(jdir),
                        oracle["fastq"], "none"], capture_output=True,
                       text=True, env=_env(), cwd=REPO, timeout=TIMEOUT_S)
    assert p.returncode == 0 and "DONE" in p.stdout, p.stderr[-3000:]
    assert (jdir / "decisions.tsv").read_bytes() == oracle["decisions"]
    assert re.search(r"tallies (.+)", p.stdout).group(1) == oracle["tally"]
    rows = oracle["decisions"].decode().splitlines()
    assert len(rows) == N_READS
    # both decisions occur, and reads of both contigs are placed
    assert {r.split("\t")[1] for r in rows} == {"0", "1"}
    assert {r.split("\t")[2] for r in rows} >= {"0", "1"}


@pytest.mark.parametrize("crash", ["mid_part:1", "after_part:1",
                                   "after_ckpt:2"])
def test_resume_after_kill_is_byte_identical(oracle, crash):
    wdir = oracle["work"] / crash.replace(":", "_")
    wdir.mkdir()
    fastq = oracle["fastq"]

    # crashed life: rank 0 dies at the crash point, rank 1 in a collective
    rc, out1, rc1, rank1 = _life(str(wdir), fastq, crash)
    assert rc == 9 and ("CRASH " + crash) in out1, out1[-2000:]
    assert rc1 != 0, rank1[-2000:]
    assert not (wdir / "decisions.tsv").exists()

    # resumed life: completes, recomputing ONLY past the durable cursor
    rc, out2, rc1, rank1 = _life(str(wdir), fastq, "none")
    assert rc == 0 and rc1 == 0 and "DONE" in out2, (out2 + rank1)[-3000:]
    kind, i = crash.split(":")
    cursor = int(i) + (1 if kind == "after_ckpt" else 0)
    if cursor:
        assert ("resumed at cursor %d" % cursor) in out2, out2[-2000:]
    assert _computed_batches(out2) == list(range(cursor, 5))

    assert (wdir / "decisions.tsv").read_bytes() == oracle["decisions"]
    assert re.search(r"tallies (.+)", out2).group(1) == oracle["tally"]
