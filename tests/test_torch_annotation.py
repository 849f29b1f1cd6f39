"""The annotation chain through the port's CLI (cornetto_tpu_torch.cli):
sdust, telofind, telowin and telobreaks under CORNETTO_FORCE_CPU=1 against
test_data/golden (the reference C tool's outputs, byte for byte), the
device backends (the default) and the host ones, and the entry points'
freedom from jax.  The device DP's chunk core is cut to its smallest (2W)
here so the plain lane-parallel DP stays fast on the CPU; the result does
not depend on it."""

import contextlib
import io
import os
import subprocess
import sys

import pytest
import torch

from cornetto_tpu_torch import cli
from cornetto_tpu_torch.tools import sdust as tsdust

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["cornetto"] + argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    monkeypatch.setattr(tsdust, "CORE", 128)
    # the plain DP's small ops gain nothing from intra-op threads, and the
    # suite's parallel workers would oversubscribe the cores with them
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("golden,args", [
    ("sdust.txt", []),
    ("sdust.txt", ["--backend", "device"]),
    ("sdust_w32t14.txt", ["-w", "32", "-t", "14"]),
    ("sdust_w32t14.txt", ["-w", "32", "-t", "14", "--backend", "device"]),
    ("sdust_w32t14.txt", ["-w32", "-t14", "--backend=device"]),
    ("sdust.txt", ["--backend", "host"]),
    ("sdust_w32t14.txt", ["-w", "32", "-t", "14", "--backend", "host"])])
def test_sdust_golden(cpu, synth, gold, golden, args):
    rc, out, err = _cli(["sdust"] + args + [str(synth / "asm.fasta")])
    assert rc == 0, err
    assert out == (gold / golden).read_text()
    assert "CMD: sdust" in err


def test_sdust_run_reports_stats(cpu, synth, gold):
    """tools.sdust.run(stats=...) adds each contig's counts and seconds per
    part; the output is the golden's."""
    out, stats = io.StringIO(), {}
    tsdust.run(str(synth / "asm.fasta"), backend="device", out=out,
               stats=stats)
    assert out.getvalue() == (gold / "sdust.txt").read_text()
    assert stats["chunks"] > 0 and stats["overflow_rows"] == 0
    assert all(stats[k] >= 0 for k in ("plan", "h2d", "kernel", "readback",
                                       "overflow", "host_spans", "assemble"))


def test_sdust_device_rejects_wide_window_and_low_threshold(cpu, synth):
    rc, out, err = _cli(["sdust", "-w", "67", "--backend", "device",
                         str(synth / "asm.fasta")])
    assert rc == 1 and out == ""
    assert "W=67 is outside 3..66" in err and "--backend host" in err
    rc, out, err = _cli(["sdust", "-t", "4", "--backend", "device",
                         str(synth / "asm.fasta")])
    assert rc == 1 and out == "" and "T=4 is below 5" in err
    # outside the device DP's range the default backend is the host DP:
    # its rows are the port's --backend host rows and the JAX CLI's
    from cornetto_tpu.cli import main as jax_main
    for args, n_rows in ((["-w", "67"], 24), (["-t", "4"], 1358)):
        rc, out, err = _cli(["sdust"] + args + [str(synth / "asm.fasta")])
        assert rc == 0 and out.count("\n") == n_rows
        rc, host, _ = _cli(["sdust"] + args + ["--backend", "host",
                                               str(synth / "asm.fasta")])
        assert rc == 0 and out == host
        jax_out = io.StringIO()
        with contextlib.redirect_stdout(jax_out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert jax_main(["cornetto", "sdust"] + args
                            + [str(synth / "asm.fasta")]) == 0
        assert out == jax_out.getvalue()
    # the host DP takes any window and threshold
    rc, out, _ = _cli(["sdust", "-w", "67", "-t", "4", "--backend", "host",
                       str(synth / "asm.fasta")])
    assert rc == 0 and out


@pytest.mark.parametrize("golden,args", [
    ("telofind.txt", []),
    ("telofind.txt", ["--backend", "device"]),
    ("telofind.txt", ["--backend=device"]),
    ("telofind_ccctaa.txt", ["CCCTAA"]),
    ("telofind_ccctaa.txt", ["CCCTAA", "--backend", "device"]),
    ("telofind.txt", ["--backend", "host"]),
    ("telofind_ccctaa.txt", ["CCCTAA", "--backend=host"])])
def test_telofind_golden(cpu, synth, gold, golden, args):
    rc, out, err = _cli(["telofind", str(synth / "asm.fasta")] + args)
    assert rc == 0, err
    assert out == (gold / golden).read_text()


def test_telofind_env_switch_and_bad_backend(cpu, monkeypatch, synth, gold):
    """No switch is needed for the mask kernel: it is the default backend
    (the JAX package's CORNETTO_TELOFIND_DEVICE is not read); --backend
    host takes the memchr scan; any other backend exits 1."""
    from cornetto_tpu_torch.kernels import telo
    calls = []
    real = telo.telo_match_mask
    monkeypatch.setattr(telo, "telo_match_mask",
                        lambda *a: calls.append(1) or real(*a))
    rc, out, _ = _cli(["telofind", str(synth / "asm.fasta")])
    assert rc == 0 and out == (gold / "telofind.txt").read_text()
    assert len(calls) == 8                      # 4 contigs x 2 strands
    rc, out, _ = _cli(["telofind", str(synth / "asm.fasta"), "--backend",
                       "host"])
    assert rc == 0 and out == (gold / "telofind.txt").read_text()
    assert len(calls) == 8
    rc, out, err = _cli(["telofind", str(synth / "asm.fasta"), "--backend",
                         "nope"])
    assert rc == 1 and out == "" and "host or device" in err


def test_default_backends_reach_the_device_kernels(cpu, monkeypatch, synth,
                                                   gold):
    """sdust and telofind with no --backend run their DP and mask on the
    port's device (sdust_device, telo_match_positions); --backend host
    reaches neither; an unknown backend exits 1.  telofind's device path
    never builds a contig-long host mask (telo_match_mask_long)."""
    from cornetto_tpu_torch.kernels import telo
    from cornetto_tpu_torch.tools import telofind as ttf
    calls = {"sdust": 0, "telo": 0, "long": 0}

    def spy(name, real):
        def f(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return f
    monkeypatch.setattr(tsdust, "sdust_device",
                        spy("sdust", tsdust.sdust_device))
    monkeypatch.setattr(ttf, "telo_match_positions",
                        spy("telo", ttf.telo_match_positions))
    monkeypatch.setattr(telo, "telo_match_mask_long",
                        spy("long", telo.telo_match_mask_long))
    fasta = str(synth / "asm.fasta")
    rc, out, _ = _cli(["sdust", fasta])
    assert rc == 0 and out == (gold / "sdust.txt").read_text()
    rc, out, _ = _cli(["telofind", fasta])
    assert rc == 0 and out == (gold / "telofind.txt").read_text()
    assert calls == {"sdust": 4, "telo": 8, "long": 0}  # 4 contigs x 2
    assert _cli(["sdust", "--backend", "host", fasta])[0] == 0
    assert _cli(["telofind", fasta, "--backend", "host"])[0] == 0
    assert calls == {"sdust": 4, "telo": 8, "long": 0}
    rc, out, err = _cli(["sdust", "--backend", "nope", fasta])
    assert rc == 1 and out == "" and "host or device" in err


def test_telofind_reads_back_only_positions(cpu, monkeypatch, synth, gold):
    """The only tensors telofind's device path moves to the host are the
    match positions: int64, one per match, never a mask as long as the
    contig."""
    from cornetto_tpu_torch.io.fasta import read_fastx
    seen = []
    real = torch.Tensor.cpu

    def cpu_spy(t, *a, **k):
        seen.append((t.dtype, t.numel()))
        return real(t, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", cpu_spy)
    rc, out, _ = _cli(["telofind", str(synth / "asm.fasta")])
    assert rc == 0 and out == (gold / "telofind.txt").read_text()
    shortest = min(len(r.seq) for r in read_fastx(str(synth / "asm.fasta")))
    assert len(seen) == 8                        # 4 contigs x 2 strands
    assert all(dt == torch.int64 for dt, _ in seen)
    assert 0 < sum(n for _, n in seen) < shortest


@pytest.mark.parametrize("backend", ["device", "host"])
def test_telofind_run_reports_stats(cpu, synth, gold, backend):
    """tools.telofind.run(stats=...) adds the counts and the seconds per
    part; the output is the golden's."""
    from cornetto_tpu_torch.tools import telofind as ttf
    out, stats = io.StringIO(), {}
    ttf.run(str(synth / "asm.fasta"), out=out, backend=backend, stats=stats)
    assert out.getvalue() == (gold / "telofind.txt").read_text()
    assert stats["contigs"] == 4 and stats["bases"] > 0
    parts = ["read", "encode", "walk", "output"]
    if backend == "device":
        parts += ["h2d", "kernel", "compact", "readback"]
        assert stats["positions"] >= out.getvalue().count("\n")
    assert all(stats[k] >= 0 for k in parts)


def test_telofind_non_acgt_motif_scans_on_host(cpu, tmp_path):
    """A motif the mask kernel cannot express takes the host scan, as in
    the JAX package: the device backend's rows equal the host's."""
    fa = tmp_path / "n.fa"
    fa.write_text(">c\nACGTTTNGGGTTNGGGAATTNGGG\n>d\nNNNN\n")
    outs = [_cli(["telofind", str(fa), "TTNGGG"] + b)[1]
            for b in (["--backend", "host"], [])]
    assert outs[0] == outs[1] and outs[0].count("\n") == 2


@pytest.mark.parametrize("motif", ["ttaggg", "TTAggg", "TTAGGG", "CCCTAA"])
def test_telofind_motif_case_matches_jax_cli(cpu, tmp_path, motif):
    """The sequence is uppercased and the motif is not: a lowercase letter
    in the motif matches nothing.  The port's default (device) and host
    backends give the JAX CLI's default output byte for byte."""
    from cornetto_tpu.tools import telofind as jtf
    fa = tmp_path / "t.fa"
    fa.write_text(">c1\nACGTAC" + "TTAGGG" * 3 + "GATC" + "ttaggg" * 4
                  + "CATG" + "TTAggg" * 2 + "ACGA" + "CCCTAA" * 2 + "TG"
                  + "ccctaa" * 3 + "GG" + "cccTAA" * 2 + "ACGTTT\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jtf.main(["telofind", str(fa), motif]) == 0
    want = buf.getvalue()
    assert (want != "") == (motif.upper() == motif)
    for backend in ([], ["--backend", "host"]):
        rc, out, err = _cli(["telofind", str(fa), motif] + backend)
        assert rc == 0, err
        assert out == want


@pytest.mark.parametrize("golden,args", [
    ("telowin.txt", ["99.9", "0.4"]),
    ("telowin2.txt", ["95", "0.3"])])
def test_telowin_golden(cpu, gold, golden, args):
    rc, out, err = _cli(["telowin", str(gold / "telomere.txt")] + args)
    assert rc == 0, err
    assert out == (gold / golden).read_text()


def test_telobreaks_golden(cpu, gold):
    rc, out, err = _cli(["telobreaks", str(gold / "lens.txt"),
                         str(gold / "sdust.txt"),
                         str(gold / "telomere.txt")])
    assert rc == 0, err
    assert out == (gold / "telobreaks.txt").read_text()


def test_chain_from_device_outputs(cpu, tmp_path, synth, gold):
    """sdust and telofind on the device backends, then telowin and
    telobreaks on their outputs, as the reference's annotation chain."""
    fasta = str(synth / "asm.fasta")
    _, sd, _ = _cli(["sdust", "--backend", "device", fasta])
    _, tf, _ = _cli(["telofind", fasta, "--backend", "device"])
    telomere = "".join("\t".join([r[0]] + r[1:]) + "\n" for r in
                       (line.split("\t") for line in tf.splitlines()))
    (tmp_path / "sdust.txt").write_text(sd)
    (tmp_path / "telomere.txt").write_text(telomere)
    assert telomere == (gold / "telomere.txt").read_text()
    _, win, _ = _cli(["telowin", str(tmp_path / "telomere.txt"), "99.9",
                      "0.4"])
    _, brk, _ = _cli(["telobreaks", str(gold / "lens.txt"),
                      str(tmp_path / "sdust.txt"),
                      str(tmp_path / "telomere.txt")])
    assert win == (gold / "telowin.txt").read_text()
    assert brk == (gold / "telobreaks.txt").read_text()


def test_usage_lists_annotation_commands(capsys):
    assert cli.main(["cornetto"]) == 1
    err = capsys.readouterr().err
    for cmd in ("sdust", "telofind", "telowin", "telobreaks"):
        assert cmd in err
    # telostats and minidot are ported: with no input each prints its usage
    rc, _, err = _cli(["telostats"])
    assert rc == 1 and "Usage: cornetto telostats" in err
    assert "not yet ported" not in err
    rc, _, err = _cli(["minidot"])
    assert rc == 1 and "Usage: minidot" in err
    assert "not yet ported" not in err


def test_annotation_imports_no_jax(tmp_path, synth, gold):
    """sdust and telofind on their device backends, and telobreaks, through
    the port's CLI leave jax and the JAX package out of sys.modules (a fresh
    interpreter: the test process itself has both loaded)."""
    code = (
        "import contextlib, io, sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "from cornetto_tpu_torch.tools import sdust\n"
        "sdust.CORE = 128\n"
        "fa, gold = sys.argv[1:]\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert main(['cornetto', 'sdust', '--backend', 'device',"
        " fa]) == 0\n"
        "    assert main(['cornetto', 'telofind', fa, '--backend',"
        " 'device']) == 0\n"
        "    assert main(['cornetto', 'telobreaks', gold + '/lens.txt',"
        " gold + '/sdust.txt', gold + '/telomere.txt']) == 0\n"
        "assert 'torch' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(synth / "asm.fasta"), str(gold)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
