"""The port's host subcommands (cornetto_tpu_torch.cli) against the JAX CLI
(cornetto_tpu.cli) on the same arguments and against test_data/golden:
fa2bed, seq, nx, report, telocontigs, asmstats, asmstats-pipeline, fixasm,
bigenough, recreate-panel, telostats (the plain telomere mask under
CORNETTO_FORCE_CPU=1), depth and bammerge.  Each case runs both CLIs
in-process, each in a directory of its own holding links to the inputs,
and compares the exit code, stdout, stderr (with the footer's times
masked) and every file the run wrote, byte for byte: tolerance 0."""

import contextlib
import io
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from cornetto_tpu import cli as jax_cli
from cornetto_tpu_torch import cli

ROOT = pathlib.Path(__file__).resolve().parent.parent
DATA = ROOT / "test_data"
SYNTH = DATA / "synth"
GOLD = DATA / "golden"
PIPE_GOLD = GOLD / "pipelines"
EXAMPLE = DATA / "example.bam"
TIMES = re.compile(rb"Real time: [0-9.]+ sec; CPU time: [0-9.]+ sec; "
                   rb"Peak RAM: [0-9.]+ GB")
# example.bam's 50 reads lie on chr22 at 19,979,850-20,032,355
REGIONS = "chr22\t19979000\t20040000\nchr22\t0\t2000\nchr21\t500\t900\n"

sys.path.insert(0, str(DATA))
import gen_synth_pipe  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")


@pytest.fixture(scope="module")
def pipe_synth():
    return pathlib.Path(gen_synth_pipe.ensure())


def _files(d: pathlib.Path):
    """{relative path: bytes} of the regular files under d (the input
    links left out)."""
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*"))
            if p.is_file() and not p.is_symlink()}


def _run(main, argv, d: pathlib.Path, inputs):
    """main(["cornetto"] + argv) in d with the inputs linked there: the
    exit code, stdout (through a real file, as a shell gives it), stderr
    with the times masked, and the files written."""
    d.mkdir()
    for name, src in inputs.items():
        (d / name).symlink_to(src)
    out_path = d.parent / (d.name + ".stdout")
    err = io.StringIO()
    old = os.getcwd()
    os.chdir(d)
    try:
        with open(out_path, "w") as out, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            try:
                rc = main(["cornetto"] + argv)
            except SystemExit as e:
                rc = e.code
    finally:
        os.chdir(old)
    return (rc, out_path.read_bytes(), TIMES.sub(b"", err.getvalue().encode()),
            _files(d))


def _both(tmp_path, argv, inputs):
    """The port's run, after asserting it equals the JAX CLI's field by
    field."""
    port = _run(cli.main, argv, tmp_path / "port", inputs)
    ref = _run(jax_cli.main, argv, tmp_path / "jax", inputs)
    for field, a, b in zip(("rc", "stdout", "stderr", "files"), port, ref):
        same = a == b
        assert same, "%s differs from the JAX CLI's" % field
    return port


def _tool_stderr(err: bytes) -> bytes:
    """stderr before the CLI's footer."""
    return err[:err.rfind(b"[main] Version:")]


def _gold(name):
    return (GOLD / name).read_bytes()


@pytest.mark.parametrize("argv,stdout,stderr", [
    (["fa2bed", "asm.fasta"], "fa2bed.txt", None),
    (["seq", "reads.fastq"], "seq_30k.txt", "seq_30k.stderr"),
    (["seq", "-m", "1000", "reads.fastq"], "seq_1k.txt", "seq_1k.stderr"),
    (["seq", "--min-len=1000", "reads.fastq"], "seq_1k.txt",
     "seq_1k.stderr")])
def test_misc_tools(tmp_path, argv, stdout, stderr):
    rc, out, err, files = _both(tmp_path, argv, {
        "asm.fasta": SYNTH / "asm.fasta",
        "reads.fastq": SYNTH / "reads.fastq"})
    assert rc == 0 and out == _gold(stdout) and files == {}
    if stderr:
        assert _tool_stderr(err) == _gold(stderr)
    assert b"[main] CMD: %s" % " ".join(argv).encode() in err


ASMSTATS_IN = {"fixasm_fixed.paf": GOLD / "fixasm_fixed.paf",
               "telo_fixed.bed": GOLD / "telo_fixed.bed",
               "report_fixed.tsv": GOLD / "report_fixed.tsv",
               "order.fasta": GOLD / "order.fasta",
               "trim_in.paf": GOLD / "trim_in.paf",
               "telo.bed": GOLD / "telo.bed",
               "asm.fasta": SYNTH / "asm.fasta"}
ASMSTATS = ["asmstats", "fixasm_fixed.paf", "telo_fixed.bed",
            "-r", "report_fixed.tsv"]


@pytest.mark.parametrize("argv,stdout,rc", [
    (["nx", "asm.fasta"], "nx.txt", 0),
    (["nx", "-g", "200K", "asm.fasta"], "ngx.txt", 0),
    (["report", "asm.fasta", "asm.fasta"], "report.txt", 0),
    (["telocontigs", "asm.fasta", "telo.bed"], "telocontigs.txt", 0),
    (ASMSTATS, "asmstats.txt", 0),
    (ASMSTATS + ["-s", "human1"], "asmstats_human1.txt", 0),
    (ASMSTATS + ["-s", "human2"], "asmstats_human2.txt", 0),
    (ASMSTATS + ["-s", "order.fasta"], "asmstats_fastaorder.txt", 0),
    # the reference stops mid-report on this input (a chromosome trimmed to
    # length 0): the same partial output and a failing exit
    (["asmstats", "trim_in.paf", "telo.bed", "-r", "report_fixed.tsv",
      "--trim-pat-mat"], "asmstats_trim.txt", 1)])
def test_eval_tools(tmp_path, argv, stdout, rc):
    got_rc, out, _, files = _both(tmp_path, argv, ASMSTATS_IN)
    want = _gold(stdout)
    if stdout == "report.txt":
        # each row starts with the assembly's path as given, here local
        want = re.sub(rb"(?m)^[^#\t][^\t]*\t", b"asm.fasta\t", want)
    assert got_rc == rc and out == want and files == {}


def test_asmstats_pipeline(tmp_path):
    """asmstats on <prefix>.paf, <prefix>.windows.0.4.50kb.ends.bed and
    <prefix>.report.tsv: the golden, whose first line echoes the PAF's
    path."""
    rc, out, _, files = _both(tmp_path, ["asmstats-pipeline", "x"], {
        "x.paf": GOLD / "fixasm_fixed.paf",
        "x.windows.0.4.50kb.ends.bed": GOLD / "telo_fixed.bed",
        "x.report.tsv": GOLD / "report_fixed.tsv"})
    assert rc == 0 and files == {}
    assert out == _gold("asmstats.txt").replace(b"fixasm_fixed.paf",
                                                b"x.paf", 1)


@pytest.mark.parametrize("argv,stdout,stderr,written", [
    (["fixasm", "asm.fasta", "asm_to_ref.paf", "-m", "missing.txt",
      "-r", "report.tsv", "-w", "fixed.paf"], "fixasm_fixed.fasta",
     "fixasm.stderr", {"missing.txt": "fixasm_missing.txt",
                       "report.tsv": "fixasm_report.tsv",
                       "fixed.paf": "fixasm_fixed.paf"}),
    (["fixasm", "asm.fasta", "trim_in.paf", "-r", "r.tsv",
      "--trim-pat-mat"], "trim_fixed.fasta", None,
     {"r.tsv": "trim_report.tsv"})])
def test_dotplot_tools(tmp_path, argv, stdout, stderr, written):
    rc, out, err, files = _both(tmp_path, argv, {
        "asm.fasta": SYNTH / "asm.fasta",
        "asm_to_ref.paf": SYNTH / "asm_to_ref.paf",
        "trim_in.paf": GOLD / "trim_in.paf"})
    assert rc == 0 and out == _gold(stdout)
    if stderr:
        assert _tool_stderr(err) == _gold(stderr)
    assert files == {k: _gold(v) for k, v in written.items()}


@pytest.mark.parametrize("case", ["bigenough", "bigenough_dip",
                                  "recreate-panel", "telostats",
                                  "telostats_small"])
def test_panel_pipelines(tmp_path, pipe_synth, case):
    """bigenough on the reference's fixtures; recreate-panel's panel
    (pasm.boringbits.*; hapnetto is not ported) and every
    tmp_recreate_cornetto/ intermediate; telostats' stdout and ends BED on
    both pipeline goldens, its telofind on the plain mask."""
    fx = DATA / "bigenough"
    if case.startswith("bigenough"):
        dip = "_dip" if case.endswith("dip") else ""
        _, out, _, files = _both(tmp_path, [
            "bigenough", "-r", "out.csv", "chroms.bed",
            "in%s.boringbits.bed" % dip], {
                "chroms.bed": fx / "chroms.bed",
                "in%s.boringbits.bed" % dip:
                    fx / ("in%s.boringbits.bed" % dip)})
        assert out == (fx / ("out%s.boringbits.bed" % dip)).read_bytes()
        assert files == {"out.csv": (fx / ("out%s.boringbits.csv" % dip))
                         .read_bytes()}
    elif case == "recreate-panel":
        rc, _, _, files = _both(tmp_path, ["recreate-panel", "pasm.fasta"], {
            f: pipe_synth / f for f in ("pasm.fasta",
                                        "pasm.bp.p_ctg.lowQ.bed")})
        assert rc == 0
        for f in ("pasm.boringbits.bed", "pasm.boringbits.txt"):
            assert files[f] == (PIPE_GOLD / "recreate" / f).read_bytes()
        assert any(f.startswith("tmp_recreate_cornetto/") for f in files)
    else:
        sub, fa = (("telo", pipe_synth / "pasm.fasta") if case == "telostats"
                   else ("telosmall", SYNTH / "asm.fasta"))
        rc, out, _, files = _both(tmp_path, ["telostats", fa.name],
                                  {fa.name: fa})
        assert rc == 0
        assert out == (PIPE_GOLD / sub / "telostats.stdout").read_bytes()
        bed = fa.name.rsplit(".", 1)[0] + ".windows.0.4.50kb.ends.bed"
        assert files[bed] == (PIPE_GOLD / sub / bed).read_bytes()


def _depth_rows(out: bytes):
    return [(r.split(b"\t")[0], int(r.split(b"\t")[1]),
             int(r.split(b"\t")[-1])) for r in out.splitlines()]


@pytest.mark.parametrize("opts", [[], ["-Q", "60"], ["-Q", "61"], ["-g"],
                                  ["-J"], ["-Q", "60", "-g", "-J"],
                                  ["--bedgraph", "--include-dels"]])
def test_bam_depth(tmp_path, opts):
    """depth over three BED regions of example.bam (its references are
    GRCh38's, so never the whole genome): the reads' span, a region before
    them and one on another chromosome."""
    (tmp_path / "regions.bed").write_text(REGIONS)
    rc, out, _, files = _both(
        tmp_path, ["depth", "-b", "regions.bed"] + opts + ["example.bam"],
        {"regions.bed": tmp_path / "regions.bed", "example.bam": EXAMPLE,
         "example.bam.bai": EXAMPLE.with_suffix(".bam.bai")})
    assert rc == 0 and files == {}
    rows = _depth_rows(out)
    assert len(rows) == 61000 + 2000 + 400
    total = sum(v for _, _, v in rows)
    assert (total == 0) == (opts[:2] == ["-Q", "61"])


@pytest.mark.parametrize("no_index", [False, True])
def test_bam_merge(tmp_path, no_index):
    """bammerge of example.bam with itself: the BAM (and its .bai) equal
    the JAX package's, and its depth is twice the input's at every
    position of the regions."""
    argv = ["bammerge"] + (["--no-index"] if no_index else []) + \
        ["merged.bam", "example.bam", "example.bam"]
    inputs = {"example.bam": EXAMPLE,
              "example.bam.bai": EXAMPLE.with_suffix(".bam.bai")}
    rc, out, _, files = _both(tmp_path, argv, inputs)
    assert rc == 0 and out == b""
    assert sorted(files) == ["merged.bam"] + ([] if no_index
                                              else ["merged.bam.bai"])
    (tmp_path / "regions.bed").write_text(REGIONS)
    depth = {}
    for name, bam in (("in", EXAMPLE), ("merged", tmp_path / "port"
                                        / "merged.bam")):
        inputs = {"regions.bed": tmp_path / "regions.bed", "x.bam": bam}
        if name == "merged" and not no_index:
            inputs["x.bam.bai"] = bam.with_suffix(".bam.bai")
        elif name == "in":
            inputs["x.bam.bai"] = EXAMPLE.with_suffix(".bam.bai")
        rc, out, _, _ = _run(cli.main, ["depth", "-b", "regions.bed",
                                        "x.bam"], tmp_path / name, inputs)
        assert rc == 0
        depth[name] = np.array([v for _, _, v in _depth_rows(out)])
    assert depth["in"].sum() > 0
    assert np.array_equal(depth["merged"], 2 * depth["in"])


def test_cli_dispatch_and_usage(synth):
    """The 13 host subcommands dispatch, the usage lists them, and
    JAX_ONLY holds only what still waits; the footer of a fresh
    interpreter's run (tests/test_cli.py's fa2bed case)."""
    assert set(cli.JAX_ONLY) == {"minidot", "minidotplot", "hapnetto",
                                 "refine", "flow-eval", "flow-sv",
                                 "flow-simplex", "gfa2fa"}
    usage = io.StringIO()
    assert cli.print_usage(usage) == 0
    for cmd in ("telostats", "bigenough", "recreate-panel", "fa2bed", "seq",
                "telocontigs", "depth", "bammerge", "asmstats", "nx",
                "report", "fixasm", "asmstats-pipeline"):
        assert cmd not in cli.JAX_ONLY
        assert "       %s " % cmd in usage.getvalue()
    r = subprocess.run([sys.executable, "-m", "cornetto_tpu_torch.cli",
                        "fa2bed", str(synth / "asm.fasta")], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CORNETTO_FORCE_CPU="1"))
    assert r.returncode == 0
    assert r.stdout == (GOLD / "fa2bed.txt").read_text()
    assert "Real time:" in r.stderr and "Peak RAM:" in r.stderr
    assert "CMD: fa2bed" in r.stderr
