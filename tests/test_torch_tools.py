"""The port's host subcommands (cornetto_tpu_torch.cli) against the JAX CLI
(cornetto_tpu.cli) on the same arguments and against test_data/golden:
fa2bed, seq, nx, report, telocontigs, asmstats, asmstats-pipeline, fixasm,
minidot, minidotplot, gfa2fa, bigenough, recreate-panel, hapnetto (after
create-panel and recreate-panel), refine, telostats (the plain telomere
mask under CORNETTO_FORCE_CPU=1), depth and bammerge, and the flow-eval,
flow-sv and flow-simplex chains over fake executables.  Each case runs
both CLIs in-process, each in a directory of its own holding links to
the inputs, and compares the exit code, stdout, stderr (with the footer's
times masked) and every file the run wrote, byte for byte: tolerance 0.
saliva's functions, which have no subcommand, are held to the JAX
package's on tests/test_saliva.py's inputs."""

import contextlib
import io
import json
import os
import pathlib
import re
import stat
import subprocess
import sys
import uuid

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
                   rb"Peak RAM: [0-9.]+ GB|(?<=panel-stage )([a-z-]+): "
                   rb"[0-9.]+ s \(peak RSS so far [0-9.]+ GB\)")
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


def _run(main, argv, d: pathlib.Path, inputs, before=()):
    """main(["cornetto"] + argv) in d with the inputs linked there, after
    each command of ``before`` (which must exit 0) in the same directory:
    the exit code, stdout (through a real file, as a shell gives it),
    stderr with the times masked, and the files written."""
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
            for cmd in before:
                assert main(["cornetto"] + cmd) == 0, cmd
            try:
                rc = main(["cornetto"] + argv)
            except SystemExit as e:
                rc = e.code
    finally:
        os.chdir(old)
    return (rc, out_path.read_bytes(),
            TIMES.sub(rb"\1", err.getvalue().encode()), _files(d))


def _both(tmp_path, argv, inputs, before=()):
    """The port's run, after asserting it equals the JAX CLI's field by
    field."""
    port = _run(cli.main, argv, tmp_path / "port", inputs, before)
    ref = _run(jax_cli.main, argv, tmp_path / "jax", inputs, before)
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


@pytest.mark.parametrize("argv,gold", [
    (["minidot", "-f", "2", "fixasm_fixed.paf"], "minidot.eps"),
    (["minidot", "asm_to_ref.paf"], "minidot_raw.eps"),
    (["minidot", "-m", "50", "-i", "0.05", "-s", "500", "-w", "800", "-d",
      "asm_to_ref.paf"], "minidot_opts.eps"),
    (["minidot", "-f", "2", "--png", "dot.png", "fixasm_fixed.paf"],
     "minidot.eps")])
def test_minidot(tmp_path, argv, gold):
    """minidot on the three EPS goldens' inputs, and with the PNG raster
    (written with zlib at a fixed level: the same bytes as the JAX
    package's)."""
    rc, out, _, files = _both(tmp_path, argv, {
        "fixasm_fixed.paf": GOLD / "fixasm_fixed.paf",
        "asm_to_ref.paf": SYNTH / "asm_to_ref.paf"})
    assert rc == 0 and out == _gold(gold)
    if "--png" in argv:
        assert sorted(files) == ["dot.png"]
        assert files["dot.png"].startswith(b"\x89PNG\r\n\x1a\n")
    else:
        assert files == {}


@pytest.mark.parametrize("png", [False, True])
def test_minidotplot(tmp_path, png):
    """minidotplot with a given PAF: fixasm's fixed FASTA, PAF, report and
    missing list and minidot -f 2's EPS, each its golden; the PNG."""
    argv = ["minidotplot", "ref.fasta", "asm.fasta", "--paf",
            "asm_to_ref.paf"] + (["--png"] if png else [])
    rc, out, _, files = _both(tmp_path, argv, {
        "ref.fasta": SYNTH / "asm.fasta", "asm.fasta": SYNTH / "asm.fasta",
        "asm_to_ref.paf": SYNTH / "asm_to_ref.paf"})
    assert rc == 0 and out == b""
    want = {"asm.fixed.fasta": "fixasm_fixed.fasta",
            "asm.fixed.paf": "fixasm_fixed.paf",
            "asm.report.tsv": "fixasm_report.tsv",
            "asm.missing.txt": "fixasm_missing.txt", "asm.eps": "minidot.eps"}
    assert sorted(files) == sorted(list(want) + (["asm.png"] if png else []))
    for name, g in want.items():
        assert files[name] == _gold(g), name
    if png:
        assert files["asm.png"].startswith(b"\x89PNG\r\n\x1a\n")


def test_gfa2fa(tmp_path):
    """tests/test_simplex_flow.py::test_gfa2fa's graph: one record per S
    line with a sequence; the header, A and L lines skipped."""
    g = tmp_path / "g.gfa"
    g.write_text("H\tVN:Z:1.0\n"
                 "S\tptg000001l\tACGTACGT\tLN:i:8\n"
                 "A\tptg000001l\t0\t+\tread1\t0\t8\n"
                 "S\tptg000002l\tGGGG\n"
                 "S\tptg000003l\t*\tLN:i:5\n"
                 "L\tptg000001l\t+\tptg000002l\t+\t0M\n")
    rc, out, _, files = _both(tmp_path, ["gfa2fa", "g.gfa"], {"g.gfa": g})
    assert rc == 0 and files == {}
    assert out == b">ptg000001l\nACGTACGT\n>ptg000002l\nGGGG\n"


def _refine_inputs(d: pathlib.Path):
    """tests/test_livefish_stream.py::test_refine_pipeline's iterations."""
    rng = np.random.default_rng(3)
    acgt = np.array(list("ACGT"))
    chrA = "".join(acgt[rng.integers(0, 4, 30000)])
    chrB = "".join(acgt[rng.integers(0, 4, 25000)])
    chrC = "".join(acgt[rng.integers(0, 4, 20000)])
    d.mkdir()
    (d / "asm1.fasta").write_text(">cA\n%s\n>frag\n%s\n" % (chrA,
                                                            chrC[:5000]))
    (d / "t1.bed").write_text("cA\t0\t100\ncA\t29900\t30000\n")
    (d / "asm2.fasta").write_text(">cA2\n%s\n>cB\n%s\n>cC\n%s\n>fragA\n%s\n"
                                  % (chrA, chrB, chrC, chrA[:8000]))
    (d / "t2.bed").write_text("cA2\t0\t100\ncA2\t29900\t30000\ncB\t0\t100\n"
                              "cB\t24900\t25000\n")
    return {f: d / f for f in ("asm1.fasta", "t1.bed", "asm2.fasta",
                               "t2.bed")}


def test_refine(tmp_path):
    """refine through the CLI (MIN_CONTIG_LEN 40 Mbp: no T2T contig, every
    contig of the last iteration appended), and run() at 10 kb with the
    JAX test's labels: T2T seeding, the newfound T2T, the contained
    duplicate and fragment dropped."""
    inputs = _refine_inputs(tmp_path / "in")
    argv = ["refine", "curated", "asm1.fasta", "t1.bed", "asm2.fasta",
            "t2.bed"]
    rc, out, _, files = _both(tmp_path, argv, inputs)
    assert rc == 0
    assert out == (b"Doing A_1\n    A_1 has no T2T\nDoing A_2\n    A_2 has "
                   b"no T2T\n    Last one. Appending none T2T contigs to "
                   b"the base asm\n")
    assert sorted(files) == ["curated.fasta", "curated.nont2t.fasta",
                             "curated.t2t.fasta"]
    from cornetto_tpu.pipelines import refine as jax_refine
    from cornetto_tpu_torch.pipelines import refine
    got = {}
    for name, mod in (("port", refine), ("jax", jax_refine)):
        buf = io.StringIO()
        final = mod.run([(str(inputs["asm1.fasta"]), str(inputs["t1.bed"])),
                         (str(inputs["asm2.fasta"]), str(inputs["t2.bed"]))],
                        str(tmp_path / name), min_contig_len=10000,
                        labels=["A_1", "A_2"], out=buf)
        assert final == str(tmp_path / name) + ".fasta"
        got[name] = [buf.getvalue()] + [
            pathlib.Path(str(tmp_path / name) + suf).read_bytes()
            for suf in (".fasta", ".t2t.fasta", ".nont2t.fasta")]
    assert got["port"] == got["jax"]
    names = [ln[1:] for ln in got["port"][1].decode().splitlines()
             if ln.startswith(">")]
    assert names == ["A_1_t2t_cA", "A_2_t2t_cB", "A_2_nont2t_cC"]


def test_saliva(tmp_path):
    """tests/test_saliva.py's chain through both packages' functions: the
    same returns and the same written records."""
    from cornetto_tpu.pipelines import saliva as jax_saliva
    from cornetto_tpu_torch.pipelines import saliva
    fq = tmp_path / "reads.fastq"
    fq.write_text("@r1\nACGT\n+\nIIII\n@r2\nGGGG\n+\nIIII\n"
                  "@r3\nTTTT\n+\nIIII\n")
    cls = tmp_path / "cls.tsv"
    cls.write_text("readID\tseqID\ttaxID\nr1\tseq\t9606\n"
                   "r2\tseq\t1280\nr3\tseq\t9606\n")
    rep = tmp_path / "report.tsv"
    rep.write_text("name\ttaxID\ttaxRank\tgenomeSize\tnumReads\n"
                   "Homo sapiens\t9606\tspecies\t3e9\t5000\n"
                   "Staph\t1280\tspecies\t2e6\t150\n"
                   "Rare\t999\tspecies\t1e6\t3\n")
    asm = tmp_path / "asm.fasta"
    asm.write_text(">c1\nAAAA\n>c2\nCCCCCC\n")
    ccls = tmp_path / "ccls.tsv"
    ccls.write_text("readID\tseqID\ttaxID\nc1\tx\t1280\nc2\tx\t9606\n")
    got = {}
    for name, mod in (("port", saliva), ("jax", jax_saliva)):
        out, fa, bed = io.StringIO(), io.StringIO(), io.StringIO()
        ids = mod.nonhuman_read_ids(str(cls))
        kept = mod.extract_human_reads(str(fq), str(cls), out=out)
        species = mod.high_count_nonhuman_species(str(rep))
        names = mod.extract_nonhuman_contigs(str(asm), str(ccls), species,
                                             fasta_out=fa, bed_out=bed)
        got[name] = (ids, kept, out.getvalue(), species, names,
                     fa.getvalue(), bed.getvalue())
    assert got["port"] == got["jax"]
    ids, kept, reads, species, names, fa, bed = got["port"]
    assert ids == {"r2"} and kept == (2, 1) and "@r2" not in reads
    assert species == {"1280"} and names == ["c1_nonhuman"]
    assert bed == "c1_nonhuman\t0\t4\n" and fa == ">c1_nonhuman\nAAAA\n"


PIPE_INPUTS = ("pasm.fasta", "pasm.cov-total.bg", "pasm.cov-mq20.bg",
               "pasm.bp.p_ctg.lowQ.bed", "pasm_hap1_to_asm.paf",
               "pasm_hap2_to_asm.paf")


@pytest.mark.parametrize("case", ["bigenough", "bigenough_dip",
                                  "recreate-panel", "hapnetto_create",
                                  "hapnetto_recreate", "telostats",
                                  "telostats_small"])
def test_panel_pipelines(tmp_path, pipe_synth, case):
    """bigenough on the reference's fixtures; recreate-panel's panel
    (pasm.boringbits.*) and every tmp_recreate_cornetto/ intermediate;
    hapnetto with the given haplotype PAFs after create-panel and after
    recreate-panel: the whole tree, every golden of
    test_data/golden/pipelines/{create,recreate}/ (pasm_dip.* included);
    telostats' stdout and ends BED on both pipeline goldens, its telofind
    on the plain mask."""
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
    elif case.startswith("hapnetto"):
        flavour = case.split("_")[1]
        hap = ["--hap1-paf", "pasm_hap1_to_asm.paf", "--hap2-paf",
               "pasm_hap2_to_asm.paf"]
        first = [flavour + "-panel", "pasm.fasta"]
        rc, _, _, files = _both(
            tmp_path, ["hapnetto", "pasm"] + hap + (
                ["--recreate"] if flavour == "recreate" else []),
            {f: pipe_synth / f for f in PIPE_INPUTS}, before=[first])
        assert rc == 0
        gold = PIPE_GOLD / flavour
        want = sorted(p.name for p in gold.iterdir())
        assert len(want) == 4 and "pasm_dip.boringbits.bed" in want
        for f in want:
            assert files[f] == (gold / f).read_bytes(), f
        assert any(f.startswith("tmp_%s_hapnetto/" % flavour) for f in files)
    else:
        sub, fa = (("telo", pipe_synth / "pasm.fasta") if case == "telostats"
                   else ("telosmall", SYNTH / "asm.fasta"))
        rc, out, _, files = _both(tmp_path, ["telostats", fa.name],
                                  {fa.name: fa})
        assert rc == 0
        assert out == (PIPE_GOLD / sub / "telostats.stdout").read_bytes()
        bed = fa.name.rsplit(".", 1)[0] + ".windows.0.4.50kb.ends.bed"
        assert files[bed] == (PIPE_GOLD / sub / bed).read_bytes()


def _stub(bindir: pathlib.Path, name: str, body: str):
    """A fake executable that logs its argv and runs ``body`` (shell), as
    tests/test_evaljobs.py's."""
    path = bindir / name
    path.write_text("#!/bin/bash\necho \"%s $*\" >> %s/argv.log\n%s\n"
                    % (name, bindir, body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)


FLOW_STATE = re.compile(rb'"(at|secs)": [0-9.e+-]+')


def _flow_run(main, argv, d: pathlib.Path, inputs, stubs, monkeypatch,
              path0: str):
    """_run of a flow with its fake executables first on PATH (path0
    after them), in a bin directory beside d: the run's fields and the
    stubs' argv log, with d and the bin directory's paths masked and the
    flow state's times dropped.  ``{run}`` in argv and the stubs stands
    for d."""
    bindir = d.parent / (d.name + ".bin")
    bindir.mkdir()
    for name, body in stubs.items():
        _stub(bindir, name, body.replace("{run}", str(d)))
    monkeypatch.setenv("PATH", "%s%s%s" % (bindir, os.pathsep, path0))
    rc, out, err, files = _run(main, [a.replace("{run}", str(d))
                                      for a in argv], d, inputs)

    def mask(b: bytes) -> bytes:
        return FLOW_STATE.sub(rb'"\1"', b.replace(str(d).encode(), b"<run>")
                              .replace(str(bindir).encode(), b"<bin>"))
    log = bindir / "argv.log"
    return (rc, mask(out), mask(err), {k: mask(v) for k, v in files.items()},
            mask(log.read_bytes()) if log.exists() else b"")


def _flow_both(tmp_path, monkeypatch, argv, inputs, stubs):
    """The port's flow run, after asserting it equals the JAX CLI's field
    by field, the argv log included."""
    path0 = os.environ["PATH"]
    port = _flow_run(cli.main, argv, tmp_path / "port", inputs, stubs,
                     monkeypatch, path0)
    ref = _flow_run(jax_cli.main, argv, tmp_path / "jax", inputs, stubs,
                    monkeypatch, path0)
    for field, a, b in zip(("rc", "stdout", "stderr", "files", "argv log"),
                           port, ref):
        assert a == b, "%s differs from the JAX CLI's" % field
    return port


EVAL_STUBS = {
    # minimap2 emits the checked-in synthetic asm->ref PAF
    "minimap2": "for last; do :; done; cat %s" % (SYNTH / "asm_to_ref.paf"),
    "quast.py": 'mkdir -p "${4}" && touch "${4}/report.txt"',
    "compleasm": 'mkdir -p "${5}" && touch "${5}/summary.txt"',
    "yak": 'if [ "$1" = count ]; then touch "${7}"; else echo "QV 50"; fi'}


def test_flow_eval(tmp_path, monkeypatch):
    """flow-eval (tests/test_evaljobs.py::test_eval_flow_getstat_chain
    through the CLI): minidotplot, telostats and asmstats run natively,
    minimap2, quast, compleasm and yak are fakes; a second run resumes and
    runs nothing."""
    (tmp_path / "cfg.json").write_text(json.dumps(
        {"threads": 4, "lineage": "primates"}))
    argv = ["flow-eval", "{run}/wd", "{run}/ref.fasta", "{run}/asm.fasta",
            "--config", "cfg.json"]
    inputs = {"ref.fasta": SYNTH / "asm.fasta",
              "asm.fasta": SYNTH / "asm.fasta", "cfg.json":
              tmp_path / "cfg.json"}
    rc, _, err, files, log = _flow_both(tmp_path, monkeypatch, argv, inputs,
                                        EVAL_STUBS)
    assert rc == 0
    for out in ("asm.fixed.paf", "asm.report.tsv", "asm.eps",
                "asm.fasta.telostats.txt", "asm.fasta.asmstats.txt",
                "quast_out/report.txt", "compleasm_out/summary.txt",
                "asm.fasta.yak.txt", "asm.windows.0.4.50kb.ends.bed"):
        assert "wd/" + out in files, out
    assert files["wd/asm.eps"] == _gold("minidot.eps")
    assert files["wd/asm.fixed.paf"] == _gold("fixasm_fixed.paf")
    assert files["ref.fasta.yak"] == b""
    log = log.decode().splitlines()
    quast = next(x for x in log if x.startswith("quast.py"))
    assert "--large" in quast and "-l" in quast and "-t 4" in quast
    comp = next(x for x in log if x.startswith("compleasm"))
    assert comp.split()[1] == "run" and "-l primates" in comp
    assert any("count -K1.5g" in x for x in log if x.startswith("yak"))
    assert any(" qv " in x for x in log if x.startswith("yak"))
    # resume: a second run of the port's flow skips every step
    before = (tmp_path / "port.bin" / "argv.log").read_bytes()
    old = os.getcwd()
    os.chdir(tmp_path / "port")
    try:
        with contextlib.redirect_stderr(io.StringIO()) as e:
            assert cli.main(["cornetto"] + [a.replace(
                "{run}", str(tmp_path / "port")) for a in argv]) == 0
    finally:
        os.chdir(old)
    assert (tmp_path / "port.bin" / "argv.log").read_bytes() == before
    assert e.getvalue().count("(artifacts present)") == 7


def test_flow_sv(tmp_path, monkeypatch):
    """flow-sv (tests/test_evaljobs.py::test_sv_flow_chain through the
    CLI): the native >50 bp filter between fake dipcall, make, bcftools,
    bgzip, tabix and truvari."""
    for n in ("ref.fa", "pat.fa", "mat.fa"):
        (tmp_path / n).write_text(">x\nACGT\n")
    (tmp_path / "base.vcf.gz").write_text("x")
    vcf = ("##fileformat=VCFv4.2\n"
           "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
           "c1\t5\t.\t%s\tT\t.\t.\t.\n"
           "c1\t9\t.\tA\tT\t.\t.\t.\n" % ("A" * 60))
    stubs = {"run-dip": 'echo "all:"',
             "make": 'printf "" | gzip -n > "$PWD/dip.dip.vcf.gz"',
             "bcftools": 'cat <<"EOF"\n%sEOF' % vcf,
             "bgzip": 'gzip -n "$1"', "tabix": 'touch "$1.tbi"',
             "truvari": 'mkdir -p "${9}"'}
    inputs = {n: tmp_path / n for n in ("ref.fa", "pat.fa", "mat.fa",
                                        "base.vcf.gz")}
    rc, _, _, files, log = _flow_both(
        tmp_path, monkeypatch, ["flow-sv", "{run}/wd", "{run}/ref.fa",
                                "{run}/pat.fa", "{run}/mat.fa",
                                "{run}/base.vcf.gz"], inputs, stubs)
    assert rc == 0
    import gzip
    body = gzip.decompress(files["wd/structural_split.vcf.gz"]).decode()
    assert "A" * 60 in body and "\t9\t" not in body
    assert "wd/structural_split.vcf.gz.tbi" in files
    assert any(x.startswith("truvari bench -b")
               for x in log.decode().splitlines())


def _duplex_bam(path, records):
    from cornetto_tpu_torch.io.bam import BamWriter
    with BamWriter(str(path), ["ref"], [1000]) as w:
        for name, seq in records:
            w.write_record(name, 4, -1, -1, 0, [], seq=seq,
                           qual=[30] * len(seq))


@pytest.mark.parametrize("duplex", [False, True])
def test_flow_simplex(tmp_path, monkeypatch, duplex):
    """flow-simplex (tests/test_simplex_flow.py's chains through the CLI):
    fake slow5tools, basecaller and hifiasm around the native >= 30 kb
    read filter and gfa2fa; with --duplex, a basecall that fails once and
    is retried, then the native duplex / simplex read split of the BAMs
    (decode_read, iter_reads_fastq)."""
    (tmp_path / "s.blow5").write_text("fake blow5")
    if duplex:
        rng = np.random.default_rng(5)
        ids = [str(uuid.UUID(int=int(rng.integers(0, 2 ** 62))))
               for _ in range(3)]
        _duplex_bam(tmp_path / "payload.bam", [
            ("%s;%s" % (ids[0], ids[1]), "ACGT" * 3000),
            (ids[0], "ACGT" * 4000), (ids[2], "ACGT" * 4000)])
        stubs = {"slow5tools": 'if [ "$1" = split ]; then mkdir -p "${4}"; '
                               'touch "${4}/g0.blow5" "${4}/g1.blow5"; fi',
                 "slow5-dorado": 'if [ "$1" = duplex ]; then\n'
                                 '  if [ ! -e {run}.bin/failed_once ]; then '
                                 'touch {run}.bin/failed_once; exit 1; fi\n'
                                 '  cat %s\nfi' % (tmp_path / "payload.bam")}
        cfg = {"basecall_attempts": 3}
    else:
        fq = "".join("@r%d\n%s\n+\n%s\n" % (i, "ACGT" * (n // 4), "I" * n)
                     for i, n in enumerate([40000, 30000, 10000]))
        gfa = "S\tptg1\t%s\n" % ("ACGT" * 10)
        stubs = {"slow5tools": "true",
                 "slow5-dorado": 'if [ "$1" = basecaller ]; then cat <<"EOF"'
                                 '\n%sEOF\nfi' % fq,
                 "hifiasm": 'for last; do :; done; d=$(dirname "${last}"); '
                            'b=$(basename "${last}" .fastq); '
                            'printf "%s" > "$d/$b.bp.p_ctg.gfa"; '
                            'printf "%s" > "$d/$b.bp.hap1.p_ctg.gfa"; '
                            'printf "%s" > "$d/$b.bp.hap2.p_ctg.gfa"'
                            % (gfa, gfa, gfa)}
        cfg = {"threads": 4, "model": "/models/sup"}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    argv = ["flow-simplex", "{run}/wd", "s", "{run}/s.blow5", "--config",
            "cfg.json"] + (["--duplex"] if duplex else [])
    rc, _, err, files, log = _flow_both(
        tmp_path, monkeypatch, argv, {"s.blow5": tmp_path / "s.blow5",
                                      "cfg.json": tmp_path / "cfg.json"},
        stubs)
    assert rc == 0
    if duplex:
        assert files["wd/s.duplex_split.stats"] == (
            b"duplex\t2\nparents_dropped\t2\nshort_dropped\t0\n"
            b"simplex\t2\n")
        assert b"attempt 1/3 failed" in err
        dup = files["wd/s.duplex_reads.fastq"].decode().splitlines()
        assert dup[0] == "@%s;%s" % (ids[0], ids[1])
    else:
        names = [ln for ln in files["wd/s.fastq"].decode().splitlines()
                 if ln.startswith("@")]
        assert names == ["@r0", "@r1"]
        for out in ("s.fasta", "s.hap1.fasta", "s.hap2.fasta"):
            assert files["wd/" + out] == (">ptg1\n%s\n"
                                          % ("ACGT" * 10)).encode()
        assert b"--emit-fastq --min-qscore 10" in log
        assert b"--ont" in log and b"--telo-m CCCTAA" in log


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
    """The usage lists every subcommand the JAX CLI's usage lists, and the
    pipelines it dispatches beside them; the footer of a fresh
    interpreter's run (tests/test_cli.py's fa2bed case)."""
    assert not hasattr(cli, "JAX_ONLY")
    usage, jax_usage = io.StringIO(), io.StringIO()
    assert cli.print_usage(usage) == 0
    jax_cli.print_usage(jax_usage)
    cmds = [ln.split()[0] for ln in jax_usage.getvalue().splitlines()
            if ln.startswith("       ") and not ln.split()[0].startswith("-")]
    assert len(cmds) == 25
    for cmd in cmds + ["boringbits", "minidotplot", "hapnetto", "refine",
                       "asmstats-pipeline"]:
        assert "       %s " % cmd in usage.getvalue(), cmd
    r = subprocess.run([sys.executable, "-m", "cornetto_tpu_torch.cli",
                        "fa2bed", str(synth / "asm.fasta")], cwd=str(ROOT),
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, CORNETTO_FORCE_CPU="1"))
    assert r.returncode == 0
    assert r.stdout == (GOLD / "fa2bed.txt").read_text()
    assert "Real time:" in r.stderr and "Peak RAM:" in r.stderr
    assert "CMD: fa2bed" in r.stderr
