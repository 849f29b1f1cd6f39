"""The port stands alone: no source file of ``cornetto_tpu_torch`` (nor
``chip_smoke.py``, nor the gloo ranks of tests/test_torch_dist.py,
tests/_torch_dist_worker.py, nor the crash-injected stream's ranks and
their test, tests/_torch_ckpt_worker.py and
tests/test_torch_checkpoint_failure.py, nor the
card tests of tests/test_torch_cuda_kernels.py and their cases in
tests/_decide_cases.py and tests/_torch_ragged_cases.py, which run where
JAX is not installed, nor the
native sanitizer lane, tests/test_torch_sanitize.py) imports the JAX
package, and the port's CLI entry points not covered by the other no-jax
tests, and the library names of tests/test_torch_library_surface.py, leave
both ``jax`` and ``cornetto_tpu`` out of ``sys.modules`` in a fresh
interpreter.
The two packages share only the ``.npz`` index format
(tests/test_torch_host_copies.py)."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCES = sorted(str(p.relative_to(ROOT)) for p in
                 (ROOT / "cornetto_tpu_torch").rglob("*.py")) + \
    ["chip_smoke.py",
     "tests/_decide_cases.py",
     "tests/_torch_ckpt_worker.py",
     "tests/_torch_ragged_cases.py",
     "tests/_torch_dist_worker.py",
     "tests/test_torch_checkpoint_failure.py",
     "tests/test_torch_cuda_kernels.py",
     "tests/test_torch_sanitize.py"]


def _jax_package(name: str) -> bool:
    return name == "cornetto_tpu" or name.startswith("cornetto_tpu.")


def _imported_modules(tree):
    """Every module an import statement, importlib.import_module or
    __import__ with a literal name reaches."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno
            for alias in node.names:
                yield "%s.%s" % (node.module, alias.name), node.lineno
        elif isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value, node.lineno


def test_sources_listed():
    assert len(SOURCES) > 40
    assert "cornetto_tpu_torch/cli.py" in SOURCES
    assert "tests/test_torch_cuda_kernels.py" in SOURCES
    assert "cornetto_tpu_torch/kernels/decide.py" in SOURCES
    assert "tests/_decide_cases.py" in SOURCES
    for path in ("dist/mesh.py", "dist/multihost.py", "dist/scan.py",
                 "dist/collectives.py", "kernels/votes.py",
                 "utils/profiling.py"):
        assert "cornetto_tpu_torch/" + path in SOURCES
    assert "tests/_torch_dist_worker.py" in SOURCES
    for path in ("tools/fa2bed.py", "tools/seq.py", "tools/telocontigs.py",
                 "tools/depth.py", "tools/asmstats.py", "tools/nx.py",
                 "tools/report.py", "tools/fixasm.py",
                 "pipelines/asmstats_sh.py", "pipelines/recreate_cornetto.py",
                 "pipelines/telostats.py", "tools/bigenough.py",
                 "utils/natsort.py", "io/paf.py", "io/bam.py"):
        assert "cornetto_tpu_torch/" + path in SOURCES
    for path in ("utils/cformat.py", "io/eps.py", "tools/minidot.py",
                 "io/raster.py", "pipelines/minidotplot.py", "io/gfa.py",
                 "pipelines/hapnetto.py", "pipelines/refine.py",
                 "flow/evaljobs.py", "flow/simplex.py", "pipelines/saliva.py",
                 "dist/checkpoint.py"):
        assert "cornetto_tpu_torch/" + path in SOURCES
    assert "tests/_torch_ckpt_worker.py" in SOURCES
    assert "tests/test_torch_checkpoint_failure.py" in SOURCES
    assert "tests/test_torch_sanitize.py" in SOURCES
    assert "tests/_torch_ragged_cases.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES)
def test_source_does_not_import_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [(name, line) for name, line in _imported_modules(tree)
           if _jax_package(name) or name == "jax" or name.startswith("jax.")]
    assert not bad, "%s imports %s" % (path, bad)


def test_guard_catches_an_import_of_the_jax_package():
    for src in ("import cornetto_tpu", "import cornetto_tpu.io.bed as b",
                "from cornetto_tpu.native import sdust",
                "from cornetto_tpu import native",
                "def f():\n    from cornetto_tpu.utils import logging",
                "importlib.import_module('cornetto_tpu.tools.sdust')"):
        names = [n for n, _ in _imported_modules(ast.parse(src))]
        assert any(_jax_package(n) for n in names), src
    names = [n for n, _ in _imported_modules(ast.parse(
        "import cornetto_tpu_torch\nfrom cornetto_tpu_torch.io import bed"))]
    assert not any(_jax_package(n) for n in names)


def test_native_sources_are_the_ports_own():
    """The port compiles its own copies of the C sources into build/native/
    at the root of the checkout, not into the package directory."""
    from cornetto_tpu_torch import native
    for name in ("fastq_pack", "tsv_format", "sdust_native", "depth_write",
                 "bedgraph_native", "minimizer_native"):
        assert (ROOT / "cornetto_tpu_torch" / "native"
                / (name + ".c")).exists()
    assert pathlib.Path(native.BUILD_DIR) == ROOT / "build" / "native"
    assert native.load("sdust_native", "sdust_native.c", cflags=("-O2",))
    assert (ROOT / "build" / "native" / "_sdust_native.so").exists()
    assert not list((ROOT / "cornetto_tpu_torch" / "native").glob("*.so"))


def test_cli_entry_points_import_neither_jax_nor_the_jax_package(tmp_path,
                                                                 synth, gold):
    """livefish index and toml, boringbits, telowin, sdust and telofind on
    their host backends, the host subcommands (telostats on the plain mask,
    bigenough, recreate-panel, fa2bed, seq, telocontigs, depth, bammerge,
    asmstats, nx, report, fixasm and asmstats-pipeline) and --version,
    through the port's CLI in a fresh interpreter (the test process itself
    has both loaded)."""
    import numpy as np
    rng = np.random.default_rng(11)
    draft = tmp_path / "draft.fa"
    draft.write_text("".join(">ctg%d\n%s\n" % (i, "".join(
        np.array(list("ACGT"))[rng.integers(0, 4, 20000)])) for i in range(3)))
    bed = tmp_path / "panel.bed"
    bed.write_text("ctg0\t0\t5000\n")
    (tmp_path / "draft.bp.p_ctg.lowQ.bed").write_text("ctg1\t100\t9000\n")
    (tmp_path / "regions.bed").write_text("chr22\t19979000\t19990000\n")
    for suf, src in ((".paf", "fixasm_fixed.paf"),
                     (".windows.0.4.50kb.ends.bed", "telo_fixed.bed"),
                     (".report.tsv", "report_fixed.tsv")):
        (tmp_path / ("x" + suf)).symlink_to(gold / src)
    work = tmp_path / "work"
    work.mkdir()
    code = (
        "import contextlib, io, os, sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "draft, bed, idx, synth, gold = sys.argv[1:6]\n"
        "tmp, fixtures = sys.argv[6:]\n"
        "os.chdir(tmp + '/work')\n"
        "asm, bam = synth + '/asm.fasta', synth + '/../example.bam'\n"
        "asmstats = [gold + '/fixasm_fixed.paf', gold + '/telo_fixed.bed',"
        " '-r', gold + '/report_fixed.tsv']\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for argv in (['telostats', asm],"
        " ['bigenough', fixtures + '/chroms.bed',"
        " fixtures + '/in.boringbits.bed'],"
        " ['recreate-panel', draft], ['fa2bed', asm],"
        " ['seq', synth + '/reads.fastq'],"
        " ['telocontigs', asm, gold + '/telo.bed'],"
        " ['depth', '-b', tmp + '/regions.bed', bam],"
        " ['bammerge', tmp + '/m.bam', bam, bam],"
        " ['asmstats'] + asmstats, ['nx', asm], ['report', asm],"
        " ['fixasm', asm, synth + '/asm_to_ref.paf'],"
        " ['asmstats-pipeline', tmp + '/x']):\n"
        "        assert main(['cornetto'] + argv) == 0, argv\n"
        "    assert main(['cornetto', 'livefish', 'index', draft, '-o', idx,"
        " '-p', bed]) == 0\n"
        "    assert main(['cornetto', 'livefish', 'toml', 'ref.mmi',"
        " 'targets.csv']) == 0\n"
        "    assert main(['cornetto', 'boringbits', synth + '/cov-total.bg',"
        " '-q', synth + '/cov-mq20.bg']) == 0\n"
        "    assert main(['cornetto', 'telowin', gold + '/telomere.txt',"
        " '99.9', '0.4']) == 0\n"
        "    assert main(['cornetto', 'sdust', '--backend', 'host',"
        " synth + '/asm.fasta']) == 0\n"
        "    assert main(['cornetto', 'telofind', synth + '/asm.fasta',"
        " '--backend', 'host']) == 0\n"
        "    assert main(['cornetto', '--version']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(draft), str(bed),
         str(tmp_path / "idx"), str(synth), str(gold), str(tmp_path),
         str(ROOT / "test_data" / "bigenough")], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "idx.npz").exists()
    assert (tmp_path / "m.bam.bai").exists()
    assert (work / "draft.boringbits.bed").exists()
    assert (work / "asm.windows.0.4.50kb.ends.bed").exists()


def test_new_entry_points_import_neither_jax_nor_the_jax_package(
        tmp_path, synth, gold):
    """minidot (with --png), minidotplot with a given PAF, gfa2fa,
    hapnetto (after recreate-panel, with given PAFs), refine, and flow-eval,
    flow-sv and flow-simplex (both paths) with --config tool templates
    standing for the outside tools, through the port's CLI in a fresh
    interpreter; then saliva's functions and save_sharded / load_sharded.
    Neither jax nor cornetto_tpu ends up in sys.modules."""
    import json
    import numpy as np
    rng = np.random.default_rng(12)
    acgt = np.array(list("ACGT"))
    lens = {"ctg0": 30000, "ctg1": 20000}
    (tmp_path / "draft.fasta").write_text("".join(
        ">%s\n%s\n" % (n, "".join(acgt[rng.integers(0, 4, ln)]))
        for n, ln in lens.items()))
    (tmp_path / "draft.bp.p_ctg.lowQ.bed").write_text("ctg1\t100\t900\n")
    for hap in ("hap1", "hap2"):
        (tmp_path / ("%s.paf" % hap)).write_text(
            "h\t5000\t0\t4000\t+\tctg0\t30000\t1000\t5000\t3990\t4000"
            "\t60\n")
    # yak count writes <ref>.yak beside the ref: a link here
    (tmp_path / "ref.fasta").symlink_to(synth / "asm.fasta")
    (tmp_path / "g.gfa").write_text("S\tp1\tACGT\n")
    (tmp_path / "t.bed").write_text("ctg0\t0\t9\nctg0\t29990\t30000\n")
    (tmp_path / "s.blow5").write_text("x")
    (tmp_path / "reads.fq").write_text("@r\nACGT\n+\nIIII\n")
    (tmp_path / "cls.tsv").write_text("readID\tseqID\ttaxID\nr\ts\t9606\n")
    paf = str(synth / "asm_to_ref.paf")
    cfgs = {
        "eval": {"threads": 2, "tools": {
            "minimap2_asm": "cat %s > {out}" % paf,
            "quast": "mkdir -p {out_dir}", "compleasm": "mkdir -p {out_dir}",
            "yak_count": "touch {out}", "yak_qv": "echo QV > {out}"}},
        "sv": {"tools": {
            "dipcall": "echo all: > {mak}",
            "make_dip": "printf '' | gzip > dip.dip.vcf.gz",
            "bcftools_norm": "printf '#h\\n' > {out}",
            "bgzip": "gzip {path}", "tabix": "touch {path}.tbi"}},
        "simplex": {"tools": {
            "slow5_stats": "true",
            "basecall": "printf '@r\\n%s\\n+\\n%s\\n' > {out}"
                        % ("A" * 40, "I" * 40),
            "hifiasm": "for s in p_ctg hap1.p_ctg hap2.p_ctg; do "
                       "printf 'S\\tp\\tACGT\\n' > {asm}.bp.$s.gfa; done"},
            "min_read_len": 10},
        "duplex": {"channel_groups": 1, "tools": {
            "slow5_split": "mkdir -p {out_dir} && touch {out_dir}/g0.blow5",
            "basecall_duplex": "cp %s {out}"
                               % (tmp_path.parent / "x.bam")}}}
    from cornetto_tpu_torch.io.bam import BamWriter
    with BamWriter(str(tmp_path.parent / "x.bam"), ["ref"], [100]) as w:
        w.write_record("q", 4, -1, -1, 0, [], seq="ACGT" * 3000,
                       qual=[30] * 12000)
    for name, cfg in cfgs.items():
        (tmp_path / ("%s.json" % name)).write_text(json.dumps(cfg))
    code = (
        "import contextlib, io, os, sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "tmp, synth, gold = sys.argv[1:]\n"
        "os.chdir(tmp)\n"
        "asm = synth + '/asm.fasta'\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for argv in (['minidot', '--png', 'd.png',"
        " gold + '/fixasm_fixed.paf'],"
        " ['minidotplot', asm, asm, '--paf', synth + '/asm_to_ref.paf',"
        " '--png'], ['gfa2fa', 'g.gfa'],"
        " ['recreate-panel', 'draft.fasta'],"
        " ['hapnetto', 'draft', '--hap1-paf', 'hap1.paf', '--hap2-paf',"
        " 'hap2.paf', '--recreate'],"
        " ['refine', 'cur', 'draft.fasta', 't.bed'],"
        " ['flow-eval', tmp + '/ev', tmp + '/ref.fasta', asm, '--config',"
        " 'eval.json'],"
        " ['flow-sv', tmp + '/sv', asm, asm, asm, '--config', 'sv.json'],"
        " ['flow-simplex', tmp + '/sx', 's', tmp + '/s.blow5',"
        " '--config', 'simplex.json'],"
        " ['flow-simplex', tmp + '/dx', 's', tmp + '/s.blow5', '--duplex',"
        " '--config', 'duplex.json']):\n"
        "        assert main(['cornetto'] + argv) == 0, argv\n"
        "from cornetto_tpu_torch.pipelines import saliva\n"
        "assert saliva.extract_human_reads('reads.fq', 'cls.tsv',"
        " out=io.StringIO()) == (1, 0)\n"
        "import torch\n"
        "from cornetto_tpu_torch.dist.checkpoint import load_sharded,"
        " save_sharded\n"
        "t = {'a': torch.arange(5)}\n"
        "assert save_sharded(tmp + '/ck', t)\n"
        "assert torch.equal(load_sharded(tmp + '/ck')['a'], t['a'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), str(synth), str(gold)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for out in ("d.png", "asm.eps", "asm.png", "draft_dip.boringbits.bed",
                "cur.fasta", "ev/asm.fasta.asmstats.txt", "ref.fasta.yak",
                "sv/structural_split.vcf.gz", "sx/s.hap2.fasta",
                "dx/s.duplex_split.stats"):
        assert (tmp_path / out).exists(), out


# the library names the port adds beside its copies, and the package
# re-exports (tests/test_torch_library_surface.py holds each to JAX's)
LIBRARY_NAMES = {
    "cornetto_tpu_torch.io": [
        "FastxRecord", "read_fastx", "open_maybe_gzip", "read_bed3",
        "write_bed3", "read_bedgraph_pair", "PafRec", "parse_paf_line",
        "read_paf"],
    "cornetto_tpu_torch.intervals": [
        "IntervalSet", "bed_sort", "gnu_sort_bed", "merge", "subtract",
        "intersect_wa"],
    "cornetto_tpu_torch.utils": [
        "c_round", "c_div", "wrap_i32", "fmt_g", "fmt_float", "strnum_cmp",
        "strnum_key", "mixed_numcompare", "mixed_key", "parse_num_suffix"],
    "cornetto_tpu_torch.livefish.decide": ["decision_core"],
    "cornetto_tpu_torch.kernels.minimizer": ["pack_codes"],
    "cornetto_tpu_torch.kernels.motif": ["match_positions", "tandem_runs"],
    "cornetto_tpu_torch.kernels.sdust_chunked": ["sdust_chunked_oracle"],
    "cornetto_tpu_torch.io.bed": ["write_bed3", "read_bed_regions"],
    "cornetto_tpu_torch.io.readfish": ["write_targets_csv"],
    "cornetto_tpu_torch.utils.logging": ["debug"],
}


def test_library_names_import_neither_jax_nor_the_jax_package():
    """Each name of LIBRARY_NAMES imports in a fresh interpreter, and
    calling the new ones leaves jax and cornetto_tpu unloaded."""
    code = (
        "import importlib, io, json, sys\n"
        "names = json.loads(sys.argv[1])\n"
        "for mod, attrs in names.items():\n"
        "    m = importlib.import_module(mod)\n"
        "    for a in attrs:\n"
        "        assert hasattr(m, a), (mod, a)\n"
        "import numpy as np, torch\n"
        "from cornetto_tpu_torch.kernels import motif, sdust_chunked\n"
        "from cornetto_tpu_torch.intervals import IntervalSet\n"
        "from cornetto_tpu_torch.livefish.decide import decision_core\n"
        "seq = np.frombuffer(b'TTAGGGTTAGGGAC', dtype=np.uint8)\n"
        "assert motif.tandem_runs(motif.match_positions(seq, 'TTAGGG'), 6)"
        " == [(0, 12, 12)]\n"
        "assert sdust_chunked.sdust_chunked_oracle(b'A' * 300) == "
        "[(0, 300)]\n"
        "IntervalSet.from_arrays(['c'], [1], [2]).write(io.StringIO())\n"
        "btable = torch.zeros((1 << 4, 8), dtype=torch.int32)\n"
        "out = decision_core(btable, torch.zeros((2, 40), dtype=torch.uint8),"
        " torch.zeros((2, 3), dtype=torch.bool), k=15, w=10, min_hits=1,"
        " bin_size=1000, bucket_shift=28)\n"
        "assert len(out) == 6\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'cornetto_tpu' or m.startswith('cornetto_tpu.'))\n"
        "assert not bad, bad\n")
    import json
    env = dict(os.environ, CORNETTO_FORCE_CPU="1", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code, json.dumps(LIBRARY_NAMES)],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
