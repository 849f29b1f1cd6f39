"""The port stands alone: no source file of ``cornetto_tpu_torch`` (nor
``chip_smoke.py``, nor the card tests of tests/test_torch_cuda_kernels.py,
which run where JAX is not installed) imports the JAX package, and the
port's CLI entry points not covered by the other no-jax tests leave both
``jax`` and ``cornetto_tpu`` out of ``sys.modules`` in a fresh interpreter.
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
    ["chip_smoke.py", "tests/test_torch_cuda_kernels.py"]


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
    their host backends, and --version, through the port's CLI in a fresh
    interpreter (the test process itself has both loaded)."""
    import numpy as np
    rng = np.random.default_rng(11)
    draft = tmp_path / "draft.fa"
    draft.write_text("".join(">ctg%d\n%s\n" % (i, "".join(
        np.array(list("ACGT"))[rng.integers(0, 4, 20000)])) for i in range(3)))
    bed = tmp_path / "panel.bed"
    bed.write_text("ctg0\t0\t5000\n")
    code = (
        "import contextlib, io, sys\n"
        "from cornetto_tpu_torch.cli import main\n"
        "draft, bed, idx, synth, gold = sys.argv[1:]\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
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
         str(tmp_path / "idx"), str(synth), str(gold)], cwd=str(ROOT),
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "idx.npz").exists()
