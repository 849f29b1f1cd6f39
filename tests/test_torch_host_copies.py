"""The port's own copies of the JAX package's host layers against the
originals, on seeded inputs and on test_data: the index build and the
shared ``.npz`` index format (an index built by either package loads in
the other), the read packing, the FASTA / BED / bedgraph / BAM readers, the
SDUST chunk plan and reassembly, the native SDUST DP, the telomere walks,
the window statistics, the host tools and the read-until chunk engines'
state machines and replay (over a numpy stub engine), the natural sort,
the PAF readers, the FASTA record writer and the BAM writer with its BAI
and region depth, the C float formatters and the EPS writers, the EPS
rasterizer and PNG writer, the GFA segment reader, the BAM read decoder,
flow-sv's structural filter and refine's T2T and PAF-coverage rules.
Integers and bytes throughout; tolerance: exact equality."""

import io
import pathlib

import numpy as np
import pytest

from cornetto_tpu.dist import checkpoint as jax_ckpt
from cornetto_tpu.flow import evaljobs as jax_evaljobs
from cornetto_tpu.io import eps as jax_eps
from cornetto_tpu.io import gfa as jax_gfa
from cornetto_tpu.io import raster as jax_raster
from cornetto_tpu.io import bam as jax_bam
from cornetto_tpu.io import bed as jax_bed
from cornetto_tpu.io import fasta as jax_fasta
from cornetto_tpu.io import paf as jax_paf
from cornetto_tpu.kernels import minimizer as jax_mz
from cornetto_tpu.kernels import sdust_chunked as jax_chunked
from cornetto_tpu.kernels.pallas_telo import (_steps_for as jax_steps_for,
                                              scan_runs_from_mask as jax_walk)
from cornetto_tpu.kernels.sdust_core import _NT4 as JAX_NT4
from cornetto_tpu.kernels.window_sum import (n_windows as jax_n_windows,
                                             window_stats_numpy as jax_wsn)
from cornetto_tpu.livefish import chunks as jax_chunks
from cornetto_tpu.livefish import index as jax_index
from cornetto_tpu.livefish.decide import unpack_fused as jax_unpack_fused
from cornetto_tpu.native.sdust import sdust as jax_native_sdust
from cornetto_tpu.pipelines import refine as jax_refine
from cornetto_tpu.tools import telobreaks as jax_telobreaks
from cornetto_tpu.tools import telowin as jax_telowin
from cornetto_tpu.tools.telofind import scan_runs as jax_scan_runs
from cornetto_tpu.utils import cformat as jax_cformat
from cornetto_tpu.utils import natsort as jax_natsort
from cornetto_tpu_torch.dist import checkpoint as ckpt
from cornetto_tpu_torch.flow import evaljobs
from cornetto_tpu_torch.io import bam, bed, eps, fasta, gfa, paf, raster
from cornetto_tpu_torch.kernels import minimizer as mz
from cornetto_tpu_torch.kernels import sdust as sdust_kernels
from cornetto_tpu_torch.kernels import sdust_chunked as chunked
from cornetto_tpu_torch.kernels.sdust_core import _NT4
from cornetto_tpu_torch.kernels.telo import _steps_for, scan_runs_from_mask
from cornetto_tpu_torch.kernels.window_sum import n_windows, \
    window_stats_numpy
from cornetto_tpu_torch.livefish import chunks, index
from cornetto_tpu_torch.livefish.decide import unpack_fused
from cornetto_tpu_torch.native.sdust import sdust as native_sdust
from cornetto_tpu_torch.pipelines import refine
from cornetto_tpu_torch.tools import telobreaks, telowin
from cornetto_tpu_torch.tools.telofind import scan_runs
from cornetto_tpu_torch.utils import cformat, natsort

ROOT = pathlib.Path(__file__).resolve().parent.parent
ACGT = np.array(list("ACGT"))
INDEX_FIELDS = ("hashes", "contigs", "positions", "shard_counts",
                "contig_lens", "btable")


def _genome(seed, n_ctg=4, size=30_000):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_ctg):
        s = ACGT[rng.integers(0, 4, size)]
        s[rng.integers(0, size, 20)] = "N"            # interior Ns
        rep = ACGT[rng.integers(0, 4, 600)]
        s[1000:1600] = rep                            # an exact repeat
        s[9000:9600] = rep
        out["ctg%d" % i] = "".join(s)
    return out


def _assert_index_equal(a, b):
    for f in INDEX_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("contig_names", "k", "w", "bucket_shift", "bucket_slots",
              "two_choice", "n_shards"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("n_shards,keep,two", [(1, True, True),
                                               (2, False, True),
                                               (1, False, False)])
def test_build_index_arrays_equal(n_shards, keep, two):
    g = _genome(1)
    kw = dict(n_shards=n_shards, keep_tables=keep, two_choice=two)
    _assert_index_equal(index.build_index(g, **kw),
                        jax_index.build_index(g, **kw))


def test_build_panel_mask_equal():
    g = _genome(2)
    rows = [("ctg0", 0, 5000), ("ctg2", 7000, 29000)]
    a = index.build_panel_mask(index.build_index(g), rows)
    b = jax_index.build_panel_mask(jax_index.build_index(g), rows)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_index_loads_across_packages(tmp_path, writer):
    g = _genome(3)
    idx = index.build_index(g, keep_tables=writer == "port")
    panel = np.zeros((len(idx.contig_names), 128), dtype=bool)
    panel[1, 3:9] = True
    tallies = {"seen": np.arange(5, dtype=np.int64)}
    save, load = (ckpt.save_index, jax_ckpt.load_index) if writer == "port" \
        else (jax_ckpt.save_index, ckpt.load_index)
    path = str(tmp_path / "idx")
    save(path, idx, panel_mask=panel, tallies=tallies)
    got, got_panel, got_tallies = load(path)
    _assert_index_equal(got, idx)
    assert np.array_equal(got_panel, panel)
    assert np.array_equal(got_tallies["seen"], tallies["seen"])
    with np.load(path + ".npz", allow_pickle=True) as z:
        keys = sorted(z.files)
    other = str(tmp_path / "other")
    (jax_ckpt.save_index if writer == "port" else ckpt.save_index)(
        other, idx, panel_mask=panel, tallies=tallies)
    with np.load(other + ".npz", allow_pickle=True) as z:
        assert sorted(z.files) == keys


def test_pack_reads_encode_seq_and_minimizers_equal():
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 5, size=(37, 203)).astype(np.uint8)
    for x, y in zip(mz.pack_reads(codes), jax_mz.pack_reads(codes)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    seq = "".join(np.array(list("ACGTNacgtnRY"))[rng.integers(0, 12, 5000)])
    assert np.array_equal(mz.encode_seq(seq), jax_mz.encode_seq(seq))
    c = mz.encode_seq(seq)
    for fn in ("minimizers_np", "minimizers_native"):
        for x, y in zip(getattr(mz, fn)(c), getattr(jax_mz, fn)(c)):
            assert x.dtype == y.dtype and np.array_equal(x, y), fn


def test_fasta_reader_equal(synth, tmp_path):
    multi = tmp_path / "multi.fa.gz"
    import gzip
    with gzip.open(multi, "wt") as f:
        f.write(">a desc here\nACGT\nNNac\n>b\n\n>c x\nTTTT\n")
    for path in (synth / "asm.fasta", synth / "reads.fastq", multi):
        got = [(r.name, r.comment, r.seq) for r in fasta.read_fastx(str(path))]
        want = [(r.name, r.comment, r.seq)
                for r in jax_fasta.read_fastx(str(path))]
        assert got == want and got


def _wrap(seq: str, width: int, eol: str = "\n") -> str:
    return "".join(seq[i:i + width] + eol for i in range(0, len(seq), width))


_SEQ = "".join(np.random.default_rng(7).choice(list("ACGTNacgtn"), 1000))

# text, the reader's CHUNK, gzip, each record's squeezed
FASTA_BYTES_CASES = {
    "one-line": (">c1 x y\n%s\n>c2\nACGT\n" % _SEQ, 1 << 20, False,
                 [False, False]),
    "60-col": (">c1\n" + _wrap(_SEQ, 60) + ">c2 d\n" + _wrap(_SEQ[:50], 60),
               1 << 20, False, [True, False]),
    "80-col": (">c1\n" + _wrap(_SEQ, 80) + ">c2\n" + _wrap(_SEQ[:200], 80),
               1 << 20, False, [True, True]),
    "crlf": (">c1 d\r\n" + _wrap(_SEQ, 60, "\r\n") + ">c2\r\nACGT\r\n",
             1 << 20, False, [True, False]),
    "empty-record": (">a\nAC\n>\n>b\nGT\n", 1 << 20, False,
                     [False, False, False]),
    "header-no-body": (">a desc\n>b\tx\nACGT\n>c\n", 1 << 20, False,
                       [False, False, False]),
    "header-no-newline-at-eof": (">a\nACGT\n>b comment", 1 << 20, False,
                                 [False, False]),
    "gt-ends-the-file": (">a\nACGT\n>", 1 << 20, False, [True]),
    # the first read ends on the '\n' of '\n>', the next starts on the '>'
    "straddle": (">a\nACGTACG\n>b\nTT\n", 10, False, [False, False]),
    "longer-than-chunk": (">a\n%s\n>b\n%s" % (_SEQ, _wrap(_SEQ, 60)), 64,
                          False, [False, True]),
    "gzip": (">a desc\nACGT\nNNac\n>b\n\n>c x\n%s\n" % _SEQ, 64, True,
             [True, False, False]),
    "fastq": ("@r1 c\nACGT\n+\nIIII\n@r2\nGG\n+\nII\n", 1 << 20, False,
              [True, True]),
}


@pytest.mark.parametrize("case", sorted(FASTA_BYTES_CASES))
def test_fasta_bytes_reader_equal(tmp_path, monkeypatch, case):
    """read_fasta's records, decoded, are read_fastx's and the JAX
    package's, record for record; only a body with a line end inside it is
    squeezed (a second copy)."""
    import gzip
    text, chunk, gz, squeezed = FASTA_BYTES_CASES[case]
    path = tmp_path / ("x.fa.gz" if gz else "x.fa")
    path.write_bytes(gzip.compress(text.encode()) if gz else text.encode())
    monkeypatch.setattr(fasta, "CHUNK", chunk)
    want = [(r.name, r.comment, r.seq)
            for r in jax_fasta.read_fastx(str(path))]
    recs = list(fasta.read_fasta(str(path)))
    assert all(type(x) is bytes for r in recs for x in r[:3]
               if x is not None)
    assert [(r.name.decode(), None if r.comment is None
             else r.comment.decode(), r.seq.decode()) for r in recs] == want
    assert [(r.name, r.comment, r.seq)
            for r in fasta.read_fastx(str(path))] == want
    assert [r.squeezed for r in recs] == squeezed


def test_fasta_bytes_reader_equal_on_random_text(tmp_path, monkeypatch):
    """Seeded random texts of headers, bases, '>', '\\n', '\\r', spaces
    and tabs, read in reads of 1-64 bytes: read_fasta and read_fastx give
    the JAX package's records."""
    rng = np.random.default_rng(23)
    path = tmp_path / "r.fa"
    n = 0
    for _ in range(400):
        body = "".join(rng.choice(list(">>\n\n\n\rAcgN \t"),
                                  rng.integers(0, 40)))
        path.write_bytes((">" + body).encode())
        monkeypatch.setattr(fasta, "CHUNK", int(rng.choice([1, 2, 3, 7, 64])))
        want = [(r.name, r.comment, r.seq)
                for r in jax_fasta.read_fastx(str(path))]
        got = [(r.name.decode(), None if r.comment is None
                else r.comment.decode(), r.seq.decode())
               for r in fasta.read_fasta(str(path))]
        assert got == want, body
        assert [(r.name, r.comment, r.seq)
                for r in fasta.read_fastx(str(path))] == want, body
        n += len(want)
    assert n > 400


def test_bed_readers_equal(synth, tmp_path):
    p = synth / "asm.bp.p_ctg.lowQ.bed"
    assert list(bed.read_bed3(str(p))) == list(jax_bed.read_bed3(str(p)))
    ct, cm = str(synth / "cov-total.bg"), str(synth / "cov-mq20.bg")
    a = bed.read_bedgraph_pair(ct, cm)
    b = jax_bed.read_bedgraph_pair(ct, cm)
    assert a.names == b.names and (a.mean_depth, a.mean_mq_depth) == \
        (b.mean_depth, b.mean_mq_depth)
    for x, y in zip(a.depth + a.mq_depth, b.depth + b.mq_depth):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    scan = bed.scan_depth_track(ct)
    assert scan == jax_bed.scan_depth_track(ct)
    for (x, y) in zip(bed.iter_depth_contigs(ct, scan[1]),
                      jax_bed.iter_depth_contigs(ct, scan[1])):
        assert np.array_equal(x, y)
    # run-length rows (the aligner-free tracks)
    ranged = tmp_path / "r.bg"
    ranged.write_text("c1\t0\t1000\t5\nc1\t1000\t2500\t7\nc2\t0\t10\t1\n")
    a = bed.read_bedgraph_pair(str(ranged), str(ranged), ranged=True)
    b = jax_bed.read_bedgraph_pair(str(ranged), str(ranged), ranged=True)
    for x, y in zip(a.depth, b.depth):
        assert np.array_equal(x, y)


def test_bam_alignments_and_depth_equal():
    """The BAM reader and the depth tally of the flow's depth step (the
    example's references are GRCh38's, so only the covered ones are
    compared; the per-base bedgraph of the whole genome is ~60 GB)."""
    path = str(ROOT / "test_data" / "example.bam")
    a, b = bam.BamFile(path), jax_bam.BamFile(path)
    assert (a.ref_names, a.ref_lens) == (b.ref_names, b.ref_lens)
    fields = ("ref_id", "pos", "flag", "mapq", "cigar")
    got = [tuple(getattr(x, f) for f in fields) for x in a.alignments()]
    want = [tuple(getattr(x, f) for f in fields) for x in b.alignments()]
    assert got == want and len(got) == 50
    refs = sorted({x[0] for x in got if x[0] >= 0})
    for q in (0, 20):
        da, db = bam.depth_arrays(a, min_mapq=q), jax_bam.depth_arrays(b,
                                                                        q)
        for r in refs:
            assert da[r].dtype == db[r].dtype and \
                np.array_equal(da[r], db[r])
        assert sum(int(da[r].sum()) for r in refs)


def test_natsort_keys_equal():
    """strnum_key and mixed_key (asmstats' chromosome orders) on seeded
    names with digits, leading zeros and suffixes: the same order, and the
    same sign on every pair."""
    rng = np.random.default_rng(12)
    stems = ["chr", "ctg", "h1tig", "chrX_", "scaffold_", "", "A", "a"]
    names = ["%s%s%s" % (stems[rng.integers(0, len(stems))],
                         "0" * int(rng.integers(0, 3)),
                         int(rng.integers(0, 300)))
             + ["", "_MATERNAL", "_PATERNAL", "b", ".1"][rng.integers(0, 5)]
             for _ in range(300)]
    for key in ("strnum_key", "mixed_key"):
        assert sorted(names, key=getattr(natsort, key)) == \
            sorted(names, key=getattr(jax_natsort, key)), key
    for a, b in zip(names, names[::-1]):
        for cmp in ("strnum_cmp", "mixed_numcompare"):
            assert np.sign(getattr(natsort, cmp)(a, b)) == \
                np.sign(getattr(jax_natsort, cmp)(a, b)), (cmp, a, b)


@pytest.mark.parametrize("path", ["test_data/golden/fixasm_fixed.paf",
                                  "test_data/golden/trim_in.paf",
                                  "test_data/synth/asm_to_ref.paf"])
def test_paf_readers_equal(path):
    import dataclasses
    for fn in ("read_paf", "read_paf_minidot"):
        got = [dataclasses.astuple(r)
               for r in getattr(paf, fn)(str(ROOT / path))]
        want = [dataclasses.astuple(r)
                for r in getattr(jax_paf, fn)(str(ROOT / path))]
        assert got == want and got, fn


def test_write_fasta_record_equal():
    a, b = io.StringIO(), io.StringIO()
    for name, seq in (("ctg1", "ACGT" * 30), ("x y", ""), ("z", "N")):
        fasta.write_fasta_record(a, name, seq)
        jax_fasta.write_fasta_record(b, name, seq)
    assert a.getvalue() == b.getvalue()


def test_reg2bin_equal():
    rng = np.random.default_rng(13)
    beg = rng.integers(0, 1 << 29, 2000)
    span = 1 << rng.integers(0, 28, 2000)
    for x, n in zip(beg.tolist(), (span + rng.integers(1, 100, 2000)).tolist()):
        assert bam.reg2bin(x, x + n) == jax_bam.reg2bin(x, x + n)


def _write_bam(mod, path, rng_seed):
    rng = np.random.default_rng(rng_seed)
    with mod.BamWriter(str(path), ["c1", "c2"], [60_000, 30_000],
                       header_text="@HD\tVN:1.6\tSO:coordinate\n",
                       build_index=True) as w:
        for ref in (0, 1):
            for i, pos in enumerate(sorted(rng.integers(0, 25_000,
                                                        200).tolist())):
                m1, d, m2 = (int(v) for v in rng.integers(1, 300, 3))
                w.write_record("r%d_%d" % (ref, i), int(rng.choice([0, 16])),
                               ref, pos, int(rng.integers(0, 61)),
                               [("M", m1), ("D", d), ("M", m2)],
                               seq="".join(ACGT[rng.integers(0, 4, m1 + m2)]))


def test_bam_writer_roundtrip_and_depth_region_equal(tmp_path):
    """BamWriter (+ its BAI) writes the same bytes in both packages; each
    reader reads the other's file back; depth_region over the written BAM
    and example.bam agrees."""
    _write_bam(bam, tmp_path / "p.bam", 14)
    _write_bam(jax_bam, tmp_path / "j.bam", 14)
    for suf in ("", ".bai"):
        assert (tmp_path / ("p.bam" + suf)).read_bytes() == \
            (tmp_path / ("j.bam" + suf)).read_bytes()
    a, b = bam.BamFile(str(tmp_path / "j.bam")), \
        jax_bam.BamFile(str(tmp_path / "p.bam"))
    assert a.has_index() and b.has_index()
    fields = ("ref_id", "pos", "flag", "mapq", "cigar")
    assert [tuple(getattr(x, f) for f in fields) for x in a.alignments()] \
        == [tuple(getattr(x, f) for f in fields) for x in b.alignments()]
    ex = str(ROOT / "test_data" / "example.bam")
    cases = [(a, b, "c1", 0, 60_000), (a, b, "c2", 1000, 2500),
             (bam.BamFile(ex), jax_bam.BamFile(ex), "chr22", 19_979_000,
              20_040_000)]
    for x, y, ref, beg, end in cases:
        for q, dels in ((0, False), (30, False), (0, True)):
            got = bam.depth_region(x, ref, beg, end, min_mapq=q,
                                   include_dels=dels)
            want = jax_bam.depth_region(y, ref, beg, end, min_mapq=q,
                                        include_dels=dels)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            assert got.sum() > 0

def _sdust_inputs():
    rng = np.random.default_rng(6)
    seqs = []
    for n_len, gaps in ((9000, 0), (20_000, 6), (3000, 2)):
        s = ACGT[rng.integers(0, 4, n_len)]
        s[2000:2600] = np.tile(list("ATTCC"), 120)
        s[5000:5400] = "A"
        for _ in range(gaps):
            p = int(rng.integers(0, n_len - 200))
            s[p:p + int(rng.integers(1, 150))] = "N"
        seqs.append("".join(s).encode())
    return seqs


@pytest.mark.parametrize("core,W", [(512, 64), (128, 32), (2048, 64)])
def test_plan_chunks_and_assemble_equal(core, W):
    for seq in _sdust_inputs():
        codes = _NT4[np.frombuffer(seq, dtype=np.uint8)]
        assert np.array_equal(codes,
                              JAX_NT4[np.frombuffer(seq, dtype=np.uint8)])
        plan = chunked.plan_chunks(codes, core, W)
        assert plan == jax_chunked.plan_chunks(codes, core, W)
        device, host = plan
        per_chunk = [native_sdust(seq[c0:stop], W=W)
                     for _a, _b, c0, stop in device]
        parts = chunked.run_host_spans(seq, host, 20, W)
        assert parts == jax_chunked.run_host_spans(seq, host, 20, W)
        got = chunked.assemble(per_chunk, device, parts, W)
        assert got == jax_chunked.assemble(per_chunk, device, parts, W)
        assert got == native_sdust(seq, W=W)


def _assert_plan_exact(codes, core, W):
    """plan_chunks equals the JAX package's, and plan_rows' rows are
    sdust_pallas' rows (tests/test_torch_sdust.py::
    test_plan_rows_are_the_pallas_rows)."""
    plan = chunked.plan_chunks(codes, core, W)
    assert plan == jax_chunked.plan_chunks(codes, core, W)
    chunks, host, padded, off, clen = sdust_kernels.plan_rows(codes, W, core)
    assert (chunks, host) == plan
    if not chunks:
        assert padded is None and off is None
        return plan
    assert off.tolist() == [c[0] for c in chunks]
    for (a, _b, c0, stop), o in zip(chunks, off):
        row = np.full(clen, 4, dtype=np.uint8)
        pad_left = 4 * W - (a - c0)
        row[pad_left:pad_left + stop - c0] = codes[c0:stop]
        assert np.array_equal(padded[o:o + clen], row)
    return plan


def _n_layout(name, core, W):
    """(length, N runs as (start, length or None: to the end)) of one N
    layout around the plan's edges; a = 3 core is a core start."""
    a, w2, L = 3 * core, 2 * W, 8 * core + 37
    return {
        "n_at_0": (L, [(0, 1)]),
        "n_at_a_minus_1": (L, [(a - 1, 1)]),
        "n_at_a_minus_2w": (L, [(a - w2, 1)]),
        "n_at_a_minus_2w_minus_1": (L, [(a - w2 - 1, 1)]),
        "free_2w_minus_1": (L, [(a - 1 - k * w2, 1) for k in range(4)]),
        "free_2w": (L, [(a - 1 - k * (w2 + 1), 1) for k in range(4)]),
        "run_over_cores": (L, [(core + 5, 4 * core + 12)]),
        "run_ends_seq": (L, [(L - 3 * core - 7, None)]),
        "all_n": (L, [(0, None)]),
        "empty": (0, []),
        "shorter_than_core": (core - 5, [(core // 2, 1)]),
        "ineligible_one_core_apart": (L, [(2 * core - 1, 1),
                                          (4 * core - 1, 1)]),
        "coalescing_cores": (L, [(2 * core - 1, 1), (3 * core - 1, 1),
                                 (4 * core - w2, 3), (4 * core - 3 * W, 1)]),
    }[name]


@pytest.mark.parametrize("core,W", [(128, 32), (512, 64), (132, 66)])
@pytest.mark.parametrize("name", [
    "n_at_0", "n_at_a_minus_1", "n_at_a_minus_2w", "n_at_a_minus_2w_minus_1",
    "free_2w_minus_1", "free_2w", "run_over_cores", "run_ends_seq", "all_n",
    "empty", "shorter_than_core", "ineligible_one_core_apart",
    "coalescing_cores"])
def test_plan_chunks_n_layouts_equal(name, core, W):
    L, runs = _n_layout(name, core, W)
    codes = np.random.default_rng([23, core, W]).integers(
        0, 4, L).astype(np.uint8)
    for s, n in runs:
        codes[s:None if n is None else s + n] = 4
    device, host = _assert_plan_exact(codes, core, W)
    a = 3 * core
    eligible = {c[0] for c in device}
    if name in ("n_at_a_minus_1", "n_at_a_minus_2w", "free_2w_minus_1",
                "free_2w"):
        assert a not in eligible
    elif name == "n_at_a_minus_2w_minus_1":
        assert a in eligible
    elif name == "ineligible_one_core_apart":
        assert [h[1:] for h in host] == [(2 * core, a),
                                         (4 * core, 5 * core)]
    elif name == "coalescing_cores":
        assert len(host) == 1 and host[0][1:] == (2 * core, 5 * core)
    elif name == "all_n":       # the first core has no context to test
        assert [c[0] for c in device] == [0] and host == [(0, core, L)]
    elif name == "empty":
        assert (device, host) == ([], [])


@pytest.mark.parametrize("core,W", [(128, 3), (128, 32), (512, 64),
                                    (2048, 64), (2048, 66)])
def test_plan_chunks_fuzz_equal(monkeypatch, core, W):
    """Random N runs, from single N's to runs of several cores: the plan is
    exact, and sdust_device on it (the plain DP) is the sequential DP."""
    import torch
    assert np.array_equal(chunked.encode(bytes(range(256))), JAX_NT4)
    monkeypatch.setenv("CORNETTO_FORCE_CPU", "1")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = np.random.default_rng([24, core, W])
    try:
        for _ in range(4):
            L = int(rng.integers(3 * core, 9 * core))
            s = ACGT[rng.integers(0, 4, L)]
            for _ in range(int(rng.integers(1, 8))):
                p = int(rng.integers(0, L))
                s[p:p + int(rng.integers(1, 3 * core))] = "N"
            seq = "".join(s).encode()
            codes = _NT4[np.frombuffer(seq, dtype=np.uint8)]
            _assert_plan_exact(codes, core, W)
            assert sdust_kernels.sdust_device(seq, W=W, core=core) \
                == native_sdust(seq, W=W)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("T,W", [(20, 64), (14, 32), (5, 3), (30, 66)])
def test_native_sdust_equal(synth, T, W):
    seqs = _sdust_inputs() + [r.seq.encode() for r in
                              fasta.read_fastx(str(synth / "asm.fasta"))]
    for seq in seqs:
        assert native_sdust(seq, T=T, W=W) == \
            jax_native_sdust(seq, T=T, W=W)


def test_telomere_walks_equal():
    rng = np.random.default_rng(8)
    for k in (6, 7, 1):
        mask = (rng.random(20_000) < 0.05).astype(np.int8)
        mask[100:160:k] = 1
        assert scan_runs_from_mask(mask, k) == jax_walk(mask, k)
    seq = "".join(ACGT[rng.integers(0, 4, 30_000)]).encode()
    seq = seq[:500] + b"TTAGGG" * 40 + seq[500:] + b"TTAGG"
    for motif in (b"TTAGGG", b"CCCTAA", b"A"):
        assert list(scan_runs(seq, motif)) == list(jax_scan_runs(seq, motif))
    for m, k in ((450, 6), (18, 6), (5, 6), (1800, 7)):
        assert _steps_for(m, k) == jax_steps_for(m, k)


@pytest.mark.parametrize("length,w,inc", [(100_003, 2500, 50), (999, 2500, 50),
                                          (50_000, 999, 37)])
def test_window_stats_numpy_equal(length, w, inc):
    rng = np.random.default_rng(length)
    d = rng.integers(0, 65536, length).astype(np.uint16)
    m = rng.integers(0, 65536, length).astype(np.uint16)
    assert n_windows(length, w, inc) == jax_n_windows(length, w, inc)
    for x, y in zip(window_stats_numpy(d, m, w, inc), jax_wsn(d, m, w, inc)):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_unpack_fused_equal():
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 1 << 31, size=(2, 300)).astype(np.int32)
    for x, y in zip(unpack_fused(arr), jax_unpack_fused(arr)):
        assert np.array_equal(x, y)


def test_telowin_and_telobreaks_equal(gold):
    for args in ((99.9, 0.4), (95, 0.3)):
        a, b = io.StringIO(), io.StringIO()
        telowin.run(str(gold / "telomere.txt"), *args, out=a)
        jax_telowin.run(str(gold / "telomere.txt"), *args, out=b)
        assert a.getvalue() == b.getvalue() and a.getvalue()
    paths = [str(gold / n) for n in ("lens.txt", "sdust.txt",
                                     "telomere.txt")]
    a, b = io.StringIO(), io.StringIO()
    telobreaks.run(*paths, out=a)
    jax_telobreaks.run(*paths, out=b)
    assert a.getvalue() == b.getvalue()


class _StubEngine:
    """A numpy decision step for the chunk engines' host logic: decisions
    from a hash of each row's packed bytes (up to its length in the device
    form), so both packages' state machines see the same results."""

    @staticmethod
    def _fused(rows, lengths):
        h = np.zeros(rows.shape[0], dtype=np.int64)
        for i, r in enumerate(rows):
            n = r.shape[0] if lengths is None else int(lengths[i]) // 4
            h[i] = (int(r[:n].astype(np.int64).sum()) * 2654435761 + n) \
                % 1000003
        w0 = ((h % 3 == 0) << 30) | ((h % 7) << 16) | (h % 5)
        return np.stack([w0, h % 10007]).astype(np.int32)

    def decide_packed_fused(self, packed, nmask, L, lengths=None):
        return self._fused(np.asarray(packed), lengths)

    # read (not called) by the JAX package's _submit
    decide_packed = decide_packed_fused

    def init_chunk_state(self, n_channels, chunk_len, max_chunks):
        return np.zeros((n_channels + 1, max_chunks, chunk_len // 4),
                        dtype=np.uint8)

    def decide_chunk_tick(self, buf, rows, s_chans, s_slots, d_chans,
                          lengths):
        buf[s_chans, s_slots] = rows
        return buf, self._fused(buf[d_chans].reshape(len(d_chans), -1),
                                lengths)


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("no_map", [0, 1])
def test_chunk_engines_and_replay_equal(device, depth, no_map):
    """Both packages' ChunkDecisionEngine / DeviceChunkEngine through
    replay_read_until over the same reads (short final chunks, channels
    recycled, three batches a tick): the same decisions and metrics."""
    rng = np.random.default_rng([depth, no_map, device])
    reads = [("r%d" % i, "".join(ACGT[rng.integers(0, 4, int(n))]),
              bool(i % 2)) for i, n in enumerate(rng.integers(100, 2000, 40))]
    out = {}
    for name, mod in (("jax", jax_chunks), ("port", chunks)):
        cls = mod.DeviceChunkEngine if device else mod.ChunkDecisionEngine
        ce = cls(_StubEngine(), n_channels=8, chunk_len=200, batch=3,
                 policy=mod.ChunkPolicy(max_chunks=4, no_map_action=no_map,
                                        min_hits=2),
                 pipeline_depth=depth)
        decs = []
        process = ce.process

        def logged(events, process=process, decs=decs):
            got = process(events)
            decs.extend((d.channel, d.read_id, d.action, d.n_chunks,
                         d.contig, d.pos, d.nhits) for d in got)
            return got
        ce.process = logged
        m = mod.replay_read_until(ce, reads, unblock_overhead=100)
        out[name] = (vars(m), decs)
    assert out["port"] == out["jax"]
    assert out["port"][0]["n_reads"] == 40 and len(out["port"][1]) > 40
    assert chunks.ACTION_NAMES == jax_chunks.ACTION_NAMES
    assert vars(chunks.ChunkPolicy()) == vars(jax_chunks.ChunkPolicy())


def test_fmt_g_and_fmt_float_equal():
    """%g through C float (np.float32) and %f, on values where the cast
    changes the last printed digit and on the edges of %g's forms."""
    rng = np.random.default_rng(8)
    xs = [0.0, -0.0, 1.0, 0.1, 1 / 3, 2 / 3, 1e-5, 123456.7, 1234567.0,
          3.4e38, 1e-40, -2.5, 600.0 / 7, 99999.95, 0.000123456789]
    xs += list(rng.standard_normal(200) * 10.0 ** rng.integers(-8, 9, 200))
    xs += [int(v) for v in rng.integers(-10 ** 9, 10 ** 9, 50)]
    for x in xs:
        assert cformat.fmt_g(x) == jax_cformat.fmt_g(x), x
        assert cformat.fmt_float(x) == jax_cformat.fmt_float(x), x
    assert cformat.fmt_g(0.1) == "0.1" and cformat.fmt_g(1 / 3) == "0.333333"
    assert cformat.fmt_g(16777217) == "1.67772e+07"


def test_eps_writers_equal():
    rng = np.random.default_rng(9)
    v = lambda: float(rng.uniform(-1000, 1000))  # noqa: E731
    calls = [("header", (v(), v(), v())), ("font", ("Helvetica", 11)),
             ("gray", (0.5,)), ("linewidth", (v(),)),
             ("mstr", (v(), v(), "ctg_1")), ("linex", (v(), v(), v())),
             ("liney", (v(), v(), v())), ("line", (v(), v(), v(), v())),
             ("color", (0xFF0000,)), ("stroke", ()), ("bottom", ())]
    got, want = io.StringIO(), io.StringIO()
    for name, args in calls * 3:
        getattr(eps, name)(got, *args)
        getattr(jax_eps, name)(want, *args)
    assert got.getvalue() == want.getvalue()
    assert got.getvalue().startswith("%!PS-Adobe-3.0 EPSF-3.0\n")


@pytest.mark.parametrize("scale", [1.0, 1.5, 2.0])
def test_rasterize_eps_and_write_png_equal(tmp_path, scale):
    """The rasterizer on minidot.eps and the PNG writer (zlib at its fixed
    level): the same pixels and the same file bytes."""
    text = (ROOT / "test_data" / "golden" / "minidot.eps").read_text()
    img = raster.rasterize_eps(text, scale=scale)
    want = jax_raster.rasterize_eps(text, scale=scale)
    assert img.dtype == want.dtype and np.array_equal(img, want)
    assert (img != 255).any()
    raster.write_png(str(tmp_path / "a.png"), img)
    jax_raster.write_png(str(tmp_path / "b.png"), want)
    assert (tmp_path / "a.png").read_bytes() == \
        (tmp_path / "b.png").read_bytes()


def test_gfa_iter_segments_equal(tmp_path):
    g = tmp_path / "g.gfa"
    g.write_text("H\tVN:Z:1.0\nS\ta\tACGT\tLN:i:4\nS\tb\t*\n"
                 "L\ta\t+\tb\t+\t0M\nS\tc\tGG\nS\td\nX\ty\n"
                 "S\te\tTTTT\n")
    got = list(gfa.iter_segments(str(g)))
    assert got == list(jax_gfa.iter_segments(str(g)))
    assert got == [("a", "ACGT"), ("c", "GG"), ("e", "TTTT")]


def test_decode_read_and_iter_reads_fastq_equal(tmp_path):
    """Every record of example.bam, and of a BAM with reverse-strand and
    quality-less records, decoded to read orientation."""
    got = list(bam.iter_reads_fastq(str(ROOT / "test_data" / "example.bam")))
    want = list(jax_bam.iter_reads_fastq(
        str(ROOT / "test_data" / "example.bam")))
    assert len(got) == 50 and got == want
    assert any(flag & 0x10 for _, flag, _, _ in got)
    path = str(tmp_path / "r.bam")
    with bam.BamWriter(path, ["ref"], [1000]) as w:
        w.write_record("fwd", 0, 0, 10, 60, [(4, 0)], seq="ACGTN",
                       qual=[30, 31, 32, 33, 34])
        w.write_record("rev", 16, 0, 20, 60, [(4, 0)], seq="AACGT",
                       qual=[10, 11, 12, 13, 14])
        w.write_record("noq", 4, -1, -1, 0, [], seq="ACG")
    got = list(bam.iter_reads_fastq(path))
    assert got == list(jax_bam.iter_reads_fastq(path))
    assert got[1][2] == "ACGTT" and got[1][3] == "/.-,+"
    for payload, _, _, _ in bam._iter_raw_records(
            bam.BamFile(path)._all(), bam.BamFile(path)._aln_off):
        assert bam.decode_read(payload) == jax_bam.decode_read(payload)


def test_filter_structural_equal(tmp_path):
    rows = ["##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO",
            "c1\t10\t.\tA\tT\t.\t.\t.",
            "c1\t20\t.\t%s\tT\t.\t.\t." % ("A" * 51),
            "c1\t30\t.\tA\t%s\t.\t.\t." % ("T" * 51),
            "c1\t40\t.\t%s\tT\t.\t.\t." % ("A" * 50),
            "short\tline"]
    vcf = tmp_path / "split.vcf"
    vcf.write_text("\n".join(rows) + "\n")
    for min_len in (50, 10, 0):
        a, b = tmp_path / "a.vcf", tmp_path / "b.vcf"
        n = evaljobs.filter_structural(str(vcf), str(a), min_len)
        assert n == jax_evaljobs.filter_structural(str(vcf), str(b), min_len)
        assert a.read_bytes() == b.read_bytes()
    assert evaljobs.filter_structural(str(vcf), str(a)) == 2


def test_refine_rules_equal(tmp_path):
    """refine's T2T rule (exactly two telomere-end rows) and the PAF
    coverage fractions (the script's awk rule) on the goldens' PAFs."""
    bed = tmp_path / "ends.bed"
    bed.write_text("a\t0\t9\na\t90\t99\nb\t0\t9\nc\t0\t1\nc\t5\t6\n"
                   "c\t8\t9\nd\t1\t2\nd\t3\t4\n\n")
    assert refine.t2t_contigs(str(bed)) == jax_refine.t2t_contigs(str(bed))
    assert refine.t2t_contigs(str(bed)) == ["a", "d"]
    for path in ("test_data/golden/fixasm_fixed.paf",
                 "test_data/synth/asm_to_ref.paf"):
        got = refine.paf_coverage_fractions(str(ROOT / path))
        assert got == jax_refine.paf_coverage_fractions(str(ROOT / path))
        assert got and all(v > 0 for v in got.values())

