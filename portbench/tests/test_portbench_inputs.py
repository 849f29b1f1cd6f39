"""The generators are deterministic by seed, and the roofline arithmetic
agrees with hand counts."""

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401  (puts portbench on the path)
from portbench import draft, harness, roofline
from portbench.reads import BLOCK, ReadStream, ReadText

CPU = torch.device("cpu")
BIG = 2 ** 31 + 11          # seeds go past 32 signed bits


def tiny_index():
    cfg = harness.config("synth-chr1-3-index")
    cfg.update(contigs=[["a", 120000], ["b", 90000]],
               repeat={"len": 300, "copies": 50},
               panel={"block": 20000, "share": 0.5})
    return cfg


def test_draft_is_the_seeds():
    cfg = tiny_index()
    for seed in (0, BIG):
        a, sa = draft.genome(cfg, seed, CPU)
        b, sb = draft.genome(cfg, seed, CPU)
        assert np.array_equal(a, b) and np.array_equal(sa, sb)
        assert np.array_equal(draft.plant_repeats(cfg, seed, a, sa),
                              draft.plant_repeats(cfg, seed, b, sb))
        assert np.array_equal(a, b)
        assert draft.panel_rows(cfg, seed) == draft.panel_rows(cfg, seed)
    c, _ = draft.genome(cfg, 1, CPU)
    assert not np.array_equal(a, c)
    assert sa.tolist() == [0, 120000] and a.max() <= 3


def test_reads_are_the_seeds_and_their_text_is_their_codes():
    cfg = tiny_index()
    mix = harness.traffic("pore-3000ch")
    mix.update(read_len=[2000, 8000], repeat_head_len=[200, 300])
    codes, starts = draft.genome(cfg, BIG, CPU)
    elem = draft.plant_repeats(cfg, BIG, codes, starts)
    rows = draft.panel_rows(cfg, BIG)
    s = ReadStream(cfg, mix, BIG, starts, len(elem), rows)
    p1, p2 = s.block(3), s.block(3)
    assert all(np.array_equal(p1[f], p2[f]) for f in ReadStream.FIELDS)
    assert p1["length"].min() >= 2000 and p1["rc"].any() and \
        (p1["hl"] > 0).any() and (p1["hl"] == 0).any()
    idx = np.arange(3 * BLOCK, 3 * BLOCK + 300)
    lengths, heads = s.reads(idx, codes, elem)
    assert np.array_equal(lengths, p1["length"][:300])
    text = ReadText(codes, elem)
    for i in range(300):
        read = tuple(int(p1[f][i]) for f in ReadStream.FIELDS)
        chunks = "".join(text.chunk(read, off, 448)
                         for off in range(0, 4 * 448, 448))
        assert chunks == draft.ASCII[heads[i]].tobytes().decode()
    # a forward read with no repeat head is a substring of its contig
    fwd = np.flatnonzero((p1["rc"][:300] == 0) & (p1["hl"][:300] == 0))
    g = int(p1["g"][fwd[0]])
    assert np.array_equal(heads[fwd[0]], codes[g:g + 4 * 448])


def test_annotation_features_are_the_seeds():
    cfg = harness.config("synth-chr1-3-annot")
    cfg.update(contigs=[["a", 60000]])
    cfg["features"].update(margin=8000, satellite_len=[600, 3000],
                           gap_len=[100, 1000])
    codes, starts = draft.genome(cfg, BIG, CPU)
    t1, f1 = draft.annotation_text(cfg, BIG, codes, starts)
    t2, f2 = draft.annotation_text(cfg, BIG, codes, starts)
    assert f1 == f2 and np.array_equal(t1[0], t2[0])
    text = t1[0].tobytes()
    assert text.startswith(b"CCCTAA" * 100)
    assert b"TTAGGG" * 100 in text[-3000:]
    assert text.count(b"N") > 0 and set(text) <= set(b"ACGTN")


def test_decide_work_by_hand():
    # a 448-base prefix at width 1792: 434 k-mers, 44 windows of 10
    nbytes, ops = roofline.decide_work({448: 1}, 1792, 15, 10, True)
    assert nbytes == 112 + 4 + 44 * 2 * 32 + 1 + 8
    assert ops == 434 * 25
    # a full row: 1778 k-mers, but only 177 windows fit the width
    nbytes, ops = roofline.decide_work({1792: 2}, 1792, 15, 10, False)
    assert nbytes == 2 * (448 + 4 + 177 * 32 + 9) and ops == 2 * 1778 * 25


def test_sdust_work_and_bound_by_hand():
    assert roofline.sdust_work(1000, 3) == (1024, 20000)
    assert roofline.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, roofline.INT32_OPS_PER_S) == \
        pytest.approx(1.0)


def test_early_exit_compares_by_hand():
    # TTAGGG over "TTAGGGTA": start 0 matches (6 compares), start 1 (T, T
    # vs A: 2), starts 2-5 stop at their first byte (4), start 6 (T then
    # A vs T: 2), start 7 (A: 1)
    x = torch.tensor([3, 3, 0, 2, 2, 2, 3, 0], dtype=torch.uint8)
    assert roofline.early_exit_compares(x, [3, 3, 0, 2, 2, 2]) == 15


def test_telo_mask_work_by_hand():
    x = torch.tensor([3, 3, 0, 2, 2, 2, 3, 0], dtype=torch.uint8)
    # 8 bases read, one match (8 bytes of position)
    assert roofline.telo_mask_work(x, [3, 3, 0, 2, 2, 2]) == (16, 15)


def test_percentile_is_over_every_weight():
    assert harness.percentile([5.0, 1.0], [1, 99], 0.95) == 1.0
    assert harness.percentile([5.0, 1.0], [10, 90], 0.95) == 5.0
