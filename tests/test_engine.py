import os

import numpy as np
import pytest

from svscope_tpu.engine.datamaker import data_maker, data_maker2
from svscope_tpu.engine.decision import (call_margin, decision,
                                         find_non_same_site,
                                         msa_feature_selection)
from svscope_tpu.engine.localgraph import run_local_graph
from svscope_tpu.io.bam import BamReader
from svscope_tpu.io.fasta import FastaFile

from synth import make_test_pair


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pair"))
    return make_test_pair(d)


def _readers(pair):
    ref_path, tumor, normal, recs, ref = pair
    return (FastaFile(ref_path), [BamReader(tumor), BamReader(normal)],
            ["S_tumor", "S_normal"])


def test_call_margin():
    #      flank5 = "AC", flank3 = "GT", with a gap inside the 5' flank
    row0 = "A-CTTGT"
    idx = call_margin(row0, "AC", "GT")
    assert sorted(idx) == [0, 2, 5, 6]  # gap col 1 is NOT collected


def test_find_non_same_site():
    x = np.array([[0, 1, 0], [0, 1, 1], [0, 1, 0], [0, 2, 1]])
    # col0: all same -> second count 0; col1: second=1; col2: 2/2 split
    assert list(find_non_same_site(x, 2)) == [2]
    assert list(find_non_same_site(x, 1)) == [1, 2]


def test_data_maker_somatic_window(pair):
    ref, readers, labels = _readers(pair)
    win = data_maker("chr1\t1000\t1100", ref, readers, labels, offset=50)
    assert win.flag == "NormalOutput"
    assert len(win.sequences) == 1 + len(win.read_ids)
    assert len(win.read_ids) >= 24  # 12 tumor + 12 normal (+ bg) spanning reads
    assert win.sequences[0] == ref.fetch("chr1", 950, 1150).upper()
    # tumor reads with the insertion are ~60bp longer
    lens = np.array([len(s) for s in win.sequences[1:]])
    tumor_ins = [i for i, r in enumerate(win.read_ids)
                 if "tumor" in r and int(r.split("t")[-1]) < 5]
    assert len(tumor_ins) == 5
    assert (lens[tumor_ins] > 240).all()


def test_data_maker_flags(pair):
    ref, readers, labels = _readers(pair)
    # region with no coverage -> NoEnoughspanReads
    win = data_maker("chr1\t5500\t5600", ref, readers, labels, offset=50)
    assert win.flag == "NoEnoughspanReads"
    assert win.sequences == []


def test_decision_somatic(pair):
    ref, readers, labels = _readers(pair)
    win = data_maker("chr1\t1000\t1100", ref, readers, labels, offset=50)
    rec = decision(win)
    assert rec[9] == "NormalOutput|EMOutput"
    som_reads = rec[4]
    assert rec[5] >= 1
    names = som_reads.replace(";", ",").split(",")
    assert all("S_tumor|" in n for n in names)
    assert {n.split("|")[1] for n in names} == {f"w0t{i}" for i in range(5)}
    # somatic consensus contains the insertion -> longer than germline
    som_len = max(len(s) for s in rec[3].split(";"))
    germ_len = max(len(s) for s in rec[6].split(";"))
    assert som_len - germ_len > 40


def test_decision_clean_window(pair):
    ref, readers, labels = _readers(pair)
    win = data_maker("chr1\t3000\t3100", ref, readers, labels, offset=50)
    rec = decision(win)
    # no somatic cluster: base record with original flag
    assert rec[3] == "-" and rec[9] in ("NormalOutput",)


def test_local_graph_end_to_end(pair, tmp_path):
    ref_path, tumor, normal, recs, _ = pair
    out = run_local_graph(recs, ref_path, [tumor], [normal], ["S"], ["S"],
                          str(tmp_path), offset=50)
    assert os.path.basename(out) == "S.vs.S.TandemRepeat.Raw.bed"
    lines = [l.split("\t") for l in open(out).read().splitlines()]
    assert len(lines) == 2
    # sorted by start; window 1000 is somatic, 3000 is not
    assert [l[1] for l in lines] == ["1000", "3000"]
    assert lines[0][9] == "NormalOutput|EMOutput"
    assert lines[1][9] == "NormalOutput"


def test_local_graph_matches_sequential(pair, tmp_path):
    """Batched driver rows == sequential decision() rows."""
    ref_path, tumor, normal, recs, _ = pair
    ref, readers, labels = _readers(pair)
    out = run_local_graph(recs, ref_path, [tumor], [normal], ["S"], ["S"],
                          str(tmp_path / "b"), offset=50)
    got = sorted(open(out).read().splitlines())
    exp = []
    for r in recs:
        win = data_maker(r, ref, readers, labels, offset=50)
        exp.append("\t".join(str(x) for x in decision(win)))
    assert got == sorted(exp)


def test_local_graph_resume(pair, tmp_path):
    ref_path, tumor, normal, recs, _ = pair
    d = str(tmp_path / "r")
    out = run_local_graph(recs[:1], ref_path, [tumor], [normal], ["S"], ["S"],
                          d, offset=50)
    first = open(out).read()
    out2 = run_local_graph(recs, ref_path, [tumor], [normal], ["S"], ["S"],
                           d, offset=50, continue_run=True)
    lines = open(out2).read().splitlines()
    assert len(lines) == 2  # no duplicates
    assert first.splitlines()[0] in lines


def test_data_maker2_corners(pair):
    ref, readers, labels = _readers(pair)
    out = data_maker2("chr1\t1000\t1100", ref, readers, labels)
    assert len(out) == 2
    for wd in out:
        # plenty of reads cover the 50bp corners
        assert wd.flag in ("UnspanedSV", "UnspannedSV")
        assert len(wd.sequences) >= 4


def test_background_stats_vectorized_parity(pair):
    from svscope_tpu.engine.features import (background_stats,
                                             _background_stats_vectorized,
                                             make_genome_windows, window_info)
    from svscope_tpu.io.bam import AlignmentTable
    ref_path, tumor, normal, recs, refseq = pair
    t = AlignmentTable.from_bam(tumor)
    wins = make_genome_windows(ref_path + ".fai", size=2500)
    fast = _background_stats_vectorized(t, wins)
    for i, (c, s, e) in enumerate(wins):
        exp_cov, exp_mq = window_info(t, c, s, e)
        got_cov, got_mq = fast["COV"][i], fast["mapQRate"][i]
        assert (np.isnan(exp_cov) and np.isnan(got_cov)) or \
            abs(exp_cov - got_cov) < 1e-9
        assert (np.isnan(exp_mq) and np.isnan(got_mq)) or \
            abs(exp_mq - got_mq) < 1e-9
    # >64 windows routes through the vectorized path automatically
    via_bg = background_stats(t, wins)
    np.testing.assert_array_equal(via_bg["COV"], fast["COV"])
    assert (via_bg["window"] == fast["window"]).all()


def test_local_graph_matches_sequential_small_windows(tmp_path):
    """Batch == sequential for windows in the <10-read regime, where the
    folded EM has inactive K runs (regression for the NaN segment
    softmax)."""
    d = str(tmp_path / "small")
    os.makedirs(d)
    wins = [dict(start=s, end=s + 100, svtype="INS", svlen=60,
                 som_reads=3, depth=dep)
            for s, dep in ((2000, 4), (5000, 5), (8000, 7), (11000, 9))]
    pair = make_test_pair(d, seed=21, ref_len=20_000, windows=wins,
                          bg_reads_per_10kb=1)
    ref_path, tumor, normal, recs, _ = pair
    ref, readers, labels = _readers(pair)
    out = run_local_graph(recs, ref_path, [tumor], [normal], ["S"], ["S"],
                          str(tmp_path / "bs"), offset=50)
    got = sorted(open(out).read().splitlines())
    exp = sorted("\t".join(str(x) for x in decision(
        data_maker(r, ref, readers, labels, offset=50))) for r in recs)
    assert got == exp


def test_local_graph_matches_sequential_envelope(tmp_path):
    """Batch == sequential at the selection envelope: a ~500-read window
    (the reference's span-read cap, src/WindowSelection_v8.py:614) and a
    long-read window — exercises the top READS_LADDER/POA buckets."""
    d = str(tmp_path / "env")
    os.makedirs(d)
    wins = [dict(start=2000, end=2150, svtype="INS", svlen=80,
                 som_reads=36, depth=240),       # 480 spanning reads; the
            # subclone must clear the 5% FindNonSameSite cutoff at N=482
            dict(start=9000, end=9900, svtype="DEL", svlen=120,
                 som_reads=6, depth=12)]         # ~1 kb window payloads
    pair = make_test_pair(d, seed=33, ref_len=20_000, windows=wins,
                          bg_reads_per_10kb=1)
    ref_path, tumor, normal, recs, _ = pair
    ref, readers, labels = _readers(pair)
    out = run_local_graph(recs, ref_path, [tumor], [normal], ["S"], ["S"],
                          str(tmp_path / "envb"), offset=50)
    got = sorted(open(out).read().splitlines())
    exp = sorted("\t".join(str(x) for x in decision(
        data_maker(r, ref, readers, labels, offset=50))) for r in recs)
    assert got == exp
    assert sum("EMOutput" in g for g in got) == 2


def test_decode_rows_round_trip():
    """Batched degap-decode equals per-row decode on random gapped rows,
    including all-gap and empty-matrix edges."""
    from svscope_tpu.utils.seq import decode, decode_rows
    rng = np.random.default_rng(17)
    for _ in range(10):
        n, L = int(rng.integers(1, 12)), int(rng.integers(1, 60))
        codes = rng.integers(0, 5, (n, L)).astype(np.int8)
        codes[0, :] = 4                      # an all-gap row decodes to ""
        assert decode_rows(codes) == [decode(codes[i]) for i in range(n)]
    assert decode_rows(np.zeros((0, 7), np.int8)) == []
