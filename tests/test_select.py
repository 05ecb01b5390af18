import os

import numpy as np
import pytest

from svscope_tpu.io.bam import AlignmentTable
from svscope_tpu.ops.dbscan import dbscan_labels
from svscope_tpu.select.breakpoints import (classify_clip_pairs,
                                            chrom_offsets, encode_site,
                                            non_unique_reads,
                                            span_breakpoints, bp_arrange,
                                            sort_breakpoint)
from svscope_tpu.select.windows import (fetch_span_reads,
                                        find_candidate_sv_windows,
                                        parse_windows, rough_compare)
from svscope_tpu.select.interaln import write_interaln_vcf

from synth import make_test_pair


def test_span_breakpoints_indel():
    bp = span_breakpoints("chr1", 1000, 1500, "r1", 60, "+",
                          "100M50D100M60I300M")
    types = bp.bp_type
    assert types == ["DEL", "INS"]
    assert bp.ref_start[0] == 1100 and bp.ref_end[0] == 1150
    assert bp.ref_start[1] == 1250 and bp.ref_end[1] == 1250
    # small indels below cutoff ignored
    bp2 = span_breakpoints("chr1", 1000, 1500, "r1", 60, "+", "100M30D400M")
    assert len(bp2) == 0


def test_span_breakpoints_clip_strand():
    bp = span_breakpoints("chr1", 1000, 1400, "r1", 60, "+", "200S400M")
    assert bp.bp_type == ["CLIP"]
    assert bp.ref_start[0] == 1000          # head clip, + strand -> start
    assert bp.read_start[0] == 200          # aligned block starts at read 200
    # '-' strand: ref-orientation head clip is the read tail -> start
    bp = span_breakpoints("chr1", 1000, 1400, "r1", 60, "-", "200S400M")
    assert bp.ref_start[0] == 1000
    # '-' strand: ref-orientation tail clip is the read head -> end
    bp = span_breakpoints("chr1", 1000, 1400, "r1", 60, "-", "400M200S")
    assert bp.ref_start[0] == 1400
    bp = span_breakpoints("chr1", 1000, 1400, "r1", 60, "+", "400M200S")
    assert bp.ref_start[0] == 1400          # tail clip, + strand -> end


def test_non_unique_reads():
    assert not non_unique_reads(["0-400", "400-800"])
    assert not non_unique_reads(["0-400", "350-800"])      # 51-bp overlap
    assert non_unique_reads(["0-400", "250-800"])          # 151-bp overlap


def test_classify_clip_pairs_del():
    # read: [5000,5400] then jumps to [55000,55400] -> DEL (both ends outside)
    recs = classify_clip_pairs(
        ["chr1", "chr1"], [5400, 55000], [400, 400],
        ["0-400", "400-800"], ["chr1:5000-5400", "chr1:55000-55400"],
        ["+", "+"], [60, 60], "rd")
    kinds = [r.split("|")[2] for r in recs]
    assert "DEL" in kinds


def test_classify_clip_pairs_dup():
    # fragment A ends at bp2=9000, fragment B restarts at bp1=6000 -> DUP
    recs = classify_clip_pairs(
        ["chr1", "chr1"], [9000, 6000], [400, 400],
        ["0-400", "400-800"], ["chr1:5000-9000", "chr1:6000-9500"],
        ["+", "+"], [60, 60], "rd")
    kinds = [r.split("|")[2] for r in recs]
    assert "DUP" in kinds


def test_classify_clip_pairs_inv_tra():
    recs = classify_clip_pairs(
        ["chr1", "chr1"], [5400, 8000], [400, 400],
        ["0-400", "400-800"], ["chr1:5000-5400", "chr1:8000-8400"],
        ["+", "-"], [60, 60], "rd")
    assert [r.split("|")[2] for r in recs if "SoloBP" not in r] == ["INV"]
    recs = classify_clip_pairs(
        ["chr1", "chr2"], [5400, 8000], [400, 400],
        ["0-400", "400-800"], ["chr1:5000-5400", "chr2:8000-8400"],
        ["+", "+"], [60, 60], "rd")
    assert [r.split("|")[2] for r in recs if "SoloBP" not in r] == ["TRA"]
    # same chrom >=100kb -> TRA
    recs = classify_clip_pairs(
        ["chr1", "chr1"], [5400, 905400], [400, 400],
        ["0-400", "400-800"], ["chr1:5000-5400", "chr1:905400-905800"],
        ["+", "+"], [60, 60], "rd")
    assert [r.split("|")[2] for r in recs if "SoloBP" not in r] == ["TRA"]


def test_solo_bp_tail_quirk():
    # overlapping read regions -> no BP pair -> two SoloBP records, the tail
    # one pairing refstart[-1] with refstart[0] (reference quirk)
    recs = classify_clip_pairs(
        ["chr1", "chr1"], [5400, 8000], [0, 0],
        ["0-400", "0-390"], ["chr1:5000-5400", "chr1:8000-8390"],
        ["+", "+"], [60, 60], "rd")
    assert len(recs) == 2
    assert all("SoloBP" in r for r in recs)
    assert recs[1].split("|")[0] == "chr1:8000_chr1:5400"


def test_dbscan_matches_sklearn():
    from sklearn.cluster import DBSCAN
    rng = np.random.default_rng(4)
    for trial in range(4):
        pts = np.concatenate([
            rng.normal(0, 100, (20, 2)),
            rng.normal(5000, 150, (15, 2)),
            rng.uniform(0, 50000, (30, 2)),
        ])
        ours = dbscan_labels(pts, eps=500, min_samples=3)
        ref = DBSCAN(eps=500, min_samples=3).fit(pts).labels_
        assert (ours == ref).all()


def test_chrom_offsets_and_site(tmp_path):
    fai = tmp_path / "x.fa.fai"
    fai.write_text("chr1\t1000\t0\t60\t61\nchr2\t500\t0\t60\t61\n")
    off = chrom_offsets(str(fai))
    assert off == {"chr1": 0, "chr2": 1000}
    assert list(encode_site("chr2:100_chr1:900", off)) == [900, 1100]
    assert sort_breakpoint("chr2:100_chr1:900", off) == ["chr1:900", "chr2:100"]
    assert bp_arrange([["chr1:100", "chr1:200"], ["chr1:110", "chr1:220"]]) \
        == ("chr1:105", "chr1:210")


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("sel"))
    out = make_test_pair(d)
    return d, out


def test_fetch_span_reads(pair_dir):
    d, (ref_path, tumor, normal, recs, ref) = pair_dir
    t = AlignmentTable.from_bam(tumor)
    spans = fetch_span_reads(t, "chr1", 950, 1150)
    assert len(spans) == 12
    # insertion carriers ~60bp longer
    lens = sorted(spans.values())
    assert lens[-1] - lens[0] >= 55


def test_rough_compare(pair_dir):
    d, (ref_path, tumor, normal, recs, ref) = pair_dir
    t = AlignmentTable.from_bam(tumor)
    n = AlignmentTable.from_bam(normal)
    line = rough_compare(t, n, "chr1", 1000, 1100, "INS")
    assert line.endswith("CandidateSom")
    line = rough_compare(t, n, "chr1", 3000, 3100, "INS")
    assert line.endswith("GermlineWindow")


def test_find_candidate_windows_end_to_end(pair_dir, tmp_path):
    d, (ref_path, tumor, normal, recs, ref) = pair_dir
    t = AlignmentTable.from_bam(tumor)
    n = AlignmentTable.from_bam(normal)
    repeat_bed = str(tmp_path / "repeats.bed")
    open(repeat_bed, "w").close()
    savedir = str(tmp_path / "out")
    paths = find_candidate_sv_windows(t, n, ref_path + ".fai", repeat_bed,
                                      savedir)
    som = open(paths["somatic_bed"]).read().splitlines()
    assert len(som) == 1
    chrom, start, end, tspan, nspan, wtype = som[0].split("\t")
    assert chrom == "chr1" and wtype == "INS"
    assert int(start) <= 1050 <= int(end)
    assert int(tspan) >= 12 and int(nspan) >= 12
    vcf = write_interaln_vcf(savedir, ref_path + ".fai", "S", paths)
    body = [l for l in open(vcf).read().splitlines() if not l.startswith("#")]
    assert body == []  # no split-alignment SVs in this pair


def test_repeatmasker_channel(pair_dir, tmp_path):
    d, (ref_path, tumor, normal, recs, ref) = pair_dir
    t = AlignmentTable.from_bam(tumor)
    n = AlignmentTable.from_bam(normal)
    repeat_bed = str(tmp_path / "repeats.bed")
    with open(repeat_bed, "w") as f:
        f.write("chr1\t1020\t1080\n")  # repeat window covering the INS site
    savedir = str(tmp_path / "outlc")
    paths = find_candidate_sv_windows(t, n, ref_path + ".fai", repeat_bed,
                                      savedir)
    lc = open(paths["lc_somatic"]).read().splitlines()
    assert len(lc) == 1 and lc[0].startswith("chr1\t1020\t1080")
    # final somatic bed prefers the LC representation on overlap
    som = open(paths["somatic_bed"]).read().splitlines()
    assert any(l.startswith("chr1\t1020\t1080") for l in som)


def _split_read_table(n_reads=6, bp1=5400, bp2=55000, jitter=30, seed=0,
                      pattern="DEL"):
    """AlignmentTable with split reads forming a large-SV breakpoint pair."""
    rng = np.random.default_rng(seed)
    chrom, start, end, name, mapq, rev, cig = [], [], [], [], [], [], []
    for i in range(n_reads):
        j1 = bp1 + int(rng.integers(-jitter, jitter))
        j2 = bp2 + int(rng.integers(-jitter, jitter))
        if pattern == "DEL":
            # A: [j1-400, j1] clip at end; B: [j2, j2+600] clip at start
            frags = [(j1 - 400, j1, "400M600S", False),
                     (j2, j2 + 600, "400H600M", False)]
        elif pattern == "INV":
            frags = [(j1 - 400, j1, "400M600S", False),
                     (j2, j2 + 600, "600M400S", True)]
        else:
            raise ValueError(pattern)
        for (s, e, c, is_rev) in frags:
            chrom.append("chr1"); start.append(s); end.append(e)
            name.append(f"sr{i}"); mapq.append(60); rev.append(is_rev)
            cig.append(c)
    return AlignmentTable(chrom, start, end, name, mapq, rev, cig)


def _plain_table(n=6, s=2000, e=3000):
    return AlignmentTable(["chr1"] * n, [s] * n, [e] * n,
                          [f"pn{i}" for i in range(n)], [60] * n,
                          [False] * n, [f"{e - s}M"] * n)


def test_large_del_to_interaln_vcf(tmp_path):
    fai = tmp_path / "g.fa.fai"
    fai.write_text("chr1\t100000\t0\t60\t61\n")
    t = _split_read_table(pattern="DEL")
    n = _plain_table()
    repeat = str(tmp_path / "rep.bed"); open(repeat, "w").close()
    savedir = str(tmp_path / "o")
    paths = find_candidate_sv_windows(t, n, str(fai), repeat, savedir)
    vcf = write_interaln_vcf(savedir, str(fai), "S", paths)
    body = [l for l in open(vcf).read().splitlines() if not l.startswith("#")]
    assert len(body) == 1
    rec = body[0].split("\t")
    assert "SVTYPE=LargeDEL" in rec[7]
    assert "SUPPORT=6" in rec[7]
    assert abs(int(rec[1]) - 5400) <= 30
    assert rec[4] == "<LargeDEL>"


def test_inv_to_interaln_vcf(tmp_path):
    fai = tmp_path / "g.fa.fai"
    fai.write_text("chr1\t100000\t0\t60\t61\n")
    t = _split_read_table(pattern="INV")
    n = _plain_table()
    repeat = str(tmp_path / "rep.bed"); open(repeat, "w").close()
    savedir = str(tmp_path / "oi")
    paths = find_candidate_sv_windows(t, n, str(fai), repeat, savedir)
    vcf = write_interaln_vcf(savedir, str(fai), "S", paths)
    body = [l for l in open(vcf).read().splitlines() if not l.startswith("#")]
    assert len(body) == 1 and "SVTYPE=INV" in body[0]


def test_native_breakpoints_match_python(pair_dir, tmp_path):
    """C++ breakpoint extraction row-set == Python span_breakpoints."""
    import pandas as pd
    from svscope_tpu.select.breakpoints import (BreakpointRows,
                                                span_breakpoints)
    from svscope_tpu.native.bam import scan_with_breakpoints
    d, (ref_path, tumor, normal, recs, ref) = pair_dir
    # also exercise CLIP + '-' strand via split reads written to a BAM
    from svscope_tpu.io.bam import BamRecord, BamWriter, parse_cigar_string
    path = str(tmp_path / "sp.bam")
    with BamWriter(path, ["chr1"], [100_000]) as w:
        for i, (pos, cig, fl) in enumerate([
                (5000, "400M600S", 0), (55000, "400H600M", 0),
                (7000, "150S300M", 16), (8000, "300M200S", 16),
                (9000, "100M50D100M60I100M120S", 0)]):
            ops, lens = parse_cigar_string(cig)
            qlen = int(lens[np.isin(ops, [0, 1, 4, 7, 8])].sum())
            w.write(BamRecord(f"s{i}", fl, 0, pos, 60, ops, lens, "A" * qlen))
    for bam in (tumor, path):
        table, bp_native = scan_with_breakpoints(bam)
        py = BreakpointRows()
        for i in range(len(table)):
            span_breakpoints(table.chrom[i], int(table.start[i]),
                             int(table.end[i]), table.name[i],
                             int(table.mapq[i]),
                             "-" if table.strand_rev[i] else "+",
                             table.cigar[i], out=py)
        py_df = pd.DataFrame(py.asarrays())
        nat_df = pd.DataFrame(bp_native)
        cols = list(py_df.columns)
        assert list(nat_df.columns) == cols
        assert len(py_df) == len(nat_df) and len(py_df) > 0
        a = sorted(map(tuple, py_df[cols].astype(str).values.tolist()))
        b = sorted(map(tuple, nat_df[cols].astype(str).values.tolist()))
        assert a == b


def test_inner_del_channel(tmp_path):
    """Somatic DEL windows flow through the CandidateDEL channel."""
    d = str(tmp_path)
    wins = [dict(start=2000, end=2100, svtype="DEL", svlen=70, som_reads=5,
                 depth=12)]
    ref_path, tumor, normal, recs, _ = make_test_pair(d, seed=9,
                                                      ref_len=20_000,
                                                      windows=wins)
    t = AlignmentTable.from_bam(tumor)
    n = AlignmentTable.from_bam(normal)
    repeat = str(tmp_path / "rep.bed"); open(repeat, "w").close()
    paths = find_candidate_sv_windows(t, n, ref_path + ".fai", repeat,
                                      str(tmp_path / "o"))
    som = open(paths["somatic_bed"]).read().splitlines()
    assert len(som) == 1
    cols = som[0].split("\t")
    assert cols[5] == "DEL"
    assert int(cols[1]) <= 2050 <= int(cols[2]) + 60
