"""Candidate-window selection: whole-genome breakpoint scan -> somatic
candidate windows + split-alignment SV clusters.

Re-designs reference src/WindowSelection_v8.py:266-635 (ParseWindows /
FindCandidateSVWindow) over in-memory tables: no bedtools/sort/awk/grep
subprocesses — interval ops come from utils.intervals, clustering from
ops.dbscan.  The named intermediate bed files are still written into
savedir because downstream stages (InterALNSVs.vcf writer, adjustVCF) read
them, and they make run state inspectable.

Replicated decision semantics (with citations):
  * bp merge: DEL/INS breakpoints merged within 200 bp, windows kept when
    >3 distinct supporting reads (:464-467)
  * RepeatMasker channel: repeat windows holding >=3 distinct INS-bp reads
    (:468-469, 575-588)
  * CLIP DUP/DEL pairs: DBSCAN eps=500 min_samples=3 on linearized 2-D
    sites, keep all-tumor clusters (:437-447, 471-479); single BPType and
    >=3 distinct reads per cluster (:476-479); cluster span = min BP1 /
    min BP2 position (:481-485, including the min-end quirk)
  * good/bad span split and the large-vs-inner intersect dedupe at
    reciprocal 0.5 (:490-559) including the asymmetric DUP else-branch that
    drops INS windows when good-span DUPs exist but none intersect
    (:555-556 cats a file that was never written — replicated as a no-op)
  * RoughCompare span-length test: >=3 tumor spanning reads longer
    (INS/DUP) or shorter (DEL) by >40 bp than every normal spanning read,
    flank 50 (:391-434); min(span counts) in [3, 500] retention (:598-614)
  * LC-over-denovo preference in the final merge + whole-line sort -u
    (:619-625)
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..io.bam import AlignmentTable, parse_cigar_string
from ..ops.dbscan import dbscan_labels
from ..utils import intervals as iv
from ..utils import table as tb
from .breakpoints import (BreakpointRows, chrom_offsets, classify_clip_pairs,
                          encode_site, non_unique_reads, sort_breakpoint,
                          span_breakpoints)

log = logging.getLogger("svscope_tpu.select")

BP_COLS = ["chrom", "ref_start", "ref_end", "read_id", "read_start",
           "read_end", "ref_region", "read_region", "mapq", "strand",
           "bp_type"]
CLIP_COLS = ["BPsite", "readID", "BPType", "mapQ", "Site", "DataLabel"]


# ---------------------------------------------------------------------------
# ParseWindows
# ---------------------------------------------------------------------------

def parse_windows(table: AlignmentTable, fai_path: str, data_label: str,
                  mapq: int = 5, rm_chroms=("chrM",), bp_df=None):
    """ParseWindows equivalent (:266-331).

    bp_df: precomputed breakpoint table (native scanner,
    native/bam.scan_with_breakpoints) — row-identical to the Python
    extraction below, just fast.

    Returns dict of tables (utils.table): del_bp, ins_bp (breakpoint
    columns), clip_others, clip_inv, clip_tra (CLIP_COLS).
    """
    if bp_df is not None:
        df = bp_df
    else:
        bp = BreakpointRows()
        for i in range(len(table)):
            span_breakpoints(table.chrom[i], int(table.start[i]),
                             int(table.end[i]), table.name[i],
                             int(table.mapq[i]),
                             "-" if table.strand_rev[i] else "+",
                             table.cigar[i], out=bp)
        df = bp.asarrays()
    if tb.n_rows(df) == 0:
        z = tb.concat([], BP_COLS)
        empty = tb.concat([], CLIP_COLS)
        return dict(del_bp=z, ins_bp=z, clip_others=empty, clip_inv=empty,
                    clip_tra=empty)
    df = tb.take(df, ~np.isin(df["chrom"], list(rm_chroms)))
    # non-unique-alignment reads: fragments overlap > 100 bp on the read
    per_read = {}
    for rid, rr, qr in zip(df["read_id"], df["ref_region"],
                           df["read_region"]):
        per_read.setdefault(rid, set()).add(rr + "|" + qr)
    nonuniq = {rid for rid, combs in per_read.items()
               if non_unique_reads([c.split("|")[-1] for c in sorted(combs)])}
    bpt, mq = df["bp_type"], df["mapq"]
    del_bp = tb.take(df, (bpt == "DEL") & (mq >= mapq))
    ins_bp = tb.take(df, (bpt == "INS") & (mq >= mapq))
    clip = tb.take(df, (bpt == "CLIP") & (mq > 0)
                   & ~np.isin(df["read_id"], list(nonuniq)))
    # by (read, read_start), ties in table order
    rid = clip["read_id"].astype(str)
    clip = tb.take(clip, np.lexsort((clip["read_start"], rid)))
    records = []
    for read, rows in tb.group_rows(clip["read_id"].astype(str)):
        # >1 CLIP rows (row count, not unique regions — :307)
        if len(rows) <= 1:
            continue
        g = tb.take(clip, np.sort(rows))
        records.extend(classify_clip_pairs(
            g["chrom"].tolist(), g["ref_start"].tolist(),
            g["read_start"].tolist(), g["read_region"].tolist(),
            g["ref_region"].tolist(), g["strand"].tolist(),
            g["mapq"].tolist(), str(read)))
    offsets = chrom_offsets(fai_path)
    rows = [r.split("|") + [encode_site(r.split("|")[0], offsets),
                            data_label] for r in records]
    clip_df = tb.from_rows(rows, CLIP_COLS)
    bpt = clip_df["BPType"]
    return dict(
        del_bp=del_bp, ins_bp=ins_bp,
        clip_others=tb.take(clip_df, np.isin(bpt, ["DUP", "DEL"])),
        clip_inv=tb.take(clip_df, bpt == "INV"),
        clip_tra=tb.take(clip_df, bpt == "TRA"),
    )


# ---------------------------------------------------------------------------
# Span-read fetch + RoughCompare
# ---------------------------------------------------------------------------

def _read_span_sites(cigar: str, aln_start: int, win_start: int, win_end: int):
    """FetchAimRegion's per-record walk (:333-371): full-read coordinates of
    the window boundaries inside this alignment record."""
    ops, lens = parse_cigar_string(cigar)
    letters = np.array(list("MIDNSHP=X"))[ops]
    ref_grow = np.isin(letters, ("D", "P", "N", "M", "=", "X"))
    read_grow = np.isin(letters, ("H", "S", "I", "M", "=", "X"))
    ref_loci = np.concatenate([[aln_start],
                               aln_start + np.cumsum(np.where(ref_grow, lens, 0))])
    read_loci = np.concatenate([[0], np.cumsum(np.where(read_grow, lens, 0))])
    m_idx = np.flatnonzero(np.isin(letters, ("M", "=", "X")))
    if m_idx.size == 0:       # no aligned block (e.g. CG-placeholder)
        return 0, 0
    read_start_aln = int(lens[:m_idx[0]].sum())
    upto = m_idx[-1] + 1
    rg = np.isin(letters, ("D", "P", "N"))
    read_end_aln = int(lens[:upto][~rg[:upto]].sum())
    aln_end = int(ref_loci[-1])
    if aln_start < win_start:
        t5 = int(np.flatnonzero(ref_loci <= win_start)[-1])
        site5 = int(read_loci[t5] + (win_start - ref_loci[t5]))
    else:
        site5 = read_start_aln
    if aln_end > win_end:
        t3 = int(np.flatnonzero(ref_loci <= win_end)[-1])
        site3 = int(read_loci[t3] + (win_end - ref_loci[t3]))
    else:
        site3 = read_end_aln
    return site5, site3


def fetch_span_reads(table: AlignmentTable, chrom: str, start: int, end: int,
                     mapq_cutoff: int = 5):
    """FetchSpanReadDf equivalent (:374-389): spanning reads of [start, end]
    with their on-read window length.  Returns {read: Length}, reads in
    sorted order.

    The per-record window-boundary walk runs as one native batch call
    (span_sites_batch) when the C++ scanner is available; the Python walk
    is the fallback and the parity oracle (tested)."""
    idx = table.fetch_idx(chrom, start, end)
    idx = idx[table.mapq[idx] >= mapq_cutoff] if len(idx) else idx
    if len(idx) == 0:
        return {}
    starts = table.start[idx].astype(np.int64)
    try:
        from ..native.bam import span_sites
        blob, off = table.cig_arrays()
        s5s, s3s = span_sites(blob, off[idx], off[idx + 1] - off[idx],
                              starts, np.full(len(idx), start, np.int64),
                              np.full(len(idx), end, np.int64))
    except Exception:
        pairs = [_read_span_sites(table.cigar[i], int(table.start[i]),
                                  start, end) for i in idx]
        s5s = np.array([p[0] for p in pairs], np.int64)
        s3s = np.array([p[1] for p in pairs], np.int64)
    uniq, inv = np.unique(table.name[idx], return_inverse=True)
    ng = len(uniq)
    big = np.iinfo(np.int64).max
    rs = np.full(ng, big)
    re_ = np.full(ng, -big)
    s5m = np.full(ng, big)
    s3m = np.full(ng, -big)
    np.minimum.at(rs, inv, starts)
    np.maximum.at(re_, inv, table.end[idx].astype(np.int64))
    np.minimum.at(s5m, inv, s5s)
    np.maximum.at(s3m, inv, s3s)
    keep = (rs <= start) & (re_ >= end)
    return dict(zip(uniq[keep].tolist(), (s3m - s5m)[keep].tolist()))


def rough_compare(t_table, n_table, chrom: str, start: int, end: int,
                  window_type: str, offset: int = 40, cutoff: int = 5,
                  flank: int = 50) -> str:
    """RoughCompare / LCRoughCompare decision (:391-434)."""
    s = max(start - flank, 0)
    e = end + flank
    tdf = fetch_span_reads(t_table, chrom, s, e, mapq_cutoff=cutoff)
    ndf = fetch_span_reads(n_table, chrom, s, e, mapq_cutoff=0)
    t_len = np.fromiter(tdf.values(), np.int64, len(tdf))
    if len(ndf) == 0:
        n_hit = 0
    elif window_type == "DEL":
        n_hit = int((t_len < min(ndf.values()) - offset).sum())
    else:
        n_hit = int((t_len > max(ndf.values()) + offset).sum())
    label = "CandidateSom" if n_hit >= 3 else "GermlineWindow"
    return (f"{chrom}\t{start}\t{end}\t{len(tdf)}\t{len(ndf)}\t"
            f"{window_type}\t{label}")


# ---------------------------------------------------------------------------
# DBSCAN somatic cluster selection
# ---------------------------------------------------------------------------

def decide_with_dbscan(df: dict, eps: float = 500.0,
                       min_samples: int = 3, aim_label: str = "Tumor"):
    """DecisionWithDBSCAN (:437-447): cluster 2-D sites, keep clusters whose
    members are all `aim_label` with >= min_samples members.  Returns the
    kept rows (CLIP_COLS + labels), ordered by cluster label."""
    if tb.n_rows(df) == 0:
        out = dict(df)
        out["labels"] = np.empty(0, np.int64)
        return out
    labels = dbscan_labels(np.vstack(df["Site"]), eps=eps,
                           min_samples=min_samples)
    df = dict(df, labels=np.asarray(labels, np.int64))
    df = tb.take(df, df["labels"] != -1)
    keep = [lab for lab, rows in tb.group_rows(df["labels"])
            if (df["DataLabel"][rows] == aim_label).all()
            and len(rows) >= min_samples]
    df = tb.take(df, np.isin(df["labels"], keep))
    return tb.take(df, np.argsort(df["labels"], kind="stable"))


# ---------------------------------------------------------------------------
# bp merge -> candidate windows
# ---------------------------------------------------------------------------

INNER_COLS = ["chrom", "start", "end", "count", "reads", "type"]
LC_COLS = ["chrom", "start", "end", "reads", "count"]
SPAN_COLS = ["labels", "chrom", "start", "end", "BPType", "readID"]


def _merge_bp_windows(bp_df: dict, svtype: str, dist: int = 200,
                      min_reads: int = 4) -> list[list]:
    """`bedtools merge -d 200 -c 4,4 -o count_distinct,distinct` + awk $4>3
    (:464-467).  Returns rows [chrom, start, end, count, reads, type]."""
    rows = []
    for chrom, idx in tb.group_rows(bp_df["chrom"].astype(str)):
        idx = np.sort(idx)
        ms, me, gid, order = iv.merge(bp_df["ref_start"][idx],
                                      bp_df["ref_end"][idx], dist=dist)
        names = bp_df["read_id"][idx][order]
        for k in range(len(ms)):
            rd = sorted(set(names[gid == k]))
            if len(rd) >= min_reads:
                rows.append([str(chrom), int(ms[k]), int(me[k]), len(rd),
                             ",".join(rd), svtype])
    return rows


def _read_bed3(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(chrom, start, end) columns of a bed file."""
    chrom, start, end = [], [], []
    with open(path) as f:
        for line in f:
            p = line.rstrip("\n").split("\t")
            if len(p) >= 3:
                chrom.append(p[0])
                start.append(int(p[1]))
                end.append(int(p[2]))
    return (np.array(chrom, dtype=object), np.array(start, np.int64),
            np.array(end, np.int64))


def _lc_candidates(repeat_bed: str, ins_bp: dict) -> list[list]:
    """RepeatMasker windows holding INS breakpoints (:468-469, 578-584):
    intersect repeat windows with raw tumor INS bps, group by window, keep
    windows with >=3 supporting bp records (reads column joined verbatim,
    duplicates included, as the reference's groupby-join does).
    Returns rows [chrom, start, end, reads, count]."""
    rows = []
    if tb.n_rows(ins_bp) == 0 or not repeat_bed \
            or not os.path.exists(repeat_bed):
        return rows
    r_chrom, r_start, r_end = _read_bed3(repeat_bed)
    i_chrom = ins_bp["chrom"].astype(object)
    for chrom in sorted(set(r_chrom.tolist())):
        rsel = np.flatnonzero(r_chrom == chrom)
        isel = np.flatnonzero(i_chrom == chrom)
        if len(isel) == 0:
            continue
        rs, ie = ins_bp["ref_start"][isel], ins_bp["ref_end"][isel]
        ai, bi, _ = iv.overlap_pairs(r_start[rsel], r_end[rsel], rs,
                                     np.maximum(ie, rs + 1))
        if len(ai) == 0:
            continue
        names = ins_bp["read_id"][isel]
        for wi, pairs in tb.group_rows(np.asarray(ai)):
            if len(pairs) >= 3:
                w = rsel[int(wi)]
                rows.append([chrom, int(r_start[w]), int(r_end[w]),
                             ",".join(names[np.asarray(bi)[np.sort(pairs)]]),
                             len(pairs)])
    return rows


def _cluster_spans(filt: dict, offsets) -> list[list]:
    """Per-DBSCAN-cluster representative span (:480-486): chrom + min BP1
    position as start, min BP2 position as end (min, not max — replicated),
    first BPType, distinct reads.  Rows as SPAN_COLS."""
    rows = []
    for lab, idx in tb.group_rows(filt["labels"]):
        sortbp = [sort_breakpoint(s, offsets) for s in filt["BPsite"][idx]]
        bp1 = [x[0] for x in sortbp]
        bp2 = [x[1] for x in sortbp]
        chrom = bp1[0].split(":")[0]
        start = min(int(x.split(":")[-1]) for x in bp1)
        end = min(int(x.split(":")[-1]) for x in bp2)
        rows.append([int(lab), chrom, start, end, filt["BPType"][idx[0]],
                     ",".join(sorted(set(filt["readID"][idx])))])
    return rows


def _reciprocal_hits(a: list, b: list, frac=0.5):
    """Pairs of (a_idx, b_idx) of rows [chrom, start, end, ...] overlapping
    with `-f frac -r` semantics; chromosomes in sorted order."""
    hits = []
    if not a or not b:
        return hits
    a_c = np.array([r[0] for r in a], dtype=object)
    b_c = np.array([r[0] for r in b], dtype=object)
    a_s = np.array([int(r[1]) for r in a], np.int64)
    a_e = np.array([int(r[2]) for r in a], np.int64)
    b_s = np.array([int(r[1]) for r in b], np.int64)
    b_e = np.array([int(r[2]) for r in b], np.int64)
    for chrom in sorted(set(a_c.tolist()) & set(b_c.tolist())):
        am = np.flatnonzero(a_c == chrom)
        bm = np.flatnonzero(b_c == chrom)
        ai, bi, ov = iv.overlap_pairs(a_s[am], a_e[am], b_s[bm], b_e[bm])
        ai, bi, ov = iv.reciprocal_filter(a_s[am], a_e[am], b_s[bm],
                                          b_e[bm], ai, bi, ov, frac)
        hits.extend((int(am[x]), int(bm[y])) for x, y in zip(ai, bi))
    return hits


def find_candidate_sv_windows(t_table: AlignmentTable, n_table: AlignmentTable,
                              fai_path: str, repeat_bed: str, savedir: str,
                              eps: float = 500.0, min_samples: int = 3,
                              t_bp=None, n_bp=None, rm_chroms=("chrM",)):
    """FindCandidateSVWindow equivalent (:458-635).

    rm_chroms: chromosomes excluded from breakpoint parsing (v8 drops
    chrM; the v7 lineage wrapper in select/legacy passes ()).
    Returns dict of output paths: somatic_bed, large_del, large_dup, inv,
    tra, lc_somatic (the files the reference returns/consumes downstream).
    """
    os.makedirs(savedir, exist_ok=True)
    offsets = chrom_offsets(fai_path)
    tum = parse_windows(t_table, fai_path, "Tumor", mapq=5, bp_df=t_bp,
                        rm_chroms=rm_chroms)
    nor = parse_windows(n_table, fai_path, "Normal", mapq=0, bp_df=n_bp,
                        rm_chroms=rm_chroms)

    cand_del = _merge_bp_windows(tum["del_bp"], "DEL")
    cand_ins = _merge_bp_windows(tum["ins_bp"], "INS")
    cand_lc = _lc_candidates(repeat_bed, tum["ins_bp"])
    _write_rows(cand_del, f"{savedir}/CandidateDEL.tumor.merged.bed")
    _write_rows(cand_ins, f"{savedir}/CandidateINS.tumor.merged.bed")
    _write_rows(cand_lc, f"{savedir}/CandidateLC.tumor.merge.bed")

    # --- CLIP DUP/DEL clusters -> large-SV candidates ---
    others = tb.concat([tum["clip_others"], nor["clip_others"]], CLIP_COLS)
    filt = decide_with_dbscan(others, eps, min_samples)
    # single BPType + >=3 distinct reads per cluster (:476-479)
    keep_labels = [lab for lab, idx in tb.group_rows(filt["labels"])
                   if len(set(filt["BPType"][idx])) == 1
                   and len(set(filt["readID"][idx])) >= 3]
    filt = tb.take(filt, np.isin(filt["labels"], keep_labels))
    spans = _cluster_spans(filt, offsets) if tb.n_rows(filt) else []

    # good/bad span classification (:490-499); both cutoffs default to 5
    good, bad = [], []
    for row in spans:
        _lab, chrom, start, end, _bpt, read_ids = row
        t_span = fetch_span_reads(t_table, chrom, max(start - 50, 0),
                                  end + 50)
        n_span = fetch_span_reads(n_table, chrom, max(start - 50, 0),
                                  end + 50)
        sup = set(read_ids.split(",")) & set(t_span)
        (good if (len(sup) >= 3 and len(n_span) >= 3) else bad).append(row)

    span_windows: list[list] = []   # rows of CandidateSpan.tumor.merged.bed

    def handle_type(bptype: str, inner: list[list]) -> list[list]:
        """Large DEL vs inner DEL / large DUP vs inner INS (:500-567).
        Returns the cluster rows [chrom, start, end, BPType, readID] for
        the InterALNSVs writer."""
        g = [r[1:] for r in good if r[4] == bptype]
        b = [r[1:] for r in bad if r[4] == bptype]
        if not g:
            # no good-span clusters: all inner windows proceed (:523-525, :557-559)
            span_windows.extend(inner)
            return b
        hits = _reciprocal_hits(g, inner, 0.5)
        hit_g = {x for x, _ in hits}
        large = [r for i, r in enumerate(g) if i not in hit_g] + b
        if hits:
            inter_rows = []
            for gi, bi in hits:
                grow, irow = g[gi], inner[bi]
                start = min(grow[1], irow[1])
                # end rule replicates :515/:549 (condition on a.start vs b.end)
                end = grow[2] if grow[1] >= irow[2] else irow[2]
                reads = sorted(set(grow[4].split(",") + irow[4].split(",")))
                inter_rows.append([grow[0], int(start), int(end),
                                   len(reads), ",".join(reads), grow[3]])
            span_windows.extend(inter_rows)
            # inner windows overlapping ANY merged window are subsumed
            # (`intersect -a inner -b merged -wa -v`, :520/:554)
            for chrom in sorted({r[0] for r in inner}):
                im = [r for r in inner if r[0] == chrom]
                mm = [r for r in inter_rows if r[0] == chrom]
                mask = iv.any_overlap_mask(
                    np.array([r[1] for r in im], np.int64),
                    np.array([r[2] for r in im], np.int64),
                    np.array([r[1] for r in mm], np.int64),
                    np.array([r[2] for r in mm], np.int64))
                span_windows.extend(r for r, m in zip(im, mask) if not m)
        else:
            if bptype == "DEL":
                span_windows.extend(inner)
            # DUP branch: reference cats a never-written file (:556) — no-op
        return large

    # inner candidate rows share the span-window row shape
    large_del = handle_type("DEL", cand_del)
    large_dup = handle_type("DUP", cand_ins)

    large_del_path = f"{savedir}/CandidateLargeDEL.tumor.merged.decision.bed"
    large_dup_path = f"{savedir}/CandidateDUP.tumor.merged.decision.bed"
    _write_cluster_decision(filt, large_del, large_del_path)
    _write_cluster_decision(filt, large_dup, large_dup_path)

    # --- RoughCompare over candidate span windows (:569-618) ---
    denovo_rows, lc_rows = [], []
    for row in span_windows:
        chrom, start, end = row[0], int(row[1]), int(row[2])
        wtype = str(row[-1])
        line = rough_compare(t_table, n_table, chrom, start, end, wtype)
        counts = np.array(line.split("\t")[3:5], dtype=int)
        if counts.min() >= 3 and counts.min() <= 500:
            denovo_rows.append(line)
    for row in cand_lc:
        line = rough_compare(t_table, n_table, row[0], int(row[1]),
                             int(row[2]), "INS")
        counts = np.array(line.split("\t")[3:5], dtype=int)
        if counts.min() >= 3 and counts.min() <= 500:
            lc_rows.append(line)
    _write_lines([_DEC_HEADER] + denovo_rows,
                 f"{savedir}/CandidateSpan.tumorDenovo.merged.decision.bed")
    _write_lines([_DEC_HEADER] + lc_rows,
                 f"{savedir}/CandidateSpan.tumorLC.merged.decision.bed")
    denovo_som = [l.rsplit("\t", 1)[0] for l in denovo_rows
                  if l.endswith("CandidateSom")]
    lc_som = [l.rsplit("\t", 1)[0] for l in lc_rows
              if l.endswith("CandidateSom")]
    lc_som_path = f"{savedir}/CandidateSpan.tumorLC.merged.decision.somatic.bed"
    _write_lines(lc_som, lc_som_path)

    # final merge: LC representation preferred on reciprocal-0.5 overlap,
    # then symmetric difference, then whole-line `sort -u` (:619-625)
    lc_rows3 = [l.split("\t") for l in lc_som]
    dn_rows3 = [l.split("\t") for l in denovo_som]
    hits = _reciprocal_hits(lc_rows3, dn_rows3, 0.5)
    lc_hit = {x for x, _ in hits}
    dn_hit = {y for _, y in hits}
    final = ([lc_som[i] for i in sorted(lc_hit)]
             + [lc_som[i] for i in range(len(lc_som)) if i not in lc_hit]
             + [denovo_som[i] for i in range(len(denovo_som))
                if i not in dn_hit])
    final = sorted(set(final))
    somatic_path = f"{savedir}/CandidateSpan.tumor.merged.decision.somatic.bed"
    _write_lines(final, somatic_path)

    # --- INV / TRA clusters (:626-634) ---
    inv = decide_with_dbscan(tb.concat([tum["clip_inv"], nor["clip_inv"]],
                                       CLIP_COLS), eps, min_samples)
    tra = decide_with_dbscan(tb.concat([tum["clip_tra"], nor["clip_tra"]],
                                       CLIP_COLS), eps, min_samples)
    inv_path = f"{savedir}/CandidateINV.tumor.merged.decision.bed"
    tra_path = f"{savedir}/CandidateTRA.tumor.merged.decision.bed"
    _write_cluster_csv(inv, inv_path)
    _write_cluster_csv(tra, tra_path)
    return dict(somatic_bed=somatic_path, large_del=large_del_path,
                large_dup=large_dup_path, inv=inv_path, tra=tra_path,
                lc_somatic=lc_som_path)


_DEC_HEADER = "chrom\tstart\tend\tTumorSpan\tNormalSpan\twindowType\twindowLabel"


def _write_rows(rows: list[list], path: str):
    _write_lines(["\t".join(tb.fmt(v) for v in r) for r in rows], path)


def _write_lines(lines: list[str], path: str):
    with open(path, "w") as f:
        for l in lines:
            f.write(l + "\n")


def _write_cluster_decision(filt: dict, large: list[list], path: str):
    """Cluster-level rows for clusters whose read set appears in `large`
    (:526-531, 562-567), the file the InterALNSVs writer consumes."""
    if not large or tb.n_rows(filt) == 0:
        _write_cluster_csv(tb.take(filt, np.zeros(tb.n_rows(filt), bool)),
                           path)
        return
    reads = {r[4] for r in large}
    spans_idx = [lab for lab, idx in tb.group_rows(filt["labels"])
                 if ",".join(sorted(set(filt["readID"][idx]))) in reads]
    _write_cluster_csv(tb.take(filt, np.isin(filt["labels"], spans_idx)),
                       path)


CLUSTER_CSV_COLS = ["BPsite", "readID", "BPType", "Site", "DataLabel",
                    "labels"]


def _write_cluster_csv(df: dict, path: str):
    out = dict(df)
    out["Site"] = np.array([f"[{int(s[0])} {int(s[1])}]"
                            for s in df.get("Site", [])], dtype=object)
    if tb.n_rows(df) == 0:
        out = tb.concat([], CLUSTER_CSV_COLS)
    tb.write_tsv(path, out, CLUSTER_CSV_COLS)
