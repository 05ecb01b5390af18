"""Whole-genome alignment features + random-forest confidence filter
(the AlnFeature stage).

Re-designs reference src/SVscope.py:241-317 and src/DataScanner.py:391-481
over the in-memory AlignmentTable:

  * window_info: per-window coverage rate (summed per-read overlap /
    window length) and low-mapQ read fraction, optionally the
    multi-chromosome span ratio of the window's reads
    (windowInfo/spanchrRatio, src/DataScanner.py:403-467)
  * background_stats over the 10 kb genome grid and over Raw.bed EMOutput
    rows (background, src/DataScanner.py:469-481)
  * Z-scoring vs the genome background (src/SVscope.py:271-280)
  * MisScore via the NW kernel over somatic x germline consensus pairs
    (PairwiseCompare.MisScorePipe, src/PairwiseCompare.py:54-86)
  * allele frequency with the reference's `_tumor|` regex quirk — the
    empty alternation matches everything, so every germline support read
    counts in the denominator (CallAlleleFreq, src/PairwiseCompare.py:66-74;
    replicated)
  * 10-feature assembly + RF predict (src/SVscope.py:293-315) through the
    vectorized XLA forest (models/forest.py)
"""
from __future__ import annotations

import logging
import os

import numpy as np

from ..io.bam import AlignmentTable
from ..models.forest import Forest
from ..ops.nw import calculate_misscore
from ..utils import intervals as iv
from ..utils import table as tb

log = logging.getLogger("svscope_tpu.features")

RF_FEATURES = ["COV_Tumor", "mapQ_Tumor", "COV_Normal", "mapQ_Normal",
               "ABSMisScore", "chromSpan_Tumor", "chromSpan_Normal",
               "AdaptRatio_T", "AdaptRatio_N", "SupportReadSpanRatio"]

RAW_COLS = ["chrom", "start", "end", "SomSeq", "SomReads", "SomCount",
            "GermSeq", "GermReads", "GermCount", "Label"]


def make_genome_windows(fai_path: str, size: int = 10_000):
    """10 kb genome grid (the reference expects a pre-made
    `bedtools makewindows` bed; we generate it natively)."""
    out = []
    with open(fai_path) as f:
        for line in f:
            p = line.split("\t")
            chrom, length = p[0], int(p[1])
            for s in range(0, length, size):
                out.append((chrom, s, min(s + size, length)))
    return out


def window_info(table: AlignmentTable, chrom: str, start: int, end: int,
                mapq_cutoff: int = 5, show_chrom_span: bool = False):
    """windowInfo equivalent (src/DataScanner.py:427-467).

    Zero-length windows (merged point-INS breakpoints can produce
    start == end) return the NaN row: htslib's tabix yields nothing for an
    empty region, which is how the reference avoids dividing by a
    zero window length."""
    idx = (table.fetch_idx(chrom, start, end) if end > start
           else np.empty(0, np.intp))
    if idx.size == 0:
        if show_chrom_span:
            return (np.nan, np.nan, np.nan, [])
        return (np.nan, np.nan)
    per = {}
    for i in idx:
        r = per.setdefault(table.name[i], [table.start[i], table.end[i],
                                           table.mapq[i]])
        r[0] = min(r[0], table.start[i])
        r[1] = max(r[1], table.end[i])
        r[2] = min(r[2], table.mapq[i])
    wlen = end - start
    cov = sum(iv.coverage_length(start, end, [v[0]], [v[1]])
              for v in per.values()) / wlen
    mapq_rate = sum(1 for v in per.values() if v[2] < mapq_cutoff) / len(per)
    if not show_chrom_span:
        return (cov, mapq_rate)
    reads = sorted(per)
    span = table.spanchr_ratio(reads)
    return (cov, mapq_rate, span, reads)


def background_stats(table: AlignmentTable, windows, show_chrom_span=False):
    """background equivalent (src/DataScanner.py:469-481): a table
    (utils.table) with one row per window, keyed 'chrom_start-end' in its
    "window" column.

    The genome-grid case (show_chrom_span=False, the ~308k-window sweep) is
    fully vectorized: every (window, alignment) overlap pair is generated
    with searchsorted over the per-chromosome window grid, reduced per
    (window, read) with lexsort groupby — no per-window Python loop."""
    if not show_chrom_span and len(windows) > 64:
        return _background_stats_vectorized(table, windows)
    rows = []
    for (chrom, start, end) in windows:
        info = window_info(table, chrom, int(start), int(end),
                           show_chrom_span=show_chrom_span)
        rows.append([f"{chrom}_{start}-{end}", *info])
    cols = (["window", "COV", "mapQRate", "chromSpan", "TotalReadID"]
            if show_chrom_span else ["window", "COV", "mapQRate"])
    out = tb.from_rows(rows, cols)
    for c in ("COV", "mapQRate", "chromSpan"):
        if c in out:
            out[c] = out[c].astype(np.float64)
    return out


def _background_stats_vectorized(table: AlignmentTable, windows,
                                 mapq_cutoff: int = 5) -> dict:
    """Vectorized COV/mapQRate over an arbitrary window list.

    Per window w: group that window's overlapping alignment rows by read
    (start=min, end=max, mapQ=min over the rows IN the window), then
    COV = sum per-read clipped span / window length and mapQRate = fraction
    of reads with min mapQ < cutoff — windowInfo semantics exactly."""
    w_chrom = np.array([str(w[0]) for w in windows], dtype=object)
    w_start = np.array([int(w[1]) for w in windows], np.int64)
    w_end = np.array([int(w[2]) for w in windows], np.int64)
    keys = np.array([f"{c}_{s}-{e}" for c, s, e in windows], dtype=object)
    cov = np.full(len(windows), np.nan)
    mqr = np.full(len(windows), np.nan)
    name_codes = table.name_codes()
    for chrom, w_idx in tb.group_rows(w_chrom):
        if chrom not in table._chrom_slices:
            continue
        lo, hi = table._chrom_slices[chrom]
        a_start = table.start[lo:hi]
        a_end = table.end[lo:hi]
        a_mapq = table.mapq[lo:hi]
        a_name = name_codes[lo:hi]
        ws = w_start[w_idx]
        we = w_end[w_idx]
        worder = np.argsort(ws, kind="stable")
        ws_s, we_s = ws[worder], we[worder]
        widx_s = w_idx[worder]
        if not (np.diff(we_s) >= 0).all():
            # non-monotone window ends (irregular bed): per-window fallback
            for wi in w_idx:
                cov[wi], mqr[wi] = window_info(table, chrom,
                                               int(w_start[wi]),
                                               int(w_end[wi]))
            continue
        # window j overlaps row i iff ws[j] < a_end[i] and we[j] > a_start[i]
        hi_w = np.searchsorted(ws_s, a_end, side="left")
        lo_w = np.searchsorted(we_s, a_start, side="right")
        reps = np.maximum(hi_w - lo_w, 0)
        pair_a = np.repeat(np.arange(len(a_start)), reps)
        pair_w = (np.concatenate([np.arange(l, h) for l, h
                                  in zip(lo_w, hi_w) if h > l])
                  if reps.sum() else np.empty(0, np.intp))
        if len(pair_a) == 0:
            continue
        # reduce per (window, read): start min, end max, mapq min
        key = pair_w.astype(np.int64) * (int(name_codes.max()) + 1) \
            + a_name[pair_a]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.concatenate([[0], np.flatnonzero(ks[1:] != ks[:-1]) + 1])
        pa = pair_a[order]
        g_s = np.minimum.reduceat(a_start[pa], first)
        g_e = np.maximum.reduceat(a_end[pa], first)
        g_q = np.minimum.reduceat(a_mapq[pa], first)
        wn = pair_w[order][first]
        ov = np.minimum(g_e, we_s[wn]) - np.maximum(g_s, ws_s[wn])
        ov = np.clip(ov, 0, None)
        n_reads = np.bincount(wn, minlength=len(ws_s))
        cov_sum = np.bincount(wn, weights=ov, minlength=len(ws_s))
        low_q = np.bincount(wn, weights=(g_q < mapq_cutoff),
                            minlength=len(ws_s))
        has = n_reads > 0
        wlen = np.maximum(we_s - ws_s, 1)
        cov[widx_s[has]] = cov_sum[has] / wlen[has]
        mqr[widx_s[has]] = low_q[has] / n_reads[has]
    return {"window": keys, "COV": cov, "mapQRate": mqr}


def call_allele_freq(som_reads_field: str, germ_reads_field: str) -> str:
    """CallAlleleFreq with the `_tumor|` empty-alternation quirk: ALL
    germline support reads enter the denominator
    (src/PairwiseCompare.py:66-74, replicated for output parity)."""
    som_counts = np.array([len(x.split(","))
                           for x in som_reads_field.split(";")])
    germ_reads = [r for grp in germ_reads_field.split(";")
                  for r in grp.split(",")]
    n = som_counts.sum() + len(germ_reads)
    return ";".join(str(c / n) for c in som_counts)


def _raw_rows(raw_bed_path: str) -> list[list[str]]:
    """Raw.bed rows (RAW_COLS, string fields), exact duplicates dropped."""
    return tb.read_rows(raw_bed_path)


def _window_key(row) -> str:
    return f"{row[0]}_{row[1]}-{row[2]}"


MISS_COLS = ["chrom", "start", "end", "window", "somSupportReadID",
             "germSupportReadID", "MisScore", "AF"]


def misscore_pipe(raw_bed_path: str, use_device: bool | None = None
                  ) -> list[list]:
    """MisScorePipe (src/PairwiseCompare.py:76-86): per
    'NormalOutput|EMOutput' row, MisScore + AF, as rows of MISS_COLS.  On
    an accelerator the som x germ alignment stats run through the batched
    NW kernel (ops/nw_batch)."""
    with open(raw_bed_path) as f:
        som = [l.rstrip("\n").split("\t") for l in f if l.strip()]
    som = [r for r in som if r[9] == "NormalOutput|EMOutput"]
    if not som:
        return []
    if use_device is None:
        import jax
        use_device = jax.default_backend() not in ("cpu",)
    if use_device:
        from ..ops.nw import pick_misscore
        from ..ops.nw_batch import misscore_batch
        pairs, spans = [], []
        for r in som:
            row_pairs = [(a, b) for a in r[3].split(";")
                         for b in r[6].split(";")]
            spans.append((len(pairs), len(row_pairs)))
            pairs.extend(row_pairs)
        raw = misscore_batch(pairs)
        signed = [int(raw[i]) if len(pairs[i][0]) >= len(pairs[i][1])
                  else -int(raw[i]) for i in range(len(pairs))]
        miss = [pick_misscore(signed[o:o + n]) for o, n in spans]
    else:
        miss = [calculate_misscore(r[3].split(";"), r[6].split(";"))
                for r in som]
    return [[r[0], int(r[1]), int(r[2]), _window_key(r), r[4], r[7],
             int(m), call_allele_freq(r[4], r[7])]
            for r, m in zip(som, miss)]


def run_aln_feature(raw_bed_path: str, genome_windows, t_table, n_table,
                    t_sample_id: str, savedir: str,
                    forest: Forest | None = None):
    """AlnFeature feature assembly + RF scoring (src/SVscope.py:241-317).

    Writes <T>.Somatic.bed and RandomForestResult.tsv; returns the ReadPool
    table (utils.table, with yprob/y_hat) for the VCF stage."""
    os.makedirs(savedir, exist_ok=True)
    raw = _raw_rows(raw_bed_path)
    em = [r for r in raw if "EMOutput" in r[9]]
    sv_windows = [(r[0], int(r[1]), int(r[2])) for r in em]

    log.info("background stats over %d genome windows", len(genome_windows))
    bg_t = background_stats(t_table, genome_windows)
    bg_n = background_stats(n_table, genome_windows)
    sv_t = background_stats(t_table, sv_windows, show_chrom_span=True)
    sv_n = background_stats(n_table, sv_windows, show_chrom_span=True)
    by_win = []
    for sv, bg in ((sv_t, bg_t), (sv_n, bg_n)):
        cov = bg["COV"][~np.isnan(bg["COV"])]
        mq = bg["mapQRate"][~np.isnan(bg["mapQRate"])]
        sv["COV_Zscore"] = (sv["COV"] - cov.mean()) / np.std(cov)
        sv["mapQ_Zscore"] = (sv["mapQRate"] - mq.mean()) / np.std(mq)
        first = {}                          # first row per window key
        for i, w in enumerate(sv["window"]):
            first.setdefault(w, i)
        by_win.append(first)
    row_t, row_n = by_win

    comp, seen = [], set()
    for r in misscore_pipe(raw_bed_path):
        if tuple(r) not in seen:
            seen.add(tuple(r))
            comp.append(r + [abs(r[6])])
    somatic_bed = os.path.join(savedir, f"{t_sample_id}.Somatic.bed")
    with open(somatic_bed, "w") as f:
        for r in comp:
            f.write("\t".join(tb.fmt(v) for v in r) + "\n")
    comp_by_win = {r[3]: r for r in comp}

    em2 = {_window_key(r): r for r in raw if r[9] == "NormalOutput|EMOutput"}
    windows = sorted(set(comp_by_win) & set(em2))

    rows = []
    for w in windows:
        r = em2[w]
        som_names = [a.split("|")[-1]
                     for a in r[4].replace(";", ",").split(",")]
        germ_names = [a.split("|")[-1]
                      for a in r[7].replace(";", ",").split(",")]
        adapt = som_names + germ_names
        it, jn = row_t[w], row_n[w]
        tot_t = sv_t["TotalReadID"][it]
        tot_n = sv_n["TotalReadID"][jn]
        den_t = len(tot_t) * (1 - sv_t["mapQRate"][it])
        den_n = len(tot_n) * (1 - sv_n["mapQRate"][jn])
        rows.append([
            w,
            sv_t["COV_Zscore"][it], sv_t["mapQ_Zscore"][it],
            sv_n["COV_Zscore"][jn], sv_n["mapQ_Zscore"][jn],
            comp_by_win[w][8],
            sv_t["chromSpan"][it], sv_n["chromSpan"][jn],
            (len(np.intersect1d(adapt, tot_t)) / den_t
             if den_t > 0 else 0.0),
            (len(np.intersect1d(adapt, tot_n)) / den_n
             if den_n > 0 else 0.0),
            t_table.spanchr_ratio(som_names),
        ])
    pool = tb.from_rows(rows, ["window"] + RF_FEATURES)
    if rows:
        forest = forest or Forest.from_npz()
        X = np.stack([pool[c].astype(np.float64) for c in RF_FEATURES], 1)
        pool["yprob"] = forest.predict_proba(X)[:, 1]
        pool["y_hat"] = forest.predict(X)
    else:
        pool["yprob"] = np.empty(0)
        pool["y_hat"] = np.empty(0)
    rf_out = os.path.join(savedir, "RandomForestResult.tsv")
    tb.write_tsv(rf_out, pool, ["window"] + RF_FEATURES + ["yprob", "y_hat"],
                 index="window")
    return pool, somatic_bed, rf_out
