"""WGS-scale background-stats benchmark (BASELINE.md evidence, VERDICT r2
task 9).

The reference's AlnFeature stage sweeps windowInfo over the ~308k x 10 kb
hg38 window grid with a 100-worker process pool
(src/DataScanner.py:469-481: `background`).  This harness synthesizes an
hg38-scale in-memory AlignmentTable (24 chromosomes, ~30x long-read
coverage => ~10M alignment rows) and times the framework's vectorized
sweep (`engine.features.background_stats`), reporting wall time and peak
RSS.  Pure host work — no device involved.

Usage: python tools/wgs_bench.py [--coverage 30] [--chrom-mb 128]
       [--n-chrom 24] [--window-kb 10]
"""
from __future__ import annotations

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_table(n_chrom: int, chrom_len: int, coverage: float, seed: int = 0):
    """hg38-scale AlignmentTable: ONT-like reads (~8-12 kb), 10% of reads
    carry a supplementary alignment on a random chromosome (chromSpan
    realism), mapQ skewed high with a low-mapQ tail."""
    from svscope_tpu.io.bam import AlignmentTable
    rng = np.random.default_rng(seed)
    chroms, starts, ends, names, mapqs, strands, cigars = \
        [], [], [], [], [], [], []
    read_no = 0
    for c in range(n_chrom):
        cname = f"chr{c + 1}"
        mean_len = 10_000
        n_reads = int(chrom_len * coverage / mean_len)
        s = rng.integers(0, chrom_len - 2000, n_reads)
        ln = rng.integers(8000, 12001, n_reads)
        e = np.minimum(s + ln, chrom_len)
        q = np.where(rng.random(n_reads) < 0.07,
                     rng.integers(0, 5, n_reads),
                     rng.integers(20, 61, n_reads))
        chroms.append(np.full(n_reads, cname, object))
        starts.append(s)
        ends.append(e)
        names.append(np.array([f"r{read_no + i}" for i in range(n_reads)],
                              object))
        mapqs.append(q.astype(np.int32))
        strands.append(rng.random(n_reads) < 0.5)
        cigars.append(np.full(n_reads, f"{mean_len}M", object))
        read_no += n_reads
    # supplementary fragments: 10% of reads get a second row elsewhere
    all_names = np.concatenate(names)
    n_supp = len(all_names) // 10
    pick = np.random.default_rng(seed + 1).choice(len(all_names), n_supp,
                                                  replace=False)
    sc = np.random.default_rng(seed + 2)
    supp_chrom = np.array([f"chr{i + 1}" for i in
                           sc.integers(0, n_chrom, n_supp)], object)
    supp_start = sc.integers(0, chrom_len - 4000, n_supp)
    supp_len = sc.integers(1000, 4001, n_supp)
    chroms.append(supp_chrom)
    starts.append(supp_start)
    ends.append(supp_start + supp_len)
    names.append(all_names[pick])
    mapqs.append(sc.integers(0, 61, n_supp).astype(np.int32))
    strands.append(sc.random(n_supp) < 0.5)
    cigars.append(np.full(n_supp, "2000M", object))
    return AlignmentTable(np.concatenate(chroms), np.concatenate(starts),
                          np.concatenate(ends), np.concatenate(names),
                          np.concatenate(mapqs), np.concatenate(strands),
                          np.concatenate(cigars))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--chrom-mb", type=float, default=128.0)
    ap.add_argument("--n-chrom", type=int, default=24)
    ap.add_argument("--window-kb", type=int, default=10)
    args = ap.parse_args()
    chrom_len = int(args.chrom_mb * 1e6)

    t0 = time.time()
    table = synth_table(args.n_chrom, chrom_len, args.coverage)
    t_build = time.time() - t0
    windows = []
    for c in range(args.n_chrom):
        cname = f"chr{c + 1}"
        for s in range(0, chrom_len, args.window_kb * 1000):
            windows.append((cname, s, min(s + args.window_kb * 1000,
                                          chrom_len)))
    print(f"table: {len(table):,} alignment rows "
          f"({args.n_chrom} x {args.chrom_mb:g} Mb @ {args.coverage:g}x, "
          f"built in {t_build:.1f}s); grid: {len(windows):,} windows "
          f"of {args.window_kb} kb")

    from svscope_tpu.engine.features import background_stats
    t0 = time.time()
    df = background_stats(table, windows)
    dt = time.time() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    cov = np.asarray(df["COV"], float)
    ok = np.isfinite(cov)
    print(f"background_stats: {dt:.1f}s for {len(windows):,} windows "
          f"({len(windows) / dt:,.0f} windows/s single host process), "
          f"peak RSS {rss_gb:.1f} GB")
    print(f"sanity: {ok.sum():,} covered windows, "
          f"median COV {np.median(cov[ok]):.1f} "
          f"(expect ~{args.coverage:g}), median mapQRate "
          f"{np.median(df['mapQRate'].to_numpy(float)[ok]):.3f}")
    assert ok.sum() > 0.95 * len(windows)
    assert abs(np.median(cov[ok]) - args.coverage) / args.coverage < 0.25


if __name__ == "__main__":
    main()
