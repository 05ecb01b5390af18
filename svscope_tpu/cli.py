"""Command-line interface.

Mirrors the reference's five subcommands (src/SVscope.py:358-474):
DataPrepare, localGraph, localGraph_npz, AlnFeature, callsomaticSV, plus
`adjustVCF` (the reference ships that step as a separate script,
src/CheckInner-alignmentSVs.adjustVCF.py).

Differences by design (in-memory data plane):
  * no bedtools/bamtobed/bgzip/tabix/SQLite subprocesses — BAMs are read
    natively into in-memory alignment tables
  * the genome-window bed (-W) is optional: generated from the .fai when
    omitted
  * --device-dtype float32|float64 selects the EM precision (float64
    matches the reference CPU numerics; float32 is the fast path)
"""
from __future__ import annotations

import argparse
import logging
import os

logging.basicConfig(level=logging.INFO,
                    format="%(asctime)s - %(levelname)s - %(message)s")
log = logging.getLogger("svscope_tpu.cli")


def _device_poa_arg(args):
    """--device-poa -> engine arg: 'host' (the default) is the C++ engine
    (False), 'xla'/'fused' name a device engine."""
    v = getattr(args, "device_poa", "host")
    return False if v == "host" else v


def _em_dtype(args):
    import jax.numpy as jnp
    if getattr(args, "device_dtype", "float32") == "float64":
        import jax
        jax.config.update("jax_enable_x64", True)
        return jnp.float64
    return jnp.float32


def _load_tables(args):
    from .io.bam import AlignmentTable

    def load(path):
        try:  # native scanner (22x the Python parser); same table (tested)
            from .native.bam import scan_alignment_table
            return scan_alignment_table(path)
        except Exception as exc:
            log.warning("native BAM scan failed (%s); Python fallback", exc)
            return AlignmentTable.from_bam(path)

    t = AlignmentTable.concat([load(p) for p in args.Tumorbam.split(",")])
    n = AlignmentTable.concat([load(p) for p in args.Normalbam.split(",")])
    return t, n


def _load_tables_with_bp(args):
    """Tables + native breakpoint tables in one C++ pass (selection path).

    Falls back to tables-only (parse_windows then extracts in Python)."""
    from .select.windows import BP_COLS
    from .utils.table import concat
    try:
        from .native.bam import scan_with_breakpoints
        ts, tb, ns, nb = [], [], [], []
        for p in args.Tumorbam.split(","):
            t, b = scan_with_breakpoints(p)
            ts.append(t)
            tb.append(b)
        for p in args.Normalbam.split(","):
            t, b = scan_with_breakpoints(p)
            ns.append(t)
            nb.append(b)
        from .io.bam import AlignmentTable
        return (AlignmentTable.concat(ts), AlignmentTable.concat(ns),
                concat(tb, BP_COLS), concat(nb, BP_COLS))
    except Exception as exc:
        log.warning("native breakpoint scan failed (%s); Python fallback",
                    exc)
        t, n = _load_tables(args)
        return t, n, None, None


def _genome_windows(args, fai):
    from .engine.features import make_genome_windows
    if getattr(args, "genomeWindow", None):
        rows = [l.split("\t")[:3] for l in
                open(args.genomeWindow).read().splitlines() if l.strip()]
        return [(c, int(s), int(e)) for c, s, e in rows]
    return make_genome_windows(fai)


def _cleanup_dat(savedir):
    """--cleanupDat: drop intermediate artifacts after a *full* run
    (the reference removes its bed.gz/SQLite intermediates,
    src/SVscope.py:101-109).  Only selection intermediates go; the final
    somatic window bed and any --saveData npz payloads are outputs and
    stay."""
    import glob
    n = 0
    for f in glob.glob(os.path.join(savedir, "Candidate*.bed")):
        if f.endswith(".somatic.bed"):
            continue
        os.remove(f)
        n += 1
    log.info("cleanupDat: removed %d intermediate files", n)


def cmd_data_prepare(args):
    from .select.windows import find_candidate_sv_windows
    from .select.interaln import write_interaln_vcf
    fai = args.Reference + ".fai"
    os.makedirs(args.savedir, exist_ok=True)
    if args.selectwindows:
        t_table, n_table, t_bp, n_bp = _load_tables_with_bp(args)
        paths = find_candidate_sv_windows(t_table, n_table, fai,
                                          args.tandemRepeatFile, args.savedir,
                                          t_bp=t_bp, n_bp=n_bp)
        write_interaln_vcf(args.savedir, fai,
                           os.path.basename(args.Tumorbam.split(",")[0]
                                            ).split(".bam")[0], paths)
        args.windowBed = paths["somatic_bed"]
        if args.saveData:
            from .engine.npz import save_window_data
            records = [l for l in open(args.windowBed).read().splitlines()
                       if l.strip()]
            save_window_data(records, args.Reference,
                             args.Tumorbam.split(","),
                             args.Normalbam.split(","),
                             args.TSampleID.split(","),
                             args.NSampleID.split(","), args.savedir,
                             offset=args.offset, mapq=args.mapQ)
        elif args.FullProcess:
            args.rawBedFile = cmd_local_graph(args)
            cmd_aln_feature(args)
            if getattr(args, "cleanupDat", False):
                _cleanup_dat(args.savedir)
    log.info("DataPrepare: all processes finished")


def _setup_oversize(args):
    if getattr(args, "oversize_sharded", False):
        import jax
        import numpy as np
        from jax.sharding import Mesh
        from .ops.poa_batch import set_default_oversize_mesh
        set_default_oversize_mesh(Mesh(np.array(jax.devices()), ("sp",)))


def cmd_local_graph(args):
    from .engine.localgraph import run_local_graph
    _setup_oversize(args)
    records = [l for l in open(args.windowBed).read().splitlines()
               if l.strip() and not l.startswith("chrom\t")]
    return run_local_graph(
        records, args.Reference, args.Tumorbam.split(","),
        args.Normalbam.split(","), args.TSampleID.split(","),
        args.NSampleID.split(","), args.savedir, offset=args.offset,
        mapq=args.mapQ, continue_run=args.Continue, em_dtype=_em_dtype(args),
        device_poa=_device_poa_arg(args),
        threads=int(getattr(args, "thread", 8) or 8))


def cmd_local_graph_npz(args):
    from .engine.localgraph import raw_bed_name
    from .engine.npz import load_window_data
    _setup_oversize(args)
    t_ids = args.TSampleID.split(",")
    n_ids = args.NSampleID.split(",")
    out_path = os.path.join(args.savedir, raw_bed_name(t_ids, n_ids))
    done = set()
    rows = []
    if args.Continue and os.path.exists(out_path):
        for line in open(out_path):
            if line.strip():
                rows.append(line.rstrip("\n"))
                done.add(":".join(line.split("\t")[0:3]))
    dtype = _em_dtype(args)
    from .engine.localgraph import process_window_batch
    device_poa = _device_poa_arg(args)
    wins = [w for w in load_window_data(args.savedir)
            if ":".join(w.record.strip().split("\t")[0:3]) not in done]
    for off in range(0, len(wins), 256):
        for rec in process_window_batch(wins[off:off + 256], em_dtype=dtype,
                                        device_poa=device_poa):
            rows.append("\t".join(str(x) for x in rec))
    rows.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    with open(out_path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    log.info("localGraph_npz: %d records -> %s", len(rows), out_path)
    return out_path


def cmd_aln_feature(args):
    from .engine.features import run_aln_feature
    from .out.vcf import bed2vcf, merge_somatic_vcf
    fai = args.Reference + ".fai"
    t_table, n_table = _load_tables(args)
    windows = _genome_windows(args, fai)
    pool, somatic_bed, rf_out = run_aln_feature(
        args.rawBedFile, windows, t_table, n_table, args.TSampleID,
        args.savedir)
    tag = "_".join(args.TSampleID.split(","))
    out_vcf = os.path.join(args.savedir, f"{tag}.vcf")
    bed2vcf(args.rawBedFile, somatic_bed, rf_out, out_vcf, args.TSampleID,
            args.Reference)
    inter = os.path.join(args.savedir, "InterALNSVs.vcf")
    merged = os.path.join(args.savedir, f"{tag}.mergedSomatic.vcf")
    merge_somatic_vcf(out_vcf, inter, merged)
    log.info("AlnFeature: %s", merged)
    return merged


def cmd_call_somatic_sv(args):
    args.rawBedFile = cmd_local_graph(args)
    merged = cmd_aln_feature(args)
    if getattr(args, "cleanupDat", False):
        _cleanup_dat(args.savedir)
    return merged


def cmd_viz(args):
    from .viz.scopeviz import draw_pipe
    w = args.window
    if os.path.exists(w):  # a window bed: render every row (ScopeVIZ.main)
        outs = []
        for line in open(w):
            if not line.strip() or line.startswith("chrom\t"):
                continue
            try:
                outs.append(draw_pipe(line, args.Reference,
                                      args.Tumorbam.split(","),
                                      args.Normalbam.split(","),
                                      args.TSampleID.split(","),
                                      args.NSampleID.split(","), args.savedir,
                                      offset=args.offset, mapq=args.mapQ,
                                      graph=not args.no_graph))
            except Exception as exc:
                log.warning("viz: skipping %r (%s)", line.strip(), exc)
        log.info("viz: %d figures", len(outs))
        return outs
    if ":" in w:
        chrom, span = w.split(":")
        start, end = span.split("-")
        record = f"{chrom}\t{start}\t{end}"
    else:
        record = w
    out = draw_pipe(record, args.Reference, args.Tumorbam.split(","),
                    args.Normalbam.split(","), args.TSampleID.split(","),
                    args.NSampleID.split(","), args.savedir,
                    offset=args.offset, mapq=args.mapQ,
                    graph=not args.no_graph)
    log.info("viz: %s", out)
    return out


def cmd_adjust_vcf(args):
    from .out.adjust import adjust_vcf
    out = adjust_vcf(args.savedir)
    log.info("adjustVCF: %s", out)
    return out


def _common_bam_args(p, window_bed=True):
    if window_bed:
        p.add_argument("-w", "--windowBed", required=True)
    p.add_argument("--device-poa", nargs="?", const="xla", default="host",
                   choices=("fused", "xla", "host"),
                   help="POA alignment backend: 'host' (default) = C++ "
                        "engine; 'xla' = per-read device alignment rounds "
                        "with host fusion (when given bare); 'fused' = "
                        "whole MSA build on device, one dispatch per window "
                        "batch (docs/PERF.md)")
    p.add_argument("--oversize-sharded", action="store_true",
                   help="align windows beyond the 2048-node/2048 bp device "
                        "buckets (giant tandem repeats) via the sequence-"
                        "sharded wavefront over all available devices "
                        "instead of the single-host DP")
    p.add_argument("-T", "--Tumorbam", required=True)
    p.add_argument("-N", "--Normalbam", required=True)
    p.add_argument("-t", "--TSampleID", required=True)
    p.add_argument("-n", "--NSampleID", required=True)
    p.add_argument("-r", "--Reference", required=True)
    p.add_argument("-s", "--savedir", required=True)
    p.add_argument("-p", "--thread", default="8")
    p.add_argument("-o", "--offset", type=int, default=50)
    p.add_argument("-q", "--mapQ", type=int, default=5)
    p.add_argument("--device-dtype", default="float32",
                   choices=["float32", "float64"])


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="svscope-tpu",
        description="Somatic SV caller (local graph-genome "
                    "optimization + whole-genome alignment feature filter)")
    sub = parser.add_subparsers(dest="command")

    p = sub.add_parser("DataPrepare")
    p.add_argument("-D", "--tandemRepeatFile", required=True)
    _common_bam_args(p, window_bed=False)
    p.add_argument("--selectwindows", action="store_true", default=False)
    p.add_argument("--saveData", action="store_true", default=False)
    p.add_argument("--FullProcess", action="store_true", default=False)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.add_argument("-c", "--cleanupDat", action="store_true", default=False)
    p.add_argument("-W", "--genomeWindow", required=False)
    p.set_defaults(func=cmd_data_prepare)

    p = sub.add_parser("localGraph")
    _common_bam_args(p)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.set_defaults(func=cmd_local_graph)

    p = sub.add_parser("localGraph_npz")
    p.add_argument("-t", "--TSampleID", required=True)
    p.add_argument("-n", "--NSampleID", required=True)
    p.add_argument("-s", "--savedir", required=True)
    p.add_argument("-p", "--thread", default="8")
    p.add_argument("-o", "--offset", type=int, default=50)
    p.add_argument("-q", "--mapQ", type=int, default=5)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.add_argument("--device-dtype", default="float32",
                   choices=["float32", "float64"])
    p.set_defaults(func=cmd_local_graph_npz)

    p = sub.add_parser("AlnFeature")
    p.add_argument("-B", "--rawBedFile", required=True)
    p.add_argument("-W", "--genomeWindow", required=False)
    _common_bam_args(p, window_bed=False)
    p.set_defaults(func=cmd_aln_feature)

    p = sub.add_parser("callsomaticSV")
    p.add_argument("-W", "--genomeWindow", required=False)
    _common_bam_args(p)
    p.add_argument("-c", "--cleanupDat", action="store_true", default=False)
    p.add_argument("-C", "--Continue", action="store_true", default=False)
    p.set_defaults(func=cmd_call_somatic_sv)

    p = sub.add_parser("adjustVCF")
    p.add_argument("-s", "--savedir", required=True)
    p.set_defaults(func=cmd_adjust_vcf)

    p = sub.add_parser("viz", help="per-window diagnostic figure "
                       "(ScopeVIZ equivalent)")
    p.add_argument("-w", "--window", required=True,
                   help="window as chrom:start-end or chrom<TAB>start<TAB>end")
    _common_bam_args(p, window_bed=False)
    p.add_argument("--no-graph", action="store_true", default=False)
    p.set_defaults(func=cmd_viz)

    args = parser.parse_args(argv)
    if not hasattr(args, "func"):
        parser.print_help()
        return None
    # fail fast with readable messages instead of deep tracebacks
    for attr, what in (("Tumorbam", "tumor BAM"), ("Normalbam", "normal BAM"),
                       ("Reference", "reference FASTA"),
                       ("windowBed", "window bed"),
                       ("rawBedFile", "Raw.bed"),
                       ("tandemRepeatFile", "RepeatMasker bed")):
        val = getattr(args, attr, None)
        if not val:
            continue
        for path in str(val).split(","):
            if not os.path.exists(path):
                parser.error(f"{what} not found: {path}")
    ref = getattr(args, "Reference", None)
    if ref and not os.path.exists(ref + ".fai"):
        parser.error(f"reference index not found: {ref}.fai "
                     "(write_fasta creates it; or `samtools faidx`)")
    return args.func(args)


if __name__ == "__main__":
    main()
