"""InterALNSVs.vcf writer: split-alignment BND/INV/LargeDEL/LargeDUP calls.

Re-implements reference src/WindowSelection_v8.py:637-761 (header builder +
main's VCF emission): per DBSCAN cluster, breakpoints are averaged per side
(BPArrange), clusters need >4 supporting reads, and records keep the
reference's exact INFO layout (including the SVLEN=-%s sign convention for
LargeDUP at :758 and the ALT descriptions "Invasion"/"Delation" — format
parity strings, not prose)."""
from __future__ import annotations

import os
import time

from ..utils import table as tb
from .breakpoints import bp_arrange, chrom_offsets, sort_breakpoint

_INFO = (
    '##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n'
    '##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="Length of the SV">\n'
    '##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the SV">\n'
    '##INFO=<ID=SUPPORT,Number=1,Type=Integer,Description="Number of reads supporting the structural variation">\n'
    '##INFO=<ID=RNAMES,Number=.,Type=String,Description="Names of supporting reads">\n'
    '##INFO=<ID=AF,Number=1,Type=Float,Description="Allele Frequency">\n'
)
_TOOLS = ('##fileformat=VCFv4.2\n##source=TDscope.1.0\n'
          '##FILTER=<ID=PASS,Description="All filters passed">\n')


def write_interaln_header(fai_path: str, out_vcf: str, fasta: str) -> str:
    """generate_vcfheaderINVTRA equivalent (:637-662)."""
    chroms = []
    with open(fai_path) as f:
        for line in f:
            p = line.strip().split("\t")
            chroms.append((p[0], int(p[1])))
    with open(out_vcf, "w") as vcf:
        vcf.write(_TOOLS)
        now = time.strftime("%Y/%m/%d %H:%M:%S", time.localtime())
        vcf.write(f'##fileDate="{now}"\n')
        vcf.write(f"##reference={fasta}\n")
        for c, l in chroms:
            vcf.write(f"##contig=<ID={c},length={l}>\n")
        vcf.write('##ALT=<ID=LargeDEL,Description="Large Delation">\n'
                  '##ALT=<ID=LargeDUP,Description="Large Duplication">\n')
        vcf.write('##ALT=<ID=INV,Description="Invasion">\n'
                  '##ALT=<ID=BND,Description="Translocation">\n')
        vcf.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        vcf.write(_INFO)
    return out_vcf


def _cluster_groups(path: str, offsets):
    """Load a cluster decision CSV and aggregate per label:
    (BP1, BP2, read_names, n_reads)."""
    if not os.path.exists(path):
        return []
    head, rows = tb.read_tsv(path)
    if not rows:
        return []
    i_bp, i_read, i_lab = (head.index(c) for c in
                           ("BPsite", "readID", "labels"))
    groups: dict[int, list] = {}
    for r in rows:
        groups.setdefault(int(r[i_lab]), []).append(r)
    out = []
    for lab in sorted(groups):
        g = groups[lab]
        sortbp = [sort_breakpoint(r[i_bp], offsets) for r in g]
        bp1, bp2 = bp_arrange(sortbp)
        reads = ",".join(sorted({r[i_read] for r in g}))
        out.append((bp1, bp2, reads, len(reads.split(","))))
    return out


def write_interaln_vcf(savedir: str, fai_path: str, tumor_id: str,
                       paths: dict, min_support: int = 4) -> str:
    """main's VCF emission (:680-761).  Support must be > min_support."""
    offsets = chrom_offsets(fai_path)
    out_vcf = os.path.join(savedir, "InterALNSVs.vcf")
    write_interaln_header(fai_path, out_vcf, fai_path.split(".fai")[0])
    with open(out_vcf, "a") as vcf:
        vcf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
                  f"\t{tumor_id}\n")
        for bp1, bp2, reads, n in _cluster_groups(paths["tra"], offsets):
            if n > min_support:
                c1, p1 = bp1.split(":")
                c2, p2 = bp2.split(":")
                vcf.write(f"{c1}\t{p1}\tTDScope.BND.{bp1}-{bp2}_1\t"
                          f"N\tN]{bp2}]\t.\tPASS\tSVLEN=-1;SVTYPE=BND;"
                          f"MATE_ID=TDScope.BND.{bp1}-{bp2}_2;SUPPORT={n};"
                          f"RNAMES={reads}\tGT\t0/1\n")
                vcf.write(f"{c2}\t{p2}\tTDScope.BND.{bp1}-{bp2}_2\t"
                          f"N\tN]{bp1}]\t.\tPASS\tSVLEN=-1;SVTYPE=BND;"
                          f"MATE_ID=TDScope.BND.{bp1}-{bp2}_1;SUPPORT={n};"
                          f"RNAMES={reads}\tGT\t0/1\n")
        for bp1, bp2, reads, n in _cluster_groups(paths["inv"], offsets):
            if n > min_support:
                c1, p1 = bp1.split(":")
                svlen = int(bp2.split(":")[-1]) - int(p1)
                vcf.write(f"{c1}\t{p1}\tTDScope.INV.{bp1}-{bp2}\tN\t<INV>\t.\t"
                          f"PASS\tSVLEN={svlen};SVTYPE=INV;"
                          f"END={bp2.split(':')[-1]};SUPPORT={n};"
                          f"RNAMES={reads}\tGT\t0/1\n")
        for bp1, bp2, reads, n in _cluster_groups(paths["large_del"], offsets):
            if n > min_support:
                c1, p1 = bp1.split(":")
                svlen = int(bp2.split(":")[-1]) - int(p1)
                vcf.write(f"{c1}\t{p1}\tTDScope.DEL.{bp1}-{bp2}\tN\t<LargeDEL>"
                          f"\t.\tPASS\tSVLEN=-{svlen};SVTYPE=LargeDEL;"
                          f"END={bp2.split(':')[-1]};SUPPORT={n};"
                          f"RNAMES={reads}\tGT\t0/1\n")
        for bp1, bp2, reads, n in _cluster_groups(paths["large_dup"], offsets):
            if n > min_support:
                c1, p1 = bp1.split(":")
                svlen = int(bp2.split(":")[-1]) - int(p1)
                # SVLEN=-%s for LargeDUP replicates :758
                vcf.write(f"{c1}\t{p1}\tTDScope.DUP.{bp1}-{bp2}\tN\t<LargeDUP>"
                          f"\t.\tPASS\tSVLEN=-{svlen};SVTYPE=LargeDUP;"
                          f"END={bp2.split(':')[-1]};SUPPORT={n};"
                          f"RNAMES={reads}\tGT\t0/1\n")
    return out_vcf
