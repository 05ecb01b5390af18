"""svscope_tpu — a JAX somatic structural-variant engine.

A from-scratch re-design of the capabilities of negi2331026/SVScope
(internally "TDScope"): somatic SV calling on tumor/normal paired ONT
long-read BAMs via

  1. split-alignment breakpoint clustering (BND/INV/LargeDEL/LargeDUP), and
  2. per-window de-novo local graph-genome analysis: partial-order-alignment
     MSA + categorical mixture-model (EM/BIC) phasing of tumor-only clusters,

followed by a random-forest confidence filter over whole-genome alignment
features and VCF emission.

Architecture (accelerator-first, not a port):

  io/        host data plane: FASTA/FAI, BGZF, BAM reader/writer, alignment
             table (replaces bedtools/bamtobed/tabix/SQLite subprocesses)
  utils/     interval algebra (replaces bedtools merge/intersect), sequence
             encoding, misc
  ops/       compute kernels: POA graph engine (NumPy reference, native C++
             host engine, batched XLA device aligner and fused build),
             batched NW/edit-distance kernel, DBSCAN, Ward linkage
  models/    categorical mixture model (batched JAX EM + BIC) and the frozen
             random-forest confidence filter as vectorized XLA tree traversal
  engine/    per-window somatic decision pipeline (DataMaker/Decision
             equivalents) and the batched localGraph driver
  select/    candidate-window selection from CIGAR/CLIP breakpoints
             (WindowSelection_v8 semantics)
  out/       VCF writers (Raw.bed, per-sample VCF, InterALNSVs.vcf,
             mergedSomatic, adjusted)
  parallel/  jax.sharding Mesh plumbing: shard candidate windows across
             devices/hosts, gather records, resume journal
  viz/       per-window diagnostic figures (ScopeVIZ equivalent)

Reference layer map: /root/reference SURVEY.md §1-§3.
"""

__version__ = "0.1.0"
