"""Multi-host window-stream sharding for localGraph.

The reference is single-node (SURVEY.md §2.4); the scale-out here
shards the candidate-window stream across hosts: every process runs the
batched engine on a block-cyclic slice (block-cyclic because window cost
correlates with genome position — hot repeat regions cluster), writes a
per-host shard journal, and host 0 merges the sorted Raw.bed.  Reference
FASTA/annotations are replicated per host; device collectives stay inside
the per-host mesh (parallel/mesh.py); only the final record gather touches
the filesystem.

`jax.distributed.initialize` is optional — process_index/count can be
injected for tests or external launchers (SLURM, GKE).
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger("svscope_tpu.shard")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None):
    """jax.distributed.initialize wrapper (no-op when single process)."""
    import jax
    if coordinator:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


def shard_records(records: list[str], process_index: int,
                  process_count: int, block: int = 16) -> list[str]:
    """Block-cyclic slice of the window stream for one host."""
    out = []
    for start in range(0, len(records), block * process_count):
        lo = start + process_index * block
        out.extend(records[lo:lo + block])
    return out


def shard_raw_bed_name(t_ids, n_ids, process_index: int) -> str:
    from ..engine.localgraph import raw_bed_name
    return raw_bed_name(t_ids, n_ids) + f".shard{process_index}"


def run_local_graph_sharded(records, reference, tumor_bams, normal_bams,
                            t_ids, n_ids, savedir,
                            process_index: int | None = None,
                            process_count: int | None = None,
                            merge: bool = True, **kwargs) -> str | None:
    """Distributed localGraph: run this host's slice, then (host 0) merge.

    Returns the merged Raw.bed path on host 0, else None."""
    import jax
    from ..engine.localgraph import raw_bed_name, run_local_graph
    if process_index is None:
        process_index = jax.process_index()
    if process_count is None:
        process_count = jax.process_count()
    mine = shard_records(records, process_index, process_count)
    log.info("shard %d/%d: %d of %d windows", process_index, process_count,
             len(mine), len(records))
    shard_dir = os.path.join(savedir, f"shard{process_index}")
    shard_out = run_local_graph(mine, reference, tumor_bams, normal_bams,
                                t_ids, n_ids, shard_dir, **kwargs)
    final = os.path.join(shard_dir, "DONE")
    open(final, "w").write(shard_out + "\n")
    if not merge or process_index != 0:
        return None
    return merge_shards(savedir, t_ids, n_ids, process_count)


def merge_shards(savedir: str, t_ids, n_ids, process_count: int,
                 timeout_s: float = 3600.0) -> str:
    """Host-0 merge: wait for every shard's DONE marker, concatenate and
    re-sort into the canonical Raw.bed."""
    import time
    from ..engine.localgraph import raw_bed_name
    rows: list[str] = []
    deadline = time.time() + timeout_s
    for p in range(process_count):
        marker = os.path.join(savedir, f"shard{p}", "DONE")
        while not os.path.exists(marker):
            if time.time() > deadline:
                raise TimeoutError(f"shard {p} did not finish")
            time.sleep(2.0)
        shard_out = open(marker).read().strip()
        rows.extend(l for l in open(shard_out).read().splitlines()
                    if l.strip())
    rows.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    out_path = os.path.join(savedir, raw_bed_name(t_ids, n_ids))
    with open(out_path, "w") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
    return out_path
