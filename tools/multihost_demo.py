"""Real multi-process sharded localGraph demo.

Launches N separate OS processes; each initializes `jax.distributed`
against a localhost coordinator (exactly what a SLURM/GKE launcher does on
a pod slice), runs its block-cyclic shard of the candidate-window stream
through the batched engine, and writes a shard journal; process 0 merges
the canonical Raw.bed.  The merged output is asserted identical to a
single-process run over the same windows.

Usage: python tools/multihost_demo.py [--procs 2] [--dist]
  Default is filesystem rendezvous with injected rank/size (what external
  launchers do); --dist additionally runs jax.distributed.initialize
  against a localhost coordinator — note this sandbox blocks local TCP
  between processes, so --dist only works on real multi-host setups.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

WORKER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import jax
from svscope_tpu.parallel.shard import (init_distributed,
                                        run_local_graph_sharded)
rank = int(sys.argv[1]); world = int(sys.argv[2])
if {use_dist}:
    init_distributed(coordinator="localhost:{port}", num_processes=world,
                     process_id=rank)
    assert jax.process_index() == rank and jax.process_count() == world
records = [l for l in open({windows!r}).read().splitlines() if l.strip()]
run_local_graph_sharded(records, {ref!r}, [{tumor!r}], [{normal!r}],
                        ["T1"], ["N1"], {savedir!r},
                        process_index=rank, process_count=world,
                        merge=(rank == 0), threads=1)
print("worker", rank, "done")
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--dist", action="store_true")
    args = ap.parse_args()

    import numpy as np
    from synth import make_test_pair
    d = tempfile.mkdtemp(prefix="multihost_")
    wins = [dict(start=s, end=s + 100, svtype="INS", svlen=70, som_reads=5,
                 depth=12) for s in range(5_000, 115_000, 10_000)]
    ref_path, tumor, normal, records, _ = make_test_pair(
        d, seed=4, ref_len=120_000, windows=wins)
    win_bed = os.path.join(d, "windows.bed")
    open(win_bed, "w").write("\n".join(records) + "\n")

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + ":" + os.environ.get("PYTHONPATH", ""))
    port = 12789
    sharded_dir = os.path.join(d, "sharded")
    script = WORKER.format(repo=REPO, use_dist=args.dist, port=port,
                           windows=win_bed, ref=ref_path, tumor=tumor,
                           normal=normal, savedir=sharded_dir)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r),
                               str(args.procs)], env=env)
             for r in range(args.procs)]
    for p in procs:
        assert p.wait(timeout=900) == 0, "worker failed"
    print(f"[sharded] {args.procs} processes in {time.time()-t0:.1f}s")

    from svscope_tpu.engine.localgraph import run_local_graph, raw_bed_name
    single_dir = os.path.join(d, "single")
    t0 = time.time()
    single = run_local_graph(records, ref_path, [tumor], [normal], ["T1"],
                             ["N1"], single_dir, threads=1)
    print(f"[single] 1 process in {time.time()-t0:.1f}s")

    merged = os.path.join(sharded_dir, raw_bed_name(["T1"], ["N1"]))
    a = open(merged).read()
    b = open(single).read()
    assert a == b, "sharded merge differs from single-process output"
    print(f"[parity] merged Raw.bed identical "
          f"({len(a.splitlines())} records)  dir={d}")


if __name__ == "__main__":
    main()
