"""Host-floor proof for the localGraph headline: wall vs host cores.

The round-4 verdict accepted, as an alternative to a fixed w/s target,
"a committed measurement proving the 2-core host is the floor (e.g. wall
scales with cores)".  This probe produces that measurement in one
process (warm compile shared, affinity switched via sched_setaffinity):

  1. engine wall (device EM on the default backend) at 2 vs 1 host
     cores — the production headline path;
  2. the dominant host stage alone (native C++ POA MSA batch,
     svscope_tpu/native/poa.py::poa_msa_batch_native) at 2 vs 1 cores
     with a matching thread cap;
  3. the Python-glue share inside the POA wrapper (pack / ctypes call /
     unpack) — shows the stage is C++-bound, not wrapper-bound.

Interpretation (docs/PERF.md section 11): the POA stage scales nearly
linearly with cores and the engine wall sub-linearly, the residue being
the per-window Python feature selection + record emission (itself
parallel across a bigger pool because chunks pipeline).  The headline
number therefore tracks host CPU capacity — the reference's own hot path
(spoa in a 6-process pool, src/SVscope.py:158-161) has the same shape,
which is why vs_baseline (both sides measured on the SAME host) is the
stable cross-host claim while absolute w/s moves with the host.

Usage: python tools/probe/core_scaling_probe.py [--cpu-backend]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def _timed(fn, trials=4):
    ts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu-backend", action="store_true",
                    help="force jax to the host CPU; default uses the "
                         "default backend's device for EM")
    ap.add_argument("--windows", type=int, default=128)
    args = ap.parse_args()

    if args.cpu_backend:
        import jax
        jax.config.update("jax_platforms", "cpu")

    import bench
    from svscope_tpu.engine.localgraph import process_window_batch
    import svscope_tpu.native.poa as npoa

    all_cpus = os.sched_getaffinity(0)
    if len(all_cpus) < 2:
        print("single-CPU host: nothing to scale against")
        return
    one_cpu = {min(all_cpus)}

    wins = bench.make_window_payloads(args.windows, np.random.default_rng(3))
    process_window_batch(wins)          # warm: compile + native lib load
    seq_lists = [w.sequences for w in wins]
    npoa.poa_msa_batch_native(seq_lists)

    # 1. engine wall
    os.sched_setaffinity(0, all_cpus)
    w_all, t_all = _timed(lambda: process_window_batch(wins))
    os.sched_setaffinity(0, one_cpu)
    w_one, t_one = _timed(lambda: process_window_batch(wins))
    os.sched_setaffinity(0, all_cpus)
    n = args.windows
    print(f"engine wall  {len(all_cpus)} cores: {w_all:.3f}s = "
          f"{n / w_all:.1f} w/s   trials {[round(t, 3) for t in t_all]}")
    print(f"engine wall  1 core : {w_one:.3f}s = {n / w_one:.1f} w/s"
          f"   trials {[round(t, 3) for t in t_one]}")
    print(f"engine scaling with cores: {w_one / w_all:.2f}x")

    # 2. dominant host stage alone
    p_all, _ = _timed(
        lambda: npoa.poa_msa_batch_native(seq_lists, threads=len(all_cpus)),
        trials=5)
    os.sched_setaffinity(0, one_cpu)
    p_one, _ = _timed(lambda: npoa.poa_msa_batch_native(seq_lists, threads=1),
                      trials=5)
    os.sched_setaffinity(0, all_cpus)
    print(f"POA stage    {len(all_cpus)} cores: {p_all * 1e3:.0f} ms | "
          f"1 core: {p_one * 1e3:.0f} ms | scaling {p_one / p_all:.2f}x")

    # 3. wrapper glue share (pack / C++ / unpack), all-cores affinity
    l = npoa.lib()
    t_pack = t_call = t_unpack = 0.0
    reps = 5
    for _ in range(reps):
        t0 = time.perf_counter()
        flat: list[bytes] = []
        win_off = np.zeros(len(seq_lists) + 1, np.int64)
        for w, seqs in enumerate(seq_lists):
            flat.extend(s.encode() for s in seqs)
            win_off[w + 1] = len(flat)
        seq_off = np.zeros(len(flat) + 1, np.int64)
        for i, b in enumerate(flat):
            seq_off[i + 1] = seq_off[i] + len(b)
        blob = b"".join(flat)
        est = 1024
        for seqs in seq_lists:
            longest = max((len(s) for s in seqs), default=0)
            est = max(est, (len(seqs) + 2) * (2 * longest + 260))
        t1 = time.perf_counter()
        out = np.zeros(len(seq_lists) * est, np.uint8)
        out_len = np.zeros(len(seq_lists), np.int64)
        rc = l.poa_msa_batch(blob, npoa._i64p(seq_off), len(flat),
                             npoa._i64p(win_off), len(seq_lists),
                             npoa._u8p(out), est, npoa._i64p(out_len),
                             len(all_cpus))
        assert rc == 0
        t2 = time.perf_counter()
        for w in range(len(seq_lists)):
            txt = out[w * est: w * est + out_len[w]].tobytes().decode()
            txt.split("\n")
        t3 = time.perf_counter()
        t_pack += t1 - t0
        t_call += t2 - t1
        t_unpack += t3 - t2
    print(f"POA wrapper split: pack {t_pack / reps * 1e3:.1f} ms | "
          f"C++ {t_call / reps * 1e3:.1f} ms | "
          f"unpack {t_unpack / reps * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
