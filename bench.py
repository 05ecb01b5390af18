"""Benchmark: full batched per-window engine throughput on the GPU.

Workload: 256 candidate windows (300 bp, 24 spanning reads, half carrying a
60 bp somatic insertion) run through the production localGraph batch path —
batched POA MSA on device (graph-vs-read NW rounds + host fusion), feature
selection, batched 45-slot EM with BIC model selection, cluster labeling
and batched consensus POA — i.e. process_window_batch exactly as the CLI
drives it.

Baseline: the reference's per-window engine is its EMCluster
(src/ReadsCluster.py) plus a small pyspoa cost; EMCluster imported from
the reference checkout given by --reference DIR and timed on matched
feature matrices, scaled by the 6-process localGraph pool cap
(src/SVscope.py:158-161).  pyspoa is not used, so the baseline slightly
favors the reference.  Without --reference, vs_baseline is reported as
"not measured".

Runs in one process and exits non-zero when JAX finds no GPU.  Prints the
device, the card's name and power limit and the host, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.

Usage: python bench.py [--reference DIR] [--small]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

N_WINDOWS = 256
N_READS = 24
WIN_LEN = 300
OFFSET = 50
INS_LEN = 60
# heavy tail: selection admits up to 500 spanning reads per window
# (reference src/WindowSelection_v8.py:600,614); this tier exercises the
# >256-read mp EM routing and the native Ward init in the measured path
HEAVY_WINDOWS = 32
HEAVY_READS = 400


def make_window_payloads(n, rng, n_reads=N_READS, ins_carriers=8):
    """WindowData-like payloads: ref window + reads, the first
    ins_carriers (tumor) reads carrying a 60 bp INS.  The default 8-of-24
    workload is pinned across rounds (tests/test_perf.py)."""
    from svscope_tpu.engine.datamaker import WindowData
    wins = []
    for w in range(n):
        ref = "".join(rng.choice(list("ACGT"), WIN_LEN + 2 * OFFSET))
        ins = "".join(rng.choice(list("ACGT"), INS_LEN))
        mid = len(ref) // 2
        reads = []
        for i in range(n_reads):
            base = ref
            if i < min(n_reads // 2, ins_carriers):
                base = ref[:mid] + ins + ref[mid:]
            b = list(base)
            for _ in range(4):          # light ONT-like noise
                p = int(rng.integers(1, len(b) - 1))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(list("ACGT")))
                elif op == 1:
                    b.insert(p, str(rng.choice(list("ACGT"))))
                else:
                    b.pop(p)
            reads.append("".join(b))
        # both tags >= 3: first half tumor (with INS), second half normal
        ids = ([f"S_tumor|w{w}r{i}" for i in range(n_reads // 2)]
               + [f"S_normal|w{w}r{i}" for i in range(n_reads // 2, n_reads)])
        wins.append(WindowData([ref] + reads, np.array(ids),
                               ref[:OFFSET], ref[-OFFSET:],
                               f"chr1\t{1000 + w * 1000}\t{1000 + w * 1000 + WIN_LEN}",
                               "NormalOutput"))
    return wins


def measure_ours(wins, device_poa=False, n_trials=3):
    """(best windows/s, per-trial seconds) of the pipelined engine path
    with the given POA engine (False = host C++)."""
    from svscope_tpu.engine.localgraph import process_window_batch
    # warm pass: compiles every (shape, batch) bucket the pipelined path
    # uses; steady-state throughput is what the engine delivers on a long
    # window stream (compiles are one-time and disk-cached)
    process_window_batch(wins, device_poa=device_poa)
    trials = []
    for _ in range(n_trials):   # best of n: the host is shared and noisy
        t0 = time.time()
        records = process_window_batch(wins, device_poa=device_poa)
        dt = time.time() - t0
        n_som = sum(1 for r in records if str(r[9]).endswith("EMOutput"))
        assert n_som >= len(wins) * 0.8, f"only {n_som} somatic calls"
        trials.append(round(dt, 3))
    return len(wins) / min(trials), trials


def measure_stages(wins, device_poa=False):
    """Per-stage wall seconds on ONE unpipelined chunk: phase A (host POA
    MSA + feature selection), phase B (device EM dispatch + fetch incl.
    NaN-retry), phase C (labeling + batched consensus POA + emission).
    The pipelined headline overlaps these; the split attributes a change
    in the headline to a stage."""
    from svscope_tpu.engine import localgraph as lg
    chunk = wins[:min(len(wins), lg.PIPELINE_CHUNK)]
    t0 = time.time()
    entries, ready = lg._stage_a(chunk, "tumor", 3, 0.05, device_poa, None)
    t1 = time.time()
    fetch = lg._dispatch_em(ready, None)
    em_results = fetch()
    t2 = time.time()
    lg._emit_chunk(ready, em_results, "tumor", 3, device_poa)
    t3 = time.time()
    return {"n_windows": len(chunk),
            "stage_a_poa_feat_s": round(t1 - t0, 3),
            "stage_b_em_device_s": round(t2 - t1, 3),
            "stage_c_consensus_s": round(t3 - t2, 3)}


def measure_reference_baseline(ref_dir, budget_s=60.0, n_runs=5):
    """Per-window rate of the reference engine, two bounds (round-5
    verdict: harden the noisy single-proxy denominator):

    * em_only: reference EMCluster on matched feature matrices, pooled
      over n_runs (median + spread) — omits the reference's pyspoa cost,
      so vs_baseline computed from it UNDERSTATES our speedup.
    * poa_incl: EMCluster plus this repo's host C++ POA (MSA + consensus
      re-POA, stand-in for pyspoa — it reproduces poa(seqs,1) output
      exactly) on the same windows — the defensible upper bound.

    Both scaled by the reference's 6-process localGraph pool cap
    (src/SVscope.py:158-161), clamped to this machine's cores.
    Returns dict {em_only: [med, lo, hi], poa_incl: float | None}, or
    None when the reference cannot be imported from ref_dir.
    """
    if not ref_dir:
        return None
    ref_src = os.path.join(ref_dir, "src")
    rng = np.random.default_rng(1)
    feats = []
    for _ in range(16):
        a = rng.integers(0, 4, (1, 70))
        b = (a + 1 + rng.integers(0, 3, (1, 70))) % 4
        x = np.concatenate([np.repeat(a, N_READS // 2, 0),
                            np.repeat(b, N_READS // 2, 0)])
        flip = rng.random(x.shape) < 0.03
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x))
    if not os.path.isdir(ref_src):
        return None
    try:
        import matplotlib
        matplotlib.use("Agg")
        sys.path.insert(0, ref_src)
        import ReadsCluster as ref_rc
    except ImportError:
        return None
    finally:
        if ref_src in sys.path:
            sys.path.remove(ref_src)
    scale = min(6, os.cpu_count() or 1)
    rates = []
    for _ in range(n_runs):
        t0 = time.time()
        n_done = 0
        for x in feats:
            ref_rc.EMCluster(x, initselection=1)
            n_done += 1
            if time.time() - t0 > budget_s / n_runs:
                break
        rates.append(n_done / (time.time() - t0) * scale)
    rates.sort()
    em_only = [rates[len(rates) // 2], rates[0], rates[-1]]
    # POA-inclusive bound: per-window host C++ POA (full MSA + 2-cluster
    # consensus re-POA, the reference's spoa calls at DataScanner.py:207
    # and DecisionMaker.py:160,171) on one EM-rate's worth of windows
    poa_incl = None
    try:
        from svscope_tpu.native.poa import poa_native
        wins = make_window_payloads(8, np.random.default_rng(2))
        t0 = time.time()
        for w in wins:
            _cons, msa = poa_native(w.sequences)
            half = len(msa) // 2
            poa_native([r.replace("-", "") for r in msa[1:1 + half]])
            poa_native([r.replace("-", "") for r in msa[1 + half:]])
        poa_s_per_win = (time.time() - t0) / len(wins)
        em_s_per_win = scale / em_only[0]   # serial seconds per window
        poa_incl = scale / (em_s_per_win + poa_s_per_win)
    except Exception:
        pass
    return {"em_only": em_only, "poa_incl": poa_incl}


def heavy_payloads():
    """The heavy tier: 32 windows x 400 reads (selection caps windows at
    500 spanning reads, WindowSelection_v8.py:600)."""
    return make_window_payloads(HEAVY_WINDOWS, np.random.default_rng(5),
                                n_reads=HEAVY_READS,
                                ins_carriers=HEAVY_READS // 2)


def measure_heavy_tier(device_poa=False, n_trials=2):
    """300-500-read windows through the production batch path: exercises
    the mp read-parallel EM routing (with a mesh) and the native Ward init
    at scale."""
    from svscope_tpu.engine import localgraph as lg
    wins = heavy_payloads()
    lg.process_window_batch(wins, device_poa=device_poa)  # warm/compile
    trials = []
    for _ in range(n_trials):
        t0 = time.time()
        records = lg.process_window_batch(wins, device_poa=device_poa)
        trials.append(round(time.time() - t0, 3))
        n_som = sum(1 for r in records if str(r[9]).endswith("EMOutput"))
        assert n_som >= len(wins) * 0.8, f"heavy tier: {n_som} somatic"
    # stage split on the same chunk (ward init lives in stage B dispatch;
    # the native path keeps it off the serial wall)
    t0 = time.time()
    entries, ready = lg._stage_a(wins, "tumor", 3, 0.05, device_poa, None)
    t1 = time.time()
    fetch = lg._dispatch_em(ready, None)
    t2 = time.time()
    em_results = fetch()
    t3 = time.time()
    lg._emit_chunk(ready, em_results, "tumor", 3, device_poa)
    t4 = time.time()
    return {"n_windows": HEAVY_WINDOWS, "n_reads": HEAVY_READS,
            "w_per_s": round(HEAVY_WINDOWS / min(trials), 2),
            "trial_s": trials,
            "stage_a_poa_feat_s": round(t1 - t0, 3),
            "stage_c_consensus_s": round(t4 - t3, 3),
            "em_dispatch_prep_s": round(t2 - t1, 3),
            "em_device_wait_s": round(t3 - t2, 3)}


def run_measurement(n_windows=N_WINDOWS, heavy=True, ref_dir=None):
    from svscope_tpu.utils import machine
    rng = np.random.default_rng(0)
    wins = make_window_payloads(n_windows, rng)
    ours, trials = measure_ours(wins)
    stages = measure_stages(wins)
    base = measure_reference_baseline(ref_dir)
    out = {
        "metric": "localGraph windows/s (300bp, 24 reads; native POA + "
                  "device EM)",
        "value": round(ours, 2),
        "unit": "windows/s",
        "vs_baseline": "not measured",
        "n_windows": n_windows,
        "device": machine.device(),
        "card": machine.card(),
        "host": machine.host(),
        "trial_s": trials,
        "stages": stages,
    }
    if base is not None:
        med, lo, hi = base["em_only"]
        out["vs_baseline"] = round(ours / med, 2)
        out["baseline_w_per_s"] = round(med, 3)
        out["baseline_w_per_s_spread"] = [round(lo, 3), round(hi, 3)]
        if base["poa_incl"]:
            out["vs_baseline_poa_incl"] = round(ours / base["poa_incl"], 2)
            out["baseline_poa_incl_w_per_s"] = round(base["poa_incl"], 3)
    if heavy:
        out["heavy_tier"] = measure_heavy_tier()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reference", default=None,
                    help="reference SVScope checkout (its src/ holds "
                         "ReadsCluster.py) for the same-run baseline")
    ap.add_argument("--small", action="store_true",
                    help="64 windows, no heavy tier")
    args = ap.parse_args(argv)
    from svscope_tpu.utils import machine
    dev = machine.device()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev['platform']}")
    print(f"device: {dev['platform']} {dev['kind']} x{dev['count']}")
    print(f"card: {machine.card()}")
    print(f"host: {machine.host()}")
    print(json.dumps(run_measurement(64 if args.small else N_WINDOWS,
                                     heavy=not args.small,
                                     ref_dir=args.reference)))


if __name__ == "__main__":
    main()
