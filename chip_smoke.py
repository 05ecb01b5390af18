#!/usr/bin/env python3
"""Smoke run of the tumor/normal main path on one GPU.

Phases, in one process (only the phase-1 child touches the card while it
runs; this process imports JAX after it has exited):

  0  identify the machine: the card's name and power limit, host cores
     and AVX-512, which native libraries loaded (and whether each was
     rebuilt) — then, after phase 1, the JAX device, version and
     compile-cache directory
  1  `pytest -m gpu tests/` in a child process
  2  every device kernel of the main path against its reference, at real
     widths: folded EM (float64 on the CPU device as reference), the XLA
     POA aligner and the fused MSA build (host C++ engine), the MisScore
     NW kernel (host DP) and the forest (float64 on the CPU device);
     prints compiled.memory_analysis() of each kernel
  3  the CLI main path (DataPrepare --selectwindows --FullProcess, then
     adjustVCF) on the seeded 4 x 5 Mb genome of tools/genome_bench, cold
     and warm; merged-VCF precision/recall against the planted truth
  4  times for the record: process_window_batch windows/s on the light
     (256 x 24 reads) and heavy (32 x 400 reads) workloads with each POA
     engine, and the per-stage split

With --four-cards it runs only the mesh comparisons of __graft_entry__
(dp-mesh records, mp read-parallel EM, sp wavefront) on four cards.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": n}},
printed only when every phase passed.  Without a GPU the script exits
non-zero and prints no such line.  A JSON report of every phase goes to
chiprun_out/smoke/report.json.

Usage: python chip_smoke.py [--four-cards]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out", "smoke")

# EM parity: float32 on the card against float64 on the CPU device.
# Partitions and K must be identical, and the BIC of K=1 and of the
# selected K within this relative tolerance (f32 accumulation over <= 500
# reads x 20 steps keeps ~1e-6).  Other K runs are not compared: a run
# that degenerates re-initializes from a jax.random Dirichlet draw, and
# the draw differs between float32 and float64.
BIC_RTOL = 1e-4
# forest: float32 thresholds/inputs on the card vs float64 on the CPU
FOREST_ATOL = 1e-6
# merged-VCF precision / recall of a CPU run of the same seeded genome
# (JAX_PLATFORMS=cpu, same code); the card must do no worse
CPU_PRECISION = 1.0
CPU_RECALL = 0.84375


def log(msg: str) -> None:
    print(msg, flush=True)


class Report(dict):
    """Phase results, written to OUT_DIR/report.json after every phase so
    a run cut short still leaves what it measured."""

    def add(self, phase: str, **kv) -> None:
        self.setdefault(phase, {}).update(kv)
        os.makedirs(OUT_DIR, exist_ok=True)
        with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
            json.dump(self, f, indent=1, default=str)


# --------------------------------------------------------------------------
# phase 0: the machine
# --------------------------------------------------------------------------

def card_or_exit() -> str:
    """The card line(s) from nvidia-smi, read before JAX is imported."""
    from svscope_tpu.utils import machine
    card = machine.card()
    if card is None:
        sys.exit("chip_smoke: no GPU (nvidia-smi found no card)")
    return card


def native_libs() -> dict:
    """Load each native library; report whether it loaded and whether it
    was (re)built from native/*.cpp during this load."""
    from svscope_tpu.native import LIBPOA, bam, hcluster, poa
    out = {}
    for name, path, load in (("libpoa", LIBPOA, poa.lib),
                             ("libbamscan", bam.LIBBAM, bam.lib),
                             ("libhcluster", hcluster.LIB, hcluster.lib)):
        before = os.path.getmtime(path) if os.path.exists(path) else None
        try:
            load()
        except Exception as exc:     # reported; phase 0 decides below
            out[name] = f"FAILED: {exc!r}"
            continue
        rebuilt = before is None or os.path.getmtime(path) != before
        out[name] = "loaded, rebuilt" if rebuilt else "loaded, prebuilt"
    return out


def phase0_host(rep: Report, card: str) -> None:
    """The host half of phase 0, before anything imports JAX; building the
    native libraries here also keeps the phase-1 child from racing to."""
    from svscope_tpu.utils import machine
    host = machine.host()
    log(f"[phase0] host: nproc {host['nproc']}, avx512 {host['avx512']}")
    libs = native_libs()
    for k, v in libs.items():
        log(f"[phase0] native {k}: {v}")
    rep.add("phase0", card=card, host=host, native=libs)
    if not libs["libpoa"].startswith("loaded"):
        raise RuntimeError("the native POA engine (phase-2 reference and "
                           "the device POA paths) did not load")


def phase0_device(rep: Report, want_count: int = 1) -> dict:
    import jax
    from svscope_tpu.utils import jaxcfg, machine
    jaxcfg.enable_cache()
    dev = machine.device()
    log(f"[phase0] jax {jax.__version__}: platform {dev['platform']}, "
        f"device_kind {dev['kind']}, {dev['count']} device(s)")
    if dev["platform"] != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {dev['platform']})")
    if dev["count"] < want_count:
        sys.exit(f"chip_smoke: needs {want_count} GPUs, found {dev['count']}")
    cache = jax.config.jax_compilation_cache_dir
    log(f"[phase0] compile cache: {cache}")
    rep.add("phase0", device=dev, jax=jax.__version__, compile_cache=cache)
    return dev


# --------------------------------------------------------------------------
# phase 1: the gpu-marked tests, in a child that owns the card alone
# --------------------------------------------------------------------------

def phase1(rep: Report) -> None:
    os.makedirs(OUT_DIR, exist_ok=True)
    xml_path = os.path.join(OUT_DIR, "gpu_tests.xml")
    # cpu beside cuda: the gpu tests compute their float64 references on
    # the CPU device
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", f"--junitxml={xml_path}", "tests/"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900)
    tail = "\n".join(r.stdout.strip().splitlines()[-15:])
    log(f"[phase1] pytest -m gpu exit {r.returncode} in "
        f"{time.time() - t0:.1f} s\n{tail}")
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-4000:])
        raise RuntimeError(f"gpu tests failed (exit {r.returncode})")
    import xml.etree.ElementTree as ET
    suite = ET.parse(xml_path).getroot()
    suite = suite if suite.tag == "testsuite" else suite.find("testsuite")
    counts = {k: int(suite.get(k)) for k in
              ("tests", "failures", "errors", "skipped")}
    rep.add("phase1", seconds=round(time.time() - t0, 1), **counts)
    if counts["skipped"] or counts["tests"] == 0:
        raise RuntimeError(f"gpu tests did not all run on the card: {counts}")


# --------------------------------------------------------------------------
# phase 2: kernel parity at real widths
# --------------------------------------------------------------------------

def _partition(labels) -> set:
    labels = np.asarray(labels)
    return {tuple(np.flatnonzero(labels == v)) for v in np.unique(labels)}


def _cpu_f64():
    """Context: float64, jitted work placed on the host CPU device."""
    import contextlib
    import jax
    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    stack.enter_context(jax.default_device(jax.devices("cpu")[0]))
    return stack


def memory(name: str, jitted, *args, **static) -> dict | None:
    """compiled.memory_analysis() of one kernel at the given shapes."""
    ma = jitted.lower(*args, **static).compile().memory_analysis()
    if ma is None:
        log(f"[mem] {name}: memory_analysis unavailable on this backend")
        return None
    out = {k: int(getattr(ma, k)) for k in
           ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")}
    log(f"[mem] {name}: " + ", ".join(f"{k.replace('_in_bytes', '')} "
                                      f"{v / 2**20:.2f} MiB"
                                      for k, v in out.items()))
    return out


def stage_a_features(wins) -> list:
    """Feature matrices of the windows that reach the EM (host POA)."""
    from svscope_tpu.engine import localgraph as lg
    _entries, ready = lg._stage_a(wins, "tumor", 3, 0.05, False, None)
    return [feat for (_, _, _, feat, _) in ready]


def soak_features(n: int = 120, seed: int = 7) -> list:
    """Randomized 4-40-read windows, the recipe of tests/test_mixture.py's
    label-parity soak (1-3 prototype haplotypes, 4% flips)."""
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(n):
        nr = int(rng.integers(4, 41))
        nf = int(rng.integers(12, 80))
        k_true = int(rng.integers(1, 4))
        protos = rng.integers(0, 4, (k_true, nf))
        x = protos[rng.integers(0, k_true, nr)]
        flip = rng.random(x.shape) < 0.04
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    return feats


def em_parity(feats: list) -> dict:
    """Folded EM (the localGraph labels-only dispatch) on the default
    device in float32 against the same code on the CPU device in float64:
    identical K and partitions, BIC of K=1 and the selected K within
    BIC_RTOL."""
    import jax.numpy as jnp
    from svscope_tpu.models import mixture as mx
    got = mx.em_cluster_batch_dispatch(feats, labels_only=True)()
    t0 = time.time()
    mx.em_cluster_batch_dispatch(feats, labels_only=True)()
    warm = time.time() - t0
    with _cpu_f64():
        ref = mx.em_cluster_batch_dispatch(feats, dtype=jnp.float64,
                                           labels_only=True)()
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g[0] == r[0], f"window {i}: K {g[0]} != reference {r[0]}"
        assert _partition(g[2]) == _partition(r[2]), \
            f"window {i}: partition differs from the float64 reference"
        ks = sorted({0, r[0] - 1})
        bg, br = np.asarray(g[6])[ks], np.asarray(r[6])[ks]
        assert np.isfinite(bg).all() and np.isfinite(br).all(), \
            f"window {i}: non-finite BIC"
        worst = max(worst, float((np.abs(bg - br) / np.abs(br)).max()))
    assert worst <= BIC_RTOL, f"BIC relative error {worst:.2e} > {BIC_RTOL}"
    return {"windows": len(feats), "max_bic_rel_err": worst,
            "warm_s": round(warm, 4)}


def em_memory(feats: list) -> dict | None:
    """memory_analysis of the folded-EM kernel at the (reads, features)
    bucket most windows of the set fall in."""
    import jax
    import jax.numpy as jnp
    from svscope_tpu.models import mixture as mx
    shapes = [(mx._bucket(x.shape[0], mx.READS_LADDER), mx._bucket(x.shape[1]))
              for x in feats]
    n_pad, nf_pad = max(set(shapes), key=shapes.count)
    b = mx._bucket(shapes.count((n_pad, nf_pad)), mx.BATCH_LADDER)
    sds = jax.ShapeDtypeStruct
    return memory(f"folded EM (B={b}, reads {n_pad}, feats {nf_pad})",
                  mx._em_folded_batch_light,
                  sds((b, n_pad, nf_pad), jnp.int8),
                  sds((b, mx.MAX_K, n_pad), jnp.int8),
                  sds((b,), jnp.int32), sds((b,), jnp.int32),
                  sds((b,), jnp.int32), sds((b,), jnp.float32),
                  sds((b, 2), jnp.uint32), nsteps=mx.NSTEP,
                  dtype=jnp.float32)


def _noisy(rng, s: str, n_edits: int) -> str:
    b = list(s)
    for _ in range(n_edits):
        p = int(rng.integers(1, len(b) - 1))
        op = int(rng.integers(0, 3))
        if op == 0:
            b[p] = str(rng.choice(list("ACGT")))
        elif op == 1:
            b.insert(p, str(rng.choice(list("ACGT"))))
        else:
            b.pop(p)
    return "".join(b)


def aligner_cases(n_windows: int, ref_len: int, n_reads: int, seed: int):
    """(graph, query) pairs: a native POA graph of a reference plus noisy
    reads (a third carrying an insertion, a quarter a deletion) and a
    query read carrying the insertion."""
    from svscope_tpu.native.poa import NativePoaGraph
    rng = np.random.default_rng(seed)
    cases = []
    for _ in range(n_windows):
        ref = "".join(rng.choice(list("ACGT"), ref_len))
        ins = "".join(rng.choice(list("ACGT"), max(ref_len // 20, 4)))
        m = ref_len // 2
        g = NativePoaGraph()
        g.add_sequence(ref)
        for r in range(n_reads):
            base = ref
            if r % 3 == 0:
                base = ref[:m] + ins + ref[m:]
            elif r % 4 == 1:
                base = ref[:m // 2] + ref[m // 2 + ref_len // 25:]
            g.add_sequence(_noisy(rng, base, 4))
        cases.append((g, _noisy(rng, ref[:m] + ins + ref[m:], 4)))
    return cases


def nw_score(chars, preds, sinks, n_nodes: int, seq: bytes) -> int:
    """Best NW score of seq against a packed graph (rank space), by the
    recurrence of ops/poa.PoaGraph.align in NumPy: the score reference for
    the device aligner.  It includes the leading graph gaps that the
    traceback (which stops at the first read base) does not emit."""
    from svscope_tpu.ops.poa_device import GAP, MATCH, MISMATCH
    s = np.frombuffer(seq, np.uint8)
    L = len(s)
    decay = GAP * np.arange(L + 1)
    H = np.empty((n_nodes + 1, L + 1), np.int64)
    H[0] = decay
    for i in range(n_nodes):
        rows = [p + 1 for p in preds[i] if p >= 0] or [0]
        maxpred = H[rows].max(axis=0)
        sub = np.where(s == chars[i], MATCH, MISMATCH)
        base = np.empty(L + 1, np.int64)
        base[0] = maxpred[0] + GAP
        base[1:] = np.maximum(maxpred[:-1] + sub, maxpred[1:] + GAP)
        H[i + 1] = np.maximum.accumulate(base - decay) + decay
    return int(H[1:, L][sinks[:n_nodes]].max())


def aligner_parity(cases, with_memory: bool = False) -> dict:
    """ops/poa_device.align_batch (the --device-poa xla route) against the
    native engine: identical alignments, and the device score equal to
    the NumPy recurrence's best score."""
    import jax
    from svscope_tpu.ops import poa_device as pdev
    from svscope_tpu.ops.poa_batch import L_LADDER, N_LADDER, _bucket
    nb = max(_bucket(g.n_nodes(), N_LADDER) for g, _ in cases)
    lb = max(_bucket(len(s), L_LADDER) for _, s in cases)
    packed = [g.pack(nb, pdev.MAX_PREDS) for g, _ in cases]
    assert all(p is not None for p in packed), "graph does not pack"
    B = len(cases)
    chars = np.stack([p[0] for p in packed])
    preds = np.stack([p[1] for p in packed])
    sinks = np.stack([p[2] for p in packed])
    nn = np.array([p[3] for p in packed], np.int32)
    seqs = np.zeros((B, lb), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, (_, s) in enumerate(cases):
        seqs[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        lens[i] = len(s)
    args = jax.device_put((chars, preds, sinks, nn, seqs, lens))
    jax.block_until_ready(pdev.align_batch(*args, lb))
    t0 = time.time()
    an, asp, ke, sc = jax.device_get(pdev.align_batch(*args, lb))
    warm = time.time() - t0
    for i, (g, s) in enumerate(cases):
        aln = pdev.unpack_alignment(an[i], asp[i], int(ke[i]), packed[i][4])
        assert aln == g.align_only(s), f"window {i}: alignment != host"
        score = nw_score(chars[i], preds[i], sinks[i], int(nn[i]), s.encode())
        assert int(sc[i]) == score, f"window {i}: score {sc[i]} != {score}"
    out = {"windows": B, "bucket": [nb, lb], "warm_s": round(warm, 4)}
    if with_memory:
        out["memory"] = memory(f"XLA POA aligner (B={B}, {nb} x {lb})",
                               pdev.align_batch, *args, l_max=lb)
    return out


def fused_parity(seq_lists, with_memory: bool = False) -> dict:
    """The fused on-device MSA build ('xla' engine) against the host C++
    engine: identical MSA rows and consensus."""
    import jax
    import jax.numpy as jnp
    from svscope_tpu.ops import poa_fused as pf
    from svscope_tpu.ops.poa_batch import poa_msa_batch
    got = pf.fused_msa_batch(seq_lists)
    t0 = time.time()
    pf.fused_msa_batch(seq_lists)
    warm = time.time() - t0
    ref = poa_msa_batch(seq_lists, use_device=False)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g[0] == r[0], f"window {i}: consensus != host engine"
        assert g[1] == r[1], f"window {i}: MSA != host engine"
    out = {"windows": len(seq_lists), "warm_s": round(warm, 4)}
    if with_memory:
        rb = pf._bucket(max(len(s) for s in seq_lists), pf.R_LADDER)
        lb = pf._bucket(max(len(x) for s in seq_lists for x in s),
                        pf.L_LADDER)
        nb = pf._bucket(max(pf._estimate_nodes(s) for s in seq_lists),
                        pf.N_LADDER)
        b = pf._bucket(len(seq_lists), pf.B_LADDER)
        sds = jax.ShapeDtypeStruct
        out["memory"] = memory(
            f"fused build (B={b}, R={rb}, L={lb}, N={nb})", pf._build_batch,
            sds((b, rb, lb), jnp.uint8), sds((b, rb), jnp.int32),
            sds((b,), jnp.int32), ncap=nb + 1, r_max=rb, l_max=lb)
    return out


def nw_pairs(n: int, lo: int, hi: int, seed: int) -> list:
    """(somatic, germline)-like consensus pairs: a sequence and a copy
    with noise and one indel."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        a = "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))
        m = len(a) // 2
        k = int(rng.integers(len(a) // 40, len(a) // 15)) + 1
        sv = "".join(rng.choice(list("ACGT"), k))
        b = a[:m] + sv + a[m:] if rng.random() < 0.5 else a[:m] + a[m + k:]
        pairs.append((a, _noisy(rng, b, len(b) // 50)))
    return pairs


def nw_parity(pairs, l_max: int, with_memory: bool = False) -> dict:
    """MisScore kernel ops/nw_batch.nw_stats_batch against the host DP
    ops/nw.nw_align_stats: (score, matches, align_len) exactly equal."""
    import jax
    from svscope_tpu.ops.nw import nw_align_stats
    from svscope_tpu.ops.nw_batch import nw_stats_batch
    B = len(pairs)
    ac = np.zeros((B, l_max), np.uint8)
    bc = np.zeros((B, l_max), np.uint8)
    la = np.zeros(B, np.int32)
    lb = np.zeros(B, np.int32)
    for k, (a, b) in enumerate(pairs):
        assert max(len(a), len(b)) <= l_max
        ac[k, :len(a)] = np.frombuffer(a.encode(), np.uint8)
        bc[k, :len(b)] = np.frombuffer(b.encode(), np.uint8)
        la[k], lb[k] = len(a), len(b)
    args = jax.device_put((ac, bc, la, lb))
    jax.block_until_ready(nw_stats_batch(*args, l_max))
    t0 = time.time()
    s, m, al = jax.device_get(nw_stats_batch(*args, l_max))
    warm = time.time() - t0
    for k, (a, b) in enumerate(pairs):
        assert nw_align_stats(a, b) == (int(s[k]), int(m[k]), int(al[k])), \
            f"pair {k}: NW stats differ from the host DP"
    out = {"pairs": B, "bucket": l_max, "warm_s": round(warm, 4)}
    if with_memory:
        out["memory"] = memory(f"MisScore NW (B={B}, L={l_max})",
                               nw_stats_batch, *args, l_max=l_max)
    return out


def forest_features(n: int, seed: int) -> np.ndarray:
    """RF inputs in the ranges the AlnFeature stage produces: z-scores,
    |MisScore|, chromosome-span and adapt ratios."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, 10))
    X[:, :4] = rng.normal(0, 2, (n, 4))
    X[:, 4] = rng.uniform(0, 300, n)
    X[:, 5:] = rng.uniform(0, 1.2, (n, 5))
    return X


def forest_parity(X, with_memory: bool = False) -> dict:
    """models/forest predict_proba on the default device (float32) against
    the same traversal on the CPU device in float64: identical classes,
    probabilities within FOREST_ATOL."""
    import jax
    from svscope_tpu.models import forest as fm
    f = fm.Forest.from_npz()
    p = f.predict_proba(X)
    t0 = time.time()
    p = f.predict_proba(X)
    warm = time.time() - t0
    with _cpu_f64():
        p_ref = fm.Forest.from_npz().predict_proba(X)
    assert (p.argmax(1) == p_ref.argmax(1)).all(), "forest classes differ"
    err = float(np.abs(p - p_ref).max())
    assert err <= FOREST_ATOL, f"forest proba error {err:.2e}"
    out = {"samples": len(X), "max_abs_err": err, "warm_s": round(warm, 4)}
    if with_memory:
        out["memory"] = memory(f"forest (n={len(X)})", fm._forest_proba,
                               *f._dev, jax.numpy.asarray(X),
                               max_depth=f.max_depth)
    return out


def phase2(rep: Report) -> None:
    import bench
    t0 = time.time()
    light = bench.make_window_payloads(128, np.random.default_rng(0))
    feats_light = stage_a_features(light)
    feats_heavy = stage_a_features(bench.heavy_payloads())
    for name, feats in (("em_bench_128x24", feats_light),
                        ("em_heavy_32x400", feats_heavy),
                        ("em_soak_120", soak_features())):
        r = em_parity(feats)
        r["memory"] = em_memory(feats)
        log(f"[phase2] {name}: {r}")
        rep.add("phase2", **{name: r})
    bench_cases = aligner_cases(32, 400, 12, seed=3)
    big_cases = aligner_cases(8, 1200, 8, seed=4)
    for name, cases in (("aligner_bench", bench_cases),
                        ("aligner_2048", big_cases)):
        r = aligner_parity(cases, with_memory=True)
        log(f"[phase2] {name}: {r}")
        rep.add("phase2", **{name: r})
    r = fused_parity([w.sequences for w in light[:32]], with_memory=True)
    log(f"[phase2] fused_bench_32x24: {r}")
    rep.add("phase2", fused_bench_32x24=r)
    for name, pairs, l_max in (("misscore_1024", nw_pairs(64, 600, 940, 5),
                                1024),
                               ("misscore_4096", nw_pairs(8, 2500, 4000, 6),
                                4096)):
        r = nw_parity(pairs, l_max, with_memory=True)
        log(f"[phase2] {name}: {r}")
        rep.add("phase2", **{name: r})
    r = forest_parity(forest_features(4096, 8), with_memory=True)
    log(f"[phase2] forest: {r}")
    rep.add("phase2", forest=r, seconds=round(time.time() - t0, 1))


# --------------------------------------------------------------------------
# phase 3: the CLI main path on the seeded genome
# --------------------------------------------------------------------------

class CompileCounter:
    """Backend compilations and their seconds, from JAX's monitoring
    events, between start() and stop()."""

    def __init__(self):
        import jax
        self.n, self.s, self.on = 0, 0.0, False
        jax.monitoring.register_event_duration_secs_listener(self._hear)

    def _hear(self, event: str, secs: float, **_kw) -> None:
        if self.on and event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.s += secs

    def start(self) -> None:
        self.n, self.s, self.on = 0, 0.0, True

    def stop(self) -> tuple[int, float]:
        self.on = False
        return self.n, self.s


def score_calls(vcf: str, classes: dict) -> tuple[float, float]:
    """(precision, recall) of a merged VCF against the planted truth, with
    tools/genome_bench's overlap rule."""
    import genome_bench as gb
    truth = [t for c in gb.TRUTH_CLASSES for t in classes[c]]
    calls = []
    for line in open(vcf):
        if line.startswith("#"):
            continue
        p = line.split("\t")
        info = dict(kv.split("=", 1) for kv in p[7].split(";") if "=" in kv)
        calls.append((p[0], int(p[1]), int(info.get("END", int(p[1]) + 1))))
    spans = [(t[0], t[1], t[2]) for t in truth]
    on_truth = sum(1 for c in calls if gb.overlaps(spans, c))
    tp = sum(1 for t in truth if gb.overlaps(calls, t))
    prec = on_truth / len(calls) if calls else 1.0
    return prec, tp / len(truth)


def run_cli(workdir: str, ref: str, tumor: str, normal: str,
            counter: CompileCounter, tag: str) -> dict:
    """DataPrepare --selectwindows --FullProcess + adjustVCF through
    cli.main, with the wall of each stage the CLI runs."""
    from svscope_tpu import cli
    savedir = os.path.join(workdir, tag)
    rep_bed = os.path.join(workdir, "repeats.bed")
    open(rep_bed, "w").close()           # no RepeatMasker track
    walls = {}

    def timed(name, fn):
        def wrapper(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                walls[name] = round(time.time() - t0, 2)
        return wrapper

    saved = cli.cmd_local_graph, cli.cmd_aln_feature
    cli.cmd_local_graph = timed("localGraph", cli.cmd_local_graph)
    cli.cmd_aln_feature = timed("AlnFeature", cli.cmd_aln_feature)
    counter.start()
    t0 = time.time()
    try:
        cli.main(["DataPrepare", "-D", rep_bed, "-T", tumor, "-N", normal,
                  "-t", "T1", "-n", "N1", "-r", ref, "-s", savedir,
                  "--selectwindows", "--FullProcess"])
        walls["DataPrepare_total"] = round(time.time() - t0, 2)
        t1 = time.time()
        adjusted = cli.main(["adjustVCF", "-s", savedir])
        walls["adjustVCF"] = round(time.time() - t1, 2)
    finally:
        cli.cmd_local_graph, cli.cmd_aln_feature = saved
        n_comp, s_comp = counter.stop()
    walls["scan+select"] = round(walls["DataPrepare_total"]
                                 - walls["localGraph"]
                                 - walls["AlnFeature"], 2)
    merged = os.path.join(savedir, "T1.mergedSomatic.vcf")
    assert os.path.exists(adjusted), "adjustVCF wrote nothing"
    return {"walls_s": walls, "compiles": n_comp,
            "compile_s": round(s_comp, 2), "merged_vcf": merged}


def phase3(rep: Report, mb_per_chrom: float = 5.0, n_chroms: int = 4,
           depth: int = 12) -> None:
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import genome_bench as gb
    counter = CompileCounter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
        t0 = time.time()
        ref, tumor, normal, classes = gb.build_genome(
            d, n_chroms, mb_per_chrom, depth, np.random.default_rng(11))
        synth = round(time.time() - t0, 1)
        log(f"[phase3] genome {n_chroms} x {mb_per_chrom} Mb, depth {depth}:"
            f" built in {synth} s")
        cold = run_cli(d, ref, tumor, normal, counter, "cold")
        warm = run_cli(d, ref, tumor, normal, counter, "warm")
        prec, rec = score_calls(warm["merged_vcf"], classes)
        same = open(cold["merged_vcf"]).read().split("#CHROM")[1] == \
            open(warm["merged_vcf"]).read().split("#CHROM")[1]
    log(f"[phase3] cold: {cold['walls_s']}, {cold['compiles']} compiles "
        f"({cold['compile_s']} s backend compile)")
    log(f"[phase3] warm: {warm['walls_s']}, {warm['compiles']} compiles")
    log(f"[phase3] merged VCF: precision {prec:.3f}, recall {rec:.3f} "
        f"(CPU run of the same seed: {CPU_PRECISION:.3f} / "
        f"{CPU_RECALL:.3f}); cold and warm calls identical: {same}")
    rep.add("phase3", synth_s=synth, cold=cold, warm=warm, precision=prec,
            recall=rec, cold_equals_warm=same)
    assert same, "cold and warm runs called different records"
    assert prec >= CPU_PRECISION and rec >= CPU_RECALL, \
        f"merged VCF P/R {prec:.3f}/{rec:.3f} below the CPU run's"


# --------------------------------------------------------------------------
# phase 4: times for the record (claims nothing)
# --------------------------------------------------------------------------

def phase4(rep: Report, engines=(False, "xla", "fused")) -> None:
    """Warm windows/s per POA engine (best of the trials after a warm-up
    pass), the light workload's A/B/C stage split, and the heavy tier's
    (the split for the host engine; a device engine's heavy stage A is a
    full per-read device build, as long as the whole pass)."""
    import bench
    light = bench.make_window_payloads(bench.N_WINDOWS,
                                       np.random.default_rng(0))
    for eng in engines:
        name = eng or "host"
        t0 = time.time()
        wps, trials = bench.measure_ours(light, device_poa=eng, n_trials=2)
        stages = bench.measure_stages(light, device_poa=eng)
        log(f"[phase4] light 256x24, POA {name}: {wps:.2f} w/s "
            f"(trials {trials}); stages {stages}")
        if eng:
            h_wps, h_trials = bench.measure_ours(bench.heavy_payloads(),
                                                 device_poa=eng, n_trials=1)
            heavy = {"w_per_s": round(h_wps, 3), "trial_s": h_trials}
        else:
            heavy = bench.measure_heavy_tier(device_poa=eng, n_trials=2)
        log(f"[phase4] heavy 32x400, POA {name}: {heavy}")
        rep.add("phase4", **{name: {"light_w_per_s": round(wps, 2),
                                    "light_trial_s": trials,
                                    "light_stages": stages,
                                    "heavy": heavy,
                                    "seconds": round(time.time() - t0, 1)}})


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh comparisons")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    rep = Report()
    card = card_or_exit()
    log(card)
    phase0_host(rep, card)
    if args.four_cards:
        dev = phase0_device(rep, want_count=4)
        import __graft_entry__ as ge
        for check in (ge.check_dp_records, ge.check_mp_em,
                      ge.check_sharded_em_step, ge.check_sp_wavefront):
            t0 = time.time()
            check(4)
            log(f"[four-cards] {check.__name__}(4): identical "
                f"({time.time() - t0:.1f} s)")
            rep.add("four_cards", **{check.__name__:
                                     round(time.time() - t0, 1)})
    else:
        phase1(rep)
        dev = phase0_device(rep)
        phase2(rep)
        phase3(rep)
        phase4(rep)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
