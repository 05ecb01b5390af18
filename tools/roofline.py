"""Kernel throughput measurements.

Measures, on the current host and JAX default device:
  * native C++ POA DP (single core and thread pool), against the AVX-512
    host bound per core (~0.28 cycles/cell @ 3 GHz, ~10 GCUPS)
  * the XLA scan aligner (GCUPS on the device, traceback included)
  * batched EM phasing (windows/s)
No device peak is quoted: a device roofline needs a peak table keyed by
`device_kind`, which the benchmark does not have yet.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def native_poa():
    from svscope_tpu.native.poa import NativePoaGraph, poa_msa_batch_native
    rng = np.random.default_rng(0)
    mk = lambda n: "".join(rng.choice(list("ACGT"), n))
    windows = []
    for _ in range(64):
        ref = mk(400)
        reads = []
        for _ in range(24):
            b = list(ref)
            for _ in range(5):
                p = int(rng.integers(1, len(b) - 1))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(list("ACGT")))
                elif op == 1:
                    b.insert(p, str(rng.choice(list("ACGT"))))
                else:
                    b.pop(p)
            reads.append("".join(b))
        windows.append([ref] + reads)
    # cells: sum over reads of nodes*len ~ 24 * 500 * 400 per window
    cells = 64 * 24 * 500 * 400
    poa_msa_batch_native(windows[:4])
    t0 = time.time()
    poa_msa_batch_native(windows, threads=1)
    dt1 = time.time() - t0
    t0 = time.time()
    poa_msa_batch_native(windows, threads=os.cpu_count())
    dtn = time.time() - t0
    return cells / dt1 / 1e9, cells / dtn / 1e9, 64 / dtn


def device_aligners():
    import jax
    import jax.numpy as jnp
    from svscope_tpu.ops import poa_device as pdev
    rng = np.random.default_rng(0)
    B, nb, lb, nn_true, sl = 256, 512, 512, 500, 450
    chars = rng.integers(65, 69, (B, nb)).astype(np.uint8)
    preds = np.full((B, nb, 8), -1, np.int32)
    for r in range(1, nb):
        preds[:, r, 0] = r - 1
    rs = rng.choice(np.arange(2, nb), int(0.15 * nb), replace=False)
    preds[:, rs, 1] = 0                     # 15% branch rows
    sinks = np.zeros((B, nb), bool)
    sinks[:, nn_true - 1] = True
    nn = np.full(B, nn_true, np.int32)
    seqs = rng.integers(65, 69, (B, lb)).astype(np.uint8)
    ln = np.full(B, sl, np.int32)
    cells = float(B) * nn_true * sl
    args = [jnp.asarray(a) for a in (chars, preds, sinks, nn, seqs, ln)]
    jax.device_get(pdev.align_batch(*args, lb))
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        jax.device_get(pdev.align_batch(*args, lb))
    return cells / ((time.time() - t0) / reps) / 1e9


def em_stage():
    from svscope_tpu.models.mixture import em_cluster_batch
    rng = np.random.default_rng(1)
    feats = []
    for _ in range(256):
        a = rng.integers(0, 4, (1, 100))
        b = (a + 1 + rng.integers(0, 3, (1, 100))) % 4
        x = np.concatenate([np.repeat(a, 16, 0), np.repeat(b, 16, 0)])
        flip = rng.random(x.shape) < 0.03
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    em_cluster_batch(feats)
    t0 = time.time()
    em_cluster_batch(feats)
    return 256 / (time.time() - t0)


def main():
    c1, cn, wps = native_poa()
    print(f"native C++ POA DP: {c1:.2f} GCUPS/core, {cn:.2f} GCUPS "
          f"({os.cpu_count()} threads), {wps:.0f} MSA windows/s "
          f"[host roofline ~10 GCUPS/core]")
    import jax
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    print(f"device POA (512 nodes x 450 bp x 256 windows, 15% branch rows): "
          f"XLA {device_aligners():.2f} GCUPS (traceback included)")
    print(f"EM phasing (32 reads x 100 cols, all K in [1,9] x 20 steps): "
          f"{em_stage():.0f} windows/s")


if __name__ == "__main__":
    main()
