"""Parity tests for the fully on-device POA MSA build (ops/poa_fused).

The fused path must be indistinguishable from ops.poa.poa — the repo's
spoa-semantics oracle for the reference's poa(seqs, 1) calls
(reference src/DataScanner.py:207,213; DecisionMaker.py:160,171) —
because `--device-poa fused` routes every window through it.  Shapes are kept to one or two (R, L, N) buckets so the CPU compile
cost stays bounded.
"""
import random

import numpy as np
import pytest

from svscope_tpu.ops.poa import poa
from svscope_tpu.ops.poa_fused import _estimate_nodes, fused_msa_batch


def mutate(rng, s, sub, ins, dele):
    out = []
    for ch in s:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(rng.choice("ACGT"))
        else:
            out.append(ch)
        if rng.random() < ins:
            out.append(rng.choice("ACGT"))
    return "".join(out)


def window(rng, nreads, L, div):
    """Tumor-like window: reference + reads, half carrying an insertion."""
    ref = "".join(rng.choice("ACGT") for _ in range(L))
    sv = "".join(rng.choice("ACGT") for _ in range(rng.randint(4, 12)))
    reads = []
    for i in range(nreads - 1):
        base = ref[:L // 2] + sv + ref[L // 2:] if i % 2 == 0 else ref
        reads.append(mutate(rng, base, div, div / 2, div / 2))
    return [ref] + reads


def test_edge_cases_exact():
    windows = [
        ["ACGT"],                      # single sequence
        ["ACGT", "ACGT", "ACGT"],      # identical reads
        ["ACGT", "", "AGT"],           # empty read mid-window
        ["", "ACGTA"],                 # graph inits on the second read
        ["A", "T"],                    # single-base divergence
        ["ACGTACGT", "TGCATGCA"],      # fully divergent pair
        [],                            # no reads at all
        ["", ""],                      # only empty reads
    ]
    got = fused_msa_batch(windows)
    for seqs, g in zip(windows, got):
        assert g == poa(seqs, 1), seqs


def test_randomized_windows_exact():
    rng = random.Random(20260820)
    windows = [window(rng, rng.randint(3, 8), rng.randint(10, 60),
                      rng.choice([0.02, 0.1, 0.3]))
               for _ in range(25)]
    got = fused_msa_batch(windows)
    for i, seqs in enumerate(windows):
        exp = poa(seqs, 1)
        assert got[i] == exp, f"window {i}: {seqs}"


def test_msa_invariants():
    rng = random.Random(7)
    windows = [window(rng, 6, 50, 0.1) for _ in range(4)]
    for seqs, (cons, rows) in zip(windows, fused_msa_batch(windows)):
        assert len(rows) == len(seqs)
        assert len({len(r) for r in rows}) == 1
        for s, r in zip(seqs, rows):
            assert r.replace("-", "") == s
        assert len(cons) > 0


def test_overflow_falls_back_to_host():
    # force a node-bucket overflow: highly divergent long reads make the
    # graph approach sum-of-lengths, far past the _estimate_nodes guess
    rng = random.Random(3)
    seqs = ["".join(rng.choice("ACGT") for _ in range(60))
            for _ in range(16)]
    assert _estimate_nodes(seqs) < 16 * 60   # the estimate CAN overflow
    got = fused_msa_batch([seqs])
    assert got[0] == poa(seqs, 1)            # fallback keeps exactness


def test_fast_toposort_matches_reference_kahn():
    """The batched-prefix placement must reproduce the one-group-at-a-time
    Kahn order exactly, on graph states from real fused builds."""
    import jax
    import jax.numpy as jnp
    from svscope_tpu.ops import poa_fused as pf

    rng = random.Random(99)
    # synthetic DAG states: random chains with random forward edges and
    # random aligned-group structure (the full-build states are covered
    # transitively by the oracle-parity tests above, whose MSA column
    # order and alignment tie-breaks depend on the sort)
    for trial in range(30):
        n = rng.randint(2, 60)
        ncap = 64
        pred_node = np.full((ncap, pf.MAX_PREDS), -1, np.int32)
        group_min = np.arange(ncap, dtype=np.int32)
        for v in range(1, n):
            pred_node[v, 0] = v - 1          # chain backbone
        for _ in range(rng.randint(0, 10)):  # extra forward edges
            a = rng.randint(0, n - 2)
            b = rng.randint(a + 1, n - 1)
            row = pred_node[b]
            if (row == a).any():
                continue
            free = np.flatnonzero(row < 0)
            if free.size:
                pred_node[b, free[0]] = a
        for _ in range(rng.randint(0, 6)):   # aligned columns
            a = rng.randint(0, n - 2)
            b = rng.randint(a + 1, n - 1)
            if group_min[b] == b and group_min[a] == a:
                group_min[b] = a
        fast = jax.jit(lambda p, g, nn: pf._toposort(p, g, nn, ncap))(
            pred_node, group_min, np.int32(n))
        ref = jax.jit(lambda p, g, nn: pf._toposort_ref(p, g, nn, ncap))(
            pred_node, group_min, np.int32(n))
        f_order, f_rank, f_cyc = map(np.asarray, fast)
        r_order, r_rank, r_cyc = map(np.asarray, ref)
        assert bool(f_cyc) == bool(r_cyc), trial
        if not r_cyc:
            assert (f_order[:n] == r_order[:n]).all(), trial
            assert (f_rank[:n] == r_rank[:n]).all(), trial


@pytest.mark.parametrize("n_shards", [2, 4])
def test_dispatch_build_pallas_shards_under_mesh(n_shards):
    """With a dp mesh installed, the fused build's window axis shards over
    the mesh (GSPMD partitions the XLA program along windows) and the
    output is identical to the unsharded build and to the oracle."""
    from svscope_tpu.parallel import dataparallel as dpm

    rng = random.Random(17)
    windows = [window(rng, 4, 24, 0.05) for _ in range(8)]
    base = fused_msa_batch(windows)
    try:
        dpm.set_data_mesh(dpm.make_dp_mesh(n_shards))
        got = fused_msa_batch(windows)
        assert dpm.LAST_DISPATCH["sharded"] and \
            dpm.LAST_DISPATCH["n_shards"] == n_shards
    finally:
        dpm.set_data_mesh(None)
    assert got == base
    for seqs, g in zip(windows, got):
        assert g == poa(seqs, 1)


def test_non_acgtn_bases_fall_back():
    # the device build encodes ACGTN only; other characters (IUPAC codes)
    # must transparently route to the host engine with identical output
    seqs = ["ACGRTACGT", "ACGRTACT", "ACGRTAGGT"]
    got = fused_msa_batch([seqs])
    assert got[0] == poa(seqs, 1)
