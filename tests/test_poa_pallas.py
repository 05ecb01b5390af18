"""Parity tests for the batched device POA aligner
(ops/poa_device.align_batch, the `--device-poa xla` route).

The aligner must produce the exact alignment (path, gaps, tie-breaks) of
the native C++ engine — itself parity-exact with the NumPy oracle — on
arbitrary packed POA graphs, unsharded and under a ("dp",) data mesh.
The gpu-marked case runs the compiled kernel on the card.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from svscope_tpu.native.poa import NativePoaGraph
from svscope_tpu.ops import poa_device as pdev


def _build_cases(rng, n_windows, read_len, n_reads, with_svs=True):
    graphs, seqs = [], []
    for w in range(n_windows):
        ref = "".join(rng.choice(list("ACGT"), read_len))
        ins = "".join(rng.choice(list("ACGT"), max(read_len // 6, 4)))
        g = NativePoaGraph()
        g.add_sequence(ref)
        for r in range(n_reads):
            base = ref
            if with_svs and r % 3 == 0:
                m = len(ref) // 2
                base = ref[:m] + ins + ref[m:]
            if with_svs and r % 4 == 1:
                m = len(ref) // 3
                base = ref[:m] + ref[m + read_len // 5:]
            b = list(base)
            for _ in range(4):
                p = int(rng.integers(0, max(len(b) - 1, 1)))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(list("ACGT")))
                elif op == 1:
                    b.insert(p, str(rng.choice(list("ACGT"))))
                elif len(b) > 2:
                    b.pop(p)
            g.add_sequence("".join(b))
        graphs.append(g)
        s = ref if w % 2 else ref[: len(ref) // 2] + ins + ref[len(ref) // 2:]
        seqs.append(s)
    return graphs, seqs


def _pack(graphs, seqs, nb, lb):
    packed = [g.pack(nb, 8) for g in graphs]
    assert all(p is not None for p in packed)
    chars = np.stack([p[0] for p in packed])
    preds = np.stack([p[1] for p in packed])
    sinks = np.stack([p[2] for p in packed])
    nn = np.array([p[3] for p in packed], np.int32)
    B = len(graphs)
    sq = np.zeros((B, lb), np.uint8)
    ln = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        sq[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        ln[i] = len(s)
    return packed, chars, preds, sinks, nn, sq, ln


def _align(chars, preds, sinks, nn, sq, ln, lb):
    return [np.array(x) for x in pdev.align_batch(
        jnp.asarray(chars), jnp.asarray(preds), jnp.asarray(sinks),
        jnp.asarray(nn), jnp.asarray(sq), jnp.asarray(ln), lb)]


def _assert_parity(graphs, seqs, packed, chars, preds, sinks, nn, sq, ln,
                   lb):
    an, asp, ke, _sc = _align(chars, preds, sinks, nn, sq, ln, lb)
    for i in range(len(packed)):
        got = pdev.unpack_alignment(an[i], asp[i], int(ke[i]), packed[i][4])
        assert graphs[i].align_only(seqs[i]) == got, \
            f"alignment mismatch window {i} vs native engine"


def test_pallas_parity_interpret():
    rng = np.random.default_rng(7)
    graphs, seqs = _build_cases(rng, 9, 40, 6)
    packed, *arrs = _pack(graphs, seqs, 128, 64)
    _assert_parity(graphs, seqs, packed, *arrs, 64)


def test_pallas_parity_chain_only():
    """Backbone-only graphs (every row has one predecessor, the previous
    rank); output must match the native engine exactly."""
    rng = np.random.default_rng(13)
    graphs, seqs = _build_cases(rng, 8, 40, 0)
    packed, *arrs = _pack(graphs, seqs, 64, 64)
    preds = arrs[1]
    assert (preds[:, 1:, 1] < 0).all(), "test premise: pure chains"
    _assert_parity(graphs, seqs, packed, *arrs, 64)


@pytest.mark.gpu
def test_pallas_parity_compiled_large():
    """The aligner compiled for the card, at the bench bucket (256 nodes x
    256 bp), against the native engine."""
    rng = np.random.default_rng(11)
    graphs, seqs = _build_cases(rng, 24, 150, 12)
    packed, *arrs = _pack(graphs, seqs, 256, 256)
    _assert_parity(graphs, seqs, packed, *arrs, 256)


def test_pallas_dp_mesh_parity_interpret():
    """align_batch over inputs sharded on a ("dp",) data mesh (GSPMD
    partitions the window axis): outputs identical to the unsharded
    call."""
    from svscope_tpu.parallel import dataparallel as dpm
    rng = np.random.default_rng(17)
    B, N, L = 64, 16, 20
    chars = rng.integers(65, 68, (B, N)).astype(np.uint8)
    preds = np.full((B, N, 8), -1, np.int32)
    preds[:, 1:, 0] = np.arange(N - 1)
    # a few branch rows so both predecessor shapes run
    preds[::3, 5, 1] = 2
    sinks = np.zeros((B, N), bool)
    sinks[:, -1] = True
    nn = np.full(B, N, np.int32)
    seqs = rng.integers(65, 68, (B, L)).astype(np.uint8)
    lens = np.full(B, L, np.int32)
    args = (chars, preds, sinks, nn, seqs, lens)
    base = [np.asarray(x) for x in pdev.align_batch(*args, L)]
    try:
        dpm.set_data_mesh(dpm.make_dp_mesh(8))
        dev = dpm.shard_batch(args)
        assert dpm.LAST_DISPATCH["n_shards"] == 8
        out = [np.asarray(x) for x in pdev.align_batch(*dev, L)]
    finally:
        dpm.set_data_mesh(None)
    for a, b in zip(base, out):
        assert (a == b).all()
