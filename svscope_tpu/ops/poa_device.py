"""Batched POA graph-vs-sequence alignment on the accelerator.

The reference's hot loop #1 is spoa's per-window partial-order alignment
(src/DataScanner.py:207,213 via pyspoa; SURVEY.md §3 ranks it first).  This
design makes *windows* the parallel axis: each round aligns the next
read of every window in one device call, the host fuses the resulting
alignments into its graphs (O(nodes+len) each), and the next round begins
— thousands of windows in flight, graph growth stays host-side where the
data structure mutation is cheap.

Device kernel (pure XLA, jitted):
  * graph: chars[N] int8, topological order implicit (rank == row), preds
    as a padded (N, P) rank matrix (-1 pad); sinks mask for NW termination
  * DP scanned over rows with the full H matrix carried and updated in
    place; predecessor rows fetched by gather; the intra-row gap
    H[i,j] = max(base[j], H[i,j-1]+g) is computed with an associative
    cummax over (base[j] - j*g)
  * NW semantics and scoring identical to ops/poa.py (m=5, n=-4, g=-8):
    best sink at the last column, traceback preferring
    match > graph-gap > seq-gap, predecessors in insertion order
  * traceback runs on device as a bounded fori_loop over gathered cells and
    returns compact (node, seq_pos) pairs (-1 gaps), so the big H/direction
    state never leaves the device

Parity with PoaGraph.align is exact because both implement the same
recurrence with the same tie-break order; tests/test_poa_pallas.py runs
this aligner against the native engine on randomized packed graphs, and
tests/test_engine.py covers it through the device-POA MSA path.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.jaxcfg import enable_cache

enable_cache()

from .poa import PoaGraph

MATCH = 5
MISMATCH = -4
GAP = -8
NEG = jnp.int32(-(2 ** 29))
MAX_PREDS = 8


def pack_graph(graph: PoaGraph, n_max: int, p_max: int = MAX_PREDS):
    """Pack a PoaGraph into padded arrays in topological-rank space."""
    order = graph.topo_order()
    n = len(order)
    if n > n_max:
        raise ValueError(f"graph has {n} nodes > bucket {n_max}")
    pos_of = {node: i for i, node in enumerate(order)}
    chars = np.zeros(n_max, np.int8)
    preds = np.full((n_max, p_max), -1, np.int32)
    is_sink = np.zeros(n_max, bool)
    node_of_rank = np.full(n_max, -1, np.int32)
    for i, node in enumerate(order):
        chars[i] = ord(graph.chars[node])
        node_of_rank[i] = node
        ps = graph.in_edges[node]
        if len(ps) > p_max:
            raise ValueError(f"node in-degree {len(ps)} > {p_max}")
        for k, p in enumerate(ps):
            preds[i, k] = pos_of[p]
        is_sink[i] = not graph.out_edges[node]
    return chars, preds, is_sink, np.int32(n), node_of_rank


def _align_one(chars, preds, is_sink, n_nodes, seq, seq_len, l_max: int):
    """DP + traceback for one (graph, sequence) pair.

    chars (N,) uint8 ascii codes; preds (N,P) rank indices; seq (L,) uint8.
    Returns (aln_nodes, aln_spos) of length n_max+l_max (padded -2)."""
    n_max, p_max = preds.shape
    jcol = jnp.arange(l_max + 1, dtype=jnp.int32)
    decay = GAP * jcol
    seq_mask = jcol[1:] <= seq_len          # valid seq positions 1..L

    h0 = jnp.where(jcol <= seq_len, GAP * jcol, NEG).astype(jnp.int32)
    H = jnp.full((n_max + 1, l_max + 1), NEG, jnp.int32)
    H = H.at[0].set(h0)

    def row(H, i):
        node_ok = i < n_nodes
        pr = preds[i]                        # (P,)
        has_pred = pr >= 0
        # predecessor rows (+1 for the virtual row); no preds -> row 0
        rows = jnp.where(has_pred, pr + 1, 0)
        P = H[rows]                          # (P, L+1)
        P = jnp.where(has_pred[:, None] | (jnp.arange(p_max) == 0)[:, None],
                      P, NEG)
        maxpred = P.max(axis=0)
        sub = jnp.where(seq == chars[i], MATCH, MISMATCH).astype(jnp.int32)
        base1 = jnp.maximum(maxpred[:-1] + sub, maxpred[1:] + GAP)
        base1 = jnp.where(seq_mask, base1, NEG)
        base = jnp.concatenate([(maxpred[0] + GAP)[None], base1])
        hrow = jax.lax.associative_scan(jnp.maximum, base - decay) + decay
        hrow = jnp.where(node_ok, hrow, NEG)
        return H.at[i + 1].set(hrow), None

    # STATIC trip count on purpose: a scan's carry updates at the shared
    # loop index stay aliased in place under vmap, whereas a dynamic
    # per-window fori lowers to a batched while whose done-mask select
    # touches the full (n_max+1, l_max+1) H every iteration — measured
    # far more expensive than the padded rows it avoids
    H, _ = jax.lax.scan(row, H, jnp.arange(n_max, dtype=jnp.int32))

    # best sink at column seq_len (rank order tie-break: first max)
    ends = jax.vmap(lambda r: r[seq_len])(H[1:])
    ends = jnp.where(is_sink & (jnp.arange(n_max) < n_nodes), ends, NEG)
    # explicit int32: argmax returns int64 under jax_enable_x64 and the
    # traceback carry must keep one integer type across cond branches
    best_i = (jnp.argmax(ends) + 1).astype(jnp.int32)
    seq_len = jnp.asarray(seq_len, jnp.int32)

    # traceback
    out_len = n_max + l_max
    aln_nodes = jnp.full(out_len, -2, jnp.int32)
    aln_spos = jnp.full(out_len, -2, jnp.int32)

    def tb_step(state):
        i, j, k, aln_nodes, aln_spos = state
        # default: finished (j == 0) handled by cond in while condition
        def when_virtual(_):
            return (i, j - 1, k - 1, aln_nodes.at[k].set(-1),
                    aln_spos.at[k].set(j - 1))

        def when_node(_):
            hij = H[i, j]
            pr = preds[i - 1]
            has_pred = pr >= 0
            rows = jnp.where(has_pred, pr + 1, 0)
            valid = has_pred | (jnp.arange(p_max) == 0)
            sub = jnp.where(seq[j - 1] == chars[i - 1], MATCH, MISMATCH)
            diag_ok = valid & (hij == H[rows, j - 1] + sub)
            up_ok = valid & (hij == H[rows, j] + GAP)
            any_diag = diag_ok.any()
            any_up = up_ok.any()
            first_diag = jnp.argmax(diag_ok)
            first_up = jnp.argmax(up_ok)

            def diag(_):
                p = rows[first_diag]
                return (p, j - 1, k - 1, aln_nodes.at[k].set(i - 1),
                        aln_spos.at[k].set(j - 1))

            def up(_):
                p = rows[first_up]
                return (p, j, k - 1, aln_nodes.at[k].set(i - 1),
                        aln_spos.at[k].set(-1))

            def left(_):
                return (i, j - 1, k - 1, aln_nodes.at[k].set(-1),
                        aln_spos.at[k].set(j - 1))

            return jax.lax.cond(any_diag, diag,
                                lambda _: jax.lax.cond(any_up, up, left, 0),
                                0)

        return jax.lax.cond(i == 0, when_virtual, when_node, 0)

    def tb_cond(state):
        i, j, k, _, _ = state
        return (j > 0) & (k >= 0)

    init = (best_i, seq_len, jnp.int32(out_len - 1), aln_nodes, aln_spos)
    _, _, k_end, aln_nodes, aln_spos = jax.lax.while_loop(tb_cond, tb_step,
                                                          init)
    return aln_nodes, aln_spos, k_end, H[best_i, seq_len]


@functools.partial(jax.jit, static_argnames=("l_max",))
def align_batch(chars, preds, is_sink, n_nodes, seqs, seq_lens, l_max: int):
    """vmapped graph-vs-seq alignment.

    chars (B, N); preds (B, N, P); is_sink (B, N); n_nodes (B,);
    seqs (B, L); seq_lens (B,).  Returns (aln_nodes, aln_spos, k_start,
    score) with alignments right-aligned in the output buffer."""
    return jax.vmap(_align_one, in_axes=(0, 0, 0, 0, 0, 0, None))(
        chars, preds, is_sink, n_nodes, seqs, seq_lens, l_max)


def unpack_alignment(aln_nodes, aln_spos, k_end, node_of_rank):
    """Device output -> [(node_id, seq_pos)] list in graph node ids."""
    out = []
    for r, s in zip(aln_nodes[int(k_end) + 1:], aln_spos[int(k_end) + 1:]):
        r, s = int(r), int(s)
        if r == -2:
            continue
        node = int(node_of_rank[r]) if r >= 0 else -1
        out.append((node, s))
    return out
