"""Fully on-device POA MSA build: graph fusion as a jitted device program.

The per-round device POA path (ops/poa_batch._device_round) pays one
host<->device round trip per read: pack graphs, align the round's reads on
the device, fetch alignments, fuse on the host in C++.  With R rounds per
window batch, that dispatch chain — not the DP kernel — can dominate the
device path (docs/PERF.md).

This module removes the round trips: the ENTIRE iterative MSA build —
group-aware topological re-ranking, graph-vs-read NW alignment, and graph
fusion, for every read round — runs as ONE jitted XLA program, vmapped
over windows.  Host touches the device exactly twice per window batch:
one device_put of the encoded reads and one device_get of the final graph
(chars, groups, per-read node paths, consensus walk).  Everything the
reference's hot loop #1 does per window (spoa's poa(seqs, 1),
src/DataScanner.py:207,213 and src/DecisionMaker.py:160,171) happens on
the accelerator with *windows* as the parallel axis.

Semantics are identical to ops/poa.poa (the spoa-parity NumPy oracle) and
the C++ engine — same scoring (m=5, n=-4, g=-8), the same group-aware
Kahn order (aligned columns adjacent, min-group-id heap), the same
fusion rules (first matching column member in insertion order), and the
same consensus tie-breaks (first-max in-edge per slot order, first-max
score node in rank order, earliest-created out-edge among (weight, score)
maxima) — tested row-for-row in tests/test_poa_fused.py.

Device-side data layout per window (node-id space, padded to `ncap` rows
with row ncap-1 as a write sink for masked updates; bases are 5-letter
codes ACGTN -> 0..4, other characters fall back to the host engine):

  chars      (ncap,)    node base code
  pred_node  (ncap, P)  in-edge tails in insertion order (-1 pad)
  pred_w     (ncap, P)  in-edge weights
  pred_t     (ncap, P)  in-edge creation stamps (out-edge insertion order)
  group_char (ncap, 5)  per COLUMN id: the member node carrying each base
                        (column members have distinct bases by
                        construction, so matching is one gather)
  group_min  (ncap,)    column id == smallest member node id
  path       (R, L)     per (read, base) fused node id (MSA row source)

Fusion of one alignment is fully VECTORIZED (no per-entry loop): within a
round the fused nodes are pairwise distinct (an intra-column edge can
never arise, so an alignment never revisits a column), hence matching,
node allocation (first entry per (column, base) key creates, later ones
reuse), edge appends (at most one new in-edge per node per round) and
path writes are one-shot segment/cumsum ops plus unique-index scatters.

Windows whose graph outgrows the bucket (nodes, in-degree > P, or a
would-be cycle) raise a per-window overflow flag and are transparently
re-run on the host C++ engine.
"""
from __future__ import annotations

import functools
import logging

import numpy as np
import jax
import jax.numpy as jnp

from ..parallel.dataparallel import shard_batch
from ..utils.jaxcfg import enable_cache

enable_cache()

from .poa_device import MAX_PREDS, _align_one

log = logging.getLogger("svscope_tpu.poa_fused")

ALPHA5 = 5               # base codes: ACGTN -> 0..4
CODE_OF = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGTN"):
    CODE_OF[_b] = _i
DECODE = np.frombuffer(b"ACGTN", np.uint8)
BIG = np.int32(1 << 30)
R_LADDER = (4, 8, 16, 32, 64, 128, 256, 512)
N_LADDER = (128, 256, 512, 1024, 2048, 3072)
L_LADDER = (64, 128, 256, 512, 1024, 2048)
B_LADDER = (8, 32, 128, 256)
# cap on the alignment DP's (B, ncap+1, L+1) int32 H matrix
H_BYTES_CAP = 1 << 30


def _toposort_ref(pred_node, group_min, n_nodes, ncap: int):
    """Group-aware Kahn order, identical to PoaGraph.topo_order: aligned
    columns emit adjacently (members in node-id order), groups selected by
    smallest group id among the ready set.  Returns (order, rank, cyclic):
    order = node ids in rank order (inactive ids trailing).

    Literal one-group-per-iteration transcription — the oracle for
    _toposort's batched-prefix placement (see tests/test_poa_fused.py)."""
    ids = jnp.arange(ncap, dtype=jnp.int32)
    active = ids < n_nodes
    pnc = jnp.clip(pred_node, 0, ncap - 1)
    pg = group_min[pnc]
    own = group_min[:, None]

    def cond(st):
        placed, _rank, _pos, it = st
        return jnp.any(~placed) & (it < ncap)

    def body(st):
        placed, rank, pos, it = st
        # a node is unblocked when every pred is placed or in its own group
        pok = (pred_node < 0) | placed[pnc] | (pg == own)
        node_ok = jnp.all(pok, axis=1).astype(jnp.int32)
        grp_ok = jax.ops.segment_min(node_ok, group_min, num_segments=ncap)
        selectable = active & ~placed & (grp_ok[group_min] > 0)
        gsel = jnp.min(jnp.where(selectable, group_min, BIG))
        chosen = selectable & (group_min == gsel)
        idx = jnp.cumsum(chosen, dtype=jnp.int32) - 1
        rank = jnp.where(chosen, pos + idx, rank)
        pos = pos + jnp.sum(chosen, dtype=jnp.int32)
        return placed | chosen, rank, pos, it + 1

    placed0 = ~active
    rank0 = jnp.full((ncap,), BIG, jnp.int32)
    placed, rank, _pos, _it = jax.lax.while_loop(
        cond, body, (placed0, rank0, jnp.int32(0), jnp.int32(0)))
    cyclic = jnp.any(~placed)
    order = jnp.argsort(rank).astype(jnp.int32)   # stable: id order on ties
    return order, rank, cyclic


def _toposort(pred_node, group_min, n_nodes, ncap: int):
    """_toposort_ref's exact order with batched placement: each iteration
    places the maximal gid-consecutive RUN of groups instead of one group.

    Kahn with a min-gid heap picks group g* = min ready gid, then the next
    pick is again the min ready gid, and so on.  Claim: the whole prefix
    {unplaced groups g >= g* in gid order whose unplaced blockers all lie
    in [g*, g)} is placed consecutively in gid order by sequential Kahn.
    Proof sketch: the prefix contains EVERY unplaced group in the gid
    interval, so each element's blockers are earlier prefix members; by
    induction element i is ready at its turn and is the minimum (all
    smaller unplaced gids are already placed; groups outside the prefix
    are > it).  Any group newly readied mid-prefix has gid outside
    [g*, prefix end] and cannot preempt.  A backbone chain therefore
    places in ONE iteration (iterations ~ #order-violating back edges —
    fusion-created nodes with edges into smaller-gid columns — instead of
    #groups)."""
    ids = jnp.arange(ncap, dtype=jnp.int32)
    active = ids < n_nodes
    is_grp = active & (group_min == ids)          # column founders
    pnc = jnp.clip(pred_node, 0, ncap - 1)
    tails_g = group_min[pnc]                      # (ncap, P) blocker gids
    heads_g = jnp.broadcast_to(group_min[:, None], tails_g.shape)
    ev_static = (pred_node >= 0) & active[:, None] & (tails_g != heads_g)
    iota = ids
    # Group-level blocker MATRIX, built once per call: Mblk[b, h] = 1 iff
    # some edge makes group b a blocker of group h.  The while body then
    # computes per-group min/max UNPLACED blocker gids as masked
    # (ncap, ncap) sweeps — pure vector streaming with NO gathers, scatters
    # or segment ops in the loop.  The previous formulations (per-
    # iteration segment_min over the edge list, then a member-table
    # gather) serialized every one of a real build's ~1,700 sort
    # iterations on gathers, which made the canonical re-rank most of the
    # whole on-device build (docs/PERF.md §2-10); the sweep form costs the
    # one-time scatter below plus a streaming pass per iteration.
    Mblk = jnp.zeros((ncap, ncap), jnp.int8)
    Mblk = Mblk.at[tails_g.ravel(), heads_g.ravel()].max(
        ev_static.ravel().astype(jnp.int8))
    Mblk = Mblk > 0
    # BIT-PACK the blocker axis: the while body's min/max sweeps read the
    # whole (ncap, ncap) matrix per iteration — 67 MB per 64-window batch,
    # ~50 iterations/round.  Packing blockers into uint32 words cuts the
    # per-iteration traffic 32x; per-word min/max blocker gids come from
    # clz of the word (and of its lowest set bit).
    nw = -(-ncap // 32)
    pad_b = nw * 32 - ncap
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (jnp.pad(Mblk, ((0, pad_b), (0, 0))).astype(jnp.uint32)
            .reshape(nw, 32, ncap) << shifts[None, :, None]
            ).sum(axis=1, dtype=jnp.uint32)       # (nw, ncap)
    widx32 = jnp.arange(nw, dtype=jnp.int32)[:, None] * 32

    def cond(st):
        grp_placed, _itp, it, stuck = st
        return jnp.any(is_grp & ~grp_placed) & ~stuck & (it < ncap)

    def step(st):
        grp_placed, it_placed, it, stuck = st
        upw = (jnp.pad(~grp_placed, (0, pad_b)).astype(jnp.uint32)
               .reshape(nw, 32) << shifts[None, :]
               ).sum(axis=1, dtype=jnp.uint32)    # packed unplaced mask
        act = bits & upw[:, None]                 # (nw, ncap) uint32
        nz = act != jnp.uint32(0)
        # highest/lowest set bit per word via clz (clz(0)=32 -> masked)
        hb = 31 - jax.lax.clz(act.astype(jnp.int32))
        low = act & (~act + jnp.uint32(1))        # x & -x
        lb = 31 - jax.lax.clz(low.astype(jnp.int32))
        bmax = jnp.max(jnp.where(nz, widx32 + hb, -1), axis=0)
        bmin = jnp.min(jnp.where(nz, widx32 + lb, BIG), axis=0)
        unplaced = is_grp & ~grp_placed
        ready = unplaced & (bmax < 0)
        gstar = jnp.min(jnp.where(ready, ids, BIG))
        C = unplaced & ((bmax < 0) | ((bmin >= gstar) & (bmax < ids)))
        transparent = ~unplaced | (ids < gstar)
        # prefix-AND as a single min-reduction: chain_ok(g) <=> no
        # failing index <= g <=> g < first failing index (the cumprod
        # scan this replaces lowered to ~10 sub-kernels per iteration)
        first_fail = jnp.min(jnp.where(C | transparent, BIG, ids))
        place_g = unplaced & (ids >= gstar) & C & (ids < first_fail)
        # record the placement ITERATION per GROUP; the node-level
        # expansion (a (ncap,) gather) runs ONCE after the loop — the
        # in-loop per-iteration gather was the body's dominant cost
        # (gathers inside while loops serialize)
        it_placed = jnp.where(place_g, it, it_placed)
        cnt = jnp.sum(place_g, dtype=jnp.int32)
        return (grp_placed | place_g, it_placed, it + 1, cnt == 0)

    # (a 2-step unroll of the Kahn body was tried and reverted: it was
    # slower — iterations are sweep-work-bound, not loop-overhead-bound,
    # so the unroll only added tail waste)
    st0 = (jnp.zeros((ncap,), bool), jnp.full((ncap,), BIG, jnp.int32),
           jnp.int32(0), jnp.bool_(False))
    grp_placed, it_g, _it, _stuck = jax.lax.while_loop(cond, step, st0)
    cyclic = jnp.any(is_grp & ~grp_placed)
    it_placed = it_g[group_min]               # group -> node, one gather
    # lexicographic (iteration, gid, id): iterations and gids fit one
    # int32 key (ncap <= 3074 -> it*ncap+gid < 2^24); stable argsort
    # breaks the remaining ties by node id — exactly members-in-id-order
    placed_node = active & grp_placed[group_min] & (it_placed < BIG)
    key = jnp.where(placed_node, it_placed * ncap + group_min, BIG)
    order = jnp.argsort(key).astype(jnp.int32)
    rank = jnp.zeros((ncap,), jnp.int32).at[order].set(iota)
    return order, rank, cyclic


def _ranked_view(chars, pred_node, n_nodes, order, rank, ncap: int):
    """Rank-space packed graph for the aligner: chars/preds/sinks with
    row == topological rank (ops/poa_device.pack_graph equivalent)."""
    chars_r = chars[order]
    pn = pred_node[order]
    preds_r = jnp.where(pn >= 0, rank[jnp.clip(pn, 0, ncap - 1)], -1)
    valid_rows = (jnp.arange(ncap, dtype=jnp.int32) < n_nodes)[:, None]
    vals = ((pred_node >= 0) & valid_rows).astype(jnp.int32).ravel()
    outdeg = jax.ops.segment_sum(
        vals, jnp.clip(pred_node, 0, ncap - 1).ravel(), num_segments=ncap)
    sink_r = (outdeg == 0)[order]
    return chars_r, preds_r, sink_r


def _fuse_alignment(aln_nodes, aln_spos, order, seq, chars, pred_node,
                    pred_w, pred_t, group_char, group_min, n_nodes, t_ctr,
                    overflow, *, ncap: int, l_max: int):
    """Vectorized fusion of one window's alignment into its graph state.

    No per-entry loop: within a round the fused nodes are pairwise
    distinct (an intra-column edge cannot arise, so an alignment never
    revisits a column), hence matching, allocation, edge appends and path
    writes are one-shot segment/cumsum ops plus unique-index scatters.
    Returns the new state plus the read's (l_max,) node path."""
    P = MAX_PREDS
    out_len = ncap + l_max
    trash = ncap - 1
    n_max = ncap - 1
    kk = jnp.arange(out_len, dtype=jnp.int32)
    KEYCAP = ncap * ALPHA5

    valid = aln_spos >= 0               # real base entries (pads -2,
    sposc = jnp.clip(aln_spos, 0, l_max - 1)      # graph-gaps -1 skip)
    c5 = seq[sposc]                     # (out_len,) base codes
    node = jnp.where(valid & (aln_nodes >= 0),
                     order[jnp.clip(aln_nodes, 0, ncap - 1)], -1)
    gid = group_min[jnp.clip(node, 0, ncap - 1)]
    # match = the column member carrying this base (distinct bases per
    # column => membership is all that matters, not scan order)
    pre = jnp.where(node >= 0,
                    group_char[jnp.clip(gid, 0, ncap - 1), c5], -1)
    matched = valid & (pre >= 0)
    isnew = valid & ~matched
    join = isnew & (node >= 0)          # joins an existing column
    # first entry per (column, base) key creates the node; later
    # entries of the same key reuse it (the host scan's behavior when
    # a same-round node already joined the column)
    keyc = jnp.where(join, gid * ALPHA5 + c5, KEYCAP)
    firstk = jax.ops.segment_min(jnp.where(join, kk, BIG), keyc,
                                 num_segments=KEYCAP + 1)
    is_first = join & (firstk[keyc] == kk)
    creator = is_first | (isnew & (node < 0))
    new_idx = jnp.cumsum(creator, dtype=jnp.int32) - 1
    n_new = jnp.sum(creator, dtype=jnp.int32)
    ovf_n = n_nodes + n_new > n_max
    cur_created = jnp.clip(n_nodes + new_idx, 0, trash)
    id_of_key = jnp.full((KEYCAP + 1,), trash, jnp.int32)
    id_of_key = id_of_key.at[jnp.where(is_first, keyc, KEYCAP)].set(
        cur_created, unique_indices=True)
    cur = jnp.where(matched, pre,
                    jnp.where(creator, cur_created, id_of_key[keyc]))
    cur = jnp.where(valid, cur, -1)
    # prev chain: the previous valid entry's node
    lastk = jax.lax.cummax(jnp.where(valid, kk, -1))
    lastk = jnp.concatenate([jnp.full((1,), -1, jnp.int32), lastk[:-1]])
    prev = jnp.where(lastk >= 0, cur[jnp.clip(lastk, 0, out_len - 1)], -1)
    add_e = valid & (prev >= 0)
    curc = jnp.clip(cur, 0, ncap - 1)
    # edge prev->cur: all fused nodes of one round are distinct, so at
    # most ONE new in-edge lands per node — scatter rows are unique
    slots = pred_node[curc]             # (out_len, P) pre-round rows
    ehit = slots == prev[:, None]
    has_e = add_e & jnp.any(ehit, axis=1)
    eslot = jnp.argmax(ehit, axis=1).astype(jnp.int32)[:, None]
    nvalid = jnp.sum(slots >= 0, axis=1, dtype=jnp.int32)
    ovf_e = add_e & ~has_e & (nvalid >= P)
    wslot = jnp.where(has_e, eslot[:, 0], jnp.clip(nvalid, 0, P - 1))
    newe = add_e & ~has_e & ~ovf_e
    ew_old = jnp.take_along_axis(pred_w[curc], eslot, 1)[:, 0]
    et_old = jnp.take_along_axis(pred_t[curc], eslot, 1)[:, 0]
    wval = jnp.where(has_e, ew_old + 1, 1)
    tval = jnp.where(has_e, et_old,
                     t_ctr + jnp.cumsum(newe, dtype=jnp.int32) - 1)
    # unique_indices: real rows are pairwise distinct (distinct cur
    # per round); masked entries all collapse onto the trash row,
    # whose content is never read — racing writes there are harmless
    erow = jnp.where(add_e & ~ovf_e, curc, trash)
    pred_node = pred_node.at[erow, wslot].set(
        jnp.where(add_e, prev, -1), unique_indices=True)
    pred_w = pred_w.at[erow, wslot].set(wval, unique_indices=True)
    pred_t = pred_t.at[erow, wslot].set(tval, unique_indices=True)
    t_ctr = t_ctr + jnp.sum(newe, dtype=jnp.int32)
    # new node init (unique ids; (column, base) keys unique)
    nrow = jnp.where(creator, cur_created, trash)
    chars = chars.at[nrow].set(c5, unique_indices=True)
    new_gid = jnp.where(node >= 0, gid, cur_created)
    group_min = group_min.at[nrow].set(new_gid, unique_indices=True)
    gcrow = jnp.where(creator, jnp.clip(new_gid, 0, ncap - 1), trash)
    group_char = group_char.at[gcrow, c5].set(cur_created,
                                              unique_indices=True)
    # bookkeeping (alignment seq positions are unique)
    path_row = jnp.full((l_max + 1,), -1, jnp.int32)
    path_row = path_row.at[jnp.where(valid, sposc, l_max)].set(
        cur, unique_indices=True)
    n_nodes = jnp.minimum(n_nodes + n_new, jnp.int32(n_max))
    overflow = overflow | ovf_n | jnp.any(ovf_e)
    return (chars, pred_node, pred_w, pred_t, group_char, group_min,
            n_nodes, t_ctr, overflow, path_row[:l_max])


def _build_batch_impl(seqs, lens, n_seqs, ncap: int, r_max: int,
                      l_max: int):
    """Batch-level build: one round loop over the whole window batch, each
    round's re-rank, alignment and fusion vmapped over windows."""
    B = seqs.shape[0]
    out_len = ncap + l_max
    kk = jnp.arange(out_len, dtype=jnp.int32)[None, :]
    sortv = jax.vmap(lambda p, g, n: _toposort(p, g, n, ncap))
    viewv = jax.vmap(
        lambda c, p, n, o, rk: _ranked_view(c, p, n, o, rk, ncap))
    fusev = jax.vmap(
        functools.partial(_fuse_alignment, ncap=ncap, l_max=l_max))
    alignv = jax.vmap(
        lambda c, p, s, n, q, sl: _align_one(c, p, s, n, q, sl, l_max))

    def round_body(r, st):
        (chars, pred_node, pred_w, pred_t, group_char, group_min, n_nodes,
         t_ctr, overflow, path) = st
        seq = seqs[:, r].astype(jnp.int32)          # (B, l_max)
        slen = lens[:, r]                           # (B,)
        order, rank, cyclic = sortv(pred_node, group_min, n_nodes)
        chars_r, preds_r, sink_r = viewv(chars, pred_node, n_nodes, order,
                                         rank)
        empty = n_nodes == 0
        # empty read OR empty graph: zero rows/columns -> immediate exit
        slen_eff = jnp.where(empty, 0, slen)
        n_eff = jnp.where(slen > 0, n_nodes, 0)
        aln_nodes, aln_spos, _k, _s = alignv(chars_r, preds_r, sink_r,
                                             n_eff, seq, slen_eff)
        # empty graph: the "alignment" is all-gap — fusing it IS chain init
        g0 = (out_len - slen)[:, None]
        use_gap = (empty & (slen > 0))[:, None]
        aln_nodes = jnp.where(use_gap, jnp.where(kk >= g0, -1, -2),
                              aln_nodes)
        aln_spos = jnp.where(use_gap, jnp.where(kk >= g0, kk - g0, -2),
                             aln_spos)
        overflow = overflow | cyclic
        (chars, pred_node, pred_w, pred_t, group_char, group_min, n_nodes,
         t_ctr, overflow, path_row) = fusev(
            aln_nodes, aln_spos, order, seq, chars, pred_node, pred_w,
            pred_t, group_char, group_min, n_nodes, t_ctr, overflow)
        path = path.at[:, r].set(path_row)
        return (chars, pred_node, pred_w, pred_t, group_char, group_min,
                n_nodes, t_ctr, overflow, path)

    P = MAX_PREDS
    st0 = (jnp.zeros((B, ncap), jnp.int32),
           jnp.full((B, ncap, P), -1, jnp.int32),
           jnp.zeros((B, ncap, P), jnp.int32),
           jnp.zeros((B, ncap, P), jnp.int32),
           jnp.full((B, ncap, ALPHA5), -1, jnp.int32),
           jnp.broadcast_to(jnp.arange(ncap, dtype=jnp.int32),
                            (B, ncap)),
           jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32),
           jnp.zeros((B,), bool),
           jnp.full((B, r_max, l_max), -1, jnp.int32))
    rounds = jnp.max(jnp.asarray(n_seqs, jnp.int32))
    (chars, pred_node, pred_w, pred_t, group_char, group_min, n_nodes,
     t_ctr, overflow, path) = jax.lax.fori_loop(
        jnp.int32(0), rounds, round_body, st0)
    order, _rank, cyclic = sortv(pred_node, group_min, n_nodes)
    overflow = overflow | cyclic
    consv = jax.vmap(
        lambda c, pn, pw, pt, nn, o: _consensus_walk(c, pn, pw, pt, nn, o,
                                                     ncap))
    back_buf, back_start, fwd_buf, fwd_cnt = consv(
        chars, pred_node, pred_w, pred_t, n_nodes, order)
    return (chars, group_min, n_nodes, path, order, back_buf, back_start,
            fwd_buf, fwd_cnt, overflow)


def _consensus_walk(chars, pred_node, pred_w, pred_t, n_nodes, order,
                    ncap: int):
    """Heaviest-bundle consensus node path (PoaGraph.consensus semantics):
    scan scores in rank order, walk back over best in-edges from the
    first max-score node, extend forward over heaviest out-edges."""
    P = MAX_PREDS
    ids = jnp.arange(ncap, dtype=jnp.int32)
    valid_e = (pred_node >= 0) & (ids[:, None] < n_nodes)
    pnc = jnp.clip(pred_node, 0, ncap - 1)

    # ---- score/best_in scan in rank order ----
    # lexicographic (weight, tail score) with first-max slot tie-break;
    # weight <= n_seqs (<=2^10), score <= sum of path weights (<2^21)
    def sc_step(carry, i):
        score, best_in = carry
        v = order[i]
        vc = jnp.clip(v, 0, ncap - 1)
        vmask = valid_e[vc]
        sc = score[pnc[vc]]
        key = jnp.where(vmask, pred_w[vc] * (1 << 21) + sc, -1)
        b = jnp.argmax(key).astype(jnp.int32)
        has = jnp.any(vmask)
        score = score.at[vc].set(jnp.where(has, pred_w[vc, b] + sc[b], 0))
        best_in = best_in.at[vc].set(jnp.where(has, pred_node[vc, b], -1))
        return (score, best_in), None

    (score, best_in), _ = jax.lax.scan(
        sc_step, (jnp.zeros((ncap,), jnp.int32),
                  jnp.full((ncap,), -1, jnp.int32)),
        jnp.arange(ncap, dtype=jnp.int32))

    # first max-score node in rank order
    s_ord = jnp.where(jnp.arange(ncap) < n_nodes,
                      score[jnp.clip(order, 0, ncap - 1)], -1)
    vmax = order[jnp.argmax(s_ord).astype(jnp.int32)]
    vmax = jnp.where(n_nodes > 0, vmax, -1)

    # ---- per-node best out-edge (max (weight, head score), earliest
    # creation among ties == Python max over insertion-ordered out_edges)
    heads = jnp.broadcast_to(ids[:, None], (ncap, P)).ravel()
    tails = pnc.ravel()
    ve = valid_e.ravel()
    key1 = jnp.where(ve, pred_w.ravel() * (1 << 21) + score[heads], -1)
    mx = jax.ops.segment_max(key1, tails, num_segments=ncap)
    match = ve & (key1 == mx[tails])
    tcap = ncap * P
    tmv = jnp.clip(pred_t.ravel(), 0, tcap - 1)
    tkey = jnp.where(match, tmv, BIG)
    tmn = jax.ops.segment_min(tkey, tails, num_segments=ncap)
    time_head = jnp.full((tcap + 1,), -1, jnp.int32)
    time_head = time_head.at[jnp.where(ve, tmv, tcap)].set(heads)
    best_out = jnp.where(tmn < BIG, time_head[jnp.clip(tmn, 0, tcap)], -1)

    # ---- backward walk (includes vmax), buffer filled right-to-left ----
    def bcond(st):
        v, idx, _buf = st
        return (v >= 0) & (idx >= 0)     # idx bound: cycle safety net

    def bbody(st):
        v, idx, buf = st
        buf = buf.at[jnp.clip(idx, 0, ncap - 1)].set(v)
        return best_in[jnp.clip(v, 0, ncap - 1)], idx - 1, buf

    _v, idxf, back_buf = jax.lax.while_loop(
        bcond, bbody, (vmax, jnp.int32(ncap - 1),
                       jnp.full((ncap,), -1, jnp.int32)))
    back_start = jnp.maximum(idxf + 1, 0)

    # ---- forward extension from vmax ----
    def fcond(st):
        v, cnt, _buf = st
        return ((v >= 0) & (cnt < ncap)     # cnt bound: cycle safety net
                & (best_out[jnp.clip(v, 0, ncap - 1)] >= 0))

    def fbody(st):
        v, cnt, buf = st
        nv = best_out[jnp.clip(v, 0, ncap - 1)]
        buf = buf.at[jnp.clip(cnt, 0, ncap - 1)].set(nv)
        return nv, cnt + 1, buf

    _v, fwd_cnt, fwd_buf = jax.lax.while_loop(
        fcond, fbody, (vmax, jnp.int32(0),
                       jnp.full((ncap,), -1, jnp.int32)))
    return back_buf, back_start, fwd_buf, fwd_cnt


@functools.partial(jax.jit, static_argnames=("ncap", "r_max", "l_max"))
def _build_batch(seqs, lens, n_seqs, *, ncap: int, r_max: int, l_max: int):
    return _build_batch_impl(seqs, lens, n_seqs, ncap, r_max, l_max)


def _bucket(x, ladder):
    for b in ladder:
        if x <= b:
            return b
    return None


def _emit_window(chars, group_min, n_nodes, path, order, back_buf,
                 back_start, fwd_buf, fwd_cnt, n_seqs: int):
    """(consensus, msa_rows) from one fetched window state (NumPy)."""
    n = int(n_nodes)
    if n == 0:
        return "", ["" for _ in range(n_seqs)]
    order_n = order[:n]
    gm_ord = group_min[order_n]
    uniq, first = np.unique(gm_ord, return_index=True)
    colrank = np.empty(len(uniq), np.int64)
    colrank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    col_of_gm = np.zeros(group_min.shape[0], np.int64)
    col_of_gm[uniq] = colrank
    ncol = len(uniq)
    rows = []
    for r in range(n_seqs):
        rowbuf = np.full(ncol, ord("-"), np.uint8)
        p = path[r]
        nodes = p[p >= 0]
        rowbuf[col_of_gm[group_min[nodes]]] = DECODE[chars[nodes]]
        rows.append(rowbuf.tobytes().decode())
    cons_nodes = np.concatenate([back_buf[int(back_start):],
                                 fwd_buf[:int(fwd_cnt)]])
    consensus = DECODE[chars[cons_nodes]].tobytes().decode()
    return consensus, rows


def _estimate_nodes(seqs: list[str]) -> int:
    """Bucket guess for the final node count: backbone plus headroom for
    per-read novel bases.  Overflow falls back to the host engine, so the
    guess only trades a rare re-run against padding waste."""
    lmax = max(len(s) for s in seqs)
    return lmax + max(32, lmax // 2) + 4 * len(seqs)


def fused_msa_batch(seq_lists: list[list[str]], max_batch: int | None = None):
    """spoa-equivalent poa(seqs, 1) over many windows with the whole MSA
    build on-device: 2 transfers per (bucket, chunk) instead of 2 per read
    round.  Returns [(consensus, msa_rows)] per window, identical to
    ops.poa.poa / the host C++ engine (tested)."""
    out: list = [None] * len(seq_lists)
    groups: dict[tuple[int, int, int], list[int]] = {}
    fallback: list[int] = []
    encoded: dict[int, list[np.ndarray]] = {}
    for i, seqs in enumerate(seq_lists):
        if not seqs or all(len(s) == 0 for s in seqs):
            out[i] = ("", ["" for _ in seqs])
            continue
        rb = _bucket(len(seqs), R_LADDER)
        lb = _bucket(max(len(s) for s in seqs), L_LADDER)
        nb = _bucket(_estimate_nodes(seqs), N_LADDER)
        if rb is None or lb is None or nb is None:
            fallback.append(i)
            continue
        codes = [CODE_OF[np.frombuffer(s.encode(), np.uint8)] for s in seqs]
        if any((c == 255).any() for c in codes):    # non-ACGTN base
            fallback.append(i)
            continue
        encoded[i] = codes
        groups.setdefault((rb, lb, nb), []).append(i)
    for (rb, lb, nb), idxs in groups.items():
        ncap = nb + 1
        bmem = max(8, H_BYTES_CAP // ((ncap + 1) * (lb + 1) * 4))
        bcap = max(8, (min(max_batch or B_LADDER[-1], bmem) // 8) * 8)
        for off in range(0, len(idxs), bcap):
            chunk = idxs[off:off + bcap]
            # chunks past B_LADDER[-1] round up to a multiple of 8
            b_pad = _bucket(len(chunk), B_LADDER) or -(-len(chunk) // 8) * 8
            b_pad = min(b_pad, bcap) if b_pad > len(chunk) else b_pad
            seqs_a = np.zeros((b_pad, rb, lb), np.uint8)
            lens_a = np.zeros((b_pad, rb), np.int32)
            nseq_a = np.zeros(b_pad, np.int32)
            for bi, wi in enumerate(chunk):
                nseq_a[bi] = len(seq_lists[wi])
                for ri, c in enumerate(encoded[wi]):
                    seqs_a[bi, ri, :len(c)] = c
                    lens_a[bi, ri] = len(c)
            # one transfer; with a data mesh installed the window axis
            # shards across devices (windows independent -> SPMD, which
            # GSPMD partitions along the window axis)
            res = jax.device_get(_build_batch(
                *shard_batch((seqs_a, lens_a, nseq_a)), ncap=ncap, r_max=rb,
                l_max=lb))
            (chars, group_min, n_nodes, path, order, back_buf, back_start,
             fwd_buf, fwd_cnt, overflow) = res
            for bi, wi in enumerate(chunk):
                if overflow[bi]:
                    fallback.append(wi)
                    continue
                out[wi] = _emit_window(
                    chars[bi], group_min[bi], n_nodes[bi], path[bi],
                    order[bi], back_buf[bi], back_start[bi], fwd_buf[bi],
                    fwd_cnt[bi], len(seq_lists[wi]))
    if fallback:
        log.info("fused POA: %d/%d windows overflowed the device bucket; "
                 "host C++ fallback", len(fallback), len(seq_lists))
        if len(fallback) > 1:      # threaded host engine, like host mode
            from ..native.poa import poa_msa_batch_native
            for i, r in zip(fallback,
                            poa_msa_batch_native(
                                [seq_lists[i] for i in fallback])):
                out[i] = r
        else:
            from ..native.poa import poa_native
            out[fallback[0]] = poa_native(seq_lists[fallback[0]])
    return out
