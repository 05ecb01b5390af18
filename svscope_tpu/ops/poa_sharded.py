"""Sequence-sharded POA wavefront: one oversized window's graph-vs-read DP
pipelined across the device mesh.

The batched aligner (ops/poa_device) makes *windows* the parallel axis and
keeps each DP on one device; windows beyond their buckets
(giant tandem repeats: >2048 graph nodes or >2048 bp reads) previously fell
back to the host int32 path.  This module is the SURVEY.md §5 "long-context"
row: the moral equivalent of ring attention for DP wavefronts.

Design (column sharding + systolic pipeline):

  * The (N+1) x (L+1) DP matrix is sharded on the COLUMN (read-position)
    axis: device d owns a contiguous block of C = (L+1)/D columns and keeps
    its H block, a direction block, and a copy of its left neighbour's last
    column (`leftcol`) resident.
  * Rows run as a wavefront: at global step t, device d computes row
    i = t - d + 1 of its block — all D devices work on D consecutive rows
    simultaneously after the D-step fill.  Total steps N + D - 1.
  * The only cross-device traffic is ONE int32 per device per step,
    ppermuted right along the mesh axis: the just-finished row's value at
    the block's last column.  The receiver uses it twice — as the incoming
    gap-chain carry for the row it is about to compute, and appended to
    `leftcol` so later rows can read their predecessors' j-1 values across
    the block boundary.  (Predecessor rows of row i all have rank < i, so
    their boundary values arrived in earlier steps.)
  * Recurrence, scoring (m=5, n=-4, g=-8) and traceback tie-break order
    (diagonal predecessors in insertion order, then graph-gap predecessors,
    then the sequence gap) are identical to ops/poa_device._align_one; the
    direction plane is computed on device per row, and the final walk runs
    on host over the gathered int8 plane (O(N+L)).
  * Past FULL_DIRS_CELL_LIMIT cells the kernel stores NO direction plane:
    the H matrix stays device-resident (it is needed for the predecessor
    gathers anyway) and the traceback walks it in (KR x KC) direction
    blocks recomputed on device on demand — the path is monotone in both
    rank and read position, so it visits O(N/KR + L/KC) blocks and the
    host fetch volume drops from O(N*L) int8 to O((N+L)*K).  This is what
    lets a single giant tandem-repeat window (e.g. 32k nodes x 32k bp)
    run without a quarter-gigabyte device->host transfer.

Parity: tests/test_poa_sharded.py runs this against PoaGraph.align on an
8-virtual-device CPU mesh.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..utils.jaxcfg import enable_cache

enable_cache()

from .poa import PoaGraph
from .poa_device import pack_graph

MATCH = 5
MISMATCH = -4
GAP = -8
NEG = np.int32(-(2 ** 29))
MAX_PREDS = 8
DIR_LEFT = 16


def _wavefront_shard(chars, preds, sinks, n_nodes, seq_sh, seq_len,
                     *, axis: str, n_max: int, block: int, n_dev: int,
                     store: str = "dirs"):
    """Per-device body (inside shard_map).  chars/preds/sinks/n_nodes are
    replicated; seq_sh is this device's (block,) slice of the shifted read
    (seq_sh[j_local] = read char of global column d*block + j_local)."""
    d = jax.lax.axis_index(axis)
    p_max = preds.shape[1]
    j_local = jnp.arange(block, dtype=jnp.int32)
    j_global = d * block + j_local
    col_valid = j_global <= seq_len
    slot = jnp.arange(p_max)

    h0 = jnp.where(col_valid, GAP * j_global, NEG).astype(jnp.int32)
    H = jnp.full((n_max + 1, block), NEG, jnp.int32).at[0].set(h0)
    dirs = jnp.full((n_max, block), DIR_LEFT, jnp.int8)
    # left neighbour's last column, row 0 (virtual row) known statically
    lc0 = jnp.where((d > 0) & (d * block - 1 <= seq_len),
                    GAP * (d * block - 1), NEG).astype(jnp.int32)
    leftcol = jnp.full(n_max + 1, NEG, jnp.int32).at[0].set(lc0)
    perm = [(s, s + 1) for s in range(n_dev - 1)]

    def step(state, t):
        H, dirs, leftcol, recv = state
        i = t - d + 1                       # this device's row this step
        active = (i >= 1) & (i <= n_nodes)
        ii = jnp.clip(i, 1, n_max)
        leftcol = leftcol.at[ii].set(
            jnp.where(active & (d > 0), recv, leftcol[ii]))
        pr = preds[ii - 1]
        has_pred = pr >= 0
        valid_slot = has_pred | (slot == 0)
        rows = jnp.where(has_pred, pr + 1, 0)
        Pb = jnp.where(valid_slot[:, None], H[rows], NEG)        # (P, C)
        lvals = jnp.where(valid_slot, leftcol[rows], NEG)
        Pm1 = jnp.concatenate([lvals[:, None], Pb[:, :-1]], axis=1)
        maxpred = Pb.max(axis=0)
        maxpredm1 = Pm1.max(axis=0)
        ch = chars[ii - 1]
        sub = jnp.where(seq_sh == ch, MATCH, MISMATCH).astype(jnp.int32)
        diag = jnp.where(col_valid & (j_global >= 1), maxpredm1 + sub, NEG)
        up = maxpred + GAP
        base = jnp.where(j_global == 0, up, jnp.maximum(diag, up))
        base = jnp.where(col_valid, base, NEG)
        # in-row gap chain with the ppermuted carry from the left block
        carry = jnp.where(d > 0, recv, NEG)
        decay = GAP * j_local
        cm = jax.lax.associative_scan(jnp.maximum, base - decay) + decay
        hrow = jnp.maximum(cm, carry + GAP * (j_local + 1))
        hrow = jnp.where(col_valid, hrow, NEG)

        H = H.at[ii].set(jnp.where(active, hrow, H[ii]))
        if store == "dirs":
            # directions against the finished row (first matching slot wins)
            d_diag = jnp.full(block, -1, jnp.int32)
            d_up = jnp.full(block, -1, jnp.int32)
            for p in range(p_max - 1, -1, -1):
                ok = valid_slot[p]
                dok = (ok & (hrow == Pm1[p] + sub) & (j_global >= 1)
                       & col_valid)
                uok = ok & (hrow == Pb[p] + GAP)
                d_diag = jnp.where(dok, p, d_diag)
                d_up = jnp.where(uok, 8 + p, d_up)
            dirrow = jnp.where(d_diag >= 0, d_diag,
                               jnp.where(d_up >= 0, d_up, DIR_LEFT))
            dirs = dirs.at[ii - 1].set(
                jnp.where(active, dirrow.astype(jnp.int8), dirs[ii - 1]))
        send = jnp.where(active, hrow[block - 1], NEG)
        recv_next = jax.lax.ppermute(send, axis, perm)
        return (H, dirs, leftcol, recv_next), None

    steps = jnp.arange(n_max + n_dev - 1, dtype=jnp.int32)
    if store != "dirs":
        dirs = jnp.zeros((1, 1), jnp.int8)   # placeholder carry
    (H, dirs, leftcol, _), _ = jax.lax.scan(
        step, (H, dirs, leftcol, jnp.int32(NEG)), steps)

    # best sink at global column seq_len (owner device only), rank
    # tie-break = first max (rank order), like _align_one's argmax
    loc = seq_len - d * block
    owner = (loc >= 0) & (loc < block)
    ends = H[1:, jnp.clip(loc, 0, block - 1)]
    rank_ok = sinks & (jnp.arange(n_max) < n_nodes)
    ends = jnp.where(owner & rank_ok, ends, NEG)
    best_local = jnp.argmax(ends).astype(jnp.int32)
    score_local = ends[best_local]
    score = jax.lax.pmax(score_local, axis)
    best = jax.lax.psum(jnp.where(owner, best_local, 0), axis)
    if store == "dirs":
        return dirs, score[None], best[None]
    return H, score[None], best[None]


def _shard_wrap(fn, mesh, specs):
    from jax import shard_map
    return shard_map(fn, mesh=mesh, check_vma=False, **specs)


@functools.partial(jax.jit,
                   static_argnames=("axis", "n_max", "block", "n_dev",
                                    "mesh", "store"))
def _wavefront_call(chars, preds, sinks, n_nodes, seq_sh, seq_len, *,
                    axis: str, n_max: int, block: int, n_dev: int,
                    mesh: Mesh, store: str = "dirs"):
    fn = functools.partial(_wavefront_shard, axis=axis, n_max=n_max,
                           block=block, n_dev=n_dev, store=store)
    specs = dict(in_specs=(P(), P(), P(), P(), P(axis), P()),
                 out_specs=(P(None, axis), P(axis), P(axis)))
    wrapped = _shard_wrap(fn, mesh, specs)
    return wrapped(chars, preds, sinks, n_nodes, seq_sh, seq_len)


def _host_traceback(dirs, preds, best_rank, seq_len):
    """Walk the int8 direction plane exactly like _align_one's while loop."""
    out = []
    i = int(best_rank) + 1
    j = int(seq_len)
    while j > 0:
        if i == 0:
            out.append((-1, j - 1))
            j -= 1
            continue
        code = int(dirs[i - 1, j])
        if code == DIR_LEFT:
            out.append((-1, j - 1))
            j -= 1
        elif code >= 8:                      # graph gap via pred slot
            p = code - 8
            out.append((i - 1, -1))
            i = int(preds[i - 1, p]) + 1
        else:                                # diagonal via pred slot
            out.append((i - 1, j - 1))
            i = int(preds[i - 1, code]) + 1
            j -= 1
    out.reverse()
    return out


FULL_DIRS_CELL_LIMIT = 1 << 25   # past ~32M cells, skip the dirs plane
TB_BLOCK_R = 512                 # traceback direction-block rows (ranks)
TB_BLOCK_C = 512                 # traceback direction-block columns


@functools.partial(jax.jit, static_argnames=("kr", "kc"))
def _dir_block(H, preds, chars, seq_sh, seq_len, r0, c0, *, kr: int,
               kc: int):
    """(kr, kc) int8 direction codes for ranks [r0, r0+kr) x global
    columns [c0, c0+kc), recomputed from the resident H matrix — the same
    tie-break order as the forward kernel's dirs plane.  c0 >= 1 (column 0
    never needs a direction: the host walk ends at j == 0)."""
    n1 = H.shape[0]                       # n_max + 1
    p_max = preds.shape[1]
    zero = jnp.int32(0)
    Hc = jax.lax.dynamic_slice(H, (zero, c0 - 1), (n1, kc + 1))  # c0-1 ..
    seqc = jax.lax.dynamic_slice(seq_sh, (c0,), (kc,))
    jg = c0 + jnp.arange(kc, dtype=jnp.int32)
    col_ok = jg <= seq_len
    slot = jnp.arange(p_max)

    def row_dirs(r):
        pr = preds[r]
        has = pr >= 0
        valid = has | (slot == 0)
        rows = jnp.where(has, pr + 1, 0)
        Pc = jnp.where(valid[:, None], Hc[rows], NEG)          # (P, kc+1)
        h = Hc[r + 1, 1:]                                      # (kc,)
        sub = jnp.where(seqc == chars[r], MATCH, MISMATCH).astype(jnp.int32)
        d_diag = jnp.full(kc, -1, jnp.int32)
        d_up = jnp.full(kc, -1, jnp.int32)
        for p in range(p_max - 1, -1, -1):
            ok = valid[p]
            dok = ok & (h == Pc[p, :-1] + sub) & col_ok
            uok = ok & (h == Pc[p, 1:] + GAP)
            d_diag = jnp.where(dok, p, d_diag)
            d_up = jnp.where(uok, 8 + p, d_up)
        return jnp.where(d_diag >= 0, d_diag,
                         jnp.where(d_up >= 0, d_up, DIR_LEFT)).astype(
            jnp.int8)

    ranks = jnp.clip(r0 + jnp.arange(kr, dtype=jnp.int32), 0, n1 - 2)
    return jax.vmap(row_dirs)(ranks)


def _banded_traceback(H, preds_np, chars_dev, seq_sh_dev, best_rank: int,
                      seq_len: int, kr: int = TB_BLOCK_R,
                      kc: int = TB_BLOCK_C):
    """_host_traceback without a direction plane: walk the path, fetching
    (kr, kc) direction blocks recomputed on device from H as the walk
    crosses block boundaries.  i and j are both non-increasing, so each
    block is visited at most once: O(N/kr + L/kc) fetches."""
    preds_dev = jnp.asarray(preds_np)
    sl = jnp.int32(seq_len)
    lpad = H.shape[1]
    blk, br0, bc0 = None, -1, -1
    out = []
    i, j = int(best_rank) + 1, int(seq_len)
    while j > 0:
        if i == 0:
            out.append((-1, j - 1))
            j -= 1
            continue
        r = i - 1
        r0 = (r // kr) * kr
        # clamp so the device slice [c0-1, c0+kc) stays in bounds (a
        # dynamic_slice would silently shift otherwise)
        c0 = min(((j - 1) // kc) * kc + 1, lpad - kc)
        if r0 != br0 or c0 != bc0:
            blk = np.asarray(_dir_block(H, preds_dev, chars_dev, seq_sh_dev,
                                        sl, jnp.int32(r0), jnp.int32(c0),
                                        kr=kr, kc=kc))
            br0, bc0 = r0, c0
        code = int(blk[r - r0, j - c0])
        if code == DIR_LEFT:
            out.append((-1, j - 1))
            j -= 1
        elif code >= 8:                      # graph gap via pred slot
            out.append((i - 1, -1))
            i = int(preds_np[i - 1, code - 8]) + 1
        else:                                # diagonal via pred slot
            out.append((i - 1, j - 1))
            i = int(preds_np[i - 1, code]) + 1
            j -= 1
    out.reverse()
    return out


def align_sharded_packed(chars, preds, is_sink, n_nodes, node_of_rank,
                         seq: str, mesh: Mesh, axis: str = "sp",
                         traceback: str = "auto", tb_block: tuple | None =
                         None):
    """Sharded wavefront over pre-packed rank-space graph arrays (the
    format produced by ops.poa_device.pack_graph or the native engine's
    pack).  Returns ([(node_id, seq_pos)], score).

    traceback: 'full' fetches the whole (N, L) int8 direction plane;
    'banded' keeps H resident and fetches recomputed direction blocks
    along the path; 'auto' picks banded past FULL_DIRS_CELL_LIMIT cells."""
    n_dev = mesh.shape[axis]
    n_max = chars.shape[0]
    L = len(seq)
    l_bucket = max(256, 1 << max(L - 1, 1).bit_length())
    block = -(-(l_bucket + 1) // n_dev)      # ceil((L_bucket+1)/D)
    seq_sh = np.full(block * n_dev, 255, np.int32)
    seq_sh[1:L + 1] = np.frombuffer(seq.encode(), np.uint8)
    cells = n_max * block * n_dev
    banded = (traceback == "banded"
              or (traceback == "auto" and cells > FULL_DIRS_CELL_LIMIT))

    put = lambda a, spec: jax.device_put(jnp.asarray(a),
                                         NamedSharding(mesh, spec))
    chars_dev = put(np.asarray(chars).astype(np.int32), P())
    preds_np = np.asarray(preds, np.int32)
    seq_dev = put(seq_sh, P(axis))
    plane, score, best = _wavefront_call(
        chars_dev, put(preds_np, P()),
        put(np.asarray(is_sink, bool), P()), put(np.int32(n_nodes), P()),
        seq_dev, put(np.int32(L), P()),
        axis=axis, n_max=n_max, block=block, n_dev=n_dev, mesh=mesh,
        store="h" if banded else "dirs")
    score, best = jax.device_get((score, best))
    if banded:
        kr, kc = tb_block or (TB_BLOCK_R, TB_BLOCK_C)
        kr = min(kr, n_max)
        kc = min(kc, block * n_dev - 1)
        pairs = _banded_traceback(plane, preds_np, chars_dev, seq_dev,
                                  int(best[0]), L, kr=kr, kc=kc)
    else:
        pairs = _host_traceback(jax.device_get(plane), preds_np,
                                int(best[0]), L)
    aln = [(int(node_of_rank[r]) if r >= 0 else -1, s) for r, s in pairs]
    return aln, int(score[0])


def align_sharded(graph: PoaGraph, seq: str, mesh: Mesh, axis: str = "sp",
                  p_max: int = MAX_PREDS, traceback: str = "auto",
                  tb_block: tuple | None = None):
    """PoaGraph.align equivalent for one oversized (graph, read) pair,
    column-sharded over `mesh[axis]`.  Returns ([(node_id, seq_pos)], score)
    with -1 for gaps, identical to the host aligner (tested)."""
    n = len(graph.topo_order())
    n_max = max(256, 1 << (n - 1).bit_length())   # bucket: few compiles
    chars, preds, is_sink, n_nodes, node_of_rank = pack_graph(
        graph, n_max, p_max)
    return align_sharded_packed(chars, preds, is_sink, n_nodes,
                                node_of_rank, seq, mesh, axis,
                                traceback=traceback, tb_block=tb_block)


def poa_msa_sharded(seq_list: list[str], mesh: Mesh, axis: str = "sp"):
    """MSA of one oversized window through the sharded aligner: the graph
    grows on host (fusion is O(nodes)), every alignment round runs as a
    column-sharded wavefront.  Same output as ops.poa.poa(seqs, 1)."""
    from .poa import _fused_path
    graph = PoaGraph()
    paths: list[list[int]] = []
    for s in seq_list:
        if not s:
            graph.seq_begin.append(-1)
            paths.append([])
            continue
        if graph.n_nodes() == 0:
            prev = -1
            begin = -1
            for ch in s:
                cur = graph._add_node(ch)
                if prev >= 0:
                    graph._add_edge(prev, cur)
                else:
                    begin = cur
                prev = cur
            graph.seq_begin.append(begin)
            paths.append(list(range(len(s))))
            continue
        aln, _score = align_sharded(graph, s, mesh, axis)
        paths.append(_fused_path(graph, aln, s))
    col, ncol = graph._columns()
    rows = []
    for path in paths:
        row = ["-"] * ncol
        for v in path:
            row[col[v]] = graph.chars[v]
        rows.append("".join(row))
    return graph.consensus(), rows
