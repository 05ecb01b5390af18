"""Batched global-alignment statistics on device (MisScore kernel).

The AlnFeature stage's hot loop #5 is Biopython's global alignment over
somatic x germline consensus pairs (src/PairwiseCompare.py:19-30; SURVEY.md
§3).  MisScore needs (matches, align_len) of ONE optimal alignment under
the traceback preference diag > up > left — not just the score — so the
kernel forward-propagates the traceback choice: at every cell the
tie-break is decided locally (diagonal wins ties, then up, then left), and
(matches, len) accumulate along the chosen-predecessor chain.  This
reproduces ops/nw.nw_align_stats exactly (tested) without materializing H
or walking back.

Row recurrence (vectorized over the j axis, scanned over i):
  diag/up candidates -> in-row gap chain via associative cummax of
  (base[j] + j) -> selection flags -> left-run resolution with an
  index-cummax + gather (M/A copied from the run head).

Shipped as a jitted XLA kernel batched over padded pairs.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.jaxcfg import enable_cache

enable_cache()

from .nw import MATCH, MISMATCH, GAP

NEG = jnp.int32(-(2 ** 29))


def _pad_batch(n: int, ladder=(8, 32, 128, 512, 2048)) -> int:
    """Batch-axis shape bucket: keeps the jit cache small when pair counts
    vary call to call (every distinct B is otherwise a recompile)."""
    for b in ladder:
        if n <= b:
            return b
    return n


def _row_scan(a_codes, b_codes, la, lb, l_max: int, match: int = MATCH,
              mismatch: int = MISMATCH, gap: int = GAP):
    """Stats for one pair; a (l_max,), b (l_max,) uint8; la/lb true lens."""
    j = jnp.arange(l_max + 1, dtype=jnp.int32)
    jvalid = j[1:] <= lb

    h0 = jnp.where(j <= lb, gap * j, NEG).astype(jnp.int32)
    m0 = jnp.zeros(l_max + 1, jnp.int32)
    a0 = jnp.where(j <= lb, j, 0).astype(jnp.int32)

    def row(carry, i):
        H_p, M_p, A_p = carry
        ch = a_codes[i]
        valid_i = i < la
        sub = jnp.where(b_codes == ch, match, mismatch).astype(jnp.int32)
        ismatch = (b_codes == ch).astype(jnp.int32)
        diag = jnp.where(jvalid, H_p[:-1] + sub, NEG)
        up = H_p[1:] + gap
        base = jnp.maximum(diag, up)
        base_full = jnp.concatenate([(H_p[0] + gap)[None], base])
        # H[j] = max(base_full[j], H[j-1] + gap): cummax of base_full - gap*j
        decay = gap * j
        H = jax.lax.associative_scan(jnp.maximum, base_full - decay) + decay
        diag_sel = jnp.concatenate([jnp.array([False]),
                                    (H[1:] == diag) & jvalid])
        up_sel = jnp.concatenate([jnp.array([True]),
                                  (~diag_sel[1:]) & (H[1:] == up)])
        left_sel = ~(diag_sel | up_sel)
        # left runs copy (M, A) from the run head
        src = jnp.where(left_sel, jnp.int32(-1), j)
        head = jax.lax.associative_scan(jnp.maximum, src)
        M_cand = jnp.where(diag_sel,
                           jnp.concatenate([jnp.zeros(1, jnp.int32),
                                            M_p[:-1] + ismatch]),
                           M_p)  # up case: M_p[j]
        A_cand = jnp.where(diag_sel,
                           jnp.concatenate([jnp.zeros(1, jnp.int32),
                                            A_p[:-1] + 1]),
                           A_p + 1)
        M = M_cand[head]
        A = A_cand[head] + (j - head)
        H = jnp.where(valid_i, H, H_p)
        M = jnp.where(valid_i, M, M_p)
        A = jnp.where(valid_i, A, A_p)
        return (H, M, A), None

    (H, M, A), _ = jax.lax.scan(row, (h0, m0, a0),
                                jnp.arange(l_max, dtype=jnp.int32))
    return H[lb], M[lb], A[lb]


@functools.partial(jax.jit,
                   static_argnames=("l_max", "match", "mismatch", "gap"))
def nw_stats_batch(a_codes, b_codes, la, lb, l_max: int, match: int = MATCH,
                   mismatch: int = MISMATCH, gap: int = GAP):
    """(scores, matches, align_lens) for padded pairs.

    a_codes/b_codes (B, l_max) uint8 ascii; la/lb (B,) true lengths."""
    return jax.vmap(_row_scan,
                    in_axes=(0, 0, 0, 0, None, None, None, None))(
        a_codes, b_codes, la, lb, l_max, match, mismatch, gap)


def edit_distance_batch(pairs: list[tuple[str, str]],
                        l_buckets=(128, 256, 512, 1024, 2048, 4096)):
    """Levenshtein distances via the same kernel with unit costs:
    maximizing (match 0, mismatch -1, gap -1) makes distance = -score.
    Covers the reference's read-vs-read edit-distance matrix role
    (src/DecisionMaker.py:76-108, Levenshtein dependency)."""
    out = np.zeros(len(pairs), np.int64)
    groups: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(pairs):
        mx = max(len(a), len(b), 1)
        lbk = next((x for x in l_buckets if mx <= x), None)
        if lbk is None:
            raise ValueError(f"pair {i} longer than {l_buckets[-1]}")
        groups.setdefault(lbk, []).append(i)
    import jax
    pending = []
    for lbk, idxs in groups.items():
        B = _pad_batch(len(idxs))
        ac = np.zeros((B, lbk), np.uint8)
        bc = np.zeros((B, lbk), np.uint8)
        la = np.zeros(B, np.int32)
        lbn = np.zeros(B, np.int32)
        for k, i in enumerate(idxs):
            a, b = pairs[i]
            ac[k, :len(a)] = np.frombuffer(a.encode(), np.uint8)
            bc[k, :len(b)] = np.frombuffer(b.encode(), np.uint8)
            la[k], lbn[k] = len(a), len(b)
        dac, dbc, dla, dlb = jax.device_put((ac, bc, la, lbn))  # 1 transfer
        s, _m, _al = nw_stats_batch(dac, dbc, dla, dlb, lbk, 0, -1, -1)
        pending.append((idxs, s))
    fetched = jax.device_get([s for _, s in pending])
    for (idxs, _), s in zip(pending, fetched):
        for k, i in enumerate(idxs):
            out[i] = -int(s[k])
    return out


def pairwise_edit_distance_matrix(seqs: list[str]) -> np.ndarray:
    """Symmetric read-vs-read Levenshtein matrix on device."""
    n = len(seqs)
    pairs = [(seqs[i], seqs[j]) for i in range(n) for j in range(i + 1, n)]
    d = edit_distance_batch(pairs) if pairs else np.empty(0, np.int64)
    out = np.zeros((n, n), np.int64)
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            out[i, j] = out[j, i] = d[k]
            k += 1
    return out


def misscore_batch(pairs: list[tuple[str, str]], l_buckets=(128, 256, 512,
                                                            1024, 2048, 4096)):
    """MisScores for (som, germ) pairs via the device kernel; falls back to
    the host DP for oversized pairs."""
    from .nw import nw_align_stats
    out = np.zeros(len(pairs), np.int64)
    groups: dict[int, list[int]] = {}
    for i, (a, b) in enumerate(pairs):
        mx = max(len(a), len(b))
        lb = next((x for x in l_buckets if mx <= x), None)
        if lb is None:
            _, m, al = nw_align_stats(a, b)
            out[i] = al - m
        else:
            groups.setdefault(lb, []).append(i)
    # dispatch every bucket first (async), then fetch everything in one
    # round trip instead of one per bucket
    import jax
    pending = []
    for lbk, idxs in groups.items():
        B = _pad_batch(len(idxs))
        ac = np.zeros((B, lbk), np.uint8)
        bc = np.zeros((B, lbk), np.uint8)
        la = np.zeros(B, np.int32)
        lbn = np.zeros(B, np.int32)
        for k, i in enumerate(idxs):
            a, b = pairs[i]
            ac[k, :len(a)] = np.frombuffer(a.encode(), np.uint8)
            bc[k, :len(b)] = np.frombuffer(b.encode(), np.uint8)
            la[k], lbn[k] = len(a), len(b)
        dac, dbc, dla, dlb = jax.device_put((ac, bc, la, lbn))  # 1 transfer
        _s, m, al = nw_stats_batch(dac, dbc, dla, dlb, lbk)
        pending.append((idxs, m, al))
    fetched = jax.device_get([(m, al) for _, m, al in pending])
    for (idxs, _, _), (m, al) in zip(pending, fetched):
        for k, i in enumerate(idxs):
            out[i] = int(al[k]) - int(m[k])
    return out
