"""Categorical (multinomial) mixture model over the 5-letter MSA alphabet,
fit by EM with BIC model selection — the phasing core of the per-window
engine.

Re-designs reference src/ReadsCluster.py as batched, jittable JAX:
  * E-step (gamma_updating, src/ReadsCluster.py:132-155): per-column one-hot
    dot products against log-theta — a single (N, nf*5) @ (nf*5, K) matmul,
    followed by the reference's safe-exp reciprocal-sum
    normalization gamma_I = 1/sum_j exp(clip(M_j - M_I, -700, 700)).
  * M-step (pitheta_updating, :162-188): gamma^T one-hot counts; on a
    degenerate pi (pi*N < 1 or NaN) the parameters re-initialize to uniform
    pi + Dirichlet(1) theta (reference drew from the globally seeded numpy
    RNG; here a jax.random key is threaded per run — cluster-label parity is
    the contract, not bit-exact RNG streams).
  * EM (:190-209): hierarchical init -> E -> 20x(M -> E), no convergence
    test, per-step expected-complete log-likelihood (loglik, :104-122).
  * BIC (:211-219): 2*sum(lik) - n_theta*log(N) with the zero-count
    parameter correction (EMCluster, :225-234).
  * Model selection (EMCluster, :221-277): K in [1, min(9, N-1)], up to 5
    retries on NaN BIC, argmax BIC, and the K=1->2 tie-break when
    BIC_1 - BIC_2 <= nf*log(N).

All K runs execute in parallel (vmap over a padded K axis with cluster-slot
masks); windows batch over a leading axis with padded reads/features.
"""
from __future__ import annotations

import functools
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.jaxcfg import enable_cache

enable_cache()

ALPHA = 5          # alphabet size {A,T,C,G,-}
MAX_K = 9          # reference max cluster count (src/ReadsCluster.py:221)
NSTEP = 20         # fixed EM iterations (src/ReadsCluster.py:190)
PAD_CODE = 5       # feature pad: one-hot(5, num_classes=5) == zeros
EPS = 1e-10
NEG_BIG = -1e30
MAX_BATCH = 256                  # windows per device call
# Shape buckets are deliberately COARSE: every distinct (batch, reads,
# features) triple is a separate jit entry costing ~1.3 s of client-side
# tracing/lowering per process (measured; the chromosome-scale harness
# spent more time tracing fine-grained buckets than computing).  Padding
# waste is device compute — cheap next to a single retrace.  The 128 rung
# exists because the production pipeline feeds EM in
# engine/localgraph.PIPELINE_CHUNK = 128 sub-chunks (one EM batch bucket
# exactly); without it every standard chunk padded to 256 — 2x the EM
# device work for nothing.
BATCH_LADDER = (32, 128, 256)     # batch-axis shape buckets
SHAPE_LADDER = (16, 64, 256, 1024, 4096)   # feature-axis buckets
READS_LADDER = (16, 64, 512)      # read-axis buckets (selection caps at 500)
# Every dot whose result feeds labels or BIC runs at full float precision:
# a GPU computes an unpinned f32 dot in TF32 (~3 decimal digits), enough
# to flip near-tied E-step responsibilities and Ward-seeded K choices.
HIGHEST = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Hierarchical initialization (host side, tiny: N <= 500)
# ---------------------------------------------------------------------------

def pairwise_identity(seqdatamx: np.ndarray) -> np.ndarray:
    """Per-pair fraction of identical columns, diag=1.

    Mirrors CallDistance/pariwiseDistance (src/ReadsCluster.py:44-59): the
    value is a *similarity* though the reference names it a distance; the
    Ward init consumes the square matrix as an observation matrix — both
    quirks are replicated because they shape the initial clustering.
    """
    x = np.asarray(seqdatamx)
    n, nf_raw = x.shape
    nf = max(nf_raw, 1)
    if n * n * nf_raw > (1 << 21):
        # one-hot matmul: eq(i,j) = sum_a <x_i==a, x_j==a>.  Counts are
        # integers <= nf << 2^24, exact in f32, so the float64 division
        # below is bitwise identical to the broadcast path (BLAS does the
        # work without the (n, n, nf) bool tensor — 30x at the 400-500
        # read heavy tail, round-5 bench tier)
        oh = (x[..., None] == np.arange(ALPHA, dtype=x.dtype))
        oh_f = oh.reshape(n, nf_raw * ALPHA).astype(np.float32)
        eq = (oh_f @ oh_f.T).astype(np.float64)
        out = eq / nf
    else:
        eq = (x[:, None, :] == x[None, :, :]).sum(axis=2) / nf
        out = eq.astype(np.float64)
    np.fill_diagonal(out, 1.0)
    return out


def _cut_tree_labels(Z: np.ndarray, n: int, k: int) -> np.ndarray:
    """K-cluster labels by applying the first n-k merges of a monotone
    linkage — equivalent to fcluster(..., 'maxclust') for Ward trees but
    without scipy's per-call validation overhead (which dominated the init
    profile).  Labels numbered by first leaf occurrence."""
    parent = np.arange(2 * n - 1)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for m in range(n - k):
        a, b = int(Z[m, 0]), int(Z[m, 1])
        parent[find(a)] = parent[find(b)] = n + m
    roots = {}
    out = np.empty(n, np.int32)
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = len(roots)
        out[i] = roots[r]
    return out


def _pairwise_euclidean(obs: np.ndarray) -> np.ndarray:
    """(n, n) euclidean distances between observation rows (pdist square).

    Accumulates the squared differences ONE FEATURE AT A TIME — scipy's
    pdist C loop sums sequentially, and NumPy's pairwise summation differs
    from it by ~1 ulp, which is enough to flip downstream tie comparisons
    and reorder equal-height Ward merges.  Bitwise pdist parity is what
    makes ward_linkage Z-identical to scipy (tested).

    The hot path is the C++ kernel (native/hcluster.cpp): same per-pair
    sequential accumulation, SIMD across pairs (lane-independent sums are
    never reassociated), fp-contract off — bitwise-identical to this
    NumPy loop (tested) at ~15-30x its speed for the 500-read windows
    that otherwise serialize host EM prep."""
    obs = np.asarray(obs, np.float64)
    try:
        from ..native.hcluster import pdist_seq
        return pdist_seq(obs)
    except Exception:                    # no g++ / load failure: pure NumPy
        n, nf = obs.shape
        s = np.zeros((n, n), np.float64)
        for k in range(nf):
            d = obs[:, k, None] - obs[None, :, k]
            s += d * d
        return np.sqrt(s)


def ward_linkage(obs: np.ndarray) -> np.ndarray:
    """scipy.cluster.hierarchy.linkage(obs, 'ward') replacement: NN-chain
    agglomeration (Müllner 2011) over euclidean distances of observation
    rows, with scipy's exact semantics — strict-< inner argmin (first
    minimum wins, the chain predecessor keeps ties), Lance-Williams Ward
    update in scipy's operand order, stable distance sort, union-find
    relabeling.  Pure NumPy: drops the last compiled-scipy dependency from
    the EM hot path (SURVEY §2.3 'scipy linkage retained').  Tested
    Z-identical to scipy on randomized and tie-heavy inputs."""
    n = obs.shape[0]
    D = _pairwise_euclidean(np.asarray(obs, np.float64))
    np.fill_diagonal(D, np.inf)
    size = np.ones(n, np.int64)
    alive = np.ones(n, bool)
    Z = np.empty((n - 1, 4), np.float64)
    chain: list[int] = []
    for k in range(n - 1):
        if not chain:
            chain.append(int(np.flatnonzero(alive)[0]))
        while True:
            x = chain[-1]
            row = np.where(alive, D[x], np.inf)
            row[x] = np.inf
            m = row.min()
            if len(chain) > 1:
                prev = chain[-2]
                y = int(np.argmin(row)) if m < row[prev] else prev
            else:
                y = int(np.argmin(row))
            if len(chain) > 1 and y == chain[-2]:
                break
            chain.append(y)
        chain.pop()
        chain.pop()
        if x > y:
            x, y = y, x
        nx, ny = size[x], size[y]
        d_xy = D[x, y]
        Z[k] = (x, y, d_xy, nx + ny)
        alive[x] = False
        size[y] = nx + ny
        # Ward Lance-Williams update, scipy's operand order:
        # sqrt((ni+nx)*t*d_xi^2 + (ni+ny)*t*d_yi^2 - ni*t*d_xy^2)
        upd = alive.copy()
        upd[y] = False
        ni = size[upd].astype(np.float64)
        t = 1.0 / (nx + ny + ni)
        d_xi = D[x, upd]
        d_yi = D[y, upd]
        new = np.sqrt((ni + nx) * t * d_xi * d_xi
                      + (ni + ny) * t * d_yi * d_yi
                      - ni * t * d_xy * d_xy)
        D[y, upd] = new
        D[upd, y] = new
    order = np.argsort(Z[:, 2], kind="stable")
    Z = Z[order]
    # union-find relabel in sorted order (scipy's label())
    parent = np.arange(2 * n - 1)
    uf_size = np.ones(2 * n - 1, np.int64)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for i in range(n - 1):
        xr, yr = find(int(Z[i, 0])), find(int(Z[i, 1]))
        if xr > yr:
            xr, yr = yr, xr
        Z[i, 0], Z[i, 1] = xr, yr
        Z[i, 3] = uf_size[xr] + uf_size[yr]
        parent[xr] = parent[yr] = n + i
        uf_size[n + i] = uf_size[xr] + uf_size[yr]
    return Z


def ward_init_labels(seqdatamx: np.ndarray, kmax: int,
                     sim: np.ndarray | None = None) -> np.ndarray:
    """(kmax, N) int labels in 0..K-1 for K = 1..kmax from Ward linkage.

    ward_linkage receives the (N, N) similarity matrix as raw observations,
    exactly like the reference feeds scipy (src/ReadsCluster.py:242-243).
    Hot path is the C++ kernel (native/hcluster.cpp::ward_cut_batch —
    bitwise label parity tested); _ward_init_labels_py is the NumPy
    fallback/oracle."""
    if sim is None:
        n = seqdatamx.shape[0]
        if n < 2:
            return np.zeros((kmax, n), np.int32)
        sim = pairwise_identity(seqdatamx)
    return ward_cut_many([sim], kmax, n_threads=1)[0]


_WARD_NATIVE_WARNED = False


def ward_cut_many(sims: list[np.ndarray], kmax: int,
                  n_threads: int | None = None) -> list[np.ndarray]:
    """Batched Ward-cut labels over per-window (n, n) similarity
    matrices: native C++ (threaded across windows) with NumPy fallback.
    Only build/load failures fall back (a bug in the wrapper must
    surface, not silently cost the 10x the native path buys)."""
    global _WARD_NATIVE_WARNED
    import subprocess
    try:
        from ..native.hcluster import ward_cut_batch as _wcb
        return _wcb(sims, kmax, n_threads=n_threads)
    except (ImportError, OSError, RuntimeError,
            subprocess.CalledProcessError) as exc:
        if not _WARD_NATIVE_WARNED:
            _WARD_NATIVE_WARNED = True
            logging.getLogger("svscope_tpu.mixture").warning(
                "native ward_cut_batch unavailable (%s); NumPy fallback "
                "(~10x slower EM init)", exc)
        return [_ward_init_labels_py(None, kmax, sim=s) for s in sims]


def _ward_init_labels_py(seqdatamx: np.ndarray | None, kmax: int,
                         sim: np.ndarray | None = None) -> np.ndarray:
    """Pure-NumPy ward_init_labels (the native kernel's parity oracle).
    All K cuts come from one incremental union-find pass over the merge
    list (identical labels to per-K _cut_tree_labels; the per-K rebuild
    dominated the EM host-prep profile)."""
    n = seqdatamx.shape[0] if sim is None else sim.shape[0]
    labels = np.zeros((kmax, n), np.int32)
    if n < 2:
        return labels
    if sim is None:
        sim = pairwise_identity(seqdatamx)
    Z = ward_linkage(sim)
    # leaf -> current cluster id, re-stamped eagerly over both sides of
    # each merge (total O(n log n)-ish for Ward trees); each cut's labels
    # come from one vectorized first-occurrence relabel (the per-leaf
    # union-find walk dominated the EM host-prep profile at large chunk
    # counts)
    root = np.arange(n, dtype=np.int64)
    members: dict[int, np.ndarray] = {i: np.array([i]) for i in range(n)}
    m = 0
    for k in range(min(kmax, n), 1, -1):
        while m < n - k:
            a, b = int(Z[m, 0]), int(Z[m, 1])
            ma, mb = members.pop(a), members.pop(b)
            mc = np.concatenate([ma, mb])
            root[mc] = n + m
            members[n + m] = mc
            m += 1
        _u, first, inv = np.unique(root, return_index=True,
                                   return_inverse=True)
        order = np.empty(len(first), np.int32)
        order[np.argsort(first)] = np.arange(len(first), dtype=np.int32)
        labels[k - 1] = order[inv]
    return labels


# ---------------------------------------------------------------------------
# Jitted EM core
# ---------------------------------------------------------------------------

def _m_step(gamma, x_oh, read_mask, n_true, nf, key, kmask):
    """pi/theta update with degenerate-pi Dirichlet re-init."""
    K = gamma.shape[1]
    gamma = gamma * read_mask[:, None]
    pi = gamma.sum(axis=0) / n_true
    counts = jnp.einsum("nk,nfa->kfa", gamma, x_oh, precision=HIGHEST)
    denom = gamma.sum(axis=0)[:, None, None]
    theta = counts / jnp.where(denom == 0, 1.0, denom)
    bad = (jnp.where(kmask, pi, 1.0) * n_true < 1).any() | jnp.isnan(pi).any()
    # Dirichlet(ones(5)) re-init, masked cluster slots excluded from `bad`
    gam = jax.random.gamma(key, jnp.ones((K, nf, ALPHA), dtype=gamma.dtype))
    dirich = gam / gam.sum(axis=-1, keepdims=True)
    pi = jnp.where(bad, jnp.full_like(pi, 1.0 / jnp.maximum(kmask.sum(), 1)), pi)
    theta = jnp.where(bad, dirich, theta)
    return pi, theta


def _e_step(pi, theta, x_flat, kmask):
    """Returns (gamma, margin_log) with the reference's reciprocal-sum."""
    theta_c = jnp.clip(theta, EPS, 1 - EPS)
    logt = jnp.log(theta_c).reshape(theta.shape[0], -1)  # (K, nf*5)
    M = jnp.matmul(x_flat, logt.T, precision=HIGHEST)  # (N, K)
    M = M + jnp.log(jnp.clip(pi, EPS, 1 - EPS))[None, :]
    M = jnp.where(kmask[None, :], M, NEG_BIG)
    diff = jnp.clip(M[:, :, None] - M[:, None, :], -700.0, 700.0)  # [n, j, I]
    denom = jnp.exp(diff).sum(axis=1)  # sum_j exp(M_j - M_I)
    gamma = 1.0 / denom
    gamma = jnp.where(kmask[None, :], gamma, 0.0)
    return gamma, M


def _loglik(pi, theta, gamma, x_oh, read_mask):
    """Expected complete-data log-lik per read (src/ReadsCluster.py:104-122)."""
    theta_c = jnp.clip(theta, EPS, 1 - EPS)
    per_k = jnp.einsum("nfa,kfa->nk", x_oh, jnp.log(theta_c),
                       precision=HIGHEST)
    per_k = per_k + jnp.log(jnp.clip(pi, EPS, 1 - EPS))[None, :]
    lik = (per_k * gamma).sum(axis=1)
    return lik * read_mask


def em_run(x_oh, read_mask, gamma0, kmask, n_true, key, nsteps: int = NSTEP):
    """One EM run for one (window, K): init E-step then nsteps x (M, E).

    x_oh: (N, nf, 5) one-hot (pad rows/cols all-zero)
    gamma0: (N, Kmax) one-hot hard labels from Ward init
    kmask: (Kmax,) bool of active cluster slots
    Returns (pi, theta, gamma, lik_per_read).
    """
    nf = x_oh.shape[1]
    x_flat = x_oh.reshape(x_oh.shape[0], -1)
    keys = jax.random.split(key, nsteps + 1)
    pi0, theta0 = _m_step(gamma0, x_oh, read_mask, n_true, nf, keys[0], kmask)
    gamma, _ = _e_step(pi0, theta0, x_flat, kmask)

    def step(carry, k):
        gamma = carry
        pi, theta = _m_step(gamma, x_oh, read_mask, n_true, nf, k, kmask)
        gamma, _ = _e_step(pi, theta, x_flat, kmask)
        lik = _loglik(pi, theta, gamma * read_mask[:, None], x_oh, read_mask)
        return gamma, (pi, theta, lik)

    gamma, (pis, thetas, liks) = jax.lax.scan(step, gamma, keys[1:])
    return pis[-1], thetas[-1], gamma, liks[-1]


def _bic(lik_sum, n_true, nf_true, k, zero_param_num):
    n_theta = (k - 1) + k * nf_true * (ALPHA - 1) - zero_param_num
    return 2.0 * lik_sum - n_theta * jnp.log(n_true)


def _em_all_k_core(x_oh, read_mask, gamma0_all, kmask_all, n_true, nf_true,
                   zero_param_num, keys, nsteps: int = NSTEP):
    """vmap EM over the K axis for one window.

    gamma0_all: (MAX_K, N, MAX_K); kmask_all: (MAX_K, MAX_K); keys: (MAX_K,)
    Returns (bics, gammas, pis, thetas).
    """
    run = jax.vmap(lambda g0, km, key: em_run(x_oh, read_mask, g0, km,
                                              n_true, key, nsteps))
    pis, thetas, gammas, liks = run(gamma0_all, kmask_all, keys)
    ks = kmask_all.sum(axis=1)
    bics = jax.vmap(_bic, in_axes=(0, None, None, 0, None))(
        liks.sum(axis=1), n_true, nf_true, ks, zero_param_num)
    return bics, gammas, pis, thetas


_em_all_k = functools.partial(jax.jit, static_argnames=("nsteps",))(_em_all_k_core)

# ---------------------------------------------------------------------------
# K-folded batched EM: all 9 K-runs of a window share one segmented slot
# axis (sum_{K=1..9} K = 45 cluster slots), so each EM step is ONE pair of
# batched matmuls over (windows, reads, nf*5) x (nf*5, 45) instead of nine
# vmapped copies that re-read the one-hot matrix.  Mathematically identical
# to the per-K path (softmax == the reference's reciprocal-sum; segments
# never interact); ~an order of magnitude fewer device ops per step.
# ---------------------------------------------------------------------------

R_TOTAL = MAX_K * (MAX_K + 1) // 2           # 45
SLOT_RUN = np.concatenate([[r] * (r + 1) for r in range(MAX_K)])  # (45,)
RUN_OFF = np.concatenate([[0], np.cumsum(np.arange(1, MAX_K + 1))])[:MAX_K]
SLOT_K = SLOT_RUN + 1                         # K of the run owning the slot
SEG = np.eye(MAX_K)[SLOT_RUN]                 # (45, 9) slot -> run one-hot


def _em_folded_one(codes, hard, n_k, n_true, nf_true, zpn, key,
                   nsteps: int, dtype, psum_axis: str | None = None,
                   read_off=None):
    """One window's 45-slot folded EM.

    psum_axis: when set, the READ axis of this window is sharded over that
    mesh axis (shard_map caller) — the three read reductions (denominator,
    sufficient-statistic counts, log-likelihood) become psums and all other
    ops stay local.  This is SURVEY §5's Ulysses analog: one giant window
    scattered across chips, gamma stays sharded.  read_off: this shard's
    global read offset (for the read-count mask)."""
    n_pad, nf_pad = codes.shape
    seg = jnp.asarray(SEG, dtype)                          # (R, 9)
    slot_run = jnp.asarray(SLOT_RUN)
    slot_k = jnp.asarray(SLOT_K, dtype)
    run_off = jnp.asarray(RUN_OFF)
    rsum = ((lambda v: jax.lax.psum(v, psum_axis)) if psum_axis
            else (lambda v: v))

    x_oh = (codes[..., None] == jnp.arange(ALPHA, dtype=codes.dtype))
    x_flat = x_oh.reshape(n_pad, nf_pad * ALPHA).astype(dtype)
    ridx = jnp.arange(n_pad) + (0 if read_off is None else read_off)
    read_mask = (ridx < n_true).astype(dtype)
    nt = n_true.astype(dtype)
    slot_active = slot_run < n_k                           # (R,)

    # init gamma: run r's hard labels land in slots run_off[r] + label
    slots0 = run_off[:, None] + hard.astype(jnp.int32)     # (9, N)
    g0 = (slots0[..., None] == jnp.arange(R_TOTAL)).astype(dtype)
    run_ok = (jnp.arange(MAX_K) < n_k).astype(dtype)
    gamma0 = (g0 * run_ok[:, None, None]).sum(0) * read_mask[:, None]

    def m_step(gamma, key):
        g = gamma * read_mask[:, None]
        denom = rsum(g.sum(axis=0))                        # (R,)
        counts = rsum(jnp.matmul(g.T, x_flat,
                                 precision=HIGHEST))       # (R, nf*5)
        theta = counts / jnp.where(denom == 0, 1.0, denom)[:, None]
        pi = denom / nt
        # per-run degeneracy: any active slot with pi*N < 1 or NaN
        bad_slot = ((pi * nt < 1) | jnp.isnan(pi)) & slot_active
        bad_run = jnp.matmul(seg.T, bad_slot.astype(dtype),
                             precision=HIGHEST) > 0        # (9,)
        bad = jnp.matmul(seg, bad_run.astype(dtype),
                         precision=HIGHEST) > 0            # (R,)
        # Dirichlet(1) == normalized exponentials (cheap on device)
        e = -jnp.log(jax.random.uniform(key, (R_TOTAL, nf_pad, ALPHA),
                                        dtype=dtype, minval=1e-12))
        dirich = (e / e.sum(-1, keepdims=True)).reshape(R_TOTAL, -1)
        pi = jnp.where(bad, 1.0 / slot_k, pi)
        theta = jnp.where(bad[:, None], dirich, theta)
        return pi, theta

    def e_step(pi, theta):
        logt = jnp.log(jnp.clip(theta, EPS, 1 - EPS))
        M = (jnp.matmul(x_flat, logt.T, precision=HIGHEST)
             + jnp.log(jnp.clip(pi, EPS, 1 - EPS))[None, :])
        M = jnp.where(slot_active[None, :], M, NEG_BIG)
        # segment softmax (== reference reciprocal-sum, src/ReadsCluster.py:153).
        # Segment max/denominator spread via exact gathers, NOT one-hot
        # matmuls: a reduced-precision dot (TF32 on a GPU, oneDNN's fast
        # path on CPU, wherever precision is not pinned) puts a ~2e-4
        # relative error on the inactive-run sentinel (-1e30), so
        # M - m_slot ~ +2e26, whose exp overflows to inf and poisons every
        # segment sum with inf*0=NaN for any window with fewer than
        # MAX_K+1 reads.  Gathers are exact at any precision setting.
        segmax_runs = []
        for r in range(MAX_K):
            o = int(RUN_OFF[r])
            segmax_runs.append(M[:, o:o + r + 1].max(axis=1))
        m_run = jnp.stack(segmax_runs, axis=1)             # (N, 9)
        m_slot = jnp.take(m_run, slot_run, axis=1)         # (N, R) exact
        a = jnp.exp(jnp.clip(M - m_slot, -700.0, 700.0))
        seg_sum = jnp.matmul(a, seg, precision=HIGHEST)   # (N, 9)
        denom = jnp.take(seg_sum, slot_run, axis=1)        # (N, R) exact
        gamma = a / denom
        gamma = jnp.where(slot_active[None, :], gamma, 0.0)
        return gamma, M

    def step(carry, key):
        gamma = carry
        pi, theta = m_step(gamma, key)
        gamma, M = e_step(pi, theta)
        lik_slot = gamma * M                               # (N, R)
        lik_run = (jnp.matmul(lik_slot, seg, precision=HIGHEST)
                   * read_mask[:, None])                   # (N, 9)
        return gamma, rsum(lik_run.sum(axis=0))

    keys = jax.random.split(key, nsteps + 1)
    pi0, theta0 = m_step(gamma0, keys[0])
    gamma, _ = e_step(pi0, theta0)
    gamma, liks = jax.lax.scan(step, gamma, keys[1:])
    lik = liks[-1]                                         # (9,)
    ks = jnp.arange(1, MAX_K + 1, dtype=dtype)
    n_theta = (ks - 1) + ks * nf_true.astype(dtype) * (ALPHA - 1) \
        - zpn.astype(dtype)
    bics = 2.0 * lik - n_theta * jnp.log(nt)
    # re-split segments into the (9, N, 9) per-run gamma layout
    gam_runs = []
    for r in range(MAX_K):
        o = int(RUN_OFF[r])
        pad = jnp.zeros((n_pad, MAX_K - (r + 1)), dtype)
        gam_runs.append(jnp.concatenate([gamma[:, o:o + r + 1], pad], axis=1))
    return bics, jnp.stack(gam_runs, axis=0)


def _em_folded_one_light(codes, hard, n_k, n_true, nf_true, zpn, key,
                         nsteps: int, dtype):
    """Labels-only variant: argmax the per-run gamma on device so the host
    fetch is (9,) bics + (9, N) int8 labels instead of the full (9, N, 9)
    float gamma (localGraph only consumes hard labels,
    src/DecisionMaker.py:143)."""
    bics, gam_runs = _em_folded_one(codes, hard, n_k, n_true, nf_true, zpn,
                                    key, nsteps, dtype)
    return bics, jnp.argmax(gam_runs, axis=2).astype(jnp.int8)


@functools.partial(jax.jit, static_argnames=("nsteps", "dtype"))
def _em_folded_batch(codes, hard, n_k, n_true, nf_true, zpn, keys,
                     nsteps: int = NSTEP, dtype=jnp.float32):
    return jax.vmap(_em_folded_one,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, None, None))(
        codes, hard, n_k, n_true, nf_true, zpn, keys, nsteps, dtype)


@functools.partial(jax.jit, static_argnames=("nsteps", "dtype"))
def _em_folded_batch_light(codes, hard, n_k, n_true, nf_true, zpn, keys,
                           nsteps: int = NSTEP, dtype=jnp.float32):
    return jax.vmap(_em_folded_one_light,
                    in_axes=(0, 0, 0, 0, 0, 0, 0, None, None))(
        codes, hard, n_k, n_true, nf_true, zpn, keys, nsteps, dtype)


# ---------------------------------------------------------------------------
# Read-parallel (mp) EM for oversized windows: SURVEY §5's Ulysses analog.
# Selection caps windows at 3..500 spanning reads
# (src/WindowSelection_v8.py:600,614); windows past MP_READ_THRESHOLD
# scatter their READ axis over the installed data mesh instead of running
# on one chip — the E-step is read-independent given theta, and the three
# read reductions (denominator, counts, log-lik) become psums.
# ---------------------------------------------------------------------------

MP_READ_THRESHOLD = 256
LAST_MP_DISPATCH = {"used": False, "n_shards": 1, "n_windows": 0}
_MP_FN_CACHE: dict = {}


def _mp_folded_fn(mesh, axis: str, nsteps: int, dtype, labels_only: bool):
    """Jitted shard_map of the folded EM with the read axis sharded over
    mesh[axis].  bics replicate (every shard computes them from psummed
    stats); labels/gamma stay read-sharded until the fetch."""
    key = (mesh, axis, nsteps, jnp.dtype(dtype).name, labels_only)
    if key in _MP_FN_CACHE:
        return _MP_FN_CACHE[key]
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(codes_l, hard_l, n_k, n_true, nf_true, zpn, rngkey):
        off = jax.lax.axis_index(axis) * codes_l.shape[0]
        bics, gam = _em_folded_one(codes_l, hard_l, n_k, n_true, nf_true,
                                   zpn, rngkey, nsteps, dtype,
                                   psum_axis=axis, read_off=off)
        if labels_only:
            return bics, jnp.argmax(gam, axis=2).astype(jnp.int8)
        return bics, gam

    in_specs = (P(axis, None), P(None, axis), P(), P(), P(), P(), P())
    out_specs = (P(), P(None, axis) if labels_only else P(None, axis, None))
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=in_specs,
                           out_specs=out_specs))
    _MP_FN_CACHE[key] = fn
    return fn


def _mp_route(feats, mesh, axis: str) -> set[int]:
    """Indices of windows to run read-parallel: above the threshold AND
    their padded read axis divides the mesh."""
    nsh = int(mesh.shape[axis])
    if nsh <= 1:
        return set()
    out = set()
    for i, x in enumerate(feats):
        n = int(np.asarray(x).shape[0])
        if n > MP_READ_THRESHOLD and _bucket(n, READS_LADDER) % nsh == 0:
            out.add(i)
    return out


def _mp_dispatch_one(x, mesh, axis: str, max_c: int, base_key, dtype,
                     nsteps: int, labels_only: bool):
    """Host prep + async read-sharded EM for ONE oversized window.
    Returns (n_k, bics_dev, out_dev)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    x = np.asarray(x)
    n, nf = x.shape
    n_pad = _bucket(n, READS_LADDER)
    nf_pad = _bucket(nf)
    n_k = max(min(max_c + 1, n) - 1, 1)
    codes = np.full((n_pad, nf_pad), PAD_CODE, np.int8)
    codes[:n, :nf] = x
    hard = np.zeros((MAX_K, n_pad), np.int8)
    hard[:min(n_k, MAX_K), :n] = ward_init_labels(x, min(n_k, MAX_K))
    np_dtype = np.dtype(jnp.dtype(dtype))
    dev_c, dev_h = jax.device_put(
        (codes, hard), (NamedSharding(mesh, P(axis, None)),
                        NamedSharding(mesh, P(None, axis))))
    fn = _mp_folded_fn(mesh, axis, nsteps, dtype, labels_only)
    bics_d, out_d = fn(dev_c, dev_h, np.int32(n_k), np.int32(n),
                       np_dtype.type(nf), np_dtype.type(zero_param_count(x)),
                       np.asarray(base_key))
    return n_k, bics_d, out_d


_KEY_CACHE: dict[tuple[int, int], np.ndarray] = {}

# Reference parity: EMCluster re-runs EM while BIC is NaN, up to 5 total
# attempts per K (src/ReadsCluster.py:247-252: ClusterCount=5 decremented
# per run).  Each attempt here re-keys the degenerate-re-init RNG; slots
# that produced a finite BIC keep their first finite result, exactly like
# the reference's per-K while loop.
MAX_EM_ATTEMPTS = 5


def _host_prng_key(seed: int, attempt: int = 0) -> np.ndarray:
    """Host copy of jax.random.PRNGKey(seed) (fold_in(attempt) for NaN-BIC
    retries) — building the key on device and fetching it back costs two
    device round trips per dispatch."""
    k = (seed, attempt)
    if k not in _KEY_CACHE:
        key = jax.random.PRNGKey(seed)
        if attempt:
            key = jax.random.fold_in(key, attempt)
        _KEY_CACHE[k] = np.asarray(key)
    return _KEY_CACHE[k]


def zero_param_count(seqdatamx: np.ndarray) -> int:
    """Number of (symbol, column) cells with zero count
    (src/ReadsCluster.py:225-234)."""
    x = np.asarray(seqdatamx)
    counts = np.stack([(x == a).sum(axis=0) for a in range(ALPHA)])
    return int((counts == 0).sum())


def _bucket(x: int, ladder=SHAPE_LADDER):
    for b in ladder:
        if x <= b:
            return b
    return x


def _prepare_window(x: np.ndarray, max_c: int, n_pad: int, nf_pad: int):
    """Host-side prep of one window for the jitted EM: one-hot matrix,
    Ward-init hard assignments for every K, masks and counts."""
    n, nf = x.shape
    kmax_excl = min(max_c + 1, n)
    n_k = max(kmax_excl - 1, 1)
    hard = ward_init_labels(x, min(n_k, MAX_K))
    x_oh = np.zeros((n_pad, nf_pad, ALPHA), dtype=np.float64)
    valid = x < ALPHA
    idx = np.where(valid)
    x_oh[idx[0], idx[1], x[valid]] = 1.0
    gamma0_all = np.zeros((MAX_K, n_pad, MAX_K), np.float64)
    kmask_all = np.zeros((MAX_K, MAX_K), bool)
    for ki in range(n_k):
        kmask_all[ki, :ki + 1] = True
        gamma0_all[ki, np.arange(n), hard[ki]] = 1.0
    read_mask = np.zeros(n_pad, np.float64)
    read_mask[:n] = 1.0
    return x_oh, read_mask, gamma0_all, kmask_all, n_k, zero_param_count(x)


def _select_result(x, bics, gammas, pis, thetas, n_k):
    """BIC argmax + K=1->2 tie-break + slicing, shared by single/batch.
    pis/thetas may be None (light batch path)."""
    n, nf = x.shape
    bics = np.array(bics, np.float64)
    bics[n_k:] = np.nan
    if np.isnan(bics[:n_k]).all():
        # every K diverged after the upstream MAX_EM_ATTEMPTS re-keyed
        # retries (the reference crashes at nanargmax here,
        # src/ReadsCluster.py:264); degrade to a single cluster
        return [1, x, np.zeros(n, np.int64), None,
                np.ones((n, 1), np.float64), None, bics[:n_k]]
    sel = int(np.nanargmax(bics))
    k_sel = sel + 1
    if k_sel == 1 and n_k >= 2 and (bics[0] - bics[1] <= nf * np.log(n)):
        sel, k_sel = 1, 2
    gamma = np.array(gammas[sel], np.float64)[:n, :k_sel]
    theta = np.array(thetas[sel], np.float64)[:k_sel] if thetas is not None else None
    pi = np.array(pis[sel], np.float64)[:k_sel] if pis is not None else None
    labels = np.argmax(gamma, axis=1)
    return [k_sel, x, labels, theta, gamma, pi, bics[:n_k]]


def _raw_em_dispatch(feats: list[np.ndarray], max_c: int,
                     base_key: np.ndarray, dtype, nsteps: int,
                     labels_only: bool):
    """Host prep + async device EM over shape buckets.  Returns a fetch()
    closure producing raw per-window tuples (bics (MAX_K,), per-K output
    — int8 labels (MAX_K, N) or gamma (MAX_K, N, MAX_K) —, n_k)."""
    results: list = [None] * len(feats)
    from ..parallel.dataparallel import data_mesh
    mesh, maxis = data_mesh()
    mp_idx: set[int] = _mp_route(feats, mesh, maxis) if mesh is not None \
        else set()
    mp_pending = []          # (feat index, n_k, bics_dev, out_dev)
    for i in sorted(mp_idx):
        n_k, bics_d, out_d = _mp_dispatch_one(
            feats[i], mesh, maxis, max_c, base_key, dtype, nsteps,
            labels_only)
        mp_pending.append((i, n_k, bics_d, out_d))
    LAST_MP_DISPATCH.update(
        used=bool(mp_pending),
        n_shards=int(mesh.shape[maxis]) if mp_pending else 1,
        n_windows=len(mp_pending))
    groups: dict[tuple[int, int], list[int]] = {}
    for i, x in enumerate(feats):
        if i in mp_idx:
            continue
        key = (_bucket(x.shape[0], READS_LADDER),
               _bucket(x.shape[1]))
        groups.setdefault(key, []).append(i)
    # fixed batch-axis buckets: one chunk = one compiled shape; pad chunks
    # by repeating the first window (results discarded)
    chunks = []
    for key, idxs in groups.items():
        for off in range(0, len(idxs), MAX_BATCH):
            chunks.append((key, idxs[off:off + MAX_BATCH]))
    pending: list = []
    for (n_pad, nf_pad), idxs in chunks:
        b_pad = _bucket(len(idxs), ladder=BATCH_LADDER)
        codes = np.full((b_pad, n_pad, nf_pad), PAD_CODE, np.int8)
        hard_b = np.zeros((b_pad, MAX_K, n_pad), np.int8)
        nks = np.ones(b_pad, np.int32)
        ns = np.zeros(b_pad, np.int32)
        nfs = np.zeros(b_pad, np.int32)
        zps = np.zeros(b_pad, np.float64)
        for bi, i in enumerate(idxs):
            x = np.asarray(feats[i])
            ns[bi], nfs[bi] = x.shape
            codes[bi, :x.shape[0], :x.shape[1]] = x
        nb = len(idxs)
        # batched pairwise identity + zero-param counts via a one-hot
        # batched matmul: eq(i,j) = sum_a <x_i==a, x_j==a>.  PAD_CODE is
        # outside the 0..4 alphabet, so pad rows/columns contribute 0 and
        # no correction terms are needed.  Counts are integers <= nf_pad
        # << 2^24, exact in f32; BLAS does the O(nb*n^2*nf*5) work without
        # ever materializing the (nb, n, n, nf) comparison tensor.
        sims = zps_b = None
        if nb * n_pad * n_pad * nf_pad * ALPHA <= (1 << 29):
            c = codes[:nb]
            oh = (c[..., None] == np.arange(ALPHA, dtype=c.dtype))
            oh_f = oh.reshape(nb, n_pad, nf_pad * ALPHA).astype(np.float32)
            sims = np.matmul(oh_f, oh_f.transpose(0, 2, 1))  # (nb, n, n)
            zps_b = oh.sum(axis=1)                    # (nb, nf_pad, ALPHA)
        sim_list = []
        for bi, i in enumerate(idxs):
            x = np.asarray(feats[i])
            n, nf = x.shape
            nks[bi] = max(min(max_c + 1, n) - 1, 1)
            if sims is not None:
                sim = (sims[bi, :n, :n] / max(nf, 1)).astype(np.float64)
                np.fill_diagonal(sim, 1.0)
                zps[bi] = float((zps_b[bi, :nf] == 0).sum())
            else:
                sim = pairwise_identity(x)
                zps[bi] = zero_param_count(x)
            sim_list.append(sim)
        # one threaded C++ call for every window's Ward-cut init (the
        # per-window Python NN-chain was 23% of the localGraph chunk wall)
        cuts = ward_cut_many(sim_list, MAX_K)
        for bi, i in enumerate(idxs):
            n = sim_list[bi].shape[0]
            kmin = min(int(nks[bi]), MAX_K)
            hard_b[bi, :kmin, :n] = cuts[bi][:kmin]
        if len(idxs) < b_pad:                # batch-axis padding
            codes[len(idxs):] = codes[0]
            hard_b[len(idxs):] = hard_b[0]
            nks[len(idxs):] = nks[0]
            ns[len(idxs):] = ns[0]
            nfs[len(idxs):] = nfs[0]
            zps[len(idxs):] = zps[0]
        # per-window key fixed by seed (deterministic and independent of
        # batch composition; RNG is only consumed on degenerate re-inits)
        keys = np.broadcast_to(base_key, (b_pad,) + base_key.shape)
        kernel = _em_folded_batch_light if labels_only else _em_folded_batch
        # ONE batched host->device transfer instead of one per array.
        # With a data mesh installed (parallel/dataparallel) the window
        # axis is sharded across chips — windows are independent, so the
        # folded EM runs SPMD with zero collectives.
        from ..parallel.dataparallel import shard_batch
        np_dtype = np.dtype(jnp.dtype(dtype))
        dev = shard_batch((codes, hard_b, nks, ns, nfs,
                           zps.astype(np_dtype), keys))
        bics_b, gammas_b = kernel(*dev, nsteps, dtype)
        pending.append((idxs, nks, bics_b, gammas_b))

    def fetch():
        # one batched fetch (each separate np.array() is a round trip)
        fetched = jax.device_get([(b, g) for _, _, b, g in pending]
                                 + [(b, o) for _, _, b, o in mp_pending])
        for (idxs, nks, _, _), (bics_b, gammas_b) in zip(pending, fetched):
            for bi, i in enumerate(idxs):
                results[i] = (np.array(bics_b[bi], np.float64),
                              np.array(gammas_b[bi]), int(nks[bi]))
        for (i, n_k, _, _), (bics, out) in zip(mp_pending,
                                               fetched[len(pending):]):
            results[i] = (np.array(bics, np.float64), np.array(out), n_k)
        return results

    return fetch


def em_cluster_batch_dispatch(feats: list[np.ndarray], max_c: int = MAX_K,
                              seed: int = 2023, dtype=jnp.float32,
                              nsteps: int = NSTEP, labels_only: bool = False):
    """Async half of em_cluster_batch: host prep + device dispatch for every
    shape bucket, returning a fetch() closure that blocks on the single
    batched device_get, applies the reference's NaN-BIC retry policy (up to
    MAX_EM_ATTEMPTS re-keyed runs per K, src/ReadsCluster.py:247-252) and
    finishes selection.  Lets the caller overlap the device EM with host
    work (localGraph overlaps the previous chunk's consensus emission)."""
    raw_fetch = _raw_em_dispatch(feats, max_c, _host_prng_key(seed), dtype,
                                 nsteps, labels_only)

    def fetch():
        raws = raw_fetch()
        need = [i for i, (b, _o, nk) in enumerate(raws)
                if np.isnan(b[:nk]).any()]
        for attempt in range(1, MAX_EM_ATTEMPTS):
            if not need:
                break
            subs = _raw_em_dispatch([feats[i] for i in need], max_c,
                                    _host_prng_key(seed, attempt), dtype,
                                    nsteps, labels_only)()
            still = []
            for i, (b2, o2, nk) in zip(need, subs):
                b, o, _nk = raws[i]
                bad = np.flatnonzero(np.isnan(b[:nk]))
                b[bad] = b2[bad]          # last attempt wins on NaN slots
                o[bad] = o2[bad]
                if np.isnan(b[:nk]).any():
                    still.append(i)
            need = still
        out = []
        for x, (b, o, nk) in zip(feats, raws):
            x = np.asarray(x)
            if labels_only:
                out.append(_select_result_labels(x, b, o, nk))
            else:
                out.append(_select_result(x, b, o, None, None, nk))
        return out

    return fetch


def _select_result_labels(x, bics, labels_all, n_k):
    """_select_result over device-computed hard labels (labels_only path).
    Same BIC argmax + K=1->2 tie-break; gamma/theta/pi omitted (the
    localGraph consumer only reads K, labels and bics)."""
    n, nf = x.shape
    bics = np.array(bics, np.float64)
    bics[n_k:] = np.nan
    if np.isnan(bics[:n_k]).all():
        return [1, x, np.zeros(n, np.int64), None,
                np.ones((n, 1), np.float64), None, bics[:n_k]]
    sel = int(np.nanargmax(bics))
    k_sel = sel + 1
    if k_sel == 1 and n_k >= 2 and (bics[0] - bics[1] <= nf * np.log(n)):
        sel, k_sel = 1, 2
    labels = np.asarray(labels_all[sel][:n], np.int64)
    return [k_sel, x, labels, None, None, None, bics[:n_k]]


def em_cluster_batch(feats: list[np.ndarray], max_c: int = MAX_K,
                     seed: int = 2023, dtype=jnp.float32, nsteps: int = NSTEP):
    """Batched EMCluster over many windows.

    Windows are grouped into (reads, features) shape buckets; each bucket is
    one vmapped device call over (window, K, EM-scan) — the throughput
    path for localGraph.  Per-window results are identical to em_cluster.
    """
    return em_cluster_batch_dispatch(feats, max_c=max_c, seed=seed,
                                     dtype=dtype, nsteps=nsteps)()


def em_cluster(seqdatamx: np.ndarray, max_c: int = MAX_K, seed: int = 2023,
               dtype=jnp.float32, nsteps: int = NSTEP, pad_shapes: bool = True):
    """EMCluster equivalent (src/ReadsCluster.py:221-277).

    Returns [K, seqdatamx, labels, theta, gamma, pi, bic_list] like the
    reference.  Host wrapper around the jitted all-K batch; the engine's
    batched path calls _em_all_k directly on padded window batches.

    pad_shapes: pad (reads, features) up to power-of-two buckets so the jit
    cache stays small across windows of varying size; padding is exact
    (masked rows, zero one-hots) — results are unchanged.
    """
    x = np.asarray(seqdatamx)
    n, nf = x.shape
    n_pad = _bucket(n, READS_LADDER) if pad_shapes else n
    nf_pad = _bucket(nf) if pad_shapes else nf
    x_oh, read_mask, gamma0_all, kmask_all, n_k, zpn = _prepare_window(
        x, max_c, n_pad, nf_pad)
    cast = lambda a: jnp.asarray(a, dtype=dtype)
    args = (cast(x_oh), cast(read_mask), cast(gamma0_all),
            jnp.asarray(kmask_all), jnp.asarray(float(n), dtype=dtype),
            jnp.asarray(float(nf), dtype=dtype),
            jnp.asarray(float(zpn), dtype=dtype))
    run = lambda a: jax.random.split(jnp.asarray(_host_prng_key(seed, a)),
                                     MAX_K)
    bics, gammas, pis, thetas = (np.array(v, np.float64) for v in
                                 _em_all_k(*args, run(0), nsteps))
    # reference NaN-BIC retry: up to MAX_EM_ATTEMPTS re-keyed runs per K
    # (src/ReadsCluster.py:247-252); finite slots keep their first result
    for attempt in range(1, MAX_EM_ATTEMPTS):
        bad = np.flatnonzero(np.isnan(bics[:n_k]))
        if bad.size == 0:
            break
        b2, g2, p2, t2 = (np.array(v, np.float64) for v in
                          _em_all_k(*args, run(attempt), nsteps))
        bics[bad], gammas[bad], pis[bad], thetas[bad] = \
            b2[bad], g2[bad], p2[bad], t2[bad]
    return _select_result(x, bics, gammas, pis, thetas, n_k)
