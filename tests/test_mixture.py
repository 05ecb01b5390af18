import os
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from svscope_tpu.models.mixture import (em_cluster, pairwise_identity,
                                        ward_init_labels, zero_param_count)

REF_SRC = "/root/reference/src"


def _make_two_cluster(rng, n1=6, n2=6, nf=24, noise=0.03):
    a = rng.integers(0, 4, (1, nf))
    b = rng.integers(0, 4, (1, nf))
    # ensure the two archetypes differ in most columns
    b = np.where(a == b, (b + 1) % 4, b)
    x = np.concatenate([np.repeat(a, n1, 0), np.repeat(b, n2, 0)])
    flip = rng.random(x.shape) < noise
    x = np.where(flip, rng.integers(0, 5, x.shape), x)
    return x.astype(np.int64)


def test_pairwise_identity():
    x = np.array([[0, 1, 2], [0, 1, 3], [0, 1, 2]])
    d = pairwise_identity(x)
    assert d[0, 1] == pytest.approx(2 / 3)
    assert d[0, 2] == pytest.approx(1.0)
    assert d[0, 0] == 1.0


def test_zero_param_count():
    x = np.array([[0, 1], [0, 1]])
    # col0: only symbol 0 -> 4 zeros; col1: only symbol 1 -> 4 zeros
    assert zero_param_count(x) == 8


def test_em_two_clusters():
    rng = np.random.default_rng(11)
    x = _make_two_cluster(rng)
    K, _, labels, theta, gamma, pi, bics = em_cluster(x, dtype=jnp.float64)
    assert K == 2
    assert len(set(labels[:6])) == 1 and len(set(labels[6:])) == 1
    assert labels[0] != labels[6]
    assert gamma.shape == (12, 2)
    np.testing.assert_allclose(gamma.sum(1), 1.0, atol=1e-6)


def test_em_homogeneous_reads():
    """Homogeneous reads: K collapses to 1 unless the K=1->2 BIC tie-break
    fires (src/ReadsCluster.py:269-272); either way no junk K."""
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, (1, 15))
    x = np.repeat(a, 8, 0)
    K, _, labels, *_ = em_cluster(x, dtype=jnp.float64)
    assert K in (1, 2)


def test_em_three_clusters():
    rng = np.random.default_rng(23)
    a0 = rng.integers(0, 4, 30)
    arch = [a0, (a0 + 1) % 4, (a0 + 2) % 4]  # pairwise distinct in every col
    x = np.concatenate([np.repeat(a[None], 5, 0) for a in arch])
    K, _, labels, *_ = em_cluster(x, dtype=jnp.float64)
    assert K >= 3
    for g in range(3):
        seg = labels[g * 5:(g + 1) * 5]
        assert len(set(seg)) == 1


@pytest.mark.skipif(not os.path.isdir(REF_SRC), reason="reference not mounted")
def test_label_parity_vs_reference_emcluster():
    """Cluster-label parity against the reference EMCluster on structured
    windows (the parity contract per SURVEY.md §7.3: labels, not floats)."""
    import matplotlib
    matplotlib.use("Agg")
    sys.path.insert(0, REF_SRC)
    try:
        import ReadsCluster as ref_rc
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"reference ReadsCluster unimportable: {exc}")
    finally:
        sys.path.remove(REF_SRC)
    rng = np.random.default_rng(42)
    for trial in range(3):
        x = _make_two_cluster(rng, nf=20 + 4 * trial)
        K_ref, _, lab_ref, *_ = ref_rc.EMCluster(x, initselection=1)
        K_new, _, lab_new, *_ = em_cluster(x, dtype=jnp.float64)
        assert K_new == K_ref
        # labels equal up to permutation
        perm = {}
        ok = True
        for a, b in zip(lab_ref, lab_new):
            if a in perm:
                ok = ok and perm[a] == b
            else:
                perm[a] = b
        assert ok and len(set(perm.values())) == len(perm)


def test_small_window_folded_em_no_nan():
    """Windows with fewer than MAX_K+1 reads have inactive K runs whose
    -1e30 sentinel must not poison the segment softmax (regression: the
    one-hot segment matmuls ran at bf16-level precision and inf*0 NaN'd
    every BIC for n <= 9)."""
    from svscope_tpu.models.mixture import em_cluster_batch
    rng = np.random.default_rng(123)
    feats = []
    for t in range(24):
        n = int(rng.integers(4, 10))        # below MAX_K + 1
        nf = int(rng.integers(12, 60))
        k_true = int(rng.integers(1, 3))
        protos = rng.integers(0, 4, (k_true, nf))
        x = protos[rng.integers(0, k_true, n)]
        flip = rng.random(x.shape) < 0.04
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    for res, x in zip(em_cluster_batch(feats), feats):
        assert res[0] >= 1
        assert not np.isnan(np.asarray(res[4], np.float64)).any()


@pytest.mark.skipif(not os.path.isdir(REF_SRC), reason="reference not mounted")
def test_label_parity_soak_small_and_large():
    """Partition-identical to the reference EMCluster over randomized
    matrices spanning the small-n regime."""
    import matplotlib
    matplotlib.use("Agg")
    sys.path.insert(0, REF_SRC)
    try:
        import ReadsCluster as ref_rc
    except Exception as exc:
        pytest.skip(f"reference ReadsCluster unimportable: {exc}")
    finally:
        sys.path.remove(REF_SRC)
    from svscope_tpu.models.mixture import em_cluster_batch
    rng = np.random.default_rng(7)
    feats = []
    for t in range(30):
        n = int(rng.integers(5, 36))
        nf = int(rng.integers(12, 80))
        k_true = int(rng.integers(1, 4))
        protos = rng.integers(0, 4, (k_true, nf))
        x = protos[rng.integers(0, k_true, n)]
        flip = rng.random(x.shape) < 0.04
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    ours = em_cluster_batch(feats)
    for x, res in zip(feats, ours):
        ref = ref_rc.EMCluster(np.asarray(x, np.int64), initselection=1)
        labels_ref = np.asarray(ref[2])
        labels_our = np.asarray(res[2])
        assert ref[0] == res[0]
        part_ref = {tuple(np.flatnonzero(labels_ref == l))
                    for l in set(labels_ref.tolist())}
        part_our = {tuple(np.flatnonzero(labels_our == l))
                    for l in set(labels_our.tolist())}
        assert part_ref == part_our


def test_labels_only_dispatch_matches_full_path():
    """The localGraph labels_only fetch (device argmax, int8 transfer) must
    select the same K and hard labels as the full-gamma path."""
    from svscope_tpu.models.mixture import (em_cluster_batch,
                                            em_cluster_batch_dispatch)
    rng = np.random.default_rng(11)
    feats = []
    for t in range(20):
        n = int(rng.integers(4, 40))
        nf = int(rng.integers(10, 70))
        k_true = int(rng.integers(1, 4))
        protos = rng.integers(0, 4, (k_true, nf))
        x = protos[rng.integers(0, k_true, n)]
        flip = rng.random(x.shape) < 0.05
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    full = em_cluster_batch(feats)
    light = em_cluster_batch_dispatch(feats, labels_only=True)()
    for f, l in zip(full, light):
        assert f[0] == l[0]
        # both paths argmax the same device gamma -> labels are identical
        assert np.array_equal(f[2], l[2])
        np.testing.assert_allclose(f[6], l[6], rtol=0, atol=0,
                                   equal_nan=True)


def test_ward_cuts_match_scipy_fcluster_partitions():
    """The vectorized small-to-large ward cut labeling must produce the same
    partition as scipy fcluster(maxclust=K) for every K, on random feature
    matrices (label names are first-occurrence order, so compare as
    partitions)."""
    from scipy.cluster.hierarchy import linkage, fcluster
    from svscope_tpu.models.mixture import pairwise_identity
    for t in range(25):
        rng = np.random.default_rng(100 + t)
        n = int(rng.integers(4, 40))
        nf = int(rng.integers(12, 60))
        x = rng.integers(0, 5, (n, nf)).astype(np.int8)
        lab = ward_init_labels(x, 9)
        Z = linkage(pairwise_identity(x), "ward")
        for k in range(2, min(9, n) + 1):
            fc = fcluster(Z, k, criterion="maxclust")
            ours = lab[k - 1]
            part_ref = {tuple(np.flatnonzero(fc == l))
                        for l in set(fc.tolist())}
            part_our = {tuple(np.flatnonzero(ours == l))
                        for l in set(ours.tolist())}
            assert part_ref == part_our, (t, k)
            # first-occurrence labeling: labels appear in increasing order
            first = [int(ours[np.flatnonzero(ours == l)[0]])
                     for l in sorted(set(ours.tolist()))]
            assert first == sorted(first)


def test_nan_bic_retry_recovers(monkeypatch):
    """Reference parity (src/ReadsCluster.py:247-252): a NaN BIC re-runs EM
    with fresh RNG up to 5 total attempts.  Poison the first device call and
    check the batch path recovers the clean result on attempt 2."""
    import svscope_tpu.models.mixture as mx
    rng = np.random.default_rng(7)
    feats = [_make_two_cluster(rng, n1=5, n2=5, nf=20) for _ in range(3)]
    clean = mx.em_cluster_batch(feats, dtype=jnp.float64)
    calls = {"n": 0}
    real = mx._em_folded_batch

    def flaky(*args, **kw):
        calls["n"] += 1
        bics, gammas = real(*args, **kw)
        if calls["n"] == 1:
            bics = jnp.full_like(bics, jnp.nan)
        return bics, gammas

    monkeypatch.setattr(mx, "_em_folded_batch", flaky)
    out = mx.em_cluster_batch(feats, dtype=jnp.float64)
    assert calls["n"] == 2          # one retry round fixed every window
    for c, o in zip(clean, out):
        assert o[0] == c[0]
        assert (o[2] == c[2]).all()


def test_nan_bic_retry_exhausts_to_k1(monkeypatch):
    """All MAX_EM_ATTEMPTS runs NaN: the reference crashes at nanargmax
    (src/ReadsCluster.py:264); we degrade gracefully to K=1 after exactly
    MAX_EM_ATTEMPTS dispatches."""
    import svscope_tpu.models.mixture as mx
    rng = np.random.default_rng(8)
    feats = [_make_two_cluster(rng, n1=4, n2=4, nf=16)]
    calls = {"n": 0}
    real = mx._em_folded_batch

    def always_nan(*args, **kw):
        calls["n"] += 1
        bics, gammas = real(*args, **kw)
        return jnp.full_like(bics, jnp.nan), gammas

    monkeypatch.setattr(mx, "_em_folded_batch", always_nan)
    out = mx.em_cluster_batch(feats, dtype=jnp.float64)
    assert calls["n"] == mx.MAX_EM_ATTEMPTS
    K, _, labels, *_ = out[0]
    assert K == 1 and (labels == 0).all()


def test_nan_bic_retry_single_window(monkeypatch):
    """Same policy on the single-window em_cluster path (_em_all_k)."""
    import svscope_tpu.models.mixture as mx
    rng = np.random.default_rng(9)
    x = _make_two_cluster(rng, n1=5, n2=5, nf=20)
    clean = mx.em_cluster(x, dtype=jnp.float64)
    calls = {"n": 0}
    real = mx._em_all_k

    def flaky(*args, **kw):
        calls["n"] += 1
        bics, gammas, pis, thetas = real(*args, **kw)
        if calls["n"] == 1:
            bics = jnp.full_like(bics, jnp.nan)
        return bics, gammas, pis, thetas

    monkeypatch.setattr(mx, "_em_all_k", flaky)
    out = mx.em_cluster(x, dtype=jnp.float64)
    assert calls["n"] == 2
    assert out[0] == clean[0]
    assert (out[2] == clean[2]).all()


def test_ward_linkage_matches_scipy_exactly():
    """ward_linkage (pure NumPy NN-chain) vs scipy.linkage(X, 'ward'):
    merge pairs, heights and sizes identical, on randomized float inputs
    AND tie-heavy small-int inputs (where argmin tie-breaks matter)."""
    from scipy.cluster.hierarchy import linkage as scipy_linkage
    from svscope_tpu.models.mixture import ward_linkage
    for t in range(40):
        rng = np.random.default_rng(300 + t)
        n = int(rng.integers(3, 60))
        nf = int(rng.integers(2, 30))
        if t % 2 == 0:
            X = rng.random((n, nf))
        else:                                  # tie-heavy: few distinct rows
            arch = rng.integers(0, 3, (max(2, n // 4), nf))
            X = arch[rng.integers(0, arch.shape[0], n)].astype(np.float64)
        Z0 = scipy_linkage(X, "ward")
        Z1 = ward_linkage(X)
        assert (Z0[:, :2] == Z1[:, :2]).all(), t
        assert (Z0[:, 3] == Z1[:, 3]).all(), t
        np.testing.assert_allclose(Z1[:, 2], Z0[:, 2], rtol=1e-12, atol=0)


def test_ward_linkage_on_similarity_matrices():
    """The production input shape: pairwise_identity matrices of encoded
    windows (integer ratios — heavy exact ties)."""
    from scipy.cluster.hierarchy import linkage as scipy_linkage
    from svscope_tpu.models.mixture import pairwise_identity, ward_linkage
    for t in range(25):
        rng = np.random.default_rng(600 + t)
        n = int(rng.integers(4, 48))
        nf = int(rng.integers(10, 60))
        x = rng.integers(0, 5, (n, nf)).astype(np.int8)
        sim = pairwise_identity(x)
        Z0 = scipy_linkage(sim, "ward")
        Z1 = ward_linkage(sim)
        assert (Z0[:, :2] == Z1[:, :2]).all(), t


def test_native_pdist_bitwise_matches_python_and_scipy():
    """The C++ pdist kernel (native/hcluster.cpp) must be bitwise-identical
    to BOTH the sequential NumPy fallback and scipy's pdist — it feeds the
    tie-sensitive Ward NN-chain, where a 1-ulp difference reorders merges."""
    pytest.importorskip("svscope_tpu.native.hcluster")
    from scipy.spatial.distance import pdist as sp_pdist, squareform
    from svscope_tpu.native.hcluster import pdist_seq
    rng = np.random.default_rng(9)
    for n, nf in [(3, 2), (17, 5), (64, 64), (200, 123), (500, 70)]:
        x = rng.random((n, nf))
        xq = np.round(x * 8) / 8           # tie-heavy quantized variant
        for obs in (x, xq):
            ref = squareform(sp_pdist(obs))
            got = pdist_seq(obs)
            np.fill_diagonal(ref, 0.0)
            assert (got == ref).all(), (n, nf)
            # both thread counts take the same fp path
            assert (pdist_seq(obs, n_threads=4) == ref).all(), (n, nf)


def test_nan_bic_retry_labels_only(monkeypatch):
    """Retry policy through the labels_only dispatch (the localGraph
    production path uses _em_folded_batch_light)."""
    import svscope_tpu.models.mixture as mx
    rng = np.random.default_rng(12)
    feats = [_make_two_cluster(rng, n1=5, n2=5, nf=18) for _ in range(2)]
    clean = mx.em_cluster_batch_dispatch(feats, labels_only=True,
                                         dtype=jnp.float64)()
    calls = {"n": 0}
    real = mx._em_folded_batch_light

    def flaky(*args, **kw):
        calls["n"] += 1
        bics, labels = real(*args, **kw)
        if calls["n"] == 1:
            bics = jnp.full_like(bics, jnp.nan)
        return bics, labels

    monkeypatch.setattr(mx, "_em_folded_batch_light", flaky)
    out = mx.em_cluster_batch_dispatch(feats, labels_only=True,
                                       dtype=jnp.float64)()
    assert calls["n"] == 2
    for c, o in zip(clean, out):
        assert o[0] == c[0] and (o[2] == c[2]).all()


def test_native_ward_cut_batch_bitwise_matches_python():
    """The C++ ward_cut_batch (native/hcluster.cpp) must produce the exact
    labels of the NumPy NN-chain oracle (_ward_init_labels_py, itself
    scipy-parity-tested above) — it replaces the per-window Python Ward
    init on the EM dispatch hot path (23% of the localGraph chunk wall
    before round 5)."""
    pytest.importorskip("svscope_tpu.native.hcluster")
    from svscope_tpu.native.hcluster import ward_cut_batch
    from svscope_tpu.models.mixture import (_ward_init_labels_py,
                                            pairwise_identity)
    rng = np.random.default_rng(7)
    sims = []
    for trial in range(60):
        n = int(rng.integers(2, 40))
        nf = int(rng.integers(10, 80))
        x = rng.integers(0, 5, (n, nf)).astype(np.int8)
        if trial % 3 == 0:      # tie-heavy: few distinct rows
            base = rng.integers(0, 5, (3, nf))
            x = base[rng.integers(0, 3, n)].astype(np.int8)
        sims.append(pairwise_identity(x))
    # one heavy-tail window (500-read selection cap,
    # src/WindowSelection_v8.py:600,614)
    sims.append(pairwise_identity(
        rng.integers(0, 5, (500, 40)).astype(np.int8)))
    py = [_ward_init_labels_py(None, 9, sim=s) for s in sims]
    nat = ward_cut_batch(sims, 9, n_threads=2)
    nat1 = ward_cut_batch(sims, 9, n_threads=1)
    for a, b, c in zip(py, nat, nat1):
        assert a.shape == b.shape and (a == b).all()
        assert (b == c).all()           # threading never changes labels


def test_ward_init_labels_wrapper_equals_oracle():
    """Public ward_init_labels (native fast path + fallback) always equals
    the NumPy oracle, with and without a precomputed sim."""
    from svscope_tpu.models.mixture import (_ward_init_labels_py,
                                            pairwise_identity,
                                            ward_init_labels)
    rng = np.random.default_rng(11)
    for n in (1, 2, 3, 9, 24):
        x = rng.integers(0, 5, (n, 30)).astype(np.int8)
        want = _ward_init_labels_py(x, 9)
        assert (ward_init_labels(x, 9) == want).all()
        if n >= 2:
            sim = pairwise_identity(x)
            assert (ward_init_labels(x, 9, sim=sim) == want).all()


def _dot_precisions(jaxpr):
    """precision of every dot_general in a jaxpr, sub-jaxprs included."""
    from jax.extend import core
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            subs = v if isinstance(v, (tuple, list)) else (v,)
            for sub in subs:
                if isinstance(sub, core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("path", ["folded", "per_k", "mesh"])
def test_em_dots_pinned_to_highest(path):
    """Every dot of the EM paths whose results feed labels or BIC runs at
    Precision.HIGHEST (a GPU would otherwise use TF32 for f32 dots)."""
    import jax
    import jax.numpy as jnp
    import svscope_tpu.models.mixture as mx
    f32 = jnp.float32
    if path == "folded":
        fn = lambda c, h: mx._em_folded_one(
            c, h, jnp.int32(3), jnp.int32(8), f32(6), f32(0),
            jnp.zeros(2, jnp.uint32), 4, f32)
        args = (jnp.zeros((8, 6), jnp.int8), jnp.zeros((9, 8), jnp.int8))
    elif path == "per_k":
        fn = lambda x, g: mx._em_all_k_core(
            x, jnp.ones(8, f32), g, jnp.ones((9, 9), bool), f32(8), f32(6),
            f32(0), jax.random.split(jax.random.PRNGKey(0), 9), 4)
        args = (jnp.zeros((8, 6, 5), f32), jnp.zeros((9, 8, 9), f32))
    else:
        from svscope_tpu.parallel.mesh import _local_em_scan
        fn = lambda x, g: jax.vmap(
            lambda *a: _local_em_scan(*a, nsteps=3), axis_name="mp")(
            x[None], jnp.ones((1, 2, 8), f32), g[None],
            jnp.ones((1, 2, 9), bool), jnp.full((1, 2), 8.0, f32))
        args = (jnp.zeros((2, 8, 6, 5), f32), jnp.zeros((2, 8, 9), f32))
    precs = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precs, "no dots found"
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(q == hi for q in p) for p in precs), \
        precs
