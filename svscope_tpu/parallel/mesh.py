"""Device-mesh plumbing: sharded batched EM over (windows x reads).

The reference's only parallelism is a 6-process pool over windows
(src/SVscope.py:158-161).  The replacement here is a 2-D
`jax.sharding.Mesh`:

  * axis "dp" — data parallel over candidate windows (the embarrassing
    axis; replaces the process pool)
  * axis "mp" — model-ish parallel over the read axis inside each window:
    the E-step is row-independent given theta, and the M-step's
    sufficient statistics are read-axis sums, reduced with
    `jax.lax.psum` over "mp" (so one giant window can be spread over
    devices — the analog of tensor parallelism for this workload)

Multi-host: every process feeds its local shard of the window stream
(parallel/shard.py).  The mesh follows the algorithm's axes only; the
devices of a host are joined all to all.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.jaxcfg import enable_cache

enable_cache()
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models.mixture import ALPHA, EPS, HIGHEST, MAX_K, NEG_BIG, NSTEP


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Factorize devices into a (dp, mp) mesh; mp gets the smaller factor."""
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    n = len(devices)
    mp = 1
    for cand in (2, 4, 8):
        if n % cand == 0 and n // cand >= cand:
            mp = cand
    dp = n // mp
    arr = np.array(devices).reshape(dp, mp)
    return Mesh(arr, ("dp", "mp"))


def _local_em_scan(x_oh, read_mask, gamma0, kmask, n_true, nsteps):
    """EM scan with read-axis partial sums reduced over the 'mp' axis.

    Shapes are per-shard: x_oh (B, N_loc, nf, A); all reductions over reads
    become psum('mp').  Deterministic (no degenerate re-init on this path —
    masked slots keep uniform parameters instead)."""
    B, n_loc, nf, _ = x_oh.shape
    x_flat = x_oh.reshape(B, n_loc, nf * ALPHA)

    def m_step(gamma):
        g = gamma * read_mask[..., None]
        denom_local = g.sum(axis=1)                       # (B, K)
        denom = jax.lax.psum(denom_local, "mp")
        counts_local = jnp.einsum("bnk,bnfa->bkfa", g, x_oh,
                                  precision=HIGHEST)
        counts = jax.lax.psum(counts_local, "mp")
        pi = denom / n_true[:, None]
        theta = counts / jnp.where(denom == 0, 1.0, denom)[..., None, None]
        return pi, theta

    def e_step(pi, theta):
        logt = jnp.log(jnp.clip(theta, EPS, 1 - EPS)).reshape(B, MAX_K, -1)
        M = jnp.einsum("bnf,bkf->bnk", x_flat, logt, precision=HIGHEST)
        M = M + jnp.log(jnp.clip(pi, EPS, 1 - EPS))[:, None, :]
        M = jnp.where(kmask[:, None, :], M, NEG_BIG)
        diff = jnp.clip(M[..., :, None] - M[..., None, :], -700.0, 700.0)
        gamma = 1.0 / jnp.exp(diff).sum(axis=-2)
        return jnp.where(kmask[:, None, :], gamma, 0.0), M

    def step(gamma, _):
        pi, theta = m_step(gamma)
        gamma, M = e_step(pi, theta)
        # expected complete log-lik (local rows then psum)
        logt = jnp.log(jnp.clip(theta, EPS, 1 - EPS)).reshape(B, MAX_K, -1)
        per_k = jnp.einsum("bnf,bkf->bnk", x_flat, logt, precision=HIGHEST)
        per_k = per_k + jnp.log(jnp.clip(pi, EPS, 1 - EPS))[:, None, :]
        lik_local = ((per_k * gamma).sum(axis=2) * read_mask).sum(axis=1)
        lik = jax.lax.psum(lik_local, "mp")
        return gamma, lik

    pi0, theta0 = m_step(gamma0)
    gamma, _ = e_step(pi0, theta0)
    gamma, liks = jax.lax.scan(step, gamma, None, length=nsteps)
    return gamma, liks[-1]


def sharded_em_step(mesh: Mesh, nsteps: int = NSTEP):
    """Jitted full EM step over a window batch sharded (dp=windows,
    mp=reads).  Returns (gamma, lik) with gamma sharded like the input."""
    spec_x = P("dp", "mp", None, None)
    spec_rm = P("dp", "mp")
    spec_g = P("dp", "mp", None)
    spec_k = P("dp", None)
    spec_n = P("dp")

    fn = shard_map(
        functools.partial(_local_em_scan, nsteps=nsteps), mesh=mesh,
        in_specs=(spec_x, spec_rm, spec_g, spec_k, spec_n),
        out_specs=(spec_g, spec_n))
    return jax.jit(fn)


def make_example_batch(batch: int, n_reads: int, nf: int, seed: int = 0,
                       dtype=np.float32):
    """Synthetic padded window batch for compile checks and benchmarks."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ALPHA, (batch, n_reads, nf))
    x_oh = np.eye(ALPHA, dtype=dtype)[codes]
    read_mask = np.ones((batch, n_reads), dtype)
    hard = rng.integers(0, 2, (batch, n_reads))
    gamma0 = np.zeros((batch, n_reads, MAX_K), dtype)
    b, r = np.meshgrid(np.arange(batch), np.arange(n_reads), indexing="ij")
    gamma0[b, r, hard] = 1.0
    kmask = np.zeros((batch, MAX_K), bool)
    kmask[:, :2] = True
    n_true = np.full((batch,), float(n_reads), dtype)
    return x_oh, read_mask, gamma0, kmask, n_true
