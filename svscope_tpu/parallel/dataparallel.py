"""Process-wide data-parallel mesh for the production engine.

The reference's only scale-out is a 6-process pool over candidate windows
(src/SVscope.py:158-161).  Here the same axis — windows — is sharded over
devices: installing a 1-D ("dp",) `jax.sharding.Mesh` makes every
batched device dispatch in the engine (the 45-slot folded EM in
models/mixture and the per-round POA aligner batches in ops/poa_batch)
place its batch axis across the mesh.  Windows are independent, so the
SPMD program contains no collectives — per-chip throughput times N, which
is exactly the pool-replacement scaling story.

This module owns only the registry + placement helper; it imports nothing
from the model code (models/mixture and ops/poa_batch import it, while
parallel/mesh.py imports models — keeping this separate breaks the cycle).
"""
from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("svscope_tpu.dataparallel")

_MESH = None
_AXIS = "dp"
# introspection for tests / dryrun: how the last shard_batch placed data
LAST_DISPATCH = {"sharded": False, "n_shards": 1}


def set_data_mesh(mesh, axis: str = "dp") -> None:
    """Install (or clear, with None) the engine-wide data mesh."""
    global _MESH, _AXIS
    _MESH = mesh
    _AXIS = axis
    if mesh is not None:
        log.info("data-parallel mesh installed: %d devices on axis %r",
                 int(np.prod(list(mesh.shape.values()))), axis)


def data_mesh():
    """(mesh, axis) or (None, axis)."""
    return _MESH, _AXIS


def make_dp_mesh(n_devices: int | None = None, devices=None):
    """Flat 1-D ("dp",) mesh over the given/first n/all LOCAL devices.

    Local, not global: the engine's shard_batch commits host data with
    jax.device_put, which requires every mesh device to be addressable by
    this process — in a multi-process run each host owns its own dp mesh
    over its chips while the window stream is sharded across hosts by
    parallel/shard.py."""
    import jax
    from jax.sharding import Mesh
    if devices is None:
        devices = (jax.local_devices()[:n_devices] if n_devices
                   else jax.local_devices())
    return Mesh(np.asarray(devices), ("dp",))


def shard_batch(arrays: tuple, min_per_shard: int = 1):
    """One host->device transfer of batch-leading arrays.

    With a data mesh installed and the shared leading axis divisible by the
    mesh (leaving >= min_per_shard rows per device), axis 0 is sharded over
    it and trailing axes replicated; otherwise a plain device_put.  All
    arrays must share the leading-axis length."""
    import jax
    mesh, axis = _MESH, _AXIS
    b = int(arrays[0].shape[0])
    if mesh is not None:
        n = int(mesh.shape[axis])
        if b % n == 0 and b // n >= min_per_shard:
            from jax.sharding import NamedSharding, PartitionSpec as P
            shardings = tuple(
                NamedSharding(mesh, P(axis, *([None] * (a.ndim - 1))))
                for a in arrays)
            LAST_DISPATCH.update(sharded=True, n_shards=n)
            return jax.device_put(arrays, shardings)
    LAST_DISPATCH.update(sharded=False, n_shards=1)
    return jax.device_put(arrays)
