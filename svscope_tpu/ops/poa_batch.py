"""Batched multi-window POA MSA.

Two execution modes, identical results (both are parity-exact with
ops/poa.poa, the spoa-semantics reference — tested):

  * host mode: the C++ engine (svscope_tpu/native) aligns each window's
    reads directly; windows fan out over a thread pool (ctypes releases the
    GIL during alignment).
  * device mode: round r aligns the r-th read of EVERY window in one
    `ops.poa_device.align_batch` call (windows bucketed by node-count x
    read-length); the C++ engine does the graph packing and alignment
    fusion between rounds.  Window count, not core count, is the
    parallel axis.

Windows exceeding the largest bucket (nodes, length, in-degree) fall back
to host alignment transparently.
"""
from __future__ import annotations

import logging
import os

import numpy as np
import jax

from ..native.poa import NativePoaGraph, poa_native
from ..parallel.dataparallel import shard_batch
from . import poa_device as pdev

log = logging.getLogger("svscope_tpu.poa_batch")
_ORACLE_WARNED = False

N_LADDER = (128, 256, 512, 1024, 2048)
L_LADDER = (64, 128, 256, 512, 1024, 2048)
B_LADDER = (8, 32, 128, 256)
MAX_BATCH = 256
# Native-engine fan-out: more threads than cores actively hurts (on a
# 2-core host, 2 threads beat 8 — the pipeline already runs two host
# stages concurrently)
HOST_THREADS = min(8, os.cpu_count() or 1)

_DEFAULT_OVERSIZE = (None, "sp")   # (mesh, axis) fallback when not passed


def set_default_oversize_mesh(mesh, axis: str = "sp") -> None:
    """Route over-bucket windows of every poa_msa_batch(use_device=...) call
    through the sharded wavefront by default (CLI --oversize-sharded)."""
    global _DEFAULT_OVERSIZE
    _DEFAULT_OVERSIZE = (mesh, axis)


def _bucket(x, ladder):
    for b in ladder:
        if x <= b:
            return b
    return None


def poa_msa_batch(seq_lists: list[list[str]], use_device=False,
                  threads: int | None = None, oversize_mesh=None,
                  oversize_axis: str = "sp"):
    """spoa-equivalent poa(seqs, 1) over many windows.

    use_device: False = host C++ engine (default); True/'xla' = batched XLA
    aligner rounds; 'fused' = the whole MSA build (rank + align + fuse,
    all rounds) as one on-device program (ops/poa_fused) — 2 transfers per
    bucket chunk instead of 2 per read.  The device engines pack and fuse
    graphs in the native C++ engine, so they need it to load.

    oversize_mesh: optional jax Mesh — windows exceeding the largest
    (nodes, length) bucket align through the column-sharded wavefront
    (ops/poa_sharded) over mesh[oversize_axis] instead of falling back to
    the host DP (giant-tandem-repeat path).

    Returns [(consensus, msa_rows)] per window."""
    if oversize_mesh is None:
        oversize_mesh, oversize_axis = _DEFAULT_OVERSIZE
    if not use_device:
        # giant windows go to the wavefront even in host mode (the host DP
        # handles any size, but past the device buckets the sharded path
        # is the scaling story — opt-in via oversize_mesh)
        big = set()
        if oversize_mesh is not None:
            big = {i for i, s in enumerate(seq_lists)
                   if s and max(map(len, s)) > L_LADDER[-1]}
        small_idx = [i for i in range(len(seq_lists)) if i not in big]
        out: list = [None] * len(seq_lists)
        small = [seq_lists[i] for i in small_idx]
        from ..native.poa import native_available
        if not native_available():
            # wheel install on an ISA-gated host with no toolchain: the
            # NumPy oracle is output-identical, just slower (one warning)
            global _ORACLE_WARNED
            if not _ORACLE_WARNED:
                log.warning("native POA engine unavailable on this host; "
                            "falling back to the NumPy oracle")
                _ORACLE_WARNED = True
            from .poa import poa as _poa_oracle
            res = [_poa_oracle(s, 1) for s in small]
        elif len(small) > 1:
            from ..native.poa import poa_msa_batch_native
            res = poa_msa_batch_native(small, threads=threads or HOST_THREADS)
        else:
            res = [poa_native(s) for s in small]
        for i, r in zip(small_idx, res):
            out[i] = r
        for i in sorted(big):
            out[i] = _oversize_msa(seq_lists[i], oversize_mesh, oversize_axis)
        return out
    _require_native()
    engine = use_device if isinstance(use_device, str) else "xla"
    if engine not in ("xla", "fused"):
        raise ValueError(f"unknown device POA engine {engine!r}")
    if engine == "fused":
        from .poa_fused import fused_msa_batch
        big = set()
        if oversize_mesh is not None:
            big = {i for i, s in enumerate(seq_lists)
                   if s and max(map(len, s)) > L_LADDER[-1]}
        if not big:
            return fused_msa_batch(seq_lists)
        out = [None] * len(seq_lists)
        small_idx = [i for i in range(len(seq_lists)) if i not in big]
        for i, r in zip(small_idx,
                        fused_msa_batch([seq_lists[i] for i in small_idx])):
            out[i] = r
        for i in sorted(big):
            out[i] = _oversize_msa(seq_lists[i], oversize_mesh, oversize_axis)
        return out
    graphs = [NativePoaGraph() for _ in seq_lists]
    host_only = [False] * len(seq_lists)
    max_rounds = max((len(s) for s in seq_lists), default=0)
    for r in range(max_rounds):
        items = []
        for w, seqs in enumerate(seq_lists):
            if r >= len(seqs):
                continue
            seq = seqs[r]
            g = graphs[w]
            if len(seq) == 0 or g.n_nodes() == 0 or host_only[w]:
                g.add_sequence(seq)
                continue
            items.append((w, seq))
        if items:
            _device_round(graphs, items, host_only, oversize_mesh,
                          oversize_axis)
    return [(g.consensus(), g.msa()) for g in graphs]


def _require_native() -> None:
    """The device and oversize paths pack and fuse graphs in the C++
    engine; unlike host mode they have no NumPy-oracle fallback."""
    from ..native.poa import native_available
    if not native_available():
        raise RuntimeError(
            "device/oversize POA needs the native C++ engine "
            "(native/poa_engine.cpp), which could not be built or loaded "
            "on this host; use the host engine (use_device=False)")


def _oversize_msa(seqs: list[str], mesh, axis: str):
    """One giant window's full MSA with every alignment round on the
    sharded wavefront (host C++ graph fusion between rounds)."""
    _require_native()
    g = NativePoaGraph()
    for seq in seqs:
        if len(seq) == 0 or g.n_nodes() == 0:
            g.add_sequence(seq)
        elif not _oversize_sharded(g, seq, mesh, axis):
            g.add_sequence(seq)          # in-degree > 8: host DP round
    return g.consensus(), g.msa()


def _oversize_sharded(g, seq: str, mesh, axis: str) -> bool:
    """Align one over-bucket (graph, read) via the sharded wavefront and
    fuse; returns False if the graph can't be packed (in-degree > 8)."""
    from .poa_sharded import align_sharded_packed
    n = g.n_nodes()
    n_max = max(N_LADDER[-1], 1 << (max(n, 2) - 1).bit_length())
    packed = g.pack(n_max, pdev.MAX_PREDS)
    if packed is None:
        return False
    c, p, s, nn, nor = packed
    aln, _score = align_sharded_packed(c, p, s, nn, nor, seq, mesh, axis)
    g.fuse(aln, seq)
    return True


def _device_round(graphs, items, host_only, oversize_mesh=None,
                  oversize_axis: str = "sp"):
    """One round: bucket (window, seq) pairs, device-align, C++ fuse."""
    buckets: dict[tuple[int, int], list[tuple[int, str, tuple]]] = {}
    for w, seq in items:
        g = graphs[w]
        nb = _bucket(g.n_nodes(), N_LADDER)
        lb = _bucket(len(seq), L_LADDER)
        packed = None
        if nb is not None and lb is not None:
            packed = g.pack(nb, pdev.MAX_PREDS)
        if packed is None:
            if oversize_mesh is not None and _oversize_sharded(
                    g, seq, oversize_mesh, oversize_axis):
                continue
            host_only[w] = True
            g.add_sequence(seq)
            continue
        buckets.setdefault((nb, lb), []).append((w, seq, packed))
    for (nb, lb), group in buckets.items():
        for off in range(0, len(group), MAX_BATCH):
            chunk = group[off:off + MAX_BATCH]
            b_pad = _bucket(len(chunk), B_LADDER) or len(chunk)
            chars = np.zeros((b_pad, nb), np.uint8)
            preds = np.full((b_pad, nb, pdev.MAX_PREDS), -1, np.int32)
            sinks = np.zeros((b_pad, nb), bool)
            nn = np.zeros(b_pad, np.int32)
            seqs = np.zeros((b_pad, lb), np.uint8)
            lens = np.zeros(b_pad, np.int32)
            for bi, (w, seq, (c, p, s, n, nor)) in enumerate(chunk):
                chars[bi], preds[bi], sinks[bi], nn[bi] = c, p, s, n
                seqs[bi, :len(seq)] = np.frombuffer(seq.encode(), np.uint8)
                lens[bi] = len(seq)
            if len(chunk) < b_pad:       # batch padding: replicate row 0
                chars[len(chunk):] = chars[0]
                preds[len(chunk):] = preds[0]
                sinks[len(chunk):] = sinks[0]
                nn[len(chunk):] = nn[0]
                seqs[len(chunk):] = seqs[0]
                lens[len(chunk):] = lens[0]
            # one batched transfer each way; the batch axis shards over the
            # installed data mesh (windows independent -> SPMD, no
            # collectives)
            dev = shard_batch((chars, preds, sinks, nn, seqs, lens))
            an, asp, ke, _sc = jax.device_get(pdev.align_batch(*dev, lb))
            for bi, (w, seq, (c, p, s, n, nor)) in enumerate(chunk):
                aln = pdev.unpack_alignment(an[bi], asp[bi], int(ke[bi]), nor)
                graphs[w].fuse(aln, seq)
