"""localGraph driver: run the per-window somatic decision over a stream of
candidate windows, batched for the accelerator.

Replaces reference src/SVscope.py:118-183 (a 6-process multiprocessing pool
draining async results into Raw.bed in completion order, then shell-sorting)
with a three-phase pipeline:

  A (host)   DataMaker + POA MSA + feature selection per window
  B (device) batched EM over all windows of a chunk (em_cluster_batch:
             bucketed vmap over windows x K x EM-scan)
  C (host)   cluster labeling, consensus POA, record emission

Resume (--Continue, src/SVscope.py:142-151) is generalized to a correct
journal: finished window keys (chrom:start-end) are re-read from the
existing Raw.bed and skipped.  (The reference's resume membership test
compares split fields against joined strings and never matches —
src/SVscope.py:150 — so it reruns and appends duplicates; downstream
drop_duplicates papers over it.  We resume correctly.)

Output: '<T>.vs.<N>.TandemRepeat.Raw.bed', 10 columns, sorted by
(chrom, start) like the reference's `sort -k1,1 -k2,2n`.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np

from ..io.bam import BamReader
from ..io.fasta import FastaFile
from ..models.mixture import em_cluster_batch, em_cluster_batch_dispatch
from ..ops.poa_batch import poa_msa_batch
from ..utils import seq as sq
from .datamaker import WindowData, data_maker, data_maker2
from .decision import (call_margin, decision, dup_rescue,
                       find_non_same_site)

log = logging.getLogger("svscope_tpu.localgraph")


def open_bam(path: str):
    """Lazy native-backed reader (columns in C++, sequences decoded per
    fetch); falls back to the pure-Python reader."""
    try:
        from ..native.bam import LazyBamReader
        return LazyBamReader(path)
    except Exception as exc:
        log.warning("native lazy BAM reader failed (%s); Python fallback",
                    exc)
        return BamReader(path)


def raw_bed_name(t_ids: list[str], n_ids: list[str]) -> str:
    return "%s.vs.%s.TandemRepeat.Raw.bed" % ("-".join(t_ids), "-".join(n_ids))


def _read_tags(read_ids) -> np.ndarray:
    """Sample tag per read ("tumor"/"normal"), split once per chunk — the
    per-id string splits showed up twice (gates + emit) in the profile."""
    return np.array([x.split("|")[0].split("_")[-1] for x in read_ids])


def _passes_gates(win: WindowData, tags: np.ndarray,
                  t_label: str = "tumor") -> bool:
    """Decision's entry gates (src/DecisionMaker.py:126-134)."""
    if tags.size == 0:
        return False
    uniq, cnt = np.unique(tags, return_counts=True)
    return (len(win.sequences) > 3 and uniq.shape[0] >= 2 and cnt.min() >= 3)


def _emit_chunk(ready, em_results, t_label, readcutoff, device_poa,
                threads=None):
    """Phase C: label clusters, batch all consensus POAs in one device
    round set, emit 10-column records."""
    jobs = []        # consensus sequence lists across all windows
    job_ref = []     # (window index, 'som'|'germ', position)
    parsed = []
    for wi, ((win, enc, read_ids, feat, tags), em) in enumerate(
            zip(ready, em_results)):
        K, _, labels, theta, gamma, pi, bics = em
        som_idx, germ_idx = [], []
        for L in np.unique(labels):
            members = np.flatnonzero(labels == L)
            mtags = np.unique(tags[members])
            if (mtags.shape[0] == 1 and mtags[0] == t_label
                    and members.size >= readcutoff):
                som_idx.append(members)
            elif members.size >= readcutoff:
                germ_idx.append(members)
        dec = sq.decode_rows(enc[1:]) if (som_idx or germ_idx) else []
        som_rows = [[dec[i] for i in idx] for idx in som_idx]
        germ_rows = [[dec[i] for i in idx] for idx in germ_idx]
        for pos, rws in enumerate(som_rows):
            if max(map(len, rws)) > 0:
                job_ref.append((wi, "som", pos))
                jobs.append(rws)
        for pos, rws in enumerate(germ_rows):
            if max(map(len, rws)) > 0:
                job_ref.append((wi, "germ", pos))
                jobs.append(rws)
        parsed.append((win, read_ids, som_idx, germ_idx,
                       ["-"] * len(som_idx), ["-"] * len(germ_idx)))
    cons_out = poa_msa_batch(jobs, use_device=device_poa,
                             threads=threads) if jobs else []
    for (wi, kind, pos), (cons, _msa) in zip(job_ref, cons_out):
        if kind == "som":
            parsed[wi][4][pos] = cons
        else:
            parsed[wi][5][pos] = cons
    out = []
    for win, read_ids, som_idx, germ_idx, som_seqs, germ_seqs in parsed:
        parts = win.record.strip().split("\t")
        record = [parts[0], parts[1], parts[2], "-", "-", 0, "-", "-", 0,
                  win.flag]
        if som_idx and germ_idx and som_seqs:
            record = [parts[0], parts[1], parts[2],
                      ";".join(som_seqs),
                      ";".join(",".join(read_ids[i] for i in idx)
                               for idx in som_idx),
                      len(som_seqs),
                      ";".join(germ_seqs),
                      ";".join(",".join(read_ids[i] for i in idx)
                               for idx in germ_idx),
                      len(germ_seqs),
                      win.flag + "|EMOutput"]
        out.append(record)
    return out


def _stage_a(wins: list[WindowData], t_label: str, hcutoff: int,
             scutoff: float, device_poa: bool, threads: int | None):
    """Host phase A: gates -> batched POA MSA -> feature selection.

    Returns (entries, ready) where entries[i] = [win, ready_index | None]."""
    entries = []     # [win, state]; state None=base | ready-index
    msa_jobs = []
    pending = []
    tags_of = {}
    for win in wins:
        tags = _read_tags(win.read_ids)
        if _passes_gates(win, tags, t_label):
            tags_of[len(entries)] = tags
            pending.append(len(entries))
            msa_jobs.append(win.sequences)
        entries.append([win, None])
    msa_out = poa_msa_batch(msa_jobs, use_device=device_poa,
                            threads=threads) if msa_jobs else []
    ready = []
    for ei, (_cons, msa) in zip(pending, msa_out):
        win, _ = entries[ei]
        enc = sq.encode_rows(msa)
        flank_cols = call_margin(msa[0], win.flank_5, win.flank_3)
        keep_cols = np.setdiff1d(np.arange(enc.shape[1]), flank_cols)
        td_raw = enc[1:, keep_cols]
        cutoff = max(hcutoff, enc.shape[0] * scutoff)
        feat = td_raw[:, find_non_same_site(td_raw, cutoff)]
        if feat.shape[0] != 0 and feat.shape[1] >= 10:
            entries[ei][1] = len(ready)
            ready.append((win, enc, win.read_ids, feat, tags_of[ei]))
    return entries, ready


def _dispatch_em(ready, em_dtype):
    """Phase B dispatch: host prep + async device EM for one chunk.
    Returns a fetch() closure (no device_get yet)."""
    feats = [feat for (_, _, _, feat, _) in ready]
    kwargs = {} if em_dtype is None else {"dtype": em_dtype}
    return em_cluster_batch_dispatch(feats, labels_only=True, **kwargs) \
        if feats else (lambda: [])


def _complete_chunk(entries, ready, em_fetch, t_label, readcutoff,
                    device_poa, threads):
    """Phase B fetch + phase C emission for one dispatched chunk."""
    em_results = em_fetch()
    emitted = _emit_chunk(ready, em_results, t_label, readcutoff, device_poa,
                          threads)
    records = []
    for win, state in entries:
        if state is None:
            parts = win.record.strip().split("\t")
            records.append([parts[0], parts[1], parts[2],
                            "-", "-", 0, "-", "-", 0, win.flag])
        else:
            records.append(emitted[state])
    return records


PIPELINE_CHUNK = 128     # sub-chunk size: one EM batch-bucket exactly


def process_window_batch(wins: list[WindowData], t_label: str = "tumor",
                         readcutoff: int = 3, hcutoff: int = 3,
                         scutoff: float = 0.05, em_dtype=None,
                         device_poa: bool | str = False,
                         threads: int | None = None) -> list[list]:
    """Batched Decision over prepared window payloads: gates -> batched POA
    MSA -> feature selection -> batched EM -> labeling + batched consensus.
    Row-for-row equivalent to decision() over each window (tested).

    Large batches run as a two-stage pipeline: a worker thread computes
    phase A (host POA, GIL-free in the C++ engine) of sub-chunk k+1 while
    the main thread runs EM (device) + consensus emission of sub-chunk k —
    host and device stay busy simultaneously."""
    if len(wins) <= PIPELINE_CHUNK:
        entries, ready = _stage_a(wins, t_label, hcutoff, scutoff,
                                  device_poa, threads)
        fetch = _dispatch_em(ready, em_dtype)
        return _complete_chunk(entries, ready, fetch, t_label, readcutoff,
                               device_poa, threads)
    from concurrent.futures import ThreadPoolExecutor
    chunks = [wins[off:off + PIPELINE_CHUNK]
              for off in range(0, len(wins), PIPELINE_CHUNK)]
    records: list[list] = []
    with ThreadPoolExecutor(1) as prefetch:
        # one-chunk lookahead: keeps peak memory at O(PIPELINE_CHUNK)
        # instead of buffering stage-A output for the whole stream.
        # Two overlaps run at once: the worker thread computes stage A of
        # chunk k+1 (host POA, GIL-free in C++) while the main thread emits
        # chunk k-1 (host consensus POA) UNDER the in-flight device EM of
        # chunk k (dispatched before the emit, fetched after).
        pending = [prefetch.submit(_stage_a, c, t_label, hcutoff, scutoff,
                                   device_poa, threads)
                   for c in chunks[:2]]
        inflight = None   # (entries, ready, em_fetch) of chunk k
        for ci in range(len(chunks)):
            entries, ready = pending.pop(0).result()
            if ci + 2 < len(chunks):
                pending.append(prefetch.submit(
                    _stage_a, chunks[ci + 2], t_label, hcutoff, scutoff,
                    device_poa, threads))
            fetch = _dispatch_em(ready, em_dtype)
            if inflight is not None:
                records.extend(_complete_chunk(*inflight, t_label, readcutoff,
                                               device_poa, threads))
            inflight = (entries, ready, fetch)
        records.extend(_complete_chunk(*inflight, t_label, readcutoff,
                                       device_poa, threads))
    return records


def run_local_graph(window_records: list[str], reference: str,
                    tumor_bams: list[str], normal_bams: list[str],
                    t_ids: list[str], n_ids: list[str], savedir: str,
                    offset: int = 50, mapq: int = 5, batch_size: int = 256,
                    continue_run: bool = False, em_dtype=None,
                    t_label: str = "tumor", readcutoff: int = 3,
                    hcutoff: int = 3, scutoff: float = 0.05,
                    device_poa: bool | str = False,
                    threads: int | None = None,
                    data_parallel: bool | None = None) -> str:
    """Batched localGraph (src/SVscope.py:118-183 equivalent).

    device_poa: POA engine, as for ops.poa_batch.poa_msa_batch (False =
    host C++ engine).  Placement is JAX's default backend.

    data_parallel: shard the engine's batched device dispatches (EM, POA
    rounds) over all attached devices via a ("dp",) mesh — the
    replacement for the reference's 6-process window pool.  None = auto
    (on when >1 device is attached)."""
    os.makedirs(savedir, exist_ok=True)
    from ..parallel.dataparallel import make_dp_mesh, set_data_mesh
    import jax
    if data_parallel or (data_parallel is None
                         and len(jax.local_devices()) > 1):
        set_data_mesh(make_dp_mesh())
        log.info("localGraph: window batches data-parallel over %d devices",
                 len(jax.local_devices()))
    else:
        set_data_mesh(None)      # don't inherit a previous run's mesh
    out_path = os.path.join(savedir, raw_bed_name(t_ids, n_ids))
    done: set[str] = set()
    existing: list[str] = []
    if continue_run and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                if line.strip():
                    existing.append(line.rstrip("\n"))
                    done.add(":".join(line.split("\t")[0:3]))
    todo = [r for r in window_records
            if ":".join(r.strip().split("\t")[0:3]) not in done]
    log.info("localGraph: %d windows (%d resumed)", len(todo), len(done))

    ref = FastaFile(reference)
    readers = [open_bam(p) for p in tumor_bams + normal_bams]
    labels = [f"{t}_tumor" for t in t_ids] + [f"{n}_normal" for n in n_ids]
    rows: list[list] = []
    t0 = time.time()
    make_data2 = lambda r: data_maker2(r, ref, readers, labels,
                                       offset=offset, mapq=mapq)
    decide_seq = lambda w: decision(w, t_label, readcutoff, hcutoff, scutoff,
                                    em_dtype=em_dtype)
    from concurrent.futures import ThreadPoolExecutor
    loader = ThreadPoolExecutor(1)
    make_batch = lambda recs: [data_maker(rec, ref, readers, labels,
                                          offset=offset, mapq=mapq)
                               for rec in recs]
    batches = [todo[off:off + batch_size]
               for off in range(0, len(todo), batch_size)]
    next_fut = loader.submit(make_batch, batches[0]) if batches else None
    try:
        for bi, chunk in enumerate(batches):
            wins = next_fut.result()
            off = bi * batch_size
            if bi + 1 < len(batches):
                next_fut = loader.submit(make_batch, batches[bi + 1])
            records = process_window_batch(
                wins, t_label=t_label, readcutoff=readcutoff,
                hcutoff=hcutoff, scutoff=scutoff, em_dtype=em_dtype,
                device_poa=device_poa, threads=threads)
            for rec, win, record in zip(chunk, wins, records):
                # DUP corner rescue on any non-EMOutput result
                # (src/SomTDDetector.py:41-58; trigger column replicated)
                parts = rec.strip().split("\t")
                svtype = parts[3].split(",")[0] if len(parts) > 3 else ""
                if record[-1].split("|")[-1] != "EMOutput" and svtype == "DUP":
                    record = dup_rescue(record, win, rec, make_data2,
                                        decide_seq)
                rows.append(record)
            log.info("localGraph: %d/%d windows, %.1fs", off + len(chunk),
                     len(todo), time.time() - t0)
    finally:
        loader.shutdown(wait=False, cancel_futures=True)
    out_rows = existing + ["\t".join(str(x) for x in r) for r in rows]
    out_rows.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    with open(out_path, "w") as f:
        for line in out_rows:
            f.write(line + "\n")
    log.info("localGraph: finished %d windows in %.1f s", len(todo),
             time.time() - t0)
    return out_path


