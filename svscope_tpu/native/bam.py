"""ctypes bindings for the native BAM scanner (native/bam_scan.cpp).

`scan_alignment_table(path)` builds the columnar AlignmentTable at C++
speed — the whole-genome ingest path.  Output is identical to
AlignmentTable.from_bam (tested); the Python reader remains the per-window
sequence fetcher.
"""
from __future__ import annotations

import ctypes as ct
import os
import threading

import numpy as np

from . import _HERE, _REPO

LIBBAM = os.path.join(_HERE, "libbamscan.so")
_SRC = os.path.join(_REPO, "native", "bam_scan.cpp")

_lib = None
_lock = threading.Lock()


def lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ._build import ensure_lib as _ensure
        l = ct.CDLL(_ensure(_SRC, LIBBAM, ("-lz",)))
        l.bam_scan_open.restype = ct.c_void_p
        l.bam_scan_open.argtypes = [ct.c_char_p, ct.c_int64]
        l.bam_scan_open_lazy.restype = ct.c_void_p
        l.bam_scan_open_lazy.argtypes = [ct.c_char_p, ct.c_int64]
        l.bam_scan_open_path.restype = ct.c_void_p
        l.bam_scan_open_path.argtypes = [ct.c_char_p, ct.c_int32, ct.c_int32]
        l.bam_scan_record_seq.restype = ct.c_int64
        l.bam_scan_record_seq.argtypes = [ct.c_void_p, ct.c_int64,
                                          ct.c_char_p, ct.c_int64]
        l.bam_scan_free.argtypes = [ct.c_void_p]
        l.bam_scan_error.restype = ct.c_char_p
        l.bam_scan_error.argtypes = [ct.c_void_p]
        l.bam_scan_n_records.restype = ct.c_int64
        l.bam_scan_n_records.argtypes = [ct.c_void_p]
        l.bam_scan_n_refs.argtypes = [ct.c_void_p]
        l.bam_scan_ref_name.argtypes = [ct.c_void_p, ct.c_int32, ct.c_char_p,
                                        ct.c_int32]
        l.bam_scan_ref_length.restype = ct.c_int64
        l.bam_scan_ref_length.argtypes = [ct.c_void_p, ct.c_int32]
        l.bam_scan_columns.argtypes = [ct.c_void_p] + [ct.c_void_p] * 5
        l.bam_scan_names_size.restype = ct.c_int64
        l.bam_scan_names_size.argtypes = [ct.c_void_p]
        l.bam_scan_cigars_size.restype = ct.c_int64
        l.bam_scan_cigars_size.argtypes = [ct.c_void_p]
        l.bam_scan_strings.argtypes = [ct.c_void_p] + [ct.c_void_p] * 4
        l.bam_scan_breakpoints.restype = ct.c_void_p
        l.bam_scan_breakpoints.argtypes = [ct.c_void_p, ct.c_int32,
                                           ct.c_int32]
        l.bp_rows_count.restype = ct.c_int64
        l.bp_rows_count.argtypes = [ct.c_void_p]
        l.bp_rows_columns.argtypes = [ct.c_void_p] + [ct.c_void_p] * 8
        l.bp_rows_free.argtypes = [ct.c_void_p]
        l.span_sites_batch.argtypes = [ct.c_char_p] + [ct.c_void_p] * 5 \
            + [ct.c_int64] + [ct.c_void_p] * 2
        _lib = l
    return _lib


def _extract(l, h, path):
    err = l.bam_scan_error(h)
    if err:
        raise ValueError(f"{path}: {err.decode()}")
    n = l.bam_scan_n_records(h)
    nref = l.bam_scan_n_refs(h)
    refs, ref_lens = [], []
    buf = ct.create_string_buffer(4096)
    for i in range(nref):
        l.bam_scan_ref_name(h, i, buf, 4096)
        refs.append(buf.value.decode())
        ref_lens.append(int(l.bam_scan_ref_length(h, i)))
    ref_id = np.empty(n, np.int32)
    start = np.empty(n, np.int64)
    end = np.empty(n, np.int64)
    mapq = np.empty(n, np.int32)
    flag = np.empty(n, np.int32)
    l.bam_scan_columns(h, ref_id.ctypes.data, start.ctypes.data,
                       end.ctypes.data, mapq.ctypes.data, flag.ctypes.data)
    names_sz = l.bam_scan_names_size(h)
    cig_sz = l.bam_scan_cigars_size(h)
    names = np.empty(max(names_sz, 1), np.uint8)
    name_off = np.empty(n + 1, np.uint32)
    cigars = np.empty(max(cig_sz, 1), np.uint8)
    cigar_off = np.empty(n + 1, np.uint32)
    l.bam_scan_strings(h, names.ctypes.data, name_off.ctypes.data,
                       cigars.ctypes.data, cigar_off.ctypes.data)
    names_b = names.tobytes()[:names_sz]
    cig_b = cigars.tobytes()[:cig_sz]
    name_list = [names_b[name_off[i]:name_off[i + 1]].decode()
                 for i in range(n)]
    cig_list = [cig_b[cigar_off[i]:cigar_off[i + 1]].decode()
                for i in range(n)]
    return refs, ref_lens, ref_id, start, end, mapq, flag, name_list, cig_list


def scan_alignment_table(path: str, threads: int = 4):
    """AlignmentTable built by the native scanner (mmap + block-parallel
    BGZF inflate + streaming parse: O(chunk) memory at any input size)."""
    from ..io.bam import AlignmentTable
    l = lib()
    h = l.bam_scan_open_path(path.encode(), 0, threads)
    try:
        (refs, _lens, ref_id, start, end, mapq, flag, name_list,
         cig_list) = _extract(l, h, path)
    finally:
        l.bam_scan_free(h)
    chrom = [refs[r] for r in ref_id]
    return AlignmentTable(chrom, start, end, name_list, mapq,
                          (flag & 0x10) != 0, cig_list)


def scan_with_breakpoints(path: str, indel_cutoff: int = 40,
                          clip_cutoff: int = 100):
    """(AlignmentTable, breakpoint table) in one native pass.

    The breakpoint table (utils.table: column -> array) matches select.breakpoints.span_breakpoints row
    for row (parity-tested) — the whole-genome CIGAR parse at C++ speed.
    """
    from ..io.bam import AlignmentTable
    l = lib()
    h = l.bam_scan_open_path(path.encode(), 0, 4)
    try:
        (refs, _lens, ref_id, start, end, mapq, flag, name_list,
         cig_list) = _extract(l, h, path)
        b = l.bam_scan_breakpoints(h, indel_cutoff, clip_cutoff)
        try:
            nb = l.bp_rows_count(b)
            rec_idx = np.empty(nb, np.int64)
            bp_type = np.empty(nb, np.int32)
            cols = [np.empty(nb, np.int64) for _ in range(6)]
            l.bp_rows_columns(b, rec_idx.ctypes.data, bp_type.ctypes.data,
                              *[c.ctypes.data for c in cols])
        finally:
            l.bp_rows_free(b)
    finally:
        l.bam_scan_free(h)
    # NOTE: table construction sorts rows; breakpoint rows reference the
    # ORIGINAL record order via rec_idx, so build strings from raw columns.
    chrom_arr = np.array([refs[r] for r in ref_id], dtype=object)
    table = AlignmentTable(chrom_arr, start, end, name_list, mapq,
                           (flag & 0x10) != 0, cig_list)
    names_arr = np.array(name_list, dtype=object)
    type_names = np.array(["DEL", "INS", "CLIP"], dtype=object)
    ref_region = np.array([f"{chrom_arr[i]}:{start[i]}-{end[i]}"
                           for i in rec_idx], dtype=object)
    read_region = np.array([f"{a}-{b}" for a, b in zip(cols[4], cols[5])],
                           dtype=object)
    bp = {
        "chrom": chrom_arr[rec_idx],
        "ref_start": cols[0],
        "ref_end": cols[1],
        "read_id": names_arr[rec_idx],
        "read_start": cols[2],
        "read_end": cols[3],
        "ref_region": ref_region,
        "read_region": read_region,
        "mapq": mapq[rec_idx],
        "strand": np.where((flag[rec_idx] & 0x10) != 0, "-", "+"),
        "bp_type": type_names[bp_type],
    }
    return table, bp


class LazyBamReader:
    """BamReader-compatible region reader backed by the native scanner.

    Columns are parsed once in C++ (mmap + block-parallel inflate +
    streaming parse); record *sequences* decode lazily per fetch through a
    BGZF virtual-offset index — only the compressed mapping, the block
    index and per-record offsets stay resident, so 30x-WGS inputs fetch
    per-window payloads without holding the decompressed stream.
    """

    def __init__(self, path: str, threads: int = 4):
        self._lib = lib()
        self._h = self._lib.bam_scan_open_path(path.encode(), 1, threads)
        # record decode mutates the C++ block-span cache and the shared
        # sequence buffer; localGraph prefetch threads share this reader
        self._fetch_lock = threading.Lock()
        (self.references, self.lengths, self._ref_id, self._start,
         self._end, self._mapq, self._flag, self._names,
         self._cigars) = _extract(self._lib, self._h, path)
        self._by_chrom: dict[int, np.ndarray] = {}
        for cid in np.unique(self._ref_id):
            idx = np.flatnonzero(self._ref_id == cid)
            self._by_chrom[int(cid)] = idx[np.argsort(self._start[idx],
                                                      kind="stable")]
        self._seq_buf = ct.create_string_buffer(1 << 20)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.bam_scan_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def _record(self, i: int):
        from ..io.bam import BamRecord, parse_cigar_string
        with self._fetch_lock:
            n = self._lib.bam_scan_record_seq(self._h, int(i), self._seq_buf,
                                              len(self._seq_buf))
            if n < -1:          # -(needed+1): grow the buffer and retry
                self._seq_buf = ct.create_string_buffer(-int(n))
                n = self._lib.bam_scan_record_seq(self._h, int(i),
                                                  self._seq_buf,
                                                  len(self._seq_buf))
            if n < 0:
                raise RuntimeError("record sequence decode failed")
            seq = self._seq_buf.raw[:n].decode()
        ops, lens = parse_cigar_string(self._cigars[i])
        return BamRecord(self._names[i], int(self._flag[i]),
                         int(self._ref_id[i]), int(self._start[i]),
                         int(self._mapq[i]), ops, lens, seq,
                         self.references[self._ref_id[i]])

    def fetch(self, chrom: str, start: int, end: int):
        try:
            cid = self.references.index(chrom)
        except ValueError:
            return []
        idx = self._by_chrom.get(cid)
        if idx is None:
            return []
        sel = (self._start[idx] < end) & (self._end[idx] > start)
        return [self._record(i) for i in idx[sel]]


def span_sites(cig_blob: bytes, cig_off, cig_len, aln_start, win_start,
               win_end):
    """Batched FetchAimRegion span sites (select/windows._read_span_sites
    semantics) over (record, window) jobs in one native call."""
    l = lib()
    n = len(aln_start)
    s5 = np.empty(n, np.int64)
    s3 = np.empty(n, np.int64)
    # bind conversions to locals: .ctypes.data of a temporary would dangle
    co = np.ascontiguousarray(cig_off, np.int64)
    cl = np.ascontiguousarray(cig_len, np.int64)
    st = np.ascontiguousarray(aln_start, np.int64)
    ws = np.ascontiguousarray(win_start, np.int64)
    we = np.ascontiguousarray(win_end, np.int64)
    l.span_sites_batch(cig_blob, co.ctypes.data, cl.ctypes.data,
                       st.ctypes.data, ws.ctypes.data, we.ctypes.data,
                       n, s5.ctypes.data, s3.ctypes.data)
    return s5, s3
