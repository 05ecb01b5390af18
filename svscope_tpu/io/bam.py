"""Native BAM reader/writer + columnar alignment table.

Replaces the reference's entire external data plane:
  * pysam.AlignmentFile.fetch           (src/DataScanner.py:77, 273)
  * `bedtools bamtobed -cigar | bgzip && tabix` (src/SVscope.py:56-75)
  * tabix region queries over bed.gz    (src/WindowSelection_v8.py:379, 438)
  * the SQLite read-alignment DB        (src/DataScanner.py:328-400)

Design: BAM records are parsed once into (a) lightweight `BamRecord`
objects for per-window sequence extraction and (b) an `AlignmentTable` —
columnar NumPy arrays (one row per alignment record, including secondary and
supplementary) that serves every bed.gz/tabix/SQLite role in-memory.  This is
host-side IO, deliberately not on the device; a C++ streaming decoder can drop in
behind the same API for whole-genome scale (native/).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import bgzf

# BAM cigar op codes -> characters
CIGAR_OPS = "MIDNSHP=X"
_OP_INDEX = {c: i for i, c in enumerate(CIGAR_OPS)}
# ops that consume reference / query
REF_CONSUME = np.array([True, False, True, True, False, False, False, True, True])
QRY_CONSUME = np.array([True, True, False, False, True, False, False, True, True])
MATCH_OPS = (0, 7, 8)  # M, =, X

_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_NT16_OF = np.full(256, 15, dtype=np.uint8)
for _i, _c in enumerate(_SEQ_NT16):
    _NT16_OF[ord(_c)] = _i
    _NT16_OF[ord(_c.lower())] = _i
_NT16_CHARS = np.frombuffer(_SEQ_NT16.encode(), dtype=np.uint8)


def cigar_string(ops: np.ndarray, lens: np.ndarray) -> str:
    return "".join(f"{l}{CIGAR_OPS[o]}" for o, l in zip(ops, lens))


def parse_cigar_string(cig: str):
    ops, lens = [], []
    num = 0
    for ch in cig:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append(_OP_INDEX[ch])
            lens.append(num)
            num = 0
    return np.array(ops, np.int8), np.array(lens, np.int64)


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int           # 0-based leftmost ref position
    mapq: int
    cigar_ops: np.ndarray
    cigar_lens: np.ndarray
    seq: str           # as stored (soft clips included, hard clips absent)
    _ref_name: str = ""

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & 0x800)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def strand(self) -> str:
        return "-" if self.is_reverse else "+"

    @property
    def reference_start(self) -> int:
        return self.pos

    @property
    def reference_end(self) -> int:
        ref_len = int(self.cigar_lens[REF_CONSUME[self.cigar_ops]].sum())
        return self.pos + ref_len

    @property
    def cigarstring(self) -> str:
        return cigar_string(self.cigar_ops, self.cigar_lens)

    def leading_hardclip(self) -> int:
        if len(self.cigar_ops) and self.cigar_ops[0] == 5:
            return int(self.cigar_lens[0])
        return 0

    def match_runs(self):
        """(qstarts, rstarts, lens) for M/=/X runs; query coords exclude hard clips."""
        q = r = 0
        qs, rs, ln = [], [], []
        for o, l in zip(self.cigar_ops, self.cigar_lens):
            o = int(o); l = int(l)
            if o in MATCH_OPS:
                qs.append(q); rs.append(r + self.pos); ln.append(l)
            if QRY_CONSUME[o] and o != 5:  # hard clip consumes neither stored seq
                q += l
            if REF_CONSUME[o]:
                r += l
        return (np.array(qs, np.int64), np.array(rs, np.int64), np.array(ln, np.int64))

    def query_pos_floor(self, ref_target: int) -> int:
        """Query position of the last aligned base with ref <= ref_target.

        Mirrors ReadsLoci's `aln_pair_linear[rpos<=start][-1]`
        (src/DataScanner.py:57-65).
        """
        qs, rs, ln = self.match_runs()
        ends = rs + ln - 1
        i = np.searchsorted(rs, ref_target, side="right") - 1
        if i < 0:
            raise ValueError("no aligned base at or before target")
        off = min(ref_target, ends[i]) - rs[i]
        return int(qs[i] + off)

    def query_pos_ceil(self, ref_target: int) -> int:
        """Query position of the first aligned base with ref >= ref_target."""
        qs, rs, ln = self.match_runs()
        ends = rs + ln - 1
        i = np.searchsorted(ends, ref_target, side="left")
        if i >= len(rs):
            raise ValueError("no aligned base at or after target")
        off = max(ref_target, rs[i]) - rs[i]
        return int(qs[i] + off)


def _parse_records(data: bytes, refs: list[str]):
    records = []
    pos = 0
    n = len(data)
    while pos + 4 <= n:
        (block_size,) = struct.unpack_from("<i", data, pos)
        rec = data[pos + 4: pos + 4 + block_size]
        pos += 4 + block_size
        (ref_id, rpos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
         _nref, _npos, _tlen) = struct.unpack_from("<iiBBHHHiiii", rec, 0)
        off = 32
        name = rec[off: off + l_read_name - 1].decode()
        off += l_read_name
        cig = np.frombuffer(rec, dtype=np.uint32, count=n_cigar, offset=off)
        ops = (cig & 0xF).astype(np.int8)
        lens = (cig >> 4).astype(np.int64)
        off += 4 * n_cigar
        nbytes = (l_seq + 1) // 2
        packed = np.frombuffer(rec, dtype=np.uint8, count=nbytes, offset=off)
        hi = packed >> 4
        lo = packed & 0xF
        codes = np.empty(nbytes * 2, np.uint8)
        codes[0::2] = hi
        codes[1::2] = lo
        seq = _NT16_CHARS[codes[:l_seq]].tobytes().decode()
        records.append(BamRecord(name, flag, ref_id, rpos, mapq, ops, lens, seq,
                                 refs[ref_id] if 0 <= ref_id < len(refs) else "*"))
    return records


class BamReader:
    """Whole-file BAM reader with in-memory region fetch.

    Suitable for per-sample chromosome-scale inputs; whole-genome streaming
    belongs to the native decoder.
    """

    def __init__(self, path: str):
        raw = bgzf.decompress_file(path)
        if raw[:4] != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", raw, 4)
        off = 8 + l_text
        self.header_text = raw[8:8 + l_text].rstrip(b"\x00").decode()
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        self.references: list[str] = []
        self.lengths: list[int] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", raw, off)
            off += 4
            self.references.append(raw[off: off + l_name - 1].decode())
            off += l_name
            (l_ref,) = struct.unpack_from("<i", raw, off)
            off += 4
            self.lengths.append(l_ref)
        self.records = _parse_records(raw[off:], self.references)
        # per-chromosome index
        self._by_chrom: dict[int, list[int]] = {}
        for i, r in enumerate(self.records):
            if r.is_unmapped:
                continue
            self._by_chrom.setdefault(r.ref_id, []).append(i)
        self._starts = {}
        self._ends = {}
        for c, idxs in self._by_chrom.items():
            idx = np.array(idxs, np.intp)
            starts = np.array([self.records[i].pos for i in idxs], np.int64)
            ends = np.array([self.records[i].reference_end for i in idxs], np.int64)
            order = np.argsort(starts, kind="stable")
            self._by_chrom[c] = idx[order]
            self._starts[c] = starts[order]
            self._ends[c] = ends[order]

    def fetch(self, chrom: str, start: int, end: int):
        """All records overlapping [start, end), by ascending ref start."""
        try:
            cid = self.references.index(chrom)
        except ValueError:
            return []
        if cid not in self._by_chrom:
            return []
        starts, ends, idx = self._starts[cid], self._ends[cid], self._by_chrom[cid]
        sel = (starts < end) & (ends > start)
        return [self.records[i] for i in idx[sel]]


class BamWriter:
    def __init__(self, path: str, references: list[str], lengths: list[int]):
        self.path = path
        self.references = references
        self.lengths = lengths
        self._recs: list[bytes] = []

    def write(self, rec: BamRecord) -> None:
        name_b = rec.name.encode() + b"\x00"
        cig = ((rec.cigar_lens.astype(np.uint32) << 4) |
               rec.cigar_ops.astype(np.uint32)).astype("<u4").tobytes()
        seq_codes = _NT16_OF[np.frombuffer(rec.seq.encode(), np.uint8)]
        if len(seq_codes) % 2:
            seq_codes = np.concatenate([seq_codes, [0]])
        packed = ((seq_codes[0::2] << 4) | seq_codes[1::2]).astype(np.uint8).tobytes()
        qual = b"\xff" * len(rec.seq)
        body = struct.pack("<iiBBHHHiiii", rec.ref_id, rec.pos, len(name_b),
                           rec.mapq, 0, len(rec.cigar_ops), rec.flag,
                           len(rec.seq), -1, -1, 0)
        body += name_b + cig + packed + qual
        self._recs.append(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(self.references, self.lengths))
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
        out += struct.pack("<i", len(self.references))
        for n, l in zip(self.references, self.lengths):
            nb = n.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        out += b"".join(self._recs)
        bgzf.compress_to_file(self.path, out)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class AlignmentTable:
    """Columnar per-record alignment table (the bed.gz + SQLite replacement).

    One row per alignment record (primary, secondary, supplementary), sorted
    by (chrom, start) — the schema `bedtools bamtobed -cigar` produced for the
    reference: chrom, start, end, read_id, mapQ, strand, cigar
    (src/WindowSelection_v8.py:1-3).
    """

    def __init__(self, chrom, start, end, name, mapq, strand_rev, cigar):
        order = np.lexsort((np.asarray(start), np.asarray(chrom, dtype=object)))
        self.chrom = np.asarray(chrom, dtype=object)[order]
        self.start = np.asarray(start, np.int64)[order]
        self.end = np.asarray(end, np.int64)[order]
        self.name = np.asarray(name, dtype=object)[order]
        self.mapq = np.asarray(mapq, np.int32)[order]
        self.strand_rev = np.asarray(strand_rev, bool)[order]
        self.cigar = np.asarray(cigar, dtype=object)[order]
        self._name_index: dict[str, list[int]] | None = None
        self._chrom_slices: dict[str, tuple[int, int]] = {}
        # contiguous chrom slices after lexsort
        if len(self.chrom):
            boundaries = np.flatnonzero(self.chrom[1:] != self.chrom[:-1]) + 1
            bounds = np.concatenate([[0], boundaries, [len(self.chrom)]])
            for i in range(len(bounds) - 1):
                self._chrom_slices[self.chrom[bounds[i]]] = (int(bounds[i]), int(bounds[i + 1]))

    def __len__(self):
        return len(self.start)

    def name_codes(self) -> np.ndarray:
        """Read-name codes (int64, one per row; equal names share a code),
        built once and cached — the WGS background sweep re-coded ~10M
        object strings on every call otherwise."""
        if getattr(self, "_name_codes", None) is None:
            codes: dict = {}
            self._name_codes = np.fromiter(
                (codes.setdefault(n, len(codes)) for n in self.name),
                np.int64, len(self.name))
        return self._name_codes

    def cig_arrays(self):
        """(blob, offsets): all cigar strings concatenated as bytes plus
        int64 offsets (n+1) — the zero-copy form native batch kernels take.
        Built once and cached."""
        if getattr(self, "_cig_blob", None) is None:
            off = np.zeros(len(self.cigar) + 1, np.int64)
            parts = []
            for i, c in enumerate(self.cigar):
                parts.append(c.encode() if isinstance(c, str) else c)
                off[i + 1] = off[i] + len(parts[-1])
            self._cig_blob = b"".join(parts)
            self._cig_off = off
        return self._cig_blob, self._cig_off

    @classmethod
    def from_bam(cls, path: str) -> "AlignmentTable":
        rd = BamReader(path)
        rows = [r for r in rd.records if not r.is_unmapped]
        return cls(
            [r._ref_name for r in rows],
            [r.pos for r in rows],
            [r.reference_end for r in rows],
            [r.name for r in rows],
            [r.mapq for r in rows],
            [r.is_reverse for r in rows],
            [r.cigarstring for r in rows],
        )

    @classmethod
    def concat(cls, tables: list["AlignmentTable"]) -> "AlignmentTable":
        return cls(
            np.concatenate([t.chrom for t in tables]) if tables else [],
            np.concatenate([t.start for t in tables]) if tables else [],
            np.concatenate([t.end for t in tables]) if tables else [],
            np.concatenate([t.name for t in tables]) if tables else [],
            np.concatenate([t.mapq for t in tables]) if tables else [],
            np.concatenate([t.strand_rev for t in tables]) if tables else [],
            np.concatenate([t.cigar for t in tables]) if tables else [],
        )

    def fetch_idx(self, chrom: str, start: int, end: int) -> np.ndarray:
        """Row indices overlapping [start, end) (tabix fetch equivalent)."""
        if chrom not in self._chrom_slices:
            return np.empty(0, np.intp)
        lo, hi = self._chrom_slices[chrom]
        s = self.start[lo:hi]
        e = self.end[lo:hi]
        sel = np.flatnonzero((s < end) & (e > start)) + lo
        return sel.astype(np.intp)

    # --- read-alignment index (SQLite reads_alignment replacement) ---
    def _build_name_index(self):
        idx: dict[str, list[int]] = {}
        for i, nm in enumerate(self.name):
            idx.setdefault(nm, []).append(i)
        self._name_index = idx

    def read_alignments(self, read_id: str) -> np.ndarray:
        """Row indices of all alignments of a read (query_reads equivalent,
        src/DataScanner.py:392-400)."""
        if self._name_index is None:
            self._build_name_index()
        return np.array(self._name_index.get(read_id, []), np.intp)

    def spanchr_ratio(self, read_ids) -> float:
        """Fraction of reads whose alignments hit >1 chromosome
        (src/DataScanner.py:403-410).  NaN when no read has alignments."""
        n_multi = 0
        n_tot = 0
        seen = set()
        for rid in read_ids:
            rid = rid.split("|")[-1]
            if rid in seen:
                continue
            seen.add(rid)
            rows = self.read_alignments(rid)
            if rows.size == 0:
                continue
            n_tot += 1
            if len(set(self.chrom[rows])) > 1:
                n_multi += 1
        return n_multi / n_tot if n_tot else float("nan")
