"""Columnar tables: a dict of equal-length NumPy arrays.

The selection, feature and VCF stages need a handful of DataFrame
operations — select rows, concatenate, group rows by a key, write and read
tab-separated files.  They are here, so that the CLI main path needs only
NumPy.  Text output matches what those stages wrote before: floats as
their shortest round-trip repr, NaN as an empty field, booleans as
True/False.
"""
from __future__ import annotations

import numpy as np

Table = dict  # column name -> 1-D np.ndarray, all of one length


def n_rows(t: Table) -> int:
    return len(next(iter(t.values()))) if t else 0


def take(t: Table, rows) -> Table:
    """Rows by boolean mask or index array, every column."""
    return {k: v[rows] for k, v in t.items()}


def concat(tables: list[Table], cols: list[str]) -> Table:
    """Row-wise concatenation of tables holding (at least) `cols`."""
    out = {}
    for c in cols:
        parts = [np.asarray(t[c]) for t in tables if n_rows(t)]
        out[c] = np.concatenate(parts) if parts else np.empty(0, object)
    return out


def from_rows(rows: list, cols: list[str]) -> Table:
    """Table from a list of row sequences (one value per column)."""
    out = {}
    for j, c in enumerate(cols):
        vals = [r[j] for r in rows]
        arr = np.empty(len(vals), object)
        for i, v in enumerate(vals):     # element-wise: values may be arrays
            arr[i] = v
        if vals and all(isinstance(v, (int, np.integer))
                        and not isinstance(v, (bool, np.bool_))
                        for v in vals):
            arr = arr.astype(np.int64)
        out[c] = arr
    return out


def group_rows(keys) -> list[tuple[object, np.ndarray]]:
    """(key, row indices) per distinct key, keys ascending, rows in their
    original order within each group (DataFrame.groupby(sort=True))."""
    keys = np.asarray(keys)
    if keys.size == 0:
        return []
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    cut = np.flatnonzero(ks[1:] != ks[:-1]) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [len(ks)]])
    return [(ks[s], order[s:e]) for s, e in zip(starts, ends)]


def fmt(v) -> str:
    """One field as written to a TSV: the shortest round-trip repr of a
    float in its own precision (float32 stays float32), '' for NaN."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else str(v)
    if isinstance(v, np.generic):
        return str(v.item())
    return str(v)


def write_tsv(path: str, t: Table, cols: list[str],
              header: bool = True, index: str | None = None) -> None:
    """Tab-separated rows of `cols`.  index: a column repeated as a
    leading field, with `index` as its header (an empty header field when
    the table has no rows, as for an unnamed index)."""
    lead = [index] if index is not None else []
    with open(path, "w") as f:
        if header:
            first = (["" if n_rows(t) == 0 else index] if lead else [])
            f.write("\t".join(first + list(cols)) + "\n")
        for i in range(n_rows(t)):
            f.write("\t".join(fmt(t[c][i]) for c in lead + list(cols))
                    + "\n")


def read_tsv(path: str) -> tuple[list[str], list[list[str]]]:
    """(header fields, rows of string fields) of a headed TSV."""
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        return [], []
    return lines[0].split("\t"), [l.split("\t") for l in lines[1:] if l]


def read_rows(path: str) -> list[list[str]]:
    """Rows of string fields of a headerless TSV, duplicates dropped
    (first occurrence kept, file order)."""
    seen, out = set(), []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line and line not in seen:
                seen.add(line)
                out.append(line.split("\t"))
    return out
