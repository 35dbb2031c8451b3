"""Row format v2: id-indexed compact row encoding + batch columnar decode.

The port's own copy of ``tikv_tpu/copr/rowv2.py``.

Re-expression of ``tidb_query_datatype/src/codec/row/v2/`` (row_slice.rs:30
header layout, compat_v1.rs:13 cell encodings).  Layout per row:

    [128][flags][non_null_cnt u16 LE][null_cnt u16 LE]
    [non-null ids asc][null ids asc][end-offsets][cell values]

ids/offsets are u8/u16 in the small form, u32/u32 when any id > 255 or the
value section exceeds 64KiB (flags bit 0 = big).  NULL columns store no value
at all; absent columns fall back to schema defaults — both reasons v2 rows
are much smaller than datum (v1) rows for wide sparse schemas.

Cell encodings (compat_v1.rs write_v2_as_datum):

* INT family / YEAR: little-endian minimal width (1/2/4/8), sign-extended
* DATETIME / ENUM / SET and unsigned ints: LE minimal width, zero-extended
* DURATION: signed LE minimal width
* REAL: this framework's 8-byte memcomparable f64 (util.codec.encode_f64)
* BYTES: raw; JSON: binary JSON (self-delimiting)
* DECIMAL: ``[prec][frac][MySQL bin decimal]`` (mydecimal.encode_bin).  The
  stored cell covers the full 81-digit envelope; the *columnar* decode bridges
  to the device's scaled-int64 form (≤18 digits) and rejects wider values
  with a pointer to ``decode_cell_wide`` for host-side access.

The batch decoder recognises blocks whose rows share one byte
layout (same ids, same offsets — the steady state for fixed-width schemas)
and decodes each column with one numpy reshape+slice over the whole block,
the same trick ``RowBatchDecoder._try_fast_decode`` plays for v1 rows.
"""

from __future__ import annotations

import numpy as np

from ..util import codec
from .datatypes import Column, ColumnInfo, EvalType, attach_schema_dictionary, typed_column
from .mydecimal import DecimalOverflow, MyDecimal

CODEC_VERSION = 128
FLAG_BIG = 1

_DEFAULT_PREC = 65  # MySQL max precision, used when the schema has no flen


# ---------------------------------------------------------------------------
# Per-row slice (row_slice.rs RowSlice)
# ---------------------------------------------------------------------------

class RowSliceV2:
    """Parsed header over one encoded row; cell lookup by column id."""

    __slots__ = ("raw", "non_null_ids", "null_ids", "offsets", "values_start")

    def __init__(self, raw: bytes):
        if not raw or raw[0] != CODEC_VERSION:
            raise ValueError("not a v2 row")
        if len(raw) < 6:
            raise ValueError("truncated v2 row")
        big = bool(raw[1] & FLAG_BIG)
        nn = int.from_bytes(raw[2:4], "little")
        nl = int.from_bytes(raw[4:6], "little")
        id_w = 4 if big else 1
        off_w = 4 if big else 2
        pos = 6
        self.raw = raw
        self.non_null_ids = [
            int.from_bytes(raw[pos + i * id_w : pos + (i + 1) * id_w], "little")
            for i in range(nn)
        ]
        pos += nn * id_w
        self.null_ids = [
            int.from_bytes(raw[pos + i * id_w : pos + (i + 1) * id_w], "little")
            for i in range(nl)
        ]
        pos += nl * id_w
        self.offsets = [
            int.from_bytes(raw[pos + i * off_w : pos + (i + 1) * off_w], "little")
            for i in range(nn)
        ]
        pos += nn * off_w
        self.values_start = pos
        # Truncation check (row_slice.rs returns Error::corrupted on short
        # input): every header int above decoded from a short slice as 0, so
        # without this a truncated row yields garbage cells instead of failing.
        if pos > len(raw) or (self.offsets and pos + self.offsets[-1] > len(raw)):
            raise ValueError("truncated v2 row")

    def header_len(self) -> int:
        return self.values_start

    def get(self, col_id: int):
        """cell bytes | None (NULL) — raises KeyError when the id is absent."""
        lo, hi = 0, len(self.non_null_ids)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.non_null_ids[mid] < col_id:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self.non_null_ids) and self.non_null_ids[lo] == col_id:
            start = self.offsets[lo - 1] if lo else 0
            # lint: allow(view-escape) -- self.raw is bytes (immutable): the
            # slice is a copy by construction, no aliasing view can escape
            return self.raw[self.values_start + start : self.values_start + self.offsets[lo]]
        if col_id in self.null_ids:
            return None
        raise KeyError(col_id)


def _dec_i64_le(cell: bytes) -> int:
    return int.from_bytes(cell, "little", signed=True)


def _dec_u64_le(cell: bytes) -> int:
    return int.from_bytes(cell, "little")


def decode_cell(info: ColumnInfo, cell: bytes):
    """One cell → the column's stored Python value (scaled int for DECIMAL)."""
    et = info.ftype.eval_type
    if et == EvalType.INT:
        if info.ftype.is_unsigned:
            v = _dec_u64_le(cell)
            return v - (1 << 64) if v >= 1 << 63 else v  # int64 view
        return _dec_i64_le(cell)
    if et in (EvalType.DATETIME, EvalType.ENUM, EvalType.SET):
        return _dec_u64_le(cell)
    if et == EvalType.DURATION:
        return _dec_i64_le(cell)
    if et == EvalType.REAL:
        return codec.decode_f64(cell)
    if et in (EvalType.BYTES, EvalType.JSON):
        return bytes(cell)
    if et == EvalType.DECIMAL:
        d = decode_cell_wide(cell)
        try:
            return d.round(info.ftype.decimal).to_i64_scaled()[0]
        except DecimalOverflow as e:
            raise ValueError(
                f"decimal {d} exceeds the columnar scaled-int64 form "
                f"(≤18 digits); read it through RowSliceV2.get + "
                f"decode_cell_wide instead"
            ) from e
    raise ValueError(f"unsupported eval type {et}")


def decode_cell_wide(cell: bytes) -> MyDecimal:
    """Full-envelope (81-digit) decode of a DECIMAL cell."""
    prec, frac = cell[0], cell[1]
    d, _ = MyDecimal.decode_bin(cell[2:], prec, frac)
    return d


# ---------------------------------------------------------------------------
# Batch decode
# ---------------------------------------------------------------------------

def is_v2_row(raw: bytes) -> bool:
    return bool(raw) and raw[0] == CODEC_VERSION


_MAX_LAYOUT_GROUPS = 32


def decode_rows_v2(schema: list[ColumnInfo], row_values: list[bytes]) -> list[Column]:
    """Decode a block of v2 rows into Columns (handle columns left zeroed).

    Fast path: every row shares the first row's exact header bytes (ids +
    offsets) ⇒ each cell lives at one fixed [start, end) for the whole block,
    so fixed-width columns decode as a reshape + byte-slice with no per-row
    Python.  Mixed layouts are *grouped* by identical (length, header) and
    each group fast-decodes the same way (delta blocks and mid-migration
    blocks typically hold a handful of layouts, not one per row); only a
    pathological layout explosion takes the per-row walk.
    """
    n = len(row_values)
    first = RowSliceV2(row_values[0])
    h = first.header_len()
    header = row_values[0][:h]
    nbytes = len(row_values[0])
    same = all(
        len(rv) == nbytes and rv[:h] == header for rv in row_values[1:]
    )
    if same:
        return _fast_decode(schema, first, row_values, n)
    return _grouped_decode(schema, row_values, n)


def _grouped_decode(schema, row_values, n) -> list[Column]:
    """Partition rows into identical-layout groups and fast-decode each.

    Grouping is vectorized per byte-length bucket: rows of one length stack
    into a byte matrix, the first unclaimed row's header selects every row
    matching it with one matrix compare, and the group decodes via
    ``_fast_decode``.  Output columns stitch back into original row order.
    """
    lens = np.fromiter((len(rv) for rv in row_values), dtype=np.int64, count=n)
    groups: list[tuple[np.ndarray, list[Column]]] = []  # (orig indices, cols)
    n_groups = 0
    for ln in np.unique(lens):
        idx = np.flatnonzero(lens == ln)
        sub = [row_values[i] for i in idx]
        mat = np.frombuffer(b"".join(sub), dtype=np.uint8).reshape(len(sub), int(ln))
        todo = np.arange(len(sub))
        while len(todo):
            n_groups += 1
            if n_groups > _MAX_LAYOUT_GROUPS:
                return _slow_decode(schema, row_values, n)
            lead = sub[todo[0]]
            h = RowSliceV2(lead).header_len()
            match = (mat[todo, :h] == np.frombuffer(lead[:h], dtype=np.uint8)).all(axis=1)
            take = todo[match]
            grp_rows = [sub[i] for i in take]
            cols = (
                _fast_decode(schema, RowSliceV2(lead), grp_rows, len(grp_rows))
                if len(grp_rows) > 1
                else _slow_decode(schema, grp_rows, 1)
            )
            groups.append((idx[take], cols))
            todo = todo[~match]
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for gidx, _cols in groups:
        order[gidx] = pos + np.arange(len(gidx))
        pos += len(gidx)
    out: list[Column] = []
    for ci in range(len(schema)):
        out.append(Column.concat([cols[ci] for _gidx, cols in groups]).take(order))
    return out


def _fast_decode(schema, first: RowSliceV2, row_values, n) -> list[Column]:
    buf = np.frombuffer(b"".join(row_values), dtype=np.uint8).reshape(n, -1)
    base = first.values_start
    cell_pos = {}
    for i, cid in enumerate(first.non_null_ids):
        start = first.offsets[i - 1] if i else 0
        cell_pos[cid] = (base + start, base + first.offsets[i])
    null_ids = set(first.null_ids)

    out: list[Column] = []
    for info in schema:
        et = info.ftype.eval_type
        if info.is_pk_handle:
            out.append(Column(EvalType.INT, np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)))
            continue
        span = cell_pos.get(info.col_id)
        if span is None:
            if info.col_id in null_ids or info.default_value is None:
                out.append(typed_column(info, [None] * n))
            else:
                out.append(typed_column(info, [info.default_value] * n))
            continue
        s, e = span
        w = e - s
        raw = buf[:, s:e]
        nulls = np.zeros(n, dtype=bool)
        if et in (EvalType.INT, EvalType.DURATION) and not info.ftype.is_unsigned:
            data = _le_signed_batch(raw, w)
            out.append(Column(et, data, nulls))
        elif et in (EvalType.INT, EvalType.DATETIME, EvalType.ENUM, EvalType.SET):
            data = _le_unsigned_batch(raw, w)
            dtype = np.uint64 if et == EvalType.SET else np.int64
            out.append(attach_schema_dictionary(info, Column(et, data.astype(dtype), nulls)))
        elif et == EvalType.REAL:
            data = codec.decode_f64_batch(np.ascontiguousarray(raw))
            out.append(Column(et, data, nulls))
        else:
            vals = [decode_cell(info, bytes(raw[r])) for r in range(n)]
            out.append(typed_column(info, vals))
    return out


def _le_unsigned_batch(raw: np.ndarray, w: int) -> np.ndarray:
    padded = np.zeros((len(raw), 8), dtype=np.uint8)
    padded[:, :w] = raw
    return padded.view(np.uint64).reshape(len(raw))


def _le_signed_batch(raw: np.ndarray, w: int) -> np.ndarray:
    u = _le_unsigned_batch(raw, w)
    if w == 8:
        return u.view(np.int64)
    sign = 1 << (8 * w - 1)
    return np.where(u >= sign, u.astype(np.int64) - (1 << (8 * w)), u.astype(np.int64))


def _slow_decode(schema, row_values, n) -> list[Column]:
    slices = [RowSliceV2(rv) for rv in row_values]
    out: list[Column] = []
    for info in schema:
        if info.is_pk_handle:
            out.append(Column(EvalType.INT, np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)))
            continue
        vals = []
        for sl in slices:
            try:
                cell = sl.get(info.col_id)
            except KeyError:
                vals.append(info.default_value)
                continue
            vals.append(None if cell is None else decode_cell(info, cell))
        out.append(typed_column(info, vals))
    return out
