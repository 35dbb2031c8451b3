"""Table key-value codec.

The port's own copy of ``tikv_tpu/copr/table.py``.

Re-expression of ``tidb_query_datatype/src/codec/table.rs:22-29``:

* record key:  ``t{table_id:i64}_r{handle:i64}``   (both memcomparable i64)
* record value: datum-v1 row (col_id, value) pairs — see ``datum.py``

Plus the columnar **batch decoder** that turns a block of scanned MVCC rows
into ``Column`` vectors.  When every row in the block shares one fixed-width
layout (the overwhelmingly common case for numeric schemas — and detectable in
O(1) per row), decode is a numpy reshape + per-column slice; otherwise a
per-row datum walk is the fallback.  This is the host side of the host→device
pipeline, so it must not be a Python-per-row loop on the hot path.
"""

from __future__ import annotations

import numpy as np

from ..util import codec
from . import datatypes
from . import datum as datum_mod
from . import rowv2
from .datatypes import Column, ColumnInfo, EvalType

TABLE_PREFIX = b"t"
RECORD_PREFIX_SEP = b"_r"


def record_key(table_id: int, handle: int) -> bytes:
    return TABLE_PREFIX + codec.encode_i64(table_id) + RECORD_PREFIX_SEP + codec.encode_i64(handle)


def decode_record_key(key: bytes) -> tuple[int, int]:
    if len(key) != 19 or key[:1] != TABLE_PREFIX or key[9:11] != RECORD_PREFIX_SEP:
        raise ValueError(f"not a record key: {key!r}")
    return codec.decode_i64(key, 1), codec.decode_i64(key, 11)


def decode_record_handles(keys: list[bytes]) -> np.ndarray:
    """Batch handle decode: one reshape + byte-slice for the whole block."""
    n = len(keys)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    lens = np.fromiter(map(len, keys), dtype=np.int64, count=n)
    if lens.min() != 19 or lens.max() != 19:
        # not uniformly record keys; per-key decode surfaces the bad one
        return np.array([decode_record_key(k)[1] for k in keys], dtype=np.int64)
    arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(n, 19)
    return codec.decode_i64_batch(arr[:, 11:19])


def encode_row(columns: list[ColumnInfo], values: list) -> bytes:
    """Encode one row's non-handle columns as the record value."""
    out = bytearray()
    for info, v in zip(columns, values):
        datum_mod.encode_datum(out, datum_mod.INT_FLAG, info.col_id)
        if v is None:
            datum_mod.encode_datum(out, datum_mod.NIL_FLAG, None)
            continue
        et = info.ftype.eval_type
        if et == EvalType.INT:
            # fixed-width (for_key) int encoding: row blocks with stable
            # schemas become one reshape + vectorized byte-slice decode
            flag = datum_mod.UINT_FLAG if info.ftype.is_unsigned else datum_mod.INT_FLAG
            datum_mod.encode_datum(out, flag, v, for_key=True)
        elif et == EvalType.REAL:
            datum_mod.encode_datum(out, datum_mod.FLOAT_FLAG, v)
        elif et == EvalType.DECIMAL:
            datum_mod.encode_datum(out, datum_mod.DECIMAL_FLAG, (v, info.ftype.decimal))
        elif et == EvalType.BYTES:
            datum_mod.encode_datum(out, datum_mod.BYTES_FLAG, v)
        elif et == EvalType.JSON:
            datum_mod.encode_datum(out, datum_mod.JSON_FLAG, v)
        elif et in (EvalType.DATETIME, EvalType.DURATION):
            datum_mod.encode_datum(out, datum_mod.DURATION_FLAG, v)
        elif et in (EvalType.ENUM, EvalType.SET):
            # stored form is the index / bitmask (row::v2 stores the same)
            datum_mod.encode_datum(out, datum_mod.UINT_FLAG, int(v))
        else:
            raise ValueError(f"unsupported {et}")
    return bytes(out)


# ---------------------------------------------------------------------------
# Batch row→column decode
# ---------------------------------------------------------------------------

class RowBatchDecoder:
    """Decode N record (handle, row_value) pairs into Columns for a schema.

    Column resolution per ``BatchTableScanExecutor`` (table_scan_executor.rs):
    a column marked ``is_pk_handle`` is filled from the key's handle; others
    come from the row value by col_id; missing col_id ⇒ default value / NULL.
    """

    def __init__(self, schema: list[ColumnInfo]):
        self.schema = schema
        self.handle_idx = [i for i, c in enumerate(schema) if c.is_pk_handle]
        # per-column cached dictionary (col_id → sorted uint64 keys + object
        # values): lets later blocks dictionary-encode with one searchsorted
        # instead of a fresh np.unique sort
        self._dict_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def decode(self, handles: np.ndarray, row_values: list[bytes]) -> list[Column]:
        n = len(row_values)
        if row_values and all(rowv2.is_v2_row(rv) for rv in row_values):
            cols = rowv2.decode_rows_v2(self.schema, row_values)
        elif row_values and any(rowv2.is_v2_row(rv) for rv in row_values):
            cols = self._mixed_decode(row_values)
        else:
            fast = self._try_fast_decode(row_values)
            cols = fast if fast is not None else self._slow_decode(row_values)
        # fill handle columns
        for i in self.handle_idx:
            cols[i] = Column(EvalType.INT, handles.astype(np.int64), np.zeros(n, dtype=bool))
        return cols

    # -- fast path: single fixed layout across the block -------------------

    def _try_fast_decode(self, row_values: list[bytes]) -> list[Column] | None:
        if not row_values:
            return None
        first = row_values[0]
        nbytes = len(first)
        layout = self._parse_layout(first)
        if layout is None:
            return None
        for rv in row_values:
            if len(rv) != nbytes:
                return None
        buf = np.frombuffer(b"".join(row_values), dtype=np.uint8).reshape(len(row_values), nbytes)
        # verify every row matches the layout's fixed flag/colid bytes
        for off in layout["const_offsets"]:
            if not (buf[:, off] == first[off]).all():
                return None
        n = len(row_values)
        out: list[Column] = []
        for info in self.schema:
            if info.is_pk_handle:
                out.append(Column(EvalType.INT, np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)))
                continue
            ent = layout["cols"].get(info.col_id)
            et = info.ftype.eval_type
            if ent is None:
                out.append(_default_column(info, n))
                continue
            kind, off = ent
            if kind == "i64":
                data = codec.decode_i64_batch(buf[:, off : off + 8])
                out.append(Column(et, data, np.zeros(n, dtype=bool), info.ftype.decimal))
            elif kind == "u64":
                data = codec.decode_u64_batch(buf[:, off : off + 8]).view(np.int64)
                out.append(Column(et, data, np.zeros(n, dtype=bool), info.ftype.decimal))
            elif kind == "f64":
                data = codec.decode_f64_batch(buf[:, off : off + 8])
                out.append(Column(et, data, np.zeros(n, dtype=bool)))
            elif isinstance(kind, tuple) and kind[0] == "bytes":
                blen = kind[1]
                codes, dictionary = self._dict_encode(info.col_id, buf, off, blen, n)
                out.append(Column(et, codes, np.zeros(n, dtype=bool), 0, dictionary))
            else:
                raise AssertionError(kind)
        return out

    def _parse_layout(self, row: bytes) -> dict | None:
        """Walk one row; return fixed offsets if every datum is fixed-width.

        Fixed-width means: INT/UINT/FLOAT/DURATION flags (8-byte payloads) and
        single-byte varint col-ids.  DECIMAL (1+varint) and BYTES are variable
        ⇒ fall back.  NULLs make a column's presence row-dependent ⇒ fall back.
        """
        cols: dict[int, tuple[str, int]] = {}
        const_offsets: list[int] = []
        off = 0
        while off < len(row):
            # col id datum: flag VARINT_FLAG + varint
            if row[off] != datum_mod.VARINT_FLAG:
                return None
            const_offsets.append(off)
            try:
                cid, noff = codec.decode_var_i64(row, off + 1)
            except ValueError:
                return None
            for o in range(off + 1, noff):
                const_offsets.append(o)
            off = noff
            if off >= len(row):
                return None
            flag = row[off]
            const_offsets.append(off)
            if flag == datum_mod.INT_FLAG:
                cols[cid] = ("i64", off + 1)
                off += 9
            elif flag == datum_mod.UINT_FLAG:
                cols[cid] = ("u64", off + 1)
                off += 9
            elif flag == datum_mod.FLOAT_FLAG:
                cols[cid] = ("f64", off + 1)
                off += 9
            elif flag == datum_mod.DURATION_FLAG:
                cols[cid] = ("i64", off + 1)
                off += 9
            elif flag == datum_mod.DECIMAL_FLAG:
                # frac byte is part of the constant layout; payload is fixed i64
                const_offsets.append(off + 1)
                cols[cid] = ("i64", off + 2)
                off += 10
            elif flag == datum_mod.COMPACT_BYTES_FLAG:
                # fixed-length bytes value: varint length must be 1 byte and
                # identical across the block (checked via const_offsets)
                try:
                    blen, noff2 = codec.decode_var_i64(row, off + 1)
                except ValueError:
                    return None
                if blen < 0 or noff2 != off + 2 or off + 2 + blen > len(row):
                    return None
                const_offsets.append(off + 1)
                cols[cid] = (("bytes", blen), off + 2)
                off += 2 + blen
            else:
                return None
        return {"cols": cols, "const_offsets": const_offsets}

    def _dict_encode(self, col_id: int, buf: np.ndarray, off: int, blen: int, n: int):
        """Dictionary-encode a fixed-width bytes column slice.

        Values ≤8 bytes pack into uint64 keys; a per-column cached dictionary
        turns steady-state blocks into one searchsorted (O(n log D)).  Wider
        values use the void-view np.unique path.
        """
        if blen == 0:
            return np.zeros(n, dtype=np.int64), np.array([b""], dtype=object)
        raw = np.ascontiguousarray(buf[:, off : off + blen])
        if blen <= 8:
            padded = np.zeros((n, 8), dtype=np.uint8)
            padded[:, :blen] = raw
            # big-endian packing: uint64 numeric order == lexicographic
            # bytes order, so the dictionary comes out SORTED — rank joins
            # and code-space range rewrites key on that
            keys = padded.view(np.uint64).reshape(n).byteswap()
            cached = self._dict_cache.get(col_id)
            if cached is not None:
                sorted_keys, values = cached
                pos = np.searchsorted(sorted_keys, keys)
                pos_c = np.minimum(pos, len(sorted_keys) - 1)
                if (sorted_keys[pos_c] == keys).all():
                    return pos_c.astype(np.int64), values
            uk, codes = np.unique(keys, return_inverse=True)
            values = np.empty(len(uk), dtype=object)
            kb = uk.byteswap().view(np.uint8).reshape(len(uk), 8)
            for j in range(len(uk)):
                values[j] = kb[j, :blen].tobytes()
            self._dict_cache[col_id] = (uk, values)
            return codes.astype(np.int64), values
        view = raw.view([("", np.uint8)] * blen).reshape(n)
        uniq, codes = np.unique(view, return_inverse=True)
        dictionary = np.empty(len(uniq), dtype=object)
        ub = uniq.view(np.uint8).reshape(len(uniq), blen)
        for j in range(len(uniq)):
            dictionary[j] = ub[j].tobytes()
        return codes.astype(np.int64), dictionary

    def _mixed_decode(self, row_values: list[bytes]) -> list[Column]:
        """A block mixing v1 and v2 rows (mid-migration): decode each format
        batch-wise, then interleave back into row order."""
        v2_idx = [i for i, rv in enumerate(row_values) if rowv2.is_v2_row(rv)]
        v1_idx = [i for i, rv in enumerate(row_values) if not rowv2.is_v2_row(rv)]
        v2_cols = rowv2.decode_rows_v2(self.schema, [row_values[i] for i in v2_idx])
        v1_cols = self._slow_decode([row_values[i] for i in v1_idx])
        n = len(row_values)
        order = np.empty(n, dtype=np.int64)
        order[np.array(v2_idx, dtype=np.int64)] = np.arange(len(v2_idx))
        order[np.array(v1_idx, dtype=np.int64)] = len(v2_idx) + np.arange(len(v1_idx))
        out = []
        for c2, c1 in zip(v2_cols, v1_cols):
            out.append(Column.concat([c2, c1]).take(order))
        return out

    # -- slow path: per-row datum walk -------------------------------------

    def _slow_decode(self, row_values: list[bytes]) -> list[Column]:
        n = len(row_values)
        rows = [datum_mod.decode_row_value(rv) for rv in row_values]
        out: list[Column] = []
        for info in self.schema:
            if info.is_pk_handle:
                out.append(Column(EvalType.INT, np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)))
                continue
            et = info.ftype.eval_type
            values = []
            for r in rows:
                d = r.get(info.col_id)
                if d is None:
                    # column absent from the row (schema evolution) ⇒ default
                    values.append(info.default_value)
                elif d.flag == datum_mod.NIL_FLAG:
                    # explicitly stored NULL stays NULL (row v2 agrees)
                    values.append(None)
                elif d.flag == datum_mod.DECIMAL_FLAG:
                    values.append(d.value[0])
                else:
                    values.append(d.value)
            out.append(_typed_column(info, values))
        return out


_typed_column = datatypes.typed_column


def _default_column(info: ColumnInfo, n: int) -> Column:
    if info.default_value is not None:
        return _typed_column(info, [info.default_value] * n)
    return _typed_column(info, [None] * n)
