"""Columnar type system for the query engine.

The port's own copy of ``tikv_tpu/copr/datatypes.py``.

Re-expression of ``tidb_query_datatype``: the ``EvalType`` lattice
(``src/def/eval_type.rs:11``), ``FieldType``, and the columnar containers
(``src/codec/data_type/vector.rs`` ``VectorValue``/``ChunkedVec*``).

Design decisions:

* Every numeric column is a dense numpy array + a boolean null mask — the
  exact layout device transfer wants (two host buffers → two device arrays),
  instead of the reference's per-type chunked vectors.
* ``DECIMAL`` is fixed-point: int64 scaled by ``10^frac`` (frac carried on the
  FieldType).  Exact, orderable, and vectorizes onto integer lanes.
* ``BYTES`` columns are numpy object arrays on host.  For device execution the
  group-by path dictionary-encodes them to int codes first.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

from . import datum as datum_mod


class EvalType(enum.Enum):
    INT = "int"
    REAL = "real"
    DECIMAL = "decimal"
    BYTES = "bytes"
    DATETIME = "datetime"  # packed int64 (μs since epoch)
    DURATION = "duration"  # int64 nanoseconds
    JSON = "json"
    # Enum/Set (eval_type.rs:11 lists both as first-class eval types).
    # ENUM columns hold the 1-based element index (0 = MySQL's invalid '')
    # — already a dense dictionary code, which is exactly the device layout;
    # SET columns hold the u64 element bitmask.
    ENUM = "enum"
    SET = "set"


# MySQL type codes (subset; tidb_query_datatype/src/def/field_type.rs)
class FieldTypeTp(enum.IntEnum):
    TINY = 1
    SHORT = 2
    LONG = 3
    FLOAT = 4
    DOUBLE = 5
    NULL = 6
    TIMESTAMP = 7
    LONGLONG = 8
    INT24 = 9
    DATE = 10
    DURATION = 11
    DATETIME = 12
    JSON = 245
    NEW_DECIMAL = 246
    ENUM = 247
    SET = 248
    BLOB = 252
    VAR_STRING = 253
    STRING = 254


UNSIGNED_FLAG = 1 << 5
NOT_NULL_FLAG = 1 << 0
PRI_KEY_FLAG = 1 << 1


_TP_TO_EVAL = {
    FieldTypeTp.TINY: EvalType.INT,
    FieldTypeTp.SHORT: EvalType.INT,
    FieldTypeTp.LONG: EvalType.INT,
    FieldTypeTp.LONGLONG: EvalType.INT,
    FieldTypeTp.INT24: EvalType.INT,
    FieldTypeTp.FLOAT: EvalType.REAL,
    FieldTypeTp.DOUBLE: EvalType.REAL,
    FieldTypeTp.NEW_DECIMAL: EvalType.DECIMAL,
    FieldTypeTp.TIMESTAMP: EvalType.DATETIME,
    FieldTypeTp.DATE: EvalType.DATETIME,
    FieldTypeTp.DATETIME: EvalType.DATETIME,
    FieldTypeTp.DURATION: EvalType.DURATION,
    FieldTypeTp.JSON: EvalType.JSON,
    FieldTypeTp.ENUM: EvalType.ENUM,
    FieldTypeTp.SET: EvalType.SET,
    FieldTypeTp.BLOB: EvalType.BYTES,
    FieldTypeTp.VAR_STRING: EvalType.BYTES,
    FieldTypeTp.STRING: EvalType.BYTES,
}


@dataclass
class FieldType:
    tp: FieldTypeTp = FieldTypeTp.LONGLONG
    flag: int = 0
    flen: int = -1
    decimal: int = 0  # frac digits for NEW_DECIMAL
    collation: str = "binary"
    elems: tuple = ()  # element names (bytes) for ENUM/SET

    @property
    def eval_type(self) -> EvalType:
        return _TP_TO_EVAL[self.tp]

    @property
    def is_unsigned(self) -> bool:
        return bool(self.flag & UNSIGNED_FLAG)

    @classmethod
    def int64(cls, unsigned: bool = False) -> "FieldType":
        return cls(FieldTypeTp.LONGLONG, UNSIGNED_FLAG if unsigned else 0)

    @classmethod
    def double(cls) -> "FieldType":
        return cls(FieldTypeTp.DOUBLE)

    @classmethod
    def decimal_type(cls, frac: int) -> "FieldType":
        return cls(FieldTypeTp.NEW_DECIMAL, decimal=frac)

    @classmethod
    def varchar(cls) -> "FieldType":
        return cls(FieldTypeTp.VAR_STRING)

    @classmethod
    def enum_type(cls, elems: list[bytes]) -> "FieldType":
        if len(elems) > 65535:
            raise ValueError("ENUM supports at most 65535 elements")
        return cls(FieldTypeTp.ENUM, elems=tuple(elems))

    @classmethod
    def set_type(cls, elems: list[bytes]) -> "FieldType":
        if len(elems) > 64:
            raise ValueError("SET supports at most 64 elements")
        return cls(FieldTypeTp.SET, elems=tuple(elems))


@dataclass
class ColumnInfo:
    """Schema entry for a table/index scan (tipb ColumnInfo equivalent)."""

    col_id: int
    ftype: FieldType
    is_pk_handle: bool = False
    default_value: object = None


class Column:
    """One columnar vector: dense values + null mask (True = NULL).

    The reference keeps NULLs implicit per chunked vec; here the mask is an
    explicit numpy bool array so that it ships to the device as-is and
    selection stays a mask operation (never a gather — static shapes).

    BYTES columns may be **dictionary-encoded** (Arrow-style): ``data`` holds
    int64 codes into ``dictionary`` (an object array of bytes).  This is the
    device-friendly representation — group-bys over such columns become dense
    segment ids with no per-row Python.
    """

    __slots__ = ("eval_type", "data", "nulls", "frac", "dictionary")

    def __init__(
        self,
        eval_type: EvalType,
        data,
        nulls: np.ndarray,
        frac: int = 0,
        dictionary: np.ndarray | None = None,
    ):
        self.eval_type = eval_type
        self.data = data
        self.nulls = nulls
        self.frac = frac  # decimal scale
        self.dictionary = dictionary

    @property
    def is_dict_encoded(self) -> bool:
        return self.dictionary is not None

    def decoded(self) -> "Column":
        """Materialize dictionary codes back into an object array.

        ENUM/SET columns are *not* decoded here: their dictionary is a name
        table and their logical value is the index/bitmask itself (use
        ``enum_names``/``set_names`` for the string cast)."""
        if self.dictionary is None or self.eval_type in (EvalType.ENUM, EvalType.SET):
            return self
        return Column(self.eval_type, self.dictionary[self.data], self.nulls, self.frac)

    def __len__(self) -> int:
        return len(self.data)

    @classmethod
    def from_values(cls, eval_type: EvalType, values: list, frac: int = 0) -> "Column":
        """Build from a python list, None meaning NULL."""
        n = len(values)
        nulls = np.array([v is None for v in values], dtype=bool)
        if eval_type == EvalType.SET:
            # u64 bitmask: bit 63 (a 64-element SET) must be representable
            data = np.array([0 if v is None else v for v in values], dtype=np.uint64)
        elif eval_type in (
            EvalType.INT,
            EvalType.DATETIME,
            EvalType.DURATION,
            EvalType.DECIMAL,
            EvalType.ENUM,
        ):
            data = np.array([0 if v is None else v for v in values], dtype=np.int64)
        elif eval_type == EvalType.REAL:
            data = np.array([0.0 if v is None else v for v in values], dtype=np.float64)
        elif eval_type in (EvalType.BYTES, EvalType.JSON):
            data = np.empty(n, dtype=object)
            for i, v in enumerate(values):
                data[i] = b"" if v is None else v
        else:
            raise ValueError(f"unsupported eval type {eval_type}")
        return cls(eval_type, data, nulls, frac)

    def take(self, indices: np.ndarray) -> "Column":
        return Column(self.eval_type, self.data[indices], self.nulls[indices], self.frac, self.dictionary)

    @classmethod
    def concat(cls, cols: list["Column"]) -> "Column":
        assert cols
        dictionary = None
        if cols[0].eval_type in (EvalType.ENUM, EvalType.SET):
            # codes are only meaningful against one shared name table
            dictionary = cols[0].dictionary
            for c in cols[1:]:
                if not np.array_equal(c.dictionary, dictionary):
                    raise ValueError("cannot concat ENUM/SET columns with different elems")
        elif any(c.is_dict_encoded for c in cols):
            cols = [c.decoded() for c in cols]
        return cls(
            cols[0].eval_type,
            np.concatenate([c.data for c in cols]),
            np.concatenate([c.nulls for c in cols]),
            cols[0].frac,
            dictionary,
        )

    def datum_at(self, i: int) -> tuple[int, object]:
        """(flag, value) pair for datum encoding of row ``i``."""
        if self.nulls[i]:
            return datum_mod.NIL_FLAG, None
        if self.eval_type == EvalType.INT:
            return datum_mod.INT_FLAG, int(self.data[i])
        if self.eval_type == EvalType.REAL:
            return datum_mod.FLOAT_FLAG, float(self.data[i])
        if self.eval_type == EvalType.DECIMAL:
            return datum_mod.DECIMAL_FLAG, (int(self.data[i]), self.frac)
        if self.eval_type in (EvalType.BYTES, EvalType.JSON):
            flag = datum_mod.JSON_FLAG if self.eval_type == EvalType.JSON else datum_mod.BYTES_FLAG
            if self.dictionary is not None:
                return flag, bytes(self.dictionary[self.data[i]])
            return flag, bytes(self.data[i])
        if self.eval_type == EvalType.DURATION:
            return datum_mod.DURATION_FLAG, int(self.data[i])
        if self.eval_type in (EvalType.DATETIME, EvalType.ENUM, EvalType.SET):
            return datum_mod.UINT_FLAG, int(self.data[i])
        raise ValueError(f"unsupported eval type {self.eval_type}")


def enum_dictionary(elems: tuple) -> np.ndarray:
    """Name dictionary for an ENUM column: slot 0 is MySQL's invalid ''."""
    d = np.empty(len(elems) + 1, dtype=object)
    d[0] = b""
    for i, e in enumerate(elems):
        d[i + 1] = bytes(e)
    return d


def set_dictionary(elems: tuple) -> np.ndarray:
    """Name dictionary for a SET column: slot b = name of bitmask bit b."""
    return np.array([bytes(e) for e in elems], dtype=object)


def attach_schema_dictionary(info: "ColumnInfo", col: Column) -> Column:
    """Attach the ENUM/SET name table declared by the schema entry."""
    if col.eval_type == EvalType.ENUM:
        col.dictionary = enum_dictionary(info.ftype.elems)
    elif col.eval_type == EvalType.SET:
        col.dictionary = set_dictionary(info.ftype.elems)
    return col


def typed_column(info: "ColumnInfo", values: list) -> Column:
    """Column.from_values typed by a schema entry (shared by the v1 and v2
    row decoders so the construction rule lives in exactly one place)."""
    col = Column.from_values(info.ftype.eval_type, values, info.ftype.decimal)
    return attach_schema_dictionary(info, col)


@dataclass
class Chunk:
    """A batch of columns with a shared logical row selection.

    ``logical_rows`` mirrors BatchExecuteResult.logical_rows
    (tidb_query_executors/src/interface.rs:144): executors filter by updating
    the selection, not by physically compacting — same trick the device path uses
    with masks.
    """

    columns: list[Column]
    logical_rows: np.ndarray  # int indices into the physical rows

    @classmethod
    def full(cls, columns: list[Column]) -> "Chunk":
        n = len(columns[0]) if columns else 0
        return cls(columns, np.arange(n))
