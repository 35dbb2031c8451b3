"""Datum v1 row codec.

The port's own copy of ``tikv_tpu/copr/datum.py``, without the JSON datum
(no JSON value reaches this slice).

Re-expression of the reference's ``tidb_query_datatype/src/codec/datum.rs``:
each value is a one-byte flag followed by a flag-specific payload.  Flag values
match the reference so key/value material is interoperable in spirit:

  NIL=0, BYTES=1, COMPACT_BYTES=2, INT=3, UINT=4, FLOAT=5, DECIMAL=6,
  DURATION=7, VARINT=8, UVARINT=9, JSON=10, MAX=250

Decimals here are this framework's device-friendly representation: a scaled
int64 (``value * 10^frac``) encoded as (frac: u8, varint scaled) — exact
fixed-point arithmetic that maps directly onto integer vector lanes, instead
of the reference's base-10^9 word array (``codec/mysql/decimal.rs``).
"""

from __future__ import annotations

from ..util import codec

NIL_FLAG = 0
BYTES_FLAG = 1
COMPACT_BYTES_FLAG = 2
INT_FLAG = 3
UINT_FLAG = 4
FLOAT_FLAG = 5
DECIMAL_FLAG = 6
DURATION_FLAG = 7
VARINT_FLAG = 8
UVARINT_FLAG = 9
JSON_FLAG = 10
MAX_FLAG = 250


class Datum:
    """Tagged scalar. value is None | int | float | bytes | (scaled, frac)."""

    __slots__ = ("flag", "value")

    def __init__(self, flag: int, value):
        self.flag = flag
        self.value = value

    def __repr__(self):
        return f"Datum({self.flag}, {self.value!r})"

    def __eq__(self, other):
        return isinstance(other, Datum) and self.flag == other.flag and self.value == other.value


def encode_datum(out: bytearray, flag: int, value, for_key: bool = False) -> None:
    """Append one datum. ``for_key`` selects memcomparable encodings."""
    if flag == NIL_FLAG:
        out.append(NIL_FLAG)
    elif flag == INT_FLAG:
        if for_key:
            out.append(INT_FLAG)
            out += codec.encode_i64(value)
        else:
            out.append(VARINT_FLAG)
            out += codec.encode_var_i64(value)
    elif flag == UINT_FLAG:
        if for_key:
            out.append(UINT_FLAG)
            out += codec.encode_u64(value)
        else:
            out.append(UVARINT_FLAG)
            out += codec.encode_var_u64(value)
    elif flag == FLOAT_FLAG:
        out.append(FLOAT_FLAG)
        out += codec.encode_f64(value)
    elif flag == BYTES_FLAG:
        if for_key:
            out.append(BYTES_FLAG)
            out += codec.encode_bytes(value)
        else:
            out.append(COMPACT_BYTES_FLAG)
            out += codec.encode_compact_bytes(value)
    elif flag == DECIMAL_FLAG:
        scaled, frac = value
        out.append(DECIMAL_FLAG)
        out.append(frac)
        # fixed 8-byte memcomparable i64: decimals stay fixed-width so row
        # blocks batch-decode as a reshape, and key encodings order correctly
        out += codec.encode_i64(scaled)
    elif flag == DURATION_FLAG:
        out.append(DURATION_FLAG)
        out += codec.encode_i64(value)
    elif flag == JSON_FLAG:
        # value is the self-delimiting binary JSON payload (type byte + body)
        out.append(JSON_FLAG)
        out += value
    elif flag == MAX_FLAG:
        out.append(MAX_FLAG)
    else:
        raise ValueError(f"unsupported datum flag {flag}")


def decode_datum(b: bytes, offset: int = 0) -> tuple[Datum, int]:
    flag = b[offset]
    offset += 1
    if flag == NIL_FLAG:
        return Datum(NIL_FLAG, None), offset
    if flag == INT_FLAG:
        return Datum(INT_FLAG, codec.decode_i64(b, offset)), offset + 8
    if flag == UINT_FLAG:
        return Datum(UINT_FLAG, codec.decode_u64(b, offset)), offset + 8
    if flag == VARINT_FLAG:
        v, offset = codec.decode_var_i64(b, offset)
        return Datum(INT_FLAG, v), offset
    if flag == UVARINT_FLAG:
        v, offset = codec.decode_var_u64(b, offset)
        return Datum(UINT_FLAG, v), offset
    if flag == FLOAT_FLAG:
        return Datum(FLOAT_FLAG, codec.decode_f64(b, offset)), offset + 8
    if flag == BYTES_FLAG:
        v, consumed = codec.decode_bytes(b[offset:])
        return Datum(BYTES_FLAG, v), offset + consumed
    if flag == COMPACT_BYTES_FLAG:
        v, offset = codec.decode_compact_bytes(b, offset)
        return Datum(BYTES_FLAG, v), offset
    if flag == DECIMAL_FLAG:
        frac = b[offset]
        scaled = codec.decode_i64(b, offset + 1)
        return Datum(DECIMAL_FLAG, (scaled, frac)), offset + 9
    if flag == DURATION_FLAG:
        return Datum(DURATION_FLAG, codec.decode_i64(b, offset)), offset + 8
    if flag == JSON_FLAG:
        raise ValueError("JSON datums are not ported")
    if flag == MAX_FLAG:
        return Datum(MAX_FLAG, None), offset
    raise ValueError(f"unknown datum flag {flag}")


def decode_datums(b: bytes) -> list[Datum]:
    out = []
    off = 0
    while off < len(b):
        d, off = decode_datum(b, off)
        out.append(d)
    return out


def encode_row_value(col_ids: list[int], datums: list[tuple[int, object]]) -> bytes:
    """Row value: alternating (col_id as varint-int datum, value datum) pairs —
    the reference's datum-v1 row layout (codec/table.rs)."""
    out = bytearray()
    for cid, (flag, value) in zip(col_ids, datums):
        encode_datum(out, INT_FLAG, cid)
        encode_datum(out, flag, value)
    return bytes(out)


def decode_row_value(b: bytes) -> dict[int, Datum]:
    ds = decode_datums(b)
    if len(ds) % 2 != 0:
        raise ValueError("odd number of datums in row")
    out = {}
    for i in range(0, len(ds), 2):
        if ds[i].flag != INT_FLAG:
            raise ValueError("row col id must be int datum")
        out[ds[i].value] = ds[i + 1]
    return out
