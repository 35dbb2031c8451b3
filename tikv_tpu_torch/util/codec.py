"""Low-level encodings: memcomparable bytes, fixed/var ints, f64.

The port's own copy of ``tikv_tpu/util/codec.py`` (the port imports nothing
of ``tikv_tpu``).  A re-expression of the reference's codec crate
(``components/codec/src/byte.rs``, ``number.rs``): same wire formats (so keys
sort identically and datum payloads round-trip), but implemented once as Python
scalar codecs and once as numpy batch codecs — the batch variants are what the
coprocessor leaf uses to turn row blocks into columnar arrays without a Python
loop per row.

Wire formats (identical to the reference):

* memcomparable bytes (asc): the input is chopped into groups of 8; every group
  is zero-padded to 8 bytes and followed by a marker byte ``0xFF - pad_count``.
  Descending variant bit-flips every byte of the ascending encoding.
* u64: 8-byte big-endian.  i64: sign bit flipped, then as u64.
* f64: if sign bit clear, flip sign bit; else flip all 64 bits; then big-endian.
* varint: LEB128 (u64); signed variant uses zigzag.
* compact bytes: zigzag varint length prefix + raw bytes.
"""

from __future__ import annotations

import struct

import numpy as np

ENC_GROUP_SIZE = 8
ENC_MARKER = 0xFF
ENC_ASC_PADDING = b"\x00" * ENC_GROUP_SIZE
ENC_DESC_PADDING = b"\xff" * ENC_GROUP_SIZE

_U64 = struct.Struct(">Q")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U64_LE = struct.Struct("<Q")
_U32 = struct.Struct(">I")
_U16 = struct.Struct(">H")

SIGN_MASK = 0x8000000000000000


# ---------------------------------------------------------------------------
# memcomparable bytes
# ---------------------------------------------------------------------------

def encode_bytes(data: bytes, desc: bool = False) -> bytes:
    """Encode ``data`` so lexicographic compare of encodings == compare of data."""
    out = bytearray()
    n = len(data)
    for i in range(0, n + 1, ENC_GROUP_SIZE):
        group = data[i : i + ENC_GROUP_SIZE]
        pad = ENC_GROUP_SIZE - len(group)
        out += group
        out += ENC_ASC_PADDING[:pad]
        out.append(ENC_MARKER - pad)
        if pad > 0:
            break
    if desc:
        return bytes(b ^ 0xFF for b in out)
    return bytes(out)


def decode_bytes(enc: bytes, desc: bool = False) -> tuple[bytes, int]:
    """Decode memcomparable bytes. Returns (data, bytes_consumed)."""
    out = bytearray()
    offset = 0
    xor = 0xFF if desc else 0x00
    while True:
        chunk = enc[offset : offset + ENC_GROUP_SIZE + 1]
        if len(chunk) < ENC_GROUP_SIZE + 1:
            raise ValueError("insufficient bytes to decode")
        marker = chunk[ENC_GROUP_SIZE] ^ xor
        pad = ENC_MARKER - marker
        if not 0 <= pad <= ENC_GROUP_SIZE:
            raise ValueError(f"invalid marker byte {marker:#x}")
        group = bytes(b ^ xor for b in chunk[:ENC_GROUP_SIZE])
        offset += ENC_GROUP_SIZE + 1
        if pad:
            padding = group[ENC_GROUP_SIZE - pad :]
            expect = b"\x00" * pad
            if padding != expect:
                raise ValueError("invalid padding")
            out += group[: ENC_GROUP_SIZE - pad]
            return bytes(out), offset
        out += group


# ---------------------------------------------------------------------------
# fixed-width numbers
# ---------------------------------------------------------------------------

def encode_u64(v: int) -> bytes:
    return _U64.pack(v & 0xFFFFFFFFFFFFFFFF)


def decode_u64(b: bytes, offset: int = 0) -> int:
    return _U64.unpack_from(b, offset)[0]


def encode_u64_desc(v: int) -> bytes:
    return _U64.pack((v & 0xFFFFFFFFFFFFFFFF) ^ 0xFFFFFFFFFFFFFFFF)


def decode_u64_desc(b: bytes, offset: int = 0) -> int:
    return _U64.unpack_from(b, offset)[0] ^ 0xFFFFFFFFFFFFFFFF


def encode_i64(v: int) -> bytes:
    return _U64.pack((v ^ SIGN_MASK) & 0xFFFFFFFFFFFFFFFF)


def decode_i64(b: bytes, offset: int = 0) -> int:
    u = _U64.unpack_from(b, offset)[0] ^ SIGN_MASK
    return u - 0x10000000000000000 if u & SIGN_MASK else u


def encode_f64(v: float) -> bytes:
    (u,) = _U64.unpack(_F64.pack(v))
    if u & SIGN_MASK:
        u ^= 0xFFFFFFFFFFFFFFFF
    else:
        u ^= SIGN_MASK
    return _U64.pack(u)


def decode_f64(b: bytes, offset: int = 0) -> float:
    u = _U64.unpack_from(b, offset)[0]
    if u & SIGN_MASK:
        u ^= SIGN_MASK
    else:
        u ^= 0xFFFFFFFFFFFFFFFF
    return _F64.unpack(_U64.pack(u))[0]


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------

def encode_var_u64(v: int) -> bytes:
    out = bytearray()
    v &= 0xFFFFFFFFFFFFFFFF
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_var_u64(b: bytes, offset: int = 0) -> tuple[int, int]:
    """Returns (value, new_offset)."""
    result = 0
    shift = 0
    while True:
        if offset >= len(b):
            raise ValueError("varint truncated")
        byte = b[offset]
        offset += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result & 0xFFFFFFFFFFFFFFFF, offset
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def encode_var_i64(v: int) -> bytes:
    # zigzag
    zz = ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF
    return encode_var_u64(zz)


def decode_var_i64(b: bytes, offset: int = 0) -> tuple[int, int]:
    zz, offset = decode_var_u64(b, offset)
    v = (zz >> 1) ^ -(zz & 1)
    return v, offset


def encode_compact_bytes(data: bytes) -> bytes:
    return encode_var_i64(len(data)) + data


def decode_compact_bytes(b: bytes, offset: int = 0) -> tuple[bytes, int]:
    n, offset = decode_var_i64(b, offset)
    if n < 0 or offset + n > len(b):
        raise ValueError("compact bytes truncated")
    return b[offset : offset + n], offset + n


# ---------------------------------------------------------------------------
# numpy batch codecs — the coprocessor's row→column fast path
# ---------------------------------------------------------------------------

def encode_u64_batch(vals: np.ndarray) -> np.ndarray:
    """(n,) uint64 → (n, 8) uint8 big-endian."""
    return vals.astype(">u8").view(np.uint8).reshape(-1, 8)


def decode_u64_batch(rows: np.ndarray) -> np.ndarray:
    """(n, 8) uint8 big-endian → (n,) uint64."""
    return np.ascontiguousarray(rows, dtype=np.uint8).view(">u8").reshape(-1).astype(np.uint64)


def encode_i64_batch(vals: np.ndarray) -> np.ndarray:
    u = vals.astype(np.int64).view(np.uint64) ^ np.uint64(SIGN_MASK)
    return encode_u64_batch(u)


def decode_i64_batch(rows: np.ndarray) -> np.ndarray:
    u = decode_u64_batch(rows) ^ np.uint64(SIGN_MASK)
    return u.view(np.int64)


def encode_f64_batch(vals: np.ndarray) -> np.ndarray:
    """(n,) float64 → (n, 8) uint8: :func:`encode_f64` of each value."""
    u = np.ascontiguousarray(vals, dtype=np.float64).view(np.uint64)
    neg = (u & np.uint64(SIGN_MASK)) != 0
    return encode_u64_batch(np.where(neg, ~u, u ^ np.uint64(SIGN_MASK)))


def decode_f64_batch(rows: np.ndarray) -> np.ndarray:
    u = decode_u64_batch(rows)
    # encoded sign bit set ⇔ original value was non-negative
    was_nonneg = (u & np.uint64(SIGN_MASK)) != 0
    u = np.where(was_nonneg, u ^ np.uint64(SIGN_MASK), u ^ np.uint64(0xFFFFFFFFFFFFFFFF))
    return u.view(np.float64)
