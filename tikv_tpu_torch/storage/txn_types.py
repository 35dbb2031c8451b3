"""MVCC data model: keys, write records and locks.

The port's own copy of ``tikv_tpu/storage/txn_types.py``, trimmed to what
the region write path reads: :class:`Key`, :func:`append_ts` /
:func:`split_ts`, :class:`Write` and :class:`WriteType`, :class:`Lock` and
:class:`LockType`.  The byte layouts are the reference package's, so both
packages read the same engine bytes.

Physical layout of the three MVCC column families:

* ``CF_DEFAULT``: ``encoded_user_key + desc(start_ts)`` → value
* ``CF_LOCK``:    ``encoded_user_key``                  → Lock record
* ``CF_WRITE``:   ``encoded_user_key + desc(commit_ts)`` → Write record

``desc(ts)`` is the bit-flipped big-endian u64 so newer versions sort first.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..util import codec

# ---------------------------------------------------------------------------
# Key  (txn_types/src/types.rs:42 — memcomparable-encoded user key)
# ---------------------------------------------------------------------------

class Key:
    """A memcomparable-encoded key, optionally suffixed with a desc timestamp."""

    __slots__ = ("encoded",)

    def __init__(self, encoded: bytes):
        self.encoded = encoded

    @classmethod
    def from_raw(cls, raw: bytes) -> "Key":
        return cls(codec.encode_bytes(raw))

    @classmethod
    def from_encoded(cls, encoded: bytes) -> "Key":
        return cls(encoded)

    def to_raw(self) -> bytes:
        data, consumed = codec.decode_bytes(self.encoded)
        if consumed != len(self.encoded):
            raise ValueError("key has trailing bytes (timestamp suffix?)")
        return data


def append_ts(encoded_key: bytes, ts: int) -> bytes:
    return encoded_key + codec.encode_u64_desc(ts)


def split_ts(encoded_key_with_ts: bytes) -> tuple[bytes, int]:
    if len(encoded_key_with_ts) < 8:
        raise ValueError("key too short for ts suffix")
    return (
        encoded_key_with_ts[:-8],
        codec.decode_u64_desc(encoded_key_with_ts, len(encoded_key_with_ts) - 8),
    )


# ---------------------------------------------------------------------------
# Write records  (txn_types/src/write.rs:13,63,224)
# ---------------------------------------------------------------------------

SHORT_VALUE_MAX_LEN = 255
_SHORT_VALUE_PREFIX = 0x76  # b'v'
_FLAG_OVERLAPPED_ROLLBACK = 0x52  # b'R'
_GC_FENCE_PREFIX = 0x46  # b'F'


class WriteType(enum.IntEnum):
    PUT = 0x50  # b'P'
    DELETE = 0x44  # b'D'
    LOCK = 0x4C  # b'L'
    ROLLBACK = 0x52  # b'R'


@dataclass
class Write:
    """A committed version record stored in CF_WRITE under key+commit_ts."""

    write_type: WriteType
    start_ts: int
    short_value: bytes | None = None
    has_overlapped_rollback: bool = False
    # gc_fence semantics (write.rs:78-129): None = not set; 0 = deleted/
    # rewritten tail version; >0 = next version's commit ts after a rewrite.
    gc_fence: int | None = None

    def to_bytes(self) -> bytes:
        out = bytearray()
        out.append(int(self.write_type))
        out += codec.encode_var_u64(self.start_ts)
        if self.short_value is not None:
            if len(self.short_value) > SHORT_VALUE_MAX_LEN:
                raise ValueError("short value too long")
            out.append(_SHORT_VALUE_PREFIX)
            out.append(len(self.short_value))
            out += self.short_value
        if self.has_overlapped_rollback:
            out.append(_FLAG_OVERLAPPED_ROLLBACK)
        if self.gc_fence is not None:
            out.append(_GC_FENCE_PREFIX)
            out += codec.encode_u64(self.gc_fence)
        return bytes(out)

    @classmethod
    def from_bytes(cls, b: bytes) -> "Write":
        if not b:
            raise ValueError("empty write record")
        try:
            wt = WriteType(b[0])
        except ValueError as e:
            raise ValueError(str(e)) from None
        start_ts, off = codec.decode_var_u64(b, 1)
        short_value = None
        overlapped = False
        gc_fence = None
        while off < len(b):
            tag = b[off]
            off += 1
            if tag == _SHORT_VALUE_PREFIX:
                if off >= len(b):
                    raise ValueError("write record truncated in short value length")
                n = b[off]
                off += 1
                if off + n > len(b):
                    raise ValueError("write record truncated in short value")
                short_value = b[off : off + n]
                off += n
            elif tag == _FLAG_OVERLAPPED_ROLLBACK:
                overlapped = True
            elif tag == _GC_FENCE_PREFIX:
                if off + 8 > len(b):
                    raise ValueError("write record truncated in gc fence")
                gc_fence = codec.decode_u64(b, off)
                off += 8
            else:
                raise ValueError(f"unknown write tag {tag:#x}")
        return cls(wt, start_ts, short_value, overlapped, gc_fence)


# ---------------------------------------------------------------------------
# Locks  (txn_types/src/lock.rs:13,62)
# ---------------------------------------------------------------------------

_TAG_SHORT_VALUE = 0x76  # b'v'
_TAG_FOR_UPDATE_TS = 0x66  # b'f'
_TAG_TXN_SIZE = 0x74  # b't'
_TAG_MIN_COMMIT_TS = 0x63  # b'c'
_TAG_ASYNC_COMMIT = 0x61  # b'a'
_TAG_ROLLBACK_TS = 0x72  # b'r'


class LockType(enum.IntEnum):
    PUT = 0x50  # b'P'
    DELETE = 0x44  # b'D'
    LOCK = 0x4C  # b'L'
    PESSIMISTIC = 0x53  # b'S'


@dataclass
class Lock:
    """An uncommitted lock stored in CF_LOCK under the user key."""

    lock_type: LockType
    primary: bytes
    ts: int  # start_ts of the locking txn
    ttl: int = 0
    short_value: bytes | None = None
    for_update_ts: int = 0  # >0 ⇒ pessimistic txn
    txn_size: int = 0
    min_commit_ts: int = 0
    use_async_commit: bool = False
    secondaries: list[bytes] = field(default_factory=list)
    rollback_ts: list[int] = field(default_factory=list)

    @classmethod
    def from_bytes(cls, b: bytes) -> "Lock":
        if not b:
            raise ValueError("empty lock record")
        try:
            lt = LockType(b[0])
        except ValueError as e:
            raise ValueError(str(e)) from None
        primary, off = codec.decode_compact_bytes(b, 1)
        ts, off = codec.decode_var_u64(b, off)
        ttl, off = codec.decode_var_u64(b, off)
        lock = cls(lt, primary, ts, ttl)

        def need(n: int) -> None:
            if off + n > len(b):
                raise ValueError("lock record truncated")

        while off < len(b):
            tag = b[off]
            off += 1
            if tag == _TAG_SHORT_VALUE:
                need(1)
                n = b[off]
                off += 1
                need(n)
                lock.short_value = b[off : off + n]
                off += n
            elif tag == _TAG_FOR_UPDATE_TS:
                need(8)
                lock.for_update_ts = codec.decode_u64(b, off)
                off += 8
            elif tag == _TAG_TXN_SIZE:
                need(8)
                lock.txn_size = codec.decode_u64(b, off)
                off += 8
            elif tag == _TAG_MIN_COMMIT_TS:
                need(8)
                lock.min_commit_ts = codec.decode_u64(b, off)
                off += 8
            elif tag == _TAG_ASYNC_COMMIT:
                lock.use_async_commit = True
                n, off = codec.decode_var_u64(b, off)
                for _ in range(n):
                    s, off = codec.decode_compact_bytes(b, off)
                    lock.secondaries.append(s)
            elif tag == _TAG_ROLLBACK_TS:
                n, off = codec.decode_var_u64(b, off)
                need(8 * n)
                for _ in range(n):
                    lock.rollback_ts.append(codec.decode_u64(b, off))
                    off += 8
            else:
                raise ValueError(f"unknown lock tag {tag:#x}")
        return lock

    def is_visible_to(self, read_ts: int, bypass_locks: frozenset[int] = frozenset()) -> bool:
        """True if a read at ``read_ts`` is NOT blocked by this lock.

        Mirrors ``Lock::check_ts_conflict`` (lock.rs:192): Lock/Pessimistic
        locks never block reads; a read below the lock ts passes; MAX_TS reads
        block (latest read must see pending writes) unless bypassed.
        """
        if self.lock_type in (LockType.LOCK, LockType.PESSIMISTIC):
            return True
        if self.ts > read_ts:
            return True
        if self.ts in bypass_locks:
            return True
        if self.min_commit_ts > read_ts:
            return True
        return False
