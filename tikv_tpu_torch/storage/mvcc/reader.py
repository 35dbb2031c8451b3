"""MVCC read path: point gets and the forward range scanner over a snapshot.

The port's own copy of ``tikv_tpu/storage/mvcc/reader.py``, trimmed to what
the region write path reads: :class:`Statistics`, :func:`_check_lock` with
:class:`KeyIsLockedError`, :class:`PointGetter` (``mvcc_batch``'s exact
per-key resolve) and :class:`ForwardScanner` (its fallback for ranges that
do not vectorize).

Semantics (Percolator/SI):

* A read at ``ts`` must first consult CF_LOCK — a PUT/DELETE lock from a txn
  with ``lock.ts <= ts`` blocks the read (the writing txn may commit below our
  read ts) unless bypassed or pushed via ``min_commit_ts``.
* The visible version is the newest CF_WRITE entry with ``commit_ts <= ts``,
  skipping LOCK/ROLLBACK records; PUT yields a value (inline short value or
  CF_DEFAULT at ``start_ts``), DELETE yields nothing.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ...util import codec
from ..engine import CF_DEFAULT, CF_LOCK, CF_WRITE, Cursor, Snapshot
from ..txn_types import Key, Lock, Write, WriteType, append_ts, split_ts


class IsolationLevel(enum.Enum):
    SI = "si"
    RC = "rc"


class KeyIsLockedError(Exception):
    def __init__(self, key: bytes, lock: Lock):
        self.key = key
        self.lock = lock
        super().__init__(f"key {key!r} is locked by txn {lock.ts} (primary {lock.primary!r})")


@dataclass
class CfStatistics:
    get: int = 0
    next: int = 0
    prev: int = 0
    seek: int = 0
    seek_for_prev: int = 0
    processed_keys: int = 0


@dataclass
class Statistics:
    """Per-CF cursor operation counts (tikv_kv/src/stats.rs)."""

    lock: CfStatistics = field(default_factory=CfStatistics)
    write: CfStatistics = field(default_factory=CfStatistics)
    data: CfStatistics = field(default_factory=CfStatistics)


# the largest possible ts suffix: appending desc(0) sorts after every real version
_LAST_VERSION_SUFFIX = codec.encode_u64_desc(0)


def _check_lock(
    lock_bytes: bytes,
    key_raw: bytes,
    ts: int,
    bypass_locks: frozenset[int],
) -> int:
    """Raise KeyIsLockedError if the lock blocks a read at ``ts``.

    Returns the ts to actually read at (committing-lock reads see through at
    the same ts; mirrors Lock::check_ts_conflict lock.rs:192).
    """
    lock = Lock.from_bytes(lock_bytes)
    if not lock.is_visible_to(ts, bypass_locks):
        raise KeyIsLockedError(key_raw, lock)
    return ts


class PointGetter:
    """Single-key visible-version lookup (point_getter.rs:136)."""

    def __init__(
        self,
        snapshot: Snapshot,
        ts: int,
        isolation: IsolationLevel = IsolationLevel.SI,
        bypass_locks: frozenset[int] = frozenset(),
        statistics: Statistics | None = None,
    ):
        self.snap = snapshot
        self.ts = ts
        self.isolation = isolation
        self.bypass_locks = bypass_locks
        self.stats = statistics or Statistics()

    def get(self, key: Key) -> bytes | None:
        if self.isolation == IsolationLevel.SI:
            self.stats.lock.get += 1
            lock_bytes = self.snap.get_cf(CF_LOCK, key.encoded)
            if lock_bytes is not None:
                _check_lock(lock_bytes, key.to_raw(), self.ts, self.bypass_locks)

        cur = self.snap.cursor_cf(CF_WRITE)
        self.stats.write.seek += 1
        ok = cur.seek(append_ts(key.encoded, self.ts))
        while ok:
            user_key, commit_ts = split_ts(cur.key())
            if user_key != key.encoded:
                return None
            write = Write.from_bytes(cur.value())
            if write.write_type == WriteType.PUT:
                self.stats.write.processed_keys += 1
                if write.short_value is not None:
                    return write.short_value
                self.stats.data.get += 1
                v = self.snap.get_cf(CF_DEFAULT, append_ts(key.encoded, write.start_ts))
                if v is None:
                    raise ValueError(f"default value missing for {key!r} @ {write.start_ts}")
                return v
            if write.write_type == WriteType.DELETE:
                return None
            # LOCK / ROLLBACK: look at the next (older) version
            self.stats.write.next += 1
            ok = cur.next()
        return None


class _ScannerBase:
    def __init__(
        self,
        snapshot: Snapshot,
        ts: int,
        start: Key | None,
        end: Key | None,
        isolation: IsolationLevel = IsolationLevel.SI,
        bypass_locks: frozenset[int] = frozenset(),
        statistics: Statistics | None = None,
    ):
        self.snap = snapshot
        self.ts = ts
        self.start = start.encoded if start else b""
        self.end = end.encoded if end else None
        self.isolation = isolation
        self.bypass_locks = bypass_locks
        self.stats = statistics or Statistics()

    def _check_range_locks(self) -> None:
        """Every lock in the scanned range must permit a read at ``ts`` —
        including locks on keys with no CF_WRITE entries yet (a prewritten
        brand-new key MUST block the scan, same as PointGetter; the reference
        walks a parallel lock cursor in forward.rs for exactly this)."""
        if self.isolation != IsolationLevel.SI:
            return
        for k, v in self.snap.scan_cf(CF_LOCK, self.start, self.end):
            self.stats.lock.next += 1
            _check_lock(v, Key.from_encoded(k).to_raw(), self.ts, self.bypass_locks)

    def _resolve_version(self, cur: Cursor, user_key: bytes) -> bytes | None:
        """From a cursor positioned at the newest candidate version of
        ``user_key`` with commit_ts <= ts, find the visible value."""
        ok = True
        while ok:
            k, _ = split_ts(cur.key())
            if k != user_key:
                return None
            write = Write.from_bytes(cur.value())
            if write.write_type == WriteType.PUT:
                self.stats.write.processed_keys += 1
                if write.short_value is not None:
                    return write.short_value
                self.stats.data.get += 1
                v = self.snap.get_cf(CF_DEFAULT, append_ts(user_key, write.start_ts))
                if v is None:
                    raise ValueError(f"default value missing for {user_key!r}")
                return v
            if write.write_type == WriteType.DELETE:
                return None
            self.stats.write.next += 1
            ok = cur.next()
        return None


class ForwardScanner(_ScannerBase):
    """Ascending scan emitting (raw_key, value) of visible versions
    (scanner/forward.rs:114, latest-KV policy)."""

    def __iter__(self):
        self._check_range_locks()
        cur = self.snap.cursor_cf(CF_WRITE, upper=self.end)
        self.stats.write.seek += 1
        ok = cur.seek(self.start)
        while ok:
            user_key, commit_ts = split_ts(cur.key())
            if self.end is not None and user_key >= self.end:
                return
            if commit_ts > self.ts:
                # newer than the read point: hop to (user_key, ts)
                self.stats.write.seek += 1
                ok = cur.seek(append_ts(user_key, self.ts))
                if ok:
                    k2, _ = split_ts(cur.key())
                    if k2 == user_key:
                        value = self._resolve_version(cur, user_key)
                        if value is not None:
                            yield Key.from_encoded(user_key).to_raw(), value
                ok = self._skip_to_next_key(cur, user_key)
                continue
            value = self._resolve_version(cur, user_key)
            if value is not None:
                yield Key.from_encoded(user_key).to_raw(), value
            ok = self._skip_to_next_key(cur, user_key)

    def _skip_to_next_key(self, cur: Cursor, user_key: bytes) -> bool:
        self.stats.write.seek += 1
        ok = cur.seek(user_key + _LAST_VERSION_SUFFIX)
        while ok:
            k, _ = split_ts(cur.key())
            if k != user_key:
                return True
            self.stats.write.next += 1
            ok = cur.next()
        return False
