"""Ordered in-memory multi-CF engine with O(log n) seeks and cheap snapshots.

The port's own copy of ``tikv_tpu/storage/btree_engine.py``: the engine the
region write path reads where no other engine is given (``chip_smoke.py``'s
region, the tests' port side).  Each CF is a sorted key list plus a value
dict; a snapshot freezes the current state, and the first write after it
clones the CF it touches (copy-on-write at CF granularity).

:meth:`BTreeEngine.bulk_load` ingests a batch with one sort, and
:meth:`BTreeEngine.load_triples` takes ``(cf, key, value)`` triples, which is
how the tests carry another engine's column families into this one byte for
byte.  A snapshot's ``scan_cf`` slices the sorted keys instead of stepping a
cursor: the same pairs in the same order.
"""

from __future__ import annotations

import bisect
import threading
from typing import Iterable, Iterator

from .engine import ALL_CFS, Cursor, KvEngine, Snapshot, WriteBatch


class _CfState:
    """Immutable-once-frozen sorted state of one column family."""

    __slots__ = ("keys", "vals", "frozen")

    def __init__(self, keys: list[bytes] | None = None, vals: dict[bytes, bytes] | None = None):
        self.keys: list[bytes] = keys if keys is not None else []
        self.vals: dict[bytes, bytes] = vals if vals is not None else {}
        self.frozen = False

    def clone(self) -> "_CfState":
        return _CfState(list(self.keys), dict(self.vals))


class _ListCursor(Cursor):
    __slots__ = ("_keys", "_vals", "_lo", "_hi", "_pos")

    def __init__(self, state: _CfState, lower: bytes | None, upper: bytes | None):
        self._keys = state.keys
        self._vals = state.vals
        self._lo = 0 if lower is None else bisect.bisect_left(self._keys, lower)
        self._hi = len(self._keys) if upper is None else bisect.bisect_left(self._keys, upper)
        self._pos = -1

    def seek(self, key: bytes) -> bool:
        self._pos = max(bisect.bisect_left(self._keys, key), self._lo)
        return self.valid()

    def next(self) -> bool:
        self._pos += 1
        return self.valid()

    def valid(self) -> bool:
        return self._lo <= self._pos < self._hi

    def key(self) -> bytes:
        return self._keys[self._pos]

    def value(self) -> bytes:
        return self._vals[self._keys[self._pos]]


class BTreeSnapshot(Snapshot):
    __slots__ = ("_states",)

    def __init__(self, states: dict[str, _CfState]):
        self._states = states

    def get_cf(self, cf: str, key: bytes) -> bytes | None:
        return self._states[cf].vals.get(key)

    def cursor_cf(self, cf: str, lower: bytes | None = None, upper: bytes | None = None) -> Cursor:
        return _ListCursor(self._states[cf], lower, upper)

    def scan_cf(self, cf: str, start: bytes, end: bytes | None) -> Iterator[tuple[bytes, bytes]]:
        # a frozen state never changes: slicing it is the cursor walk
        state = self._states[cf]
        lo = bisect.bisect_left(state.keys, start)
        hi = len(state.keys) if end is None else bisect.bisect_left(state.keys, end)
        vals = state.vals
        return iter([(k, vals[k]) for k in state.keys[lo:max(lo, hi)]])


class BTreeEngine(KvEngine):
    def __init__(self, cfs: tuple[str, ...] = ALL_CFS):
        self._lock = threading.RLock()
        self._cfs: dict[str, _CfState] = {cf: _CfState() for cf in cfs}

    def _writable(self, cf: str) -> _CfState:
        state = self._cfs[cf]
        if state.frozen:
            state = state.clone()
            self._cfs[cf] = state
        return state

    def write(self, batch: WriteBatch) -> None:
        with self._lock:
            for op, cf, key, val in batch.ops:
                state = self._writable(cf)
                if op == "put":
                    if key not in state.vals:
                        bisect.insort(state.keys, key)
                    state.vals[key] = val
                elif op == "delete":
                    if key in state.vals:
                        del state.vals[key]
                        i = bisect.bisect_left(state.keys, key)
                        del state.keys[i]
                else:
                    raise ValueError(f"unknown op {op}")

    def bulk_load(self, cf: str, items: Iterable[tuple[bytes, bytes]]) -> None:
        """Merge a batch of (key, value) pairs in one sort."""
        with self._lock:
            state = self._writable(cf)
            state.vals.update(items)
            state.keys = sorted(state.vals)

    def load_triples(self, triples: Iterable[tuple[str, bytes, bytes]]) -> None:
        """Merge ``(cf, key, value)`` triples, one sort per column family."""
        by_cf: dict[str, list] = {}
        for cf, key, value in triples:
            by_cf.setdefault(cf, []).append((key, value))
        for cf, items in by_cf.items():
            self.bulk_load(cf, items)

    def snapshot(self) -> BTreeSnapshot:
        with self._lock:
            for state in self._cfs.values():
                state.frozen = True
            return BTreeSnapshot(dict(self._cfs))

    def get_cf(self, cf: str, key: bytes) -> bytes | None:
        with self._lock:
            return self._cfs[cf].vals.get(key)
