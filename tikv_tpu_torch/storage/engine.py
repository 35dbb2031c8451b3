"""Storage-engine trait layer: column families, cursors, snapshots, batches.

The port's own copy of ``tikv_tpu/storage/engine.py`` (the port imports
nothing of ``tikv_tpu``), trimmed to what the region write path reads: the
column-family names, the forward :class:`Cursor`, :class:`Snapshot` with
``scan_cf``, :class:`WriteBatch` and :class:`KvEngine`.  Column
families mirror TiKV's ``cf_defs.rs``: default / lock / write / raft.
"""

from __future__ import annotations

import abc
from typing import Iterator

CF_DEFAULT = "default"
CF_LOCK = "lock"
CF_WRITE = "write"
CF_RAFT = "raft"
ALL_CFS = (CF_DEFAULT, CF_LOCK, CF_WRITE, CF_RAFT)
DATA_CFS = (CF_DEFAULT, CF_LOCK, CF_WRITE)


class Cursor(abc.ABC):
    """A forward iterator over one CF of a snapshot: valid (on an entry) or
    not; ``seek`` lands on the first entry >= key."""

    @abc.abstractmethod
    def seek(self, key: bytes) -> bool: ...

    @abc.abstractmethod
    def next(self) -> bool: ...

    @abc.abstractmethod
    def valid(self) -> bool: ...

    @abc.abstractmethod
    def key(self) -> bytes: ...

    @abc.abstractmethod
    def value(self) -> bytes: ...


class Snapshot(abc.ABC):
    """A consistent, immutable view of the engine."""

    @abc.abstractmethod
    def get_cf(self, cf: str, key: bytes) -> bytes | None: ...

    @abc.abstractmethod
    def cursor_cf(self, cf: str, lower: bytes | None = None, upper: bytes | None = None) -> Cursor: ...

    def scan_cf(self, cf: str, start: bytes, end: bytes | None) -> Iterator[tuple[bytes, bytes]]:
        """Yield (key, value) in [start, end) — convenience over cursors."""
        cur = self.cursor_cf(cf, lower=start, upper=end)
        ok = cur.seek(start)
        while ok:
            if end is not None and cur.key() >= end:
                break
            yield cur.key(), cur.value()
            ok = cur.next()


class WriteBatch:
    """Ordered list of mutations applied atomically."""

    __slots__ = ("ops",)

    def __init__(self):
        # (op, cf, key, value or None)
        self.ops: list[tuple[str, str, bytes, bytes | None]] = []

    def put_cf(self, cf: str, key: bytes, value: bytes) -> None:
        self.ops.append(("put", cf, key, value))

    def delete_cf(self, cf: str, key: bytes) -> None:
        self.ops.append(("delete", cf, key, None))



class KvEngine(abc.ABC):
    """The engine interface: batches, snapshots and point reads."""

    @abc.abstractmethod
    def write(self, batch: WriteBatch) -> None: ...

    @abc.abstractmethod
    def snapshot(self) -> Snapshot: ...

    @abc.abstractmethod
    def get_cf(self, cf: str, key: bytes) -> bytes | None: ...
