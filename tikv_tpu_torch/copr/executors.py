"""Scan sources (tidb_query_common Storage trait + RangesScanner equivalent).

The port's subset of ``tikv_tpu/copr/executors.py``: the ``ScanSource``
interface the evaluator's cold path pulls raw ``(key, value)`` pairs from,
and the in-memory ``FixtureScanSource``.  The CPU executor chain is not
ported; the JAX package's stays the oracle.
"""

from __future__ import annotations


class ScanSource:
    """Produces raw (key, value) pairs range by range."""

    def next_batch(self, n: int) -> tuple[list[bytes], list[bytes], bool]:
        """Returns (keys, values, drained)."""
        raise NotImplementedError


class FixtureScanSource(ScanSource):
    """In-memory (key, value) fixture — test/bench leaf without MVCC."""

    def __init__(self, items: list[tuple[bytes, bytes]]):
        self.items = items
        self.pos = 0

    def next_batch(self, n: int) -> tuple[list[bytes], list[bytes], bool]:
        chunk = self.items[self.pos : self.pos + n]
        self.pos += len(chunk)
        return [k for k, _ in chunk], [v for _, v in chunk], self.pos >= len(self.items)
