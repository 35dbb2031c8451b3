"""Scan sources (tidb_query_common Storage trait + RangesScanner equivalent).

The port's subset of ``tikv_tpu/copr/executors.py``: the ``ScanSource``
interface the evaluator's cold path pulls raw ``(key, value)`` pairs from,
the in-memory ``FixtureScanSource``, and the two helpers that host group-id
assignment shares with the CPU hash aggregation (``cols_for_eval``,
``_coded_group_parts``).  The CPU executor chain is not ported; the JAX
package's stays the oracle.
"""

from __future__ import annotations

import numpy as np

from .datatypes import Column, EvalType


def cols_for_eval(columns: list[Column], needed=None) -> dict:
    """(data, nulls) pairs for expression eval; dictionary-encoded bytes
    columns are materialized only when an expression actually references
    them."""
    out = {}
    for i, c in enumerate(columns):
        if needed is not None and i not in needed:
            continue
        c = c.decoded() if c.is_dict_encoded else c
        out[i] = (c.data, c.nulls)
    return out


def _coded_group_parts(group_rpns, columns, rows: np.ndarray):
    """If every group expr is a bare ref to a dictionary-encoded column (and
    the product capacity stays small), return [(codes, nulls, dictionary)]."""
    parts = []
    cap = 1
    for g in group_rpns:
        if len(g.nodes) != 1 or g.nodes[0].kind != "col":
            return None
        c = columns[g.nodes[0].index]
        if not c.is_dict_encoded:
            return None
        if c.eval_type in (EvalType.ENUM, EvalType.SET):
            # their dictionary is a name table, not a code table: ENUM codes
            # ARE the group value (generic int path), SET masks aren't codes
            return None
        cap *= len(c.dictionary) + 1
        if cap > (1 << 20):
            return None
        parts.append((np.asarray(c.data)[rows], np.asarray(c.nulls)[rows], c.dictionary))
    return parts or None


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
