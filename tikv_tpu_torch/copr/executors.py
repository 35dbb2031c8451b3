"""Scan sources, and the host executors the device path finishes with.

The port's subset of ``tikv_tpu/copr/executors.py``: the ``ScanSource``
interface the evaluator's cold path pulls raw ``(key, value)`` pairs from,
the in-memory ``FixtureScanSource``, the two helpers that host group-id
assignment shares with the CPU hash aggregation (``cols_for_eval``,
``_coded_group_parts``), and ``BatchTopNExecutor`` with its comparator,
which orders the small aggregated chunk of a TopN after an aggregation on
the host (as the JAX package does, ``jax_eval._post_agg``).  The rest of the
CPU executor chain is not ported; the JAX package's stays the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cmp_to_key

import numpy as np
import torch

from .datatypes import Chunk, Column, EvalType
from .rpn import Expr, RpnExpression, compile_expr, eval_rpn


@dataclass
class BatchExecuteResult:
    chunk: Chunk
    is_drained: bool


class BatchExecutor:
    """A pull executor (tidb_query_executors' BatchExecutor trait)."""

    def schema(self) -> list:
        """[(eval_type, frac)] of the output columns."""
        raise NotImplementedError

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        raise NotImplementedError


class ChunkExecutor(BatchExecutor):
    """Presents one in-memory chunk as a drained executor
    (``jax_eval._ChunkExecutor``)."""

    def __init__(self, chunk: Chunk, schema):
        self._chunk = chunk
        self._schema = schema
        self._done = False

    def schema(self):
        return self._schema

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._done:
            return BatchExecuteResult(Chunk.full([]), True)
        self._done = True
        return BatchExecuteResult(self._chunk, True)


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


# ---------------------------------------------------------------------------
# TopN
# ---------------------------------------------------------------------------

def host_eval(rpn: RpnExpression, columns: list[Column], n: int):
    """``(data, nulls)`` numpy arrays of an expression over host columns: a
    bare column as it is (dictionary codes decoded), else the port's scalar
    kernels on CPU tensors, which take no bytes."""
    if len(rpn.nodes) == 1 and rpn.nodes[0].kind == "col":
        c = columns[rpn.nodes[0].index]
        c = c.decoded() if c.is_dict_encoded else c
        return np.asarray(c.data), np.asarray(c.nulls)
    tcols = {i: (torch.from_numpy(np.ascontiguousarray(d)),
                 torch.from_numpy(np.ascontiguousarray(nl)))
             for i, (d, nl) in cols_for_eval(columns, rpn.referenced_columns()).items()}
    d, nl = eval_rpn(rpn, tcols, n, device=torch.device("cpu"))
    return d.numpy(), nl.numpy()


class BatchTopNExecutor(BatchExecutor):
    """Bounded order-by (top_n_executor.rs:21): accumulate, prune to the best
    ``limit`` rows whenever the buffer doubles, final sort at drain."""

    def __init__(self, child: BatchExecutor, order_by: list[tuple[Expr, bool]], limit: int):
        self.child = child
        self._schema = child.schema()
        self.order_by = [(compile_expr(e, self._schema), desc) for e, desc in order_by]
        self.limit = limit
        self._done = False

    def schema(self):
        return self._schema

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._done:
            return BatchExecuteResult(Chunk.full([]), True)
        key_fn = cmp_to_key(_row_cmp)
        # entries hold materialized row values so pruning releases the source
        # chunks — memory stays O(limit), not O(rows scanned)
        buf: list[tuple] = []  # (sort_key, seq, row_values)
        seq = 0
        drained = False
        enum_dicts: dict[int, np.ndarray] = {}
        while not drained:
            r = self.child.next_batch(scan_rows)
            drained = r.is_drained
            chunk = r.chunk
            if not len(chunk.logical_rows):
                continue
            for ci, c in enumerate(chunk.columns):
                # ENUM/SET codes are only meaningful with their name table —
                # carry it through the row rebuild below
                if c.eval_type in (EvalType.ENUM, EvalType.SET) and c.dictionary is not None:
                    enum_dicts.setdefault(ci, c.dictionary)
            n = len(chunk.columns[0])
            keys = []
            for rpn, desc in self.order_by:
                data, nulls = host_eval(rpn, chunk.columns, n)
                keys.append((data, nulls, desc))
            for row in chunk.logical_rows:
                row = int(row)
                values = tuple(
                    None if c.nulls[row] else _as_py(c, row) for c in chunk.columns
                )
                buf.append((_sort_key(keys, row), seq, values))
                seq += 1
            if len(buf) >= max(2 * self.limit, 4096):
                buf.sort(key=lambda it: (key_fn(it[0]), it[1]))
                del buf[self.limit :]
        self._done = True
        buf.sort(key=lambda it: (key_fn(it[0]), it[1]))
        del buf[self.limit :]
        out_cols: list[Column] = []
        for col_idx, (et, frac) in enumerate(self._schema):
            vals = [values[col_idx] for _, _, values in buf]
            col = Column.from_values(et, vals, frac)
            if col_idx in enum_dicts:
                col.dictionary = enum_dicts[col_idx]
            out_cols.append(col)
        return BatchExecuteResult(Chunk.full(out_cols), True)


def _as_py(c: Column, row: int):
    v = c.data[row]
    if c.eval_type in (EvalType.BYTES, EvalType.JSON):
        if c.dictionary is not None:
            return bytes(c.dictionary[v])
        return bytes(v)
    if c.eval_type == EvalType.REAL:
        return float(v)
    return int(v)


def _sort_key(keys, row: int) -> tuple:
    parts = []
    for data, nulls, desc in keys:
        null = bool(nulls[row])
        v = None if null else (bytes(data[row]) if data.dtype == object else data[row].item())
        parts.append((null, v, desc))
    return tuple(parts)


def _row_cmp(a: tuple, b: tuple) -> int:
    """MySQL ORDER BY: NULLs first ascending, last descending."""
    for (n1, v1, desc), (n2, v2, _) in zip(a, b):
        if n1 or n2:
            if n1 == n2:
                continue
            r = -1 if n1 else 1
        elif v1 == v2:
            continue
        else:
            r = -1 if v1 < v2 else 1
        return -r if desc else r
    return 0
