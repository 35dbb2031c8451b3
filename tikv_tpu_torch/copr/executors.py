"""Scan sources, and the host executors the device path finishes with.

The port's subset of ``tikv_tpu/copr/executors.py``: the ``ScanSource``
interface the evaluator's cold path pulls raw ``(key, value)`` pairs from,
the in-memory ``FixtureScanSource``, the two helpers that host group-id
assignment shares with the CPU hash aggregation (``cols_for_eval``,
``_coded_group_parts``), ``BatchTopNExecutor`` with its comparator, which
orders the small aggregated chunk of a TopN after an aggregation on the host
(as the JAX package does, ``jax_eval._post_agg``), and the executors that
finish a join on the host (``copr/torch_join.py``): ``ChunkFeedExecutor``
replays the joined chunks into ``BatchSelectionExecutor``,
``BatchProjectionExecutor``, ``BatchTopNExecutor`` and
``BatchLimitExecutor``.  Their expressions evaluate through
:func:`host_eval`, the port's scalar kernels on CPU tensors: a function the
port lacks declines ``op_not_ported``, and bytes only pass as a bare column
(``bytes_predicate``).  The aggregation executors and the rest of the CPU
chain are not ported; the JAX package's stay the oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cmp_to_key

import numpy as np
import torch

from .datatypes import Chunk, Column, EvalType
from .fused_agg import Unsupported
from .kernels import KERNELS
from .rpn import Expr, FuncCall, RpnExpression, compile_expr, eval_rpn

# the growing batch size of the executor drive loop (runner.rs:399)
BATCH_INITIAL_SIZE = 32
BATCH_MAX_SIZE = 1024
BATCH_GROW_FACTOR = 2


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
# Host expressions
# ---------------------------------------------------------------------------

def _ops_in(expr) -> set[str]:
    if isinstance(expr, FuncCall):
        out = {expr.op}
        for c in expr.children:
            out |= _ops_in(c)
        return out
    return set()


def check_ops(exprs) -> None:
    """Raise ``op_not_ported`` if an expression calls a scalar function the
    port does not have."""
    for e in exprs:
        missing = _ops_in(e) - set(KERNELS)
        if missing:
            raise Unsupported(f"scalar functions {sorted(missing)}", "op_not_ported")


def compile_host_expr(expr: Expr, schema) -> RpnExpression:
    """``expr`` compiled for :func:`host_eval`: ported functions only, and
    bytes only as a bare column (the scalar kernels take no bytes)."""
    check_ops([expr])
    rpn = compile_expr(expr, schema)
    if len(rpn.nodes) > 1 and any(n.eval_type in (EvalType.BYTES, EvalType.JSON)
                                  for n in rpn.nodes):
        raise Unsupported("bytes in a host expression", "bytes_predicate")
    return rpn


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


# ---------------------------------------------------------------------------
# The executors above a join
# ---------------------------------------------------------------------------

class ChunkFeedExecutor(BatchExecutor):
    """Leaf replaying prepared chunks: the join rung's bridge into the host
    executors for the descriptors above the Join.  ``chunks`` is read as
    the drive loop pulls, so a caller may fill the list after building the
    chain."""

    def __init__(self, schema, chunks: list[Chunk]):
        self._schema = schema
        self._chunks = chunks
        self._idx = 0

    def schema(self):
        return self._schema

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self._idx >= len(self._chunks):
            return BatchExecuteResult(Chunk.full([]), True)
        c = self._chunks[self._idx]
        self._idx += 1
        return BatchExecuteResult(c, self._idx >= len(self._chunks))


class BatchSelectionExecutor(BatchExecutor):
    """Filter by a conjunction of predicates (selection_executor.rs:18): the
    chunk's logical rows narrow, its columns stay."""

    def __init__(self, child: BatchExecutor, conditions: list[Expr]):
        self.child = child
        self._schema = child.schema()
        self.conditions = [compile_host_expr(c, self._schema) for c in conditions]

    def schema(self):
        return self._schema

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        r = self.child.next_batch(scan_rows)
        chunk = r.chunk
        if chunk.num_rows == 0:
            return r
        n = len(chunk.columns[0]) if chunk.columns else 0
        keep = np.ones(n, dtype=bool)
        for rpn in self.conditions:
            data, nulls = host_eval(rpn, chunk.columns, n)
            keep &= (data != 0) & ~nulls
        logical = chunk.logical_rows[keep[chunk.logical_rows]]
        return BatchExecuteResult(Chunk(chunk.columns, logical), r.is_drained)


class BatchProjectionExecutor(BatchExecutor):
    """Evaluate an expression list over the child rows (tipb::Projection):
    the output columns are the expressions in order, physically compacted."""

    def __init__(self, child: BatchExecutor, exprs: list[Expr]):
        self.child = child
        child_schema = child.schema()
        self.exprs = [compile_host_expr(e, child_schema) for e in exprs]
        if not self.exprs:
            raise ValueError("projection needs at least one expression")

    def schema(self):
        return [(r.eval_type, r.frac) for r in self.exprs]

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        r = self.child.next_batch(scan_rows)
        chunk = r.chunk
        if chunk.num_rows == 0:
            return BatchExecuteResult(Chunk.full([]), r.is_drained)
        n = len(chunk.columns[0]) if chunk.columns else 0
        logical = chunk.logical_rows
        out = []
        for rpn in self.exprs:
            data, nulls = host_eval(rpn, chunk.columns, n)
            out.append(Column(rpn.eval_type, data[logical], nulls[logical], rpn.frac))
        return BatchExecuteResult(Chunk.full(out), r.is_drained)


class BatchLimitExecutor(BatchExecutor):
    """Pass through the first N logical rows (limit_executor.rs:11)."""

    def __init__(self, child: BatchExecutor, limit: int):
        self.child = child
        self.remaining = limit

    def schema(self):
        return self.child.schema()

    def next_batch(self, scan_rows: int) -> BatchExecuteResult:
        if self.remaining <= 0:
            return BatchExecuteResult(Chunk.full([]), True)
        r = self.child.next_batch(scan_rows)
        chunk = r.chunk
        if chunk.num_rows >= self.remaining:
            logical = chunk.logical_rows[: self.remaining]
            self.remaining = 0
            return BatchExecuteResult(Chunk(chunk.columns, logical), True)
        self.remaining -= chunk.num_rows
        return r


# ---------------------------------------------------------------------------
# TopN
# ---------------------------------------------------------------------------

class BatchTopNExecutor(BatchExecutor):
    """Bounded order-by (top_n_executor.rs:21): accumulate, prune to the best
    ``limit`` rows whenever the buffer doubles, final sort at drain."""

    def __init__(self, child: BatchExecutor, order_by: list[tuple[RpnExpression, bool]],
                 limit: int):
        """``order_by``: (key, desc) pairs, each key compiled by
        :func:`compile_host_expr` against the child's schema."""
        self.child = child
        self._schema = child.schema()
        self.order_by = order_by
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
