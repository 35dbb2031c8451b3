"""DAG request model + datum response encoding.

The port's subset of ``tikv_tpu/copr/dag.py``: the executor descriptors
(tipb::Executor equivalents), ``DagRequest``, ``SelectResponse`` with its
deterministic wire framing, and the datum-row ``ResponseEncoder``.  The
response bytes are the byte-identity contract surface: the port, the JAX
evaluator and the CPU executor pipeline must emit the same ``encode()``.

``IndexScan`` is described so that the evaluator can name why it declines
it.  ``Projection`` and ``Join`` describe the join rung's plans
(``copr/torch_join.py``), and :func:`_attach` maps the descriptors above a
join onto the host executors that finish it.  The rest of the CPU executor
chain and the TypeChunk encoding are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..util import codec
from . import datum as datum_mod
from .aggr import AggDescriptor
from .datatypes import Chunk, ColumnInfo
from .executors import (
    BatchExecutor,
    BatchLimitExecutor,
    BatchProjectionExecutor,
    BatchSelectionExecutor,
    BatchTopNExecutor,
    compile_host_expr,
)
from .fused_agg import Unsupported
from .rpn import Expr

# ---------------------------------------------------------------------------
# Executor descriptors (tipb::Executor equivalents)
# ---------------------------------------------------------------------------

@dataclass
class TableScan:
    table_id: int
    columns_info: list[ColumnInfo]


@dataclass
class IndexScan:
    table_id: int
    index_id: int
    columns_info: list[ColumnInfo]


@dataclass
class Selection:
    conditions: list[Expr]


@dataclass
class Aggregation:
    group_by: list[Expr]
    agg_funcs: list[AggDescriptor]
    streamed: bool = False


@dataclass
class TopN:
    order_by: list[tuple[Expr, bool]]  # (expr, desc)
    limit: int


@dataclass
class Limit:
    limit: int


@dataclass
class Projection:
    """Expression list over the child schema (tipb::Projection equivalent):
    the output columns are the expressions in order."""

    exprs: list[Expr]


@dataclass
class Join:
    """Equi-join against a second executor chain (tipb::Join equivalent).

    The chain below this descriptor is the PROBE side; ``build`` is the build
    side's own chain (a TableScan leaf plus optional Selections) over
    ``build_ranges``.  The output schema is the probe schema followed by the
    build schema.  ``left_key``/``right_key`` are column offsets into the
    probe/build schemas; ``join_type`` is ``"inner"`` or ``"left"``.
    ``build_context`` optionally carries the build region's identity
    (region_id/region_epoch/apply_index)."""

    build: list
    build_ranges: list[tuple[bytes, bytes]]
    left_key: int
    right_key: int
    join_type: str = "inner"
    build_context: dict | None = None


ExecutorDescriptor = (TableScan | IndexScan | Selection | Aggregation | TopN | Limit
                      | Projection | Join)

#: response encoding (tipb EncodeType) of datum rows, the only one ported
ENC_TYPE_DATUM = 0


@dataclass
class DagRequest:
    """The pushed-down plan (tipb::DagRequest equivalent)."""

    executors: list[ExecutorDescriptor]
    output_offsets: list[int] | None = None  # None = all columns
    chunk_rows: int = 1024
    encode_type: int = ENC_TYPE_DATUM


class SelectResponse:
    """The coprocessor DAG answer: datum-encoded row chunks."""

    def __init__(self, chunks: list[bytes], warnings: list[str] | None = None):
        self.chunks = chunks
        self.warnings: list[str] = warnings or []

    def encode(self) -> bytes:
        """Deterministic wire encoding — the byte-identity contract surface."""
        out = bytearray(codec.encode_var_u64(len(self.chunks)))
        for c in self.chunks:
            out += codec.encode_var_u64(len(c))
            out += c
        out += codec.encode_var_u64(len(self.warnings))
        for w in self.warnings:
            wb = w.encode()
            out += codec.encode_var_u64(len(wb))
            out += wb
        return bytes(out)

    def iter_rows(self) -> list[list]:
        """Decode all chunks back into python rows (decimals as
        ``(scaled, frac)``)."""
        rows = []
        for chunk in self.chunks:
            off = 0
            while off < len(chunk):
                ncols, off = codec.decode_var_u64(chunk, off)
                row = []
                for _ in range(ncols):
                    d, off = datum_mod.decode_datum(chunk, off)
                    row.append(d.value)
                rows.append(row)
        return rows


class ResponseEncoder:
    """Row-exact chunk framer: a new chunk starts every ``chunk_rows`` rows,
    independent of producer batch boundaries — so every path emits
    byte-identical framing for identical row streams."""

    def __init__(self, chunk_rows: int):
        self.chunk_rows = chunk_rows
        self.chunks: list[bytes] = []
        self._cur = bytearray()
        self._rows = 0

    def add_chunk(self, chunk: Chunk, output_offsets: list[int] | None) -> int:
        cols = (
            chunk.columns
            if output_offsets is None
            else [chunk.columns[i] for i in output_offsets]
        )
        n = 0
        for row in chunk.logical_rows:
            self._cur += codec.encode_var_u64(len(cols))
            for c in cols:
                flag, value = c.datum_at(int(row))
                datum_mod.encode_datum(self._cur, flag, value)
            n += 1
            self._rows += 1
            if self._rows == self.chunk_rows:
                self.chunks.append(bytes(self._cur))
                self._cur = bytearray()
                self._rows = 0
        return n

    def to_response(self) -> SelectResponse:
        if self._rows:
            self.chunks.append(bytes(self._cur))
            self._cur = bytearray()
            self._rows = 0
        return SelectResponse(self.chunks)


def _attach(ex: BatchExecutor, desc) -> BatchExecutor:
    """Chain one descriptor above a join onto ``ex``: the host executors the
    join rung finishes with.  The CPU aggregation executors are not ported,
    so an Aggregation declines ``join_downstream_aggregation``."""
    if isinstance(desc, Selection):
        return BatchSelectionExecutor(ex, desc.conditions)
    if isinstance(desc, Projection):
        return BatchProjectionExecutor(ex, desc.exprs)
    if isinstance(desc, TopN):
        keys = [(compile_host_expr(e, ex.schema()), d) for e, d in desc.order_by]
        return BatchTopNExecutor(ex, keys, desc.limit)
    if isinstance(desc, Limit):
        return BatchLimitExecutor(ex, desc.limit)
    if isinstance(desc, Aggregation):
        raise Unsupported("an aggregation above a join is not ported",
                          "join_downstream_aggregation")
    raise Unsupported(f"executor {type(desc).__name__} above a join", "executor_shape")


def make_response_encoder(dag: DagRequest) -> ResponseEncoder:
    """The encoder for ``dag``: datum rows (the evaluator declines
    TypeChunk requests before this point)."""
    if dag.encode_type != ENC_TYPE_DATUM:
        raise ValueError(f"encode_type {dag.encode_type} is not ported")
    return ResponseEncoder(dag.chunk_rows)
