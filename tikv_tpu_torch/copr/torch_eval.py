"""PyTorch/CUDA DAG evaluator — the port of ``tikv_tpu/copr/jax_eval.py``.

This slice serves simple aggregations (``TableScan → Selection? →
Aggregation`` with no GROUP BY, e.g. TPC-H Q6) on one device:

    cold: scan → RowBatchDecoder (one block ahead, on a worker thread)
          → pinned host stage → one fused_agg launch per block, carry on
          the device → one packed pull → finalize
    warm: the cache's stacked [n_blocks, block_rows] image, pinned once
          → one fused_agg launch → one packed pull → finalize

``fused_agg`` (``copr/fused_agg.py``) evaluates the selection and every
aggregate argument per row and accumulates count/sum/min/max in one kernel
pass.  Finalize fills ``AggState`` from the packed carry and encodes the
datum response exactly as the JAX evaluator and the CPU pipeline do, so the
response bytes are identical.  All integer and decimal arithmetic is exact
(int64 lanes); REAL sums differ from the CPU in last-ulp rounding only.

Plans outside the slice are declined with a named cause
(:func:`decline_cause`), never run.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .aggr import PORTED_AGG_OPS, AggState
from .dag import (
    ENC_TYPE_DATUM,
    Aggregation,
    DagRequest,
    IndexScan,
    Limit,
    SelectResponse,
    Selection,
    TableScan,
    TopN,
    make_response_encoder,
)
from .dag_wire import dag_from_wire
from .datatypes import NOT_NULL_FLAG, Chunk, EvalType
from .executors import ScanSource
from .fused_agg import Image, Program, Unsupported, compile_program, fused_agg
from .kernels import KERNELS
from .rpn import FuncCall, RpnExpression, compile_expr
from .table import RowBatchDecoder, decode_record_handles

DEFAULT_BLOCK_ROWS = 1 << 16
_DEVICE_EVAL_TYPES = {EvalType.INT, EvalType.REAL, EvalType.DECIMAL, EvalType.DATETIME,
                      EvalType.DURATION}


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------

def supports(dag: DagRequest) -> bool:
    """True if this DAG runs on the port's device path."""
    return decline_cause(dag) is None


def decline_cause(dag: DagRequest) -> str | None:
    """None when the DAG is eligible, else a bounded-cardinality cause slug."""
    try:
        _analyze(dag)
        return None
    except Unsupported as exc:
        return exc.cause
    except ValueError:
        return "expr_compile"


@dataclass
class _Plan:
    scan: TableScan
    selection: Selection | None
    agg: Aggregation
    schema: list
    sel_rpns: list[RpnExpression]
    agg_rpns: list  # (op, RpnExpression | None)
    device_cols: list[int]
    nullable_cols: list[int]
    program: Program


def _ops_in(expr) -> set[str]:
    if isinstance(expr, FuncCall):
        out = {expr.op}
        for c in expr.children:
            out |= _ops_in(c)
        return out
    return set()


def _analyze(dag: DagRequest) -> _Plan:
    execs = list(dag.executors)
    if not execs or not isinstance(execs[0], (TableScan, IndexScan)):
        raise Unsupported("leaf must be a scan", "leaf_not_scan")
    scan = execs[0]
    if isinstance(scan, IndexScan):
        raise Unsupported("index scans are not ported", "index_scan_not_ported")
    if dag.encode_type != ENC_TYPE_DATUM:
        raise Unsupported("TypeChunk responses are not ported", "chunk_encoding_not_ported")
    selection = agg = None
    tail = []
    for e in execs[1:]:
        if isinstance(e, Selection) and agg is None and selection is None and not tail:
            selection = e
        elif isinstance(e, Aggregation) and agg is None and not tail:
            agg = e
        elif isinstance(e, (TopN, Limit)) and not tail:
            tail.append(e)
        else:
            raise Unsupported(f"executor {type(e).__name__} not device-routable here",
                              "executor_shape")
    if agg is None:
        raise Unsupported("raw TopN and scan/filter plans are not ported",
                          "plan_shape_not_ported")
    if tail:
        raise Unsupported("post-aggregation TopN/Limit is not ported", "post_agg_not_ported")
    if agg.group_by:
        raise Unsupported("GROUP BY is not ported", "group_by_not_ported")
    schema = [(c.ftype.eval_type, c.ftype.decimal) for c in scan.columns_info]
    for et, _ in schema:
        if et not in _DEVICE_EVAL_TYPES and et not in (EvalType.BYTES, EvalType.JSON):
            raise Unsupported(f"column type {et}", "column_type")
    for a in agg.agg_funcs:
        if a.op not in PORTED_AGG_OPS:
            raise Unsupported(f"aggregate {a.op}", "agg_op_not_ported")
    exprs = list(selection.conditions) if selection else []
    exprs += [a.expr for a in agg.agg_funcs if a.expr is not None]
    for e in exprs:
        missing = _ops_in(e) - set(KERNELS)
        if missing:
            raise Unsupported(f"scalar functions {sorted(missing)}", "op_not_ported")
    sel_rpns = [compile_expr(c, schema) for c in (selection.conditions if selection else [])]
    agg_rpns = [(a.op, compile_expr(a.expr, schema) if a.expr is not None else None)
                for a in agg.agg_funcs]
    for rpn in sel_rpns + [r for _, r in agg_rpns if r is not None]:
        if any(n.eval_type in (EvalType.BYTES, EvalType.JSON) for n in rpn.nodes):
            raise Unsupported("bytes in device expression", "bytes_predicate")
    need: set[int] = set()
    for rpn in sel_rpns + [r for _, r in agg_rpns if r is not None]:
        need |= rpn.referenced_columns()
    device_cols = sorted(need)
    # columns declared NOT NULL never ship a null mask
    nullable_cols = [i for i in device_cols
                     if not (scan.columns_info[i].ftype.flag & NOT_NULL_FLAG)]
    program = compile_program(sel_rpns, agg_rpns, device_cols, schema)
    return _Plan(scan, selection, agg, schema, sel_rpns, agg_rpns, device_cols,
                 nullable_cols, program)


# ---------------------------------------------------------------------------
# Host decode, one block ahead
# ---------------------------------------------------------------------------

_PREFETCH_END = object()


def _prefetch(it, depth: int = 1):
    """Run ``it`` on a worker thread, buffering ``depth`` items ahead: the
    producer (host decode — numpy-heavy, releases the GIL) overlaps the
    consumer (device dispatch).  Exceptions re-raise at the consumption
    point; an abandoned consumer unblocks the producer via queue timeout."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = threading.Event()

    def put_or_abandon(entry) -> bool:
        while not done.is_set():
            try:
                q.put(entry, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not put_or_abandon(("item", item)):
                    return
            put_or_abandon((None, _PREFETCH_END))
        except BaseException as exc:  # noqa: BLE001 — re-raised on consume
            put_or_abandon(("exc", exc))

    t = threading.Thread(target=produce, daemon=True, name="decode-prefetch")
    t.start()
    try:
        while True:
            kind, payload = q.get()
            if payload is _PREFETCH_END:
                return
            if kind == "exc":
                raise payload
            yield payload
    finally:
        done.set()


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class TorchDagEvaluator:
    """Run an eligible DAG over a scan source or a filled block cache.

    ``dag`` is a :class:`DagRequest` or its wire dict.  ``device`` is where
    the image lives and the kernels run: ``"cuda"`` (the default) raises
    ``RuntimeError`` when no CUDA device is present — there is no CPU
    fallback — and ``"cpu"`` runs the kernels' plain versions."""

    def __init__(self, dag, block_rows: int = DEFAULT_BLOCK_ROWS, device="cuda"):
        if isinstance(dag, dict):
            dag = dag_from_wire(dag)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TorchDagEvaluator: no CUDA device is available")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.dag = dag
        self.plan = _analyze(dag)
        self.program = self.plan.program
        self.block_rows = block_rows
        self.decoder = RowBatchDecoder(self.plan.scan.columns_info)

    # -- entry point --------------------------------------------------------

    def run(self, source: ScanSource | None, cache=None) -> SelectResponse:
        """Serve the request: warm from a filled ``cache``, else cold from
        ``source`` (filling ``cache`` when one is given)."""
        if cache is not None and cache.filled and cache.blocks:
            return self._run_aggregated_cached(cache)
        if source is None:
            raise ValueError("no scan source and no filled block cache")
        return self._run_aggregated(source, cache)

    # -- cold ---------------------------------------------------------------

    def _run_aggregated(self, source: ScanSource, cache=None) -> SelectResponse:
        """One launch per block with the carry on the device; no
        device→host traffic until finalize."""
        carry = None
        for cols, n_valid in _prefetch(self._decode_blocks(source)):
            if cache is not None:
                cache.add(cols, n_valid)
            carry = fused_agg(self.program, self._block_image(cols, n_valid), carry)
        if cache is not None:
            cache.filled = True
        if carry is None:
            carry = fused_agg(self.program, self._empty_image())
        return self._finalize_agg(carry)

    def _decode_blocks(self, source: ScanSource):
        """Yield (columns, n_valid) blocks of at most block_rows rows."""
        br = self.block_rows
        pend_handles: list[np.ndarray] = []
        pend_values: list[bytes] = []
        drained = False
        while not drained:
            keys, values, drained = source.next_batch(br)
            if keys:
                pend_handles.append(decode_record_handles(keys))
                pend_values.extend(values)
            total = sum(len(x) for x in pend_handles)
            while total >= br or (drained and total > 0):
                handles = np.concatenate(pend_handles) if len(pend_handles) > 1 else pend_handles[0]
                take = min(br, total)
                block_h, rest_h = handles[:take], handles[take:]
                block_v, rest_v = pend_values[:take], pend_values[take:]
                pend_handles = [rest_h] if len(rest_h) else []
                pend_values = rest_v
                total = len(rest_h)
                yield self.decoder.decode(block_h, block_v), take

    def _block_image(self, cols, n_valid: int) -> Image:
        """One decoded block staged as a single [n_cols, block_rows] int64
        buffer (f64 lanes as their bits) plus one bool null buffer, pinned on
        the host and copied without a host sync."""
        plan, br = self.plan, self.block_rows
        pin = self.device.type == "cuda"
        data = torch.zeros((len(plan.device_cols), br), dtype=torch.int64, pin_memory=pin)
        nulls = torch.ones((len(plan.nullable_cols), br), dtype=torch.bool, pin_memory=pin)
        dv, nv = data.numpy(), nulls.numpy()
        for j, i in enumerate(plan.device_cols):
            d = np.asarray(cols[i].data)
            dv[j, : len(d)] = d.view(np.int64) if d.dtype == np.float64 else d
        for j, i in enumerate(plan.nullable_cols):
            m = np.asarray(cols[i].nulls)
            nv[j, : len(m)] = m
        if pin:
            data = data.to(self.device, non_blocking=True)
            nulls = nulls.to(self.device, non_blocking=True)
        col_t = [data[j : j + 1].view(torch.float64) if plan.schema[i][0] == EvalType.REAL
                 else data[j : j + 1] for j, i in enumerate(plan.device_cols)]
        null_of = {i: nulls[j : j + 1] for j, i in enumerate(plan.nullable_cols)}
        null_t = [null_of.get(i) for i in plan.device_cols]
        return Image(col_t, null_t, int(n_valid), 1, br, self.device)

    def _empty_image(self) -> Image:
        """A zero-block image: the kernel writes the identity state."""
        plan = self.plan
        cols = [torch.zeros((0, self.block_rows), device=self.device,
                            dtype=torch.float64 if plan.schema[i][0] == EvalType.REAL
                            else torch.int64) for i in plan.device_cols]
        nulls = [None] * len(cols)
        return Image(cols, nulls, 0, 0, self.block_rows, self.device)

    # -- warm ---------------------------------------------------------------

    def _run_aggregated_cached(self, cache) -> SelectResponse:
        """Every block resident on the device: one launch, one pull."""
        return self._finalize_agg(fused_agg(self.program, self._stacked_device(cache)))

    def _stacked_device(self, cache) -> Image:
        """The [n_blocks, block_rows] image of the shipped columns, pinned in
        the cache on first use so later queries move no bytes."""
        plan, br = self.plan, self.block_rows
        blocks = cache.blocks
        sig = ("stacked", tuple(plan.device_cols), tuple(plan.nullable_cols), br,
               str(self.device))

        def build(_blk):
            nb = len(blocks)
            data = []
            for i in plan.device_cols:
                is_f = plan.schema[i][0] == EvalType.REAL
                host = np.zeros((nb, br), dtype=np.float64 if is_f else np.int64)
                for bi, b in enumerate(blocks):
                    d = np.asarray(b.cols[i].data)
                    host[bi, : len(d)] = d
                data.append(torch.from_numpy(host).to(self.device))
            nulls = {}
            for i in plan.nullable_cols:
                host = np.ones((nb, br), dtype=bool)
                for bi, b in enumerate(blocks):
                    m = np.asarray(b.cols[i].nulls)
                    host[bi, : len(m)] = m
                nulls[i] = torch.from_numpy(host).to(self.device)
            nv = torch.tensor([b.n_valid for b in blocks], dtype=torch.int64).to(self.device)
            return data, [nulls.get(i) for i in plan.device_cols], nv

        data, nulls, nv = cache.device_arrays(blocks[0], sig, build)
        return Image(list(data), list(nulls), nv, len(blocks), br, self.device)

    # -- finalize -----------------------------------------------------------

    def _finalize_agg(self, packed) -> SelectResponse:
        """Pull the packed state once and encode the response through
        ``AggState.result_columns``, as the CPU path does."""
        ints = packed[0].cpu().numpy()
        flts = packed[1].cpu().numpy() if self.program.n_f64 else None
        out_cols = []
        for (op, rpn), leaf in zip(self.plan.agg_rpns, self.program.aggs):
            input_type = rpn.eval_type if rpn is not None else EvalType.INT
            st = AggState(op, input_type, rpn.frac if rpn is not None else 0)
            st.grow(1)
            st.count = ints[leaf.cnt_slot, :1].astype(np.int64)
            if op != "count":
                value = (flts if leaf.is_f64 else ints)[leaf.val_slot, :1]
                if op in ("sum", "avg"):
                    st.sum = value.astype(st.sum.dtype)
                else:
                    st.value = value
                    st.has_value = st.count > 0
            out_cols += [c.take(np.array([0])) for c in st.result_columns(1)]
        enc = make_response_encoder(self.dag)
        enc.add_chunk(Chunk.full(out_cols), self.dag.output_offsets)
        return enc.to_response()
