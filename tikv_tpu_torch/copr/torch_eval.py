"""PyTorch/CUDA DAG evaluator — the port of ``tikv_tpu/copr/jax_eval.py``.

It serves three plan shapes over a table scan on one device, each cold from
a scan source and warm from a filled block cache:

* ``TableScan → Selection? → Aggregation → TopN?/Limit?`` (with or without
  GROUP BY, over the ten device aggregates; e.g. TPC-H Q6 and Q1): below;
  a TopN or Limit after the aggregation orders or cuts the small aggregated
  chunk on the host (``BatchTopNExecutor``), as the JAX package does;
* ``TableScan → Selection? → Limit?``: the selection mask per block
  (``copr/fused_mask.py``; none without a selection), one pull of it, host
  compaction and response encoding; with a Limit, cold blocks stop after the
  one that fills it and warm launches cover a doubling prefix of blocks;
* ``TableScan → Selection? → TopN → Limit?``: the running top-K
  (``copr/fused_topn.py``), the carry on the device across cold blocks, one
  launch chain over the warm image, one packed pull of K rows.

Aggregations run as follows:

    cold: scan → RowBatchDecoder (one block ahead, on a worker thread)
          → host group ids (GroupDict, first-occurrence order) → pinned host
          stage → one launch pair per block, carry on the device (grown
          when the groups outgrow it) → one packed pull → finalize
    warm: the cache's stacked [n_blocks, block_rows] image, pinned once
          → one launch pair → one packed pull → finalize; group ids are
          computed on the device from the resident dictionary codes when
          every key is a bare dictionary-coded column shared by all blocks
          (coded path), else assigned on the host and shipped per query

A warm image may be encoded (``copr/encoding.py``: bitpacked lanes, RLE
runs, narrowed dictionary codes): the pin then holds the encoded payloads
and every kernel decodes them in-kernel.  Before any warm launch the plan's
selection conjuncts are tested against the blocks' zone maps
(``copr/zone_maps.py``); a pruned block ships ``n_valid`` 0, so the kernels
skip its rows, and the warm scan/filter does not emit it.  A raw TopN with
no selection and a bare first key also drops the blocks that zone order
proves cannot reach the top K.  Scan/filter output is gathered through the
encodings (late materialization).

A warm aggregation first tries the zone rung (``copr/zone.py``, the JAX
package's ``jax_zone``): a layout of the image clustered by group and sorted
by a range column, whose tiles the selection's zones prove full, empty or
partial; the zone-tile kernels (``copr/fused_zone.py``) reduce the full
tiles without the selection, walk only the partial ones and fold the tiles
into the group slots.  A plan or image the rung cannot serve is declined
with a named cause (``zone_stats``) and runs the stacked kernels below, as
every warm aggregation does under ``route_hint = "unary"``.

Plans without GROUP BY whose aggregates are all count/sum/avg/min/max run
``fused_agg`` (``copr/fused_agg.py``, capacity 1); every other plan runs
``fused_group_agg`` (``copr/fused_group_agg.py``).  Both evaluate the
selection and every aggregate argument per row in one kernel pass.
Finalize keeps the groups whose first active row exists, orders them by it
(the CPU hash aggregation's insertion order), fills ``AggState`` from the
packed carry and encodes the datum response exactly as the JAX evaluator and
the CPU pipeline do, so the response bytes are identical.  All integer and
decimal arithmetic is exact (int64 lanes); REAL sums differ from the CPU in
last-ulp rounding only.

Plans outside these shapes are declined with a named cause
(:func:`decline_cause`), never run; join and projection plans decline here
(``join_executor``, ``projection_executor``) and go to the join rung,
``copr/torch_join.py``.
"""

from __future__ import annotations

import queue
import threading
import weakref
from contextlib import closing
from dataclasses import dataclass

import numpy as np
import torch

from . import encoding, fused_batch, zone, zone_maps
from .aggr import PORTED_AGG_OPS, AggState
from .dag import (
    ENC_TYPE_DATUM,
    Aggregation,
    DagRequest,
    IndexScan,
    Join,
    Limit,
    Projection,
    SelectResponse,
    Selection,
    TableScan,
    TopN,
    make_response_encoder,
)
from .dag_wire import dag_from_wire
from .datatypes import NOT_NULL_FLAG, Chunk, Column, EvalType
from .executors import (
    BatchTopNExecutor,
    ChunkExecutor,
    ScanSource,
    _coded_group_parts,
    check_ops,
    compile_host_expr,
    host_eval,
)
from .fused_agg import (
    AGG_COUNT,
    CAPACITY_ONE_OPS,
    NO_ROW,
    Image,
    Program,
    Unsupported,
    compile_program,
    fused_agg,
)
from .fused_group_agg import (
    GroupProgram,
    check_capacity,
    compile_group_program,
    fused_group_agg,
    grow_carry,
    init_packed,
)
from .fused_mask import compile_mask_program, fused_mask
from .fused_topn import TopnProgram, compile_topn_program, topn_step
from .groupby import GroupDict
from .rpn import ColumnRef, RpnExpression, compile_expr
from .table import RowBatchDecoder, decode_record_handles

DEFAULT_BLOCK_ROWS = 1 << 16
# the cold path's first group capacity, doubled as groups appear.  The JAX
# package starts at 1024; capacity is not visible in a response, and here
# every launch writes and folds [grid, leaves, C] partials, so it starts small
GROUP_CAPACITY_START = 8
_DEVICE_EVAL_TYPES = {EvalType.INT, EvalType.REAL, EvalType.DECIMAL, EvalType.DATETIME,
                      EvalType.DURATION}
TOPN_DEVICE_MAX = 2048  # raw TopN carries K rows of state (jax_eval._TOPN_DEVICE_MAX)


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------

def supports(dag: DagRequest) -> bool:
    """True if this DAG runs on the port's device path."""
    return decline_cause(dag) is None


def decline_cause(dag: DagRequest) -> str | None:
    """None when the DAG is eligible, else a bounded-cardinality cause slug.
    An eligible grouped plan is served at any group count."""
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
    agg: Aggregation | None
    topn: TopN | None
    limit: Limit | None
    schema: list
    sel_rpns: list[RpnExpression]
    agg_rpns: list  # (op, RpnExpression | None)
    group_rpns: list[RpnExpression]
    topn_rpns: list  # raw TopN: (RpnExpression, desc)
    # the columns the device program reads: the selection's and the
    # aggregates' (aggregation, scan/filter) or the selection's and the sort
    # keys' (raw TopN)
    device_cols: list[int]
    nullable_cols: list[int]
    # no GROUP BY and only count/sum/avg/min/max: fused_agg at capacity 1
    program: Program | None = None
    # otherwise fused_group_agg over device_cols: host group ids with GROUP
    # BY, the single slot without
    group_program: GroupProgram | None = None
    # scan/filter with a selection: the mask's conjuncts
    mask_program: Program | None = None
    # raw TopN: the top-K program; every schema column is payload
    topn_program: TopnProgram | None = None
    # aggregation: [(eval_type, frac)] of the aggregated chunk's columns
    agg_schema: list | None = None
    # aggregation with a TopN: its (compiled key, desc) over agg_schema
    post_order: list | None = None

    @property
    def k(self) -> int:
        """Rows a raw TopN keeps: min(TopN limit, Limit)."""
        k = self.topn.limit
        return k if self.limit is None else min(k, self.limit.limit)


def _streamed_in_scan_order(scan: TableScan, agg: Aggregation) -> bool:
    """Stream aggregation emits one row per consecutive run of the key; that
    equals the hash aggregation the device computes only when the scan order
    sorts by the key: grouping on the handle column (jax_eval._analyze)."""
    cols = scan.columns_info
    return len(agg.group_by) <= 1 and all(
        isinstance(g, ColumnRef) and g.index < len(cols) and cols[g.index].is_pk_handle
        for g in agg.group_by)


def _check_no_bytes(rpns) -> None:
    for rpn in rpns:
        if any(n.eval_type in (EvalType.BYTES, EvalType.JSON) for n in rpn.nodes):
            raise Unsupported("bytes in device expression", "bytes_predicate")


def _split(execs) -> tuple:
    """(selection, aggregation, TopN, Limit) of the executors after the
    scan, in ``jax_eval._analyze``'s order: Selection, then Aggregation, then
    TopN, then Limit, each at most once and each optional."""
    selection = agg = topn = limit = None
    for e in execs:
        tail_seen = topn is not None or limit is not None
        if isinstance(e, Selection) and selection is None and agg is None and not tail_seen:
            selection = e
        elif isinstance(e, Aggregation) and agg is None and not tail_seen:
            agg = e
        elif isinstance(e, TopN) and not tail_seen:
            topn = e
        elif isinstance(e, Limit) and limit is None:
            limit = e
        elif isinstance(e, Join):
            raise Unsupported("join executors serve via the join rung (copr/torch_join.py)",
                              "join_executor")
        elif isinstance(e, Projection):
            raise Unsupported("projection executors serve via the join rung",
                              "projection_executor")
        else:
            raise Unsupported(f"executor {type(e).__name__} not device-routable here",
                              "executor_shape")
    return selection, agg, topn, limit


def _analyze(dag: DagRequest) -> _Plan:
    execs = list(dag.executors)
    if not execs or not isinstance(execs[0], (TableScan, IndexScan)):
        raise Unsupported("leaf must be a scan", "leaf_not_scan")
    scan = execs[0]
    if isinstance(scan, IndexScan):
        raise Unsupported("index scans are not ported", "index_scan_not_ported")
    if dag.encode_type != ENC_TYPE_DATUM:
        raise Unsupported("TypeChunk responses are not ported", "chunk_encoding_not_ported")
    selection, agg, topn, limit = _split(execs[1:])
    schema = [(c.ftype.eval_type, c.ftype.decimal) for c in scan.columns_info]
    for et, _ in schema:
        if et not in _DEVICE_EVAL_TYPES and et not in (EvalType.BYTES, EvalType.JSON):
            raise Unsupported(f"column type {et}", "column_type")
    conds = list(selection.conditions) if selection else []
    if agg is None:
        return _analyze_scan(scan, selection, topn, limit, schema, conds)
    if agg.streamed and not _streamed_in_scan_order(scan, agg):
        raise Unsupported("streamed agg not sorted by group key", "streamed_agg_order")
    for a in agg.agg_funcs:
        if a.op not in PORTED_AGG_OPS:
            raise Unsupported(f"aggregate {a.op}", "agg_op_not_ported")
    check_ops(conds + [a.expr for a in agg.agg_funcs if a.expr is not None]
              + list(agg.group_by))
    sel_rpns = [compile_expr(c, schema) for c in conds]
    agg_rpns = [(a.op, compile_expr(a.expr, schema) if a.expr is not None else None)
                for a in agg.agg_funcs]
    group_rpns = [compile_expr(g, schema) for g in agg.group_by]
    _check_no_bytes(sel_rpns + [r for _, r in agg_rpns if r is not None])
    for g in group_rpns:
        # group keys are evaluated on the host with the port's torch scalar
        # kernels, which take no bytes: a bytes key must be a bare column
        if len(g.nodes) > 1 and any(n.eval_type in (EvalType.BYTES, EvalType.JSON)
                                    for n in g.nodes):
            raise Unsupported("bytes in a group-by expression", "group_expr_not_ported")
    agg_schema = _agg_output_schema(agg_rpns, group_rpns)
    # the TopN after the aggregation orders the aggregated chunk on the host
    # (BatchTopNExecutor): its keys evaluate like group keys
    post_order = ([(compile_host_expr(e, agg_schema), d) for e, d in topn.order_by]
                  if topn else [])
    need: set[int] = set()
    for rpn in sel_rpns + [r for _, r in agg_rpns if r is not None]:
        need |= rpn.referenced_columns()
    device_cols = sorted(need)
    # columns declared NOT NULL never ship a null mask
    nullable_cols = _nullable(scan, device_cols)
    plan = _Plan(scan, selection, agg, topn, limit, schema, sel_rpns, agg_rpns, group_rpns, [],
                 device_cols, nullable_cols, agg_schema=agg_schema, post_order=post_order)
    if not group_rpns and all(op in CAPACITY_ONE_OPS for op, _ in agg_rpns):
        plan.program = compile_program(sel_rpns, agg_rpns, device_cols, schema)
    else:
        plan.group_program = compile_group_program(
            sel_rpns, agg_rpns, device_cols, schema, None if group_rpns else (),
            track=bool(group_rpns))
    return plan


def _analyze_scan(scan, selection, topn, limit, schema, conds) -> _Plan:
    """Scan/filter and raw TopN plans (no aggregation)."""
    keys = list(topn.order_by) if topn else []
    check_ops(conds + [e for e, _ in keys])
    sel_rpns = [compile_expr(c, schema) for c in conds]
    _check_no_bytes(sel_rpns)
    topn_rpns = []
    if topn is not None:
        # raw TopN runs a device top-K merge: every schema column ships as
        # payload — numeric columns as values, BYTES as dictionary codes
        # (decoded back to bytes at finalize; a non-dict or unstable
        # dictionary raises at run time)
        if topn.limit > TOPN_DEVICE_MAX:
            raise Unsupported(f"TopN limit {topn.limit} too large for device",
                              "topn_limit_too_large")
        for et, _ in schema:
            if et not in _DEVICE_EVAL_TYPES and et != EvalType.BYTES:
                raise Unsupported(f"TopN payload column type {et}", "topn_payload_type")
        for e, desc in keys:
            rpn = compile_expr(e, schema)
            _check_no_bytes([rpn])
            if rpn.eval_type not in _DEVICE_EVAL_TYPES:
                raise Unsupported(f"TopN key type {rpn.eval_type}", "topn_key_type")
            topn_rpns.append((rpn, bool(desc)))
    need: set[int] = set()
    for rpn in sel_rpns + [r for r, _ in topn_rpns]:
        need |= rpn.referenced_columns()
    device_cols = sorted(need)
    plan = _Plan(scan, selection, None, topn, limit, schema, sel_rpns, [], [], topn_rpns,
                 device_cols, _nullable(scan, device_cols))
    if topn is not None:
        if plan.k > 0:
            plan.topn_program = compile_topn_program(
                sel_rpns, topn_rpns, device_cols, schema, list(range(len(schema))), plan.k)
    elif sel_rpns:
        plan.mask_program = compile_mask_program(sel_rpns, device_cols, schema)
    return plan


def _agg_output_schema(agg_rpns, group_rpns) -> list:
    """[(eval_type, frac)] of the aggregated chunk: each aggregate's result
    columns (``AggState.result_columns``), then the group keys
    (``jax_eval._agg_output_schema``)."""
    out = []
    for op, rpn in agg_rpns:
        it, frac = (rpn.eval_type, rpn.frac) if rpn is not None else (EvalType.INT, 0)
        if op == "count":
            out.append((EvalType.INT, 0))
        elif op == "avg":
            out += [(EvalType.INT, 0), (it, frac)]
        elif op == "var_pop":
            out += [(EvalType.INT, 0), (EvalType.REAL, 0), (EvalType.REAL, 0)]
        elif op in ("bit_and", "bit_or", "bit_xor"):
            out.append((EvalType.INT, 0))
        else:
            out.append((it, frac))
    for g in group_rpns:
        out.append((g.eval_type, g.frac))
    return out


def _nullable(scan: TableScan, cols) -> list[int]:
    return [i for i in cols if not (scan.columns_info[i].ftype.flag & NOT_NULL_FLAG)]


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
    fallback — and ``"cpu"`` runs the kernels' plain versions.
    ``route_hint = "unary"`` skips the zone rung for warm aggregations;
    ``zone_stats`` (:class:`copr.zone.ZoneStats`) says what the rung did."""

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
        self._coded_programs: dict[tuple, GroupProgram | None] = {}
        self._batch_programs: dict[tuple, GroupProgram] = {}
        # (blocks examined, blocks pruned) by the zone maps in the last warm run
        # of the stacked kernels
        self.prune_stats = (0, 0)
        self._prune_memo = None  # (cache weakref, key, keep, prune_stats)
        # "unary" skips the zone rung (jax_eval.route_hint): warm
        # aggregations then run the stacked kernels
        self.route_hint: str | None = None
        self.zone_stats = zone.ZoneStats()
        self._zone: zone.ZoneRung | None = None

    # -- entry point --------------------------------------------------------

    def run(self, source: ScanSource | None, cache=None) -> SelectResponse:
        """Serve the request: warm from a filled ``cache``, else cold from
        ``source`` (filling ``cache`` when one is given).  A filled cache
        with no blocks is a region with no rows: the cold path runs over
        it, reading no source, and answers the identity aggregate or the
        empty response (``jax_eval._blocks``)."""
        filled = cache is not None and cache.filled
        warm = filled and bool(cache.blocks)
        if not filled and source is None:
            raise ValueError("no scan source and no filled block cache")
        if self.plan.agg is not None:
            return self._run_aggregated_cached(cache) if warm \
                else self._run_aggregated(source, cache)
        if self.plan.topn is not None:
            return self._run_topn(source, cache, warm)
        return self._run_scan_filter(source, cache, warm)

    # -- cold ---------------------------------------------------------------

    def _run_aggregated(self, source: ScanSource, cache=None) -> SelectResponse:
        """One launch pair per block with the carry on the device; no
        device→host traffic until finalize.

        Group ids are assigned on the host over ALL valid rows (pre-selection):
        groups whose every row the device filters out keep no first active row
        and are dropped at finalize, and the survivors are ordered by their
        first active row — the CPU path's order, without pulling the mask."""
        plan = self.plan
        prog = plan.group_program
        groups = GroupDict()
        capacity = GROUP_CAPACITY_START if plan.group_rpns else 1
        carry = None
        offset = 0
        with closing(self._cold_blocks(source, cache)) as blocks:
            for cols, n_valid in blocks:
                if prog is None:
                    carry = fused_agg(self.program, self._block_image(cols, n_valid), carry)
                    continue
                gids = None
                if plan.group_rpns:
                    gids, n_groups = self._assign_gids(cols, n_valid, groups)
                    if n_groups > capacity:
                        # grow to the next size and migrate the carry
                        capacity = _capacity_for(prog, capacity, n_groups)
                        if carry is not None:
                            carry = grow_carry(prog, carry, capacity)
                img = self._block_image(cols, n_valid, gids, offset)
                carry = fused_group_agg(prog, img, capacity, carry)
                offset += n_valid
        if prog is None:
            if carry is None:
                carry = fused_agg(self.program, self._empty_image())
            return self._finalize_agg(carry, self.program, 1, None)
        if carry is None:
            carry = init_packed(prog, capacity, self.device)
        n_slots = len(groups) if plan.group_rpns else 1
        return self._finalize_agg(carry, prog, n_slots, lambda r: groups.rows[r])

    def _cold_blocks(self, source: ScanSource, cache=None):
        """Decoded ``(columns, n_valid)`` blocks of ``source``, decoded one
        ahead on a worker thread.  With a ``cache``, the blocks are kept
        aside and added to it, and the cache marked filled, only once the
        source is drained (``jax_eval._blocks`` fills before it yields): a
        consumer that raises mid-scan, or closes the generator early, leaves
        the cache as it was.  Closing the generator stops the worker too.
        A filled cache (with no blocks: a filled one with blocks is served
        warm) yields nothing."""
        if cache is not None and cache.filled:
            return
        blocks = _prefetch(self._decode_blocks(source))
        fill = [] if cache is not None else None
        try:
            for cols, n_valid in blocks:
                if fill is not None:
                    fill.append((cols, n_valid))
                yield cols, n_valid
            if fill is not None:
                for cols, n_valid in fill:
                    cache.add(cols, n_valid)
                cache.filled = True
        finally:
            blocks.close()

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

    def _assign_gids(self, cols, n_valid: int, groups: GroupDict):
        """Host group ids of a block's valid rows (int32 ``[block_rows]``,
        0 past ``n_valid``) and the number of groups so far."""
        rows = np.arange(n_valid)
        gids = np.zeros(self.block_rows, dtype=np.int32)
        # bare dict-encoded group columns: dense-code path, no unique pass
        coded = _coded_group_parts(self.plan.group_rpns, cols, rows)
        if coded is not None:
            if len(coded) == 1:
                gids[:n_valid] = groups.assign_coded(*coded[0])
            else:
                gids[:n_valid] = groups.assign_coded_multi(coded)
            return gids, len(groups)
        parts = [self._group_key(g, cols, n_valid) for g in self.plan.group_rpns]
        gids[:n_valid] = groups.assign(parts)
        return gids, len(groups)

    @staticmethod
    def _group_key(g: RpnExpression, cols, n_valid: int):
        """One group expression's ``(data, nulls)`` numpy arrays over the
        valid rows: a bare column as it is, else evaluated with the port's
        scalar kernels on CPU tensors."""
        d, nl = host_eval(g, cols, len(cols[0]) if cols else 0)
        return d[:n_valid], nl[:n_valid]

    def _block_image(self, cols, n_valid: int, gids=None, offset: int = 0,
                     ship=None) -> Image:
        """One decoded block staged as a single [n_cols, block_rows] int64
        buffer (f64 lanes as their bits; BYTES as dictionary codes), one bool
        null buffer and the host group ids, pinned on the host and copied
        without a host sync.  ``ship``: the columns (the device columns by
        default)."""
        plan, br = self.plan, self.block_rows
        ship = plan.device_cols if ship is None else ship
        nullable = _nullable(plan.scan, ship)
        pin = self.device.type == "cuda"
        data = torch.zeros((len(ship), br), dtype=torch.int64, pin_memory=pin)
        nulls = torch.ones((len(nullable), br), dtype=torch.bool, pin_memory=pin)
        dv, nv = data.numpy(), nulls.numpy()
        for j, i in enumerate(ship):
            d = np.asarray(cols[i].data)
            dv[j, : len(d)] = d.view(np.int64) if d.dtype == np.float64 else d
        for j, i in enumerate(nullable):
            m = np.asarray(cols[i].nulls)
            nv[j, : len(m)] = m
        g = None
        if gids is not None:
            g = torch.empty((1, br), dtype=torch.int32, pin_memory=pin)
            g.numpy()[0] = gids
        if pin:
            data = data.to(self.device, non_blocking=True)
            nulls = nulls.to(self.device, non_blocking=True)
            if g is not None:
                g = g.to(self.device, non_blocking=True)
        col_t = [data[j : j + 1].view(torch.float64) if plan.schema[i][0] == EvalType.REAL
                 else data[j : j + 1] for j, i in enumerate(ship)]
        null_of = {i: nulls[j : j + 1] for j, i in enumerate(nullable)}
        null_t = [null_of.get(i) for i in ship]
        return Image(col_t, null_t, int(n_valid), 1, br, self.device, int(offset), g)

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
        """The zone rung first (``copr/zone.py``), unless ``route_hint`` is
        ``"unary"`` or the rung declines; else the stacked kernels: every
        block resident on the device, one launch pair, one pull, zone-pruned
        blocks shipping no valid row."""
        if self.route_hint != "unary":
            out = self._zone_rung().try_run(cache)
            if out is not None:
                return self._finalize_agg(*out)
        keep = self._prune_keep(cache)
        if self.program is not None:
            packed = fused_agg(self.program, self._stacked_device(cache, keep=keep))
            return self._finalize_agg(packed, self.program, 1, None)
        stable = self._stable_dict_group_cols(cache.blocks)
        if stable is not None:
            resp = self._run_coded(cache, *stable, keep=keep)
            if resp is not None:
                return resp
        return self._run_host_gids(cache, keep)

    def _zone_rung(self) -> zone.ZoneRung:
        if self._zone is None:
            self._zone = zone.ZoneRung(self)
        return self._zone

    def _prune_keep(self, cache):
        """The per-block keep mask of the plan's selection conjuncts under
        the cache's zone maps (``jax_eval._prune_keep``), or None when
        pruning proves nothing; records ``prune_stats``.  The mask is kept
        for the next query over the same image: the port's zones change only
        with the blocks or their encodings (no write-through deltas yet), and
        testing every block's zones in Python takes milliseconds."""
        key = (cache.enc_version, len(cache.blocks), zone_maps.enabled())
        memo = self._prune_memo
        if memo is not None and memo[0]() is cache and memo[1] == key:
            self.prune_stats = memo[3]
            return memo[2]
        stats = zone_maps.PruneStats()
        keep = zone_maps.prune_blocks(cache, self.plan.sel_rpns, stats)
        self.prune_stats = (stats.examined, stats.pruned)
        self._prune_memo = (weakref.ref(cache), key, keep, self.prune_stats)
        return keep

    def _stable_dict_group_cols(self, blocks):
        """If every group expr is a bare ref to a dict-encoded column whose
        dictionary object is shared by ALL cached blocks, return (col_idx
        list, dict list) — else None.  No group-by at all qualifies trivially
        (a single slot, no codes needed)."""
        if not self.plan.group_rpns:
            return [], []
        idxs = []
        for g in self.plan.group_rpns:
            if len(g.nodes) != 1 or g.nodes[0].kind != "col":
                return None
            idxs.append(g.nodes[0].index)
        dicts = []
        for i in idxs:
            c0 = blocks[0].cols[i]
            if not c0.is_dict_encoded:
                return None
            for b in blocks[1:]:
                if b.cols[i].dictionary is not c0.dictionary:
                    return None
            dicts.append(c0.dictionary)
        cap = 1
        for d in dicts:
            cap *= len(d) + 1
        if cap > (1 << 20):
            return None
        return idxs, dicts

    def _coded_program(self, group_cols, dict_lens) -> GroupProgram | None:
        """The coded program for these key columns (shipped after the
        device columns), or None when the kernels cannot take it."""
        key = (tuple(group_cols), tuple(dict_lens))
        if key not in self._coded_programs:
            plan = self.plan
            ship = self._ship_cols(group_cols)
            try:
                prog = compile_group_program(
                    plan.sel_rpns, plan.agg_rpns, ship, plan.schema,
                    [ship.index(i) for i in group_cols], dict_lens, track=True)
            except Unsupported:
                prog = None  # too many columns: the host-id path serves it
            self._coded_programs[key] = prog
        return self._coded_programs[key]

    def _ship_cols(self, extra) -> list[int]:
        return self.plan.device_cols + [i for i in extra if i not in self.plan.device_cols]

    def _run_coded(self, cache, group_cols, dicts, keep=None) -> SelectResponse | None:
        """Group ids computed on the device from the resident dictionary
        codes (``jax_eval.scan_coded``): no per-row host→device traffic."""
        dict_lens = tuple(len(d) for d in dicts)
        n_slots = 1
        for dl in dict_lens:
            n_slots *= dl + 1
        if group_cols:
            prog = self._coded_program(group_cols, dict_lens)
            if prog is None:
                return None
        else:
            prog = self.plan.group_program
        capacity = _capacity_for(prog, 1, n_slots)
        img = self._stacked_device(cache, self._ship_cols(group_cols), keep=keep)
        packed = fused_group_agg(prog, img, capacity)
        return self._finalize_agg(packed, prog, n_slots, zone.key_of(dicts, dict_lens))

    def _batch_program(self, ship, schema, group_cols, dict_lens) -> GroupProgram:
        """This plan's program in a batch: compiled against the batch's
        shared ship list (``schema`` gives every shipped column's type),
        with ids from the key columns' codes (``()`` without GROUP BY) and
        the tracker only with GROUP BY.  The port's limits raise
        ``ValueError`` naming the cause (``plan_too_large``, ...)."""
        key = (tuple(ship), tuple(schema[i][0] == EvalType.REAL for i in ship),
               tuple(group_cols), tuple(dict_lens))
        prog = self._batch_programs.get(key)
        if prog is None:
            plan = self.plan
            try:
                prog = compile_group_program(
                    plan.sel_rpns, plan.agg_rpns, ship, schema,
                    [ship.index(i) for i in group_cols], dict_lens, track=bool(plan.group_rpns))
            except Unsupported as exc:
                raise ValueError(f"batched evaluation declines the plan: {exc.cause}") from exc
            self._batch_programs[key] = prog
        return prog

    def _run_host_gids(self, cache, keep=None) -> SelectResponse:
        """Host group ids for every block that zone maps keep, shipped with
        the query (``jax_eval.scan`` at capacity > 1).  The ids read
        ``Column.data``, which decodes an encoded column on the host."""
        blocks = cache.blocks
        prog = self.plan.group_program
        groups = GroupDict()
        all_gids = np.zeros((len(blocks), self.block_rows), dtype=np.int32)
        for bi, blk in enumerate(blocks):
            if keep is None or keep[bi]:
                all_gids[bi] = self._assign_gids(blk.cols, blk.n_valid, groups)[0]
        n_slots = len(groups)
        capacity = _capacity_for(prog, 1, max(n_slots, 1))
        gids = torch.from_numpy(all_gids).to(self.device)
        packed = fused_group_agg(prog, self._stacked_device(cache, gids=gids, keep=keep),
                                 capacity)
        return self._finalize_agg(packed, prog, n_slots, lambda r: groups.rows[r])

    def _stacked_device(self, cache, ship_cols=None, gids=None, keep=None, nullable=None,
                        decode: bool = False) -> Image:
        """The [n_blocks, block_rows] image of the shipped columns (the device
        columns by default), pinned in the cache on first use so later
        queries move no bytes; ``gids`` ride along unpinned, and blocks that
        ``keep`` drops get ``n_valid`` 0.  ``nullable``: the columns whose
        null masks ship (the plan's nullable shipped columns by default).
        An encoded image pins its encoded payloads (``encoding.device_plan``,
        ``stack_block_payloads``) under a signature of its descriptors and
        ``enc_version``, apart from any plain pin
        (``jax_eval._stacked_device``); ``decode`` pins the decoded lanes
        instead, dropping the host decodes once they are pinned."""
        br, dev = self.block_rows, self.device
        ship = self.plan.device_cols if ship_cols is None else list(ship_cols)
        nullable = _nullable(self.plan.scan, ship) if nullable is None else list(nullable)
        blocks = cache.blocks
        enc = None if decode else encoding.device_plan(cache, ship, nullable)
        if enc is None:
            sig = ("stacked", tuple(ship), tuple(nullable), br, str(dev))

            def build(_blk):
                nb = len(blocks)
                data = []
                for i in ship:
                    is_f = blocks[0].cols[i].eval_type == EvalType.REAL
                    host = np.zeros((nb, br), dtype=np.float64 if is_f else np.int64)
                    for bi, b in enumerate(blocks):
                        d = np.asarray(b.cols[i].data)
                        host[bi, : len(d)] = d
                    data.append(torch.from_numpy(host).to(dev))
                nulls = {}
                for i in nullable:
                    host = np.ones((nb, br), dtype=bool)
                    for bi, b in enumerate(blocks):
                        m = np.asarray(b.cols[i].nulls)
                        host[bi, : len(m)] = m
                    nulls[i] = torch.from_numpy(host).to(dev)
                if decode:
                    zone.purge_decoded(blocks)
                return data, [nulls.get(i) for i in ship]
        else:
            sig = ("stackedenc", tuple(ship), tuple(nullable), br, str(dev), enc.sig,
                   enc.null_sig, cache.enc_version)

            def build(_blk):
                data, nulls, _refs = encoding.stack_block_payloads(blocks, ship, nullable, enc,
                                                                   br)
                data = [tuple(torch.from_numpy(a).to(dev) for a in d) if isinstance(d, tuple)
                        else torch.from_numpy(d).to(dev) for d in data]
                null_of = {i: torch.from_numpy(m).to(dev) for i, m in zip(nullable, nulls)}
                return data, [null_of.get(i) for i in ship]

        data, nulls = cache.device_arrays(blocks[0], sig, build)
        nv, off = cache.nvoff_device(dev)
        if keep is not None:
            nv = torch.where(torch.from_numpy(keep).to(dev), nv, 0)
        descs = refs = None
        if enc is not None:
            descs, refs = enc.sig, tuple(int(r) for r in enc.refs)
        return Image(list(data), list(nulls), nv, len(blocks), br, dev, off, gids, descs, refs)

    # -- finalize -----------------------------------------------------------

    def _finalize_agg(self, packed, prog, n_slots: int, key_of) -> SelectResponse:
        """Pull the packed state once, keep the groups with a first active
        row in that row's order, and encode the response through
        ``AggState.result_columns`` and the group keys, as the CPU path does."""
        plan = self.plan
        ints = packed[0].cpu().numpy()
        flts = packed[1].cpu().numpy() if prog.n_f64 else None
        if plan.group_rpns:
            first = ints[0, :n_slots]
            alive = np.flatnonzero(first != NO_ROW)
            order = alive[np.argsort(first[alive], kind="stable")]
        else:
            order = np.array([0])
        out_cols: list[Column] = []
        for (op, rpn), slots in zip(plan.agg_rpns, _carry_slots(prog)):
            leaves = [(flts if is_f else ints)[slot, :n_slots] for is_f, slot in slots]
            st = _to_state(op, rpn, leaves, n_slots)
            out_cols += [c.take(order) for c in st.result_columns(n_slots)]
        for gi, g in enumerate(plan.group_rpns):
            out_cols.append(Column.from_values(g.eval_type, [key_of(r)[gi] for r in order],
                                               g.frac))
        enc = make_response_encoder(self.dag)
        enc.add_chunk(self._post_agg(Chunk.full(out_cols)), self.dag.output_offsets)
        return enc.to_response()

    def _post_agg(self, chunk: Chunk) -> Chunk:
        """A TopN or Limit after the aggregation, over the small aggregated
        chunk on the host (``jax_eval._post_agg``)."""
        plan = self.plan
        if plan.topn is not None:
            ex = BatchTopNExecutor(ChunkExecutor(chunk, plan.agg_schema), plan.post_order,
                                   plan.topn.limit)
            chunk = ex.next_batch(len(chunk.logical_rows) or 1).chunk
        if plan.limit is not None:
            chunk = Chunk(chunk.columns, chunk.logical_rows[: plan.limit.limit])
        return chunk

    # -- scan/filter ----------------------------------------------------------

    def _run_scan_filter(self, source, cache, warm: bool) -> SelectResponse:
        """``TableScan → Selection? → Limit?`` (``jax_eval._run_scan_filter``):
        the mask on the device (none without a selection), one pull of it per
        launch, host compaction and response encoding.  Cold, one launch per
        block and a stop after the block that fills the Limit (unless a cache
        is being filled).  Warm, with a Limit, launches over 1, 2, 4, ...
        blocks of the resident image until it is met; without, one launch
        over the whole image."""
        plan = self.plan
        remaining = plan.limit.limit if plan.limit is not None else None
        enc = make_response_encoder(self.dag)

        def emit(cols, n_valid: int, mask) -> bool:
            """Encode a block's surviving rows, gathered through the
            encodings; True once the Limit is met."""
            nonlocal remaining
            logical = np.arange(n_valid) if mask is None else np.flatnonzero(mask[:n_valid])
            if remaining is not None:
                logical = logical[:remaining]
                remaining -= len(logical)
            out_cols, logical = encoding.late_materialize_chunk(cols, logical)
            enc.add_chunk(Chunk(out_cols, logical), self.dag.output_offsets)
            return remaining is not None and remaining <= 0

        prog = plan.mask_program
        if warm:
            blocks = cache.blocks
            keep = self._prune_keep(cache)
            kept = np.arange(len(blocks)) if keep is None else np.flatnonzero(keep)
            img = self._stacked_device(cache, keep=keep) if prog is not None else None
            # a doubling prefix of the kept blocks, each launch over the
            # range that spans them (pruned blocks in it have n_valid 0)
            pos, step = 0, 1 if remaining is not None else max(len(kept), 1)
            while pos < len(kept):
                chunk = kept[pos : pos + step]
                start, end = int(chunk[0]), int(chunk[-1]) + 1
                masks = None
                if prog is not None:
                    masks = fused_mask(prog, img.blocks(start, end)).cpu().numpy()
                for bi in chunk:
                    b = blocks[bi]
                    if emit(b.cols, b.n_valid, None if masks is None else masks[bi - start]):
                        return enc.to_response()
                pos, step = pos + len(chunk), step * 2
            return enc.to_response()
        done = False
        with closing(self._cold_blocks(source, cache)) as blocks:
            for cols, n_valid in blocks:
                if done:
                    continue  # filling the cache
                mask = None
                if prog is not None:
                    mask = fused_mask(prog, self._block_image(cols, n_valid)).cpu().numpy()[0]
                done = emit(cols, n_valid, mask)
                if done and cache is None:
                    break
        return enc.to_response()

    # -- raw TopN -------------------------------------------------------------

    def _run_topn(self, source, cache, warm: bool) -> SelectResponse:
        """``TableScan → Selection? → TopN → Limit?`` with no aggregation
        (``jax_eval._run_topn``): the running top K on the device, cold one
        step per block with the carry on the device, warm one step over the
        resident image; one packed pull of K rows.  Payload is every schema
        column; BYTES columns ride as dictionary codes, and a column that is
        not dictionary-coded, or whose dictionary changes between blocks,
        raises ``ValueError``.  Warm, zone-pruned blocks and (no selection, a
        bare first key) the blocks that zone order proves cannot reach the
        top K ship no valid row."""
        plan = self.plan
        prog = plan.topn_program
        if prog is None:  # K == 0
            return make_response_encoder(self.dag).to_response()
        payload = list(range(len(plan.schema)))
        dicts: dict[int, np.ndarray] = {}
        if warm:
            for b in cache.blocks:
                self._check_payload_dicts(b.cols, dicts)
            pay = self._stacked_device(cache, payload, keep=self._topn_keep(cache))
            state = topn_step(prog, _pick(pay, payload, plan.device_cols), pay)
            return self._finalize_topn(state, dicts)
        state = None
        with closing(self._cold_blocks(source, cache)) as blocks:
            for cols, n_valid in blocks:
                self._check_payload_dicts(cols, dicts)
                pay = self._block_image(cols, n_valid, ship=payload)
                state = topn_step(prog, _pick(pay, payload, plan.device_cols), pay, state,
                                  src_base=prog.k)
        if state is None:
            return make_response_encoder(self.dag).to_response()
        return self._finalize_topn(state, dicts)

    def _topn_keep(self, cache):
        """The warm raw TopN's keep mask: zone pruning, then, with no
        selection and a bare-column first key, the zone-order early exit
        (``jax_eval._run_topn``).  Blocks keep stream order, so only blocks
        that cannot hold a top-K row drop out and the bytes cannot change."""
        plan = self.plan
        keep = self._prune_keep(cache)
        rpn0, desc0 = plan.topn_rpns[0]
        if (plan.sel_rpns or not zone_maps.enabled() or len(rpn0.nodes) != 1
                or rpn0.nodes[0].kind != "col" or not zone_maps.ensure_zones(cache)):
            return keep
        n = len(cache.blocks)
        base = keep if keep is not None else np.ones(n, dtype=bool)
        cut = zone_maps.topn_cutoff_order(cache.blocks, base, rpn0.nodes[0].index, desc0, plan.k)
        exited = int((base & ~cut).sum()) if cut is not None else 0
        if not exited:
            return keep
        examined, pruned = self.prune_stats
        self.prune_stats = (examined or n, pruned + exited)
        return cut

    def _check_payload_dicts(self, cols, dicts: dict) -> None:
        """BYTES payload rides as dictionary codes: every block must carry
        the same dictionary, or the codes mean nothing (``jax_eval.py:1611``)."""
        for ci, (et, _frac) in enumerate(self.plan.schema):
            if et != EvalType.BYTES:
                continue
            d = cols[ci].dictionary
            if d is None:
                raise ValueError(f"TopN BYTES payload column {ci} not dict-coded")
            seen = dicts.setdefault(ci, d)
            if seen is not d and (len(seen) != len(d) or any(a != b for a, b in zip(seen, d))):
                raise ValueError(f"TopN BYTES payload column {ci}: unstable dictionary")

    def _finalize_topn(self, state, dicts: dict) -> SelectResponse:
        """Pull the packed K rows once; the rank-0 prefix is the answer."""
        prog = self.plan.topn_program
        ints = state[0].cpu().numpy()
        flts = state[1].cpu().numpy() if prog.n_f64 else None
        n_out = int((ints[0] == 0).sum())
        out_cols = []
        for ci, (et, frac) in enumerate(self.plan.schema):
            data = (flts if prog.pay_f64[ci] else ints)[prog.pay_row[ci], :n_out]
            nulls = ints[prog.pay_null_row[ci], :n_out].astype(bool)
            out_cols.append(Column(et, data, nulls, frac, dicts.get(ci)))
        enc = make_response_encoder(self.dag)
        enc.add_chunk(Chunk.full(out_cols), self.dag.output_offsets)
        return enc.to_response()


def _pick(img: Image, ship: list[int], cols: list[int]) -> Image:
    """The image of columns ``cols``, taken from ``img`` over ``ship``."""
    return img.pick([ship.index(i) for i in cols])


def _capacity_for(prog: GroupProgram, capacity: int, n_groups: int) -> int:
    """Group slots for ``n_groups``: ``capacity`` doubled until it holds
    them, cut back to the shared-memory kernel's limit where that still
    holds them (past it the grouped pair takes its wide route)."""
    while capacity < n_groups:
        capacity *= 2
    if n_groups <= prog.c_max < capacity:
        capacity = prog.c_max
    check_capacity(prog, capacity)
    return capacity


def _carry_slots(prog) -> list[list[tuple[bool, int]]]:
    """Per aggregate, its carry leaves as (f64 matrix?, row) in carry order."""
    if isinstance(prog, Program):
        return [[(False, leaf.cnt_slot)]
                + ([] if leaf.kind == AGG_COUNT else [(leaf.is_f64, leaf.val_slot)])
                for leaf in prog.aggs]
    return [[(prog.leaves[i].is_f64, prog.leaves[i].slot) for i in own]
            for own in prog.agg_leaves]


def _to_state(op: str, rpn, leaves, n_slots: int) -> AggState:
    """An ``AggState`` filled from one aggregate's carry leaves
    (``_DeviceAgg.to_state``): finalization then runs the CPU path's code."""
    st = AggState(op, rpn.eval_type if rpn is not None else EvalType.INT,
                  rpn.frac if rpn is not None else 0)
    st.grow(n_slots)
    st.count = leaves[0].astype(np.int64)
    if op in ("sum", "avg"):
        st.sum = leaves[1].astype(st.sum.dtype)
    elif op == "var_pop":
        st.sum = leaves[1].astype(st.sum.dtype)
        st.sum_sq = leaves[2]
    elif op == "first":
        st.value = leaves[1]
        st.has_value = leaves[2] != NO_ROW
    elif op in ("bit_and", "bit_or", "bit_xor"):
        st.value = leaves[1]
    elif op in ("min", "max"):
        st.value = leaves[1]
        st.has_value = st.count > 0
    return st


# ---------------------------------------------------------------------------
# Batches: K plans over one image (program #10), one plan over R images (#11)
# ---------------------------------------------------------------------------

def _dict_slots(dicts) -> tuple[tuple[int, ...], int, int]:
    """(dictionary lengths, group slots, the power-of-two capacity that
    holds them) of coded group keys; NULL is each key's code ``dlen``."""
    dict_lens = tuple(len(d) for d in dicts)
    n_slots = 1
    for dl in dict_lens:
        n_slots *= dl + 1
    capacity = 1
    while capacity < n_slots:
        capacity *= 2
    return dict_lens, n_slots, capacity


def _batch_schema(evaluators, ship) -> dict:
    """``{column: (eval_type, frac)}`` of a batch's shipped columns, each
    from a rider whose scan has it; riders that type a column differently
    cannot share its lane."""
    schema = {}
    for ev in evaluators:
        for i, t in enumerate(ev.plan.schema):
            if i in ship and schema.setdefault(i, t)[0] != t[0]:
                raise ValueError(f"batched evaluation: column {i} typed differently by riders")
    return schema


def _check_tasks(progs, capacities) -> None:
    """The batch's limits, before anything is pinned: ``ValueError``."""
    for prog, cap in zip(progs, capacities):
        fused_batch.check_task(prog, cap)


def _zone_batch(evaluators, cache):
    """The zone rung for a whole same-region batch, or None
    (``jax_eval.py:1733-1752``).  A probe over every rider first (no device
    work; ``route_hint`` is not read), then every rider planned on its rung,
    then, only if all were, every one launched and finalized: a decline at
    any step sends the whole batch to the batch kernels with no zone kernel
    launched.  A zone-kernel failure raises, as on the unary route."""
    rungs = []
    for ev in evaluators:
        if ev.plan.agg is None:
            return None
        rung = ev._zone_rung()
        ok = cache not in rung._declined and rung.eligible(cache.blocks) is not None
        rungs.append(rung if ok else None)
    if any(r is None for r in rungs):
        return None
    planned = []
    for rung in rungs:
        tiles = rung.plan_tiles(cache)
        if tiles is None:
            return None
        planned.append(tiles)
    outs = [rung.serve(tiles) for rung, tiles in zip(rungs, planned)]
    return [ev._finalize_agg(*out) for ev, out in zip(evaluators, outs)]


def batch_tasks(evaluators: list[TorchDagEvaluator], cache):
    """The batch kernels' tasks of a same-region batch, one per rider over
    one pin of the sorted union of the riders' shipped columns, with the
    blocks masked that every rider's zone maps prune; and per rider its
    ``(dicts, dict_lens, n_slots)``, and the blocks (examined, pruned).
    ``ValueError`` as :func:`run_batch_cached`."""
    blocks = cache.blocks
    if not blocks:
        raise ValueError("batched evaluation over an empty block cache")
    specs = []  # (ev, group_cols, dicts, dict_lens, capacity, n_slots)
    ship: set[int] = set()
    for ev in evaluators:
        if ev.plan.agg is None:
            raise ValueError("batched evaluation requires aggregation DAGs")
        stable = ev._stable_dict_group_cols(blocks)
        if ev.plan.group_rpns and stable is None:
            raise ValueError("batched evaluation requires stable dict group keys")
        group_cols, dicts = stable
        dict_lens, n_slots, capacity = _dict_slots(dicts)
        specs.append((ev, group_cols, dicts, dict_lens, capacity, n_slots))
        ship |= set(ev._ship_cols(group_cols))
    ship = sorted(ship)
    schema = _batch_schema(evaluators, ship)
    progs = [ev._batch_program(ship, schema, gc, dl) for ev, gc, _d, dl, _c, _n in specs]
    _check_tasks(progs, [spec[4] for spec in specs])
    nullable = sorted({i for ev, gc, *_ in specs for i in _nullable(ev.plan.scan,
                                                                    ev._ship_cols(gc))})
    keep = zone_maps.batch_prune_keep([ev._prune_keep(cache) for ev in evaluators])
    pruned = (len(blocks), int((~keep).sum())) if keep is not None else (0, 0)
    img = evaluators[0]._stacked_device(cache, ship, keep=keep, nullable=nullable)
    tasks = [fused_batch.Task(prog, img, spec[4]) for prog, spec in zip(progs, specs)]
    return tasks, [(d, dl, n) for _e, _g, d, dl, _c, n in specs], pruned


def run_batch_cached(evaluators: list[TorchDagEvaluator], cache) -> list[SelectResponse]:
    """K aggregation requests over one filled block cache served together
    (``jax_eval.run_batch_cached``, program #10): on the zone rung when it
    serves every one (:func:`_zone_batch`), else by the batch kernels
    (``copr/fused_batch.py``) over :func:`batch_tasks`, with one pull of
    the packed states.  Each response is byte-identical to that request
    served alone warm.

    Every request must aggregate, and group by nothing or by bare
    dictionary-coded columns whose dictionary every block shares; otherwise,
    and over an empty cache, ``ValueError`` (so too where the port's limits
    refuse a rider, naming the cause)."""
    if not cache.blocks:
        raise ValueError("batched evaluation over an empty block cache")
    resps = _zone_batch(evaluators, cache)
    if resps is not None:
        return resps
    tasks, specs, pruned = batch_tasks(evaluators, cache)
    if tasks[0].img.descs is not None:
        encoding.count_path("fused", "encoded")
    ints, flts = fused_batch.fused_batch(tasks)
    ints, flts = ints.cpu(), flts.cpu()  # one pull for the whole batch
    out = []
    for i, (ev, task, (dicts, dict_lens, n_slots)) in enumerate(zip(evaluators, tasks, specs)):
        ev.prune_stats = pruned
        out.append(ev._finalize_agg((ints[i], flts[i]), task.prog, n_slots,
                                    zone.key_of(dicts, dict_lens)))
    return out


class XRegionPending:
    """A cross-region batch launched on the device's stream and not yet
    pulled (``jax_eval.XRegionPending``): a caller prepares its next batch
    on the host while this one runs, then calls :meth:`finalize`.
    ``encoded`` says whether the images shipped encoded (``batch_plan``);
    ``prunes`` holds each region's (blocks examined, blocks pruned), in the
    caller's order."""

    def __init__(self, ev, specs, progs, packed, order, prunes, encoded: bool):
        self._ev = ev
        self._specs = specs  # (dicts, dict_lens, n_slots) per region, the caller's order
        self._progs = progs  # per executed region
        self._packed = packed  # ((R, li, C) int64, (R, lf, C) f64) on the device
        self._order = order  # executed position -> the caller's position
        self.prunes = prunes
        self.encoded = encoded

    def finalize(self) -> list[SelectResponse]:
        """One pull of the two matrices for the whole batch, then each
        region finalized as its warm request is alone, in the caller's
        order."""
        ints, flts = self._packed[0].cpu(), self._packed[1].cpu()
        out = [None] * len(self._specs)
        for pos, r in enumerate(self._order):
            dicts, dict_lens, n_slots = self._specs[r]
            out[r] = self._ev._finalize_agg((ints[pos], flts[pos]), self._progs[pos], n_slots,
                                            zone.key_of(dicts, dict_lens))
        return out


def xregion_specs(ev: TorchDagEvaluator, caches):
    """Validate a cross-region batch (``jax_eval.xregion_specs``): the
    per-region ``(dicts, dict_lens, n_slots)``, the group columns and the
    shared power-of-two capacity, the largest region's.  ``ValueError`` for
    a plan that does not aggregate, no regions, an empty cache, or group
    keys without a dictionary every block of the region shares."""
    if ev.plan.agg is None:
        raise ValueError("cross-region batching requires aggregation DAGs")
    if not caches:
        raise ValueError("cross-region batching requires at least one region")
    specs = []
    capacity = 1
    for cache in caches:
        if not cache.blocks:
            raise ValueError("cross-region batching over an empty block cache")
        stable = ev._stable_dict_group_cols(cache.blocks)
        if ev.plan.group_rpns and stable is None:
            raise ValueError("cross-region batching requires stable dict group keys")
        dicts = stable[1]
        dict_lens, n_slots, cap = _dict_slots(dicts)
        capacity = max(capacity, cap)
        specs.append((dicts, dict_lens, n_slots))
    group_cols = [g.nodes[0].index for g in ev.plan.group_rpns]
    return specs, group_cols, capacity


def xregion_tasks(ev: TorchDagEvaluator, caches):
    """The batch kernels' tasks of a cross-region batch, one per region in
    descending block count, each over its own pin, pruned by its own zone
    maps, all at the shared capacity; with :func:`xregion_specs`' specs,
    the executed order, each region's (blocks examined, pruned) in the
    caller's order, and whether the images ship encoded (``batch_plan``)."""
    specs, group_cols, capacity = xregion_specs(ev, caches)
    ship = ev._ship_cols(group_cols)
    schema = _batch_schema([ev], ship)
    progs = {dl: ev._batch_program(ship, schema, group_cols, dl) for _d, dl, _n in specs}
    _check_tasks(progs.values(), [capacity] * len(progs))
    plans = encoding.batch_plan(caches, ship, _nullable(ev.plan.scan, ship), "xregion")
    order = sorted(range(len(caches)), key=lambda i: len(caches[i].blocks), reverse=True)
    tasks, prunes = [], [None] * len(caches)
    for r in order:
        cache = caches[r]
        stats = zone_maps.PruneStats()
        keep = zone_maps.prune_blocks(cache, ev.plan.sel_rpns, stats)
        prunes[r] = (stats.examined, stats.pruned)
        img = ev._stacked_device(cache, ship, keep=keep, decode=plans is None)
        tasks.append(fused_batch.Task(progs[specs[r][1]], img, capacity))
    return tasks, specs, order, prunes, plans is not None


def launch_xregion_cached(ev: TorchDagEvaluator, caches) -> XRegionPending:
    """One aggregation plan over R filled region caches, launched as one
    batch (``jax_eval.launch_xregion_cached``, program #11) over
    :func:`xregion_tasks`: each region with its own dictionary radices and
    frames of reference.  The images ship encoded only when ``batch_plan``
    finds every one encoded alike; otherwise decoded, the decline counted.
    ``finalize`` restores the caller's order.  ``ValueError`` as
    :func:`xregion_specs`, and where the port's limits refuse the plan."""
    tasks, specs, order, prunes, encoded = xregion_tasks(ev, caches)
    packed = fused_batch.fused_batch(tasks)
    return XRegionPending(ev, specs, [t.prog for t in tasks], packed, order, prunes, encoded)


def run_xregion_cached(ev: TorchDagEvaluator, caches) -> list[SelectResponse]:
    """:func:`launch_xregion_cached`, then ``finalize``."""
    return launch_xregion_cached(ev, caches).finalize()


def launch_xregion_sharded(ev: TorchDagEvaluator, caches, mesh) -> XRegionPending:
    """The cross-region batch of :func:`launch_xregion_cached` spread over
    every device of ``mesh`` (``jax_eval.launch_xregion_sharded``, program
    #20), each region image, or each block of a lone block-spread image,
    scanned on its owner device and the partial states merged by
    ``mesh_merge``.  Implemented in ``parallel/mesh.py``; this keeps the
    batch backends one import site.  ``ValueError`` on the declines of
    :func:`launch_xregion_cached`, and for an aggregate with no mesh merge
    rule."""
    from ..parallel.mesh import launch_xregion_sharded as launch

    return launch(ev, caches, mesh)
