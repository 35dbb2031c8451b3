"""TPC-H lineitem fixtures for the port: KV bytes, columnar images, plans.

The port's own copy of ``bench.py``'s ``build_arrays`` / ``build_kvs`` /
``build_cache``, its Q6 and Q1 plans, its scan and filter plans of BASELINE
configs 1-2 (``_filter_dag``) and its raw TopN plan (``_topn_endpoint``).
``build_arrays(n, seed)`` makes the same draws as ``bench.py`` for the same
``(n, seed)``, so both packages see the same table.  ``build_cache(...,
encode=True)`` encodes the image as a filled region image is encoded
(``copr/encoding.py``), and :func:`sort_by_shipdate` reorders the draws as
data loaded in date order.  The numpy oracles compute each query's answer
from the draws they are given alone, independently of any evaluator.
:func:`join_caches` makes the probe and build images of ``bench.py``'s join
event (``_op_join``), :func:`join_dag` its plan and :func:`join_oracle` its
joined pairs.  :func:`numeric_table` is the all-numeric table of the JAX
package's mesh tests, :func:`mesh_merge_case` synthetic inputs of the mesh
merge and :func:`mesh_columns` the lineitem draws as the sharded
evaluators' host columns.  :func:`grouped_dag` is the grouped Q1 shape of
the mesh's device-built group dictionary (program #17), over
:func:`grouped_schema` (l_returnflag and l_linestatus as INT codes), with
:func:`grouped_columns` and :func:`grouped_oracle`; :func:`dict_case` and
:func:`dict_kernel_check` hold its dictionary kernels to their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .copr import encoding
from .copr.aggr import AggDescriptor
from .copr.cache import ColumnBlockCache
from .copr.dag import (
    Aggregation,
    DagRequest,
    Join,
    Limit,
    Projection,
    Selection,
    SelectResponse,
    TableScan,
    TopN,
)
from .copr.datatypes import NOT_NULL_FLAG, Chunk, Column, ColumnInfo, EvalType, FieldType
from .copr.fused_agg import NO_ROW, Image, compile_program
from .copr.fused_group_agg import LEAF_TRACK, compile_group_program
from .copr.rpn import call, col, compile_expr, const_decimal, const_int, const_real
from .copr.table import RowBatchDecoder, encode_row, record_key
from .storage.btree_engine import BTreeEngine
from .storage.engine import CF_LOCK, CF_WRITE, WriteBatch
from .storage.txn_types import Write, WriteType
from .util.codec import encode_i64_batch, encode_u64

TABLE_ID = 101

# Q6 predicate bounds: shipdate in [9000, 9365), discount in [0.02, 0.04],
# quantity < 24
Q6_SHIP_LO, Q6_SHIP_HI = 9000, 9365
Q6_DISC_LO, Q6_DISC_HI = 2, 4
Q6_QTY_LT = 24
# Q1 predicate: shipdate <= 10500
Q1_SHIP_HI = 10500
# BASELINE config 2's conjuncts (bench._filter_dag): shipdate < 10500,
# quantity > 5, extendedprice >= 100000 (an INT constant against a
# DECIMAL(2) column: 100000.00, scaled 10,000,000); the selective variant
# takes shipdate < 8410 instead
FILTER_SHIP_LT = 10500
SELECTIVE_SHIP_LT = 8410
FILTER_QTY_GT = 5
FILTER_PRICE_GE = 100000


def lineitem() -> list[ColumnInfo]:
    """The lineitem region's schema; every TPC-H lineitem column is NOT NULL."""

    def nn(ft):
        ft.flag |= NOT_NULL_FLAG
        return ft

    return [
        ColumnInfo(1, nn(FieldType.int64()), is_pk_handle=True),
        ColumnInfo(2, nn(FieldType.int64())),  # l_quantity
        ColumnInfo(3, nn(FieldType.decimal_type(2))),  # l_extendedprice
        ColumnInfo(4, nn(FieldType.decimal_type(2))),  # l_discount
        ColumnInfo(5, nn(FieldType.int64())),  # l_shipdate (days)
        ColumnInfo(6, nn(FieldType.varchar())),  # l_returnflag
        ColumnInfo(7, nn(FieldType.varchar())),  # l_linestatus
    ]


def build_arrays(n: int, seed: int = 0) -> dict:
    """The raw column draws — the single source of randomness."""
    rng = np.random.default_rng(seed)
    return {
        "qty": rng.integers(1, 51, n),
        "price": rng.integers(90000, 10500000, n),  # 900.00 .. 105000.00
        "disc": rng.integers(0, 11, n),  # 0.00 .. 0.10
        "ship": rng.integers(8400, 10600, n),
        "rf": rng.integers(0, 3, n),
        "ls": rng.integers(0, 2, n),
    }


def build_kvs(n: int, seed: int = 0, arrays: dict | None = None) -> list[tuple[bytes, bytes]]:
    """Record (key, value) bytes of the lineitem table.  Rows share one fixed
    datum layout, so the table is a byte matrix filled by batch codecs.
    ``arrays`` gives the draws instead (``build_arrays(n, seed)`` by
    default); their optional ``"handle"`` (row handles, ``arange`` by
    default) and ``"flags"`` (l_returnflag's values, ``b"ANR"`` by default)
    are honored, as by the oracles."""
    a = build_arrays(n, seed) if arrays is None else arrays
    n = len(a["qty"])
    schema = lineitem()
    flags = np.frombuffer(a.get("flags", b"ANR"), dtype=np.uint8)
    stats = np.frombuffer(b"FO", dtype=np.uint8)
    row0 = encode_row(schema[1:], [1, 1, 1, 1, b"A", b"F"])
    layout = RowBatchDecoder(schema)._parse_layout(row0)
    mat = np.tile(np.frombuffer(row0, dtype=np.uint8), (n, 1))
    for col_id, arr in ((2, a["qty"]), (3, a["price"]), (4, a["disc"]), (5, a["ship"])):
        _kind, off = layout["cols"][col_id]
        mat[:, off : off + 8] = encode_i64_batch(arr)
    _k, off_rf = layout["cols"][6]
    _k, off_ls = layout["cols"][7]
    mat[:, off_rf] = flags[a["rf"]]
    mat[:, off_ls] = stats[a["ls"]]
    values = [r.tobytes() for r in mat]
    kmat = np.tile(np.frombuffer(record_key(TABLE_ID, 0), dtype=np.uint8), (n, 1))
    kmat[:, 11:19] = encode_i64_batch(_handles(a))
    keys = [r.tobytes() for r in kmat]
    return list(zip(keys, values))


def _handles(a: dict) -> np.ndarray:
    """Each row's handle: ``a["handle"]``, else its position."""
    return a["handle"] if "handle" in a else np.arange(len(a["qty"]), dtype=np.int64)


def sort_by_shipdate(a: dict) -> dict:
    """The draws reordered as data loaded in date order: every column
    permuted by a stable sort on l_shipdate.  Row r of the result (handle r)
    is the r-th row in that order, so the oracles apply to it unchanged."""
    order = np.argsort(a["ship"], kind="stable")
    return {k: v[order] for k, v in a.items()}


def build_cache(n: int, block_rows: int, seed: int = 0, arrays: dict | None = None,
                encode: bool = False, flags: bytes = b"ANR"):
    """The decoded-column image of ``build_kvs(n, seed)`` as a filled
    ``ColumnBlockCache``, without materializing n byte strings: ints and
    decimals as int64, varchar as dictionary codes sharing one dictionary.
    ``arrays`` reuses draws already made by ``build_arrays(n, seed)`` (or
    any permutation of them, as :func:`sort_by_shipdate`'s).  ``encode``
    encodes the image with ``encoding.encode_blocks``, as the JAX package
    encodes every region image it fills.  ``flags``: l_returnflag's
    dictionary (the draws' codes index it)."""
    a = build_arrays(n, seed) if arrays is None else arrays
    dict_rf = np.empty(len(flags), dtype=object)
    dict_rf[:] = [flags[i : i + 1] for i in range(len(flags))]
    dict_ls = np.empty(2, dtype=object)
    dict_ls[:] = [b"F", b"O"]
    handles = np.arange(n, dtype=np.int64)
    cache = ColumnBlockCache()
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        cache.add([
            Column(EvalType.INT, handles[s:e], nz),
            Column(EvalType.INT, a["qty"][s:e], nz),
            Column(EvalType.DECIMAL, a["price"][s:e], nz, 2),
            Column(EvalType.DECIMAL, a["disc"][s:e], nz, 2),
            Column(EvalType.INT, a["ship"][s:e], nz),
            Column(EvalType.BYTES, a["rf"][s:e], nz, 0, dict_rf),
            Column(EvalType.BYTES, a["ls"][s:e], nz, 0, dict_ls),
        ], e - s)
    cache.filled = True
    if encode:
        encoding.encode_blocks(cache, lineitem())
    return cache


def _q6_conds():
    return [
        call("ge", col(4), const_int(Q6_SHIP_LO)),
        call("lt", col(4), const_int(Q6_SHIP_HI)),
        call("ge", col(3), const_decimal(Q6_DISC_LO, 2)),
        call("le", col(3), const_decimal(Q6_DISC_HI, 2)),
        call("lt", col(1), const_int(Q6_QTY_LT)),
    ]


def q6_dag() -> DagRequest:
    """TPC-H Q6: sum(l_extendedprice * l_discount) under the Q6 predicates."""
    aggs = [AggDescriptor("sum", call("multiply", col(2), col(3)))]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()), Selection(_q6_conds()),
                                 Aggregation([], aggs)])


def q6_count_sum_min_max_dag() -> DagRequest:
    """The Q6 predicates with count, sum(price * discount), min(quantity) and
    max(price): the shape of the JAX package's flagship block step, over the
    first five lineitem columns, declared nullable."""
    cols = [ColumnInfo(c.col_id, FieldType(c.ftype.tp, decimal=c.ftype.decimal),
                       is_pk_handle=c.is_pk_handle) for c in lineitem()[:5]]
    aggs = [
        AggDescriptor("count", None),
        AggDescriptor("sum", call("multiply", col(2), col(3))),
        AggDescriptor("min", col(1)),
        AggDescriptor("max", col(2)),
    ]
    return DagRequest(executors=[TableScan(TABLE_ID, cols), Selection(_q6_conds()),
                                 Aggregation([], aggs)])


def q1_dag(ship_hi: int = Q1_SHIP_HI) -> DagRequest:
    """TPC-H Q1's shape (``bench.q1_dag``): sum(quantity), sum(price),
    avg(price), avg(discount), count(*) grouped by (returnflag,
    linestatus) under shipdate <= ``ship_hi`` (10500)."""
    aggs = [
        AggDescriptor("sum", col(1)),
        AggDescriptor("sum", col(2)),
        AggDescriptor("avg", col(2)),
        AggDescriptor("avg", col(3)),
        AggDescriptor("count", None),
    ]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()),
                                 Selection([call("le", col(4), const_int(ship_hi))]),
                                 Aggregation([col(5), col(6)], aggs)])


def _groups(key: np.ndarray, m: np.ndarray):
    """The rows of ``m`` grouped by ``key`` (small non-negative ints):
    ``(rows, starts)`` — the qualifying row indices ordered by key, each
    key's rows in ascending order, and where each key's run starts."""
    rows = np.flatnonzero(m)
    k = key[rows].astype(np.int16)  # a 16-bit key takes numpy's radix sort
    order = np.argsort(k, kind="stable")
    rows, k = rows[order], k[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]]) if len(k) else np.zeros(0, np.int64)
    return rows, starts


def _group_sum(col: np.ndarray, rows: np.ndarray, starts: np.ndarray) -> np.ndarray:
    return np.add.reduceat(col[rows].astype(np.int64), starts)


def q1_oracle(a: dict, ship_hi: int = Q1_SHIP_HI) -> list:
    """Q1's response rows from the raw draws, one per group that has a
    qualifying row, in the order of each group's first qualifying row."""
    m = a["ship"] <= ship_hi
    flags = a.get("flags", b"ANR")
    rows, starts = _groups(a["rf"] * 2 + a["ls"], m)
    if not len(rows):
        return []
    counts = np.diff(np.r_[starts, len(rows)])
    qty, price, disc = (_group_sum(a[c], rows, starts) for c in ("qty", "price", "disc"))
    out = []
    for g, s in enumerate(starts):
        rf, ls = divmod(int(a["rf"][rows[s]] * 2 + a["ls"][rows[s]]), 2)
        n, p = int(counts[g]), int(price[g])
        out.append((int(rows[s]), [int(qty[g]), (p, 2), n, (p, 2), n, (int(disc[g]), 2), n,
                                   flags[rf : rf + 1], b"FO"[ls : ls + 1]]))
    return [r for _first, r in sorted(out, key=lambda fr: fr[0])]


def qty_dag() -> DagRequest:
    """A GROUP BY over an INT column (l_quantity, 50 groups), which takes
    host group ids: count(*), sum(price), avg(discount), max(shipdate)
    under Q1's predicate."""
    aggs = [AggDescriptor("count", None), AggDescriptor("sum", col(2)),
            AggDescriptor("avg", col(3)), AggDescriptor("max", col(4))]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()),
                                 Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
                                 Aggregation([col(1)], aggs)])


def qty_oracle(a: dict) -> list:
    """:func:`qty_dag`'s response rows from the raw draws, in the order of
    each group's first qualifying row."""
    m = a["ship"] <= Q1_SHIP_HI
    rows, starts = _groups(a["qty"], m)
    if not len(rows):
        return []
    counts = np.diff(np.r_[starts, len(rows)])
    price, disc = (_group_sum(a[c], rows, starts) for c in ("price", "disc"))
    ship = np.maximum.reduceat(a["ship"][rows], starts)
    out = []
    for g, s in enumerate(starts):
        n = int(counts[g])
        out.append((int(rows[s]), [n, (int(price[g]), 2), n, (int(disc[g]), 2), int(ship[g]),
                                   int(a["qty"][rows[s]])]))
    return [r for _first, r in sorted(out, key=lambda fr: fr[0])]


def filter_dag(kind: str, limit: int | None = 100_000) -> DagRequest:
    """BASELINE configs 1-2 (``bench._filter_dag``): ``"scan"`` — every
    lineitem column, no predicate; ``"filter"`` — the three conjuncts;
    ``"selective"`` — the same with shipdate < 8410.  Then ``Limit(limit)``
    unless ``limit`` is None."""
    execs = [TableScan(TABLE_ID, lineitem())]
    if kind != "scan":
        ship = {"filter": FILTER_SHIP_LT, "selective": SELECTIVE_SHIP_LT}[kind]
        execs.append(Selection([
            call("lt", col(4), const_int(ship)),
            call("gt", col(1), const_int(FILTER_QTY_GT)),
            call("ge", col(2), const_int(FILTER_PRICE_GE)),
        ]))
    if limit is not None:
        execs.append(Limit(limit))
    return DagRequest(executors=execs)


def filter_mask(a: dict, kind: str) -> np.ndarray:
    """The rows :func:`filter_dag` keeps, from the draws."""
    if kind == "scan":
        return np.ones(len(a["qty"]), dtype=bool)
    ship = {"filter": FILTER_SHIP_LT, "selective": SELECTIVE_SHIP_LT}[kind]
    return (a["ship"] < ship) & (a["qty"] > FILTER_QTY_GT) & (a["price"] >= FILTER_PRICE_GE * 100)


def _lineitem_rows(a: dict, rows: np.ndarray, n_cols: int = 7) -> list:
    """Response rows of the lineitem columns ``0..n_cols-1`` at ``rows``."""
    out = []
    flags, handles = a.get("flags", b"ANR"), _handles(a)
    for r in rows.tolist():
        rf, ls = int(a["rf"][r]), int(a["ls"][r])
        out.append([int(handles[r]), int(a["qty"][r]), (int(a["price"][r]), 2),
                    (int(a["disc"][r]), 2), int(a["ship"][r]), flags[rf : rf + 1],
                    b"FO"[ls : ls + 1]][:n_cols])
    return out


def filter_oracle(a: dict, kind: str, limit: int | None = 100_000) -> list:
    """:func:`filter_dag`'s response rows, from the draws."""
    rows = np.flatnonzero(filter_mask(a, kind))
    return _lineitem_rows(a, rows if limit is None else rows[:limit])


def topn_dag(k: int = 100) -> DagRequest:
    """The raw TopN of ``bench._topn_endpoint``: the first five lineitem
    columns, shipdate <= 10500, ORDER BY extendedprice DESC, quantity ASC,
    LIMIT ``k``."""
    return DagRequest(executors=[
        TableScan(TABLE_ID, lineitem()[:5]),
        Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
        TopN([(col(2), True), (col(1), False)], k),
    ])


def topn_oracle(a: dict, k: int = 100) -> list:
    """:func:`topn_dag`'s response rows: the surviving rows in a stable
    order of (-price, quantity), ties in stream order.  Only rows priced at
    least the k-th highest surviving price can place, so only they are
    sorted."""
    rows = np.flatnonzero(a["ship"] <= Q1_SHIP_HI)
    price = a["price"][rows]
    if len(rows) > k:
        rows = rows[price >= np.partition(price, len(price) - k)[len(price) - k]]
    order = np.lexsort((rows, a["qty"][rows], -a["price"][rows].astype(np.int64)))
    return _lineitem_rows(a, rows[order[:k]], 5)


def q1_topn_dag(k: int = 4) -> DagRequest:
    """BASELINE config 4's HashAgg + TopN: :func:`q1_dag`, then ORDER BY
    l_returnflag, l_linestatus LIMIT ``k`` over the aggregated chunk, whose
    columns 7 and 8 are the two group keys (after sum, sum, avg's count and
    sum, avg's count and sum, count)."""
    dag = q1_dag()
    dag.executors.append(TopN([(col(7), False), (col(8), False)], k))
    return dag


def q1_topn_oracle(q1_rows: list, k: int = 4) -> list:
    """:func:`q1_topn_dag`'s response rows, from :func:`q1_oracle`'s rows
    over the same draws."""
    return sorted(q1_rows, key=lambda row: (row[7], row[8]))[:k]


# ---------------------------------------------------------------------------
# Batches: riders over one image, regions of one plan
# ---------------------------------------------------------------------------

BATCH_SHIP_HI = 9500  # the Q1 rider with a narrower shipdate bound


def flag_dag() -> DagRequest:
    """GROUP BY l_returnflag alone: count(*), sum(quantity),
    max(discount) under Q1's predicate."""
    aggs = [AggDescriptor("count", None), AggDescriptor("sum", col(1)),
            AggDescriptor("max", col(3))]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()),
                                 Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
                                 Aggregation([col(5)], aggs)])


def flag_oracle(a: dict) -> list:
    """:func:`flag_dag`'s response rows, in the order of each flag's first
    qualifying row."""
    rows, starts = _groups(a["rf"], a["ship"] <= Q1_SHIP_HI)
    if not len(rows):
        return []
    counts = np.diff(np.r_[starts, len(rows)])
    qty = _group_sum(a["qty"], rows, starts)
    disc = np.maximum.reduceat(a["disc"][rows], starts)
    out = [(int(rows[s]), [int(counts[g]), int(qty[g]), (int(disc[g]), 2),
                           b"ANR"[a["rf"][rows[s]] : a["rf"][rows[s]] + 1]])
           for g, s in enumerate(starts)]
    return [r for _first, r in sorted(out, key=lambda fr: fr[0])]


def q6_price_dag() -> DagRequest:
    """A Q6 variant over two columns (l_extendedprice, l_shipdate): count(*)
    and sum(price) under Q6's shipdate range, so its columns sit at other
    positions of a batch's shared ship list than in its own."""
    return DagRequest(executors=[
        TableScan(TABLE_ID, lineitem()),
        Selection([call("ge", col(4), const_int(Q6_SHIP_LO)),
                   call("lt", col(4), const_int(Q6_SHIP_HI))]),
        Aggregation([], [AggDescriptor("count", None), AggDescriptor("sum", col(2))])])


def q6_price_oracle(a: dict) -> list:
    m = (a["ship"] >= Q6_SHIP_LO) & (a["ship"] < Q6_SHIP_HI)
    n = int(m.sum())
    return [n, (int(a["price"][m].astype(np.int64).sum()), 2) if n else None]


def xor_dag() -> DagRequest:
    """bit_xor(l_quantity) and count(*) grouped by l_linestatus under Q1's
    predicate: the zone rung declines it (``agg_op``)."""
    return DagRequest(executors=[
        TableScan(TABLE_ID, lineitem()),
        Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
        Aggregation([col(6)], [AggDescriptor("bit_xor", col(1)), AggDescriptor("count", None)])])


def xor_oracle(a: dict) -> list:
    rows, starts = _groups(a["ls"], a["ship"] <= Q1_SHIP_HI)
    if not len(rows):
        return []
    counts = np.diff(np.r_[starts, len(rows)])
    xor = np.bitwise_xor.reduceat(a["qty"][rows].astype(np.int64), starts)
    out = [(int(rows[s]), [int(xor[g]), int(counts[g]),
                           b"FO"[a["ls"][rows[s]] : a["ls"][rows[s]] + 1]])
           for g, s in enumerate(starts)]
    return [r for _first, r in sorted(out, key=lambda fr: fr[0])]


def batch_plans() -> list:
    """The riders of a same-region batch, ``(name, dag, oracle)``: Q6, the
    count/sum/min/max shape, Q1, Q1 + TopN, GROUP BY l_returnflag alone,
    Q1 with shipdate <= 9500, the two-column Q6 variant and the bit_xor
    rider; every oracle maps the draws to the response rows."""
    return [
        ("q6", q6_dag(), lambda a: [q6_oracle(a)]),
        ("q6_count_sum_min_max", q6_count_sum_min_max_dag(),
         lambda a: [q6_count_sum_min_max_oracle(a)]),
        ("q1", q1_dag(), q1_oracle),
        ("q1_topn", q1_topn_dag(), lambda a: q1_topn_oracle(q1_oracle(a))),
        ("group_by_returnflag", flag_dag(), flag_oracle),
        ("q1_ship_9500", q1_dag(BATCH_SHIP_HI), lambda a: q1_oracle(a, BATCH_SHIP_HI)),
        ("q6_price", q6_price_dag(), lambda a: [q6_price_oracle(a)]),
        ("bit_xor_by_linestatus", xor_dag(), xor_oracle),
    ]


def mixed_dag() -> DagRequest:
    """GROUP BY l_returnflag with the leaf kinds Q1 lacks: var_pop (an f64
    sum of squares), first (its row and value), bit_and, bit_or, min and
    max, under Q1's predicate: the batch kernels' checks ride it."""
    aggs = [AggDescriptor("var_pop", col(1)), AggDescriptor("first", col(2)),
            AggDescriptor("bit_and", col(1)), AggDescriptor("bit_or", col(4)),
            AggDescriptor("min", col(3)), AggDescriptor("max", col(2))]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()),
                                 Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
                                 Aggregation([col(5)], aggs)])


def _f64_err(got: torch.Tensor, want: torch.Tensor, rel_tol: float, what: str) -> float:
    """Largest absolute difference of two f64 tensors, raising past
    ``rel_tol`` of the wanted magnitude (NaN equal to NaN)."""
    g, w = got.double(), want.double()
    same = (g == w) | (g.isnan() & w.isnan())
    diff = torch.where(same, 0.0, (g - w).abs())
    if bool((diff > rel_tol * w.abs()).any()):
        raise AssertionError(f"{what}: f64 leaves differ beyond rel {rel_tol}")
    return float(diff.max()) if diff.numel() else 0.0


def batch_kernel_check(tasks, rel_tol: float = 1e-12) -> dict:
    """``batch_partials`` and ``batch_combine_pack`` over ``tasks`` (CUDA
    images) beside their plain versions on the same inputs: integer words
    equal, f64 leaves to ``rel_tol`` (summed in another order), the combine
    held to its plain version over the kernel's own partials, and two runs
    of the batch bit-identical; a wide task's rows (the grouped pair's wide
    route) against ``fused_group_agg_plain``.  Raises on a difference;
    returns the largest absolute errors and the layout."""
    from .copr import fused_batch as fb
    from .copr import fused_group_agg as ga

    batch = fb.Batch(tasks)
    table = fb.upload_table(batch)
    parts = torch.empty(batch.n_parts, dtype=torch.int64, device=batch.device)
    fb.launch_batch_partials(batch, table, parts)
    want = fb.batch_partials_plain(batch)
    err_p = 0.0
    for i, t in enumerate(batch.tasks):
        got_i, want_i = batch.parts_of(parts, i), batch.parts_of(want, i)
        for l, leaf in enumerate(t.prog.leaves):
            if leaf.is_f64:
                err_p = max(err_p, _f64_err(got_i[:, l].view(torch.float64),
                                            want_i[:, l].view(torch.float64), rel_tol,
                                            f"task {i} partials leaf {l}"))
            elif not torch.equal(got_i[:, l], want_i[:, l]):
                raise AssertionError(f"task {i} partials leaf {l}: integer words differ")
    out = fb._new_out(batch)
    fb.launch_batch_combine_pack(batch, table, parts, out)
    want_i, want_f = fb.batch_combine_pack_plain(batch, parts)
    if not torch.equal(out[0], want_i):
        raise AssertionError("batch_combine_pack: integer words differ")
    err_c = _f64_err(out[1], want_f, rel_tol, "batch_combine_pack")
    runs = [fb.fused_batch(tasks) for _ in range(2)]
    sh = batch.shared
    if not all(torch.equal(r[0], runs[0][0]) and torch.equal(r[1].view(torch.int64),
                                                             runs[0][1].view(torch.int64))
               for r in runs) or not (torch.equal(runs[0][0][sh], out[0][sh]) and torch.equal(
                   runs[0][1][sh].view(torch.int64), out[1][sh].view(torch.int64))):
        raise AssertionError("batch kernels: two runs differ")
    err_w = 0.0
    for i in batch.wide:  # the wide route's state in the task's rows
        t = batch.tasks[i]
        wi, wf = ga.fused_group_agg_plain(t.prog, t.img, t.capacity)
        if not torch.equal(runs[0][0][i, : t.prog.n_int, : t.capacity], wi):
            raise AssertionError(f"wide task {i}: integer words differ")
        err_w = max(err_w, _f64_err(runs[0][1][i, : t.prog.n_f64, : t.capacity], wf, rel_tol,
                                    f"wide task {i}"))
    return {"partials": err_p, "combine": err_c, "wide": err_w, "tasks": len(batch),
            "wide_tasks": batch.wide, "ctas": batch.n_ctas, "partial_words": batch.n_parts,
            "out_shape": [len(batch), batch.li, batch.lf, batch.c_max]}


def wide_kernel_check(prog, img: Image, capacity: int, rel_tol: float = 1e-12) -> dict:
    """The grouped pair's wide route on a CUDA image (``capacity`` past
    ``c_max``) beside its plain versions on the same inputs:
    ``group_wide_partials``' state word for word against
    ``wide_partials_plain`` (integers, f64 min/max keys, exact sums);
    ``group_wide_combine`` over that state against ``wide_combine_plain``
    (the same integer rounding: f64 bit for bit, NaN equal to NaN), from
    the identity and into a carry; the pair against ``fused_group_agg_plain``
    (f64 to ``rel_tol``); two runs bit-identical.  Raises on a difference;
    returns the largest absolute f64 differences."""
    from .copr import fused_group_agg as ga

    if prog.shared_rows(capacity):
        raise ValueError(f"capacity {capacity} is within the shared rows ({prog.c_max})")
    state = ga.new_partials(prog, img, capacity)
    ga.launch_partials(prog, img, capacity, state)
    if not torch.equal(state, ga.wide_partials_plain(prog, img, capacity)):
        raise AssertionError("group_wide_partials: state words differ from the plain version")
    errs = {"partials": 0.0}
    wide_combine_check(prog, img, capacity, state)
    errs["combine"] = 0.0
    first = ga.init_packed(prog, capacity, img.device)
    ga.launch_combine(prog, img, capacity, state, None, first)
    pair = [ga.fused_group_agg(prog, img, capacity) for _ in range(2)]
    if not (torch.equal(pair[0][0], pair[1][0])
            and torch.equal(pair[0][1].view(torch.int64), pair[1][1].view(torch.int64))
            and torch.equal(pair[0][0], first[0])):
        raise AssertionError("wide route: two runs differ")
    want = ga.fused_group_agg_plain(prog, img, capacity)
    if not torch.equal(pair[0][0], want[0]):
        raise AssertionError("wide route: integer leaves differ from fused_group_agg_plain")
    errs["pair"] = _f64_err(pair[0][1], want[1], rel_tol, "wide route")
    return errs


def region_caches(block_counts, block_rows: int, seed: int = 0, two_flags=()) -> list:
    """Region images of the lineitem table, ``(draws, cache)`` each: region
    ``r`` holds ``block_counts[r]`` full blocks drawn from ``seed + r``;
    the regions listed in ``two_flags`` hold only the flags A and N, under a
    dictionary of two (the others' has three)."""
    out = []
    for r, nb in enumerate(block_counts):
        n = nb * block_rows
        a = build_arrays(n, seed + r)
        flags = b"ANR"
        if r in two_flags:
            a["rf"] = a["rf"] % 2
            flags = b"AN"
        out.append((a, build_cache(n, block_rows, seed + r, arrays=a, flags=flags)))
    return out


def _q6_mask(a: dict) -> np.ndarray:
    return ((a["ship"] >= Q6_SHIP_LO) & (a["ship"] < Q6_SHIP_HI)
            & (a["disc"] >= Q6_DISC_LO) & (a["disc"] <= Q6_DISC_HI)
            & (a["qty"] < Q6_QTY_LT))


def q6_oracle(a: dict) -> list:
    """Q6's response row from the raw draws: ``[(scaled sum, 4)]``, or
    ``[None]`` when no row qualifies."""
    m = _q6_mask(a)
    if not m.any():
        return [None]
    return [(int((a["price"][m].astype(np.int64) * a["disc"][m]).sum()), 4)]


def q6_count_sum_min_max_oracle(a: dict) -> list:
    """The response row of :func:`q6_count_sum_min_max_dag` from the draws."""
    m = _q6_mask(a)
    n = int(m.sum())
    if n == 0:
        return [0, None, None, None]
    price = a["price"][m].astype(np.int64)
    return [n, (int((price * a["disc"][m]).sum()), 4), int(a["qty"][m].min()),
            (int(price.max()), 2)]


def synthetic_case(n_blocks: int, block_rows: int, gen: torch.Generator, device):
    """A fused-aggregate program and its image for holding the kernel to its
    plain version: int64, decimal and f64 lanes, nullable and NOT NULL
    columns, wrapping int64 products, decimal rescales, a ragged last block
    and (with more than four blocks) empty blocks.  Data is drawn on
    ``device`` from ``gen``; f64 values are non-negative, so f64 sums carry
    no cancellation and compare to a relative tolerance."""
    schema = [(EvalType.INT, 0), (EvalType.DECIMAL, 2), (EvalType.REAL, 0), (EvalType.INT, 0),
              (EvalType.DECIMAL, 4)]
    sel = [call("ge", col(0), const_int(-(1 << 38))),
           call("or", call("lt", col(2), const_real(900.0)), call("is_null", col(3))),
           call("ne", col(4), const_decimal(7, 1))]
    aggs = [("count", None),
            ("count", col(1)),
            ("sum", call("multiply", col(0), col(0))),  # wraps int64
            ("sum", call("plus", col(1), col(4))),  # scale_by aligns the fracs
            ("avg", call("multiply", col(2), col(3))),  # f64 from int x real
            ("min", col(2)),
            ("max", col(3)),
            ("min", call("minus", col(1), const_decimal(5, 1)))]
    sel_rpns = [compile_expr(e, schema) for e in sel]
    agg_rpns = [(op, None if e is None else compile_expr(e, schema)) for op, e in aggs]
    prog = compile_program(sel_rpns, agg_rpns, [0, 1, 2, 3, 4], schema)
    shape = (n_blocks, block_rows)

    def ints(lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    def null_mask(p):
        return torch.rand(shape, generator=gen, device=device) < p

    cols = [ints(-(1 << 40), 1 << 40), ints(-10**9, 10**9),
            torch.rand(shape, generator=gen, device=device, dtype=torch.float64) * 1000.0,
            ints(0, 1000), ints(-10**6, 10**6)]
    nulls = [None, null_mask(0.1), null_mask(0.05), null_mask(0.2), None]
    nv = torch.full((n_blocks,), block_rows, dtype=torch.int64)
    nv[-1] = block_rows - 777
    if n_blocks > 4:
        nv[1] = 0
        nv[n_blocks // 2] = 0
    n_valids = nv.to(device) if n_blocks > 1 else int(nv[0])
    return prog, Image(cols, nulls, n_valids, n_blocks, block_rows, device)


#: the grouped synthetic cases: (id source, aggregates); all ten device
#: aggregates over int64, decimal and f64 lanes, or integer leaves only
GROUP_CASES = ("coded", "host", "host_many", "host_wide")


def synthetic_group_case(kind: str, n_blocks: int, block_rows: int, gen: torch.Generator,
                         device):
    """A grouped program, its image and its capacity, for holding the grouped
    kernels to their plain version.  ``kind``: ``"coded"`` — ids from two
    dictionary-code columns with NULLs (4 x 5 = 20 slots), all ten aggregates;
    ``"host"`` — 60 host group ids, all ten aggregates; ``"keyless"`` — no
    key and no host ids (one slot), all ten aggregates; ``"host_many"`` — 300
    host group ids, integer leaves only; ``"host_wide"`` — 3,000 host group
    ids, all ten aggregates, NaN, +-inf and +-0.0 among the REAL column's
    values (the last two past the shared-memory capacity, so the wide
    route).  Columns as :func:`synthetic_case`, with a ragged last block and
    (with more than four blocks) empty ones; f64 values are otherwise
    non-negative, so that sums taken in another order stay within a
    relative tolerance."""
    schema = [(EvalType.INT, 0), (EvalType.DECIMAL, 2), (EvalType.REAL, 0), (EvalType.INT, 0),
              (EvalType.DECIMAL, 4), (EvalType.BYTES, 0), (EvalType.BYTES, 0)]
    sel = [call("ge", col(0), const_int(-(1 << 38))),
           call("or", call("lt", col(2), const_real(900.0)), call("is_null", col(3))),
           call("ne", col(4), const_decimal(7, 1))]
    int_aggs = [("count", None),
                ("count", col(1)),
                ("sum", call("multiply", col(0), col(0))),  # wraps int64
                ("avg", call("plus", col(1), col(4))),  # scale_by aligns the fracs
                ("max", col(3)),
                ("min", call("minus", col(1), const_decimal(5, 1))),
                ("first", col(1)),
                ("bit_and", col(0)),
                ("bit_or", col(3)),
                ("bit_xor", col(1))]
    f64_aggs = [("sum", call("multiply", col(2), col(3))),  # f64 from int x real
                ("min", col(2)),
                ("max", col(2)),
                ("var_pop", col(3)),
                ("var_pop", col(2)),
                ("first", col(2))]
    aggs = int_aggs if kind == "host_many" else int_aggs[:6] + f64_aggs[:4] + int_aggs[6:] \
        + f64_aggs[4:]
    sel_rpns = [compile_expr(e, schema) for e in sel]
    agg_rpns = [(op, None if e is None else compile_expr(e, schema)) for op, e in aggs]
    dict_lens = (3, 4)
    coded = kind == "coded"
    ship = list(range(7 if coded else 5))
    keyless = kind == "keyless"
    prog = compile_group_program(sel_rpns, agg_rpns, ship, schema,
                                 (5, 6) if coded else () if keyless else None,
                                 dict_lens if coded else ())
    shape = (n_blocks, block_rows)

    def ints(lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    def null_mask(p):
        return torch.rand(shape, generator=gen, device=device) < p

    cols = [ints(-(1 << 40), 1 << 40), ints(-10**9, 10**9),
            torch.rand(shape, generator=gen, device=device, dtype=torch.float64) * 1000.0,
            ints(0, 1000), ints(-10**6, 10**6)]
    nulls = [None, null_mask(0.1), null_mask(0.05), null_mask(0.2), None]
    if kind == "host_wide":
        u = torch.rand(shape, generator=gen, device=device)
        special = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0],
                               dtype=torch.float64, device=device)
        pick = torch.randint(0, 5, shape, generator=gen, device=device)
        cols[2] = torch.where(u > 0.95, special[pick], cols[2])
    gids = None
    if coded:
        cols += [ints(0, dict_lens[0]), ints(0, dict_lens[1])]
        nulls += [null_mask(0.1), null_mask(0.05)]
        capacity = 32
    elif keyless:
        capacity = 1
    else:
        n_groups, capacity = {"host_many": (300, 512), "host_wide": (3000, 4096)}.get(kind,
                                                                                   (60, 64))
        gids = ints(0, n_groups).to(torch.int32)
    nv = torch.full((n_blocks,), block_rows, dtype=torch.int64)
    nv[-1] = block_rows - 777
    if n_blocks > 4:
        nv[1] = 0
        nv[n_blocks // 2] = 0
    if n_blocks > 1:
        n_valids = nv.to(device)
        offsets = (torch.cumsum(nv, 0) - nv).to(device)
    else:
        n_valids, offsets = int(nv[0]), 1000
    img = Image(cols, nulls, n_valids, n_blocks, block_rows, device, offsets, gids)
    return prog, img, capacity


#: fused_group_agg_partials' edge cases (:func:`group_edge_cases`)
GROUP_EDGE_CASES = ("host_past_c", "coded_ragged", "keyless", "mixed", "mixed_encoded")


def group_edge_cases(device, names=GROUP_EDGE_CASES, seed: int = 0) -> dict:
    """``name -> (prog, img, capacity)`` for holding the shared-memory
    grouped kernel to its plain version at its edges: ``host_past_c`` —
    host ids from -2 to 71 into 64 slots (the rest drop); ``coded_ragged``
    — ids from two dictionary-code columns; ``keyless`` — one slot, no key;
    each of these over 3 blocks of 1,001 rows (a short last tile a block)
    with 1,001, 999 and 530 valid rows (999 and 530 cut a tile);
    ``mixed`` and ``mixed_encoded`` — :func:`mixed_dag`'s leaf kinds
    (var_pop, first, bit_and, bit_or, min, max) grouped by
    l_returnflag's codes over 5 blocks of 4,096 lineitem rows, plain and
    encoded in place (``encoding.encode_blocks``: narrowed codes and
    bitpacked lanes)."""
    from .copr.dag_wire import dag_to_wire
    from .copr.torch_eval import TorchDagEvaluator, _capacity_for

    out = {}
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    nv = torch.tensor([1001, 999, 530], dtype=torch.int64)
    for name, kind in (("host_past_c", "host"), ("coded_ragged", "coded"), ("keyless", "keyless")):
        if name not in names:
            continue
        prog, img, cap = synthetic_group_case(kind, 3, 1001, gen, device)
        img.n_valids = nv.to(device)
        img.offsets = (torch.cumsum(nv, 0) - nv).to(device)
        if name == "host_past_c":
            img.gids = torch.randint(-2, cap + 8, (3, 1001), generator=gen, device=device,
                                     dtype=torch.int64).to(torch.int32)
        out[name] = (prog, img, cap)
    for name in ("mixed", "mixed_encoded"):
        if name not in names:
            continue
        cache = build_cache(5 * 4096 - 123, 4096, seed + 5, encode=name == "mixed_encoded")
        ev = TorchDagEvaluator(dag_to_wire(mixed_dag()), block_rows=4096, device=device)
        group_cols, dicts = ev._stable_dict_group_cols(cache.blocks)
        dict_lens = tuple(len(d) for d in dicts)
        prog = ev._coded_program(group_cols, dict_lens)
        img = ev._stacked_device(cache, ev._ship_cols(group_cols))
        cap = _capacity_for(prog, 1, int(np.prod([dl + 1 for dl in dict_lens])))
        out[name] = (prog, img, cap)
    return out


def group_partials_check(prog, img: Image, capacity: int, rel_tol: float = 1e-12) -> dict:
    """``fused_group_agg_partials`` on a CUDA image (``capacity`` within
    ``c_max``) beside ``partials_plain`` at the kernel's grid and tile
    assignment on the same tensors: integer words equal, f64 leaves to
    ``rel_tol``; two runs bit-identical; the combine over the kernel's
    partials against ``combine_plain``.  Raises on a difference; returns the
    largest absolute f64 error, the instance and the grid."""
    from .copr import fused_group_agg as ga

    runs = []
    for _ in range(2):
        parts = ga.new_partials(prog, img, capacity)
        ga.launch_partials(prog, img, capacity, parts)
        runs.append(parts)
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("fused_group_agg_partials: two runs differ")
    got = runs[0]
    want = ga.partials_plain(prog, img, capacity, ga.launch_grid(img), ga.ROWS)
    err = 0.0
    for l, leaf in enumerate(prog.leaves):
        g, w = got[:, l], want[:, l]
        if leaf.is_f64:
            err = max(err, _f64_err(g.view(torch.float64), w.view(torch.float64), rel_tol,
                                    f"partials leaf {l}"))
        elif not torch.equal(g, w):
            raise AssertionError(f"fused_group_agg_partials leaf {l}: integer words differ")
    out = (torch.empty((prog.n_int, capacity), dtype=torch.int64, device=img.device),
           torch.empty((prog.n_f64, capacity), dtype=torch.float64, device=img.device))
    ga.launch_combine(prog, img, capacity, got, None, out)
    wi, wf = ga.combine_plain(prog, img, capacity, got)
    if not torch.equal(out[0], wi):
        raise AssertionError("fused_group_agg_combine_pack: integer words differ")
    err = max(err, _f64_err(out[1], wf, rel_tol, "fused_group_agg_combine_pack"))
    return {"max_abs_err": err, "slots": ga.partials_slots(prog), "grid": ga.launch_grid(img)}


def deep_expr(cols, depth: int):
    """An INT sum over the schema's INT columns ``cols`` whose RPN holds
    ``depth`` (at least 2) operands at once: ``c + (c' + (... + c''))``,
    wrapping as int64; it picks the partials kernels' instance of the
    fewest of 2, 4 or 8 stack slots that hold ``depth``."""
    e = call("plus", col(cols[0]), col(cols[1 % len(cols)]))
    for i in range(depth - 2):
        e = call("plus", col(cols[(i + 2) % len(cols)]), e)
    return e


#: the depth of the plan each instance of the tile-walk partials kernels
#: runs (2, 4 and 8 stack slots)
INSTANCE_DEPTHS = {2: 2, 4: 4, 8: 7}

#: edge cases of the capacity-1 partials (:func:`agg_edge_cases`)
AGG_EDGE_CASES = tuple(f"{shape}_s{d}" for shape in ("ragged", "encoded") for d in (2, 4, 8)) \
    + ("date_sorted", "date_sorted_encoded")

#: edge cases of the wide route (:func:`wide_edge_cases`)
WIDE_EDGE_CASES = tuple(f"{shape}_s{d}" for shape in ("ragged", "encoded") for d in (2, 4, 8)) \
    + ("date_sorted", "hot")

_EDGE_SCHEMA = [(EvalType.INT, 0), (EvalType.DECIMAL, 2), (EvalType.REAL, 0), (EvalType.INT, 0),
                (EvalType.DECIMAL, 4)]
_ENC_SCHEMA = [(EvalType.INT, 0)] * 6 + [(EvalType.REAL, 0)]
_ENC_FRAME = (1 << 62) - 12345


def _edge_columns(shape_name: str, rng, dev):
    """The image of an edge case, ``(schema, image)`` drawn with numpy:
    ``ragged`` — :func:`synthetic_case`'s five columns over 3 blocks of
    1,001 rows (a short last tile a block) with 1,001, 998 and 5 valid rows;
    ``encoded`` — int8, int16 and int32 bitpack lanes, int8 and int16 codes,
    runs with run-shaped NULLs and a REAL column over 3 blocks of 1,003 rows
    with 1,003, 1,000 and 17 valid.  The REAL column holds NaN, +-inf and
    +-0.0 among non-negative values."""
    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def real(shape):
        x = rng.random(shape) * 1000.0
        special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0])
        return np.where(rng.random(shape) < 0.03, special[rng.integers(0, 5, shape)], x)

    if shape_name == "ragged":
        n_blocks, br, nv = 3, 1001, [1001, 998, 5]
        shape = (n_blocks, br)
        cols = [rng.integers(-(1 << 40), 1 << 40, shape), rng.integers(-10**9, 10**9, shape),
                real(shape), rng.integers(0, 1000, shape), rng.integers(-10**6, 10**6, shape)]
        nulls = [None, rng.random(shape) < 0.1, rng.random(shape) < 0.05,
                 rng.random(shape) < 0.2, None]
        img = Image([t(x) for x in cols], [t(m) for m in nulls],
                    t(np.asarray(nv, dtype=np.int64)), n_blocks, br, dev)
        return _EDGE_SCHEMA, img
    n_blocks, br, nv = 3, 1003, [1003, 1000, 17]
    kinds = [("bp", np.int8, "rows"), ("bp", np.int16, None), ("bp", np.int32, "rows"),
             ("code", np.int8, None), ("code", np.int16, "rows"), ("rle", np.int64, "runs")]
    cols, nulls, descs, refs = [], [], [], []
    for j, (kind, lane, nl) in enumerate(kinds):
        desc, payload, null_arr, ref = synthetic_encoded_column(
            kind, lane, nl, n_blocks, br, seed=int(rng.integers(1 << 30)) + j)
        cols.append(tuple(t(x) for x in payload) if kind == "rle" else t(payload))
        nulls.append(t(null_arr))
        descs.append(desc)
        refs.append(ref)
    cols.append(t(real((n_blocks, br))))
    nulls.append(t(rng.random((n_blocks, br)) < 0.1))
    descs.append(("plain",))
    refs.append(0)
    return _ENC_SCHEMA, Image(cols, nulls, t(np.asarray(nv, dtype=np.int64)), n_blocks, br, dev,
                              descs=tuple(descs), refs=tuple(refs))


def _edge_plan(shape_name: str, depth: int, grouped: bool):
    """The conjuncts and aggregates of an edge case over its schema: every
    aggregate of the capacity-1 pair (``grouped``: all ten device
    aggregates), int64, decimal and f64 lanes, and one INT sum
    :func:`deep_expr` ``depth`` operands deep."""
    if shape_name == "ragged":
        sel = [call("ge", col(0), const_int(-(1 << 38))),
               call("or", call("lt", col(2), const_real(900.0)), call("is_null", col(3))),
               call("ne", col(4), const_decimal(7, 1))]
        aggs = [("count", None), ("count", col(1)), ("sum", call("multiply", col(0), col(0))),
                ("sum", call("plus", col(1), col(4))), ("avg", call("multiply", col(2), col(3))),
                ("min", col(2)), ("max", col(2)),
                ("min", call("minus", col(1), const_decimal(5, 1)))]
        # grouped: the other five device aggregates, at most 16 in all
        more = [("first", col(1)), ("bit_and", col(0)), ("bit_or", col(3)), ("bit_xor", col(1)),
                ("var_pop", col(3)), ("var_pop", col(2)), ("first", col(2))]
        if not grouped:
            aggs += [("max", col(3)), ("sum", col(2))]
        ints = [0, 3]
    else:
        sel = [call("ge", col(0), const_int(_ENC_FRAME)), call("le", col(4), const_int(1))]
        aggs = [("count", None), ("sum", col(0)), ("min", col(1)), ("max", col(2)),
                ("sum", col(3)), ("count", col(5)), ("min", col(5)), ("max", col(4)),
                ("sum", col(6)), ("min", col(6)), ("max", col(6))]
        more = [("first", col(5)), ("bit_xor", col(2)), ("var_pop", col(6)), ("first", col(6))]
        ints = [0, 1, 2, 3, 4, 5]
    if grouped:
        aggs = aggs + more
    if depth > 2:
        aggs = aggs + [("sum", deep_expr(ints, depth))]
    return sel, aggs


def _compiled(schema, sel, aggs):
    return ([compile_expr(e, schema) for e in sel],
            [(op, None if e is None else compile_expr(e, schema)) for op, e in aggs])


def _date_sorted_q6(device, encode: bool, seed: int):
    """Q6's evaluator and its stacked image over 24 blocks of 4,096 lineitem
    rows loaded in date order (zone maps prune all but the blocks of Q6's
    year: those ship n_valid 0), plain or encoded (l_shipdate as runs)."""
    from .copr.dag_wire import dag_to_wire
    from .copr.torch_eval import TorchDagEvaluator

    br = 4096
    n = 24 * br
    cache = build_cache(n, br, seed, arrays=sort_by_shipdate(build_arrays(n, seed)),
                        encode=encode)
    ev = TorchDagEvaluator(dag_to_wire(q6_dag()), block_rows=br, device=device)
    img = ev._stacked_device(cache, keep=ev._prune_keep(cache))
    return ev, img


def agg_edge_cases(device, names=AGG_EDGE_CASES, seed: int = 0) -> dict:
    """``name -> (prog, img)`` for holding ``fused_agg_partials`` to its
    plain version at its edges, each instance (``_s2``, ``_s4``, ``_s8``:
    the plan's depth picks 2, 4 or 8 stack slots) on a ``ragged`` and an
    ``encoded`` image (:func:`_edge_columns`: n_valid not a multiple of 4,
    short last tiles, bitpack lanes, narrowed codes, runs, NaN and +-inf);
    ``date_sorted`` and ``date_sorted_encoded``: Q6 over date-ordered
    lineitem blocks that zone maps prune (:func:`_date_sorted_q6`)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 31)
    out = {}
    for name in names:
        if name.startswith("date_sorted"):
            ev, img = _date_sorted_q6(dev, name.endswith("encoded"), seed + 3)
            out[name] = (ev.program, img)
            continue
        shape_name, slots = name.rsplit("_s", 1)
        schema, img = _edge_columns(shape_name, rng, dev)
        sel, aggs = _compiled(schema, *_edge_plan(shape_name, INSTANCE_DEPTHS[int(slots)], False))
        out[name] = (compile_program(sel, aggs, list(range(len(schema))), schema), img)
    return out


def wide_edge_cases(device, names=WIDE_EDGE_CASES, seed: int = 0) -> dict:
    """``name -> (prog, img, capacity)`` for holding the wide route to its
    plain versions at its edges, past ``c_max``: each instance (``_s2``,
    ``_s4``, ``_s8``) over a ``ragged`` image (host ids from -2 to past C,
    the tracker and ``first``) and an ``encoded`` one (ids from two
    narrowed code columns, NULL codes among them); ``date_sorted``: Q6's
    selection and sum with the tracker over date-ordered encoded blocks that
    zone maps prune, host ids; ``hot``: every row of the ragged image's
    columns over 24 full blocks in one slot, all ten aggregates (one cell
    takes every atomic and every exact f64 add)."""
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 37)
    out = {}

    def host_ids(shape, lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)).to(dev)

    for name in names:
        if name == "date_sorted":
            ev, img = _date_sorted_q6(dev, True, seed + 5)
            plan = ev.plan
            prog = compile_group_program(plan.sel_rpns, plan.agg_rpns, plan.device_cols,
                                         plan.schema, None)
            cap = prog.c_max + 1
            img.gids = host_ids((img.n_blocks, img.block_rows), 0, cap)
            img.offsets = torch.arange(img.n_blocks, dtype=torch.int64, device=dev) \
                * img.block_rows
            out[name] = (prog, img, cap)
            continue
        shape_name, slots = ("ragged", "8") if name == "hot" else name.rsplit("_s", 1)
        schema, img = _edge_columns(shape_name, rng, dev)
        sel, aggs = _compiled(schema, *_edge_plan(shape_name, INSTANCE_DEPTHS[int(slots)], True))
        coded = shape_name == "encoded"
        prog = compile_group_program(sel, aggs, list(range(len(schema))), schema,
                                     (3, 4) if coded else None, (3, 3) if coded else ())
        cap = prog.c_max + 1 if coded else 4 * prog.c_max
        shape = (img.n_blocks, img.block_rows)
        if name == "hot":
            n_blocks = 8 * img.n_blocks
            img = Image([torch.cat([c] * 8) for c in img.cols],
                        [None if m is None else torch.cat([m] * 8) for m in img.nulls],
                        torch.full((n_blocks,), img.block_rows, dtype=torch.int64, device=dev),
                        n_blocks, img.block_rows, dev)
            img.gids = torch.full((n_blocks, img.block_rows), cap - 1, dtype=torch.int32,
                                  device=dev)
        elif not coded:
            img.gids = host_ids(shape, -2, cap + 8)
        img.offsets = torch.cumsum(img.n_valids, 0) - img.n_valids
        out[name] = (prog, img, cap)
    return out


def agg_partials_check(prog, img: Image, rel_tol: float = 1e-12) -> dict:
    """``fused_agg_partials`` on a CUDA image beside ``partials_plain`` at
    the kernel's grid and tile assignment on the same tensors: counts and
    integer values equal, f64 values to ``rel_tol`` (NaN equal to NaN); two
    runs bit-identical; the combine over the kernel's partials against
    ``combine_plain`` and the pair against ``fused_agg_plain``.  Raises on a
    difference; returns the largest absolute f64 error, the instance and
    the grid."""
    from .copr import fused_agg as fa

    runs = []
    for _ in range(2):
        scratch = fa.new_scratch(prog, img)
        fa.launch_partials(prog, img, scratch)
        runs.append(scratch)
    if not torch.equal(runs[0], runs[1]):
        raise AssertionError("fused_agg_partials: two runs differ")
    got, want = runs[0], fa.partials_plain(prog, img)
    err = 0.0
    for k, leaf in enumerate(prog.aggs):
        if not torch.equal(got[:, k, 0], want[:, k, 0]):
            raise AssertionError(f"fused_agg_partials aggregate {k}: counts differ")
        if leaf.kind == fa.AGG_COUNT:
            continue
        if leaf.is_f64:
            err = max(err, _f64_err(got[:, k, 1].view(torch.float64),
                                    want[:, k, 1].view(torch.float64), rel_tol,
                                    f"partials aggregate {k}"))
        elif not torch.equal(got[:, k, 1], want[:, k, 1]):
            raise AssertionError(f"fused_agg_partials aggregate {k}: integer values differ")
    out = (torch.empty((prog.n_int, 1), dtype=torch.int64, device=img.device),
           torch.empty((prog.n_f64, 1), dtype=torch.float64, device=img.device))
    fa.launch_combine(prog, got, None, out)
    for (gi, gf), (wi, wf), what in ((out, fa.combine_plain(prog, got), "combine"),
                                     (fa.fused_agg(prog, img), fa.fused_agg_plain(prog, img),
                                      "pair")):
        if not torch.equal(gi, wi):
            raise AssertionError(f"fused_agg {what}: integer leaves differ")
        err = max(err, _f64_err(gf, wf, rel_tol, f"fused_agg {what}"))
    return {"max_abs_err": err, "slots": fa.partials_slots(prog), "grid": fa.launch_grid(img)}


def synthetic_mask_case(n_blocks: int, block_rows: int, gen: torch.Generator, device):
    """A mask program and its image for holding the mask kernel to its plain
    version: :func:`synthetic_case`'s columns and conjuncts."""
    from .copr.fused_mask import compile_mask_program

    schema = [(EvalType.INT, 0), (EvalType.DECIMAL, 2), (EvalType.REAL, 0), (EvalType.INT, 0),
              (EvalType.DECIMAL, 4)]
    sel = [call("ge", col(0), const_int(-(1 << 38))),
           call("or", call("lt", col(2), const_real(900.0)), call("is_null", col(3))),
           call("ne", col(4), const_decimal(7, 1))]
    prog = compile_mask_program([compile_expr(e, schema) for e in sel], [0, 1, 2, 3, 4], schema)
    _p, img = synthetic_case(n_blocks, block_rows, gen, device)
    return prog, img


def every_op_selection(call, col, const_int, const_decimal, const_real, cols=(0, 1, 2)) -> list:
    """Conjuncts over an INT, a DECIMAL(2) and a REAL column (schema indices
    ``cols``) that reach every opcode a mask program holds (all but the
    aggregate and sort-key ones), with int, decimal and f64 operands mixed,
    decimal rescales and NULL constants, and a sum whose eight operands fill
    the stack to its ``MAX_STACK`` slots.  The expression builders are passed
    in, so that the JAX package's tests build the same conjuncts."""
    def a():
        return col(cols[0])

    def b():
        return col(cols[1])

    def c():
        return col(cols[2])

    chain = [a, b, c, a, b, c, a, b]
    deep = call("plus", chain[-2](), chain[-1]())
    for operand in reversed(chain[:-2]):
        deep = call("plus", operand(), deep)
    return [
        call("or", call("lt", deep, const_real(50.0)), call("is_null", c())),
        call("or", call("xor", call("is_true", a()), call("is_false", c())),
             call("not", call("eq", b(), const_decimal(150, 2)))),
        call("or", call("ge", call("abs", call("unary_minus", a())), const_int(5)),
             call("and", call("is_not_null", b()), call("lt", a(), const_int(None)))),
        call("or", call("ne", call("bit_and", call("bit_or", a(), const_int(3)),
                                   call("bit_neg", call("bit_xor", a(), const_int(7)))),
                        const_int(0)),
             call("gt", call("multiply", c(), a()), const_real(1.0))),
        call("or", call("le", call("minus", b(), a()), const_decimal(-100, 2)),
             call("ge", c(), const_real(None))),
    ]


def mask_edge_cases(device, seed: int = 0) -> dict:
    """Mask programs and images at the mask kernel's edges, name -> ``(prog,
    img)``, drawn with numpy from ``seed``: ``ragged`` (1,001-row blocks,
    n_valid not a multiple of a tile), ``view`` (its blocks 1-2: a base
    8 bytes past 16-byte alignment), ``conjuncts`` and ``conjuncts_view``
    (the same images under a plan whose every conjunct compares a column
    with a constant, each evaluated in one step), ``small`` (13-row blocks, one empty),
    ``encoded`` (int8, int16 and int32 bitpack lanes, int8 and int16 codes,
    runs with run-shaped NULLs, a REAL column; 1,003-row blocks),
    ``encoded_view`` (its blocks 1-2) and ``every_op``
    (:func:`every_op_selection`, a stack 8 deep, 4,099-row blocks)."""
    from .copr.fused_mask import compile_mask_program

    rng = np.random.default_rng(seed)
    dev = torch.device(device)

    def t(x):
        return None if x is None else torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def valids(nv):
        return t(np.asarray(nv, dtype=np.int64))

    out = {}
    mask_schema = [(EvalType.INT, 0), (EvalType.DECIMAL, 2), (EvalType.REAL, 0),
                   (EvalType.INT, 0), (EvalType.DECIMAL, 4)]
    # column <cmp> constant conjuncts as the kernel fuses them: int, a
    # rescaled constant, a rescaled column, a REAL column against an INT
    mask_sel = [call("ge", col(0), const_int(-(1 << 38))),
                call("or", call("lt", col(2), const_real(900.0)), call("is_null", col(3))),
                call("ne", col(4), const_decimal(7, 1)),
                call("lt", col(1), const_decimal(123_456_789, 4)),
                call("gt", col(2), const_int(5))]
    mask_prog = compile_mask_program([compile_expr(e, mask_schema) for e in mask_sel],
                                     [0, 1, 2, 3, 4], mask_schema)
    for name, n_blocks, br, nv in (("ragged", 3, 1001, [1001, 998, 5]),
                                   ("small", 4, 13, [13, 6, 0, 1])):
        shape = (n_blocks, br)
        cols = [rng.integers(-(1 << 40), 1 << 40, shape), rng.integers(-10**9, 10**9, shape),
                rng.random(shape) * 1000.0, rng.integers(0, 1000, shape),
                rng.integers(-10**6, 10**6, shape)]
        nulls = [None, rng.random(shape) < 0.1, rng.random(shape) < 0.05,
                 rng.random(shape) < 0.2, None]
        out[name] = (mask_prog, Image([t(x) for x in cols], [t(m) for m in nulls], valids(nv),
                                      n_blocks, br, dev))
    out["view"] = (mask_prog, out["ragged"][1].blocks(1, 3))
    # every conjunct a column against a constant: each one a single step
    conj_sel = [call("ge", col(0), const_int(-(1 << 38))),
                call("le", col(1), const_decimal(123_456_789, 4)),
                call("ne", col(4), const_decimal(7, 1)),
                call("lt", col(2), const_real(900.0)),
                call("gt", col(2), const_int(5)),
                call("ne", col(3), const_int(500))]
    conj_prog = compile_mask_program([compile_expr(e, mask_schema) for e in conj_sel],
                                     [0, 1, 2, 3, 4], mask_schema)
    out["conjuncts"] = (conj_prog, out["ragged"][1])
    out["conjuncts_view"] = (conj_prog, out["view"][1])

    n_blocks, br = 3, 1003
    kinds = [("bp", np.int8, "rows"), ("bp", np.int16, None), ("bp", np.int32, "rows"),
             ("code", np.int8, None), ("code", np.int16, "rows"), ("rle", np.int64, "runs")]
    cols, nulls, descs, refs = [], [], [], []
    for j, (kind, lane, nl) in enumerate(kinds):
        desc, payload, null_arr, ref = synthetic_encoded_column(kind, lane, nl, n_blocks, br,
                                                                seed=seed + j)
        cols.append(tuple(t(x) for x in payload) if kind == "rle" else t(payload))
        nulls.append(t(null_arr))
        descs.append(desc)
        refs.append(ref)
    shape = (n_blocks, br)
    cols.append(t(rng.random(shape)))
    nulls.append(t(rng.random(shape) < 0.1))
    descs.append(("plain",))
    refs.append(0)
    enc_schema = [(EvalType.INT, 0)] * 6 + [(EvalType.REAL, 0)]
    frame = (1 << 62) - 12345
    enc_sel = [call("or", call("ge", col(0), const_int(frame)), call("lt", col(1), const_int(frame))),
               call("or", call("ne", col(2), const_int(frame)), call("eq", col(3), const_int(1))),
               call("or", call("le", col(4), const_int(1)), call("is_null", col(5))),
               call("or", call("gt", col(5), const_int(0)), call("lt", col(6), const_real(0.5)))]
    enc_prog = compile_mask_program([compile_expr(e, enc_schema) for e in enc_sel],
                                    list(range(7)), enc_schema)
    enc = Image(cols, nulls, valids([br, br - 3, 17]), n_blocks, br, dev, descs=tuple(descs),
                refs=tuple(refs))
    out["encoded"] = (enc_prog, enc)
    out["encoded_view"] = (enc_prog, enc.blocks(1, 3))

    n_blocks, br = 2, 4099
    shape = (n_blocks, br)
    op_schema = [(EvalType.INT, 0), (EvalType.DECIMAL, 2), (EvalType.REAL, 0)]
    op_prog = compile_mask_program(
        [compile_expr(e, op_schema)
         for e in every_op_selection(call, col, const_int, const_decimal, const_real)],
        [0, 1, 2], op_schema)
    cols = [rng.integers(-60, 60, shape), rng.integers(-10**4, 10**4, shape),
            rng.normal(size=shape)]
    out["every_op"] = (op_prog, Image([t(x) for x in cols],
                                      [t(rng.random(shape) < 0.2) for _ in cols],
                                      valids([br, 2049]), n_blocks, br, dev))
    return out


def synthetic_topn_case(n_blocks: int, block_rows: int, k: int, gen: torch.Generator, device):
    """A top-K program over four nullable columns and its images (candidate
    columns, payload columns) for holding the top-K kernels to their plain
    versions: an INT key with many ties and NULLs ascending, a REAL key
    descending over a few values with -0.0, +0.0, +-inf and NULLs, a DECIMAL
    key, a selection, a ragged last block and (with more than four blocks)
    empty blocks."""
    from .copr.fused_topn import compile_topn_program

    schema = [(EvalType.INT, 0), (EvalType.REAL, 0), (EvalType.DECIMAL, 2), (EvalType.INT, 0)]
    sel = [compile_expr(call("or", call("gt", col(3), const_int(-500)), call("is_null", col(3))),
                        schema)]
    keys = [(compile_expr(col(0), schema), False), (compile_expr(col(1), schema), True),
            (compile_expr(col(2), schema), False)]
    prog = compile_topn_program(sel, keys, [0, 1, 2, 3], schema, [0, 1, 2, 3], k)
    shape = (n_blocks, block_rows)

    def ints(lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    def null_mask(p):
        return torch.rand(shape, generator=gen, device=device) < p

    reals = torch.tensor([-0.0, 0.0, float("inf"), float("-inf"), 1.5, -2.25, 1e308],
                         dtype=torch.float64, device=device)
    cols = [ints(-20, 20), reals[ints(0, len(reals))], ints(-3, 3), ints(-1000, 1000)]
    nulls = [null_mask(0.1), null_mask(0.1), None, null_mask(0.05)]
    nv = torch.full((n_blocks,), block_rows, dtype=torch.int64)
    nv[-1] = block_rows - 777
    if n_blocks > 4:
        nv[1] = 0
        nv[n_blocks // 2] = 0
    n_valids = nv.to(device) if n_blocks > 1 else int(nv[0])
    img = Image(cols, nulls, n_valids, n_blocks, block_rows, device)
    return prog, img, img


#: the top-K edge cases of :func:`topn_edge_case`
TOPN_EDGE_CASES = ("few_pass", "none_pass", "all_tied", "nulls", "zeros", "k1", "k_limit",
                   "ragged")


def topn_edge_case(name: str, device, seed: int = 0):
    """``(prog, image)`` of one top-K edge case for holding
    ``topn_candidates`` to its plain version (the image serves as the
    candidate and the payload columns).  Columns: an INT key (NULLs), a REAL
    key (NULLs), an INT column the selection reads.  ``few_pass``: about 9
    rows a 4,096-row tile pass the selection (K = 100), so a run is filled
    with rank-1 entries; ``none_pass``: none pass; ``all_tied``: both keys
    constant, so src alone orders; ``nulls``: 60% NULL keys, the INT one
    ascending and the REAL one descending; ``zeros``: REAL keys of -0.0 and
    +0.0 only, ascending then descending; ``k1`` and ``k_limit``: K = 1 and
    K = the tile; ``ragged``: blocks of 1,001 rows (a thread's rows cross
    from one block into the next), the last block short of its rows and the
    last tile short of the image."""
    from .copr.fused_topn import compile_topn_program, tile_rows

    rng = np.random.default_rng(seed)
    n_blocks, block_rows = (7, 1001) if name == "ragged" else (3, 5000)
    shape = (n_blocks, block_rows)
    schema = [(EvalType.INT, 0), (EvalType.REAL, 0), (EvalType.INT, 0)]
    lo = {"few_pass": 990, "none_pass": 5000}.get(name, -500)
    sel = [compile_expr(call("gt", col(2), const_int(lo)), schema)]
    a = rng.integers(-20, 20, shape)
    b = np.array([-0.0, 0.0, float("inf"), 1.5, -2.25])[rng.integers(0, 5, shape)]
    null_p = 0.6 if name == "nulls" else 0.1
    if name == "all_tied":
        a, b, null_p = np.full(shape, 7), np.full(shape, 1.5), 0.0
    if name == "zeros":
        a, b = (np.where(rng.integers(0, 2, shape) == 1, 0.0, -0.0) for _ in range(2))
        schema[0] = (EvalType.REAL, 0)
    keys = [(compile_expr(col(0), schema), name == "zeros"),
            (compile_expr(col(1), schema), name != "zeros")]
    k = {"k1": 1, "k_limit": tile_rows(2 + 2 * len(keys))}.get(name, 100)
    prog = compile_topn_program(sel, keys, [0, 1, 2], schema, [0, 1, 2], k)
    nulls = [torch.from_numpy(rng.random(shape) < null_p).to(device) for _ in range(2)]
    cols = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (a, b, rng.integers(-1000, 1000, shape))]
    nv = torch.full((n_blocks,), block_rows, dtype=torch.int64)
    nv[-1] = block_rows - 123
    img = Image(cols, nulls + [None], nv.to(device), n_blocks, block_rows, device)
    return prog, img


#: the dict_keys edge cases of :func:`key_edge_case`: the stack slots of
#: the instance each runs and whether its range flag ends set
KEY_EDGE_CASES = {
    "ragged_s2": (2, True), "ragged_s4": (4, True), "ragged_s8": (8, True),
    "ragged_in_range": (2, False),
    "encoded_s2": (2, False), "encoded_s4": (4, False), "encoded_s8": (8, False),
    "encoded_out_of_range": (2, True),
}


def key_edge_case(name: str, device, seed: int = 0):
    """``(prog, image)`` of one ``dict_keys`` edge case at 20 bits a key
    (:data:`KEY_EDGE_CASES`), over :func:`_edge_columns`' images.
    ``ragged_s*``: blocks of 1,001 rows (not a multiple of a thread's
    tile) with 1,001, 998 and 5 valid rows; keys: a nullable INT column, a
    nullable REAL column with NaN, +-inf and +-0.0 (selected -inf rows
    flag the range) and ``bit_and`` of an INT sum :func:`deep_expr` as
    deep as the instance (2, 4 or 8 slots) holds.  ``ragged_in_range``: the
    REAL key with a selection that drops its NaN and infinite rows (-0.0
    stays), so the flag stays clear.  ``encoded_s*``: blocks of 1,003 rows
    (1,003, 1,000 and 17 valid) of bitpack lanes, narrowed codes and runs
    with run-shaped NULLs; keys: a code column, a run column's low bits and
    the deep sum's, all in range.  ``encoded_out_of_range``: a code
    column, the run column's raw values (negative and past the lane) and the
    REAL column."""
    from .copr.fused_dict import compile_key_program

    dev = torch.device(device)
    rng = np.random.default_rng(seed + 41)
    shape_name = name.split("_", 1)[0]
    schema, img = _edge_columns(shape_name, rng, dev)
    slots = KEY_EDGE_CASES[name][0]
    low = [call("bit_and", deep_expr([0, 3] if shape_name == "ragged" else list(range(6)),
                                     INSTANCE_DEPTHS[slots]), const_int(1023))]
    if name == "ragged_in_range":
        sel = [call("ge", col(2), const_real(0.0)), call("lt", col(2), const_real(1000.0))]
        keys = [col(2), col(3), call("bit_and", col(0), const_int(1023))]
    elif shape_name == "ragged":
        sel = [call("or", call("lt", col(2), const_real(900.0)), call("is_null", col(3)))]
        keys = [col(3), col(2)] + low
    elif name == "encoded_out_of_range":
        sel = [call("le", col(4), const_int(1))]
        keys = [col(3), col(5), col(6)]
    else:
        sel = [call("le", col(4), const_int(1))]
        keys = [col(3), call("bit_and", col(5), const_int(1023))] + low
    prog = compile_key_program([compile_expr(e, schema) for e in sel],
                               [compile_expr(e, schema) for e in keys],
                               list(range(len(schema))), schema, 20)
    return prog, img


def keys_kernel_check(prog, img: Image) -> dict:
    """``dict_keys`` on a CUDA image twice beside its plain version on a CPU
    copy: the keys and the range flag equal, the two runs bit-identical, and
    the instance the C launcher picks from the code the one
    ``fused_dict.key_slots`` names.  Raises on a difference; returns the
    flag, the instance's stack slots and the launches."""
    import ctypes

    from .copr import fused_agg as fa
    from .copr import fused_dict as fd

    dev = img.device
    runs = []
    before = fa.LAUNCHES["dict_keys"]
    for _ in range(2):
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        keys = fd.dict_keys(prog, img, flag)
        runs.append((keys.cpu(), int(flag.item())))
    launches = fa.LAUNCHES["dict_keys"] - before
    want, bad = fd.dict_keys_plain(prog, image_on(img, "cpu"))
    if not (torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]):
        raise AssertionError("dict_keys: two runs differ")
    if not torch.equal(runs[0][0], want):
        raise AssertionError("dict_keys: differs from its plain version")
    if runs[0][1] != (fd.FLAG_RANGE if bad else 0):
        raise AssertionError(f"dict_keys: flag {runs[0][1]}, plain version's range {bad}")
    slots = fd.key_slots(prog)
    scratch = torch.empty(1, dtype=torch.int64, device=dev)
    picked = fd.kernels().dk_slots(ctypes.byref(fd.key_params(prog, img, scratch, scratch)))
    if picked != slots:
        raise AssertionError(f"dict_keys: the launcher picks {picked} slots, key_slots {slots}")
    return {"flag": runs[0][1], "slots": slots, "launches": launches,
            "rows": img.n_blocks * img.block_rows}


#: the topn_pack edge cases of :func:`pack_edge_case`: (K, payload columns,
#: sort keys, encoded payload, a carry, the mesh finalize's [S, K] image)
PACK_EDGE_CASES = {
    "k1": (1, 5, 1, False, True, False),
    "k100": (100, 5, 2, False, True, False),
    "k2048": (2048, 5, 1, False, True, False),
    "pay0": (100, 0, 1, False, True, False),
    "pay16": (100, 16, 4, False, True, False),
    "no_carry": (100, 5, 2, False, False, False),
    "encoded": (100, 7, 1, True, True, False),
    "encoded_k2048": (2048, 7, 2, True, True, False),
    "finalize": (100, 5, 2, False, False, True),
}


def pack_edge_case(name: str, device, seed: int = 0):
    """``(prog, run, pay, carry, src_base)`` of one ``topn_pack`` edge case
    (:data:`PACK_EDGE_CASES`): a final run whose winners are mixed, rank 0
    from the carry's slots (below ``src_base`` = K) and from the payload
    image's flat rows, and rank 1 (no row); payload columns of INT, REAL
    (NaN, +-inf, -0.0 and +0.0 among them) and DECIMAL types, nullable,
    over 3 blocks of 5,000 rows; or the encoded image of
    :func:`_edge_columns` (bitpack lanes, narrowed codes, runs with
    run-shaped NULLs and a REAL column); the carry a packed state whose f64
    rows hold NaN and -0.0.  ``finalize``: the mesh finalize's shape, the 8
    shards' packed payload as one ``[8, K]`` image, no carry and
    ``src_base`` 0."""
    from .copr.fused_topn import compile_topn_program

    k, n_pay, n_keys, encoded, carried, finalize = PACK_EDGE_CASES[name]
    dev = torch.device(device)
    rng = np.random.default_rng(seed + 43)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def reals(shape):
        special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0])
        x = rng.normal(0, 1e6, shape)
        return np.where(rng.random(shape) < 0.2, special[rng.integers(0, 5, shape)], x)

    if encoded:
        schema, pay = _edge_columns("encoded", rng, dev)
    else:
        types = [(EvalType.INT, 0), (EvalType.REAL, 0), (EvalType.DECIMAL, 2)]
        schema = [types[j % 3] for j in range(max(n_pay, 1))]
        n_blocks, br = (8, k) if finalize else (3, 5000)
        shape = (n_blocks, br)
        cols, nulls = [], []
        for j in range(n_pay):
            cols.append(t(reals(shape)) if schema[j][0] == EvalType.REAL
                        else t(rng.integers(-(1 << 62), 1 << 62, shape)))
            nulls.append(None if j % 4 == 3 else t(rng.random(shape) < 0.15))
        nv = k if finalize else t(np.array([br, br - 17, 1234], dtype=np.int64))
        pay = Image(cols, nulls, nv, n_blocks, br, dev)
    key = compile_expr(col(0), schema)
    prog = compile_topn_program([], [(key, False)] * n_keys, [0], schema, list(range(n_pay)), k)
    n_flat = pay.n_blocks * pay.block_rows
    src_base = k if carried else 0
    # a third of the winners from the carry's slots, a half from the image,
    # the rest rank 1; src unique
    pick = rng.random(k)
    from_carry = carried & (pick < 1 / 3)
    live = from_carry | (pick < 5 / 6)
    run = np.zeros((prog.n_words, k), dtype=np.int64)
    run[0] = np.where(live, 0, 1)
    run[1:-1] = rng.integers(-(1 << 62), 1 << 62, (prog.n_words - 2, k))
    flat = rng.choice(n_flat, k, replace=False)
    run[-1] = np.where(from_carry, rng.permutation(k), src_base + flat)
    carry = None
    if carried:
        ints = rng.integers(-(1 << 62), 1 << 62, (prog.n_int, k))
        for r in prog.pay_null_row:
            ints[r] = rng.integers(0, 2, k)
        carry = (t(ints), t(reals((prog.n_f64, k))), t(run.copy()))
    return prog, t(run), pay, carry, src_base


def pack_kernel_check(prog, run: torch.Tensor, pay: Image, carry, src_base: int) -> dict:
    """``topn_pack`` on CUDA tensors twice beside its plain version on CPU
    copies: the packed ints, the f64 rows bit for bit and the next carry
    run equal, the two launches bit-identical.  Raises on a difference;
    returns the live winners, those from the carry and the launches."""
    from .copr import fused_agg as fa
    from .copr import fused_topn as ft

    dev, k = run.device, prog.k
    outs = []
    before = fa.LAUNCHES["topn_pack"]
    for _ in range(2):
        out = (torch.full((prog.n_int, k), -1, dtype=torch.int64, device=dev),
               torch.full((prog.n_f64, k), -1.0, dtype=torch.float64, device=dev))
        nxt = torch.full((prog.n_words, k), -1, dtype=torch.int64, device=dev)
        ft.launch_pack(prog, run, pay, carry, src_base, out, nxt)
        outs.append((out[0].cpu(), out[1].cpu().view(torch.int64), nxt.cpu()))
    launches = fa.LAUNCHES["topn_pack"] - before
    host = None if carry is None else tuple(x.cpu() for x in carry)
    want = ft.pack_plain(prog, run.cpu(), image_on(pay, "cpu"), host, src_base)
    want = (want[0], want[1].view(torch.int64), want[2])
    if not all(torch.equal(a, b) for a, b in zip(*outs)):
        raise AssertionError("topn_pack: two launches differ")
    for what, got, w in zip(("ints", "f64 rows", "next carry run"), outs[0], want):
        if not torch.equal(got, w):
            raise AssertionError(f"topn_pack: its {what} differ from the plain version")
    live = run[0].cpu() == 0
    return {"live": int(live.sum()), "from_carry": int((live & (run[-1].cpu() < src_base)).sum()),
            "launches": launches}


#: program #1's synthetic cases: (kind, lane dtype, null shape)
DECODE_CASES = (("bp", np.int8, "rows"), ("bp", np.int16, "rows"), ("bp", np.int32, "rows"),
                ("code", np.int8, "rows"), ("rle", np.int64, "runs"), ("rle", np.int64, "rows"),
                ("rle", np.int64, None))


def synthetic_encoded_column(kind: str, lane, nulls: str | None, n_blocks: int, block_rows: int,
                             seed: int = 0):
    """One column's encoded payload for holding program #1 to its plain
    version: ``(desc, payload, nulls, ref)`` as numpy arrays.  ``kind`` bp:
    lanes spanning ``lane``'s whole range and a frame near the int64 edge;
    code: codes 0..2; rle: runs of random lengths, the pad run at the end of
    each block and ``k_cap`` a power of two.  ``nulls``: "rows" (a row mask
    with NULL slots holding nonzero lanes), "runs" (one flag per run) or
    None (a NOT NULL column)."""
    rng = np.random.default_rng(seed)
    shape = (n_blocks, block_rows)
    if kind == "rle":
        k_cap = 1 << max(1, (block_rows // 64).bit_length() - 1)
        ends = np.full((n_blocks, k_cap), block_rows, dtype=np.int64)
        for b in range(n_blocks):
            # distinct ends; rows past the last fall in the pad run (values
            # 0, NULL where nulls are run-shaped)
            n_runs = int(rng.integers(1, k_cap + 1))
            ends[b, :n_runs] = np.sort(rng.choice(np.arange(1, block_rows + 1), n_runs,
                                                  replace=False))
        values = rng.integers(-(1 << 40), 1 << 40, (n_blocks, k_cap), dtype=np.int64)
        payload = (values, ends)
        desc, ref = ("rle", k_cap, np.dtype(lane).str), 0
        null_arr = (rng.random((n_blocks, k_cap)) < 0.2 if nulls == "runs"
                    else rng.random(shape) < 0.2 if nulls == "rows" else None)
        return desc, payload, null_arr, ref
    info = np.iinfo(lane)
    hi = 3 if kind == "code" else info.max
    payload = rng.integers(0 if kind == "code" else info.min, hi, shape, dtype=np.int64).astype(lane)
    ref = (1 << 62) - 12345 if kind == "bp" else 0
    null_arr = rng.random(shape) < 0.2 if nulls == "rows" else None
    return (kind, np.dtype(lane).str), payload, null_arr, ref


def warm_kernel_outputs(cache, block_rows: int, device) -> dict:
    """Each kernel of the warm main paths over ``cache``'s image, launched
    on the image the evaluator pins, beside its plain version on the same
    image: ``{kernel name: (kernel output, plain output)}``, each output a
    tuple of CPU tensors.  The plans: Q6 (``fused_agg`` pair), Q1 with ids
    from the dictionary codes (grouped pair), the selective filter
    (``fused_mask``) and the raw TopN of :func:`topn_dag` (candidates, one
    merge level, pack).  Over a plain and an encoded image of the same rows
    every output must be the same."""
    from .copr import fused_agg as fa
    from .copr import fused_group_agg as ga
    from .copr import fused_mask as fm
    from .copr import fused_topn as ft
    from .copr.dag_wire import dag_to_wire
    from .copr.torch_eval import TorchDagEvaluator, _capacity_for, _pick

    def ev(dag):
        return TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device=device)

    def cpu(*ts):
        return tuple(t.cpu() for t in ts)

    out = {}
    q6 = ev(q6_dag())
    prog, img = q6.program, q6._stacked_device(cache)
    scratch = fa.new_scratch(prog, img)
    fa.launch_partials(prog, img, scratch)
    out["fused_agg_partials"] = (cpu(scratch), cpu(fa.partials_plain(prog, img)))
    packed = (torch.empty((prog.n_int, 1), dtype=torch.int64, device=device),
              torch.empty((prog.n_f64, 1), dtype=torch.float64, device=device))
    fa.launch_combine(prog, scratch, None, packed)
    out["fused_agg_combine_pack"] = (cpu(*packed), cpu(*fa.combine_plain(prog, scratch)))
    del img, scratch

    q1 = ev(q1_dag())
    group_cols, dicts = q1._stable_dict_group_cols(cache.blocks)
    dict_lens = tuple(len(d) for d in dicts)
    prog = q1._coded_program(group_cols, dict_lens)
    img = q1._stacked_device(cache, q1._ship_cols(group_cols))
    cap = _capacity_for(prog, 1, int(np.prod([dl + 1 for dl in dict_lens])))
    parts = ga.new_partials(prog, img, cap)
    ga.launch_partials(prog, img, cap, parts)
    out["fused_group_agg_partials"] = (
        cpu(parts), cpu(ga.partials_plain(prog, img, cap, ga.launch_grid(img), ga.ROWS)))
    packed = (torch.empty((prog.n_int, cap), dtype=torch.int64, device=device),
              torch.empty((prog.n_f64, cap), dtype=torch.float64, device=device))
    ga.launch_combine(prog, img, cap, parts, None, packed)
    out["fused_group_agg_combine_pack"] = (cpu(*packed),
                                           cpu(*ga.combine_plain(prog, img, cap, parts)))
    del img, parts

    sel = ev(filter_dag("selective", None))
    img = sel._stacked_device(cache)
    out["fused_mask"] = (cpu(fm.fused_mask(sel.plan.mask_program, img)),
                         cpu(fm.fused_mask_plain(sel.plan.mask_program, img)))
    del img

    tn = ev(topn_dag(100))
    prog = tn.plan.topn_program
    payload = list(range(len(tn.plan.schema)))
    pay = tn._stacked_device(cache, payload)
    cand = _pick(pay, payload, tn.plan.device_cols)
    runs = torch.empty((ft.n_tiles(prog, cand), prog.n_words, prog.k), dtype=torch.int64,
                       device=device)
    ft.launch_candidates(prog, cand, runs, 0)
    want_runs = ft.candidates_plain(prog, cand, 0)
    out["topn_candidates"] = (cpu(runs), cpu(want_runs))
    f = (ft.merge_fans(runs.shape[0], prog.n_words, prog.k) or [2])[0]
    level = torch.empty((-(-runs.shape[0] // f), prog.n_words, prog.k), dtype=torch.int64,
                        device=device)
    ft.launch_merge(runs, None, level, f)
    out["topn_merge"] = (cpu(level), cpu(ft.merge_plain(want_runs, None, f)))
    run = ft._merge_all(runs, None, cuda=True)
    state = (torch.empty((prog.n_int, prog.k), dtype=torch.int64, device=device),
             torch.empty((prog.n_f64, prog.k), dtype=torch.float64, device=device))
    nxt = torch.empty((prog.n_words, prog.k), dtype=torch.int64, device=device)
    ft.launch_pack(prog, run, pay, None, 0, state, nxt)
    out["topn_pack"] = (cpu(*state, nxt), cpu(*ft.pack_plain(prog, run, pay, None, 0)))
    return out


# ---------------------------------------------------------------------------
# the zone rung
# ---------------------------------------------------------------------------

ZONE_TAGS = (b"ant", b"bee", b"cat", b"dog", b"eel")


def zone_schema() -> list[ColumnInfo]:
    """handle, v int (the range column), w int, tag varchar (the group
    key), d decimal(2); every column but the handle nullable."""
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.int64()),
            ColumnInfo(4, FieldType.varchar()),
            ColumnInfo(5, FieldType.decimal_type(2))]


def zone_dag() -> DagRequest:
    """A plan the zone rung serves that reaches every tile reduction: a
    range on v, GROUP BY tag, count/sum/min/max/avg/var_pop, over bare
    columns and over expressions of the null-safe functions."""
    arg = call("bit_xor", call("unary_minus", col(2)), call("abs", col(1)))
    aggs = [AggDescriptor("count", None), AggDescriptor("sum", col(2)),
            AggDescriptor("min", col(2)), AggDescriptor("max", arg),
            AggDescriptor("var_pop", col(2)), AggDescriptor("avg", col(4)),
            AggDescriptor("count", call("is_not_null", col(1))),
            AggDescriptor("sum", call("bit_and", call("bit_neg", col(2)), col(1)))]
    return DagRequest(executors=[TableScan(TABLE_ID, zone_schema()),
                                 Selection([call("ge", col(1), const_int(-2000)),
                                            call("le", col(1), const_int(3000))]),
                                 Aggregation([col(3)], aggs)])


def zone_bare_dag() -> DagRequest:
    """Q1's window and groups with every aggregate over a bare column, so
    the full-tile program takes no walk: sums, sums of squares, min, max
    and counts over lineitem's int8, int16 and int32 zone lanes."""
    aggs = [AggDescriptor("var_pop", col(1)), AggDescriptor("min", col(2)),
            AggDescriptor("max", col(2)), AggDescriptor("var_pop", col(3)),
            AggDescriptor("min", col(4)), AggDescriptor("max", col(1)),
            AggDescriptor("count", col(2)), AggDescriptor("sum", col(4))]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()),
                                 Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
                                 Aggregation([col(5), col(6)], aggs)])


def zone_cache(n: int, block_rows: int, seed: int = 0, null_p: float = 0.05):
    """A filled cache for :func:`zone_dag` from seeded draws: negative
    values, NULLs in v, w and the key (a fraction ``null_p`` of the first
    tenth of the rows, so the tiles they force partial stay a minority),
    the tags coded against one dictionary shared by every block."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-5000, 5000, n)
    w = rng.integers(-1000, 1000, n)
    tag = rng.integers(0, len(ZONE_TAGS), n)
    d = rng.integers(-100000, 100000, n)
    head = np.arange(n) < n // 10
    nulls = [head & (rng.random(n) < null_p) for _ in range(3)]
    dictionary = np.empty(len(ZONE_TAGS), dtype=object)
    dictionary[:] = list(ZONE_TAGS)
    handles = np.arange(n, dtype=np.int64)
    cache = ColumnBlockCache()
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        cache.add([
            Column(EvalType.INT, handles[s:e], nz),
            Column(EvalType.INT, np.where(nulls[0][s:e], 0, v[s:e]), nulls[0][s:e]),
            Column(EvalType.INT, np.where(nulls[1][s:e], 0, w[s:e]), nulls[1][s:e]),
            Column(EvalType.BYTES, np.where(nulls[2][s:e], 0, tag[s:e]), nulls[2][s:e], 0,
                   dictionary),
            Column(EvalType.DECIMAL, d[s:e], nz, 2),
        ], e - s)
    cache.filled = True
    return cache


def zone_kernel_outputs(ev, cache, tile_rows: int | None = None, max_tiles: int | None = None):
    """The three zone kernels over ``ev``'s layout of ``cache`` (at
    ``tile_rows`` rows a tile; the rung's default when None), each beside
    its plain version on the same tensors: ``({name: (kernel output, plain
    output)}, layout, full tile count, partial tile count)``.  With
    ``max_tiles``, each list is cut to its first ``max_tiles`` tiles.  The
    tile kernels record their rows in one map, as the rung's launch does;
    the fold's plain version folds the kernels' own partials through it."""
    from .copr import fused_zone as fz

    rung = ev._zone_rung()
    tiles = rung.plan_tiles(cache, tile_rows)
    if tiles is None:
        raise AssertionError(f"the zone rung declined: {ev.zone_stats.last_decline}")
    layout, full_idx, partial_idx = tiles
    if max_tiles is not None:
        full_idx, partial_idx = full_idx[:max_tiles], partial_idx[:max_tiles]
    full, part = rung.programs(layout)
    dev = ev.device
    n_leaves = len(full.prog.leaves)
    row_of = torch.empty(layout.n_tiles, dtype=torch.int32, device=dev)
    out = {}
    lists = []
    for name, tp, idx, plain in (("zone_full", full, full_idx, fz.zone_full_plain),
                                 ("zone_partial", part, partial_idx, fz.zone_partial_plain)):
        t = torch.from_numpy(idx).to(dev)
        got = torch.empty((len(idx), n_leaves), dtype=torch.int64, device=dev)
        base = 0 if name == "zone_full" else len(full_idx)
        (fz.zone_full if name == "zone_full" else fz.zone_partial)(tp, layout, t, got, row_of, base)
        out[name] = ((got,), (plain(tp, layout, t),))
        lists.append(got)
    listed = torch.from_numpy(np.concatenate([full_idx, partial_idx]).astype(np.int64)).to(dev)
    parts = torch.cat(lists)
    C = layout.n_slots
    out["zone_fold"] = (fz.zone_fold(full, parts, listed, row_of, layout.fold, C),
                        fz.zone_fold_plain(full, parts, listed, row_of, layout.fold, C))
    return out, layout, len(full_idx), len(partial_idx)


#: zone_fold's edge cases (:func:`zone_fold_case`): (group slots, tiles of
#: the layout, share of them listed, aggregates); "skewed" leaves slots with
#: no tile, "unlisted_slot" a slot whose tiles are all unlisted, "wide" holds
#: 49 leaves (past a warp's 32 lanes), "deep" one slot of 40,000 tiles (79
#: segments, past a warp's 32 lanes in the slot's last fold), "all_empty" no
#: listed tile at all
ZONE_FOLD_CASES = {"one_slot": (1, 5000, 0.5, "mixed"),
                   "skewed": (300, 20_000, 0.9, "mixed"),
                   "unlisted_slot": (12, 3000, 0.8, "mixed"),
                   "wide": (12, 3000, 0.7, "wide"),
                   "deep": (1, 40_000, 0.15, "mixed"),
                   "all_empty": (12, 2000, 0.0, "mixed")}


def zone_fold_case(name: str, device):
    """Seeded inputs of ``zone_fold`` for :data:`ZONE_FOLD_CASES`: ``(tp,
    parts, tiles, row_of, order, capacity)``, the listed tiles as the rung
    lists them (a "full" list, then a "partial" one, each ascending), the
    row map holding each listed tile's row and, elsewhere, rows of other
    tiles and words out of range (what a query finds in memory it did not
    write), and random words in every leaf's range (int64 sums that wrap,
    the tracker with ``NO_ROW`` among its rows, positive f64 sums of
    squares)."""
    from .copr import fused_zone as fz
    from .copr.fused_group_agg import LEAF_COUNT, LEAF_MAX, LEAF_MIN, LEAF_SUM

    slots, n_tiles, share, aggs = ZONE_FOLD_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    schema = [(EvalType.INT, 0)] * 4
    if aggs == "wide":
        ops = [("var_pop", col(k % 4)) for k in range(16)]
    else:
        ops = [("count", None), ("sum", col(0)), ("min", col(1)), ("max", col(2)),
               ("var_pop", col(3))]
    agg_rpns = [(op, None if e is None else compile_expr(e, schema)) for op, e in ops]
    tp = fz.compile_tile_program([], agg_rpns, schema, True, partial=False)
    if name == "skewed":
        gid = np.minimum(rng.geometric(0.02, n_tiles) - 1, slots - 1)
    else:
        gid = rng.integers(0, slots, n_tiles)
    listed = rng.random(n_tiles) < share
    if name == "unlisted_slot":
        listed &= gid != 3
    idx = np.flatnonzero(listed)
    full = rng.random(len(idx)) < 0.7
    tiles = np.concatenate([idx[full], idx[~full]])
    n = len(tiles)
    row_of = rng.integers(-5, n + 5, n_tiles).astype(np.int32)
    row_of[tiles] = np.arange(n, dtype=np.int32)
    parts = np.empty((n, len(tp.prog.leaves)), dtype=np.int64)
    for l, leaf in enumerate(tp.prog.leaves):
        if leaf.is_f64:
            parts[:, l] = (rng.random(n) * 1e12).view(np.int64)
        elif leaf.kind == LEAF_COUNT:
            parts[:, l] = rng.integers(0, 4097, n)
        elif leaf.kind in (LEAF_SUM, LEAF_MIN, LEAF_MAX):
            parts[:, l] = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        else:  # the tracker
            parts[:, l] = np.where(rng.random(n) < 0.2, NO_ROW, rng.integers(0, 1 << 40, n))
    order = fz.fold_order(gid, slots, device)
    return (tp, torch.from_numpy(parts).to(device), torch.from_numpy(tiles).to(device),
            torch.from_numpy(row_of).to(device), order, slots)


def zone_fold_check(tp, parts, tiles, row_of, order, capacity: int,
                    rel_tol: float = 1e-12) -> dict:
    """``zone_fold`` on the card against its plain version on the same
    tensors (integer words equal, f64 leaves to ``rel_tol``) and against its
    own second launch (bit for bit); raises on a difference.  Returns the
    largest f64 error and the shape."""
    from .copr import fused_zone as fz

    got = fz.zone_fold(tp, parts, tiles, row_of, order, capacity)
    again = fz.zone_fold(tp, parts, tiles, row_of, order, capacity)
    if not (torch.equal(got[0], again[0])
            and torch.equal(got[1].view(torch.int64), again[1].view(torch.int64))):
        raise AssertionError("two zone_fold launches are not bit-identical")
    want = fz.zone_fold_plain(tp, parts, tiles, row_of, order, capacity)
    if not torch.equal(got[0], want[0]):
        at = (got[0] != want[0]).nonzero()[:8].tolist()
        raise AssertionError(f"zone_fold differs from its plain version at {at}")
    err = 0.0
    if got[1].numel():
        diff = (got[1] - want[1]).abs()
        if not bool((diff <= rel_tol * want[1].abs()).all()):
            raise AssertionError("zone_fold's f64 leaves differ from its plain version")
        err = float(diff.max())
    return {"max_abs_err": err, "rows": len(tiles), "tiles": order.n_tiles, "slots": capacity,
            "leaves": len(tp.prog.leaves), "segments": order.segs.shape[1]}


# ---------------------------------------------------------------------------
# The join event of bench.py (_op_join)
# ---------------------------------------------------------------------------

JOIN_PROBE_TABLE, JOIN_BUILD_TABLE = TABLE_ID, TABLE_ID + 1
JOIN_LIMIT = 100_000


def join_schema(key: str = "dict") -> list[ColumnInfo]:
    """``(id, key, pay)``: the key VARCHAR (``"dict"``) or BIGINT (``"int"``)."""
    kt = FieldType.varchar() if key == "dict" else FieldType.int64()
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, kt),
            ColumnInfo(3, FieldType.int64())]


def join_draws(n: int, seed: int = 0) -> dict:
    """The draws of ``bench._op_join`` at ``n`` probe rows: ``distinct =
    max(64, n // 16)``, probe keys from a pool of ``2 * distinct`` (half
    match), ``4 * distinct`` build rows keyed from the first ``distinct``,
    a 20-bit payload per row.  Keys are pool indices; the pool's strings are
    ``b"k%06d" % index``."""
    distinct = max(64, n // 16)
    rng = np.random.default_rng(seed)
    a = {"probe_key": rng.integers(0, 2 * distinct, n), "probe_pay": rng.integers(0, 1 << 20, n)}
    nb = 4 * distinct
    a["build_key"] = rng.integers(0, distinct, nb)
    a["build_pay"] = rng.integers(0, 1 << 20, nb)
    a["pool"] = np.array([b"k%06d" % i for i in range(2 * distinct)], dtype=object)
    return a


def _join_image(keys, pay, pool, key: str, block_rows: int, encode: bool):
    n = len(keys)
    if key == "dict":
        # the image's own dictionary, sorted and stable over its blocks
        used = np.unique(keys)
        dictionary = pool[used]
        codes = np.searchsorted(used, keys)
    ids = np.arange(n, dtype=np.int64)
    cache = ColumnBlockCache()
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        kcol = (Column(EvalType.BYTES, codes[s:e], nz, 0, dictionary) if key == "dict"
                else Column(EvalType.INT, keys[s:e].astype(np.int64), nz))
        cache.add([Column(EvalType.INT, ids[s:e], nz), kcol,
                   Column(EvalType.INT, pay[s:e].astype(np.int64), nz)], e - s)
    cache.filled = True
    if encode:
        encoding.encode_blocks(cache, join_schema(key))
    return cache


def join_caches(n: int, seed: int = 0, key: str = "dict", encode: bool = True,
                block_rows: int = 1 << 16):
    """``(draws, probe cache, build cache)`` of :func:`join_draws`: the keys
    as dictionary codes (``"dict"``, each image with its own sorted
    dictionary, so the probe codes remap into the build's) or as the pool
    index, an INT64 key (``"int"``, the hash path only); ``encode`` encodes
    both images as ``build_cache(..., encode=True)`` does."""
    a = join_draws(n, seed)
    probe = _join_image(a["probe_key"], a["probe_pay"], a["pool"], key, block_rows, encode)
    build = _join_image(a["build_key"], a["build_pay"], a["pool"], key, block_rows, encode)
    return a, probe, build


def join_downstream() -> tuple:
    """Selection, Projection and Limit over columns of both sides: probe pay
    below build pay; (probe id + build id, the key, build pay); 100,000 rows."""
    return (Selection([call("lt", col(2), col(5))]),
            Projection([call("plus", col(0), col(3)), col(1), col(5)]),
            Limit(JOIN_LIMIT))


def join_dag(downstream=(), key: str = "dict") -> DagRequest:
    """``[TableScan(probe), Join(build), *downstream]``, inner on column 1."""
    schema = join_schema(key)
    return DagRequest(executors=[
        TableScan(JOIN_PROBE_TABLE, schema),
        Join([TableScan(JOIN_BUILD_TABLE, schema)], [], 1, 1, join_type="inner",
             build_context={"region_id": 2, "region_epoch": (1, 1), "apply_index": 7}),
        *downstream,
    ])


def join_oracle(a: dict) -> tuple[np.ndarray, np.ndarray]:
    """(probe row, build row) of every joined pair, the CPU join's way: a
    dict from key to the build rows in row order, probed row by row."""
    table: dict = {}
    for i, k in enumerate(a["build_key"].tolist()):
        table.setdefault(k, []).append(i)
    p_out, b_out = [], []
    for i, k in enumerate(a["probe_key"].tolist()):
        rows = table.get(k)
        if rows:
            p_out.extend([i] * len(rows))
            b_out.extend(rows)
    return np.array(p_out, dtype=np.int64), np.array(b_out, dtype=np.int64)


def _varint_bytes(zz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """LEB128 bytes of the uint64 ``zz``, row by row: an ``(n, 10)`` byte
    matrix and each row's length."""
    groups = np.stack([(zz >> np.uint64(7 * k)) & np.uint64(0x7F) for k in range(10)], axis=1)
    lens = 1 + sum(((zz >> np.uint64(7 * k)) != 0).astype(np.int64) for k in range(1, 10))
    more = np.arange(10) < (lens - 1)[:, None]
    return (groups | (more * 0x80).astype(np.uint64)).astype(np.uint8), lens


def _zigzag(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, dtype=np.int64)
    return ((v << 1) ^ (v >> 63)).view(np.uint64)


def _datum_row_bytes(cols: list) -> tuple[np.ndarray, np.ndarray]:
    """The datum rows of ``cols`` in numpy, no per-row Python: each row the
    column count, then per column ``VARINT_FLAG`` (8) and the zigzag varint
    of an INT, or ``COMPACT_BYTES_FLAG`` (2), the zigzag varint of the
    length and the bytes of a BYTES value given as ``("pool", codes,
    pool)``.  Returns the rows' bytes end to end and each row's end."""
    mats, masks = [], []
    n = len(cols[0][1])
    mats.append(np.full((n, 1), len(cols), dtype=np.uint8))
    masks.append(np.ones((n, 1), dtype=bool))
    for kind, data, *pool in cols:
        if kind == EvalType.INT:
            vb, vl = _varint_bytes(_zigzag(data))
            body, width = vb, vl
            flag = 8
        else:
            entries = [bytes(x) for x in pool[0]]
            plen = np.array([len(e) for e in entries], dtype=np.int64)
            lb, ll = _varint_bytes(_zigzag(plen))
            wide = max(1, int(plen.max(initial=0)))
            pm = np.zeros((len(entries), 10 + wide), dtype=np.uint8)
            pw = ll + plen
            for i, e in enumerate(entries):  # the pool, not the rows
                pm[i, : ll[i]] = lb[i, : ll[i]]
                pm[i, ll[i] : pw[i]] = np.frombuffer(e, dtype=np.uint8)
            body, width = pm[data], pw[data]
            flag = 2
        mats.append(np.full((n, 1), flag, dtype=np.uint8))
        masks.append(np.ones((n, 1), dtype=bool))
        mats.append(body)
        masks.append(np.arange(body.shape[1]) < width[:, None])
    mat, mask = np.concatenate(mats, axis=1), np.concatenate(masks, axis=1)
    return mat[mask], np.cumsum(mask.sum(axis=1))


def join_oracle_bytes(a: dict, pairs, key: str = "dict", downstream: bool = False) -> bytes:
    """The response bytes of the joined ``pairs`` (:func:`join_oracle`),
    datum rows in chunks of 1,024 encoded here in numpy (not through the
    port's ``ResponseEncoder``); ``downstream``: after
    :func:`join_downstream`, computed here in numpy."""
    p, b = pairs
    pk, bk = a["probe_key"][p], a["build_key"][b]
    kcol = ((lambda k: ("pool", k, a["pool"])) if key == "dict"
            else (lambda k: (EvalType.INT, k.astype(np.int64))))
    if downstream:
        keep = np.flatnonzero(a["probe_pay"][p] < a["build_pay"][b])[:JOIN_LIMIT]
        p, b, pk = p[keep], b[keep], pk[keep]
        cols = [(EvalType.INT, p + b), kcol(pk), (EvalType.INT, a["build_pay"][b])]
    else:
        cols = [(EvalType.INT, p), kcol(pk), (EvalType.INT, a["probe_pay"][p]),
                (EvalType.INT, b), kcol(bk), (EvalType.INT, a["build_pay"][b])]
    chunks = []
    if len(p):
        buf, ends = _datum_row_bytes(cols)
        starts = np.concatenate([[0], ends])
        chunks = [buf[starts[i] : starts[min(i + 1024, len(p))]].tobytes()
                  for i in range(0, len(p), 1024)]
    return SelectResponse(chunks).encode()


def join_probe_case(n_keys: int, mult: int, n_probe: int, seed: int = 0,
                    wide: bool = False, null_p: float = 0.0) -> dict:
    """Inputs of both probe kernels, as numpy int64 arrays: ``n_keys``
    distinct build keys with ``mult`` rows each, sorted (``"sorted"``), and
    ``n_probe`` probes, half of them build keys (``"rank_probe"``); the hash
    table of the sorted keys (``"table"``: keys, starts, counts) and the same
    probes for it (``"hash_probe"``).  Keys are ``0 .. n_keys - 1`` (codes)
    or, ``wide``, drawn over the whole int64 range with its edges, so that
    negative keys and colliding home slots occur.  A ``null_p`` share of the
    probes is NULL: the rank path's miss code -1, the hash path's empty
    sentinel."""
    from .copr.fused_join import EMPTY
    from .copr.torch_join import _build_hash_table

    rng = np.random.default_rng(seed)
    if wide:
        # no key is -1, the rank path's miss code
        edges = np.array([-(1 << 63) + 1, -(1 << 62), -2, 0, (1 << 63) - 1], dtype=np.int64)
        keys = np.unique(np.concatenate(
            [edges, rng.integers(-(1 << 63) + 1, (1 << 63) - 1, n_keys, dtype=np.int64)]))
        keys = keys[rng.permutation(len(keys))[:n_keys]]
        keys.sort()
        misses = rng.integers(-(1 << 63) + 1, (1 << 63) - 1, n_probe, dtype=np.int64)
    else:
        keys = np.arange(n_keys, dtype=np.int64)
        misses = rng.integers(n_keys, 2 * n_keys, n_probe)
    probe = np.where(rng.random(n_probe) < 0.5, keys[rng.integers(0, len(keys), n_probe)],
                     misses).astype(np.int64)
    nulls = rng.random(n_probe) < null_p
    sorted_keys = np.repeat(keys, mult)
    lead = np.arange(0, len(sorted_keys), mult, dtype=np.int64)
    table = _build_hash_table(keys, lead, np.full(len(keys), mult, dtype=np.int64))
    return {"sorted": sorted_keys, "rank_probe": np.where(nulls, -1, probe),
            "table": table, "hash_probe": np.where(nulls, EMPTY, probe)}


def join_kernel_check(case: dict, device) -> dict:
    """Both probe kernels on ``device`` against their plain versions over
    ``case`` (:func:`join_probe_case`): int64-exact, and a second run
    bit-identical; raises on a difference.  Returns the max abs error of
    each (0) and the matched probes."""
    from .copr import fused_join

    t = {k: (tuple(torch.from_numpy(x).to(device) for x in v) if k == "table"
             else torch.from_numpy(v).to(device)) for k, v in case.items()}
    out = {}
    for name, kernel, plain, args in (
            ("join_rank_probe", fused_join.rank_probe, fused_join.rank_probe_plain,
             (t["sorted"], t["rank_probe"])),
            ("join_hash_probe", fused_join.hash_probe, fused_join.hash_probe_plain,
             (*t["table"], t["hash_probe"]))):
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        for g, h, w, what in zip(got, again, want, ("starts", "counts")):
            if g.dtype != torch.int64 or not torch.equal(g, w):
                raise AssertionError(f"{name} {what} differ from the plain version")
            if not torch.equal(g, h):
                raise AssertionError(f"{name} {what} differ between two runs")
        out[name] = 0.0
        out[f"{name}_matched"] = int((got[1] > 0).sum())
    if out["join_rank_probe_matched"] != out["join_hash_probe_matched"]:
        raise AssertionError("the rank and hash probes match different rows")
    return out


# ---------------------------------------------------------------------------
# The mesh path (programs #16, #18, #19, #20)
# ---------------------------------------------------------------------------

NUMERIC_TABLE_ID = 42


def numeric_table(n: int, seed: int = 0, table_id: int = NUMERIC_TABLE_ID):
    """The all-numeric table of the JAX package's mesh tests (``id`` handle,
    ``a`` int in [0, 1000), ``b`` int in [0, 100), ``c`` decimal(2) in [0,
    1000.00)), drawn with numpy from ``seed`` as ``numeric_table_kvs`` draws
    it: ``(schema, kvs, (a, b, c))``."""
    rng = np.random.default_rng(seed)
    schema = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
              ColumnInfo(2, FieldType.int64()), ColumnInfo(3, FieldType.int64()),
              ColumnInfo(4, FieldType.decimal_type(2))]
    a = rng.integers(0, 1000, n)
    b = rng.integers(0, 100, n)
    c = rng.integers(0, 100000, n)
    kvs = [(record_key(table_id, i), encode_row(schema[1:], [int(a[i]), int(b[i]), int(c[i])]))
           for i in range(n)]
    return schema, kvs, (a, b, c)


def mesh_merge_program():
    """A grouped program whose state has every leaf kind a mesh plan can
    hold (``first`` has no merge rule): the tracker, counts, int64 and f64
    sums, var_pop's f64 sum of squares, int64 and f64 min and max, and the
    three bitwise leaves."""
    schema = [(EvalType.INT, 0), (EvalType.REAL, 0)]
    aggs = [("count", None), ("sum", col(0)), ("sum", col(1)), ("var_pop", col(1)),
            ("min", col(0)), ("max", col(0)), ("min", col(1)), ("max", col(1)),
            ("bit_and", col(0)), ("bit_or", col(0)), ("bit_xor", col(0))]
    agg_rpns = [(op, None if e is None else compile_expr(e, schema)) for op, e in aggs]
    return compile_group_program([], agg_rpns, [0, 1], schema, None, track=True)


def merge_perm(capacity: int, seed: int, device) -> torch.Tensor:
    """A carry remap of ``mesh_merge``: the positions (nondecreasing, int32)
    of a sorted dictionary's live slots in a larger one, a sentinel tail
    at ``capacity``, and (for an overflow) two slots on one position and
    one past the end.  Drawn with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    live = int(rng.integers(1, capacity + 1))
    perm = np.sort(rng.choice(capacity, size=live, replace=False))
    if live > 2:
        perm[1] = perm[0]
        perm[-1] = capacity
    perm = np.concatenate([perm, np.full(capacity - live, capacity)])
    return torch.from_numpy(np.sort(perm).astype(np.int32)).to(device)


def mesh_merge_case(n_parts: int, n_regions: int, capacity: int, seed: int, device):
    """Synthetic inputs of ``mesh_merge``: :func:`mesh_merge_program`, its
    stacked packed states ``(n_parts, n_int, C)`` / ``(n_parts, n_f64, C)``,
    a table listing for each region a random subset of the parts in a random
    order (padded with -1; one region lists none), and a carry ``(R, n_int,
    C)`` / ``(R, n_f64, C)``.  Integers span the whole int64 range, so sums
    wrap; f64 words hold NaN, +-0.0 and +-inf at the edges; trackers hold
    row indices and ``NO_ROW``.  Drawn with numpy from ``seed``."""
    prog = mesh_merge_program()
    rng = np.random.default_rng(seed)

    def states(n):
        ints = rng.integers(-(1 << 63), (1 << 63) - 1, (n, prog.n_int, capacity),
                            dtype=np.int64, endpoint=True)
        ints[:, :, 0] = [-(1 << 63), (1 << 63) - 1][rng.integers(0, 2)]
        flts = rng.standard_normal((n, prog.n_f64, capacity)) * 1e6
        special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf])
        pick = rng.random(flts.shape) < 0.05
        flts[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        flts[:, :, 1] = -0.0
        flts[:, :, 2] = 0.0
        for leaf in prog.leaves:
            if leaf.kind == LEAF_TRACK:
                rows = rng.integers(0, 1 << 40, (n, capacity))
                ints[:, leaf.slot] = np.where(rng.random((n, capacity)) < 0.2, NO_ROW, rows)
        return torch.from_numpy(ints).to(device), torch.from_numpy(flts).to(device)

    parts = states(n_parts)
    carry = states(n_regions)
    lists = [list(rng.permutation(n_parts)[: rng.integers(1, n_parts + 1)])
             for _ in range(n_regions)]
    lists[-1] = []
    width = max(len(p) for p in lists)
    table = np.full((n_regions, width), -1, dtype=np.int32)
    for r, p in enumerate(lists):
        slots = np.sort(rng.permutation(width)[: len(p)])  # -1 entries between parts too
        table[r, slots] = p
    return prog, parts, torch.from_numpy(table).to(device), carry


def mesh_fold_case(n_shards: int, n_parts: int, capacity: int, rows_per_shard: int, seed: int,
                   device, n_windows: int = 1, empty=()):
    """Synthetic inputs of ``mesh_fold``: :func:`mesh_merge_program`; the
    shards' raw partial rows ``(n_shards * n_parts, n_leaves, C)`` int64
    (f64 leaves as bits), integers over the whole int64 range, f64 words
    with NaN, +-0.0 and +-inf, the tracker's flat rows below
    ``rows_per_shard`` or ``NO_ROW``, and the shards listed in ``empty`` at
    their identities (a shard past a partial super-block's valid rows); the
    shard table (shard ``k``'s rows after shard ``k - 1``'s, its row 0 at
    ``k * rows_per_shard``); a ``base`` row; the window width ``C /
    n_windows``; and the windows ``[(lo, carry)]``, each carry ``(n_int,
    width)`` / ``(n_f64, width)`` drawn alike.  Drawn with numpy from
    ``seed``.  Returns ``(prog, rows, shards, base, width, windows)``."""
    from .copr import fused_mesh

    prog = mesh_merge_program()
    rng = np.random.default_rng(seed)
    special = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf])

    def words(shape, leaf):
        if leaf.kind == LEAF_TRACK:
            rows = rng.integers(0, rows_per_shard, shape)
            return np.where(rng.random(shape) < 0.2, NO_ROW, rows)
        if not leaf.is_f64:
            return rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64, endpoint=True)
        f = rng.standard_normal(shape) * 1e6
        pick = rng.random(shape) < 0.05
        f[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        f[..., :2] = [-0.0, 0.0]
        return f.view(np.int64)

    n_rows = n_shards * n_parts
    rows = np.empty((n_rows, len(prog.leaves), capacity), dtype=np.int64)
    for l, leaf in enumerate(prog.leaves):
        rows[:, l] = words((n_rows, capacity), leaf)
        for k in empty:
            rows[k * n_parts:(k + 1) * n_parts, l] = leaf.ident
    shards = fused_mesh.shard_table([(k * n_parts, n_parts, k * rows_per_shard)
                                     for k in range(n_shards)], n_rows, device)
    width = capacity // n_windows
    windows = []
    for g in range(n_windows):
        ints = np.empty((prog.n_int, width), dtype=np.int64)
        flts = np.empty((prog.n_f64, width), dtype=np.int64)
        for leaf in prog.leaves:
            (flts if leaf.is_f64 else ints)[leaf.slot] = words((width,), leaf)
        windows.append((g * width, (torch.from_numpy(ints).to(device),
                                    torch.from_numpy(flts.view(np.float64)).to(device))))
    base = int(rng.integers(0, 1 << 40))
    return prog, torch.from_numpy(rows).to(device), shards, base, width, windows


def fold_pair_images(prog, shards, base: int, rows_per_shard: int, device) -> list:
    """One-block CUDA images of ``rows_per_shard`` rows (zero columns of
    ``prog``'s types, host ids 0), shard ``k``'s at global row ``base`` +
    its table offset: what ``fused_group_agg_combine_pack`` reads of a
    shard besides its partial rows."""
    shape = (1, rows_per_shard)
    return [Image([torch.zeros(shape, dtype=torch.float64 if f else torch.int64, device=device)
                   for f in prog.col_f64], [None] * len(prog.col_f64), 0, 1, rows_per_shard,
                  device, base + off, torch.zeros(shape, dtype=torch.int32, device=device))
            for _r0, _n, off in shards.tolist()]


def fold_pair(prog, rows, shards, width: int, windows, images, perm=None) -> list:
    """What ``mesh_fold`` replaces, on the card: ``fused_group_agg_combine_pack``
    over each shard's rows of ``rows`` (its image from ``images``), then
    ``mesh_merge`` of the packed states in shard order over each window
    ``(lo, carry)`` into its carry (through ``perm``).  Returns the
    windows' ``(ints, flts)``."""
    from .copr import fused_group_agg as ga
    from .copr import fused_mesh

    cap, dev = rows.shape[2], rows.device
    pi = torch.empty((len(images), prog.n_int, cap), dtype=torch.int64, device=dev)
    pf = torch.empty((len(images), prog.n_f64, cap), dtype=torch.float64, device=dev)
    for k, ((r0, n, _off), img) in enumerate(zip(shards.tolist(), images)):
        ga.launch_combine(prog, img, cap, rows[r0:r0 + n], None, (pi[k], pf[k]))
    table = fused_mesh.merge_table([range(len(images))], len(images), dev)
    outs = []
    for lo, carry in windows:
        out = (torch.empty((1, prog.n_int, width), dtype=torch.int64, device=dev),
               torch.empty((1, prog.n_f64, width), dtype=torch.float64, device=dev))
        c = None if carry is None else (carry[0][None], carry[1][None])
        fused_mesh.launch_mesh_merge(prog, (pi, pf), table, c, lo, lo + width, out, perm)
        outs.append((out[0][0], out[1][0]))
    return outs


def mesh_columns(a: dict, start: int, end: int) -> dict:
    """Rows ``[start, end)`` of the lineitem draws ``a`` as the sharded
    evaluators' host columns, ``{column: (data, nulls)}``, for the columns of
    :func:`topn_dag` (the handle and l_quantity .. l_shipdate)."""
    nz = np.zeros(end - start, dtype=bool)
    return {0: (np.arange(start, end, dtype=np.int64), nz), 1: (a["qty"][start:end], nz),
            2: (a["price"][start:end], nz), 3: (a["disc"][start:end], nz),
            4: (a["ship"][start:end], nz)}


def grouped_schema() -> list[ColumnInfo]:
    """The schema of the JAX package's grouped Q1 mesh step
    (``__graft_entry__._q1_grouped_dag``): lineitem's first five columns,
    nullable there, then l_returnflag and l_linestatus as INT code columns."""
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()), ColumnInfo(3, FieldType.decimal_type(2)),
            ColumnInfo(4, FieldType.decimal_type(2)), ColumnInfo(5, FieldType.int64()),
            ColumnInfo(6, FieldType.int64()), ColumnInfo(7, FieldType.int64())]


#: the grouped plans' key columns: l_quantity (50 values), l_returnflag (3
#: codes) and l_linestatus (2 codes), by draw name and schema index
GROUP_KEY_COLS = {"qty": 1, "rf": 5, "ls": 6}


def grouped_dag(keys=("rf", "ls")) -> DagRequest:
    """Q1's grouped mesh shape: sum(quantity), sum(price), avg(price),
    count(*) under shipdate <= 10500, GROUP BY ``keys`` (draw names of
    :data:`GROUP_KEY_COLS`: Q1's (returnflag, linestatus), l_quantity's 50
    groups, (quantity, linestatus)'s 100)."""
    aggs = [AggDescriptor("sum", col(1)), AggDescriptor("sum", col(2)),
            AggDescriptor("avg", col(2)), AggDescriptor("count", None)]
    return DagRequest(executors=[
        TableScan(TABLE_ID, grouped_schema()),
        Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
        Aggregation([col(GROUP_KEY_COLS[k]) for k in keys], aggs)])


def grouped_columns(a: dict, start: int, end: int, rows: int | None = None) -> dict:
    """Rows ``[start, end)`` of the lineitem draws ``a`` as the columns of
    :func:`grouped_schema`, ``{column: (data, nulls)}``, no NULLs; zeros
    pad them to ``rows`` (a super-block's) when given."""
    names = ("qty", "price", "disc", "ship", "rf", "ls")
    cols = [np.arange(start, end, dtype=np.int64)] + [a[k][start:end] for k in names]
    if rows is not None and rows != end - start:
        cols = [np.concatenate([c, np.zeros(rows - len(c), dtype=c.dtype)]) for c in cols]
    nz = np.zeros(len(cols[0]), dtype=bool)
    return {j: (c.astype(np.int64, copy=False), nz) for j, c in enumerate(cols)}


def grouped_oracle(a: dict, keys=("rf", "ls"), key_bits: int = 31) -> dict:
    """:func:`grouped_dag`'s answer from the draws in the sharded grouped
    evaluator's ``finalize`` form: the packed keys in order of each group's
    first qualifying row, those rows, and per aggregate its leaves (count;
    then the sum for sum and avg)."""
    rows = np.flatnonzero(a["ship"] <= Q1_SHIP_HI)
    key = np.zeros(len(rows), dtype=np.int64)
    for k in keys:
        key = (key << key_bits) | a[k][rows].astype(np.int64)
    uniq, first_at, inv = np.unique(key, return_index=True, return_inverse=True)
    by_group = np.argsort(inv, kind="stable")
    starts = np.flatnonzero(np.r_[True, np.diff(inv[by_group]) != 0]) if len(rows) else []
    count = np.bincount(inv, minlength=len(uniq)).astype(np.int64)
    qty, price = (np.add.reduceat(a[c][rows][by_group].astype(np.int64), starts)
                  if len(rows) else np.zeros(0, np.int64) for c in ("qty", "price"))
    order = np.argsort(first_at, kind="stable")
    return {"keys": uniq[order], "first": rows[first_at][order],
            "aggs": [(count[order], qty[order]), (count[order], price[order]),
                     (count[order], price[order]), (count[order],)]}


def dict_case(n: int, cap: int, distinct: int, seed: int, device, bad: bool = False):
    """Synthetic inputs of the dictionary kernels (``copr/fused_dict.py``):
    a key program (selection ``v < 800``; GROUP BY a nullable INT column of
    ``distinct`` values, 5% NULL, and a REAL column truncated to 0..3, at
    20 bits a key), a one-block image of ``n`` rows of which the last 7
    are past ``n_valid``, and an old dictionary at ``cap`` slots: the union
    of the first half's keys.  ``bad`` puts negative REAL values in 1% of
    the rows (a range overflow).  Drawn with numpy from ``seed``."""
    from .copr import fused_dict

    rng = np.random.default_rng(seed)
    schema = [(EvalType.INT, 0), (EvalType.REAL, 0), (EvalType.INT, 0)]
    k1 = rng.integers(0, distinct, n)
    null1 = rng.random(n) < 0.05
    k2 = rng.uniform(0, 4, n)
    if bad:
        k2 = np.where(rng.random(n) < 0.01, -k2 - 1, k2)
    v = rng.integers(0, 1000, n)
    sel = [compile_expr(call("lt", col(2), const_int(800)), schema)]
    keys = [compile_expr(col(0), schema), compile_expr(col(1), schema)]
    prog = fused_dict.compile_key_program(sel, keys, [0, 1, 2], schema, 20)

    def lane(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).view(1, n).to(device)

    img = Image([lane(k1, np.int64), lane(k2, np.float64), lane(v, np.int64)],
                [lane(null1, np.bool_), None, None], n - 7, 1, n, torch.device(device))
    first, _bad = fused_dict.dict_keys_plain(prog, image_on(img, "cpu"))
    old, _over = fused_dict.dict_union_plain(None, first[: n // 2], cap)
    return prog, img, old.to(device)


UNION_EDGE_CASES = ("one", "tile_minus_one", "tile", "tile_plus_one", "all_sentinel",
                    "all_equal", "cap_exact", "cap_plus_one", "carried", "tile_2048",
                    "tile_8192", "largest_tile", "sort_route", "sort_route_32768",
                    "sort_tile_plus_one")


def union_edge_case(name: str, seed: int = 0):
    """One input of ``dict_union`` at an edge of its kernel: ``(dictionary
    or None, keys, cap)`` as int64 tensors on the CPU, drawn with numpy from
    ``seed``; ``name`` one of :data:`UNION_EDGE_CASES`.  The tile route at
    64 slots (tiles of ``union_tile(64)`` = ``TILE_MIN`` keys) with 1, T -
    1, T and T + 1 keys, keys all sentinel or all equal, exactly ``cap``
    and ``cap + 1`` distinct keys, a carried dictionary; the other tiles
    the route takes: 2,048 keys (1,024 slots), 8,192 (4,096 slots, the
    largest that merges between two buffers) and 16,384 (8,192 slots,
    merged in place); the sort route past ``CAP_MAX`` slots, at 32,768
    slots over the mesh path's 163,840 keys, and one key past a sort
    tile."""
    from .copr import fused_dict as fd

    rng = np.random.default_rng(seed)

    def keys(n, spread, sentinel_p=0.2):
        k = rng.integers(0, spread, n)
        k[rng.random(n) < sentinel_p] = fd.SENTINEL
        return k

    def carried(cap, spread):
        return fd.dict_union_plain(None, torch.from_numpy(keys(4 * cap, spread, 0.0)), cap)[0]

    t = fd.union_tile(64)
    cases = {
        "one": (None, np.array([5]), 64),
        "tile_minus_one": (None, keys(t - 1, 200), 64),
        "tile": (None, keys(t, 200), 64),
        "tile_plus_one": (None, keys(t + 1, 200), 64),
        "all_sentinel": (None, np.full(5000, fd.SENTINEL), 64),
        "all_equal": (None, np.full(5000, 42), 64),
        "cap_exact": (None, rng.permutation(np.arange(5000) % 64) * 7, 64),
        "cap_plus_one": (None, rng.permutation(np.arange(5000) % 65) * 7, 64),
        "carried": (carried(64, 100), keys(20_000, 60), 64),
        "tile_2048": (carried(1024, 1500), keys(30_000, 1200), 1024),
        "tile_8192": (carried(4096, 6000), keys(60_000, 4500), 4096),
        "largest_tile": (carried(8192, 12_000), keys(100_000, 8000), 8192),
        "sort_route": (carried(9000, 20_000), keys(200_000, 20_000), 9000),
        "sort_route_32768": (carried(32768, 60_000), keys(131_072, 60_000), 32768),
        "sort_tile_plus_one": (None, keys(fd.SORT_TILE + 1, 20_000, 0.0), fd.CAP_MAX + 1),
    }
    d, k, cap = cases[name]
    return d, torch.from_numpy(np.asarray(k, dtype=np.int64)), cap


def union_kernel_check(d, keys: torch.Tensor, cap: int, device) -> dict:
    """``dict_union`` on CUDA copies of ``d`` (or None) and ``keys`` against
    ``dict_union_plain`` on the CPU: the union and the capacity flag equal,
    two runs bit-identical.  Raises on a difference; returns the flag and
    the union's fill."""
    from .copr import fused_dict as fd

    want, over = fd.dict_union_plain(d, keys, cap)
    dd = None if d is None else d.to(device)
    kd = keys.to(device)
    runs = []
    for _ in range(2):
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        out = torch.empty(cap, dtype=torch.int64, device=device)
        fd.launch_union(dd, kd, cap, flag, out)
        runs.append((out.cpu(), int(flag.cpu())))
    if not (torch.equal(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]):
        raise AssertionError("dict_union: two runs differ")
    if not torch.equal(runs[0][0], want):
        raise AssertionError("dict_union: differs from its plain version")
    if runs[0][1] != (fd.FLAG_CAPACITY if over else 0):
        raise AssertionError(f"dict_union flag {runs[0][1]}, plain version over={over}")
    return {"over": over, "live": int((want < fd.SENTINEL).sum())}


def sort_route_levels(d, keys: torch.Tensor, device) -> dict:
    """The sort route's tile sort (its tiles and their live counts) and
    ``dict_merge`` levels on CUDA copies of ``d`` (a dictionary or None) and
    ``keys``, each level against ``merge_pass_plain`` of the plain tiles
    exactly and run twice bit for bit; the last level against the sorted
    keys.  Returns the sorted keys on the card, the tiles and their live
    counts, the plan and each level's input and output (for timing)."""
    from .copr import fused_dict as fd

    lib = fd.kernels()
    x = keys if d is None else torch.cat([d, keys])
    n = x.numel()
    sorted_n = fd.sorted_keys(n)
    dd = None if d is None else d.to(device)
    kd = keys.to(device)
    n_d = 0 if d is None else d.numel()
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    tiles = torch.empty(sorted_n, dtype=torch.int64, device=device)
    live = torch.empty(sorted_n // fd.SORT_TILE, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.du_launch(None if dd is None else dd.data_ptr(), n_d, kd.data_ptr(), kd.numel(),
                       tiles.data_ptr(), flag.data_ptr(), fd.SORT_TILE, fd.SORT_TILE,
                       live.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dict_union launch failed: cudaError {rc}")
    want = fd.union_pass_plain(x.cpu(), fd.SORT_TILE, fd.SORT_TILE)[0].reshape(-1)
    if not torch.equal(tiles.cpu(), want):
        raise AssertionError("dict_union's tile sort differs from its plain version")
    if not torch.equal(live.cpu(), (want < fd.SENTINEL).view(-1, fd.SORT_TILE).sum(1)
                       .to(torch.int32)):
        raise AssertionError("dict_union's live counts differ from the tiles'")
    levels, src = [], tiles
    for w, f in fd.merge_plan(n):
        outs = []
        for _ in range(2):
            dst = torch.empty_like(src)
            rc = lib.dm_launch(src.data_ptr(), sorted_n, w, f, live.data_ptr(), dst.data_ptr(),
                               stream)
            if rc != 0:
                raise RuntimeError(f"dict_merge launch failed: cudaError {rc}")
            outs.append(dst)
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"dict_merge ({w}, {f}): two runs differ")
        want = fd.merge_pass_plain(want, w, f)
        if not torch.equal(outs[0].cpu(), want):
            raise AssertionError(f"dict_merge ({w}, {f}) differs from its plain version")
        levels.append((w, f, src, outs[0]))
        src = outs[0]
    if not torch.equal(src.cpu(), torch.sort(want).values):
        raise AssertionError("the sort route's levels left the keys unsorted")
    return {"sorted": src, "tiles": tiles, "live": live, "plan": fd.merge_plan(n),
            "levels": levels}


COMPACT_EDGE_CASES = ("tile_boundary_run", "all_sentinel", "cap_exact", "cap_plus_one",
                      "one_sort_tile", "shard_union", "global_union")
#: the on-card cases add a buffer past the card's resident blocks (2,048
#: tiles of dict_compact), so that blocks wait on tiles whose blocks started
#: later than they were launched
COMPACT_GRID_CASE = "grid_4m"


def compact_edge_case(name: str, seed: int = 0):
    """One sorted buffer of the sort route's compaction at an edge of
    ``dict_compact`` and its ``cap`` (past ``CAP_MAX``, as the route runs
    it): ``(sorted int64 keys on the CPU, cap)``, drawn with numpy from
    ``seed``; ``name`` one of :data:`COMPACT_EDGE_CASES` or
    :data:`COMPACT_GRID_CASE`.  Equal keys across the boundary of two tiles
    (``COMPACT_TILE``), every key the sentinel, exactly ``cap`` and ``cap +
    1`` distinct keys, one ``SORT_TILE`` of keys, the grouped mesh's shard
    union (163,840 keys into 32,768 slots) and global union (262,144 keys),
    and 4,194,304 keys."""
    from .copr import fused_dict as fd

    rng = np.random.default_rng(seed)
    t, cap = fd.COMPACT_TILE, fd.CAP_MAX + 1

    def keys(n, spread, sentinel_p):
        k = rng.integers(0, spread, n)
        k[rng.random(n) < sentinel_p] = fd.SENTINEL
        return k

    if name == "tile_boundary_run":
        k = np.sort(keys(3 * t, 4 * t, 0.1))
        k[t - 37 : t + 51] = k[t - 37]  # one key from 37 before the boundary to 51 past it
        k[2 * t - 1 : 2 * t + 1] = k[2 * t - 1]  # and the last key of a tile again first
        s = np.sort(k)
    elif name == "all_sentinel":
        s = np.full(2 * fd.SORT_TILE, fd.SENTINEL)
    elif name in ("cap_exact", "cap_plus_one"):
        distinct = cap + (name == "cap_plus_one")
        k = np.concatenate([rng.permutation(4 * fd.SORT_TILE)[:distinct] * 3,
                            rng.integers(0, 4 * fd.SORT_TILE, 4 * fd.SORT_TILE - distinct)])
        k = np.unique(k)[:distinct]  # exactly `distinct` keys, then repeats and sentinels
        s = np.sort(np.concatenate([k, rng.choice(k, 2 * fd.SORT_TILE),
                                    np.full(4 * fd.SORT_TILE - distinct, fd.SENTINEL)]))
    elif name == "one_sort_tile":
        s = np.sort(keys(fd.SORT_TILE, 3000, 0.05))
    elif name == "shard_union":
        s, cap = np.sort(keys(163_840, 60_000, 0.2)), 32768
    elif name == "global_union":
        s, cap = np.sort(keys(262_144, 20_000, 0.9)), 32768
    elif name == COMPACT_GRID_CASE:
        s, cap = np.sort(keys(1 << 22, 1 << 21, 0.05)), 1 << 20
    else:
        raise ValueError(f"no compaction edge case {name!r}")
    return torch.from_numpy(np.asarray(s, dtype=np.int64)), cap


def compact_kernel_check(s: torch.Tensor, cap: int, device) -> dict:
    """``dict_compact`` alone on a CUDA copy of the sorted ``s`` against
    ``compact_plain``: the keys and the capacity flag equal, two runs and a
    third into an output that starts 8 bytes past a 16-byte boundary
    bit-identical (the scratch it leaves zero is used again).  Raises on a
    difference; returns the flag, the live keys and the launch's blocks."""
    from .copr import fused_dict as fd

    want, over = fd.compact_plain(s.clone(), cap)
    sd = s.to(device)
    lib = fd.kernels()
    stream = torch.cuda.current_stream(device).cuda_stream
    runs = []
    for _ in range(2):
        flag = torch.zeros(1, dtype=torch.int32, device=device)
        out = torch.empty(cap, dtype=torch.int64, device=device)
        scratch = fd.compact_scratch(device, sd.numel())
        rc = lib.dc_launch_compact(sd.data_ptr(), sd.numel(), out.data_ptr(), flag.data_ptr(),
                                   cap, scratch.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"dict_compact launch failed: cudaError {rc}")
        runs.append((out.cpu(), int(flag.cpu())))
        if bool((scratch != 0).any()):
            raise AssertionError("dict_compact left its scratch non-zero")
    # once more into an output 8 bytes past a 16-byte boundary
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    out = torch.empty(cap + 1, dtype=torch.int64, device=device)[1:]
    rc = lib.dc_launch_compact(sd.data_ptr(), sd.numel(), out.data_ptr(), flag.data_ptr(), cap,
                               fd.compact_scratch(device, sd.numel()).data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dict_compact launch failed: cudaError {rc}")
    runs.append((out.cpu(), int(flag.cpu())))
    if not all(torch.equal(runs[0][0], o) and runs[0][1] == f for o, f in runs[1:]):
        raise AssertionError("dict_compact: two runs differ")
    if not torch.equal(runs[0][0], want):
        raise AssertionError("dict_compact: differs from its plain version")
    if runs[0][1] != (fd.FLAG_CAPACITY if over else 0):
        raise AssertionError(f"dict_compact flag {runs[0][1]}, plain version over={over}")
    return {"over": over, "live": int((want < fd.SENTINEL).sum()),
            "blocks": fd.compact_tiles(s.numel())}


XROUND_EDGE_CASES = ("random_words", "random_words_finite", "ties", "subnormal", "zero",
                     "negative", "huge")


def _exact_words(values, rng, scramble: bool) -> np.ndarray:
    """``[len(values), XWORDS]`` int64 words whose exact sums (word k counts
    units of 2^(32k - 1074)) are the Python ints ``values``: each value's
    32-bit digits (negated for a negative value), or with ``scramble`` the
    same sums with a random signed carry moved between every two words (up
    to 2^29 units of the word above, so words reach 2^61)."""
    from .copr.fused_group_agg import XWORDS

    out = np.zeros((len(values), XWORDS), dtype=np.int64)
    for i, v in enumerate(values):
        m, sign = abs(v), -1 if v < 0 else 1
        w = [sign * ((m >> (32 * k)) & 0xFFFFFFFF) for k in range(XWORDS)]
        if m >> (32 * XWORDS):
            raise ValueError("a value past the exact sum's words")
        if scramble:
            for k in range(XWORDS - 1):
                r = int(rng.integers(-(1 << 29), 1 << 29))
                w[k] += r << 32
                w[k + 1] -= r
        out[i] = w
    return out


def xround_edge_words(name: str, seed: int = 0) -> np.ndarray:
    """Exact f64 sums at the edges of the combine's rounding, as
    ``[n, XWORDS]`` int64 words (each value both in plain digits and
    scrambled): random signed words below 2^40 in all 66 positions (most
    sums past the f64 range) or in the 63 lowest (``_finite``); ties at the
    rounding bit with an even and an odd mantissa, one unit above and below
    each; subnormal results down to the smallest subnormal, and the
    smallest normal; sums that cancel to zero; negative sums; sums at and
    past the largest double."""
    from .copr.fused_group_agg import XWORDS

    rng = np.random.default_rng(seed)
    if name in ("random_words", "random_words_finite"):
        k = XWORDS if name == "random_words" else 63
        w = np.zeros((64, XWORDS), dtype=np.int64)
        w[:, :k] = rng.integers(-(1 << 40), 1 << 40, (64, k))
        return w
    top = (1 << 53) - 1
    if name == "ties":
        vals = []
        for m in ((1 << 52) + 2, (1 << 52) + 3, top - 1, top):  # even and odd mantissas
            for sh in (0, 1, 40, 700):
                tie = ((2 * m + 1) << sh) << 9  # half a unit of the last place past m
                vals += [tie, tie + 1, tie - 1]
    elif name == "subnormal":
        vals = [1, 2, 3, 12345, (1 << 52) - 1, 1 << 52, (1 << 53) + 1]
    elif name == "zero":
        vals = [0] * 8
    elif name == "negative":
        vals = [-1, -12345, -((2 * ((1 << 52) + 3) + 1) << 30), -(top << 900), -(1 << 2000) + 7]
    elif name == "huge":
        dbl_max = top << 2045  # the largest double, (2^53 - 1) 2^971, in units of 2^-1074
        half_ulp = 1 << 2044
        vals = [dbl_max, dbl_max + half_ulp - 1, dbl_max + half_ulp, -dbl_max - half_ulp,
                1 << 2100]
    else:
        raise ValueError(f"no rounding edge case {name!r}")
    return np.concatenate([_exact_words(vals, rng, False), _exact_words(vals, rng, True)])


def exact_word_value(words) -> float:
    """The double nearest (ties to even) the exact sum of one cell's words:
    Python's int division, which rounds correctly, the infinities past the
    range."""
    from fractions import Fraction

    v = sum(int(w) << (32 * k) for k, w in enumerate(words))
    try:
        return float(Fraction(v, 1 << 1074))
    except OverflowError:
        return float("inf") if v > 0 else float("-inf")


def wide_combine_crafted(device, seed: int = 0):
    """A wide-route state whose f64 sum cells hold the rounding's edge words
    (:func:`xround_edge_words`, every case) and every combination of the
    NaN and infinity flags, with a carry in the integer words' high halves
    (no word above 2^61): the ``host_wide`` program (every leaf kind) past
    ``c_max``, its other leaves as ``wide_partials_plain`` leaves them.
    Returns ``(prog, img, capacity, state)`` on ``device``."""
    from .copr import fused_group_agg as ga

    gen = torch.Generator(device=device).manual_seed(seed)
    prog, img, _cap = synthetic_group_case("host_wide", 4, 1 << 12, gen, device)
    words = np.concatenate([xround_edge_words(n, seed) for n in XROUND_EDGE_CASES])
    cap = max(prog.c_max + 1, len(words) + 8)
    state = ga.wide_partials_plain(prog, img, cap)
    flags, xacc = ga._wide_views(prog, cap, state)
    w = torch.from_numpy(words).to(device)
    for x, l in enumerate(prog.x_leaves):
        xacc[x, : len(words)] = w.roll(x, 0)
        xacc[x, len(words):] = 0
        flags[l] = 0
        flags[l, len(words) : len(words) + 8] = torch.arange(8, device=device)
    return prog, img, cap, state


def wide_combine_check(prog, img: Image, capacity: int, state: torch.Tensor) -> None:
    """``group_wide_combine`` over ``state`` against ``wide_combine_plain``,
    from the identity and into a carry (the plain pair's packed state):
    integer leaves equal, f64 leaves bit for bit with NaN equal to NaN.
    Raises on a difference."""
    from .copr import fused_group_agg as ga

    for carry in (None, ga.fused_group_agg_plain(prog, img, capacity)):
        out = ga.init_packed(prog, capacity, img.device)
        c = None if carry is None else tuple(t.clone() for t in carry)
        ga.launch_combine(prog, img, capacity, state, c, out)
        want = ga.wide_combine_plain(prog, img, capacity, state,
                                     None if carry is None else tuple(t.clone() for t in carry))
        if not torch.equal(out[0], want[0]):
            raise AssertionError("group_wide_combine: integer leaves differ")
        same = (out[1].view(torch.int64) == want[1].view(torch.int64)) \
            | (out[1].isnan() & want[1].isnan())
        if not bool(same.all()):
            at = (~same).nonzero()[:6].tolist()
            raise AssertionError(
                "group_wide_combine: f64 leaves differ from the plain version at "
                f"{[(r, c, float(out[1][r, c]), float(want[1][r, c])) for r, c in at]}")


def topn_merge_case(n_runs: int, n_words: int, k: int, seed: int, device, carry: bool = True):
    """``n_runs`` sorted top-K runs ``[n_runs, n_words, k]`` (and a carry
    run) on ``device``, drawn with numpy from ``seed``: the rank word 0 or 1,
    the middle words from a few values (ties in every word but ``src``,
    which is unique), the first two runs identical but for ``src``."""
    from .copr import fused_topn as ft

    rng = np.random.default_rng(seed)
    total = n_runs + (1 if carry else 0)
    e = np.zeros((total, n_words, k), dtype=np.int64)
    e[:, 0] = rng.integers(0, 2, size=(total, k))
    for w in range(1, n_words - 1):
        e[:, w] = rng.integers(-3, 3, size=(total, k))
    if total > 1:
        e[1, :-1] = e[0, :-1]
    e[:, -1] = rng.permutation(total * k).reshape(total, k)
    runs = torch.from_numpy(e)
    runs = torch.stack([r[:, ft._lexsort(r[:, None, :])[0]] for r in runs]).to(device)
    return runs[:n_runs].contiguous(), (runs[n_runs].contiguous() if carry else None)


def topn_merge_check(runs: torch.Tensor, extra, fan_in: int) -> torch.Tensor:
    """One ``topn_merge`` level on the card against ``merge_plain`` of CPU
    copies, exactly, and two launches bit for bit; returns its output."""
    from .copr import fused_topn as ft

    n, n_words, k = runs.shape
    shape = (-(-(n + (extra is not None)) // fan_in), n_words, k)
    outs = []
    for _ in range(2):
        out = torch.empty(shape, dtype=torch.int64, device=runs.device)
        ft.launch_merge(runs, extra, out, fan_in)
        outs.append(out)
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"topn_merge (fan-in {fan_in}): two runs differ")
    want = ft.merge_plain(runs.cpu(), None if extra is None else extra.cpu(), fan_in)
    if not torch.equal(outs[0].cpu(), want):
        raise AssertionError(f"topn_merge (fan-in {fan_in}, k {k}, {n_words} words) differs "
                             "from its plain version")
    return outs[0]


def image_on(img: Image, device) -> Image:
    """A copy of an image (plain or encoded) on ``device``."""
    def to(t):
        if t is None:
            return None
        return tuple(x.to(device) for x in t) if isinstance(t, tuple) else t.to(device)

    nv = img.n_valids if isinstance(img.n_valids, int) else to(img.n_valids)
    off = img.offsets if isinstance(img.offsets, int) else to(img.offsets)
    return Image([to(c) for c in img.cols], [to(m) for m in img.nulls], nv, img.n_blocks,
                 img.block_rows, torch.device(device), off, to(img.gids), img.descs, img.refs)


#: the old dictionaries of :func:`ids_case`: none; some slots the
#: sentinel, some keys not in the new one; the new one itself; one whose
#: every slot moves
IDS_OLD = ("none", "sentinels", "same", "moves")


def ids_case(cap: int, n: int, old_kind: str, seed: int, device):
    """Inputs of ``dict_ids`` at ``cap`` slots: a sorted dictionary of
    distinct even keys with its last eighth the sentinel, ``n`` keys below,
    above, equal to and between its keys and the sentinel, and an old
    dictionary of kind ``old_kind`` (:data:`IDS_OLD`) or None.  Returns
    ``(new, keys, old)`` on ``device``."""
    from .copr import fused_dict as fd

    rng = np.random.default_rng(seed)
    live = max(1, cap - cap // 8)
    vals = np.sort(rng.permutation(np.unique(rng.integers(1, 1 << 40, 2 * live)))[:live]) * 2
    live = len(vals)
    new = np.full(cap, fd.SENTINEL, dtype=np.int64)
    new[:live] = vals
    kinds = [vals[rng.integers(0, live, n)],                                # equal
             vals[rng.integers(0, live, n)] + 1,                            # between
             rng.integers(-(1 << 20), vals[0], n),                          # below
             rng.integers(int(vals[-1]) + 1, fd.SENTINEL, n),               # above
             np.full(n, fd.SENTINEL, dtype=np.int64)]                       # sentinel
    keys = np.choose(rng.integers(0, len(kinds), n), kinds)
    old = None
    if old_kind == "same":
        old = new.copy()
    elif old_kind == "moves":
        old = np.full(cap, fd.SENTINEL, dtype=np.int64)
        old[: live - 1] = vals[1:]
    elif old_kind == "sentinels":
        keep = np.sort(np.concatenate([vals[rng.random(live) < 0.5],
                                       vals[rng.integers(0, live, live // 4)] + 1]))
        keep = np.unique(keep)[:cap]
        old = np.full(cap, fd.SENTINEL, dtype=np.int64)
        old[: len(keep)] = keep
    elif old_kind != "none":
        raise ValueError(f"no old dictionary {old_kind!r}")

    def dev(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return dev(new), dev(keys), dev(old)


def ids_kernel_check(new: torch.Tensor, keys: torch.Tensor, old) -> dict:
    """``dict_ids`` on CUDA inputs twice, bit-identical, beside its plain
    version on CPU copies: the ids and (with ``old``) the perm equal.
    Raises on a difference; returns how many ids and perm slots it held."""
    from .copr import fused_dict as fd

    dev, cap = keys.device, new.numel()
    runs = []
    for _ in range(2):
        gids = torch.empty(keys.numel(), dtype=torch.int32, device=dev)
        perm = None if old is None else torch.empty(cap, dtype=torch.int32, device=dev)
        fd.dict_ids(new, keys, gids, old, perm)
        runs.append([gids.cpu()] + ([] if perm is None else [perm.cpu()]))
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("dict_ids: two runs differ")
    want_ids, want_perm = fd.dict_ids_plain(new.cpu(), keys.cpu(),
                                            None if old is None else old.cpu())
    if not torch.equal(runs[0][0], want_ids):
        raise AssertionError(f"dict_ids at {cap} slots: ids differ from the plain version")
    if old is not None and not torch.equal(runs[0][1], want_perm):
        raise AssertionError(f"dict_ids at {cap} slots: perm differs from the plain version")
    return {"ids": keys.numel(), "perm": 0 if old is None else cap}


def dict_kernel_check(prog, img: Image, old, cap: int) -> dict:
    """The three dictionary kernels on a CUDA image beside their plain
    versions on CPU copies of the same inputs: the keys and the range flag,
    the union of ``old`` and the keys (its capacity flag), the ids and the
    old slots' ``perm``, all equal; each kernel run twice, bit-identical.
    Raises on a difference; returns the flags and the dictionary's fill."""
    from .copr import fused_dict as fd

    dev = img.device
    runs = []
    for _ in range(2):
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        keys = fd.dict_keys(prog, img, flag)
        new = fd.dict_union(old, keys, cap, flag)
        gids = torch.empty(keys.numel(), dtype=torch.int32, device=dev)
        perm = torch.empty(cap, dtype=torch.int32, device=dev)
        fd.dict_ids(new, keys, gids, old, perm)
        runs.append([t.cpu() for t in (flag, keys, new, gids, perm)])
    if not all(torch.equal(a, b) for a, b in zip(*runs)):
        raise AssertionError("dictionary kernels: two runs differ")
    flag, keys, new, gids, perm = runs[0]
    want_keys, bad = fd.dict_keys_plain(prog, image_on(img, "cpu"))
    want_new, over = fd.dict_union_plain(old.cpu(), want_keys, cap)
    want_gids, want_perm = fd.dict_ids_plain(want_new, want_keys, old.cpu())
    want_flag = (fd.FLAG_RANGE if bad else 0) | (fd.FLAG_CAPACITY if over else 0)
    for what, got, want in (("dict_keys", keys, want_keys), ("dict_union", new, want_new),
                            ("dict_ids", gids, want_gids), ("dict_ids perm", perm, want_perm)):
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: differs from the plain version")
    if int(flag) != want_flag:
        raise AssertionError(f"dictionary flag {int(flag)}, plain version {want_flag}")
    return {"flag": want_flag, "live": int((want_new < fd.SENTINEL).sum())}


def mesh_merge_check(prog, parts, table, carry=None, lo: int = 0, hi: int | None = None,
                     perm=None, rel_tol: float = 1e-12) -> float:
    """``mesh_merge`` on CUDA inputs beside its plain version on the same
    inputs: integer words equal, f64 leaves to ``rel_tol`` (NaN equal to
    NaN), and a second launch bit-identical.  Raises on a difference;
    returns the largest absolute f64 difference."""
    from .copr import fused_mesh

    got = fused_mesh.mesh_merge(prog, parts, table, carry, lo, hi, perm=perm)
    again = fused_mesh.mesh_merge(prog, parts, table, carry, lo, hi, perm=perm)
    cpu = [tuple(t.cpu() for t in x) if x is not None else None for x in (parts, carry)]
    want = fused_mesh.mesh_merge_plain(prog, cpu[0], table.cpu(), cpu[1], lo, hi,
                                       None if perm is None else perm.cpu())
    if not torch.equal(got[0].cpu(), want[0]):
        raise AssertionError("mesh_merge: integer words differ from the plain version")
    if not (torch.equal(got[0], again[0])
            and torch.equal(got[1].view(torch.int64), again[1].view(torch.int64))):
        raise AssertionError("mesh_merge: two runs differ")
    return _f64_err(got[1].cpu(), want[1], rel_tol, "mesh_merge")


def mesh_fold_check(prog, rows, shards, base: int, width: int, windows, perm=None,
                    images=None, rel_tol: float = 1e-12) -> float:
    """``mesh_fold`` on CUDA inputs beside its plain version on the same
    inputs (integer words equal, f64 leaves to ``rel_tol``, NaN equal to
    NaN) and, given the shards' ``images``, beside :func:`fold_pair` (every
    word equal, f64 leaves bit for bit); a second launch bit-identical.
    The carries are left as they are.  Raises on a difference; returns the
    largest absolute f64 difference from the plain version."""
    from .copr import fused_mesh

    got = fused_mesh.mesh_fold(prog, rows, shards, base, width, windows, perm=perm)
    again = fused_mesh.mesh_fold(prog, rows, shards, base, width, windows, perm=perm)
    cpu_windows = [(lo, None if c is None else tuple(t.cpu() for t in c)) for lo, c in windows]
    want = fused_mesh.mesh_fold_plain(prog, rows.cpu(), shards.cpu(), base, width, cpu_windows,
                                      None if perm is None else perm.cpu())
    pair = None if images is None else fold_pair(prog, rows, shards, width, windows, images,
                                                 perm)
    err = 0.0
    for i, (g, a, w) in enumerate(zip(got, again, want)):
        if not torch.equal(g[0].cpu(), w[0]):
            raise AssertionError(f"mesh_fold window {i}: integer words differ from the plain "
                                 "version")
        if not (torch.equal(g[0], a[0]) and torch.equal(g[1].view(torch.int64),
                                                        a[1].view(torch.int64))):
            raise AssertionError(f"mesh_fold window {i}: two runs differ")
        if pair is not None and not (torch.equal(g[0], pair[i][0]) and torch.equal(
                g[1].view(torch.int64), pair[i][1].view(torch.int64))):
            raise AssertionError(f"mesh_fold window {i}: not the combines and mesh_merge bit "
                                 "for bit")
        err = max(err, _f64_err(g[1].cpu(), w[1], rel_tol, "mesh_fold"))
    return err


# ---------------------------------------------------------------------------
# Per-supplier statistics: group slots past the grouped pair's shared memory
# ---------------------------------------------------------------------------

#: TPC-H's suppliers per scale factor (spec 4.2.3, l_suppkey) and lineitem's
#: rows at scale factor 1
SUPPLIERS_PER_SF = 10_000
LINEITEM_SF1_ROWS = 6_001_215
#: TPC-H Q15's revenue window, l_shipdate in [1996-01-01, 1996-04-01), days
Q15_SHIP_LO, Q15_SHIP_HI = 9496, 9587
SHIP_MODES = (b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB")
SHIP_INSTRUCTS = (b"DELIVER IN PERSON", b"COLLECT COD", b"NONE", b"TAKE BACK RETURN")
#: the supplier table's columns past lineitem(): l_suppkey, the price as a
#: DOUBLE, l_shipmode, l_shipinstruct; the KV rows carry the first two
SUPP, PRICE_F, MODE, INSTR = 7, 8, 9, 10
SUPP_KV_COLS = 9


def suppliers(n: int) -> int:
    """Suppliers that a lineitem image of ``n`` rows draws l_suppkey from:
    ``10,000 * SF`` with ``SF = n / 6,001,215``; an image of fewer rows is a
    region of an SF-1 table, whose 10,000 suppliers it draws from."""
    return round(SUPPLIERS_PER_SF * max(1.0, n / LINEITEM_SF1_ROWS))


def supp_schema() -> list[ColumnInfo]:
    """lineitem() and l_suppkey (INT), l_extendedprice stored as a DOUBLE
    (as a TiDB table with a DOUBLE price holds it), l_shipmode and
    l_shipinstruct (varchar); every column NOT NULL."""
    def nn(ft):
        ft.flag |= NOT_NULL_FLAG
        return ft

    return lineitem() + [ColumnInfo(8, nn(FieldType.int64())),
                         ColumnInfo(9, nn(FieldType.double())),
                         ColumnInfo(10, nn(FieldType.varchar())),
                         ColumnInfo(11, nn(FieldType.varchar()))]


def supp_arrays(n: int, seed: int = 0, arrays: dict | None = None) -> dict:
    """:func:`build_arrays`' draws (or ``arrays``, the same draws) and, from
    a second stream of the seed, l_suppkey uniform over ``1 ..``
    :func:`suppliers` ``(n)``, l_shipmode's and l_shipinstruct's codes; the
    DOUBLE price is ``price / 100``."""
    a = dict(build_arrays(n, seed) if arrays is None else arrays)
    rng = np.random.default_rng([seed, 15])
    a["supp"] = rng.integers(1, suppliers(n) + 1, n)
    a["mode"] = rng.integers(0, len(SHIP_MODES), n)
    a["instr"] = rng.integers(0, len(SHIP_INSTRUCTS), n)
    a["price_f"] = a["price"] / 100.0
    return a


def supp_kvs(n: int, seed: int = 0) -> list[tuple[bytes, bytes]]:
    """Record bytes of the supplier table's first :data:`SUPP_KV_COLS`
    columns (lineitem's, l_suppkey, the DOUBLE price), one fixed layout
    filled by batch codecs as :func:`build_kvs` does."""
    from .util.codec import encode_f64_batch

    a = supp_arrays(n, seed)
    schema = supp_schema()[:SUPP_KV_COLS]
    row0 = encode_row(schema[1:], [1, 1, 1, 1, b"A", b"F", 1, 1.0])
    layout = RowBatchDecoder(schema)._parse_layout(row0)
    mat = np.tile(np.frombuffer(row0, dtype=np.uint8), (n, 1))
    for col_id, arr in ((2, a["qty"]), (3, a["price"]), (4, a["disc"]), (5, a["ship"]),
                        (8, a["supp"])):
        _kind, off = layout["cols"][col_id]
        mat[:, off : off + 8] = encode_i64_batch(arr)
    _kind, off = layout["cols"][9]
    mat[:, off : off + 8] = encode_f64_batch(a["price_f"])
    for col_id, key, vals in ((6, "rf", b"ANR"), (7, "ls", b"FO")):
        _k, off = layout["cols"][col_id]
        mat[:, off] = np.frombuffer(vals, dtype=np.uint8)[a[key]]
    kmat = np.tile(np.frombuffer(record_key(TABLE_ID, 0), dtype=np.uint8), (n, 1))
    kmat[:, 11:19] = encode_i64_batch(np.arange(n, dtype=np.int64))
    return list(zip((r.tobytes() for r in kmat), (r.tobytes() for r in mat)))


def supp_cache(n: int, block_rows: int, seed: int = 0, arrays: dict | None = None):
    """The supplier table's image as a filled ``ColumnBlockCache``: every
    column of :func:`supp_schema`, varchar as dictionary codes; ``arrays``
    reuses :func:`supp_arrays`' draws (their slices are the image's)."""
    a = supp_arrays(n, seed) if arrays is None else arrays
    dicts = {}
    for key, vals in (("rf", b"ANR"), ("ls", b"FO")):
        dicts[key] = np.empty(len(vals), dtype=object)
        dicts[key][:] = [vals[i : i + 1] for i in range(len(vals))]
    for key, vals in (("mode", SHIP_MODES), ("instr", SHIP_INSTRUCTS)):
        dicts[key] = np.empty(len(vals), dtype=object)
        dicts[key][:] = list(vals)
    handles = np.arange(n, dtype=np.int64)
    cache = ColumnBlockCache()
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        cache.add([Column(EvalType.INT, handles[s:e], nz),
                   Column(EvalType.INT, a["qty"][s:e], nz),
                   Column(EvalType.DECIMAL, a["price"][s:e], nz, 2),
                   Column(EvalType.DECIMAL, a["disc"][s:e], nz, 2),
                   Column(EvalType.INT, a["ship"][s:e], nz)]
                  + [Column(EvalType.BYTES, a[k][s:e], nz, 0, dicts[k]) for k in ("rf", "ls")]
                  + [Column(EvalType.INT, a["supp"][s:e], nz),
                     Column(EvalType.REAL, a["price_f"][s:e], nz)]
                  + [Column(EvalType.BYTES, a[k][s:e], nz, 0, dicts[k])
                     for k in ("mode", "instr")], e - s)
    cache.filled = True
    return cache


def _q15_window():
    return [call("ge", col(4), const_int(Q15_SHIP_LO)), call("lt", col(4), const_int(Q15_SHIP_HI))]


def supp_dag() -> DagRequest:
    """Per-supplier statistics over TPC-H Q15's window: count(*),
    sum(l_extendedprice * (1 - l_discount)), avg(l_extendedprice),
    var_pop(l_extendedprice), min(l_discount), max(l_discount) GROUP BY
    l_suppkey.  var_pop's sum of squares is an f64 leaf."""
    price, disc = col(2), col(3)
    aggs = [AggDescriptor("count", None),
            AggDescriptor("sum", call("multiply", price, call("minus", const_int(1), disc))),
            AggDescriptor("avg", price), AggDescriptor("var_pop", price),
            AggDescriptor("min", disc), AggDescriptor("max", disc)]
    return DagRequest(executors=[TableScan(TABLE_ID, supp_schema()[:SUPP_KV_COLS]),
                                 Selection(_q15_window()), Aggregation([col(SUPP)], aggs)])


def supp_first_dag() -> DagRequest:
    """The DOUBLE price per supplier over Q15's window: first, min, max,
    sum and var_pop (REAL sums, extremes and first's f64 value)."""
    aggs = [AggDescriptor(op, col(PRICE_F)) for op in ("first", "min", "max", "sum", "var_pop")]
    return DagRequest(executors=[TableScan(TABLE_ID, supp_schema()[:SUPP_KV_COLS]),
                                 Selection(_q15_window()), Aggregation([col(SUPP)], aggs)])


def _first_ordered(key: np.ndarray, m: np.ndarray):
    """The rows of ``m`` grouped by ``key`` (any int64): ``(rows, starts,
    order)`` — rows sorted by key (each key's rows ascending), where each
    key's run starts, and the runs in order of their first row."""
    rows = np.flatnonzero(m)
    k = key[rows]
    by = np.argsort(k, kind="stable")
    rows, k = rows[by], k[by]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]]) if len(k) else np.zeros(0, np.int64)
    return rows, starts, np.argsort(rows[starts], kind="stable")


def _q15_mask(a: dict) -> np.ndarray:
    return (a["ship"] >= Q15_SHIP_LO) & (a["ship"] < Q15_SHIP_HI)


def supp_oracle(a: dict) -> list:
    """:func:`supp_dag`'s response rows from the draws, in the order of each
    supplier's first qualifying row: var_pop's partial state is (count, sum
    as a double, sum of squares of the scaled price)."""
    rows, starts, order = _first_ordered(a["supp"], _q15_mask(a))
    if not len(rows):
        return []
    counts = np.diff(np.r_[starts, len(rows)])
    price = a["price"][rows].astype(np.int64)
    rev = np.add.reduceat(price * (100 - a["disc"][rows]), starts)
    psum = np.add.reduceat(price, starts)
    sq = np.add.reduceat(price.astype(np.float64) ** 2, starts)
    dmin = np.minimum.reduceat(a["disc"][rows], starts)
    dmax = np.maximum.reduceat(a["disc"][rows], starts)
    out = []
    for g in order:
        n = int(counts[g])
        out.append([n, (int(rev[g]), 4), n, (int(psum[g]), 2), n, float(psum[g]), float(sq[g]),
                    (int(dmin[g]), 2), (int(dmax[g]), 2), int(a["supp"][rows[starts[g]]])])
    return out


def supp_first_oracle(a: dict) -> list:
    """:func:`supp_first_dag`'s response rows from the draws (f64 sums by
    numpy: compare them to a relative tolerance)."""
    rows, starts, order = _first_ordered(a["supp"], _q15_mask(a))
    if not len(rows):
        return []
    counts = np.diff(np.r_[starts, len(rows)])
    x = a["price_f"][rows]
    xmin, xmax = np.minimum.reduceat(x, starts), np.maximum.reduceat(x, starts)
    xsum, sq = np.add.reduceat(x, starts), np.add.reduceat(x * x, starts)
    out = []
    for g in order:
        n, r0 = int(counts[g]), rows[starts[g]]
        out.append([float(a["price_f"][r0]), float(xmin[g]), float(xmax[g]), float(xsum[g]),
                    n, float(xsum[g]), float(sq[g]), int(a["supp"][r0])])
    return out


FLAG_KEYS = ((5, "rf", b"ANR"), (6, "ls", b"FO"), (MODE, "mode", SHIP_MODES),
             (INSTR, "instr", SHIP_INSTRUCTS))


def flags4_dag(var_pop: bool = False) -> DagRequest:
    """Q1's aggregates grouped by TPC-H's four flag columns (l_returnflag,
    l_linestatus, l_shipmode, l_shipinstruct): 4 x 3 x 8 x 5 = 480 coded
    slots with the NULL codes, past a batch task's shared-memory rows.
    ``var_pop`` adds var_pop(l_extendedprice) and sum of the DOUBLE price:
    f64 leaves."""
    aggs = list(q1_dag().executors[-1].agg_funcs)
    if var_pop:
        aggs += [AggDescriptor("var_pop", col(2)), AggDescriptor("sum", col(PRICE_F))]
    return DagRequest(executors=[TableScan(TABLE_ID, supp_schema()),
                                 Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
                                 Aggregation([col(c) for c, _k, _v in FLAG_KEYS], aggs)])


def flags4_oracle(a: dict, var_pop: bool = False) -> list:
    """:func:`flags4_dag`'s response rows from the draws, in the order of
    each group's first qualifying row (by counting: 168 keys)."""
    key = np.zeros(len(a["rf"]), dtype=np.int64)
    for _c, k, vals in FLAG_KEYS:
        key = key * len(vals) + a[k]
    m = a["ship"] <= Q1_SHIP_HI
    rows = np.flatnonzero(m)
    k = key[rows]
    n_keys = int(np.prod([len(vals) for _c, _k, vals in FLAG_KEYS]))
    first = np.full(n_keys, -1, dtype=np.int64)
    first[k[::-1]] = rows[::-1]  # the last store wins: each key's first row
    counts = np.bincount(k, minlength=n_keys)

    def total(x):  # exact: integer sums stay below 2^53
        return np.bincount(k, weights=x[rows].astype(np.float64), minlength=n_keys)

    qty, price, disc = (total(a[c]).astype(np.int64) for c in ("qty", "price", "disc"))
    if var_pop:
        sq = np.bincount(k, weights=a["price"][rows].astype(np.float64) ** 2, minlength=n_keys)
        psum_f = np.bincount(k, weights=a["price_f"][rows], minlength=n_keys)
    out = []
    present = np.flatnonzero(counts)
    for g in present[np.argsort(first[present], kind="stable")]:
        n, p, r0 = int(counts[g]), int(price[g]), first[g]
        row = [int(qty[g]), (p, 2), n, (p, 2), n, (int(disc[g]), 2), n]
        if var_pop:
            row += [n, float(p), float(sq[g]), float(psum_f[g])]
        out.append(row + [vals[a[kk][r0]] if isinstance(vals, tuple) else vals[a[kk][r0]:][:1]
                          for _c, kk, vals in FLAG_KEYS])
    return out


def supp_columns(a: dict, start: int, end: int, rows: int | None = None) -> dict:
    """Rows ``[start, end)`` of :func:`supp_arrays`' draws as the sharded
    evaluators' host columns of the supplier table's first
    :data:`SUPP_KV_COLS` columns, ``{column: (data, nulls)}``, no NULLs;
    zeros pad them to ``rows`` (a super-block's) when given."""
    names = ("qty", "price", "disc", "ship", "rf", "ls", "supp", "price_f")
    cols = [np.arange(start, end, dtype=np.int64)] + [a[k][start:end] for k in names]
    if rows is not None and rows != end - start:
        cols = [np.concatenate([c, np.zeros(rows - len(c), dtype=c.dtype)]) for c in cols]
    nz = np.zeros(len(cols[0]), dtype=bool)
    return {j: (c, nz) for j, c in enumerate(cols)}


def supp_mesh_oracle(a: dict) -> dict:
    """:func:`supp_dag`'s answer in ``ShardedGroupedEvaluator.finalize``'s
    form: the suppliers (the packed keys) in order of their first
    qualifying row, those rows, and per aggregate its leaves (count, then
    the sum, the extreme or the sum and the f64 sum of squares)."""
    rows, starts, order = _first_ordered(a["supp"], _q15_mask(a))
    counts = np.diff(np.r_[starts, len(rows)]).astype(np.int64)
    price = a["price"][rows].astype(np.int64)
    rev = np.add.reduceat(price * (100 - a["disc"][rows]), starts)
    psum = np.add.reduceat(price, starts)
    sq = np.add.reduceat(price.astype(np.float64) ** 2, starts)
    disc = a["disc"][rows].astype(np.int64)
    dmin, dmax = np.minimum.reduceat(disc, starts), np.maximum.reduceat(disc, starts)
    c = counts[order]
    return {"keys": a["supp"][rows[starts]][order].astype(np.int64),
            "first": rows[starts][order].astype(np.int64),
            "aggs": [(c,), (c, rev[order]), (c, psum[order]), (c, psum[order], sq[order]),
                     (c, dmin[order]), (c, dmax[order])]}


# ---------------------------------------------------------------------------
# An MVCC region of lineitem: the write path's engine and its write batches
# ---------------------------------------------------------------------------

REGION_ID = 1
REGION_EPOCH = (1, 1)
NEW_FLAG = b"X"  # an l_returnflag value the draws never make: it grows the dictionary


def region_context(apply_index: int) -> dict:
    """The request context ``RegionColumnCache.serve`` keys an image by."""
    return {"region_id": REGION_ID, "region_epoch": REGION_EPOCH, "apply_index": apply_index}


def _write_keys(handles: np.ndarray, commit_ts: int) -> list[bytes]:
    """CF_WRITE keys of the records at ``handles``: the memcomparable
    encoding of each 19-byte record key (two full groups of 8 bytes, then 3
    bytes padded with 5 zeros, each group followed by its marker) and the
    descending commit ts, filled as one byte matrix."""
    n = len(handles)
    raw = np.tile(np.frombuffer(record_key(TABLE_ID, 0), dtype=np.uint8), (n, 1))
    raw[:, 11:19] = encode_i64_batch(np.asarray(handles, dtype=np.int64))
    out = np.zeros((n, 35), dtype=np.uint8)
    out[:, 0:8], out[:, 9:17], out[:, 18:21] = raw[:, 0:8], raw[:, 8:16], raw[:, 16:19]
    out[:, 8] = out[:, 17] = 0xFF
    out[:, 26] = 0xFF - 5
    out[:, 27:35] = np.frombuffer(encode_u64(commit_ts ^ 0xFFFFFFFFFFFFFFFF), dtype=np.uint8)
    return [r.tobytes() for r in out]


def _write_records(values: list[bytes], start_ts: int) -> list[bytes]:
    """PUT write records with each value inline as a short value (every
    lineitem row is far under 255 bytes), as ``tests/fixtures.py``'s
    ``put_committed`` writes them."""
    # the record of an empty short value, less its length byte
    head = Write(WriteType.PUT, start_ts, short_value=b"").to_bytes()[:-1]
    return [head + bytes([len(v)]) + v for v in values]


def region_engine(a: dict, start_ts: int = 90, commit_ts: int = 100) -> BTreeEngine:
    """The port's in-memory engine holding ``build_kvs(arrays=a)``'s rows as
    versions committed at ``commit_ts``: the region the write path fills
    its image from."""
    kvs = build_kvs(0, arrays=a)
    eng = BTreeEngine()
    eng.bulk_load(CF_WRITE, zip(_write_keys(_handles(a), commit_ts),
                                _write_records([v for _k, v in kvs], start_ts)))
    return eng


def region_write(a: dict, seed: int, n_update: int = 0, n_insert: int = 0, n_delete: int = 0,
                 q6_movers: int = 0, new_flag: bool = False):
    """A write batch over the rows of ``a``, drawn with numpy from ``seed``:
    ``n_update`` rows are amended in place, a new quantity, price, discount
    and line status (``build_arrays``' ranges) with their ship date and
    return flag kept; of them ``q6_movers`` rows with l_shipdate >= 10000
    move into Q6's window (in a date-ordered region their blocks' zone maps
    excluded it), and with ``new_flag`` one in eight of them (at least one)
    takes ``NEW_FLAG`` as its return flag;
    ``n_insert`` rows are added past the largest handle and ``n_delete``
    rows removed.  Returns ``(arrays after the batch, handles put, handles
    deleted)``, the arrays carrying ``"handle"`` and ``"flags"`` for the
    oracles."""
    rng = np.random.default_rng(seed)
    n = len(a["qty"])
    handles = _handles(a)
    movers = rng.choice(np.flatnonzero(a["ship"] >= 10000), q6_movers, replace=False)
    rest = rng.choice(np.setdiff1d(np.arange(n), movers), n_update - q6_movers + n_delete,
                      replace=False)
    upd = np.concatenate([movers, rest[: n_update - q6_movers]]).astype(np.int64)
    dele = rest[n_update - q6_movers:]
    b = {k: a[k].copy() for k in ("qty", "price", "disc", "ship", "rf", "ls")}
    b["handle"], b["flags"] = handles.copy(), a.get("flags", b"ANR")
    fresh = build_arrays(len(upd) + n_insert, seed + 1)
    for k in ("qty", "price", "disc", "ls"):
        b[k][upd] = fresh[k][: len(upd)]
    m = upd[:q6_movers]
    b["ship"][m] = rng.integers(Q6_SHIP_LO, Q6_SHIP_HI, len(m))
    b["disc"][m] = rng.integers(Q6_DISC_LO, Q6_DISC_HI + 1, len(m))
    b["qty"][m] = rng.integers(1, Q6_QTY_LT, len(m))
    if new_flag:
        if NEW_FLAG not in b["flags"]:
            b["flags"] += NEW_FLAG
        b["rf"][upd[: max(1, len(upd) // 8)]] = b["flags"].index(NEW_FLAG)
    if n_insert:
        for k in ("qty", "price", "disc", "ship", "rf", "ls"):
            b[k] = np.concatenate([b[k], fresh[k][len(upd):]])
        b["handle"] = np.concatenate([b["handle"], handles.max(initial=-1) + 1
                                      + np.arange(n_insert, dtype=np.int64)])
    puts = np.sort(np.concatenate([handles[upd], b["handle"][n:]]))
    deleted = np.sort(handles[dele])
    if len(dele):
        keep = np.ones(len(b["qty"]), dtype=bool)
        keep[dele] = False
        for k in ("qty", "price", "disc", "ship", "rf", "ls", "handle"):
            b[k] = b[k][keep]
    return b, puts, deleted


def region_write_ops(b: dict, puts: np.ndarray, deleted: np.ndarray, start_ts: int,
                     commit_ts: int) -> list:
    """The ops of :func:`region_write`'s batch committed at ``commit_ts``,
    as the raft apply path emits them: per key its CF_WRITE record (a PUT
    with the row inline, or a DELETE) and the CF_LOCK delete of its commit.
    ``b`` is the batch's arrays after it."""
    at = np.searchsorted(b["handle"], puts)
    sub = {k: b[k][at] for k in ("qty", "price", "disc", "ship", "rf", "ls", "handle")}
    sub["flags"] = b["flags"]
    values = [v for _k, v in build_kvs(0, arrays=sub)]
    recs = _write_records(values, start_ts)
    del_rec = Write(WriteType.DELETE, start_ts).to_bytes()
    ops = [("put", CF_WRITE, k, r) for k, r in zip(_write_keys(puts, commit_ts), recs)]
    ops += [("put", CF_WRITE, k, del_rec) for k in _write_keys(deleted, commit_ts)]
    both = np.concatenate([puts, deleted])
    ops += [("delete", CF_LOCK, k[:-8], None) for k in _write_keys(both, commit_ts)]
    return ops


def apply_region_ops(engine: BTreeEngine, ops) -> None:
    """Apply ``ops`` to ``engine``: each column family's puts with one sort,
    then the deletes."""
    puts: dict[str, list] = {}
    wb = WriteBatch()
    for op, cf, key, val in ops:
        if op == "put":
            puts.setdefault(cf, []).append((key, val))
        else:
            wb.delete_cf(cf, key)
    for cf, items in puts.items():
        engine.bulk_load(cf, items)
    engine.write(wb)


def patch_case(n_blocks: int, block_rows: int, n_data: int, n_null: int, n_upd: int,
               seed: int, device):
    """Inputs of ``fused_patch.patch_stacked``: ``n_data`` lanes of
    ``[n_blocks, block_rows]`` (even lanes int64, odd lanes f64), ``n_null``
    bool lanes, and ``n_upd`` updates at unique positions spread over every
    block, their words (the f64 lanes' include NaN, -0.0 and +-inf) and
    null flags.  Returns ``(lanes, null lanes, positions, words, nulls)``."""
    rng = np.random.default_rng(seed)
    shape = (n_blocks, block_rows)
    lanes = [torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, shape) if j % 2 == 0
                              else rng.standard_normal(shape)).to(device) for j in range(n_data)]
    null_lanes = [torch.from_numpy(rng.random(shape) < 0.2).to(device) for _ in range(n_null)]
    pos = rng.choice(n_blocks * block_rows, n_upd, replace=False).astype(np.int64)
    words = []
    for j in range(n_data):
        if j % 2 == 0:
            words.append(rng.integers(-(1 << 62), 1 << 62, n_upd))
        else:
            f = rng.standard_normal(n_upd)
            f[: min(4, n_upd)] = [np.nan, -0.0, np.inf, -np.inf][: min(4, n_upd)]
            words.append(f.view(np.int64))
    vals = np.array(words, dtype=np.int64).reshape(n_data, n_upd)
    nls = rng.random((n_null, n_upd)) < 0.5
    return lanes, null_lanes, pos, vals, nls


def patch_kernel_check(lanes, null_lanes, pos, vals, nls) -> int:
    """``patch_stacked`` on copies of the lanes against its plain version on
    other copies, bit for bit (f64 lanes compared as their int64 words);
    raises AssertionError on the first lane that differs.  Returns the
    kernel launches it made (1)."""
    from .copr import fused_agg, fused_patch

    dev = (lanes or null_lanes)[0].device
    k_lanes, p_lanes = [t.clone() for t in lanes], [t.clone() for t in lanes]
    k_nulls, p_nulls = [t.clone() for t in null_lanes], [t.clone() for t in null_lanes]
    before = fused_agg.LAUNCHES["patch_stacked"]
    fused_patch.patch_stacked(k_lanes, k_nulls, pos, vals, nls)
    fused_patch.patch_stacked_plain(p_lanes, p_nulls, torch.from_numpy(pos).to(dev),
                                    torch.from_numpy(vals).to(dev), torch.from_numpy(nls).to(dev))
    for j, (k, p) in enumerate(zip(k_lanes, p_lanes)):
        if not torch.equal(k.view(torch.int64), p.view(torch.int64)):
            raise AssertionError(f"patch_stacked: data lane {j} differs from the plain version")
    for j, (k, p) in enumerate(zip(k_nulls, p_nulls)):
        if not torch.equal(k, p):
            raise AssertionError(f"patch_stacked: null lane {j} differs from the plain version")
    return fused_agg.LAUNCHES["patch_stacked"] - before
