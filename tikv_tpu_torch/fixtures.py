"""TPC-H lineitem fixtures for the port: KV bytes, columnar images, plans.

The port's own copy of ``bench.py``'s ``build_arrays`` / ``build_kvs`` /
``build_cache`` and its Q6 and Q1 plans.  ``build_arrays(n, seed)`` makes the same
draws as ``bench.py`` for the same ``(n, seed)``, so both packages see the
same table.  The numpy oracles compute each query's answer from those draws
alone, independently of any evaluator.
"""

from __future__ import annotations

import numpy as np
import torch

from .copr.aggr import AggDescriptor
from .copr.cache import ColumnBlockCache
from .copr.dag import Aggregation, DagRequest, Selection, TableScan
from .copr.datatypes import NOT_NULL_FLAG, Column, ColumnInfo, EvalType, FieldType
from .copr.fused_agg import Image, compile_program
from .copr.fused_group_agg import compile_group_program
from .copr.rpn import call, col, compile_expr, const_decimal, const_int, const_real
from .copr.table import RowBatchDecoder, encode_row, record_key
from .util.codec import encode_i64_batch

TABLE_ID = 101

# Q6 predicate bounds: shipdate in [9000, 9365), discount in [0.02, 0.04],
# quantity < 24
Q6_SHIP_LO, Q6_SHIP_HI = 9000, 9365
Q6_DISC_LO, Q6_DISC_HI = 2, 4
Q6_QTY_LT = 24
# Q1 predicate: shipdate <= 10500
Q1_SHIP_HI = 10500


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


def build_kvs(n: int, seed: int = 0) -> list[tuple[bytes, bytes]]:
    """Record (key, value) bytes of the lineitem table.  Rows share one fixed
    datum layout, so the table is a byte matrix filled by batch codecs."""
    a = build_arrays(n, seed)
    schema = lineitem()
    flags = np.frombuffer(b"ANR", dtype=np.uint8)
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
    kmat[:, 11:19] = encode_i64_batch(np.arange(n, dtype=np.int64))
    keys = [r.tobytes() for r in kmat]
    return list(zip(keys, values))


def build_cache(n: int, block_rows: int, seed: int = 0, arrays: dict | None = None):
    """The decoded-column image of ``build_kvs(n, seed)`` as a filled
    ``ColumnBlockCache``, without materializing n byte strings: ints and
    decimals as int64, varchar as dictionary codes sharing one dictionary.
    ``arrays`` reuses draws already made by ``build_arrays(n, seed)``."""
    a = build_arrays(n, seed) if arrays is None else arrays
    dict_rf = np.empty(3, dtype=object)
    dict_rf[:] = [b"A", b"N", b"R"]
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


def q1_dag() -> DagRequest:
    """TPC-H Q1's shape (``bench.q1_dag``): sum(quantity), sum(price),
    avg(price), avg(discount), count(*) grouped by (returnflag,
    linestatus) under shipdate <= 10500."""
    aggs = [
        AggDescriptor("sum", col(1)),
        AggDescriptor("sum", col(2)),
        AggDescriptor("avg", col(2)),
        AggDescriptor("avg", col(3)),
        AggDescriptor("count", None),
    ]
    return DagRequest(executors=[TableScan(TABLE_ID, lineitem()),
                                 Selection([call("le", col(4), const_int(Q1_SHIP_HI))]),
                                 Aggregation([col(5), col(6)], aggs)])


def q1_oracle(a: dict) -> list:
    """Q1's response rows from the raw draws, one per group that has a
    qualifying row, in the order of each group's first qualifying row."""
    m = a["ship"] <= Q1_SHIP_HI
    key = a["rf"] * 2 + a["ls"]
    rows = []
    for k in np.unique(key[m]):
        sel = m & (key == k)
        n = int(sel.sum())
        price = int(a["price"][sel].astype(np.int64).sum())
        rf, ls = divmod(int(k), 2)
        rows.append((int(np.argmax(sel)), [
            int(a["qty"][sel].astype(np.int64).sum()), (price, 2), n, (price, 2),
            n, (int(a["disc"][sel].astype(np.int64).sum()), 2), n,
            b"ANR"[rf : rf + 1], b"FO"[ls : ls + 1]]))
    return [r for _first, r in sorted(rows, key=lambda fr: fr[0])]


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
    rows = []
    for q in np.unique(a["qty"][m]):
        sel = m & (a["qty"] == q)
        n = int(sel.sum())
        rows.append((int(np.argmax(sel)), [
            n, (int(a["price"][sel].astype(np.int64).sum()), 2), n,
            (int(a["disc"][sel].astype(np.int64).sum()), 2), int(a["ship"][sel].max()), int(q)]))
    return [r for _first, r in sorted(rows, key=lambda fr: fr[0])]


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
GROUP_CASES = ("coded", "host", "host_many")


def synthetic_group_case(kind: str, n_blocks: int, block_rows: int, gen: torch.Generator,
                         device):
    """A grouped program, its image and its capacity, for holding the grouped
    kernels to their plain version.  ``kind``: ``"coded"`` — ids from two
    dictionary-code columns with NULLs (4 x 5 = 20 slots), all ten aggregates;
    ``"host"`` — 60 host group ids, all ten aggregates; ``"host_many"`` — 300
    host group ids, integer leaves only (past the shared-memory capacity, so
    the atomic partials).  Columns as :func:`synthetic_case`, with a ragged
    last block and (with more than four blocks) empty ones; f64 values are
    non-negative."""
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
    prog = compile_group_program(sel_rpns, agg_rpns, ship, schema,
                                 (5, 6) if coded else None, dict_lens if coded else ())
    shape = (n_blocks, block_rows)

    def ints(lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int64)

    def null_mask(p):
        return torch.rand(shape, generator=gen, device=device) < p

    cols = [ints(-(1 << 40), 1 << 40), ints(-10**9, 10**9),
            torch.rand(shape, generator=gen, device=device, dtype=torch.float64) * 1000.0,
            ints(0, 1000), ints(-10**6, 10**6)]
    nulls = [None, null_mask(0.1), null_mask(0.05), null_mask(0.2), None]
    gids = None
    if coded:
        cols += [ints(0, dict_lens[0]), ints(0, dict_lens[1])]
        nulls += [null_mask(0.1), null_mask(0.05)]
        capacity = 32
    else:
        n_groups = 300 if kind == "host_many" else 60
        gids = ints(0, n_groups).to(torch.int32)
        capacity = 512 if kind == "host_many" else 64
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
