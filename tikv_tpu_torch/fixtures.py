"""TPC-H lineitem fixtures for the port: KV bytes, columnar images, plans.

The port's own copy of ``bench.py``'s ``build_arrays`` / ``build_kvs`` /
``build_cache`` and its Q6 plan.  ``build_arrays(n, seed)`` makes the same
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
from .copr.rpn import call, col, compile_expr, const_decimal, const_int, const_real
from .copr.table import RowBatchDecoder, encode_row, record_key
from .util.codec import encode_i64_batch

TABLE_ID = 101

# Q6 predicate bounds: shipdate in [9000, 9365), discount in [0.02, 0.04],
# quantity < 24
Q6_SHIP_LO, Q6_SHIP_HI = 9000, 9365
Q6_DISC_LO, Q6_DISC_HI = 2, 4
Q6_QTY_LT = 24


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
