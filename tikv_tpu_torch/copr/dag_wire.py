"""DagRequest ⇄ wire dict conversion (the tipb-protobuf role for the RPC).

The port's copy of ``tikv_tpu/copr/dag_wire.py``.  A request crosses into
the port as this wire dict, the form the RPC carries.
"""

from __future__ import annotations

from .aggr import AggDescriptor
from .dag import (
    Aggregation,
    DagRequest,
    IndexScan,
    Join,
    Limit,
    Projection,
    Selection,
    TableScan,
    TopN,
)
from .datatypes import ColumnInfo, EvalType, FieldType, FieldTypeTp
from .rpn import ColumnRef, Constant, FuncCall


def expr_to_wire(e) -> dict:
    if isinstance(e, ColumnRef):
        return {"t": "col", "i": e.index}
    if isinstance(e, Constant):
        return {"t": "const", "v": e.value, "et": e.eval_type.value, "frac": e.frac}
    if isinstance(e, FuncCall):
        return {"t": "call", "op": e.op, "args": [expr_to_wire(c) for c in e.children]}
    raise TypeError(e)


def expr_from_wire(d: dict):
    if d["t"] == "col":
        return ColumnRef(d["i"])
    if d["t"] == "const":
        return Constant(d["v"], EvalType(d["et"]), d.get("frac", 0))
    if d["t"] == "call":
        return FuncCall(d["op"], [expr_from_wire(a) for a in d["args"]])
    raise ValueError(d)


def _col_info_to_wire(c: ColumnInfo) -> dict:
    return {
        "id": c.col_id,
        "tp": int(c.ftype.tp),
        "flag": c.ftype.flag,
        "dec": c.ftype.decimal,
        "pk": c.is_pk_handle,
    }


def _col_info_from_wire(d: dict) -> ColumnInfo:
    return ColumnInfo(
        d["id"],
        FieldType(FieldTypeTp(d["tp"]), d.get("flag", 0), decimal=d.get("dec", 0)),
        is_pk_handle=d.get("pk", False),
    )


def _exec_to_wire(e) -> dict:
    if isinstance(e, TableScan):
        return {"t": "table_scan", "table_id": e.table_id,
                "cols": [_col_info_to_wire(c) for c in e.columns_info]}
    if isinstance(e, IndexScan):
        return {"t": "index_scan", "table_id": e.table_id, "index_id": e.index_id,
                "cols": [_col_info_to_wire(c) for c in e.columns_info]}
    if isinstance(e, Selection):
        return {"t": "selection", "conds": [expr_to_wire(c) for c in e.conditions]}
    if isinstance(e, Aggregation):
        return {
            "t": "agg",
            "group_by": [expr_to_wire(g) for g in e.group_by],
            "aggs": [{"op": a.op, "expr": expr_to_wire(a.expr) if a.expr else None} for a in e.agg_funcs],
            "streamed": e.streamed,
        }
    if isinstance(e, TopN):
        return {"t": "topn", "limit": e.limit,
                "order_by": [[expr_to_wire(x), desc] for x, desc in e.order_by]}
    if isinstance(e, Limit):
        return {"t": "limit", "limit": e.limit}
    if isinstance(e, Projection):
        return {"t": "projection", "exprs": [expr_to_wire(x) for x in e.exprs]}
    if isinstance(e, Join):
        d = {"t": "join", "join_type": e.join_type,
             "left_key": e.left_key, "right_key": e.right_key,
             "build": [_exec_to_wire(b) for b in e.build],
             "build_ranges": [[s, x] for s, x in e.build_ranges]}
        if e.build_context is not None:
            d["build_context"] = dict(e.build_context)
        return d
    raise TypeError(e)


def dag_to_wire(dag: DagRequest) -> dict:
    execs = [_exec_to_wire(e) for e in dag.executors]
    d = {"executors": execs, "output_offsets": dag.output_offsets, "chunk_rows": dag.chunk_rows}
    if dag.encode_type:
        d["encode_type"] = dag.encode_type
    return d


def _exec_from_wire(e: dict):
    t = e["t"]
    if t == "table_scan":
        return TableScan(e["table_id"], [_col_info_from_wire(c) for c in e["cols"]])
    if t == "index_scan":
        return IndexScan(e["table_id"], e["index_id"], [_col_info_from_wire(c) for c in e["cols"]])
    if t == "selection":
        return Selection([expr_from_wire(c) for c in e["conds"]])
    if t == "agg":
        return Aggregation(
            [expr_from_wire(g) for g in e["group_by"]],
            [AggDescriptor(a["op"], expr_from_wire(a["expr"]) if a["expr"] else None) for a in e["aggs"]],
            streamed=e.get("streamed", False),
        )
    if t == "topn":
        return TopN([(expr_from_wire(x), desc) for x, desc in e["order_by"]], e["limit"])
    if t == "limit":
        return Limit(e["limit"])
    if t == "projection":
        return Projection([expr_from_wire(x) for x in e["exprs"]])
    if t == "join":
        ctx = e.get("build_context")
        if ctx is not None and "region_epoch" in ctx:
            ctx = dict(ctx, region_epoch=tuple(ctx["region_epoch"]))
        return Join(
            [_exec_from_wire(b) for b in e["build"]],
            [(s, x) for s, x in e["build_ranges"]],
            e["left_key"], e["right_key"],
            join_type=e.get("join_type", "inner"),
            build_context=ctx,
        )
    raise ValueError(f"executor {t!r}")


def dag_from_wire(d: dict) -> DagRequest:
    execs = [_exec_from_wire(e) for e in d["executors"]]
    return DagRequest(executors=execs, output_offsets=d.get("output_offsets"),
                      chunk_rows=d.get("chunk_rows", 1024),
                      encode_type=d.get("encode_type", 0))
