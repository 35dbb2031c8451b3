"""Warm serving over encoded images: the port against the JAX evaluator and the CPU pipeline.

Each warm plan the port serves runs over encoded images (bitpacked lanes,
narrowed dictionary codes, and on the date-sorted fixture an RLE
l_shipdate, so zone maps prune blocks) built from the same blocks by each
package's own ``encode_blocks``.  ``SelectResponse.encode()`` of the port
(``device="cpu"``: the plain versions, which decode through
``kernels.decode_device_column``) must equal, byte for byte, that of
``JaxDagEvaluator`` over its encoded cache (``route_hint="unary"``, which
takes the stacked programs and their in-kernel decode, and unset, which
tries the zone rung first), and that of the CPU ``BatchExecutorsRunner``
over the plain blocks.  A nullable table adds NULL runs (run-shaped null
payloads), all-NULL and mixed-NULL bitpacked columns.  No tolerance: REAL
columns never encode and no plan here sums one.
"""

import numpy as np
import pytest

import bench
from test_torch_encoding import _blocks, jax_cache, port_cache
from tikv_tpu.copr import jax_eval
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag import (
    Aggregation,
    BatchExecutorsRunner,
    DagRequest,
    Limit,
    Selection,
    TableScan,
    TopN,
)
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.executors import CachedBlocksExecutor
from tikv_tpu.copr.rpn import call, col, const_decimal, const_int
from tikv_tpu_torch.copr import zone_maps
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator, decline_cause
from tikv_tpu_torch.copr.dag_wire import dag_from_wire

BLOCK_ROWS = {"lineitem": 1024, "lineitem_shipdate": 1024, "nullable": 512}


def _nullable_schema():
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()), ColumnInfo(3, FieldType.int64()),
            ColumnInfo(4, FieldType.int64()), ColumnInfo(5, FieldType.decimal_type(2)),
            ColumnInfo(6, FieldType.double()), ColumnInfo(7, FieldType.varchar()),
            ColumnInfo(8, FieldType.varchar()), ColumnInfo(9, FieldType.varchar()),
            ColumnInfo(10, FieldType.int64())]


def _lineitem_plans():
    scan = TableScan(bench.TABLE_ID, bench._lineitem())
    scan5 = TableScan(bench.TABLE_ID, bench._lineitem()[:5])
    aggs = [AggDescriptor("count", None), AggDescriptor("sum", call("multiply", col(2), col(3))),
            AggDescriptor("min", col(1)), AggDescriptor("max", col(2))]
    q6_conds = [call("ge", col(4), const_int(9000)), call("lt", col(4), const_int(9365)),
                call("ge", col(3), const_decimal(2, 2)), call("le", col(3), const_decimal(4, 2)),
                call("lt", col(1), const_int(24))]
    qty_aggs = [AggDescriptor("count", None), AggDescriptor("sum", col(2)),
                AggDescriptor("avg", col(3)), AggDescriptor("max", col(4))]
    q1_topn = bench.q1_dag()
    q1_topn.executors.append(TopN([(col(7), False), (col(8), False)], 4))
    plans = {
        "q6": DagRequest(executors=[scan, Selection(q6_conds), Aggregation([], aggs[1:2])]),
        "q6_count_sum_min_max": DagRequest(executors=[scan5, Selection(q6_conds),
                                                      Aggregation([], aggs)]),
        "q1_coded": bench.q1_dag(),
        "group_by_quantity_host_ids": DagRequest(executors=[
            scan, Selection([call("le", col(4), const_int(10500))]),
            Aggregation([col(1)], qty_aggs)]),
        "config2_limit": bench._filter_dag("filter", 300),
        "config2": bench._filter_dag("filter"),
        "config1_scan": bench._filter_dag("scan", 1500),
        "selective_offsets": DagRequest(executors=[scan, Selection([
            call("lt", col(4), const_int(8600))])], output_offsets=[6, 4, 0]),
        "raw_topn": DagRequest(executors=[scan5, Selection([call("le", col(4), const_int(10500))]),
                                          TopN([(col(2), True), (col(1), False)], 100)]),
        "raw_topn_no_selection": DagRequest(executors=[scan5, TopN([(col(4), True),
                                                                    (col(0), False)], 50)]),
        "raw_topn_ascending_limit": DagRequest(executors=[
            scan, TopN([(col(4), False), (col(2), True)], 300), Limit(40)]),
        "q1_topn": q1_topn,
    }
    return plans


def _nullable_plans():
    scan = TableScan(bench.TABLE_ID, _nullable_schema())
    aggs = [AggDescriptor("count", None), AggDescriptor("count", col(3)),
            AggDescriptor("sum", col(2)), AggDescriptor("min", col(3)),
            AggDescriptor("max", col(9)), AggDescriptor("avg", col(3))]
    return {
        "agg_over_null_runs": DagRequest(executors=[scan, Selection([
            call("ge", col(3), const_int(-2))]), Aggregation([], aggs)]),
        "agg_is_null": DagRequest(executors=[scan, Selection([call("is_null", col(3))]),
                                             Aggregation([], aggs[:3])]),
        "group_by_codes": DagRequest(executors=[scan, Selection([
            call("gt", col(2), const_int(120))]), Aggregation([col(8)], aggs)]),
        "group_by_null_runs_host_ids": DagRequest(executors=[scan, Aggregation([col(3)],
                                                                               aggs[:3])]),
        "filter_all_null_column": DagRequest(executors=[scan, Selection([
            call("lt", col(1), const_int(5))])]),
        "filter_mixed_limit": DagRequest(executors=[scan, Selection([
            call("is_null", col(2)), call("ge", col(9), const_int(7))]), Limit(200)]),
        "scan_limit": DagRequest(executors=[scan, Limit(700)]),
    }


def _plans():
    return [(t, name) for t in ("lineitem", "lineitem_shipdate") for name in _lineitem_plans()] \
        + [("nullable", name) for name in _nullable_plans()]


_CACHES = {}


def _caches(table):
    if table not in _CACHES:
        blocks = _blocks(table)
        _CACHES[table] = (jax_cache(blocks, encode=False)[0], jax_cache(blocks)[0],
                          port_cache(blocks)[0])
    return _CACHES[table]


@pytest.mark.parametrize("table,plan", _plans())
def test_encoded_warm_plan_is_byte_identical_to_jax_and_the_cpu_pipeline(table, plan):
    dag = (_nullable_plans() if table == "nullable" else _lineitem_plans())[plan]
    wire = dag_to_wire(dag)
    assert decline_cause(dag_from_wire(wire)) is None
    jplain, jenc, penc = _caches(table)
    br = BLOCK_ROWS[table]
    want = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jplain, dag.executors[0].columns_info)
    ).handle_request().encode()
    port = TorchDagEvaluator(wire, block_rows=br, device="cpu")
    got = port.run(None, penc).encode()
    assert got == want, "port over its encoded image vs the CPU pipeline"
    jev = jax_eval.JaxDagEvaluator(dag, block_rows=br)
    hints = ("unary", None) if any(isinstance(e, Aggregation) for e in dag.executors) \
        else ("unary",)
    for hint in hints:
        jev.route_hint = hint
        assert jev.run(None, jenc).encode() == got, f"JAX over its encoded cache, hint {hint}"
    # and the same plan with pruning off, over the same image
    zone_maps.set_enabled(False)
    try:
        assert TorchDagEvaluator(wire, block_rows=br, device="cpu").run(None, penc).encode() == got
    finally:
        zone_maps.set_enabled(True)


def test_date_sorted_image_prunes_and_exits_early():
    _jplain, _jenc, penc = _caches("lineitem_shipdate")
    plans = _lineitem_plans()
    seen = {}
    for name in ("q6", "config2_limit", "raw_topn_no_selection", "raw_topn_ascending_limit"):
        ev = TorchDagEvaluator(dag_to_wire(plans[name]), block_rows=1024, device="cpu")
        ev.run(None, penc)
        seen[name] = ev.prune_stats
    n = len(penc.blocks)
    assert seen["q6"][0] == n and seen["q6"][1] >= n * 3 // 4
    assert 0 < seen["config2_limit"][1] < n
    # no selection: the zone-order early exit drops all but the blocks at
    # the sorted column's far end
    for name in ("raw_topn_no_selection", "raw_topn_ascending_limit"):
        assert seen[name][0] == n and seen[name][1] >= n - 3, name


def test_encoded_pins_hold_narrow_payloads_apart_from_plain_pins():
    penc = port_cache(_blocks("lineitem"))[0]
    plain = port_cache(_blocks("lineitem"), encode=False)[0]
    for cache in (penc, plain):
        ev = TorchDagEvaluator(dag_to_wire(_lineitem_plans()["q6"]), block_rows=1024,
                               device="cpu")
        ev.run(None, cache)
    sig_enc = [s for s in penc.blocks[0].device if s[0] == "stackedenc"]
    sig_plain = [s for s in plain.blocks[0].device if s[0] == "stacked"]
    assert len(sig_enc) == 1 and len(sig_plain) == 1
    assert sig_enc[0][-1] == penc.enc_version
    data, _nulls = penc.blocks[0].device[sig_enc[0]]
    assert [str(t.dtype) for t in data] == ["torch.int8", "torch.int32", "torch.int8",
                                          "torch.int16"]
    # Q6's four columns: 8 bytes a row encoded against 32 plain
    assert penc.device_nbytes() * 10 <= plain.device_nbytes() * 3
    assert np.isclose((penc.device_nbytes() - 16 * len(penc.blocks)) / 8,
                      (plain.device_nbytes() - 16 * len(plain.blocks)) / 32)
