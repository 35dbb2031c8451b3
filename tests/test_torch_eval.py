"""End to end: the port's evaluator against the JAX evaluator and the CPU pipeline.

Q6-family requests over ~5,000 lineitem rows, cold (KV bytes through the row
decoder) and warm (a resident block cache), at block_rows 256 and 1024.  The
request enters the port as the wire dict.  ``SelectResponse.encode()`` of the
port must equal that of ``JaxDagEvaluator`` (zone rung allowed, and
``route_hint="unary"``) and of the CPU ``BatchExecutorsRunner``; REAL
variants compare decoded values to rel 1e-12 (jax_eval.py:19-20).  The
warm port cache is carried across from the JAX cache's decoded blocks.
"""

import numpy as np
import pytest

import bench
import __graft_entry__ as graft
from tikv_tpu.copr import jax_eval
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.cache import ColumnBlockCache as JaxCache
from tikv_tpu.copr.dag import (
    Aggregation,
    BatchExecutorsRunner,
    DagRequest,
    IndexScan,
    Limit,
    Selection,
    TableScan,
    TopN,
)
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.executors import CachedBlocksExecutor, FixtureScanSource as JaxSource
from tikv_tpu.copr.rpn import call, col, const_decimal, const_int, const_real
from tikv_tpu.copr.table import encode_row, record_key
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.dag_wire import dag_from_wire
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_wire
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator, decline_cause

N_ROWS = 5000


def _q6_conds():
    return [
        call("ge", col(4), const_int(9000)),
        call("lt", col(4), const_int(9365)),
        call("ge", col(3), const_decimal(2, 2)),
        call("le", col(3), const_decimal(4, 2)),
        call("lt", col(1), const_int(24)),
    ]


def _nullable_lineitem():
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.decimal_type(2)),
            ColumnInfo(4, FieldType.decimal_type(2)),
            ColumnInfo(5, FieldType.int64()),
            ColumnInfo(6, FieldType.varchar()),
            ColumnInfo(7, FieldType.varchar())]


def _real_lineitem():
    cols = _nullable_lineitem()
    cols[2] = ColumnInfo(3, FieldType.double())
    return cols


def _nullable_dag():
    aggs = [AggDescriptor("count", None), AggDescriptor("count", col(2)),
            AggDescriptor("sum", call("multiply", col(2), col(3))),
            AggDescriptor("avg", col(3)), AggDescriptor("min", col(1)),
            AggDescriptor("max", call("plus", col(2), col(3)))]
    return DagRequest(executors=[TableScan(bench.TABLE_ID, _nullable_lineitem()),
                                 Selection(_q6_conds()), Aggregation([], aggs)])


def _real_dag():
    conds = _q6_conds()[:4] + [call("lt", col(2), const_real(60000.0))]
    aggs = [AggDescriptor("sum", col(2)), AggDescriptor("avg", call("multiply", col(2), col(2))),
            AggDescriptor("min", col(2)), AggDescriptor("max", col(2)),
            AggDescriptor("count", None), AggDescriptor("sum", col(1))]
    return DagRequest(executors=[TableScan(bench.TABLE_ID, _real_lineitem()),
                                 Selection(conds), Aggregation([], aggs)])


def _row_kvs(schema, rows):
    kvs = []
    for h, values in enumerate(rows):
        kvs.append((record_key(bench.TABLE_ID, h), encode_row(schema[1:], values)))
    return kvs


def _nullable_kvs(n):
    a = bench.build_arrays(n, seed=3)
    rng = np.random.default_rng(4)
    holes = rng.random((4, n)) < 0.1
    rows = []
    for r in range(n):
        vals = [int(a["qty"][r]), int(a["price"][r]), int(a["disc"][r]), int(a["ship"][r])]
        vals = [None if holes[j, r] else v for j, v in enumerate(vals)]
        rows.append(vals + [b"ANR"[a["rf"][r]:a["rf"][r] + 1], b"FO"[a["ls"][r]:a["ls"][r] + 1]])
    return _row_kvs(_nullable_lineitem(), rows)


def _real_kvs(n):
    a = bench.build_arrays(n, seed=5)
    rows = [[int(a["qty"][r]), float(a["price"][r]) / 100.0, int(a["disc"][r]),
             int(a["ship"][r]), b"A", b"F"] for r in range(n)]
    return _row_kvs(_real_lineitem(), rows)


_KVS = {}


def _kvs(kind):
    if kind not in _KVS:
        _KVS[kind] = {"lineitem": lambda: bench.build_kvs(N_ROWS),
                      "nullable": lambda: _nullable_kvs(N_ROWS),
                      "real": lambda: _real_kvs(N_ROWS)}[kind]()
    return _KVS[kind]


PLANS = {
    "graft": (graft._dag, "lineitem", False),
    "q6": (bench.q6_dag, "lineitem", False),
    "nullable": (_nullable_dag, "nullable", False),
    "real": (_real_dag, "real", True),
}


def _same(port_resp, other_resp, real: bool, what: str):
    if not real:
        assert port_resp.encode() == other_resp.encode(), what
        return
    got, want = port_resp.iter_rows(), other_resp.iter_rows()
    assert len(got) == len(want) == 1, what
    for g, w in zip(got[0], want[0]):
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0), what
        else:
            assert g == w, what


def test_port_fixture_kvs_equal_the_bench_fixture():
    assert fx.build_kvs(3000, seed=2) == bench.build_kvs(3000, seed=2)
    a = fx.build_arrays(3000, seed=2)
    b = bench.build_arrays(3000, seed=2)
    assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("block_rows", [256, 1024])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_cold_and_warm_responses_match(plan, block_rows):
    make_dag, kvs_kind, real = PLANS[plan]
    kvs = _kvs(kvs_kind)
    dag = make_dag()
    wire = dag_to_wire(dag)

    cpu_cold = BatchExecutorsRunner(dag, JaxSource(kvs)).handle_request()
    jax_cache = JaxCache()
    jax_cold = jax_eval.JaxDagEvaluator(dag, block_rows=block_rows).run(JaxSource(kvs), jax_cache)
    port = TorchDagEvaluator(wire, block_rows=block_rows, device="cpu")
    port_cold = port.run(FixtureScanSource(kvs))
    _same(port_cold, jax_cold, real, "cold vs JAX")
    _same(port_cold, cpu_cold, real, "cold vs CPU pipeline")

    assert jax_cache.filled and jax_cache.blocks
    blocks = [([(c.eval_type.value, np.asarray(c.data), np.asarray(c.nulls), c.frac, c.dictionary)
                for c in b.cols], b.n_valid) for b in jax_cache.blocks]
    port_cache = ColumnBlockCache.from_numpy_blocks(blocks)
    port_warm = port.run(None, port_cache)
    _same(port_warm, port_cold, real, "warm vs cold")
    for hint in (None, "unary"):
        jev = jax_eval.JaxDagEvaluator(dag, block_rows=block_rows)
        jev.route_hint = hint
        _same(port_warm, jev.run(None, jax_cache), real, f"warm vs JAX route_hint={hint}")
    cpu_warm = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jax_cache, dag.executors[0].columns_info)
    ).handle_request()
    _same(port_warm, cpu_warm, real, "warm vs CPU pipeline")
    # a second warm run reuses the pinned image
    assert port.run(None, port_cache).encode() == port_warm.encode()


def test_q6_matches_the_numpy_oracle_cold_and_warm():
    n = 20_000
    a = fx.build_arrays(n, seed=9)
    ev = TorchDagEvaluator(port_wire(fx.q6_dag()), block_rows=4096, device="cpu")
    assert ev.run(FixtureScanSource(fx.build_kvs(n, seed=9))).iter_rows() == [fx.q6_oracle(a)]
    assert ev.run(None, fx.build_cache(n, 4096, seed=9)).iter_rows() == [fx.q6_oracle(a)]
    ev_g = TorchDagEvaluator(port_wire(fx.q6_count_sum_min_max_dag()), block_rows=4096,
                             device="cpu")
    assert ev_g.run(None, fx.build_cache(n, 4096, seed=9)).iter_rows() == \
        [fx.q6_count_sum_min_max_oracle(a)]


def test_cold_run_fills_a_cache_for_warm_runs():
    kvs = _kvs("lineitem")
    ev = TorchDagEvaluator(dag_to_wire(bench.q6_dag()), block_rows=1024, device="cpu")
    cache = ColumnBlockCache()
    cold = ev.run(FixtureScanSource(kvs), cache)
    assert cache.filled and cache.total_rows == N_ROWS
    assert ev.run(None, cache).encode() == cold.encode()
    assert cache.device_nbytes() > 0


def test_empty_source_gives_the_identity_state():
    dag = graft._dag()
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=256, device="cpu")
    want = jax_eval.JaxDagEvaluator(dag, block_rows=256).run(JaxSource([]))
    got = port.run(FixtureScanSource([]))
    assert got.encode() == want.encode()
    assert got.iter_rows() == [[0, None, None, None]]


def _declined():
    cols = bench._lineitem()
    scan = TableScan(bench.TABLE_ID, cols)
    agg = Aggregation([], [AggDescriptor("sum", col(1))])
    q1 = bench.q1_dag()
    q1.executors[-1].streamed = True  # stream agg keyed on (flag, status): not scan order
    return {
        "plan_shape_not_ported": DagRequest(executors=[scan, TopN([(col(1), False)], 10)]),
        "scan_filter": DagRequest(executors=[scan, Selection(_q6_conds())]),
        "index_scan_not_ported": DagRequest(
            executors=[IndexScan(bench.TABLE_ID, 1, cols[1:3]), agg]),
        "post_agg_not_ported": DagRequest(executors=[scan, agg, Limit(1)]),
        "agg_op_outside_the_ten": DagRequest(
            executors=[scan, Aggregation([], [AggDescriptor("approx_count_distinct", col(1))])]),
        "op_not_ported": DagRequest(executors=[scan, Aggregation(
            [], [AggDescriptor("sum", call("divide_real", col(1), col(2)))])]),
        "chunk_encoding_not_ported": DagRequest(executors=[scan, agg], encode_type=1),
        "streamed_agg_order": q1,
    }


DECLINE_CAUSE = {
    "scan_filter": "plan_shape_not_ported",
    "agg_op_outside_the_ten": "agg_op_not_ported",
}


@pytest.mark.parametrize("case", sorted(_declined()))
def test_plans_outside_the_slice_decline_with_a_named_cause(case):
    dag = _declined()[case]
    port_dag = dag_from_wire(dag_to_wire(dag))
    want = DECLINE_CAUSE.get(case, case)
    assert decline_cause(port_dag) == want
    with pytest.raises(Exception) as exc:
        TorchDagEvaluator(port_dag, block_rows=256, device="cpu")
    assert getattr(exc.value, "cause", None) == want


def test_q6_is_eligible():
    assert decline_cause(dag_from_wire(dag_to_wire(bench.q6_dag()))) is None


def _served():
    """Plans the first slice declined (by these cause names) that GROUP BY
    and the ten device aggregates now serve."""
    scan = TableScan(bench.TABLE_ID, bench._lineitem())
    return {
        "group_by_not_ported": bench.q1_dag(),
        "agg_op_not_ported": DagRequest(
            executors=[scan, Aggregation([], [AggDescriptor("var_pop", col(1))])]),
        "agg_first": DagRequest(
            executors=[scan, Aggregation([], [AggDescriptor("first", col(1))])]),
        "agg_bit_and": DagRequest(
            executors=[scan, Aggregation([], [AggDescriptor("bit_and", col(1))])]),
    }


@pytest.mark.parametrize("case", sorted(_served()))
def test_formerly_declined_plans_are_served_byte_identical_to_jax(case):
    dag = _served()[case]
    kvs = _kvs("lineitem")
    port_dag = dag_from_wire(dag_to_wire(dag))
    assert decline_cause(port_dag) is None
    port = TorchDagEvaluator(port_dag, block_rows=1024, device="cpu")
    got = port.run(FixtureScanSource(kvs))
    want = jax_eval.JaxDagEvaluator(dag, block_rows=1024).run(JaxSource(kvs))
    cpu = BatchExecutorsRunner(dag, JaxSource(kvs)).handle_request()
    real = case == "agg_op_not_ported"  # var_pop's sum of squares is REAL
    _same_rows(got, want, real)
    _same_rows(got, cpu, real)


def _same_rows(got, want, real):
    if not real:
        assert got.encode() == want.encode()
        return
    g_rows, w_rows = got.iter_rows(), want.iter_rows()
    assert len(g_rows) == len(w_rows)
    for g_row, w_row in zip(g_rows, w_rows):
        assert g_row == pytest.approx(w_row, rel=1e-12, abs=0)
