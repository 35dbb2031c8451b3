"""GROUP BY and the ten device aggregates: the port against the JAX package.

Three levels, all on the CPU through the plain version of the grouped kernels:

* the block step and the stacked scans — the JAX package's ``_build_agg_fn``
  (one block, carried), ``_build_scan_fn`` (host group ids) and
  ``_build_scan_fn_coded`` (ids from dictionary codes) against
  ``fused_group_agg_plain`` on the same inputs, unpacked leaf by leaf: int
  leaves exact, f64 leaves to rel 1e-12 (REAL sums are summed in another
  order: the JAX package's own exemption, jax_eval.py:19-20);
* whole requests — ``TorchDagEvaluator(device="cpu")`` against
  ``JaxDagEvaluator`` and the CPU executor pipeline, cold and warm, with
  byte-identical ``SelectResponse.encode()`` (REAL aggregates: values to rel
  1e-12);
* TPC-H Q1 against the numpy oracle of ``tikv_tpu_torch.fixtures``.

Inputs come from ``np.random.default_rng`` at block_rows 256 to 4096.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from tikv_tpu.copr import jax_eval
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.cache import ColumnBlockCache as JaxCache
from tikv_tpu.copr.dag import Aggregation, BatchExecutorsRunner, DagRequest, Selection, TableScan
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import NOT_NULL_FLAG, Column, ColumnInfo, EvalType, FieldType
from tikv_tpu.copr.executors import CachedBlocksExecutor, FixtureScanSource as JaxSource
from tikv_tpu.copr.rpn import call, col, const_int, const_real
from tikv_tpu.copr.table import encode_row, record_key
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import fused_group_agg as ga
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_wire
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

CPU = torch.device("cpu")
TABLE = 77


def _nn(ft):
    ft.flag |= NOT_NULL_FLAG
    return ft


def _schema(keys_nullable: bool = False):
    """handle, c1 int, c2 double, c3 decimal(2) (all nullable), two varchar
    keys, an int key."""
    key = FieldType.varchar if keys_nullable else (lambda: _nn(FieldType.varchar()))
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.double()),
            ColumnInfo(4, FieldType.decimal_type(2)),
            ColumnInfo(5, key()),
            ColumnInfo(6, key()),
            ColumnInfo(7, FieldType.int64())]


def _all_aggs():
    """Every one of the ten device aggregates, over int, decimal and REAL
    arguments."""
    return [AggDescriptor("count", None), AggDescriptor("count", col(1)),
            AggDescriptor("sum", col(1)), AggDescriptor("avg", col(3)),
            AggDescriptor("min", col(2)), AggDescriptor("max", col(1)),
            AggDescriptor("var_pop", col(2)), AggDescriptor("var_pop", col(3)),
            AggDescriptor("first", col(1)), AggDescriptor("first", col(2)),
            AggDescriptor("bit_and", col(1)), AggDescriptor("bit_or", col(1)),
            AggDescriptor("bit_xor", col(1)), AggDescriptor("sum", col(2)),
            AggDescriptor("min", col(3)), AggDescriptor("max", col(2))]


def _int_aggs():
    """Aggregates whose leaves are all integers (no f64 leaf)."""
    return [AggDescriptor("count", None), AggDescriptor("sum", col(1)),
            AggDescriptor("avg", col(3)), AggDescriptor("min", col(3)),
            AggDescriptor("max", col(1)), AggDescriptor("first", col(3)),
            AggDescriptor("bit_and", col(1)), AggDescriptor("bit_or", col(1)),
            AggDescriptor("bit_xor", col(1))]


def _conds():
    return [call("or", call("gt", col(1), const_int(-40)), call("is_null", col(2))),
            call("lt", col(2), const_real(900.0))]


def _dag(group_by, aggs=None, keys_nullable=False, streamed=False):
    return DagRequest(executors=[
        TableScan(TABLE, _schema(keys_nullable)), Selection(_conds()),
        Aggregation(group_by, _all_aggs() if aggs is None else aggs, streamed=streamed)])


# ---------------------------------------------------------------------------
# the block step and the stacked scans
# ---------------------------------------------------------------------------

DICT_LENS = (3, 4)


def _inputs(cols, nullable, nb, n_rows, rng, null_p=0.2):
    data = {}
    for i in cols:
        if i == 2:
            data[i] = rng.uniform(0.0, 1000.0, (nb, n_rows))
        elif i in (4, 5):
            data[i] = rng.integers(0, DICT_LENS[i - 4], (nb, n_rows)).astype(np.int64)
        else:
            data[i] = rng.integers(-100, 100, (nb, n_rows)).astype(np.int64)
    nulls = {i: rng.random((nb, n_rows)) < null_p for i in nullable}
    return data, nulls


def _image(ship, nullable, data, nulls, n_valids, offsets, gids=None):
    nb, br = data[ship[0]].shape
    nv = n_valids if isinstance(n_valids, int) else torch.from_numpy(n_valids)
    off = offsets if isinstance(offsets, int) else torch.from_numpy(offsets)
    return fa.Image([torch.from_numpy(data[i]) for i in ship],
                    [torch.from_numpy(nulls[i]) if i in nullable else None for i in ship],
                    nv, nb, br, CPU, off, None if gids is None else torch.from_numpy(gids))


def _assert_state(got, want):
    gi, gf = got[0].numpy(), got[1].numpy()
    wi, wf = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gi, wi)
    assert gf.shape == wf.shape
    np.testing.assert_allclose(gf, wf, rtol=1e-12, atol=0)
    # exact where the JAX value is exact: extremes, first values, int sums
    same = np.isfinite(wf) & (wf == np.round(wf))
    np.testing.assert_array_equal(gf[same], wf[same])


N_VALIDS = np.array([512, 0, 512, 300, 0, 512, 77], dtype=np.int64)


def _offsets(nv):
    return np.concatenate([[0], np.cumsum(nv)[:-1]]).astype(np.int64)


def test_stacked_scan_with_host_ids_matches_jax():
    rng = np.random.default_rng(21)
    nb, br, cap = len(N_VALIDS), 512, 64
    ev = jax_eval.JaxDagEvaluator(_dag([col(6)]), block_rows=br)
    port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
    assert port.plan.device_cols == ev.device_cols == [1, 2, 3]
    data, nulls = _inputs(ev.device_cols, ev.nullable_cols, nb, br, rng)
    gids = rng.integers(0, 50, (nb, br)).astype(np.int32)
    want = ev._build_scan_fn(cap, nb)(tuple(data[i] for i in ev.device_cols),
                                      tuple(nulls[i] for i in ev.nullable_cols),
                                      N_VALIDS, gids, _offsets(N_VALIDS), None)
    img = _image(ev.device_cols, ev.nullable_cols, data, nulls, N_VALIDS, _offsets(N_VALIDS),
                 gids)
    _assert_state(ga.fused_group_agg(port.plan.group_program, img, cap), want)


def test_stacked_scan_with_coded_ids_matches_jax():
    rng = np.random.default_rng(22)
    nb, br = len(N_VALIDS), 512
    group_cols = [4, 5]
    ev = jax_eval.JaxDagEvaluator(_dag([col(4), col(5)]), block_rows=br)
    ship = ev._ship_cols(group_cols)
    port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
    prog = port._coded_program(group_cols, DICT_LENS)
    assert port._ship_cols(group_cols) == ship
    data, nulls = _inputs(ship, ev.nullable_cols, nb, br, rng)
    cap = 32  # (3 + 1) * (4 + 1) slots
    want = ev._build_scan_fn_coded(DICT_LENS, cap, nb, group_cols)(
        tuple(data[i] for i in ship), tuple(nulls[i] for i in ev.nullable_cols),
        N_VALIDS, _offsets(N_VALIDS), None)
    img = _image(ship, ev.nullable_cols, data, nulls, N_VALIDS, _offsets(N_VALIDS))
    _assert_state(ga.fused_group_agg(prog, img, cap), want)


@pytest.mark.parametrize("aggs", ["all", "int"])
def test_block_steps_carried_and_grown_match_jax(aggs):
    """The cold path: a block at capacity 8, the carry grown to 64, a
    second block carried in place."""
    rng = np.random.default_rng(23)
    br = 1024
    ev = jax_eval.JaxDagEvaluator(_dag([col(6)], None if aggs == "all" else _int_aggs()),
                                  block_rows=br)
    port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
    prog = port.plan.group_program
    state = (jnp.full(8, jax_eval._NO_ROW, dtype=jnp.int64),
             tuple(da.init_carry(8) for da in ev.device_aggs))
    carry, offset = None, 0
    for n_valid, n_groups, cap in ((1000, 8, 8), (br, 60, 64)):
        data, nulls = _inputs(ev.device_cols, ev.nullable_cols, 1, br, rng)
        gids = rng.integers(0, n_groups, (1, br)).astype(np.int32)
        if cap != state[0].shape[0]:
            state = (jnp.full(cap, jax_eval._NO_ROW, dtype=jnp.int64).at[:8].set(state[0]),
                     tuple(jax_eval._grow_carry(da, c, cap)
                           for da, c in zip(ev.device_aggs, state[1])))
            carry = ga.grow_carry(prog, carry, cap)
        state = ev._build_agg_fn(cap)([data[i][0] for i in ev.device_cols],
                                      [nulls[i][0] for i in ev.nullable_cols], n_valid,
                                      gids[0], offset, state)
        img = _image(ev.device_cols, ev.nullable_cols, data, nulls, n_valid, offset, gids)
        carry = ga.fused_group_agg(prog, img, cap, carry)
        _assert_state(carry, jax_eval._pack_state(state))
        offset += n_valid


def test_single_slot_of_the_new_aggregates_matches_jax():
    """No GROUP BY with var_pop/first/bit ops: one slot, no tracker."""
    rng = np.random.default_rng(24)
    nb, br = len(N_VALIDS), 512
    ev = jax_eval.JaxDagEvaluator(_dag([]), block_rows=br)
    port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
    assert port.program is None and port.plan.group_program.key_slots == ()
    data, nulls = _inputs(ev.device_cols, ev.nullable_cols, nb, br, rng)
    want = ev._build_scan_fn(1, nb)(tuple(data[i] for i in ev.device_cols),
                                    tuple(nulls[i] for i in ev.nullable_cols), N_VALIDS,
                                    np.zeros((nb, br), dtype=np.int32), _offsets(N_VALIDS), None)
    img = _image(ev.device_cols, ev.nullable_cols, data, nulls, N_VALIDS, _offsets(N_VALIDS))
    _assert_state(ga.fused_group_agg(port.plan.group_program, img, 1), want)


def test_f64_extremes_take_nan_and_signed_zero_as_jax_does():
    """NaN propagates; -0.0 wins min and +0.0 wins max whatever the row
    order (XLA's scatter min/max), in the block and across the carry."""
    br = 16
    dag = _dag([col(6)], [AggDescriptor("min", col(2)), AggDescriptor("max", col(2))])
    ev = jax_eval.JaxDagEvaluator(dag, block_rows=br)
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cpu")
    prog = port.plan.group_program
    z = [0.0, -0.0]
    blocks = [np.array([[1.0, np.nan, 2.0, 0.0, -0.0, -0.0, 0.0, 5.0, 0.0, 0.0, -0.0, -0.0,
                         3.0, 1.0, 0.0, 7.0]]),
              np.array([[z[i % 2] for i in range(br)]])]
    gids = np.array([[0, 0, 0, 1, 1, 2, 2, 3, 4, 4, 5, 5, 6, 6, 6, 7]], dtype=np.int32)
    cap = 8
    state = (jnp.full(cap, jax_eval._NO_ROW, dtype=jnp.int64),
             tuple(da.init_carry(cap) for da in ev.device_aggs))
    carry, offset = None, 0
    for c2 in blocks:
        data = {0: np.zeros((1, br), dtype=np.int64), 1: np.zeros((1, br), dtype=np.int64),
                2: c2}
        nulls = {i: np.zeros((1, br), dtype=bool) for i in ev.nullable_cols}
        state = ev._build_agg_fn(cap)([data[i][0] for i in ev.device_cols],
                                      [nulls[i][0] for i in ev.nullable_cols], br, gids[0],
                                      offset, state)
        img = _image(ev.device_cols, ev.nullable_cols, data, nulls, br, offset, gids)
        carry = ga.fused_group_agg(prog, img, cap, carry)
        want = np.asarray(jax_eval._pack_state(state)[1])
        got = carry[1].numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
        offset += br


# ---------------------------------------------------------------------------
# whole requests
# ---------------------------------------------------------------------------

def _row_kvs(schema, rows):
    return [(record_key(TABLE, h), encode_row(schema[1:], values)) for h, values in enumerate(rows)]


def _kvs(n, seed, keys_nullable=False, n_keys=3, filtered_key=None):
    """Rows of :func:`_schema`; ``filtered_key`` gets c2 >= 900 on every row,
    so the selection removes the whole group."""
    rng = np.random.default_rng(seed)
    holes = rng.random((4, n)) < 0.1
    rows = []
    for r in range(n):
        ka, kb = int(rng.integers(0, n_keys)), int(rng.integers(0, 4))
        c2 = float(rng.uniform(0, 1000))
        if filtered_key is not None and ka == filtered_key:
            c2 = 950.0
        vals = [int(rng.integers(-100, 100)), c2, int(rng.integers(-10**6, 10**6))]
        vals = [None if holes[j, r] else v for j, v in enumerate(vals)]
        key_a = None if keys_nullable and holes[3, r] else b"k%d" % ka
        rows.append(vals + [key_a, b"abcd"[kb : kb + 1], int(rng.integers(0, 40))])
    return _row_kvs(_schema(keys_nullable), rows)


def _real(dag) -> bool:
    cols = dag.executors[0].columns_info
    agg = dag.executors[-1]
    return any(a.expr is not None and _uses_real(a.expr, cols) for a in agg.agg_funcs)


def _uses_real(expr, cols):
    if hasattr(expr, "index"):
        return cols[expr.index].ftype.eval_type == EvalType.REAL
    return any(_uses_real(c, cols) for c in getattr(expr, "children", []))


def _same(port_resp, other_resp, real: bool, what: str):
    if not real:
        assert port_resp.encode() == other_resp.encode(), what
        return
    got, want = port_resp.iter_rows(), other_resp.iter_rows()
    assert len(got) == len(want), what
    for g_row, w_row in zip(got, want):
        assert len(g_row) == len(w_row), what
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-12, abs=0, nan_ok=True), what
            else:
                assert g == w, what


def _port_cache(jax_cache):
    return ColumnBlockCache.from_numpy_blocks(
        [([(c.eval_type.value, np.asarray(c.data), np.asarray(c.nulls), c.frac, c.dictionary)
           for c in b.cols], b.n_valid) for b in jax_cache.blocks])


def _check_request(dag, kvs, block_rows, jax_warm=True):
    """Cold then warm: the port's bytes against the JAX evaluator's and the
    CPU pipeline's.  Returns the port's evaluator and its warm cache."""
    real = _real(dag)
    cpu_cold = BatchExecutorsRunner(dag, JaxSource(kvs)).handle_request()
    jax_cache = JaxCache()
    jax_cold = jax_eval.JaxDagEvaluator(dag, block_rows=block_rows).run(JaxSource(kvs), jax_cache)
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cpu")
    port_cold = port.run(FixtureScanSource(kvs))
    _same(port_cold, jax_cold, real, "cold vs JAX")
    _same(port_cold, cpu_cold, real, "cold vs CPU pipeline")
    if not jax_cache.blocks:
        return port, None
    port_cache = _port_cache(jax_cache)
    port_warm = port.run(None, port_cache)
    cpu_warm = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jax_cache, dag.executors[0].columns_info)
    ).handle_request()
    _same(port_warm, cpu_warm, real, "warm vs CPU pipeline")
    if jax_warm:
        for hint in (None, "unary"):
            jev = jax_eval.JaxDagEvaluator(dag, block_rows=block_rows)
            jev.route_hint = hint
            _same(port_warm, jev.run(None, jax_cache), real, f"warm vs JAX route_hint={hint}")
    assert port.run(None, port_cache).encode() == port_warm.encode()
    return port, port_cache


_KVS = {}


def _cached_kvs(name, make):
    if name not in _KVS:
        _KVS[name] = make()
    return _KVS[name]


def _rows():
    return _cached_kvs("rows", lambda: _kvs(2500, 1))


CASES = {
    # (dag, kvs): rows with NULL holes decode per row, so their varchar keys
    # arrive as plain bytes and the warm run takes host ids; the lineitem
    # fixture decodes to dictionary codes and takes the coded path
    "q1": (bench.q1_dag, lambda: _cached_kvs("lineitem", lambda: bench.build_kvs(3000))),
    "int_key": (lambda: _dag([col(6)]), _rows),
    "expr_key": (lambda: _dag([call("multiply", col(6), const_int(3))], _int_aggs()), _rows),
    "mixed_keys": (lambda: _dag([col(4), col(6), col(5)], _int_aggs()), _rows),
    "two_keys": (lambda: _dag([col(5), col(4)]), _rows),
    "null_key": (lambda: _dag([col(4)], keys_nullable=True),
                 lambda: _cached_kvs("null_keys", lambda: _kvs(2500, 2, keys_nullable=True))),
    "filtered_group": (lambda: _dag([col(4)], _int_aggs()),
                       lambda: _cached_kvs("filtered", lambda: _kvs(2500, 3, filtered_key=1))),
    "ten_aggs_no_group_by": (lambda: _dag([]), _rows),
    "streamed_by_handle": (lambda: _dag([col(0)], _int_aggs(), streamed=True), _rows),
}


@pytest.mark.parametrize("block_rows", [256, 1024])
@pytest.mark.parametrize("case", sorted(CASES))
def test_responses_match_jax_and_the_cpu_pipeline(case, block_rows):
    make_dag, make_kvs = CASES[case]
    port, cache = _check_request(make_dag(), make_kvs(), block_rows)
    if case == "q1":
        assert port._stable_dict_group_cols(cache.blocks) is not None


def test_groups_filtered_out_vanish_and_the_rest_keep_first_active_row_order():
    dag = _dag([col(4)], _int_aggs())
    kvs = _cached_kvs("filtered", lambda: _kvs(2500, 3, filtered_key=1))
    rows = TorchDagEvaluator(dag_to_wire(dag), block_rows=256, device="cpu").run(
        FixtureScanSource(kvs)).iter_rows()
    keys = [r[-1] for r in rows]
    assert b"k1" not in keys and sorted(keys) == [b"k0", b"k2"]


def _coded_caches(key_null_p=0.0, filtered_code=None, n_blocks=3, n=300, seed=0):
    """Both packages' caches over :func:`_schema`'s columns with the two
    varchar keys dictionary-coded (one dictionary object each, shared by
    every block), so the warm path computes group ids from the codes on the
    device.  ``filtered_code`` of the first key gets c2 = 950 on every row:
    the selection removes its whole group."""
    rng = np.random.default_rng(seed)
    d4 = np.empty(3, dtype=object)
    d4[:] = [b"x", b"y", b"z"]
    d5 = np.empty(4, dtype=object)
    d5[:] = [b"a", b"b", b"c", b"d"]
    blocks = []
    for b in range(n_blocks):
        nz = np.zeros(n, dtype=bool)
        ka = rng.integers(0, 3, n)
        c2 = rng.uniform(0, 1000, n)
        if filtered_code is not None:
            c2[ka == filtered_code] = 950.0
        blocks.append(([(EvalType.INT.value, np.arange(n, dtype=np.int64) + n * b, nz, 0, None),
                        (EvalType.INT.value, rng.integers(-100, 100, n), rng.random(n) < 0.1, 0,
                         None),
                        (EvalType.REAL.value, c2, rng.random(n) < 0.1, 0, None),
                        (EvalType.DECIMAL.value, rng.integers(-10**6, 10**6, n), nz, 2, None),
                        (EvalType.BYTES.value, ka, rng.random(n) < key_null_p, 0, d4),
                        (EvalType.BYTES.value, rng.integers(0, 4, n), nz, 0, d5),
                        (EvalType.INT.value, rng.integers(0, 40, n), nz, 0, None)], n))
    jax_cache = JaxCache()
    for cols, nv in blocks:
        jax_cache.add([Column(EvalType(et), data, nulls, frac, dic)
                       for et, data, nulls, frac, dic in cols], nv)
    jax_cache.filled = True
    return jax_cache, ColumnBlockCache.from_numpy_blocks(blocks)


CODED_CASES = {
    "one_key": ([4], None, None),
    "two_keys": ([5, 4], None, None),
    "mixed_coded_and_int_keys": ([4, 6], _int_aggs, None),
    "filtered_group": ([4], _int_aggs, 1),
    "ten_aggs_no_group_by": ([], None, None),
}


@pytest.mark.parametrize("case", sorted(CODED_CASES))
def test_warm_coded_ids_match_jax_and_the_cpu_pipeline(case):
    keys, aggs, filtered = CODED_CASES[case]
    dag = _dag([col(k) for k in keys], None if aggs is None else aggs())
    jax_cache, port_cache = _coded_caches(filtered_code=filtered)
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=512, device="cpu")
    coded = port._stable_dict_group_cols(port_cache.blocks) is not None
    assert coded == (case != "mixed_coded_and_int_keys")
    got = port.run(None, port_cache)
    real = _real(dag)
    cpu = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jax_cache, dag.executors[0].columns_info)
    ).handle_request()
    _same(got, cpu, real, "warm vs CPU pipeline")
    for hint in (None, "unary"):
        jev = jax_eval.JaxDagEvaluator(dag, block_rows=512)
        jev.route_hint = hint
        _same(got, jev.run(None, jax_cache), real, f"warm vs JAX route_hint={hint}")
    if filtered is not None:
        assert b"xyz"[filtered : filtered + 1] not in [r[-1] for r in got.iter_rows()]


def test_warm_coded_ids_keep_the_null_group():
    """A NULL key is its own group on the coded path, as in the CPU pipeline.
    The JAX package's coded scan ships null masks for the device columns
    only, so it folds NULL keys into their code's group: there the port is
    held to the CPU pipeline and to its own host-id path."""
    dag = _dag([col(4)], _int_aggs(), keys_nullable=True)
    jax_cache, port_cache = _coded_caches(key_null_p=0.2)
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=512, device="cpu")
    assert port._stable_dict_group_cols(port_cache.blocks) is not None
    got = port.run(None, port_cache)
    cpu = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jax_cache, dag.executors[0].columns_info)
    ).handle_request()
    assert got.encode() == cpu.encode()
    assert None in [r[-1] for r in got.iter_rows()]
    assert port._run_host_gids(port_cache).encode() == got.encode()


def test_empty_source_gives_no_group():
    dag = bench.q1_dag()
    got = TorchDagEvaluator(dag_to_wire(dag), block_rows=256, device="cpu").run(
        FixtureScanSource([]))
    want = jax_eval.JaxDagEvaluator(dag, block_rows=256).run(JaxSource([]))
    assert got.encode() == want.encode() == BatchExecutorsRunner(
        dag, JaxSource([])).handle_request().encode()
    assert got.iter_rows() == []


@pytest.mark.parametrize("aggs,n_keys", [("all", 200), ("int", 2500)])
def test_cold_capacity_grows_across_blocks(aggs, n_keys):
    """More groups than the first capacity (8), arriving block by block: the
    REAL plan stays under the shared-memory capacity, the integer plan grows
    past it (the JAX package's own start, 1024, too)."""
    dag = _dag([col(0)] if n_keys > 1000 else [call("multiply", col(6), col(6))],
               None if aggs == "all" else _int_aggs())
    kvs = _cached_kvs("rows", lambda: _kvs(2500, 1))
    port, _cache = _check_request(dag, kvs, 256)
    resp = port.run(FixtureScanSource(kvs))
    assert len(resp.iter_rows()) > 8


def _big_dict_cache(n_slots):
    rng = np.random.default_rng(5)
    d = np.empty(n_slots, dtype=object)
    d[:] = [b"v%d" % i for i in range(n_slots)]
    n = 2000
    nz = np.zeros(n, dtype=bool)
    return ColumnBlockCache.from_numpy_blocks([(
        [(EvalType.INT.value, np.arange(n, dtype=np.int64), nz, 0, None),
         (EvalType.INT.value, rng.integers(-100, 100, n), nz, 0, None),
         (EvalType.REAL.value, rng.uniform(0, 1000, n), nz, 0, None),
         (EvalType.DECIMAL.value, rng.integers(-10**6, 10**6, n), nz, 2, None),
         (EvalType.BYTES.value, rng.integers(0, n_slots, n), nz, 0, d),
         (EvalType.BYTES.value, np.zeros(n, dtype=np.int64), nz, 0, d[:1]),
         (EvalType.INT.value, rng.integers(0, 40, n), nz, 0, None)], n)])


@pytest.mark.parametrize("path", ["cold", "warm_coded", "warm_host"])
def test_real_leaves_past_the_shared_capacity_decline_by_name(path):
    """More group slots than the shared-memory partials hold, with f64
    leaves: declined by name (cold: at the block where the groups cross the
    limit; warm: before any launch).  Integer leaves take any capacity."""
    group_by = [col(4)] if path == "warm_coded" else [col(0)]
    br = 256 if path == "cold" else 2048
    port = TorchDagEvaluator(dag_to_wire(_dag(group_by)), block_rows=br, device="cpu")
    int_port = TorchDagEvaluator(dag_to_wire(_dag(group_by, _int_aggs())), block_rows=br,
                                 device="cpu")
    c_max = port.plan.group_program.c_max
    if path == "cold":
        def run(ev):
            return ev.run(FixtureScanSource(_rows()))
    else:
        cache = _big_dict_cache(c_max + 40)

        def run(ev):
            return ev.run(None, cache)
    with pytest.raises(fa.Unsupported) as exc:
        run(port)
    assert exc.value.cause == "real_group_capacity_not_ported"
    assert len(run(int_port).iter_rows()) > c_max


# ---------------------------------------------------------------------------
# TPC-H Q1 against the oracle
# ---------------------------------------------------------------------------

def test_q1_matches_the_numpy_oracle_cold_and_warm():
    n = 20_000
    a = fx.build_arrays(n, seed=9)
    ev = TorchDagEvaluator(dag_to_wire(bench.q1_dag()), block_rows=4096, device="cpu")
    want = fx.q1_oracle(a)
    assert len(want) == 6
    assert ev.run(FixtureScanSource(fx.build_kvs(n, seed=9))).iter_rows() == want
    cache = fx.build_cache(n, 4096, seed=9)
    assert ev._stable_dict_group_cols(cache.blocks) is not None
    assert ev.run(None, cache).iter_rows() == want
    assert TorchDagEvaluator(port_wire(fx.qty_dag()), block_rows=4096, device="cpu").run(
        None, cache).iter_rows() == fx.qty_oracle(a)


def test_port_q1_plan_is_the_bench_plan():
    assert port_wire(fx.q1_dag()) == dag_to_wire(bench.q1_dag())


# ---------------------------------------------------------------------------
# the contract with the CUDA source
# ---------------------------------------------------------------------------

SOURCE = Path(ga.__file__).resolve().parent.parent / "csrc" / "fused_agg.cu"


def test_leaf_kinds_and_limits_match_the_cuda_source():
    text = SOURCE.read_text()
    table = {m.group(1): int(m.group(2)) for m in re.finditer(r"\bGA_([A-Z]+) = (\d+)", text)}
    assert table == {k[len("LEAF_"):]: v for k, v in vars(ga).items() if k.startswith("LEAF_")}
    defines = dict(re.findall(r"#define (\w+) (\d+)", text))
    assert int(defines["GA_MAX_LEAVES"]) == ga.MAX_LEAVES
    assert int(defines["GA_MAX_KEYS"]) == ga.MAX_KEYS
    assert int(defines["GA_SMEM_MAX"]) == ga.SMEM_MAX
    assert int(defines["FA_THREADS"]) == ga.THREADS
    assert int(defines["FA_GRID"]) == ga.GRID_MAX


def test_group_params_struct_layout():
    # GaParams: 35 pointers, the 384-byte column descriptors (FaEnc), four
    # int64, 64 constants, 64 leaf identities, 256 code words, seven int32,
    # two int32[4], two int32[16], six int8[64] tables, padded to 8 bytes;
    # with the combine's other arguments it stays under the 4 KB
    # kernel-parameter limit.  The wrapper re-checks the kernel's sizeof at
    # load.
    assert ctypes.sizeof(ga._GaParams) == 3320
    prog = TorchDagEvaluator(dag_to_wire(bench.q1_dag()), block_rows=64,
                             device="cpu").plan.group_program
    assert len(prog.leaves) == 10 and prog.c_max == 331
    assert [leaf.kind for leaf in prog.leaves] == [
        ga.LEAF_TRACK, ga.LEAF_COUNT, ga.LEAF_SUM, ga.LEAF_COUNT, ga.LEAF_SUM, ga.LEAF_COUNT,
        ga.LEAF_SUM, ga.LEAF_COUNT, ga.LEAF_SUM, ga.LEAF_COUNT]


def test_grouped_kernel_path_refuses_cpu_and_other_devices():
    gen = torch.Generator().manual_seed(1)
    prog, img, cap = fx.synthetic_group_case("host", 1, 256, gen, CPU)
    with pytest.raises(ValueError, match="CUDA image"):
        ga.launch_partials(prog, img, cap, ga.new_partials(prog, img, cap))
    img.device = torch.device("meta")
    with pytest.raises(ValueError, match="no fused_group_agg"):
        ga.fused_group_agg(prog, img, cap)
