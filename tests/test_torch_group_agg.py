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


def _dag(group_by, aggs=None, keys_nullable=False, streamed=False, conds=None):
    return DagRequest(executors=[
        TableScan(TABLE, _schema(keys_nullable)), Selection(_conds() if conds is None else conds),
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


def _wide_pair(prog, img, cap, carry=None):
    """The wide route's plain versions, word for word the kernels':
    ``group_wide_partials`` then ``group_wide_combine``."""
    return ga.wide_combine_plain(prog, img, cap, ga.wide_partials_plain(prog, img, cap), carry)


def _same_bits_where_zero(got, want):
    gf, wf = got[1].numpy(), np.asarray(want[1])
    zero = wf == 0
    np.testing.assert_array_equal(np.signbit(gf[zero]), np.signbit(wf[zero]))


@pytest.mark.parametrize("times", [1, 4], ids=["c_max_plus_1", "4_c_max"])
@pytest.mark.parametrize("path", ["cold", "warm_host", "warm_coded"])
def test_wide_route_matches_jax_leaf_by_leaf(path, times):
    """Past the shared-memory slots (``c_max + 1`` and ``4 * c_max``): the
    JAX package's block step (cold, carried over two blocks), stacked scan
    with host ids and coded scan, against ``fused_group_agg`` and the wide
    route's plain versions, leaf by leaf: integer leaves exact, f64 leaves
    to rel 1e-12 with NaN, +-inf and +-0.0 among the REAL values (signed
    zeros exact)."""
    rng = np.random.default_rng(30 + times)
    br = 512
    conds = _conds()[:1]
    group_by = [col(4), col(5)] if path == "warm_coded" else [col(6)]
    ev = jax_eval.JaxDagEvaluator(_dag(group_by, conds=conds), block_rows=br)
    port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
    prog = port.plan.group_program
    cap = times * prog.c_max + (1 if times == 1 else 0)
    assert not prog.shared_rows(cap)

    def draw(ship, nb):
        data, nulls = _inputs(ship, ev.nullable_cols, nb, br, rng)
        data[2] = _with_specials(data[2], rng)
        return data, nulls

    def check(got, want):
        _assert_state(got, want)
        _same_bits_where_zero(got, want)

    if path == "cold":
        state = (jnp.full(cap, jax_eval._NO_ROW, dtype=jnp.int64),
                 tuple(da.init_carry(cap) for da in ev.device_aggs))
        carry = wide = None
        offset = 0
        for n_valid in (br - 40, br):
            data, nulls = draw(ev.device_cols, 1)
            gids = rng.integers(0, cap, (1, br)).astype(np.int32)
            state = ev._build_agg_fn(cap)([data[i][0] for i in ev.device_cols],
                                          [nulls[i][0] for i in ev.nullable_cols], n_valid,
                                          gids[0], offset, state)
            img = _image(ev.device_cols, ev.nullable_cols, data, nulls, n_valid, offset, gids)
            carry = ga.fused_group_agg(prog, img, cap, carry)
            wide = _wide_pair(prog, img, cap, wide)
            want = jax_eval._pack_state(state)
            check(carry, want)
            check(wide, want)
            offset += n_valid
        return
    nb = len(N_VALIDS)
    if path == "warm_host":
        data, nulls = draw(ev.device_cols, nb)
        gids = rng.integers(0, cap, (nb, br)).astype(np.int32)
        want = ev._build_scan_fn(cap, nb)(tuple(data[i] for i in ev.device_cols),
                                          tuple(nulls[i] for i in ev.nullable_cols),
                                          N_VALIDS, gids, _offsets(N_VALIDS), None)
        img = _image(ev.device_cols, ev.nullable_cols, data, nulls, N_VALIDS,
                     _offsets(N_VALIDS), gids)
    else:
        group_cols = [4, 5]
        dict_lens = (cap // 5, 4)  # about cap slots, the NULL code included
        ship = ev._ship_cols(group_cols)
        prog = port._coded_program(group_cols, dict_lens)
        data, nulls = draw(ship, nb)
        data[4] = rng.integers(0, dict_lens[0], (nb, br)).astype(np.int64)
        data[5] = rng.integers(0, dict_lens[1], (nb, br)).astype(np.int64)
        want = ev._build_scan_fn_coded(dict_lens, cap, nb, group_cols)(
            tuple(data[i] for i in ship), tuple(nulls[i] for i in ev.nullable_cols),
            N_VALIDS, _offsets(N_VALIDS), None)
        img = _image(ship, ev.nullable_cols, data, nulls, N_VALIDS, _offsets(N_VALIDS))
    check(ga.fused_group_agg(prog, img, cap), want)
    check(_wide_pair(prog, img, cap), want)


def test_wide_route_sums_are_exact_and_order_free():
    """The wide route's f64 sums are the exact sums of the rows' values
    rounded once: equal, bit for bit, to ``math.fsum`` over each group (and
    so to any order of the rows), where a fixed-order f64 fold is not."""
    import math

    rng = np.random.default_rng(40)
    vals = rng.uniform(-1, 1, 4096) * 10.0 ** rng.integers(-30, 30, 4096)
    gids = rng.integers(0, 300, 4096)
    cells = torch.zeros((300, ga.XWORDS), dtype=torch.int64)
    for order in (np.arange(4096), rng.permutation(4096)):
        cells.zero_()
        k, digits = ga._xdigits(torch.from_numpy(vals[order]))
        base = torch.from_numpy(gids[order]) * ga.XWORDS + k
        for q, d in enumerate(digits):
            cells.view(-1).index_add_(0, base + q, d)
        got = ga._xround(cells).numpy()
        want = np.array([math.fsum(vals[gids == g]) for g in range(300)])
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", fx.XROUND_EDGE_CASES)
def test_exact_sum_rounding_edges_match_an_exact_reference(name):
    """The combine's rounding (``_xround``, the plain version of the kernel's
    warp-wide rounding) at its edges (``fx.xround_edge_words``: random signed
    words in all 66 positions and in the 63 lowest, ties at the rounding
    bit with even and odd mantissas and one unit either side, subnormal
    results down to the smallest, sums that cancel to zero, negative sums,
    sums at and past the largest double; each value in plain digits and
    with carries moved between the words) against Python's correctly
    rounded ``Fraction`` division, bit for bit."""
    words = fx.xround_edge_words(name)
    got = ga._xround(torch.from_numpy(words)).numpy()
    want = np.array([fx.exact_word_value(w) for w in words])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("flags", range(8))
def test_exact_sum_flags_take_precedence_over_the_sum(flags):
    """Each combination of the NaN, +inf and -inf flags of an f64 sum cell:
    NaN with the NaN flag or both infinities, else the one infinity, else
    the rounded sum."""
    words = fx.xround_edge_words("ties")[:6]
    got = ga._xtotal(torch.full((6,), flags, dtype=torch.int64), torch.from_numpy(words))
    if flags & ga.XFLAG_NAN or flags & 3 == 3:
        assert bool(got.isnan().all())
    elif flags:
        assert bool((got == (float("inf") if flags & ga.XFLAG_POSINF else float("-inf"))).all())
    else:
        np.testing.assert_array_equal(got.numpy(), [fx.exact_word_value(w) for w in words])


def test_crafted_wide_state_combines_to_the_exact_sums():
    """The crafted wide-route state the on-card combine check takes
    (``fx.wide_combine_crafted``: every rounding edge in each f64 sum leaf,
    each flag combination, ``host_wide``'s other leaves): the plain combine
    gives every crafted cell's exactly rounded sum, NaN and the infinities
    as the flags say."""
    prog, img, cap, state = fx.wide_combine_crafted("cpu")
    words = np.concatenate([fx.xround_edge_words(n) for n in fx.XROUND_EDGE_CASES])
    want = np.array([fx.exact_word_value(w) for w in words])
    out_i, out_f = ga.wide_combine_plain(prog, img, cap, state)
    n = len(words)
    for x, l in enumerate(prog.x_leaves):
        got = out_f[prog.leaves[l].slot].numpy()
        np.testing.assert_array_equal(got[:n].view(np.int64), np.roll(want, x).view(np.int64))
        flagged = got[n : n + 8]
        assert flagged[0] == 0.0 and flagged[1] == np.inf and flagged[2] == -np.inf
        assert np.isnan(flagged[3:]).all()


# ---------------------------------------------------------------------------
# whole requests
# ---------------------------------------------------------------------------

def _row_kvs(schema, rows):
    return [(record_key(TABLE, h), encode_row(schema[1:], values)) for h, values in enumerate(rows)]


def _kvs(n, seed, keys_nullable=False, n_keys=3, filtered_key=None, specials=False):
    """Rows of :func:`_schema`; ``filtered_key`` gets c2 >= 900 on every row,
    so the selection removes the whole group; ``specials`` puts NaN, +-inf
    and +-0.0 among signed c2 values (:func:`_with_specials`)."""
    rng = np.random.default_rng(seed)
    holes = rng.random((4, n)) < 0.1
    c2s = _with_specials(rng.uniform(0, 1000, n), rng) if specials else None
    rows = []
    for r in range(n):
        ka, kb = int(rng.integers(0, n_keys)), int(rng.integers(0, 4))
        c2 = float(rng.uniform(0, 1000)) if c2s is None else float(c2s[r])
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


def _big_dict_caches(n_slots, specials=False):
    """Both packages' caches of one 2,000-row block of :func:`_schema`'s
    columns, the first varchar key coded over a dictionary of ``n_slots``
    values (ids from the codes past the shared-memory slots); with
    ``specials`` the REAL column holds NaN, +-inf and +-0.0 among signed
    values."""
    rng = np.random.default_rng(5)
    d = np.empty(n_slots, dtype=object)
    d[:] = [b"v%d" % i for i in range(n_slots)]
    n = 2000
    nz = np.zeros(n, dtype=bool)
    c2 = rng.uniform(0, 1000, n)
    if specials:
        c2 = _with_specials(c2, rng)
    blocks = [(
        [(EvalType.INT.value, np.arange(n, dtype=np.int64), nz, 0, None),
         (EvalType.INT.value, rng.integers(-100, 100, n), nz, 0, None),
         (EvalType.REAL.value, c2, nz, 0, None),
         (EvalType.DECIMAL.value, rng.integers(-10**6, 10**6, n), nz, 2, None),
         (EvalType.BYTES.value, rng.integers(0, n_slots, n), nz, 0, d),
         (EvalType.BYTES.value, np.zeros(n, dtype=np.int64), nz, 0, d[:1]),
         (EvalType.INT.value, rng.integers(0, 40, n), nz, 0, None)], n)]
    jax_cache = JaxCache()
    for cols, nv in blocks:
        jax_cache.add([Column(EvalType(et), data, nulls, frac, dic)
                       for et, data, nulls, frac, dic in cols], nv)
    jax_cache.filled = True
    return jax_cache, ColumnBlockCache.from_numpy_blocks(blocks)


def _with_specials(x, rng, p=0.08):
    """``x`` with its sign flipped in a third of the entries and NaN, +inf,
    -inf, -0.0 or +0.0 in a share ``p`` of them."""
    x = np.where(rng.random(x.shape) < 0.3, -x, x)
    special = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0])[rng.integers(0, 5, x.shape)]
    return np.where(rng.random(x.shape) < p, special, x)


def _serve_warm(dag, jax_cache, port_cache, br):
    """The port's warm answer against the JAX evaluator's (both routes) and
    the CPU pipeline's over the same blocks; returns the port's evaluator
    and answer."""
    real = _real(dag)
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cpu")
    got = port.run(None, port_cache)
    cpu = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jax_cache, dag.executors[0].columns_info)
    ).handle_request()
    _same(got, cpu, real, "warm vs CPU pipeline")
    for hint in (None, "unary"):
        jev = jax_eval.JaxDagEvaluator(dag, block_rows=br)
        jev.route_hint = hint
        _same(got, jev.run(None, jax_cache), real, f"warm vs JAX route_hint={hint}")
    return port, got


@pytest.mark.parametrize("path", ["cold", "warm_coded", "warm_host"])
def test_real_leaves_past_the_shared_capacity_decline_by_name(path):
    """More group slots than the shared-memory partials hold, with f64
    leaves (a name kept from when the port declined them): served by the
    grouped pair's wide route, cold (the capacity grown past ``c_max``
    block by block) and warm, with ids from the host or from dictionary
    codes, equal to the JAX evaluator and the CPU pipeline (f64 values to
    rel 1e-12); the integer-only plan too."""
    group_by = [col(4)] if path == "warm_coded" else [col(0)]
    for aggs in (None, _int_aggs()):
        dag = _dag(group_by, aggs)
        c_max = TorchDagEvaluator(dag_to_wire(dag), device="cpu").plan.group_program.c_max
        if path == "cold":
            port, _cache = _check_request(dag, _rows(), 256)
            resp = port.run(FixtureScanSource(_rows()))
        else:
            jax_cache, port_cache = _big_dict_caches(c_max + 40)
            port, resp = _serve_warm(dag, jax_cache, port_cache, 2048)
            assert (port._stable_dict_group_cols(port_cache.blocks) is not None) \
                == (path == "warm_coded")
        assert len(resp.iter_rows()) > c_max


@pytest.mark.parametrize("path", ["cold", "warm_coded", "warm_host"])
def test_wide_requests_with_nan_and_infinities_match_jax(path):
    """The wide route over REAL values with NaN, +-inf and +-0.0: var_pop,
    REAL sum/avg/min/max/first among the ten aggregates, served past
    ``c_max`` cold, warm by host ids and warm by coded ids, equal to the JAX
    evaluator and the CPU pipeline.  The selection keeps NaN rows (no
    comparison on the REAL column)."""
    group_by = [col(4)] if path == "warm_coded" else [col(0)]
    dag = _dag(group_by, conds=_conds()[:1])
    if path == "cold":
        kvs = _cached_kvs("special_rows", lambda: _kvs(2500, 7, specials=True))
        port, _cache = _check_request(dag, kvs, 256)
        resp = port.run(FixtureScanSource(kvs))
    else:
        c_max = TorchDagEvaluator(dag_to_wire(dag), device="cpu").plan.group_program.c_max
        jax_cache, port_cache = _big_dict_caches(4 * c_max, specials=True)
        port, resp = _serve_warm(dag, jax_cache, port_cache, 2048)
    vals = [v for row in resp.iter_rows() for v in row if isinstance(v, float)]
    assert any(np.isnan(vals)) and any(np.isinf(vals))
    assert port.run(*((FixtureScanSource(kvs),) if path == "cold" else (None, port_cache))
                    ).encode() == resp.encode()


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

CSRC = Path(ga.__file__).resolve().parent.parent / "csrc"


def test_leaf_kinds_and_limits_match_the_cuda_source():
    # the leaf kinds and limits live in the header the grouped and batch
    # kernels share; the geometry in fused_agg.cu
    text = (CSRC / "ga_leaf.cuh").read_text() + (CSRC / "fused_agg.cu").read_text()
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


# ---------------------------------------------------------------------------
# fused_group_agg_partials' tile walk: its grid, its rows, its instance
# ---------------------------------------------------------------------------

N_VALIDS_510 = np.array([510, 0, 510, 301, 0, 510, 77], dtype=np.int64)


@pytest.mark.parametrize("ids", ["host", "coded"])
@pytest.mark.parametrize("br", [510, 512])
def test_partials_at_the_tile_walks_assignment_match_jax(ids, br):
    """Both plain halves of the grouped pair composed at the partials
    kernel's own grid and rows (``ROWS`` rows of a block a thread, tile u in
    block (u mod grid * THREADS) // THREADS): blocks of 510 rows end in a
    short tile and n_valid 301 and 77 cut one; against the JAX package's
    stacked scan with host ids and with ids from dictionary codes."""
    rng = np.random.default_rng(23)
    nv = N_VALIDS if br == 512 else N_VALIDS_510
    nb = len(nv)
    if ids == "host":
        ev = jax_eval.JaxDagEvaluator(_dag([col(6)]), block_rows=br)
        port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
        prog, ship, cap = port.plan.group_program, ev.device_cols, 64
        data, nulls = _inputs(ship, ev.nullable_cols, nb, br, rng)
        gids = rng.integers(0, 50, (nb, br)).astype(np.int32)
        want = ev._build_scan_fn(cap, nb)(tuple(data[i] for i in ship),
                                          tuple(nulls[i] for i in ev.nullable_cols),
                                          nv, gids, _offsets(nv), None)
    else:
        group_cols = [4, 5]
        ev = jax_eval.JaxDagEvaluator(_dag([col(4), col(5)]), block_rows=br)
        ship = ev._ship_cols(group_cols)
        port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=br, device="cpu")
        prog, cap, gids = port._coded_program(group_cols, DICT_LENS), 32, None
        data, nulls = _inputs(ship, ev.nullable_cols, nb, br, rng)
        want = ev._build_scan_fn_coded(DICT_LENS, cap, nb, group_cols)(
            tuple(data[i] for i in ship), tuple(nulls[i] for i in ev.nullable_cols),
            nv, _offsets(nv), None)
    img = _image(ship, ev.nullable_cols, data, nulls, nv, _offsets(nv), gids)
    parts = ga.partials_plain(prog, img, cap)
    assert tuple(parts.shape) == (ga.launch_grid(img), len(prog.leaves), cap)
    _assert_state(ga.combine_plain(prog, img, cap, parts), want)


def test_launch_grid_counts_tiles_and_the_wide_route_rows():
    """fused_group_agg_partials takes one block per THREADS tiles of ROWS
    rows of a block (a short block's last tile counts whole), at most
    GRID_MAX; group_wide_partials walks the same tiles on the same grid."""
    def img(n_blocks, block_rows):
        return fa.Image([], [], block_rows, n_blocks, block_rows, CPU, 0)

    assert ga.ROWS == 4
    for (nb, br), tiles in (((763, 1 << 17), 528), ((1, 1 << 16), 64), ((1, 1 << 17), 128),
                            ((1, 1024), 1), ((3, 1001), 3), ((1, 1), 1)):
        assert ga.launch_grid(img(nb, br)) == tiles, (nb, br)
        assert ga.wide_grid(img(nb, br)) == tiles, (nb, br)


@pytest.mark.parametrize("block_rows", [1001, 1024])
def test_grouped_partials_plain_gives_a_threads_rows_to_its_block(block_rows):
    """partials_plain follows the kernel's tile assignment by default: row i
    of block b lies in tile b * ceil(block_rows / ROWS) + i // ROWS, and
    tile u in block (u mod grid * THREADS) // THREADS; a count's partials
    are those blocks' valid rows whose id lies in the slots (ids past C
    count nowhere; the grid strides)."""
    from tikv_tpu_torch.copr.fused_group_agg import LEAF_COUNT

    rng = np.random.default_rng(29)
    nb = 600
    ev = jax_eval.JaxDagEvaluator(_dag([col(6)], [AggDescriptor("count", col(1))], conds=[]),
                                  block_rows=block_rows)
    port = TorchDagEvaluator(dag_to_wire(ev.dag), block_rows=block_rows, device="cpu")
    prog, cap = port.plan.group_program, 16
    nv = np.full(nb, block_rows, dtype=np.int64)
    nv[-1] -= 77
    gids = rng.integers(0, cap + 4, (nb, block_rows)).astype(np.int32)  # some past C
    data, nulls = _inputs(ev.device_cols, ev.nullable_cols, nb, block_rows, rng, null_p=0.0)
    img = _image(ev.device_cols, ev.nullable_cols, data, nulls, nv, _offsets(nv), gids)
    grid = ga.launch_grid(img)
    assert grid == ga.GRID_MAX and grid * ga.THREADS * ga.ROWS < nb * block_rows
    parts = ga.partials_plain(prog, img, cap)
    leaf = [l.kind for l in prog.leaves].index(LEAF_COUNT)
    rows = np.arange(nb * block_rows)
    b, i = rows // block_rows, rows % block_rows
    ok = (i < nv[b]) & (gids.reshape(-1) < cap)
    tile = b * -(-block_rows // ga.ROWS) + i // ga.ROWS
    blk = (tile % (grid * ga.THREADS)) // ga.THREADS
    want = np.zeros((grid, cap), dtype=np.int64)
    np.add.at(want, (blk[ok], gids.reshape(-1)[ok]), 1)
    np.testing.assert_array_equal(parts[:, leaf].numpy(), want)
    # the same rows through the whole plain pair: ids past C drop
    np.testing.assert_array_equal(
        ga.combine_plain(prog, img, cap, parts)[0].numpy(),
        ga.fused_group_agg_plain(prog, img, cap)[0].numpy())


def test_partials_instance_follows_the_plan():
    """The launcher runs the fused_group_agg_partials instance whose stack
    holds the plan (the fewest of 2, 4 or 8 slots, read as the batch's
    launcher reads it); c_max is what fits its rows in shared memory, 331
    slots for Q1's 10 leaves."""
    q1 = TorchDagEvaluator(dag_to_wire(bench.q1_dag()), block_rows=64,
                           device="cpu").plan.group_program
    assert ga.partials_slots(q1) == fa.stack_slots([q1.code])
    assert q1.c_max == 331
    assert ga.partials_smem(q1, 331) <= ga.SMEM_MAX < ga.partials_smem(q1, 332)
    gen = torch.Generator().manual_seed(5)
    for kind in fx.GROUP_CASES:
        prog, _img, cap = fx.synthetic_group_case(kind, 1, 256, gen, CPU)
        assert ga.partials_slots(prog) in (2, 4, 8)
        assert ga.partials_slots(prog) >= fa.stack_depth(prog.code)
        assert prog.shared_rows(cap) == (ga.partials_smem(prog, cap) <= ga.SMEM_MAX)


def test_tile_walk_constants_match_the_cuda_source():
    """GA_ROWS of csrc/fused_agg.cu against the wrapper's, the three
    instances the launcher picks from, and the fold in the one header both
    partials kernels include."""
    agg = (CSRC / "fused_agg.cu").read_text()
    batch = (CSRC / "fused_batch.cu").read_text()
    fold = (CSRC / "ga_fold.cuh").read_text()
    assert int(re.search(r"#define GA_ROWS (\d+)", agg).group(1)) == ga.ROWS
    for slots in (2, 4, 8):
        assert f"fused_group_agg_partials<{slots}>" in agg
    for text in (agg, batch):
        assert '#include "ga_fold.cuh"' in text
        assert "ga_walk_tiles<" in text and "ga_row_atomic" not in text
    assert "ga_row_atomic(" in fold and "__match_any_sync" in fold


def test_combine_instance_follows_the_plan_and_the_capacity():
    """The combine the launcher picks: ``fused_group_agg_combine_pack`` up
    to c_max, ``group_wide_combine`` past it, each the instance of the
    partials' stack slots (first's walk at the winning row), for Q1 and
    every synthetic case at its own capacity and at c_max and c_max + 1."""
    q1 = TorchDagEvaluator(dag_to_wire(bench.q1_dag()), block_rows=64,
                           device="cpu").plan.group_program
    assert ga.combine_kernel(q1, 8) == ("fused_group_agg_combine_pack", ga.partials_slots(q1))
    assert ga.combine_kernel(q1, 331)[0] == "fused_group_agg_combine_pack"
    assert ga.combine_kernel(q1, 332)[0] == "group_wide_combine"
    gen = torch.Generator().manual_seed(5)
    for kind in fx.GROUP_CASES:
        prog, _img, cap = fx.synthetic_group_case(kind, 1, 256, gen, CPU)
        for c in (cap, prog.c_max, prog.c_max + 1):
            name, slots = ga.combine_kernel(prog, c)
            assert name == ("fused_group_agg_combine_pack" if prog.shared_rows(c)
                            else "group_wide_combine"), (kind, c)
            assert slots == ga.partials_slots(prog) >= fa.stack_depth(prog.code)


def test_combine_and_mesh_fold_share_one_tree():
    """fused_group_agg_combine_pack runs a warp a cell with no barrier, in
    instances of 2, 4 and 8 stack slots, first's value by the tile walk (no
    one-row walk left in fused_agg.cu); the combine's tree is one function
    of ga_leaf.cuh that it and mesh_fold both call."""
    agg = (CSRC / "fused_agg.cu").read_text()
    mesh = (CSRC / "fused_mesh.cu").read_text()
    leaf = (CSRC / "ga_leaf.cuh").read_text()
    for slots in (2, 4, 8):
        assert f"fused_group_agg_combine_pack<{slots}>" in agg
    body = agg[agg.index("fused_group_agg_combine_pack(const __grid_constant__"):]
    body = body[: body.index("\n}\n")]
    assert "__syncthreads" not in body and "ga_tree_fold<" in body
    assert "fa_walk(" not in agg and "ga_finish_cell<D>(" in agg
    assert "ga_tree_fold<" in mesh and "__shfl_down_sync" not in mesh
    # one table of merge rules: mesh_fold picks its rule through ga_with_rule
    assert "ga_with_rule(" in mesh and "mf_fold_cell<Ga" not in mesh
    assert leaf.count("long long ga_tree_fold(") == 1
    assert int(re.search(r"#define GA_TREE (\d+)", leaf).group(1)) == ga.THREADS


@pytest.mark.parametrize("name", fx.GROUP_EDGE_CASES)
def test_grouped_edge_cases_through_the_plain_pair(name):
    """fx.group_edge_cases on the CPU: the partials' plain version at the
    kernel's grid and tiles, folded by the combine's, equals the one-pass
    plain version (ids past C drop, one slot, short tiles, every leaf kind,
    an encoded image), and the instance the launcher would pick holds the
    plan."""
    prog, img, cap = fx.group_edge_cases(CPU, (name,))[name]
    assert prog.shared_rows(cap)
    parts = ga.partials_plain(prog, img, cap)
    got = ga.combine_plain(prog, img, cap, parts)
    want = ga.fused_group_agg_plain(prog, img, cap)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0, equal_nan=True)
    assert ga.partials_slots(prog) >= fa.stack_depth(prog.code)
    assert ga.partials_smem(prog, cap) <= ga.SMEM_MAX
    if name == "mixed_encoded":
        assert img.descs is not None


# ---------------------------------------------------------------------------
# group_wide_partials' tile walk: its edges and instances
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", fx.WIDE_EDGE_CASES)
def test_wide_edge_cases_through_the_plain_pair(name):
    """fx.wide_edge_cases on the CPU, past c_max: the wide route's plain
    versions (the state word for word, its combine) equal the one-pass
    plain version (integers exactly, f64 to rel 1e-12, NaN equal to NaN),
    on ragged tiles with host ids past C and below 0, ids from narrowed
    codes over an encoded image, blocks zone maps pruned and one hot slot;
    the launcher's instance is the one the name says."""
    prog, img, cap = fx.wide_edge_cases(CPU, (name,))[name]
    assert not prog.shared_rows(cap)
    state = ga.wide_partials_plain(prog, img, cap)
    assert tuple(state.shape) == (ga.wide_size(prog, cap),)
    got = ga.wide_combine_plain(prog, img, cap, state)
    want = ga.fused_group_agg_plain(prog, img, cap)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0, equal_nan=True)
    if name[-3:] in ("_s2", "_s4", "_s8"):
        assert ga.partials_slots(prog) == int(name[-1])
    live = int((want[0][0] < fa.NO_ROW).sum())  # slots the tracker saw
    if name == "hot":
        assert live == 1 and int(want[0][0][cap - 1]) < fa.NO_ROW
        assert prog.x_leaves  # an exact f64 sum cell takes every row
    else:
        assert live > 1
    if name == "date_sorted":
        assert bool((img.n_valids == 0).any())
