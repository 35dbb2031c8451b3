"""The zone-tiled warm rung: the port against the JAX package.

One port case for each test of ``tests/test_jax_zone.py``, on the CPU
through the plain versions of the zone-tile kernels, with tiles of 64 rows
in both packages so that full, empty and partial tiles all occur.  Every
case holds the port's response bytes, on its default (zone) route and under
``route_hint="unary"``, to ``JaxDagEvaluator`` on both of its routes and to
the CPU pipeline, and says which rung served.  Then one test per named
decline cause, a kernel failure that raises, the layout's bookkeeping, the
tile kernels' plain versions against a direct computation, and the seven
null-safe scalar functions the rung needed against the JAX package's
kernels.  Inputs come from ``np.random.default_rng``.
"""

import dataclasses
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tikv_tpu.copr import jax_zone
from tikv_tpu.copr import kernels as jkernels
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.cache import ColumnBlockCache as JaxCache
from tikv_tpu.copr.dag import (
    Aggregation,
    BatchExecutorsRunner,
    DagRequest,
    Selection,
    TableScan,
    TopN,
)
from tikv_tpu.copr.datatypes import Column, ColumnInfo, EvalType, FieldType
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.executors import FixtureScanSource
from tikv_tpu.copr.jax_eval import JaxDagEvaluator
from tikv_tpu.copr.rpn import call, col, const_decimal, const_int
from tikv_tpu.copr.table import encode_row, record_key
from tikv_tpu_torch.copr import encoding, zone
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import fused_zone as fz
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.fused_group_agg import fused_group_agg
from tikv_tpu_torch.copr.kernels import KERNELS
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

TABLE = 88
TILE = 64


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """Small tiles in both packages: a few thousand rows make many tiles."""
    monkeypatch.setattr(jax_zone, "TILE_ROWS", TILE)
    monkeypatch.setattr(zone, "TILE_ROWS", TILE)


def _port_cache(jax_cache):
    return ColumnBlockCache.from_numpy_blocks(
        [([(c.eval_type.value, np.asarray(c.data), np.asarray(c.nulls), c.frac, c.dictionary)
           for c in b.cols], b.n_valid) for b in jax_cache.blocks])


def _table(n, seed=0, with_nulls=False, block=2048):
    """id, v int (the range column), d decimal(2), tag varchar (dictionary-
    coded group key), w int; optional NULLs in v and tag.  Returns (schema,
    kvs for the CPU pipeline, JAX cache, port cache): both caches hold the
    same decoded image, the tags coded against ONE dictionary shared by
    every block (the stable-dictionary contract the rung keys on)."""
    rng = np.random.default_rng(seed)
    cols = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.decimal_type(2)),
            ColumnInfo(4, FieldType.varchar()),
            ColumnInfo(5, FieldType.int64())]
    v = rng.integers(0, 10_000, n)
    d = rng.integers(0, 5_000, n)
    tags = [b"alpha", b"beta", b"gamma"]
    t = rng.integers(0, 3, n)
    w = rng.integers(-50, 50, n)
    null_v = rng.random(n) < 0.05 if with_nulls else np.zeros(n, dtype=bool)
    null_t = rng.random(n) < 0.05 if with_nulls else np.zeros(n, dtype=bool)
    kvs = [(record_key(TABLE, i), encode_row(cols[1:], [
        None if null_v[i] else int(v[i]), int(d[i]), None if null_t[i] else tags[t[i]],
        int(w[i])])) for i in range(n)]
    dictionary = np.empty(3, dtype=object)
    dictionary[:] = tags
    handles = np.arange(n, dtype=np.int64)
    cache = JaxCache()
    for s in range(0, n, block):
        e = min(s + block, n)
        z = np.zeros(e - s, dtype=bool)
        cache.add([Column(EvalType.INT, handles[s:e], z.copy()),
                   Column(EvalType.INT, np.where(null_v[s:e], 0, v[s:e]), null_v[s:e].copy()),
                   Column(EvalType.DECIMAL, d[s:e].copy(), z.copy(), 2),
                   Column(EvalType.BYTES, t[s:e].astype(np.int64), null_t[s:e].copy(), 0,
                          dictionary),
                   Column(EvalType.INT, w[s:e].copy(), z.copy())], e - s)
    cache.filled = True
    return cols, kvs, cache, _port_cache(cache)


FIX = _table(6000)
NFIX = _table(6000, seed=1, with_nulls=True)


def _zone_served(jev) -> bool:
    z = getattr(jev, "_zone", None)
    return bool(z) and z.served > 0


def check(executors, fix, block_rows=2048, port_zone=True, jax_zone_served=True):
    """The port's bytes on both routes against the JAX package's on both
    routes and the CPU pipeline; asserts which rung served.  Returns the
    port's default-route evaluator.  Over NFIX's NULL group keys the JAX
    package's unary route is wrong (its coded ids drop NULL keys: ROADMAP
    queue 3, a fault of the reference), so there it is held to differ."""
    cols, kvs, jcache, pcache = fix
    dag = DagRequest(executors=executors)
    want = BatchExecutorsRunner(dag, FixtureScanSource(kvs)).handle_request().encode()
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cpu")
    served = ev.zone_stats.served
    got = ev.run(None, pcache).encode()
    assert got == want, "port (zone route) vs the CPU pipeline"
    assert (ev.zone_stats.served == served + 1) == port_zone, ev.zone_stats
    unary = TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cpu")
    unary.route_hint = "unary"
    assert unary.run(None, pcache).encode() == want, "port (unary route) vs the CPU pipeline"
    assert unary.zone_stats.served == 0 and unary._zone is None
    null_keys = fix is NFIX and bool(executors[-1].group_by if isinstance(
        executors[-1], Aggregation) else executors[-2].group_by)
    for hint in (None, "unary"):
        jev = JaxDagEvaluator(dag, block_rows=block_rows)
        jev.route_hint = hint
        same = jev.run(None, cache=jcache).encode() == got
        # the JAX package's coded path serves its unary route, and its
        # default route where its zone rung declines
        coded = hint == "unary" or not jax_zone_served
        assert same != (null_keys and coded), f"JAX route_hint={hint}"
        if hint is None:
            assert _zone_served(jev) == jax_zone_served
    return ev


# ---------------------------------------------------------------------------
# one case for each test of tests/test_jax_zone.py
# ---------------------------------------------------------------------------

def test_zone_grouped_range_predicate():
    ev = check([TableScan(TABLE, FIX[0]), Selection([call("le", col(1), const_int(7000))]),
                Aggregation([col(3)], [AggDescriptor("sum", col(1)), AggDescriptor("avg", col(2)),
                                       AggDescriptor("count", None)])], FIX)
    st = ev.zone_stats
    assert st.full > 0 and st.partial > 0 and st.empty > 0
    assert st.full + st.partial + st.empty == st.examined


def test_zone_ungrouped_multi_conjunct():
    check([TableScan(TABLE, FIX[0]),
           Selection([call("ge", col(1), const_int(2000)), call("lt", col(1), const_int(3000)),
                      call("ge", col(2), const_decimal(500, 2))]),
           Aggregation([], [AggDescriptor("sum", call("multiply", col(2), col(4)))])], FIX)


def test_zone_min_max_and_negative_values():
    check([TableScan(TABLE, FIX[0]), Selection([call("gt", col(1), const_int(1000))]),
           Aggregation([col(3)], [AggDescriptor("min", col(4)), AggDescriptor("max", col(4)),
                                  AggDescriptor("sum", col(4))])], FIX)


def test_zone_nulls_in_group_key_and_values():
    check([TableScan(TABLE, NFIX[0]), Selection([call("le", col(1), const_int(8000))]),
           Aggregation([col(3)], [AggDescriptor("sum", col(1)), AggDescriptor("count", col(1)),
                                  AggDescriptor("avg", col(1)), AggDescriptor("count", None)])],
          NFIX)


def test_zone_unrecognized_conjunct_still_exact():
    ev = check([TableScan(TABLE, FIX[0]),
                Selection([call("lt", col(1), call("plus", col(4), const_int(5000)))]),
                Aggregation([col(3)], [AggDescriptor("count", None)])], FIX,
               port_zone=False, jax_zone_served=False)
    assert ev.zone_stats.last_decline == "unclassifiable_selection"


def test_zone_all_tiles_empty():
    ev = check([TableScan(TABLE, FIX[0]), Selection([call("gt", col(1), const_int(10_000_000))]),
                Aggregation([col(3)], [AggDescriptor("sum", col(1))])], FIX)
    st = ev.zone_stats
    assert st.empty == st.examined > 0 and st.full == st.partial == 0


def test_zone_eq_and_flipped_conjuncts():
    check([TableScan(TABLE, FIX[0]),
           Selection([call("ge", const_int(9000), col(1)),
                      call("ne", col(2), const_decimal(600000, 2))]),
           Aggregation([col(3)], [AggDescriptor("sum", col(4))])], FIX)


def test_zone_post_agg_topn_limit():
    check([TableScan(TABLE, FIX[0]), Selection([call("le", col(1), const_int(9500))]),
           Aggregation([col(3)], [AggDescriptor("sum", col(1))]), TopN([(col(0), True)], 2)], FIX)


def test_zone_no_selection():
    ev = check([TableScan(TABLE, FIX[0]),
                Aggregation([col(3)], [AggDescriptor("sum", col(1)),
                                       AggDescriptor("count", None)])], FIX)
    st = ev.zone_stats
    assert st.empty == 0 and st.full > st.partial  # only the pad tiles are partial


def test_zone_var_pop_served():
    check([TableScan(TABLE, FIX[0]), Selection([call("le", col(1), const_int(7000))]),
           Aggregation([col(3)], [AggDescriptor("var_pop", col(1)),
                                  AggDescriptor("var_pop", col(4)),
                                  AggDescriptor("var_pop", col(2)),
                                  AggDescriptor("var_pop", call("multiply", col(1), col(4))),
                                  AggDescriptor("count", None)])], FIX)


def test_zone_var_pop_with_nulls():
    check([TableScan(TABLE, NFIX[0]), Selection([call("le", col(1), const_int(8000))]),
           Aggregation([col(3)], [AggDescriptor("var_pop", col(1)),
                                  AggDescriptor("count", col(1))])], NFIX)


def test_zone_repeat_and_second_evaluator_share_layout():
    execs = [TableScan(TABLE, FIX[0]), Selection([call("le", col(1), const_int(7000))]),
             Aggregation([col(3)], [AggDescriptor("sum", col(1))])]
    dag = DagRequest(executors=execs)
    want = BatchExecutorsRunner(dag, FixtureScanSource(FIX[1])).handle_request().encode()
    pcache = FIX[3]
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    w1, w2 = ev.run(None, pcache).encode(), ev.run(None, pcache).encode()
    ev2 = TorchDagEvaluator(dag_to_wire(dag), block_rows=512, device="cpu")
    assert w1 == w2 == ev2.run(None, pcache).encode() == want
    assert ev.zone_stats.served == 2 and ev2.zone_stats.served == 1
    for hint in (None, "unary"):
        jev = JaxDagEvaluator(dag, block_rows=2048)
        jev.route_hint = hint
        assert jev.run(None, cache=FIX[2]).encode() == jev.run(None, cache=FIX[2]).encode() == w1
        assert _zone_served(jev) == (hint is None)
    sigs = [s for s in pcache.blocks[0].device if s[:4] == ("zone_layout", (3,), 1, (1,))]
    assert len(sigs) == 1  # one pinned layout served both evaluators



@functools.cache
def _odd_tile_fix():
    return _table(3000, seed=3)


@pytest.mark.parametrize("tile", [61, 150])
def test_zone_tiles_that_are_not_a_multiple_of_the_step(tile, monkeypatch):
    """Tiles whose rows are not a multiple of 4 (nor of the kernels' step,
    ``fz.ROWS`` rows a thread): the rung's layout and classification, and
    the plain versions over the short last rows, against the JAX zone route
    and the CPU pipeline at the same tile size."""
    monkeypatch.setattr(jax_zone, "TILE_ROWS", tile)
    monkeypatch.setattr(zone, "TILE_ROWS", tile)
    fix = _odd_tile_fix()
    ev = check([TableScan(TABLE, fix[0]), Selection([call("le", col(1), const_int(7000)),
                                                     call("ge", col(1), const_int(500))]),
                Aggregation([col(3)], [AggDescriptor("sum", col(1)),
                                       AggDescriptor("var_pop", col(4)),
                                       AggDescriptor("min", col(4)), AggDescriptor("max", col(1)),
                                       AggDescriptor("count", None)])], fix)
    st = ev.zone_stats
    assert st.full > 0 and st.partial > 0 and st.empty > 0
    (layout,) = [e for s, e in fix[3].blocks[0].device.items()
                 if s[0] == "zone_layout" and s[4] == tile]
    assert layout.tile_rows == tile and layout.n_rows == layout.n_tiles * tile

def _fuzz_fixture(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3000, 9000))
    cols = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.decimal_type(2)),
            ColumnInfo(4, FieldType.varchar()),
            ColumnInfo(5, FieldType.varchar()),
            ColumnInfo(6, FieldType.int64())]
    v = rng.integers(-5000, 5000, n)
    d = rng.integers(0, 100000, n)
    tags_a, tags_b = [b"aa", b"bb", b"cc"], [b"xx", b"yy"]
    ta, tb = rng.integers(0, 3, n), rng.integers(0, 2, n)
    w = rng.integers(0, 1 << 30, n)
    null_v = rng.random(n) < float(rng.choice([0.0, 0.05, 0.3]))
    kvs = [(record_key(TABLE, i), encode_row(cols[1:], [
        None if null_v[i] else int(v[i]), int(d[i]), tags_a[ta[i]], tags_b[tb[i]], int(w[i])]))
        for i in range(n)]
    da = np.empty(3, dtype=object)
    da[:] = tags_a
    db = np.empty(2, dtype=object)
    db[:] = tags_b
    B = int(rng.choice([1024, 2048, 4096]))
    handles = np.arange(n, dtype=np.int64)
    cache = JaxCache()
    for s in range(0, n, B):
        e = min(s + B, n)
        z = np.zeros(e - s, dtype=bool)
        cache.add([Column(EvalType.INT, handles[s:e], z.copy()),
                   Column(EvalType.INT, np.where(null_v[s:e], 0, v[s:e]), null_v[s:e].copy()),
                   Column(EvalType.DECIMAL, d[s:e].copy(), z.copy(), 2),
                   Column(EvalType.BYTES, ta[s:e].astype(np.int64), z.copy(), 0, da),
                   Column(EvalType.BYTES, tb[s:e].astype(np.int64), z.copy(), 0, db),
                   Column(EvalType.INT, w[s:e].copy(), z.copy())], e - s)
    cache.filled = True
    return rng, B, (cols, kvs, cache, _port_cache(cache))


@pytest.mark.parametrize("seed", [11, 22, 33, 44, 55, 66])
def test_zone_differential_fuzz(seed):
    """Random plans over random tables: the port's bytes on both routes equal
    the JAX package's on both routes and the CPU pipeline's, whichever rung
    serves; the rung must serve some of them."""
    rng, B, fix = _fuzz_fixture(seed)
    cols, kvs, jcache, pcache = fix
    conj_pool = [
        lambda: call("le", col(1), const_int(int(rng.integers(-4000, 6000)))),
        lambda: call("gt", col(1), const_int(int(rng.integers(-6000, 4000)))),
        lambda: call("ge", col(2), const_decimal(int(rng.integers(0, 90000)), 2)),
        lambda: call("ne", col(1), const_int(int(rng.integers(-5000, 5000)))),
        lambda: call("lt", col(1), call("plus", col(5), const_int(100))),  # unrecognized
    ]
    agg_pool = [
        lambda: AggDescriptor("sum", col(1)),
        lambda: AggDescriptor("count", None),
        lambda: AggDescriptor("avg", col(2)),
        lambda: AggDescriptor("min", col(1)),
        lambda: AggDescriptor("max", col(2)),
        lambda: AggDescriptor("count", col(1)),
        lambda: AggDescriptor("sum", call("multiply", col(2), col(1))),
        lambda: AggDescriptor("var_pop", col(1)),
        lambda: AggDescriptor("sum", call("bit_xor", col(5), call("abs", col(1)))),
        lambda: AggDescriptor("max", call("unary_minus", col(1))),
        # outside the rung's aggregates: the stacked kernels serve
        lambda: AggDescriptor("first", col(1)),
        lambda: AggDescriptor("bit_xor", col(5)),
    ]
    served = 0
    for case in range(6):
        conds = [conj_pool[int(rng.integers(0, len(conj_pool)))]()
                 for _ in range(int(rng.integers(0, 3)))]
        group = [[], [col(3)], [col(3), col(4)]][int(rng.integers(0, 3))]
        aggs = [agg_pool[int(rng.integers(0, len(agg_pool)))]()
                for _ in range(int(rng.integers(1, 4)))]
        execs = [TableScan(TABLE, cols)] + ([Selection(conds)] if conds else []) \
            + [Aggregation(group, aggs)]
        dag = DagRequest(executors=execs)
        want = BatchExecutorsRunner(dag, FixtureScanSource(kvs)).handle_request().encode()
        what = f"seed={seed} case={case} conds={len(conds)} group={len(group)} " \
               f"aggs={[a.op for a in aggs]}"
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=B, device="cpu")
        got = ev.run(None, pcache).encode()
        served += ev.zone_stats.served
        assert got == want, what
        ev.route_hint = "unary"
        assert ev.run(None, pcache).encode() == want, what
        for hint in (None, "unary"):
            jev = JaxDagEvaluator(dag, block_rows=B)
            jev.route_hint = hint
            assert jev.run(None, cache=jcache).encode() == got, f"{what} JAX hint={hint}"
    assert served > 0


def test_zone_kernel_failure_propagates(monkeypatch):
    """A zone kernel's failure raises to the caller (the JAX package
    catches it and serves the generic path, test_jax_zone.py:439); the
    cache is not remembered as declined, so the next query tries again."""
    dag = DagRequest(executors=[TableScan(TABLE, FIX[0]),
                                Selection([call("le", col(1), const_int(7000))]),
                                Aggregation([col(3)], [AggDescriptor("sum", col(1))])])
    calls = {"n": 0}

    def boom(*_args, **_kw):
        calls["n"] += 1
        raise RuntimeError("simulated kernel failure")

    monkeypatch.setattr(zone, "zone_full", boom)
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="simulated kernel failure"):
            ev.run(None, FIX[3])
    assert calls["n"] == 2
    assert ev.zone_stats.served == 0 and ev.zone_stats.last_decline is None


def _layout(pcache, sort_col, needed):
    (layout,) = [e for s, e in pcache.blocks[0].device.items()
                 if s[0] == "zone_layout" and s[2] == sort_col and s[3] == needed]
    return layout


def test_full_tile_program_shared_across_selection_constants():
    """Plans that differ only in selection constants share one full-tile
    program (it holds no selection); their partial-tile programs differ."""
    fix = _table(6000, seed=7)
    fulls, partials = [], []
    for c in (3000, 4000, 5000, 6000):
        ev = check([TableScan(TABLE, fix[0]), Selection([call("le", col(1), const_int(c))]),
                    Aggregation([col(3)], [AggDescriptor("sum", col(1))])], fix)
        full, part = ev._zone.programs(_layout(fix[3], sort_col=1, needed=(1,)))
        fulls.append(full)
        partials.append(part)
    assert all(f is fulls[0] for f in fulls)
    assert list(_layout(fix[3], sort_col=1, needed=(1,)).full_programs.values()) == [fulls[0]]
    assert not any(w & 0xFF == fa.OP_FILTER for w in fulls[0].prog.code)
    assert len({p.prog.consts for p in partials}) == 4


# ---------------------------------------------------------------------------
# declines, one per named cause
# ---------------------------------------------------------------------------

def _declines():
    s = FIX[0]
    le = Selection([call("le", col(1), const_int(7000))])
    real_cols = s[:4] + [ColumnInfo(5, FieldType.double())]
    return {
        "agg_op": [TableScan(TABLE, s), le, Aggregation([col(3)], [AggDescriptor("first", col(1))])],
        "unstable_group_dicts": [TableScan(TABLE, s), le,
                                 Aggregation([col(4)], [AggDescriptor("sum", col(1))])],
        "real_arg": [TableScan(TABLE, real_cols), le,
                     Aggregation([col(3)], [AggDescriptor("sum", col(4))])],
        "non_nullsafe_fn": [TableScan(TABLE, s), le, Aggregation(
            [col(3)], [AggDescriptor("sum", call("is_null", col(1)))])],
        "null_literal": [TableScan(TABLE, s), le, Aggregation(
            [col(3)], [AggDescriptor("sum", call("plus", col(1), const_int(None)))])],
        "unclassifiable_selection": [
            TableScan(TABLE, s), Selection([call("lt", col(1), call("plus", col(4), col(4)))]),
            Aggregation([col(3)], [AggDescriptor("sum", col(1))])],
        # the sort column's conjunct holds on every row, and w is uniform in
        # every tile: every tile is partial
        "partial_fraction": [TableScan(TABLE, s), Selection(
            [call("le", col(1), const_int(20_000)), call("le", col(4), const_int(0))]),
            Aggregation([col(3)], [AggDescriptor("sum", col(1))])],
    }


def test_every_named_cause_has_a_case():
    assert sorted(_declines()) == sorted(zone.DECLINE_CAUSES)


def _real_fix():
    """FIX with w as a REAL column (whole numbers: every sum is exact)."""
    cols, _kvs, jcache, _p = FIX
    real_cols = cols[:4] + [ColumnInfo(5, FieldType.double())]
    jc = JaxCache()
    rows = []
    for b in jcache.blocks:
        c = list(b.cols)
        c[4] = Column(EvalType.REAL, c[4].data.astype(np.float64), c[4].nulls.copy())
        jc.add(c, b.n_valid)
        rows += [[int(c[1].data[r]), int(c[2].data[r]), c[3].dictionary[c[3].data[r]],
                  float(c[4].data[r])] for r in range(b.n_valid)]
    jc.filled = True
    kvs = [(record_key(TABLE, i), encode_row(real_cols[1:], row)) for i, row in enumerate(rows)]
    return real_cols, kvs, jc, _port_cache(jc)


@pytest.mark.parametrize("cause", sorted(_declines()))
def test_decline_names_its_cause_and_the_stacked_kernels_serve(cause):
    execs = _declines()[cause]
    fix = _real_fix() if cause == "real_arg" else FIX
    dag = DagRequest(executors=execs)
    want = BatchExecutorsRunner(dag, FixtureScanSource(fix[1])).handle_request()
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    for _ in range(2):  # the second query declines again, by the same cause
        assert ev.run(None, fix[3]).encode() == want.encode()
    st = ev.zone_stats
    assert st.served == 0 and st.last_decline == cause and st.declines == {cause: 2}


def test_bitwise_op_on_a_real_operand_is_declined_by_name():
    s = FIX[0][:4] + [ColumnInfo(5, FieldType.double())]
    dag = DagRequest(executors=[TableScan(TABLE, s), Aggregation(
        [], [AggDescriptor("sum", call("bit_and", col(1), col(4)))])])
    with pytest.raises(fa.Unsupported) as exc:
        TorchDagEvaluator(dag_to_wire(dag), block_rows=256, device="cpu")
    assert exc.value.cause == "op_not_ported"


# ---------------------------------------------------------------------------
# layout bookkeeping
# ---------------------------------------------------------------------------

def test_layout_pins_count_and_encoded_decodes_are_purged():
    """The pinned layout's tensors count in ``device_nbytes``, the lanes are
    narrowed, and the gathers leave no full decode on an encoded image."""
    cols, kvs, jcache, _p = FIX
    pcache = _port_cache(jcache)
    encoding.encode_blocks(pcache)
    enc_cols = [c for b in pcache.blocks for c in b.cols if isinstance(c, encoding.EncodedColumn)]
    assert enc_cols
    dag = DagRequest(executors=[TableScan(TABLE, cols),
                                Selection([call("le", col(1), const_int(7000))]),
                                Aggregation([col(3)], [AggDescriptor("sum", col(4)),
                                                       AggDescriptor("max", col(2))])])
    want = BatchExecutorsRunner(dag, FixtureScanSource(kvs)).handle_request().encode()
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    assert ev.run(None, pcache).encode() == want
    assert ev.zone_stats.served == 1
    assert all(c._data is None for c in enc_cols)
    (layout,) = [e for s, e in pcache.blocks[0].device.items() if s[0] == "zone_layout"]
    assert {i: str(t.dtype) for i, t in layout.cols.items()} == {
        1: "torch.int16", 2: "torch.int16", 4: "torch.int8"}
    n = layout.n_rows
    assert pcache.device_nbytes() == (2 + 2 + 1) * n + n + 4 * n + 8 * layout.n_tiles
    pcache.drop_device()
    assert pcache.device_nbytes() == 0


def test_group_order_and_first_rows_follow_the_valid_row_index():
    """Every group's tracker is its least valid-row index over active rows,
    as the stacked kernels' tracker."""
    execs = [TableScan(TABLE, NFIX[0]), Selection([call("ge", col(1), const_int(2500))]),
             Aggregation([col(3)], [AggDescriptor("count", None)])]
    dag = DagRequest(executors=execs)
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    packed, prog, n_slots, _key = ev._zone_rung().try_run(NFIX[3])
    unary = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    group_cols, dicts = unary._stable_dict_group_cols(NFIX[3].blocks)
    cprog = unary._coded_program(group_cols, tuple(len(d) for d in dicts))
    img = unary._stacked_device(NFIX[3], unary._ship_cols(group_cols))
    stacked = fused_group_agg(cprog, img, n_slots)
    assert n_slots == 4 and torch.equal(packed[0][0], stacked[0][0])


# ---------------------------------------------------------------------------
# the tile kernels' plain versions against a direct computation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,span", [(np.int8, 200), (np.int16, 3000), (np.int64, 1 << 20)])
def test_cluster_sort_is_numpys_lexsort(dtype, span):
    """The layout's (group, sort key) order: a 16-bit radix pass where the
    spans allow it (narrow keys widened first), numpy's lexsort beyond."""
    rng = np.random.default_rng(span)
    skey = (rng.integers(0, span, 20_000) - span // 2).astype(dtype)
    gid = rng.integers(0, 12, 20_000)
    assert np.array_equal(zone._lexsort([skey, gid]), np.lexsort((skey, gid)))
    assert np.array_equal(zone._lexsort([gid]), np.argsort(gid, kind="stable"))


def test_tile_plain_versions_match_a_direct_computation():
    """zone_full/zone_partial/zone_fold through the evaluator's own layout
    against numpy over the original rows: count, sum, min, max and the sum
    of squares per group, with NULLs, negative values and the new ops."""
    cols, kvs, jcache, pcache = NFIX
    sel = [call("le", col(1), const_int(6000))]
    arg = call("bit_xor", call("unary_minus", col(4)), call("abs", col(1)))
    dag = DagRequest(executors=[TableScan(TABLE, cols), Selection(sel), Aggregation(
        [col(3)], [AggDescriptor("count", col(1)), AggDescriptor("sum", arg),
                   AggDescriptor("min", col(4)), AggDescriptor("max", arg),
                   AggDescriptor("var_pop", col(4))])])
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=2048, device="cpu")
    packed, prog, n_slots, _key = ev._zone_rung().try_run(pcache)
    v = np.concatenate([b.cols[1].data for b in jcache.blocks])
    vn = np.concatenate([b.cols[1].nulls for b in jcache.blocks])
    t = np.concatenate([b.cols[3].data for b in jcache.blocks])
    tn = np.concatenate([b.cols[3].nulls for b in jcache.blocks])
    w = np.concatenate([b.cols[4].data for b in jcache.blocks])
    slot = np.where(tn, 3, t)
    active = ~vn & (v <= 6000)
    a = (-w) ^ np.abs(v)
    ints, flts = (x.numpy() for x in packed)
    for g in range(n_slots):
        m = active & (slot == g)
        want = [m.sum(), m.sum(), a[m].sum(), m.sum(), w[m].min() if m.any() else 2**63 - 1,
                m.sum(), a[m].max() if m.any() else -2**63, m.sum(), w[m].sum()]
        assert list(ints[1:, g]) == want, g
        assert flts[0, g] == float((w[m].astype(np.float64) ** 2).sum())
        assert ints[0, g] == (np.flatnonzero(m)[0] if m.any() else fa.NO_ROW)


def test_fold_and_tile_kernels_refuse_other_devices():
    tp = fz.compile_tile_program([], [("count", None)], [(EvalType.INT, 0)], False, partial=False)
    parts = torch.zeros((0, len(tp.prog.leaves)), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        fz.zone_fold(tp, parts, torch.zeros(0, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), 1)


def test_zone_params_and_leaf_kinds_match_the_cuda_source():
    text = (Path(fz.__file__).resolve().parent.parent / "csrc" / "fused_zone.cu").read_text()
    kinds = {m.group(1): int(m.group(2)) for m in re.finditer(r"ZN_(\w+) = (-?\d+)", text)}
    from tikv_tpu_torch.copr import fused_group_agg as ga
    assert kinds == {"TRACK": ga.LEAF_TRACK, "COUNT": ga.LEAF_COUNT, "SUM": ga.LEAF_SUM,
                     "SUMSQ": ga.LEAF_SUMSQ, "MIN": ga.LEAF_MIN, "MAX": ga.LEAF_MAX,
                     "BARE_WALK": fz.BARE_WALK, "BARE_COUNT": fz.BARE_COUNT}
    body = text[text.index("struct ZnParams {"):]
    body = body[: body.index("};")]
    fields = re.findall(r"(\w+)(?:\[\w+\])?;", body)
    assert fields == [name for name, _t in fz._ZnParams._fields_]
    assert int(re.search(r"#define ZN_THREADS (\d+)", text).group(1)) == fz.THREADS
    assert int(re.search(r"#define ZN_ROWS (\d+)", text).group(1)) == fz.ROWS




def test_zone_bare_fixture_takes_the_instance_with_no_walk():
    """``fixtures.zone_bare_dag`` (the on-card check of the full-tile
    instance with no walk) is served by the rung, its full-tile program all
    bare columns, byte for byte as the unary route answers it."""
    from tikv_tpu_torch import fixtures as pfx
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_wire

    a = pfx.build_arrays(20_000, seed=12)
    cache = pfx.build_cache(20_000, 4096, seed=12, arrays=a)
    ev = TorchDagEvaluator(port_wire(pfx.zone_bare_dag()), block_rows=4096, device="cpu")
    got = ev.run(None, cache).encode()
    assert ev.zone_stats.served == 1 and ev.zone_stats.full > 0
    layout = _layout(cache, 4, (1, 2, 3, 4))
    full, _part = ev._zone_rung().programs(layout)
    assert full.all_bare and fz.tile_slots(full) == 0
    unary = TorchDagEvaluator(port_wire(pfx.zone_bare_dag()), block_rows=4096, device="cpu")
    unary.route_hint = "unary"
    assert unary.run(None, cache).encode() == got

def _chain(depth: int):
    """An int expression the walk holds ``depth`` operands deep: -c0 at
    depth 1, else c0 + (c1 + (c0 + ...)) over ``depth`` columns."""
    from tikv_tpu_torch.copr import rpn as prpn
    if depth == 1:
        return prpn.call("unary_minus", prpn.col(0))
    e = prpn.col((depth - 1) % 2)
    for i in range(depth - 2, -1, -1):
        e = prpn.call("plus", prpn.col(i % 2), e)
    return e


@pytest.mark.parametrize("depth,slots", [(1, 2), (3, 4), (6, 8)])
def test_tile_instance_follows_the_stack_slots(depth, slots):
    """The launcher runs the walk instance ``fa.stack_slots`` picks for the
    program's code, full or partial; a full-tile program of bare columns
    runs the one with no walk (0), its partial program the walk."""
    from tikv_tpu_torch.copr import rpn as prpn
    schema = [(EvalType.INT, 0), (EvalType.INT, 0)]
    expr = prpn.compile_expr(_chain(depth), schema)
    for partial in (False, True):
        tp = fz.compile_tile_program([], [("sum", expr), ("count", None)], schema, True,
                                     partial=partial)
        assert fa.stack_depth(tp.prog.code) == depth
        assert fz.tile_slots(tp) == fa.stack_slots([tp.prog.code]) == slots
        assert (partial, slots) in fz.TILE_INSTANCES
    bare = [("sum", prpn.compile_expr(prpn.col(1), schema)), ("count", None)]
    full = fz.compile_tile_program([], bare, schema, True, partial=False)
    part = fz.compile_tile_program([], bare, schema, True, partial=True)
    assert full.all_bare and fz.tile_slots(full) == 0 and (False, 0) in fz.TILE_INSTANCES
    assert fz.tile_slots(part) == 2


def test_tile_instance_refuses_a_plan_deeper_than_the_walk():
    """A program deeper than ``fa.MAX_STACK`` operands (the emitter refuses
    one; here its code is made by hand) is refused by the kernel's name."""
    from tikv_tpu_torch.copr import rpn as prpn
    schema = [(EvalType.INT, 0), (EvalType.INT, 0)]
    tp = fz.compile_tile_program([], [("sum", prpn.compile_expr(_chain(6), schema))], schema,
                                 True, partial=True)
    deep = (fa.OP_COL,) * (fa.MAX_STACK + 1) + tp.prog.code
    tp = dataclasses.replace(tp, prog=dataclasses.replace(tp.prog, code=deep))
    with pytest.raises(ValueError, match=f"zone_partial: a plan {fa.MAX_STACK + 7} operands"):
        fz.tile_slots(tp)

# ---------------------------------------------------------------------------
# the seven null-safe scalar functions against the JAX package's kernels
# ---------------------------------------------------------------------------

NEW_OPS = ("unary_minus", "abs", "bit_and", "bit_or", "bit_xor", "bit_neg", "is_not_null")


def _operand(rng, n, real):
    if real:
        d = rng.normal(0, 1e3, n)
        d[:4] = [-0.0, 0.0, np.inf, -np.inf]
    else:
        d = rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64) * rng.integers(-2, 3, n)
        d[:4] = [-(1 << 63), (1 << 63) - 1, 0, -1]
    return d, rng.random(n) < 0.2


@pytest.mark.parametrize("op,real", [(op, False) for op in NEW_OPS]
                         + [(op, True) for op in NEW_OPS if not op.startswith("bit_")])
def test_new_ops_match_the_reference_kernels(op, real):
    rng = np.random.default_rng(NEW_OPS.index(op))
    arity, rkind, fn = KERNELS[op]
    jarity, jrkind, jfn = jkernels.KERNELS[op]
    assert (arity, rkind) == (jarity, jrkind)
    args = [_operand(rng, 512, real) for _ in range(arity)]
    wd, wn = jfn(np, *args)
    gd, gn = fn(*[(torch.from_numpy(d.copy()), torch.from_numpy(nl.copy())) for d, nl in args])
    assert np.array_equal(gn.numpy(), wn)
    if real and op != "is_not_null":
        assert np.array_equal(gd.numpy().view(np.int64), np.asarray(wd).view(np.int64))
    else:
        assert np.array_equal(gd.numpy(), np.asarray(wd))


def test_new_ops_in_the_walk_match_the_scalar_kernels():
    """The new opcodes in the tile programs (arguments on full tiles, the
    selection and arguments on partial ones) and, where an unrecognised
    conjunct holds one, in the stacked kernels: against JAX and the CPU
    pipeline on both routes."""
    args = [AggDescriptor("sum", call("bit_or", col(4), const_int(3))),
            AggDescriptor("min", call("bit_neg", col(4))),
            AggDescriptor("sum", call("abs", col(4))),
            AggDescriptor("max", call("unary_minus", col(2))),
            AggDescriptor("count", call("is_not_null", col(1)))]
    check([TableScan(TABLE, FIX[0]), Selection([call("le", col(1), const_int(9000))]),
           Aggregation([col(3)], args)], FIX)
    check([TableScan(TABLE, NFIX[0]), Selection([call("ge", col(1), const_int(100))]),
           Aggregation([], [AggDescriptor("sum", call("bit_xor", col(1), col(4))),
                            AggDescriptor("min", call("abs", col(4)))])], NFIX)
    ev = check([TableScan(TABLE, NFIX[0]),
                Selection([call("is_not_null", col(1)),
                           call("gt", call("bit_and", col(1), const_int(0xFF)), const_int(10))]),
                Aggregation([col(3)], args)], NFIX, port_zone=False, jax_zone_served=False)
    assert ev.zone_stats.last_decline == "unclassifiable_selection"
