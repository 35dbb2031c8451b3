"""Batched warm aggregation and the cold fill: the port against the JAX package.

The port's ``run_batch_cached`` (K plans over one image, program #10) and
``run_xregion_cached`` / ``launch_xregion_cached`` (one plan over R images,
#11) are held, response for response and byte for byte, to the JAX
package's functions of the same names (``JAX_PLATFORMS=cpu``, over a JAX
cache holding the same blocks) and to the CPU pipeline over the same KV
bytes, on the CPU through the plain versions of the batch kernels.  Where
the reference's warm coded ids drop NULL group keys (ROADMAP queue 3 C),
the port is held to the CPU pipeline and the JAX answer to differ.  The
first tests repair the cold fill: a cold run that raises mid-scan leaves
the cache as it was, and a filled cache with no blocks answers as the JAX
package does.  Draws come from ``np.random.default_rng``; blocks of 64 to
512 rows; no tolerance (no plan sums a REAL column).
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import bench
from tikv_tpu.copr import jax_eval, jax_zone
from tikv_tpu.copr import encoding as jenc
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
from tikv_tpu.copr.dag_wire import dag_from_wire as jax_from_wire
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import Column as JaxColumn
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.datatypes import EvalType as JaxEvalType
from tikv_tpu.copr.executors import CachedBlocksExecutor
from tikv_tpu.copr.executors import FixtureScanSource as JaxSource
from tikv_tpu.copr.jax_eval import JaxDagEvaluator
from tikv_tpu.copr.rpn import call, col, const_int
from tikv_tpu.copr.table import encode_row, record_key
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import encoding, fused_batch, torch_eval, zone, zone_maps
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_wire
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.torch_eval import (
    TorchDagEvaluator,
    launch_xregion_cached,
    run_batch_cached,
    run_xregion_cached,
    xregion_specs,
)

BR = 256
TILE = 64


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """Small zone tiles in both packages: a few blocks make many tiles."""
    monkeypatch.setattr(jax_zone, "TILE_ROWS", TILE)
    monkeypatch.setattr(zone, "TILE_ROWS", TILE)


# ---------------------------------------------------------------------------
# regions: KV bytes for the CPU pipeline, one image for each package
# ---------------------------------------------------------------------------

def _schema(nullable: bool):
    """lineitem's columns; NOT NULL as TPC-H declares them, or nullable."""
    if not nullable:
        return bench._lineitem()
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.decimal_type(2)), ColumnInfo(4, FieldType.decimal_type(2)),
            ColumnInfo(5, FieldType.int64()), ColumnInfo(6, FieldType.varchar()),
            ColumnInfo(7, FieldType.varchar())]


class Region:
    """One region of lineitem rows: its draws, KV bytes and both images."""

    def __init__(self, n_blocks, seed, flags=b"ANR", null_p=0.0, sort=False, block_rows=BR,
                 stable=True):
        n = n_blocks * block_rows
        self.block_rows = block_rows
        a = fx.build_arrays(n, seed)
        a["rf"] = a["rf"] % len(flags)
        if sort:
            a = fx.sort_by_shipdate(a)
        rng = np.random.default_rng(seed + 100)
        holes = {c: rng.random(n) < null_p for c in ("qty", "price", "rf")}
        self.nullable = null_p > 0
        schema = _schema(self.nullable)
        kvs = []
        for r in range(n):
            vals = [int(a["qty"][r]), int(a["price"][r]), int(a["disc"][r]), int(a["ship"][r]),
                    flags[a["rf"][r] : a["rf"][r] + 1], b"FO"[a["ls"][r] : a["ls"][r] + 1]]
            for j, c in ((0, "qty"), (1, "price"), (4, "rf")):
                if holes[c][r]:
                    vals[j] = None
            kvs.append((record_key(fx.TABLE_ID, r), encode_row(schema[1:], vals)))
        self.kvs = kvs
        self.arrays = a
        dicts = {5: np.array([flags[i : i + 1] for i in range(len(flags))], dtype=object),
                 6: np.array([b"F", b"O"], dtype=object)}
        blocks = []
        for s in range(0, n, block_rows):
            e = min(s + block_rows, n)
            z = np.zeros(e - s, dtype=bool)
            # an unstable image: each block its own copy of the dictionaries
            d = dicts if stable else {k: v.copy() for k, v in dicts.items()}
            cols = [("int", np.arange(s, e), z, 0, None)]
            for c, key, frac in (("qty", 1, 0), ("price", 2, 2), ("disc", 3, 2), ("ship", 4, 0),
                                 ("rf", 5, 0), ("ls", 6, 0)):
                nl = holes.get(c, np.zeros(n, dtype=bool))[s:e].copy()
                data = np.where(nl, 0, a[c][s:e]).astype(np.int64)
                et = (fx.EvalType.BYTES if key >= 5 else
                      fx.EvalType.DECIMAL if frac else fx.EvalType.INT)
                cols.append((et.value, data, nl, frac, d.get(key)))
            blocks.append((cols, e - s))
        self.blocks = blocks
        self.pcache = ColumnBlockCache.from_numpy_blocks(blocks)
        self.jcache = JaxCache()
        for cols, nv in blocks:
            self.jcache.add([JaxColumn(JaxEvalType(et), d.copy(), nl.copy(), frac, dic)
                             for et, d, nl, frac, dic in cols], nv)
        self.jcache.filled = True

    def encode(self):
        encoding.encode_blocks(self.pcache, None)
        jenc.encode_blocks(self.jcache, None)
        return self

    def cpu(self, dag) -> bytes:
        return BatchExecutorsRunner(dag, JaxSource(self.kvs)).handle_request().encode()


def _jax_dag(port_dag) -> DagRequest:
    return jax_from_wire(port_wire(port_dag))


def _with_scan(dag: DagRequest, schema) -> DagRequest:
    """``dag`` over the scan columns ``schema``."""
    ex = list(dag.executors)
    ex[0] = TableScan(ex[0].table_id, schema)
    return DagRequest(executors=ex)


def _riders(names, nullable=False):
    """(name, JAX DagRequest, numpy oracle) of the fixture's riders."""
    out = []
    for name, dag, oracle in fx.batch_plans():
        if name in names:
            jdag = _jax_dag(dag)
            if nullable:
                jdag = _with_scan(jdag, _schema(True)[: len(jdag.executors[0].columns_info)])
            out.append((name, jdag, oracle))
    return out


def _port_evs(dags, block_rows=BR):
    return [TorchDagEvaluator(dag_to_wire(d), block_rows=block_rows, device="cpu") for d in dags]


def _jax_evs(dags, block_rows=BR):
    return [JaxDagEvaluator(d, block_rows=block_rows) for d in dags]


ALL = [name for name, _d, _o in fx.batch_plans()]
ZONE_OK = [n for n in ALL if n != "bit_xor_by_linestatus"]


# ---------------------------------------------------------------------------
# A1: a cold run that raises mid-scan leaves the cache as it was
# ---------------------------------------------------------------------------

def _varchar_table(n=1579, null_from=600):
    """id, v int, tag varchar with NULLs only from row ``null_from`` on: the
    first block's tags decode to dictionary codes, a later block's do not."""
    schema = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, FieldType.int64()),
              ColumnInfo(3, FieldType.varchar())]
    rng = np.random.default_rng(11)
    v = rng.integers(0, 1000, n)
    kvs = [(record_key(9, i), encode_row(schema[1:], [
        int(v[i]), None if i >= null_from and i % 7 == 0 else [b"x", b"y", b"z"][i % 3]]))
        for i in range(n)]
    return schema, kvs


def _count_dag(schema):
    return DagRequest(executors=[TableScan(9, schema), Aggregation([], [
        AggDescriptor("count", None), AggDescriptor("sum", col(1))])])


def test_a_raising_cold_topn_leaves_the_cache_unfilled():
    """A raw TopN whose BYTES payload stops being dictionary-coded raises
    in its second block; the port's cache stays empty (it used to keep the
    first block, and a warm count(*) then answered 2,091), so cold and warm
    count(*) afterwards answer 1,579, as JAX's."""
    schema, kvs = _varchar_table()
    topn = DagRequest(executors=[TableScan(9, schema), TopN([(col(1), False)], 5)])
    count = _count_dag(schema)
    cache, jcache = ColumnBlockCache(), JaxCache()
    with pytest.raises(ValueError, match="not dict-coded"):
        TorchDagEvaluator(dag_to_wire(topn), block_rows=512, device="cpu").run(
            FixtureScanSource(kvs), cache)
    with pytest.raises(ValueError, match="not dict-coded"):
        JaxDagEvaluator(topn, block_rows=512).run(JaxSource(kvs), cache=jcache)
    assert cache.blocks == [] and not cache.filled
    want = BatchExecutorsRunner(count, JaxSource(kvs)).handle_request().encode()
    ev = TorchDagEvaluator(dag_to_wire(count), block_rows=512, device="cpu")
    jev = JaxDagEvaluator(count, block_rows=512)
    cold = ev.run(FixtureScanSource(kvs), cache)
    assert cache.filled and cache.total_rows == 1579
    warm = ev.run(None, cache)
    assert cold.iter_rows()[0][0] == warm.iter_rows()[0][0] == 1579
    for got in (cold, warm):
        assert got.encode() == want == jev.run(JaxSource(kvs), cache=jcache).encode()


def test_a_cold_group_by_past_its_capacity_leaves_the_cache_unfilled():
    """A raw TopN whose BYTES payload stops being dictionary-coded raises
    mid-scan and leaves the cache unfilled; a REAL sum and var_pop whose
    groups then outgrow the shared-memory slots (a name kept from when the
    port declined them, ``real_group_capacity_not_ported``) are served by
    the wide route cold, fill the cache whole and answer warm as the CPU
    pipeline and the JAX evaluator do (REAL values to rel 1e-12)."""
    schema = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, FieldType.int64()),
              ColumnInfo(3, FieldType.double()), ColumnInfo(4, FieldType.varchar())]
    rng = np.random.default_rng(12)
    n = 3000
    kvs = [(record_key(9, i), encode_row(schema[1:], [
        i % 1500, float(rng.random()), None if i >= 600 and i % 7 == 0 else b"xyz"[i % 3:][:1]]))
        for i in range(n)]
    topn = DagRequest(executors=[TableScan(9, schema), TopN([(col(1), False)], 5)])
    cache = ColumnBlockCache()
    with pytest.raises(ValueError, match="not dict-coded"):
        TorchDagEvaluator(dag_to_wire(topn), block_rows=256, device="cpu").run(
            FixtureScanSource(kvs), cache)
    assert cache.blocks == [] and not cache.filled
    grouped = DagRequest(executors=[TableScan(9, schema), Aggregation(
        [col(1)], [AggDescriptor("sum", col(2)), AggDescriptor("var_pop", col(2))])])
    ev = TorchDagEvaluator(dag_to_wire(grouped), block_rows=256, device="cpu")
    want = BatchExecutorsRunner(grouped, JaxSource(kvs)).handle_request()
    jwant = JaxDagEvaluator(grouped, block_rows=256).run(JaxSource(kvs))
    cold = ev.run(FixtureScanSource(kvs), cache)
    assert cache.filled and cache.total_rows == n
    warm = ev.run(None, cache)
    assert len(want.iter_rows()) == 1500 > ev.plan.group_program.c_max
    for got in (cold, warm):
        for other in (want, jwant):
            for g_row, w_row in zip(got.iter_rows(), other.iter_rows(), strict=True):
                assert g_row == pytest.approx(w_row, rel=1e-12, abs=0)


def test_an_early_close_stops_the_worker_and_fills_nothing():
    """A consumer that stops early (a Limit met) closes the block generator:
    the prefetch worker ends, and the cache is neither filled nor added to."""
    schema, kvs = _varchar_table(null_from=10**9)
    ev = TorchDagEvaluator(dag_to_wire(_count_dag(schema)), block_rows=128, device="cpu")
    cache = ColumnBlockCache()
    gen = ev._cold_blocks(FixtureScanSource(kvs), cache)
    next(gen)
    next(gen)
    gen.close()
    assert cache.blocks == [] and not cache.filled
    deadline = time.monotonic() + 10
    while any(t.name == "decode-prefetch" for t in threading.enumerate()):
        assert time.monotonic() < deadline, "the prefetch worker did not stop"
        time.sleep(0.05)


# ---------------------------------------------------------------------------
# A2: a filled cache with no blocks answers as the JAX package does
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["aggregation", "grouped", "scan", "topn"])
def test_a_filled_empty_cache_answers_like_jax(kind):
    schema = _schema(False)
    scan = TableScan(fx.TABLE_ID, schema)
    sel = Selection([call("le", col(4), const_int(10500))])
    dag = DagRequest(executors={
        "aggregation": [scan, sel, Aggregation([], [AggDescriptor("count", None),
                                                    AggDescriptor("sum", col(1))])],
        "grouped": [scan, Aggregation([col(5)], [AggDescriptor("count", None)])],
        "scan": [scan, sel],
        "topn": [scan, sel, TopN([(col(2), True)], 10)],
    }[kind])
    want = BatchExecutorsRunner(dag, JaxSource([])).handle_request().encode()
    cache, jcache = ColumnBlockCache(), JaxCache()
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=BR, device="cpu")
    jev = JaxDagEvaluator(dag, block_rows=BR)
    assert ev.run(FixtureScanSource([]), cache).encode() == want
    assert jev.run(JaxSource([]), cache=jcache).encode() == want
    assert cache.filled and cache.blocks == []
    # the filled empty cache: no source is read
    got = ev.run(None, cache).encode()
    assert got == want == jev.run(None, cache=jcache).encode()


# ---------------------------------------------------------------------------
# program #10: K plans over one image
# ---------------------------------------------------------------------------

def _check_batch(region, riders, served_by_zone: bool, jax_differs=()):
    """The port's batch against JAX's batch, the CPU pipeline, each rider
    served alone by the port, and (plain draws) the numpy oracles."""
    dags = [d for _n, d, _o in riders]
    br = region.block_rows
    evs = _port_evs(dags, br)
    served = [ev.zone_stats.served for ev in evs]
    got = run_batch_cached(evs, region.pcache)
    jgot = jax_eval.run_batch_cached(_jax_evs(dags, br), region.jcache)
    for (name, dag, oracle), ev, before, resp, jresp in zip(riders, evs, served, got, jgot):
        want = region.cpu(dag)
        assert resp.encode() == want, name
        assert (jresp.encode() == want) != (name in jax_differs), f"JAX {name}"
        assert ev.zone_stats.served == before + served_by_zone, name
        alone = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cpu")
        alone.route_hint = "unary"
        assert alone.run(None, region.pcache).encode() == want, name
        if oracle is not None and not region.nullable:
            assert resp.iter_rows() == oracle(region.arrays), name
    return evs


def test_riders_with_different_column_sets_on_the_batch_kernels():
    """All eight riders; bit_xor declines the zone rung (``agg_op``), so
    every rider runs on the batch kernels, each compiled against the shared
    ship list: the two-column Q6 variant's columns sit at other slots there."""
    evs = _check_batch(Region(5, 1), _riders(ALL), served_by_zone=False)
    assert evs[-1].zone_stats.declines.get("agg_op") == 1


def test_every_rider_zone_eligible_rides_the_zone_rung():
    """Blocks of 2,048 rows: each group's run fills whole 64-row tiles."""
    _check_batch(Region(2, 2, block_rows=2048), _riders(ZONE_OK), served_by_zone=True)


def test_a_late_zone_decline_sends_the_whole_batch_to_the_kernels():
    """Every rider passes the probe, but the last declines once planned (no
    conjunct classifies a tile: ``unclassifiable_selection``); no rider is
    served by the rung, and no zone kernel ran for the others."""
    region = Region(2, 3, block_rows=2048)
    riders = _riders(["q1", "q6"])
    sums = DagRequest(executors=[
        TableScan(fx.TABLE_ID, _schema(False)),
        Selection([call("lt", call("plus", col(1), col(4)), const_int(9100))]),
        Aggregation([], [AggDescriptor("count", None)])])
    riders.append(("sum_of_columns", sums, None))
    evs = _port_evs([d for _n, d, _o in riders], 2048)
    got = run_batch_cached(evs, region.pcache)
    assert evs[-1].zone_stats.last_decline == "unclassifiable_selection"
    assert [ev.zone_stats.examined > 0 for ev in evs] == [True, True, False]
    assert [ev.zone_stats.served for ev in evs] == [0, 0, 0]
    for (name, dag, _o), resp in zip(riders, got):
        assert resp.encode() == region.cpu(dag), name


def test_a_nullable_column_read_only_by_the_second_rider():
    """The port of ``tests/test_jax_eval.py::test_batch_respects_other_
    evaluators_null_masks``: the first rider reads a NOT NULL-looking
    column, the second one a column with NULLs; its mask must ship."""
    cols = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.int64())]
    kvs = [(record_key(7, i), encode_row(cols[1:], [None if i % 3 == 0 else i, i]))
           for i in range(300)]
    dag_a = DagRequest(executors=[TableScan(7, cols), Aggregation([], [
        AggDescriptor("sum", col(2))])])
    dag_b = DagRequest(executors=[TableScan(7, cols), Aggregation([], [
        AggDescriptor("count", col(1)), AggDescriptor("sum", col(1))])])
    ev_a, ev_b = (TorchDagEvaluator(dag_to_wire(d), block_rows=64, device="cpu")
                  for d in (dag_a, dag_b))
    cache = ColumnBlockCache()
    ev_a.run(FixtureScanSource(kvs), cache)
    jev_a, jev_b = JaxDagEvaluator(dag_a, block_rows=64), JaxDagEvaluator(dag_b, block_rows=64)
    jcache = JaxCache()
    jev_a.run(JaxSource(kvs), cache=jcache)
    ra, rb = run_batch_cached([ev_a, ev_b], cache)
    ja, jb = jax_eval.run_batch_cached([jev_a, jev_b], jcache)
    for dag, got, jgot in ((dag_a, ra, ja), (dag_b, rb, jb)):
        want = BatchExecutorsRunner(dag, JaxSource(kvs)).handle_request().encode()
        assert got.encode() == want == jgot.encode()


def test_zone_pruned_blocks_keep_the_union_of_the_riders():
    """Date-sorted blocks: a block is masked only when every rider's zone
    maps prune it, and the answers do not change."""
    region = Region(8, 4, sort=True)
    riders = _riders(["q6", "q6_price", "q1_ship_9500"])
    # bit_xor keeps the batch off the zone rung; its selection prunes too
    xor = _riders(["bit_xor_by_linestatus"])[0][1]
    xor.executors[1] = Selection([call("le", col(4), const_int(fx.BATCH_SHIP_HI))])
    riders.append(("bit_xor_ship_9500", xor, None))
    evs = _check_batch(region, riders, served_by_zone=False)
    keeps = [zone_maps.prune_blocks(region.pcache, ev.plan.sel_rpns) for ev in evs]
    union = zone_maps.batch_prune_keep(keeps)
    assert union is not None and all(k is not None for k in keeps)
    assert evs[0].prune_stats == (8, int((~union).sum())) and (~union).sum() > 0
    assert ((~union) == np.logical_and.reduce([~k for k in keeps])).all()


def test_null_group_keys_match_the_cpu_pipeline():
    """NULLs in l_returnflag: the port ships the key's null mask and matches
    the CPU pipeline; the JAX batch groups the NULL keys wrongly."""
    riders = _riders(["q1", "group_by_returnflag", "bit_xor_by_linestatus"], nullable=True)
    _check_batch(Region(4, 5, null_p=0.1), riders, served_by_zone=False,
                 jax_differs=("q1", "group_by_returnflag"))


def test_every_leaf_kind_in_a_batch():
    """var_pop (its f64 sum of squares), first, bit_and, bit_or, min and
    max beside Q1: integers squared sum exactly in f64, so bytes equal."""
    mixed = _jax_dag(fx.mixed_dag())
    riders = _riders(["q1", "bit_xor_by_linestatus"]) + [("mixed", mixed, None)]
    _check_batch(Region(3, 9), riders, served_by_zone=False)
    _check_xregion([Region(2, 29), Region(1, 30, flags=b"AN")], mixed)


def test_an_encoded_image_batches_like_the_plain_one():
    region = Region(5, 6).encode()
    before = encoding.PATH_COUNTS.get(("fused", "encoded"), 0)
    _check_batch(region, _riders(ALL), served_by_zone=False)
    assert encoding.PATH_COUNTS[("fused", "encoded")] == before + 1


def test_batch_declines_raise_like_the_reference():
    region = Region(2, 7)
    agg = _riders(["q1"])[0][1]
    scan = DagRequest(executors=[TableScan(fx.TABLE_ID, _schema(False)),
                                 Selection([call("le", col(4), const_int(9000))])])
    for fn, evs, cache in ((run_batch_cached, _port_evs([agg, scan]), region.pcache),
                           (jax_eval.run_batch_cached, _jax_evs([agg, scan]), region.jcache)):
        with pytest.raises(ValueError, match="requires aggregation DAGs"):
            fn(evs, cache)
    unstable = Region(2, 8, stable=False)
    for fn, evs, cache in ((run_batch_cached, _port_evs([agg]), unstable.pcache),
                           (jax_eval.run_batch_cached, _jax_evs([agg]), unstable.jcache)):
        with pytest.raises(ValueError, match="stable dict group keys"):
            fn(evs, cache)
    empty = ColumnBlockCache()
    empty.filled = True
    with pytest.raises(ValueError, match="empty block cache"):
        run_batch_cached(_port_evs([agg]), empty)
    # a port limit: the union of the riders' columns is one plan's program
    wide = DagRequest(executors=[TableScan(fx.TABLE_ID, _schema(False)), Aggregation(
        [col(5), col(6), col(5), col(6), col(5)], [AggDescriptor("count", None)])])
    with pytest.raises(ValueError, match="plan_too_large"):
        run_batch_cached(_port_evs([wide, _riders(["bit_xor_by_linestatus"])[0][1]]),
                         region.pcache)


# ---------------------------------------------------------------------------
# program #11: one plan over R images
# ---------------------------------------------------------------------------

def _check_xregion(regions, name_or_dag, jax_differs=False):
    if isinstance(name_or_dag, str):
        _n, dag, oracle = _riders([name_or_dag], nullable=regions[0].nullable)[0]
    else:
        dag, oracle = name_or_dag, None
    ev = _port_evs([dag])[0]
    got = run_xregion_cached(ev, [r.pcache for r in regions])
    jgot = jax_eval.run_xregion_cached(JaxDagEvaluator(dag, block_rows=BR),
                                       [r.jcache for r in regions])
    for region, resp, jresp in zip(regions, got, jgot):
        want = region.cpu(dag)
        assert resp.encode() == want
        assert (jresp.encode() == want) != jax_differs
        if oracle is not None and not region.nullable:
            assert resp.iter_rows() == oracle(region.arrays)
    return ev


@pytest.mark.parametrize("name", ["q1", "q6", "q6_count_sum_min_max", "group_by_returnflag",
                                  "bit_xor_by_linestatus", "q1_topn"])
def test_xregion_unequal_regions_in_shuffled_order(name):
    """Regions of 3, 1, 5 and 2 blocks, one with a returnflag dictionary of
    two; they run largest first and come back in the caller's order."""
    _check_xregion(_shuffled_regions(), name)


@functools.lru_cache(maxsize=1)
def _shuffled_regions():
    return [Region(3, 10), Region(1, 11, flags=b"AN"), Region(5, 12), Region(2, 13)]


def test_xregion_specs_share_one_capacity_and_keep_each_radix():
    regions = [Region(2, 14), Region(1, 15, flags=b"AN")]
    ev = _port_evs([_riders(["q1"])[0][1]])[0]
    specs, group_cols, capacity = xregion_specs(ev, [r.pcache for r in regions])
    assert group_cols == [5, 6] and capacity == 16
    assert [(s[1], s[2]) for s in specs] == [((3, 2), 12), ((2, 2), 9)]


def test_xregion_over_encoded_regions():
    regions = [Region(3, 16).encode(), Region(2, 17, flags=b"AN").encode(),
               Region(4, 18, sort=True).encode()]
    before = encoding.PATH_COUNTS.get(("xregion", "encoded"), 0)
    for name in ("q1", "q6"):
        _check_xregion(regions, name)
    assert encoding.PATH_COUNTS[("xregion", "encoded")] == before + 2
    pending = launch_xregion_cached(_port_evs([_riders(["q6"])[0][1]])[0],
                                    [r.pcache for r in regions])
    assert pending.encoded
    # the date-sorted region's zone maps prune Q6's blocks, region by region
    assert pending.prunes[0][1] == 0 and pending.prunes[2][1] > 0
    pending.finalize()


def test_xregion_enc_mismatch_ships_decoded_lanes():
    """One region left plain among encoded ones: the batch ships decoded
    lanes, the decline counted, the bytes the same."""
    regions = [Region(3, 19).encode(), Region(2, 20), Region(2, 21).encode()]
    before = encoding.DECLINE_COUNTS.get(("xregion", "enc_mismatch"), 0)
    _check_xregion(regions, "q1")
    assert encoding.DECLINE_COUNTS[("xregion", "enc_mismatch")] == before + 1
    pending = launch_xregion_cached(_port_evs([_riders(["q1"])[0][1]])[0],
                                    [r.pcache for r in regions])
    assert not pending.encoded
    assert encoding.PATH_COUNTS[("xregion", "decoded_ship")] >= 2
    enc_cols = [c for b in regions[0].pcache.blocks for c in b.cols
                if isinstance(c, encoding.EncodedColumn)]
    assert enc_cols and all(c._data is None for c in enc_cols), "decodes left on the host"


def test_xregion_null_group_keys_match_the_cpu_pipeline():
    regions = [Region(2, 22, null_p=0.1), Region(3, 23, null_p=0.1)]
    _check_xregion(regions, "q1", jax_differs=True)


def test_xregion_declines_raise_like_the_reference():
    q1 = _riders(["q1"])[0][1]
    scan = DagRequest(executors=[TableScan(fx.TABLE_ID, _schema(False)),
                                 Selection([call("le", col(4), const_int(9000))])])
    good, unstable = Region(1, 24), Region(2, 25, stable=False)
    empty, jempty = ColumnBlockCache(), JaxCache()
    empty.filled = jempty.filled = True
    cases = ((scan, [good], "requires aggregation DAGs"), (q1, [], "at least one region"),
             (q1, [good, "empty"], "empty block cache"),
             (q1, [good, unstable], "stable dict group keys"))
    for dag, regions, msg in cases:
        with pytest.raises(ValueError, match=msg):
            run_xregion_cached(_port_evs([dag])[0],
                               [empty if r == "empty" else r.pcache for r in regions])
        with pytest.raises(ValueError, match=msg):
            jax_eval.run_xregion_cached(JaxDagEvaluator(dag, block_rows=BR),
                                        [jempty if r == "empty" else r.jcache for r in regions])


# ---------------------------------------------------------------------------
# riders past their shared-memory rows: the wide route inside the batch
# ---------------------------------------------------------------------------

class SuppRegion:
    """A region of the supplier table (``fx.supp_cache``: lineitem and
    l_suppkey, the DOUBLE price, l_shipmode, l_shipinstruct): its draws and
    both packages' images of the same blocks."""

    def __init__(self, n_blocks, seed, block_rows=BR):
        self.block_rows = block_rows
        self.arrays = fx.supp_arrays(n_blocks * block_rows, seed)
        self.pcache = fx.supp_cache(n_blocks * block_rows, block_rows, seed, arrays=self.arrays)
        self.jcache = JaxCache()
        for b in self.pcache.blocks:
            self.jcache.add([JaxColumn(JaxEvalType(c.eval_type.value), np.asarray(c.data),
                                       np.asarray(c.nulls), c.frac, c.dictionary)
                             for c in b.cols], b.n_valid)
        self.jcache.filled = True

    def cpu(self, dag):
        return BatchExecutorsRunner(dag, None, leaf=CachedBlocksExecutor(
            self.jcache, dag.executors[0].columns_info)).handle_request()


def _close(got, want, what):
    """Responses equal: bytes where no value is a float, else row by row
    with REAL values to rel 1e-12."""
    if got.encode() == want.encode():
        return
    for g_row, w_row in zip(got.iter_rows(), want.iter_rows(), strict=True):
        assert g_row == pytest.approx(w_row, rel=1e-12, abs=0), what


WIDE_RIDERS = {"int": lambda: _jax_dag(fx.flags4_dag()),
               "f64": lambda: _jax_dag(fx.flags4_dag(var_pop=True))}


@pytest.mark.parametrize("kind", sorted(WIDE_RIDERS))
def test_a_batch_rider_past_its_slots_rides_the_wide_route(kind):
    """Q1 grouped by TPC-H's four flag columns (480 coded slots, past a
    task's shared-memory rows), integer leaves or with f64 leaves (var_pop,
    a REAL sum), beside three riders on the batch kernels: the batch's
    responses equal the same requests one by one, the JAX package's
    ``run_batch_cached``, the CPU pipeline and the oracles."""
    from tikv_tpu_torch.copr import fused_agg as fa

    region = SuppRegion(4, 31)
    rider = WIDE_RIDERS[kind]()
    others = _riders(["q1", "q6", "bit_xor_by_linestatus"])
    dags = [rider] + [d for _n, d, _o in others]
    evs = _port_evs(dags)
    tasks, _specs, _pruned = torch_eval.batch_tasks(evs, region.pcache)
    assert fused_batch.Batch(tasks).wide == [0]
    fa.reset_launches()
    got = run_batch_cached(evs, region.pcache)
    assert fa.LAUNCHES["group_wide_partials"] == 0  # the plain versions here
    jgot = jax_eval.run_batch_cached(_jax_evs(dags), region.jcache)
    oracles = [lambda a: fx.flags4_oracle(a, kind == "f64")] + [o for _n, _d, o in others]
    for dag, resp, jresp, oracle in zip(dags, got, jgot, oracles):
        alone = TorchDagEvaluator(dag_to_wire(dag), block_rows=BR, device="cpu")
        alone.route_hint = "unary"
        _close(resp, alone.run(None, region.pcache), "alone")
        _close(resp, jresp, "JAX")
        _close(resp, region.cpu(dag), "CPU pipeline")
        want = oracle(region.arrays)
        assert len(resp.iter_rows()) == len(want)
        for g_row, w_row in zip(resp.iter_rows(), want):
            assert g_row == pytest.approx(w_row, rel=1e-12, abs=0)


@pytest.mark.parametrize("kind", sorted(WIDE_RIDERS))
def test_a_cross_region_batch_past_its_slots_rides_the_wide_route(kind):
    """The four-flag plan over three regions (every task wide): as the
    regions served one by one, the JAX package's ``run_xregion_cached`` and
    the CPU pipeline."""
    regions = [SuppRegion(3, 32), SuppRegion(1, 33), SuppRegion(2, 34)]
    dag = WIDE_RIDERS[kind]()
    ev = _port_evs([dag])[0]
    _specs, _group_cols, capacity = xregion_specs(ev, [r.pcache for r in regions])
    assert capacity == 512
    got = run_xregion_cached(ev, [r.pcache for r in regions])
    jgot = jax_eval.run_xregion_cached(JaxDagEvaluator(dag, block_rows=BR),
                                       [r.jcache for r in regions])
    for region, resp, jresp in zip(regions, got, jgot):
        _close(resp, ev.run(None, region.pcache), "alone")
        _close(resp, jresp, "JAX")
        _close(resp, region.cpu(dag), "CPU pipeline")


# ---------------------------------------------------------------------------
# the batch kernels' plain versions
# ---------------------------------------------------------------------------

def test_batch_layout_and_plain_kernels_match_the_grouped_plain_version():
    """Each task's packed state from the two plain batch kernels equals
    ``fused_group_agg_plain`` over the same task; the grid shares
    ``BATCH_CTAS`` by rows; padding words are 0."""
    from tikv_tpu_torch.copr import fused_group_agg as ga

    regions = [Region(3, 26), Region(1, 27, flags=b"AN")]
    evs = _port_evs([d for _n, d, _o in _riders(["q1", "q6", "bit_xor_by_linestatus"])])
    tasks = []
    for region in regions:
        cache = region.pcache
        for ev in evs:
            stable = ev._stable_dict_group_cols(cache.blocks)
            gc, dicts = stable
            ship = sorted(set(ev._ship_cols(gc)))
            prog = ev._batch_program(ship, ev.plan.schema, gc, tuple(len(d) for d in dicts))
            cap = 1
            while cap < int(np.prod([len(d) + 1 for d in dicts])):
                cap *= 2
            tasks.append(fused_batch.Task(prog, ev._stacked_device(cache, ship), cap))
    batch = fused_batch.Batch(tasks)
    assert sum(batch.grids) == batch.n_ctas <= fused_batch.BATCH_CTAS + len(tasks)
    for t, g in zip(tasks, batch.grids):
        assert 1 <= g <= -(-t.img.n_blocks * BR // ga.THREADS)
    assert batch.cta0 == list(np.cumsum([0] + batch.grids[:-1]))
    parts = fused_batch.batch_partials_plain(batch)
    assert parts.shape == (batch.n_parts,)
    ints, flts = fused_batch.batch_combine_pack_plain(batch, parts)
    assert ints.shape == (len(tasks), batch.li, batch.c_max)
    for i, t in enumerate(tasks):
        wi, wf = ga.fused_group_agg_plain(t.prog, t.img, t.capacity)
        assert (ints[i, : t.prog.n_int, : t.capacity] == wi).all()
        assert (ints[i, t.prog.n_int :] == 0).all() and (ints[i, :, t.capacity :] == 0).all()
        assert (flts[i, : t.prog.n_f64, : t.capacity] == wf).all()
    got = fused_batch.fused_batch(tasks)
    assert (got[0] == ints).all() and (got[1] == flts).all()


def test_batch_refuses_what_the_kernels_do_not_take():
    """A task past its shared-memory rows is no longer refused (a name kept
    from then): it is wide, takes no CTA of the batch kernels and is served
    by the grouped pair's wide route in the same call.  Host group ids and
    an empty batch are still refused."""
    from tikv_tpu_torch.copr import fused_group_agg as ga

    region = Region(1, 28)
    ev = _port_evs([_riders(["q1"])[0][1]])[0]
    ship = ev._ship_cols([5, 6])
    prog = ev._batch_program(ship, ev.plan.schema, [5, 6], (3, 2))
    img = ev._stacked_device(region.pcache, ship)
    wide_cap = fused_batch.c_max(prog) + 1
    tasks = [fused_batch.Task(prog, img, wide_cap), fused_batch.Task(prog, img, 16)]
    batch = fused_batch.Batch(tasks)
    assert batch.wide == [0] and batch.shared == [1] and batch.grids[0] == 0
    assert batch.c_max == wide_cap and batch.c_shared == 16
    ints, flts = fused_batch.fused_batch(tasks)
    for i, t in enumerate(tasks):
        wi, _wf = ga.fused_group_agg_plain(t.prog, t.img, t.capacity)
        assert torch.equal(ints[i, : prog.n_int, : t.capacity], wi)
        assert (ints[i, :, t.capacity :] == 0).all()
    host = ev.plan.group_program
    with pytest.raises(ValueError, match="dictionary codes, not host ids"):
        fused_batch.Batch([fused_batch.Task(host, img, 16)])
    with pytest.raises(ValueError, match="CUDA"):
        batch = fused_batch.Batch([fused_batch.Task(prog, img, 16)])
        fused_batch.launch_batch_partials(batch, None, None)
    with pytest.raises(ValueError, match="at least one task"):
        fused_batch.Batch([])


def test_batch_task_struct_layout():
    # BtTask: 37 pointers and int64, the 384-byte column descriptors
    # (FaEnc), 64 constants, 64 leaf identities, 256 code words, ten int32,
    # two int32[4], two int32[16], six int8[64] tables, field for field as
    # csrc/fused_batch.cu declares them; the wrapper re-checks the kernel's
    # sizeof at load
    import ctypes
    import re
    from pathlib import Path

    assert ctypes.sizeof(fused_batch._BtTask) == 3312
    assert fused_batch.SMEM_MAX == 232448 - 3312
    text = (Path(fused_batch.__file__).resolve().parent.parent / "csrc"
            / "fused_batch.cu").read_text()
    body = text[text.index("struct BtTask {"):]
    body = re.sub(r"//.*", "", body[: body.index("};")])
    assert re.findall(r"(\w+)(?:\[\w+\])?;", body) == [n for n, _t in fused_batch._BtTask._fields_]
    assert int(re.search(r"#define BT_THREADS (\d+)", text).group(1)) == fused_batch.THREADS
