"""The mesh path of the port (programs #16, #18, #19) against the JAX package.

The port's ``ShardedDagEvaluator``, ``MeshServingRunner`` and
``ShardedTopNEvaluator`` run on ``make_mesh(["cpu"] * 8, groups)``, through
the plain versions of their kernels (``mesh_merge`` among them), and are held
to ``tikv_tpu.parallel.mesh`` on conftest's eight virtual CPU devices, over
the numeric table of ``tests/test_mesh.py`` (``numeric_table_kvs(4096)``):
every leaf of the state, integer leaves exactly and f64 leaves to rel
1e-12 (the reference reduces with ``psum`` in XLA's order, the port folds
in shard order); every ``SelectResponse`` byte for byte to the JAX runner,
the port's single-device cold answer and the CPU pipeline.  The JAX
package's group growth case groups by ``id mod 97``; the port has no ``mod``
yet (``op_not_ported``), so its growth case groups by ``b``'s 100 values.
"""

import numpy as np
import pytest
import torch

import jax

from copr_fixtures import TABLE_ID, numeric_table_kvs
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag import Aggregation, BatchExecutorsRunner, DagRequest, Selection, TableScan, TopN
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.executors import FixtureScanSource as JaxSource
from tikv_tpu.copr.rpn import call, col, const_int
from tikv_tpu.parallel import mesh as jm
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_group_agg as ga
from tikv_tpu_torch.copr import fused_mesh
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
from tikv_tpu_torch.parallel import mesh as pm

COLS, KVS, (A, B, C) = numeric_table_kvs(4096)
PORT_KVS = fx.numeric_table(4096)[1]  # the port's own copy of the table
N = 4096
REL = 1e-12


def _columns(n, cols_map):
    return {i: (np.asarray(v).astype(np.int64), np.zeros(n, dtype=bool))
            for i, v in cols_map.items()}


COLUMNS = _columns(N, {0: np.arange(N), 1: A, 2: B, 3: C})


def _meshes(groups, n_devices=8):
    return (jm.make_mesh(jax.devices()[:n_devices], groups=groups),
            pm.make_mesh(["cpu"] * n_devices, groups=groups))


def _same_state(jstate, port):
    """The JAX state (first, carries) against the port's ``unpack``."""
    jfirst, jcarries = jax.tree.map(np.asarray, jstate)
    first, carries = port
    np.testing.assert_array_equal(first, jfirst)
    assert len(carries) == len(jcarries)
    for got_agg, want_agg in zip(carries, jcarries):
        assert len(got_agg) == len(want_agg)
        for got, want in zip(got_agg, want_agg):
            if np.asarray(want).dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=REL, atol=0)
            else:
                np.testing.assert_array_equal(got, want)


def _both(dag, groups, rows_per_shard, capacity, blocks, n_devices=8):
    """Run ``blocks`` through both sharded evaluators; returns the port's
    unpacked state after holding it to the JAX one."""
    jmesh, pmesh = _meshes(groups, n_devices)
    jev = jm.ShardedDagEvaluator(dag, jmesh, rows_per_shard, capacity=capacity)
    pev = pm.ShardedDagEvaluator(dag_to_wire(dag), pmesh, rows_per_shard, capacity=capacity)
    got = pev.unpack(pev.run_blocks(blocks))
    _same_state(jev.run_blocks(blocks), got)
    return got


def q6ish():
    return DagRequest(executors=[
        TableScan(TABLE_ID, COLS),
        Selection([call("lt", col(1), const_int(500))]),
        Aggregation([], [AggDescriptor("count", None), AggDescriptor("sum", col(3)),
                         AggDescriptor("min", col(1)), AggDescriptor("max", col(2))]),
    ])


# ---------------------------------------------------------------------------
# program #16: ShardedDagEvaluator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_sharded_simple_agg_matches_jax_and_numpy(groups):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    rows = N // (8 // groups)
    first, carries = _both(q6ish(), groups, rows, 16, [(COLUMNS, N, np.zeros(N, np.int32))])
    mask = A < 500
    assert carries[0][0][0] == mask.sum()
    assert carries[1][1][0] == C[mask].sum()
    assert carries[2][1][0] == A[mask].min()
    assert carries[3][1][0] == B[mask].max()
    assert first[0] == int(np.flatnonzero(mask)[0])


@pytest.mark.parametrize("groups", [2, 4])
def test_sharded_group_agg_matches_jax_and_numpy(groups):
    dag = DagRequest(executors=[
        TableScan(TABLE_ID, COLS),
        Aggregation([col(2)], [AggDescriptor("count", None), AggDescriptor("sum", col(3))]),
    ])
    gkey = (B % 16).astype(np.int32)
    first, carries = _both(dag, groups, N // (8 // groups), 16, [(COLUMNS, N, gkey)])
    for g in range(16):
        m = gkey == g
        assert carries[0][0][g] == m.sum()
        assert carries[1][1][g] == C[m].sum()
        assert first[g] == int(np.flatnonzero(m)[0])


def test_multi_block_carry_and_a_partial_last_block():
    """The state stays on the devices across super-blocks; the last one is
    partial, so its shards clip ``n_valid`` (some to 0)."""
    rows = N // 4 // 4  # 4 shards of 256 rows: super-blocks of 1,024 rows
    total = rows * 4
    blocks = []
    for b in range(4):
        sl = slice(b * total, (b + 1) * total)
        n_valid = total if b < 3 else 300
        cols = _columns(total, {1: A[sl], 2: B[sl], 3: C[sl]})
        blocks.append((cols, n_valid, (B[sl] % 16).astype(np.int32)))
    first, carries = _both(q6ish(), 2, rows, 16, blocks)
    seen = np.concatenate([np.arange(3 * total), 3 * total + np.arange(300)])
    mask = A[seen] < 500
    gk = B[seen] % 16
    for g in range(16):
        m = mask & (gk == g)
        assert carries[0][0][g] == m.sum()
        assert carries[1][1][g] == C[seen][m].sum()
        assert first[g] == int(seen[np.flatnonzero(m)[0]])


def test_every_mergeable_aggregate_and_first_declines():
    """count, sum, avg, var_pop (an f64 sum of squares), min, max and the
    three bitwise aggregates merge across the shards; ``first`` declines."""
    aggs = [AggDescriptor(op, None if op == "count" else col(c))
            for op, c in (("count", 0), ("sum", 3), ("avg", 1), ("var_pop", 3), ("min", 2),
                          ("max", 3), ("bit_and", 1), ("bit_or", 1), ("bit_xor", 2))]
    dag = DagRequest(executors=[TableScan(TABLE_ID, COLS),
                                Selection([call("lt", col(1), const_int(900))]),
                                Aggregation([], aggs)])
    rng = np.random.default_rng(2)
    gids = rng.integers(0, 4, N).astype(np.int32)
    _first, carries = _both(dag, 2, N // 4, 4, [(COLUMNS, N, gids)])
    mask = A < 900
    for slot in range(4):
        m = mask & (gids == slot)
        assert carries[6][1][slot] == np.bitwise_and.reduce(A[m])
        assert carries[7][1][slot] == np.bitwise_or.reduce(A[m], initial=0)
        assert carries[8][1][slot] == np.bitwise_xor.reduce(B[m], initial=0)
    first_dag = DagRequest(executors=[TableScan(TABLE_ID, COLS),
                                      Aggregation([], [AggDescriptor("first", col(1))])])
    assert not pm.mesh_mergeable(TorchDagEvaluator(dag_to_wire(first_dag), device="cpu")
                                 .plan.agg_rpns)
    jmesh, pmesh = _meshes(2)
    with pytest.raises(ValueError, match="mesh merge"):
        jm.ShardedDagEvaluator(first_dag, jmesh, rows_per_shard=64, capacity=4)
    with pytest.raises(ValueError, match="mesh merge"):
        pm.ShardedDagEvaluator(dag_to_wire(first_dag), pmesh, rows_per_shard=64, capacity=4)


def test_a_bit_aggregate_plan_of_the_reference_test():
    """``test_mesh.py``'s bit-aggregate case: its own two-column table."""
    cols_info = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
                 ColumnInfo(2, FieldType.int64())]
    dag = DagRequest(executors=[TableScan(1, cols_info), Aggregation([], [
        AggDescriptor("bit_and", col(1)), AggDescriptor("bit_or", col(1)),
        AggDescriptor("bit_xor", col(1)), AggDescriptor("count", None)])])
    rng = np.random.default_rng(2)
    n = 64 * 4
    vals = rng.integers(0, 1 << 20, n).astype(np.int64)
    gids = rng.integers(0, 4, n).astype(np.int32)
    _both(dag, 2, 64, 4, [({1: (vals, np.zeros(n, bool))}, n, gids)])


# ---------------------------------------------------------------------------
# MeshServingRunner
# ---------------------------------------------------------------------------

def _grouped_q1ish():
    return DagRequest(executors=[
        TableScan(TABLE_ID, COLS),
        Aggregation([col(2)], [AggDescriptor("count", None), AggDescriptor("sum", col(3)),
                               AggDescriptor("avg", col(3))]),
    ])


def _scalar_q6ish():
    return DagRequest(executors=[
        TableScan(TABLE_ID, COLS),
        Selection([call("lt", col(2), const_int(40))]),
        Aggregation([], [AggDescriptor("count", None), AggDescriptor("sum", col(3)),
                         AggDescriptor("min", col(2)), AggDescriptor("max", col(3))]),
    ])


MVCC_COLS, MVCC_KVS, _ = numeric_table_kvs(3000, seed=7)
PORT_MVCC_KVS = fx.numeric_table(3000, seed=7)[1]


def test_the_port_draws_the_reference_tables():
    assert PORT_KVS == KVS and PORT_MVCC_KVS == MVCC_KVS
    assert [(c.col_id, c.ftype.eval_type.value) for c in fx.numeric_table(1)[0]] == \
        [(c.col_id, c.ftype.eval_type.value) for c in COLS]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("plan", ["q6ish", "q1ish"])
def test_mesh_serving_runner_bytes(groups, plan):
    """The runner's response equals the JAX runner's, the port's
    single-device cold answer and the CPU pipeline's, byte for byte; the
    grouped plan's 100 groups grow the capacity from 16 to 128."""
    make = _scalar_q6ish if plan == "q6ish" else _grouped_q1ish
    dag = DagRequest(executors=[TableScan(TABLE_ID, MVCC_COLS)] + list(make().executors[1:]))
    jmesh, pmesh = _meshes(groups)
    runner = pm.MeshServingRunner(dag_to_wire(dag), pmesh, rows_per_shard=64)
    got = runner.run(FixtureScanSource(PORT_MVCC_KVS)).encode()
    want = BatchExecutorsRunner(dag, JaxSource(MVCC_KVS)).handle_request().encode()
    assert got == want
    assert jm.MeshServingRunner(dag, jmesh, rows_per_shard=64).run(
        JaxSource(MVCC_KVS)).encode() == want
    one = TorchDagEvaluator(dag_to_wire(dag), block_rows=1024, device="cpu")
    assert one.run(FixtureScanSource(PORT_MVCC_KVS)).encode() == want
    assert runner.sharded.capacity == (16 if plan == "q6ish" else 128)
    assert runner.sharded.capacity % groups == 0


def test_mesh_serving_runner_non_pow2_groups():
    """A groups axis of 3 over 6 devices: a capacity divisible by 3 (48),
    and the same bytes as the JAX runner on 6 devices and the CPU pipeline."""
    jmesh, pmesh = _meshes(3, n_devices=6)
    runner = pm.MeshServingRunner(dag_to_wire(_grouped_q1ish()), pmesh, rows_per_shard=64)
    assert runner.sharded.capacity == 48 and runner.sharded.n_regions == 2
    got = runner.run(FixtureScanSource(PORT_KVS)).encode()
    want = BatchExecutorsRunner(_grouped_q1ish(), JaxSource(KVS)).handle_request().encode()
    assert got == want
    assert jm.MeshServingRunner(_grouped_q1ish(), jmesh, rows_per_shard=64).run(
        JaxSource(KVS)).encode() == want
    assert runner.sharded.capacity == 192  # 100 groups: 48 doubled twice


def test_mesh_rejects_non_agg_dag_cheaply(monkeypatch):
    """A scan or TopN plan is refused before any evaluator is built."""
    def no_evaluator(*_a, **_k):
        raise AssertionError("an evaluator was built for a plan the mesh refuses")

    monkeypatch.setattr(pm, "TorchDagEvaluator", no_evaluator)
    mesh = pm.make_mesh(["cpu"] * 8, groups=2)
    for dag in (DagRequest(executors=[TableScan(TABLE_ID, COLS), TopN([(col(1), False)], 5)]),
                DagRequest(executors=[TableScan(TABLE_ID, COLS),
                                      Selection([call("lt", col(1), const_int(5))])])):
        with pytest.raises(ValueError, match="aggregation DAG"):
            pm.MeshServingRunner(dag_to_wire(dag), mesh)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="aggregation DAG"):
        pm.ShardedDagEvaluator(dag_to_wire(DagRequest(executors=[
            TableScan(TABLE_ID, COLS), TopN([(col(1), False)], 5)])), mesh, 64)


def test_f64_leaves_past_the_kernels_slots_decline():
    """var_pop's f64 leaf over more groups than the shared-memory partials
    hold (a name kept from when the port declined it): each shard takes the
    grouped pair's wide route.  The sharded evaluator at 2,048 slots equals
    the JAX one leaf by leaf, and ``MeshServingRunner``, its capacity grown
    past ``c_max``, answers byte for byte as the JAX runner, the
    single-device route and the CPU pipeline (integer squares sum exactly)."""
    dag = DagRequest(executors=[TableScan(TABLE_ID, COLS), Aggregation(
        [col(1)], [AggDescriptor("var_pop", col(3)), AggDescriptor("count", None)])])
    _first, carries = _both(dag, 2, N // 4, 2048, [(COLUMNS, N, A.astype(np.int32))])
    m = A == A[0]
    assert carries[0][2][A[0]] == float((C[m].astype(np.float64) ** 2).sum())
    jmesh, pmesh = _meshes(2)
    runner = pm.MeshServingRunner(dag_to_wire(dag), pmesh, rows_per_shard=64)
    got = runner.run(FixtureScanSource(PORT_KVS)).encode()
    want = BatchExecutorsRunner(dag, JaxSource(KVS)).handle_request().encode()
    assert got == want
    assert jm.MeshServingRunner(dag, jmesh, rows_per_shard=64).run(JaxSource(KVS)).encode() \
        == want
    one = TorchDagEvaluator(dag_to_wire(dag), block_rows=1024, device="cpu")
    assert one.run(FixtureScanSource(PORT_KVS)).encode() == want
    assert runner.sharded.capacity > runner.sharded.prog.c_max


def test_make_mesh_shapes_and_refusals(monkeypatch):
    mesh = pm.make_mesh(["cpu"] * 8, groups=4)
    assert mesh.shape == {"regions": 2, "groups": 4} and mesh.size == 8
    assert mesh.lead == torch.device("cpu")
    assert pm._flat_regions_mesh(mesh).shape == {"regions": 8, "groups": 1}
    with pytest.raises(ValueError, match="divide"):
        pm.make_mesh(["cpu"] * 6, groups=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh(["cuda:0"] * 8)


# ---------------------------------------------------------------------------
# programs #18 and #19: ShardedTopNEvaluator
# ---------------------------------------------------------------------------

def topn_dag(k=10):
    return DagRequest(executors=[
        TableScan(TABLE_ID, COLS),
        Selection([call("lt", col(1), const_int(700))]),
        TopN([(col(2), True), (col(3), False)], k),
    ])


def _topn_both(dag, groups, rows, blocks):
    jmesh, pmesh = _meshes(groups)
    jev = jm.ShardedTopNEvaluator(dag, jmesh, rows)
    pev = pm.ShardedTopNEvaluator(dag_to_wire(dag), pmesh, rows)
    got = pev.finalize(pev.run_blocks(blocks))
    want = jev.finalize(jev.run_blocks(blocks))
    assert got["rows"] == want["rows"]
    np.testing.assert_array_equal(got["gidx"], want["gidx"])
    for (d, nl), (wd, wnl) in zip(got["payload"], want["payload"]):
        np.testing.assert_array_equal(d, wd)
        np.testing.assert_array_equal(nl, wnl)
    return got


@pytest.mark.parametrize("n_blocks", [1, 4])
def test_sharded_topn_matches_jax_and_oracle(n_blocks):
    """Per-shard running top K and the merge == the single-stream top K,
    ties broken by global stream order across shards and blocks."""
    rows = N // 4 // n_blocks
    total = rows * 4
    blocks = []
    for b in range(n_blocks):
        sl = slice(b * total, (b + 1) * total)
        blocks.append((_columns(total, {0: np.arange(N)[sl], 1: A[sl], 2: B[sl], 3: C[sl]}),
                       total))
    got = _topn_both(topn_dag(10), 2, rows, blocks)
    idx = np.flatnonzero(A < 700)
    expect = idx[np.lexsort((idx, C[idx], -B[idx]))][:10]
    assert got["rows"] == 10
    np.testing.assert_array_equal(got["gidx"], expect)
    np.testing.assert_array_equal(got["payload"][0][0], expect)
    np.testing.assert_array_equal(got["payload"][2][0], B[expect])
    np.testing.assert_array_equal(got["payload"][3][0], C[expect])


def test_sharded_topn_ties_resolve_in_stream_order():
    """Identical keys in every shard and block: global stream order, across
    blocks too (shard 1's rows of block 0 before shard 0's of block 1)."""
    rows = 16
    total = rows * 8
    dag = DagRequest(executors=[TableScan(TABLE_ID, COLS), TopN([(col(2), False)], 40)])
    blocks = []
    for b in range(2):
        sl = slice(b * total, (b + 1) * total)
        blocks.append((_columns(total, {0: np.arange(N)[sl], 1: A[sl],
                                        2: np.full(total, 42), 3: C[sl]}), total))
    got = _topn_both(dag, 1, rows, blocks)
    assert list(got["gidx"]) == list(range(40))


def test_sharded_topn_fewer_rows_than_k():
    rows = 512 // 8
    n = rows * 8
    dag = DagRequest(executors=[TableScan(TABLE_ID, COLS),
                                Selection([call("lt", col(1), const_int(3))]),
                                TopN([(col(1), False)], 50)])
    got = _topn_both(dag, 1, rows, [(_columns(n, {0: np.arange(n), 1: A[:n], 2: B[:n],
                                                  3: C[:n]}), n - 5)])
    assert got["rows"] == int((A[: n - 5] < 3).sum()) < 50


# ---------------------------------------------------------------------------
# mesh_merge's plain version
# ---------------------------------------------------------------------------

def _fold(prog, parts, table, carry, lo, hi):
    """Each region's listed parts folded one by one through ``_merge``."""
    pi, pf = parts
    out_i = torch.empty((table.shape[0], prog.n_int, hi - lo), dtype=torch.int64)
    out_f = torch.empty((table.shape[0], prog.n_f64, hi - lo), dtype=torch.float64)
    for r in range(table.shape[0]):
        for leaf in prog.leaves:
            src, out = (pf, out_f) if leaf.is_f64 else (pi, out_i)
            acc = torch.full((hi - lo,), leaf.ident_value, dtype=src.dtype)
            for q in table[r].tolist():
                if q >= 0:
                    acc = ga._merge(leaf, acc, src[q, leaf.slot, lo:hi])
            if carry is not None:
                acc = ga._merge(leaf, (carry[1] if leaf.is_f64 else carry[0])[r, leaf.slot], acc)
            out[r, leaf.slot] = acc
    return out_i, out_f


@pytest.mark.parametrize("n_parts,capacity", [(8, 16), (64, 331)])
def test_mesh_merge_plain_folds_through_merge(n_parts, capacity):
    """Every mergeable leaf kind, NaN, +-0.0, +-inf and int64 wrap, parts
    listed in any order with gaps, a region with none; with and without a
    carry, over the whole width and a member's slot window."""
    prog, parts, table, carry = fx.mesh_merge_case(n_parts, 5, capacity, seed=n_parts,
                                                   device="cpu")
    kinds = {leaf.kind for leaf in prog.leaves}
    assert kinds == set(range(ga.LEAF_TRACK, ga.LEAF_XOR + 1))
    for lo, hi, with_carry in ((0, capacity, False), (capacity // 2, capacity, True)):
        c = None if not with_carry else (carry[0][:, :, lo:hi].contiguous(),
                                         carry[1][:, :, lo:hi].contiguous())
        got = fused_mesh.mesh_merge(prog, parts, table, c, lo, hi)
        want = _fold(prog, parts, table, c, lo, hi)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int64), want[1].view(torch.int64))
    # the region that lists no part holds the identities
    empty = fused_mesh.mesh_merge(prog, parts, table)
    for leaf in prog.leaves:
        row = (empty[1] if leaf.is_f64 else empty[0])[-1, leaf.slot]
        assert bool((row == leaf.ident_value).all())


def test_mesh_merge_refuses_first_and_bad_tables():
    ev = TorchDagEvaluator(dag_to_wire(DagRequest(executors=[
        TableScan(TABLE_ID, COLS), Aggregation([col(2)], [AggDescriptor("first", col(1))])])),
        device="cpu")
    prog = ev.plan.group_program
    parts = ga.init_packed(prog, 4, "cpu")
    with pytest.raises(ValueError, match="mesh merge rule"):
        fused_mesh.mesh_merge(prog, (parts[0][None], parts[1][None]),
                              fused_mesh.merge_table([[0]], 1, "cpu"))
    with pytest.raises(ValueError, match="part rows"):
        fused_mesh.merge_table([[0, 3]], 2, "cpu")
