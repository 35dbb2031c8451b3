"""The device-built group dictionary of the mesh (program #17) against the JAX package.

The port's ``ShardedGroupedEvaluator`` runs on ``make_mesh(["cpu"] * 8,
groups)``, through the plain versions of its kernels (``copr/fused_dict.py``:
``dict_keys``, ``dict_union``, ``dict_ids``; ``mesh_merge`` with the carry
remap), and is held to ``tikv_tpu.parallel.mesh.ShardedGroupedEvaluator``
on conftest's eight virtual CPU devices and to numpy oracles: the
dictionary, the first rows, the flag and every leaf of the state, integer
leaves exactly and f64 leaves to rel 1e-12 (the reference reduces with
``psum`` in XLA's order, the port folds in shard order).  After an
overflow only the flag is compared: the reference misfiles the carry by
design then.  The kernels' plain versions are held to direct numpy
statements, the tile-merge identity of ``dict_union`` with hypothesis.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag import Aggregation, DagRequest, Selection, TableScan
from tikv_tpu.copr.dag_wire import dag_from_wire, dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.rpn import call, col, const_int
from tikv_tpu.parallel import mesh as jm
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import fused_dict as fd
from tikv_tpu_torch.copr import fused_mesh
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_dag_to_wire
from tikv_tpu_torch.parallel import mesh as pm

TABLE_ID = 42
COLS = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, FieldType.int64()),
        ColumnInfo(3, FieldType.int64()), ColumnInfo(4, FieldType.decimal_type(2))]
N = 4096
RNG = np.random.default_rng(0)  # the numeric table of tests/test_mesh.py: a, b, c
A, B, C = RNG.integers(0, 1000, N), RNG.integers(0, 100, N), RNG.integers(0, 100000, N)
REL = 1e-12


def _columns(n, cols_map, nulls=None):
    nulls = nulls or {}
    return {i: (np.asarray(v).astype(np.int64), nulls.get(i, np.zeros(n, dtype=bool)))
            for i, v in cols_map.items()}


def grouped_dag(aggs=None, cols=COLS, key=2):
    aggs = aggs or [AggDescriptor("count", None), AggDescriptor("sum", col(3)),
                    AggDescriptor("min", col(1))]
    return DagRequest(executors=[TableScan(TABLE_ID, cols),
                                 Selection([call("lt", col(1), const_int(800))]),
                                 Aggregation([col(key)], aggs)])


def _both(dag, groups, rows, capacity, blocks, key_bits=31):
    """Both evaluators over ``blocks``; returns the port's and the JAX
    package's ``finalize`` and raw states, after holding them equal (all of
    it without overflow, the flag alone with)."""
    jev = jm.ShardedGroupedEvaluator(dag, jm.make_mesh(jax.devices(), groups=groups), rows,
                                     capacity=capacity, key_bits=key_bits)
    pev = pm.ShardedGroupedEvaluator(dag_to_wire(dag), pm.make_mesh(["cpu"] * 8, groups=groups),
                                     rows, capacity=capacity, key_bits=key_bits)
    jstate = jev.run_blocks(blocks)
    pstate = pev.run_blocks(blocks)
    jfin, pfin = jev.finalize(jstate), pev.finalize(pstate)
    assert pfin["overflow"] == jfin["overflow"]
    if not pfin["overflow"]:
        _same(pfin, jfin)
        jd, jfirst, jcarries, jover = jax.tree.map(np.asarray, jstate)
        d, first, carries, over = pev.unpack(pstate)
        _same({"keys": d, "first": first, "aggs": carries, "overflow": over},
              {"keys": jd, "first": jfirst, "aggs": jcarries, "overflow": bool(jover)})
    return pfin, pev


def _same(got, want):
    np.testing.assert_array_equal(got["keys"], np.asarray(want["keys"]))
    np.testing.assert_array_equal(got["first"], np.asarray(want["first"]))
    assert got["overflow"] == want["overflow"]
    assert len(got["aggs"]) == len(want["aggs"])
    for g_agg, w_agg in zip(got["aggs"], want["aggs"]):
        assert len(g_agg) == len(w_agg)
        for g, w in zip(g_agg, w_agg):
            w = np.asarray(w)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=REL, atol=0)
            else:
                np.testing.assert_array_equal(g, w)


def _first_order(mask, key):
    order, seen = [], set()
    for i in np.flatnonzero(mask):
        g = int(key[i])
        if g not in seen:
            seen.add(g)
            order.append(g)
    return order


def _check_oracle(out, mask, key, value=C, low=A):
    """count, sum(value) and min(low) per group in first-occurrence order."""
    order = _first_order(mask, key)
    assert list(out["keys"]) == order
    for pos, g in enumerate(order):
        m = mask & (key == g)
        assert out["aggs"][0][0][pos] == m.sum()
        assert out["aggs"][1][1][pos] == value[m].sum()
        assert out["aggs"][2][1][pos] == low[m].min()


# ---------------------------------------------------------------------------
# the cases of tests/test_mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_device_group_dict_matches_jax_and_the_oracle(groups):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    rows = N // (8 // groups)
    gkey = (B % 13).astype(np.int64)
    out, _ev = _both(grouped_dag(), groups, rows, 64, [(_columns(N, {1: A, 2: gkey, 3: C}), N)])
    assert not out["overflow"]
    _check_oracle(out, A < 800, gkey)


def test_device_group_dict_multi_block_carry():
    """Keys that sort first arrive in later blocks only: the carried slots
    move (the remap) and the first rows use the global stream index."""
    rows = N // 4 // 4
    total = rows * 4
    gkey = (B % 7).astype(np.int64) + 20
    gkey[2 * total:] = (B[2 * total:] % 5).astype(np.int64)
    blocks = [(_columns(total, {1: A[s:s + total], 2: gkey[s:s + total], 3: C[s:s + total]}),
               total) for s in range(0, N, total)]
    out, _ev = _both(grouped_dag(), 2, rows, 64, blocks)
    assert not out["overflow"]
    _check_oracle(out, A < 800, gkey)


def test_group_dict_overflow_is_detected():
    gkey = (np.arange(N) % 50).astype(np.int64)  # 50 groups into 8 slots
    out, _ev = _both(grouped_dag(), 1, N // 8, 8, [(_columns(N, {1: A, 2: gkey, 3: C}), N)])
    assert out["overflow"]


def test_group_dict_overflow_is_sticky():
    """An overflow in the first block stays set after blocks that fit."""
    total = 512
    few = _columns(total, {1: np.zeros(total), 2: np.arange(total) % 3, 3: C[:total]})
    many = _columns(total, {1: np.zeros(total), 2: np.arange(total) % 40, 3: C[:total]})
    out, _ev = _both(grouped_dag(), 1, total // 8, 8, [(many, total), (few, total)])
    assert out["overflow"]


def test_group_key_out_of_range_flags_overflow():
    total = 512
    gkey = np.zeros(total, dtype=np.int64)
    gkey[: total // 2] = -1  # negative: cannot pack
    gkey[total // 2:] = (1 << 31) - 1  # the NULL lane
    blocks = [(_columns(total, {1: np.zeros(total), 2: gkey, 3: C[:total]}), total)]
    out, _ev = _both(grouped_dag(), 1, total // 8, 8, blocks)
    assert out["overflow"]


def test_inactive_rows_out_of_range_do_not_flag():
    """Only active rows flag: a bad value behind the selection or past
    n_valid is the sentinel."""
    total = 512
    gkey = (np.arange(total) % 4).astype(np.int64)
    a = np.zeros(total, dtype=np.int64)
    a[:8], gkey[:8] = 900, -5  # selection false
    gkey[-8:] = -5  # past n_valid
    out, _ev = _both(grouped_dag(), 1, total // 8, 8,
                     [(_columns(total, {1: a, 2: gkey, 3: C[:total]}), total - 8)])
    assert not out["overflow"] and list(out["keys"]) == [0, 1, 2, 3]


def test_too_many_group_keys_rejected_at_init():
    dag = DagRequest(executors=[TableScan(TABLE_ID, COLS),
                                Aggregation([col(1), col(2), col(3)],
                                            [AggDescriptor("count", None)])])
    with pytest.raises(ValueError):
        jm.ShardedGroupedEvaluator(dag, jm.make_mesh(jax.devices(), groups=1), 64, capacity=8)
    with pytest.raises(ValueError):
        pm.ShardedGroupedEvaluator(dag_to_wire(dag), pm.make_mesh(["cpu"] * 8), 64, capacity=8)
    # two keys fit at 31 bits, three at 20
    pm.ShardedGroupedEvaluator(dag_to_wire(dag), pm.make_mesh(["cpu"] * 8), 64, capacity=8,
                               key_bits=20)


@pytest.mark.parametrize("dag", ["first", "no_group_by"])
def test_first_and_plans_without_group_by_are_refused(dag):
    if dag == "first":
        plan = grouped_dag([AggDescriptor("count", None), AggDescriptor("first", col(3))])
    else:
        plan = DagRequest(executors=[TableScan(TABLE_ID, COLS),
                                     Aggregation([], [AggDescriptor("count", None)])])
    with pytest.raises(ValueError):
        jm.ShardedGroupedEvaluator(plan, jm.make_mesh(jax.devices(), groups=1), 64)
    with pytest.raises(ValueError):
        pm.ShardedGroupedEvaluator(dag_to_wire(plan), pm.make_mesh(["cpu"] * 8), 64)


# ---------------------------------------------------------------------------
# beyond tests/test_mesh.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2])
def test_graft_q1_grouped_shape_matches_jax_and_the_oracle(groups):
    """The JAX package's grouped Q1 mesh step (two keys, l_returnflag and
    l_linestatus as INT codes) over the lineitem draws, several super-blocks,
    the last one partial."""
    n = 3000
    a = fx.build_arrays(n, 5)
    dag = dag_from_wire(port_dag_to_wire(fx.grouped_dag()))
    rows = 128
    total = rows * 8 // groups
    blocks = [(fx.grouped_columns(a, s, min(s + total, n), total), min(total, n - s))
              for s in range(0, n, total)]
    out, _ev = _both(dag, groups, rows, 16, blocks)
    want = fx.grouped_oracle(a)
    _same(out, dict(want, overflow=False))


@pytest.mark.parametrize("keys,capacity", [(("qty",), 64), (("qty", "ls"), 128)])
def test_wider_group_by_plans_match_jax_and_the_oracle(keys, capacity):
    """GROUP BY l_quantity (50 groups) and (l_quantity, l_linestatus) (100)."""
    n = 5000
    a = fx.build_arrays(n, 6)
    dag = dag_from_wire(port_dag_to_wire(fx.grouped_dag(keys)))
    blocks = [(fx.grouped_columns(a, s, min(s + 2048, n), 2048), min(2048, n - s))
              for s in range(0, n, 2048)]
    out, _ev = _both(dag, 1, 256, capacity, blocks)
    _same(out, dict(fx.grouped_oracle(a, keys), overflow=False))


def test_group_by_quantity_at_five_bits_flags_range():
    """l_quantity's values reach 50, past a 5-bit lane's 31."""
    n = 2048
    a = fx.build_arrays(n, 7)
    dag = dag_from_wire(port_dag_to_wire(fx.grouped_dag(("qty",))))
    out, _ev = _both(dag, 1, 256, 64, [(fx.grouped_columns(a, 0, n), n)], key_bits=5)
    assert out["overflow"]


def test_nullable_key_column_groups_its_nulls_apart():
    """NULL keys pack as the all-ones lane: one group of their own, in
    first-occurrence order with the others."""
    gkey = (B % 5).astype(np.int64)
    nulls = np.zeros(N, dtype=bool)
    nulls[5::7] = True
    out, _ev = _both(grouped_dag(), 2, N // 4, 16,
                     [(_columns(N, {1: A, 2: gkey, 3: C}, {2: nulls}), N)])
    packed = np.where(nulls, (1 << 31) - 1, gkey)
    _check_oracle(out, A < 800, packed)
    assert (1 << 31) - 1 in list(out["keys"])


def test_partial_last_super_block():
    """The last super-block's n_valid cuts it mid-shard: rows past it are
    ignored, whatever they hold."""
    gkey = (B % 11).astype(np.int64)
    total = 1024
    blocks = [(_columns(total, {1: A[s:s + total], 2: gkey[s:s + total], 3: C[s:s + total]}),
               total) for s in range(0, 3 * total, total)]
    blocks.append((_columns(total, {1: A[3 * total:], 2: gkey[3 * total:],
                                    3: C[3 * total:]}), 300))
    out, _ev = _both(grouped_dag(), 1, total // 8, 16, blocks)
    mask = (A < 800) & (np.arange(N) < 3 * total + 300)
    _check_oracle(out, mask, gkey)


def test_real_key_and_f64_leaves_match_jax():
    """A REAL group key truncates toward zero as astype(int64); REAL sums,
    min, max and var_pop fold to rel 1e-12 of the reference."""
    cols = COLS + [ColumnInfo(5, FieldType.double())]
    aggs = [AggDescriptor("count", None), AggDescriptor("sum", col(4)),
            AggDescriptor("min", col(4)), AggDescriptor("max", col(4)),
            AggDescriptor("var_pop", col(4)), AggDescriptor("sum", col(3))]
    rng = np.random.default_rng(8)
    real = rng.uniform(0, 12, N)
    columns = _columns(N, {0: np.arange(N), 1: A, 2: B, 3: C})
    columns[4] = (real * rng.choice([1.0, 1e3], N), np.zeros(N, dtype=bool))
    blocks = [({i: (d[s:s + 1024], m[s:s + 1024]) for i, (d, m) in columns.items()}, 1024)
              for s in range(0, N, 1024)]
    real_key = dag_from_wire(dag_to_wire(grouped_dag(aggs, cols, key=4)))
    out, _ev = _both(real_key, 2, 256, 16, [(  # the key: real truncated, values < 12
        {**b, 4: (np.floor(b[4][0] % 12) + 0.5, b[4][1])}, nv) for b, nv in blocks])
    assert not out["overflow"] and sorted(out["keys"]) == list(range(12))
    out, _ev = _both(grouped_dag(aggs, cols, key=2), 1, 128, 128, blocks)
    assert not out["overflow"]


def test_state_stays_on_the_lead_device_and_step_is_public():
    ev = pm.ShardedGroupedEvaluator(dag_to_wire(grouped_dag()), pm.make_mesh(["cpu"] * 8), 64)
    state = ev.init_state()
    gkey = (B[:512] % 3).astype(np.int64)
    state = ev.step([A[:512], gkey, C[:512]], [np.zeros(512, bool)] * 3, 512, state)
    assert ev.ship_cols == [1, 2, 3] and ev.nullable_cols == [1, 2, 3]
    assert all(t.device.type == "cpu" for t in (state[0], *state[1], state[2]))
    assert state[2].dtype == torch.int32 and int(state[2]) == 0
    assert list(ev.finalize(state)["keys"]) == _first_order(A[:512] < 800, gkey)


# ---------------------------------------------------------------------------
# the kernels' plain versions against numpy
# ---------------------------------------------------------------------------

def _union_numpy(d, keys, cap):
    u = np.unique(np.concatenate([d, keys]))
    u = u[u < fd.SENTINEL]
    out = np.full(cap, fd.SENTINEL, dtype=np.int64)
    out[: min(cap, len(u))] = u[:cap]
    return out, len(u) > cap


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 40), st.integers(0, 3), st.integers(0, 600), st.integers(1, 500),
       st.integers(0, 2**32 - 1))
def test_union_tiles_keep_the_smallest_distinct_keys(cap, extra, n, spread, seed):
    """The tile-merge identity of dict_union: passes that keep each tile's
    first cap distinct keys, at any tile of at least 2 * cap, give the cap
    smallest distinct keys of the whole union, and overflow exactly when it
    has more."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, spread, n)
    keys[rng.random(n) < 0.2] = fd.SENTINEL
    d, _o = _union_numpy(np.zeros(0, np.int64), rng.integers(0, spread, cap), cap)
    want, over = _union_numpy(d, keys, cap)
    tile = 2 * cap * 2 ** extra
    got, got_over = fd.dict_union_plain(torch.from_numpy(d), torch.from_numpy(keys), cap,
                                        tile=tile)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_over == over


@pytest.mark.parametrize("cap", [8, 64, 4096])
def test_dict_union_plain_at_the_kernel_tile(cap):
    rng = np.random.default_rng(cap)
    keys = rng.integers(0, 3 * cap, 50_000)
    keys[::3] = fd.SENTINEL
    d, _o = _union_numpy(np.zeros(0, np.int64), keys[:100], cap)
    got, over = fd.dict_union_plain(torch.from_numpy(d), torch.from_numpy(keys), cap)
    want, want_over = _union_numpy(d, keys, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert over == want_over
    assert fd.union_passes(50_000 + cap, cap)[-1] <= fd.union_tile(cap)


def test_dict_capacity_limits():
    """The tile route up to ``CAP_MAX`` slots, the sort route past it: every
    capacity in ``[1, 2^31)`` is taken (no ``dict_capacity_not_ported``)."""
    assert fd.union_tile(8) == fd.TILE_MIN and fd.union_tile(4096) == 8192
    assert fd.union_tile(fd.CAP_MAX) == fd.TILE_MAX
    with pytest.raises(ValueError, match="sort route"):
        fd.union_tile(fd.CAP_MAX + 1)
    for cap in (0, 1 << 31):
        with pytest.raises(ValueError):
            fd.check_capacity(cap)
    fd.check_capacity((1 << 31) - 1)
    assert fd.union_launches(100_000, 64) == {"dict_union": len(fd.union_passes(100_000, 64))}
    assert fd.union_launches(8 * 32768, 32768) == {
        "dict_union": 1, "dict_merge": 2, "dict_compact": 1}
    assert fd.merge_plan(fd.SORT_TILE) == [] \
        and fd.merge_plan(fd.SORT_TILE + 1) == [(fd.SORT_TILE, 2)]


def test_union_limits_match_the_cuda_source():
    """The union's keys a thread (E), its sort tile, its largest tile and
    the dictionary sizes in csrc/fused_dict.cu against the wrapper's; every
    tile the wrapper launches is one the kernel takes (a power of two from
    one warp's run to 1,024 threads' keys) and fits in shared memory."""
    import re
    from pathlib import Path

    text = (Path(fd.__file__).resolve().parent.parent / "csrc" / "fused_dict.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", text))
    assert int(defines["DU_E"]) == fd.KEYS_A_THREAD
    assert int(defines["DU_SORT_TILE"]) == fd.SORT_TILE
    assert int(defines["DU_TILE_MAX"]) == fd.TILE_MAX
    assert int(defines["DI_SMEM_KEYS"]) == fd.CAP_MAX
    # dict_compact: a tile of 16-byte rows, a lane of warp 0 a (row, warp)
    # segment; the sort route's buffers hold whole tiles
    threads = int(defines["DC_THREADS"])
    assert int(defines["DC_TILE"]) == fd.COMPACT_TILE
    assert "#define DC_ROWS (DC_TILE / (2 * DC_THREADS))" in text
    assert fd.COMPACT_TILE % (2 * threads) == 0 and threads % 32 == 0
    assert fd.COMPACT_TILE // (2 * threads) * (threads // 32) == 32
    assert fd.SORT_TILE % fd.COMPACT_TILE == 0
    assert "#define DU_WARP_KEYS (32 * DU_E)" in text
    assert int(defines["DM_CHUNK"]) == fd.MERGE_CHUNK
    assert fd.MERGE_CHUNK % int(defines["DM_PAD"]) == 0
    assert fd.MERGE_FAN_MAX <= int(defines["DM_THREADS"]) // 32  # a warp a run
    assert int(defines["DM_FAN_MAX"]) == fd.MERGE_FAN_MAX
    assert fd.SORT_TILE % fd.MERGE_CHUNK == 0  # a dict_merge block's keys lie in one run
    assert "#define DM_TILE DU_SORT_TILE" in text
    # a whole stride between samples, their count a power of two
    samples, gap = int(defines["DM_SAMPLES"]), int(defines["DM_SAMPLE_GAP"])
    assert samples & (samples - 1) == 0 and (fd.SORT_TILE // gap) & (fd.SORT_TILE // gap - 1) == 0
    assert fd.SORT_TILE % gap == 0 and fd.SORT_TILE // gap <= samples
    assert fd.MERGE_FAN_MAX <= int(defines["DM_THREADS"])  # a thread a run's window
    padded = fd.MERGE_CHUNK + fd.MERGE_CHUNK // int(defines["DM_PAD"])
    static = (padded + fd.MERGE_FAN_MAX * (int(defines["DM_SAMPLES"]) + 4)) * 8 + padded * 4
    stage = int(defines["DM_STAGE"]) + int(defines["DM_STAGE"]) // int(defines["DM_PAD"])
    assert stage * 8 + static <= 232448  # one block an SM: the grid fits the card once
    warp_keys = 32 * fd.KEYS_A_THREAD
    assert fd.TILE_MAX // fd.KEYS_A_THREAD == int(defines["DU_THREADS"])
    pingpong = int(defines["DU_PINGPONG_MAX"])
    for cap in (1, 64, 512, 4096, fd.CAP_MAX):
        tile = fd.union_tile(cap)
        assert tile & (tile - 1) == 0 and warp_keys <= tile <= fd.TILE_MAX
        smem = (2 if tile <= pingpong else 1) * (tile + tile // fd.KEYS_A_THREAD) * 8
        assert smem <= 232448
    for tile in (fd.SORT_TILE, fd.TILE_MIN):
        assert tile & (tile - 1) == 0 and warp_keys <= tile <= fd.TILE_MAX


def test_union_passes_follow_the_tile():
    """The tile route's passes at the tiles it takes: a shard's 131,072
    keys (and the carried 64) at 64 slots take three passes of 1,024-key
    tiles, at 2,048 slots six of 4,096; the sort route's merge passes and
    padded keys follow its tile of 4,096 keys."""
    n = 131_072 + 64
    assert fd.union_tile(64) == fd.TILE_MIN == 1024
    assert fd.union_passes(n, 64) == [n, 129 * 64, 9 * 64]
    assert fd.union_tile(2048) == 4096
    assert fd.union_passes(n, 2048) == [n, 33 * 2048, 17 * 2048, 9 * 2048, 5 * 2048, 3 * 2048,
                                        2 * 2048]
    assert fd.union_passes(100, 64) == [100]
    assert fd.sorted_keys(163_840) == 163_840 and fd.sorted_keys(1) == fd.SORT_TILE == 4096
    assert fd.merge_plan(163_840) == [(4096, 8), (8 * 4096, 5)]
    assert fd.merge_plan(1 << 18) == [(4096, 8), (8 * 4096, 8)]
    assert fd.merge_plan((1 << 18) + 1) == [(4096, 8), (8 * 4096, 3), (24 * 4096, 3)]
    assert fd.merge_plan(5 * 4096) == [(4096, 5)]
    assert len(fd.merge_plan(1 << 24)) == 4  # each doubling past 64 runs: at most one level more
    assert fd.union_launches(163_840, 32768) == {
        "dict_union": 1, "dict_merge": 2, "dict_compact": 1}
    # the compaction's grid: a block a tile, 80 and 128 at the mesh's unions
    assert fd.compact_tiles(163_840) == 80 and fd.compact_tiles(262_144) == 128
    assert fd.compact_tiles(0) == 1 and fd.compact_tiles(fd.COMPACT_TILE + 1) == 2


@pytest.mark.parametrize("name", fx.UNION_EDGE_CASES)
def test_union_edge_cases_keep_the_smallest_distinct_keys(name):
    """Each input of the kernel's edges (``fx.union_edge_case``) through
    ``dict_union_plain`` against ``np.unique``, cut to ``cap``; the flag
    exactly when there are more distinct keys."""
    d, keys, cap = fx.union_edge_case(name)
    got, over = fd.dict_union_plain(d, keys, cap)
    want, want_over = _union_numpy(np.zeros(0, np.int64) if d is None else d.numpy(),
                                   keys.numpy(), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert over == want_over


@settings(max_examples=25, deadline=None)
@given(st.integers(fd.CAP_MAX + 1, 40_000), st.integers(0, 3000), st.integers(1, 60_000),
       st.integers(0, 2**32 - 1))
def test_sort_route_keeps_the_smallest_distinct_keys(cap, n, spread, seed):
    """The sort route of dict_union past 8,192 slots (tiles sorted, runs
    merged pairwise, distinct keys compacted) gives ``np.unique`` cut to
    ``cap`` and overflows exactly when there are more, the carried
    dictionary included."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, spread, n)
    keys[rng.random(n) < 0.2] = fd.SENTINEL
    d, _o = _union_numpy(np.zeros(0, np.int64), rng.integers(0, spread, 500), cap)
    want, over = _union_numpy(d, keys, cap)
    got, got_over = fd.dict_union_plain(torch.from_numpy(d), torch.from_numpy(keys), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_over == over


def test_merge_and_compact_plain_versions():
    """dict_merge's plain version merges sorted runs F at a time (a short
    last run too, and a last group of one run); dict_compact's keeps the
    first cap distinct keys."""
    rng = np.random.default_rng(8)
    runs = [np.sort(rng.integers(0, 50, w)) for w in (8, 8, 8, 5)]
    got = fd.merge_pass_plain(torch.from_numpy(np.concatenate(runs)), 8, 2).numpy()
    np.testing.assert_array_equal(got[:16], np.sort(np.concatenate(runs[:2])))
    np.testing.assert_array_equal(got[16:], np.sort(np.concatenate(runs[2:])))
    got = fd.merge_pass_plain(torch.from_numpy(np.concatenate(runs)), 8, 3).numpy()
    np.testing.assert_array_equal(got[:24], np.sort(np.concatenate(runs[:3])))
    np.testing.assert_array_equal(got[24:], runs[3])
    s = np.sort(np.concatenate([rng.integers(0, 30, 100), [fd.SENTINEL] * 9]))
    out, over = fd.compact_plain(torch.from_numpy(s), 20)
    np.testing.assert_array_equal(out.numpy(), np.unique(s)[:20])
    assert over
    out, over = fd.compact_plain(torch.from_numpy(s), 40)
    u = np.unique(s)[:-1]
    np.testing.assert_array_equal(out.numpy()[: len(u)], u)
    assert (out.numpy()[len(u):] == fd.SENTINEL).all() and not over


@pytest.mark.parametrize("name", fx.COMPACT_EDGE_CASES)
def test_compaction_edges_keep_the_smallest_distinct_keys(name):
    """The sort route's compaction at the edges of dict_compact
    (``fx.compact_edge_case``: equal keys across a tile boundary, all
    sentinel, exactly cap and cap + 1 distinct keys, one sort tile, the mesh
    path's 163,840 and 262,144 keys): ``compact_plain`` of the sorted keys
    and ``dict_union_plain`` of them shuffled against ``np.unique`` cut to
    ``cap``, the flag exactly when there are more."""
    s, cap = fx.compact_edge_case(name)
    want, want_over = _union_numpy(np.zeros(0, np.int64), s.numpy(), cap)
    got, over = fd.compact_plain(s.clone(), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert over == want_over
    shuffled = torch.from_numpy(np.random.default_rng(1).permutation(s.numpy()))
    got, over = fd.dict_union_plain(None, shuffled, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert over == want_over
    if name == "tile_boundary_run":  # the run really crosses the tile
        t = fd.COMPACT_TILE
        assert s[t - 1] == s[t] < fd.SENTINEL and s[2 * t - 1] == s[2 * t]


def _sort_route_input(case, rng):
    """Keys of the sort route at one of its edges, sorted into tiles as
    ``dict_union`` leaves them: ``ragged`` (n not a multiple of the tile),
    ``sentinel`` (runs mostly sentinel-padded), ``all_equal``, ``wide``
    (the mesh path's 163,840 keys)."""
    n, spread, sentinel_p = {"ragged": (5 * fd.SORT_TILE + 777, 1 << 40, 0.1),
                             "sentinel": (9 * fd.SORT_TILE, 5000, 0.97),
                             "all_equal": (12 * fd.SORT_TILE - 1, 1, 0.0),
                             "wide": (163_840, 60_000, 0.2)}[case]
    keys = rng.integers(0, spread, n)
    keys[rng.random(n) < sentinel_p] = fd.SENTINEL
    return torch.from_numpy(keys)


@pytest.mark.parametrize("case", ["ragged", "sentinel", "all_equal", "wide"])
def test_sort_route_merge_levels_sort_the_tiles(case):
    """The tiles ``dict_union`` sorts at the sort route (distinct keys,
    sentinel-padded), merged by ``merge_plan``'s levels: after each level
    every group of F runs is one sorted run, the last level's output is the
    sorted keys, and the union equals ``np.unique`` cut to ``cap``."""
    keys = _sort_route_input(case, np.random.default_rng(len(case)))
    s = fd.union_pass_plain(keys, fd.SORT_TILE, fd.SORT_TILE)[0].reshape(-1)
    want = torch.sort(s).values
    plan = fd.merge_plan(keys.numel())
    assert len(plan) <= 2
    for w, f in plan:
        s = fd.merge_pass_plain(s, w, f)
        for a0 in range(0, s.numel(), w * f):
            g = s[a0 : a0 + w * f]
            assert bool((g[1:] >= g[:-1]).all())
    assert torch.equal(s, want)
    cap = fd.CAP_MAX + 1
    got, over = fd.dict_union_plain(None, keys, cap)
    want_u, want_over = _union_numpy(np.zeros(0, np.int64), keys.numpy(), cap)
    np.testing.assert_array_equal(got.numpy(), want_u)
    assert over == want_over


@pytest.mark.parametrize("case", ["all_equal", "sentinel", "ragged"])
def test_sort_route_edges_match_jax(case):
    """The sort route's edges through the evaluator at 16,384 slots against
    the JAX evaluator and the oracle: every row of one group, a selection
    that keeps 1% of the rows (runs of sentinels), and super-blocks whose
    valid rows are not a multiple of the tile."""
    groups = 2
    rows = N // (8 // groups)
    rng = np.random.default_rng(7)
    key = {"all_equal": np.full(N, 7), "sentinel": C, "ragged": C}[case]
    low = np.where(rng.random(N) < 0.01, 5, 900) if case == "sentinel" else A
    n_valid = N - 1111 if case == "ragged" else N
    out, _ev = _both(grouped_dag(), groups, rows, 16384,
                     [(_columns(N, {1: low, 2: key, 3: C}), n_valid)] * 2)
    assert not out["overflow"]
    valid = np.arange(N) < n_valid
    mask = np.concatenate([(low < 800) & valid] * 2)
    _check_oracle(out, mask, np.concatenate([key] * 2), value=np.concatenate([C] * 2),
                  low=np.concatenate([low] * 2))


@pytest.mark.parametrize("groups", [1, 2])
def test_device_group_dict_past_8192_slots_matches_jax(groups):
    """A dictionary of 16,384 slots (the union's sort route, the grouped
    pair's wide route on every shard) over ~3,300 distinct keys: equal to
    the JAX evaluator and the oracle; at 8,200 slots over more distinct keys
    than that, the capacity flag is raised as the JAX one's."""
    rows = N // (8 // groups)
    out, _ev = _both(grouped_dag(), groups, rows, 16384,
                     [(_columns(N, {1: A, 2: C, 3: C}), N)])
    assert not out["overflow"] and len(out["keys"]) > 3000
    _check_oracle(out, A < 800, C)
    rng = np.random.default_rng(groups)
    blocks = []
    for _b in range(3):
        key = rng.integers(0, 1 << 20, N)
        blocks.append((_columns(N, {1: A, 2: key, 3: C}), N))
    out, _ev = _both(grouped_dag(), groups, rows, 8200, blocks)
    assert out["overflow"]


def test_dict_ids_plain_is_a_clipped_searchsorted():
    rng = np.random.default_rng(3)
    live = np.sort(rng.choice(1000, 40, replace=False))
    new = np.concatenate([live, np.full(24, fd.SENTINEL)])
    keys = np.concatenate([rng.integers(0, 1100, 500), [fd.SENTINEL] * 5])
    old = np.concatenate([live[::3], np.full(64 - len(live[::3]), fd.SENTINEL)])
    ids, perm = fd.dict_ids_plain(torch.from_numpy(new), torch.from_numpy(keys),
                                  torch.from_numpy(old))
    np.testing.assert_array_equal(ids.numpy(), np.clip(np.searchsorted(new, keys), 0, 63))
    np.testing.assert_array_equal(perm.numpy(), np.where(old < fd.SENTINEL,
                                                         np.searchsorted(new, old), 64))
    assert ids.dtype == perm.dtype == torch.int32
    full = np.arange(64, dtype=np.int64)  # a full dictionary clips a larger key to the end
    ids, none = fd.dict_ids_plain(torch.from_numpy(full), torch.tensor([70, fd.SENTINEL]))
    assert list(ids) == [63, 63] and none is None


def test_dict_keys_plain_packs_as_numpy():
    prog, img, _old = fx.dict_case(3000, 64, 20, 1, "cpu", bad=True)
    keys, bad = fd.dict_keys_plain(prog, img)
    k1, k2, v = (c.reshape(-1).numpy() for c in img.cols)
    null1 = img.nulls[0].reshape(-1).numpy()
    lane_max = (1 << 20) - 1
    t2 = np.trunc(k2).astype(np.int64)
    active = (v < 800) & (np.arange(3000) < 3000 - 7)
    want = (np.where(null1, lane_max, k1) << 20) | (t2 & lane_max)
    np.testing.assert_array_equal(keys.numpy(), np.where(active, want, fd.SENTINEL))
    assert bad == bool((active & (t2 < 0)).any()) and bad


@pytest.mark.parametrize("name", list(fx.KEY_EDGE_CASES))
def test_dict_keys_edge_cases_pick_their_instance(name):
    """Each dict_keys edge case runs the instance of the stack slots it was
    built for (the fewest of 2, 4 or 8 that hold its plan, as
    ``fused_agg.stack_slots`` picks them), and the plain version ends with
    the range flag the case names: a selected NaN or infinite REAL key or a
    run value past its lane sets it; -0.0 and values in the lane do not."""
    slots, flagged = fx.KEY_EDGE_CASES[name]
    prog, img = fx.key_edge_case(name, "cpu")
    assert fd.key_slots(prog) == fa.stack_slots([prog.code]) == slots
    flag = torch.zeros(1, dtype=torch.int32)
    keys = fd.dict_keys(prog, img, flag)
    assert bool(int(flag) & fd.FLAG_RANGE) == flagged
    live = int((keys < fd.SENTINEL).sum())
    assert 0 < live < keys.numel()  # some rows selected, some not


def test_dict_keys_in_range_case_packs_as_numpy():
    """``ragged_in_range`` through the plain version against numpy: the REAL
    key's NaN and infinite rows are dropped by the selection, -0.0
    truncates to 0, a NULL packs as lane_max, rows past a block's n_valid
    (inside a tile: 998 and 5 of 1,001) are the sentinel."""
    prog, img = fx.key_edge_case("ragged_in_range", "cpu")
    keys, bad = fd.dict_keys_plain(prog, img)
    c0, c2, c3 = (img.cols[j].numpy() for j in (0, 2, 3))
    n2, n3 = img.nulls[2].numpy(), img.nulls[3].numpy()
    nv = img.n_valids.numpy()
    valid = np.arange(img.block_rows)[None, :] < nv[:, None]
    with np.errstate(invalid="ignore"):
        sel = valid & ~n2 & (c2 >= 0.0) & (c2 < 1000.0)
        t2 = np.where(n2 | ~np.isfinite(c2), 0, c2).astype(np.int64)
    lane_max = prog.lane_max
    want = np.where(n2, lane_max, t2)
    want = (want << 20) | np.where(n3, lane_max, c3)
    want = (want << 20) | (c0 & 1023)
    np.testing.assert_array_equal(keys.numpy(), np.where(sel, want, fd.SENTINEL).reshape(-1))
    assert not bad


def test_dict_keys_refuses_a_plan_deeper_than_its_instances():
    """A key plan deeper than the tile walk's 8 slots raises ``ValueError``
    on either device, before any launch (the emitter refuses such plans;
    this one is written by hand)."""
    prog, img = fx.key_edge_case("ragged_s8", "cpu")
    deep = prog.code + (fa.OP_COL,) * 9 + (fa.OP_PLUS,) * 8 + (fa.OP_FILTER,)
    bad = dataclasses.replace(prog, code=deep)
    assert fa.stack_depth(deep) == 9
    with pytest.raises(ValueError, match="dict_keys"):
        fd.key_slots(bad)
    with pytest.raises(ValueError, match="dict_keys"):
        fd.dict_keys(bad, img, torch.zeros(1, dtype=torch.int32))


def test_dict_keys_tile_matches_the_cuda_source():
    """dict_keys' tile (rows a thread) in csrc/fused_dict.cu against the
    wrapper's, its instances of 2, 4 and 8 stack slots, and its launcher's
    pick from the plan's code (fa_stack_slots of csrc/fa_walk.cuh)."""
    import re
    from pathlib import Path

    csrc = Path(fd.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "fused_dict.cu").read_text()
    walk = (csrc / "fa_walk.cuh").read_text()
    assert int(re.search(r"#define DK_ROWS (\d+)", text).group(1)) == fd.KEY_ROWS == 4
    for slots in (2, 4, fa.MAX_STACK):
        assert f"case {slots}: return dict_keys<{slots}>;" in text
    assert "const int slots = fa_stack_slots(*p);" in text and "dk_kernel(slots)" in text
    assert "depth <= 2 ? 2 : depth <= 4 ? 4 : depth <= FA_MAX_STACK ? 8 : 0" in walk
    assert "fa_walk_keys" not in walk + text  # the one-row key walk is gone


def test_mesh_merge_remap_is_a_scatter_of_the_carry():
    """mesh_merge's plain version with a perm: the carry's slot i moves to
    slot perm[i] (the first of two on one slot, none past the end), the
    identity elsewhere, then combines with the folded parts."""
    prog, parts, table, carry = fx.mesh_merge_case(4, 1, 16, 3, "cpu")
    perm = fx.merge_perm(16, 5, "cpu")
    got = fused_mesh.mesh_merge(prog, parts, table, carry, perm=perm)
    folded = fused_mesh.mesh_merge(prog, parts, table)
    p = perm.numpy()
    for leaf in prog.leaves:
        m = 1 if leaf.is_f64 else 0
        moved = np.full(16, leaf.ident_value, dtype=carry[m].numpy().dtype)
        for i in range(15, -1, -1):  # the first slot wins
            if p[i] < 16:
                moved[p[i]] = carry[m][0, leaf.slot, i].item()
        want = fused_mesh.ga._merge(leaf, torch.from_numpy(moved),
                                    folded[m][0, leaf.slot])
        torch.testing.assert_close(got[m][0, leaf.slot], want, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError):
        fused_mesh.mesh_merge(prog, parts, table, carry, 0, 8, perm=perm)


# ---------------------------------------------------------------------------
# dict_ids: the shared table, its stride, the perm beside the keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cap", [1, 3, 64, 8192, 8193, 32768, 100_000, 262_144])
def test_ids_plain_version_gives_searchsorted(cap):
    """dict_ids on the CPU (its plain version) at every capacity the kernel
    splits by (the shared copy up to CAP_MAX slots, the table past it):
    searchsorted's (left) ids clipped to cap - 1 and each old slot's place,
    for fx.ids_case's keys and for dense keys (a run of integers) from below
    the first to past the last, with the sentinel."""
    new, keys, old = fx.ids_case(cap, 5001, "sentinels", cap, "cpu")
    live = max(1, cap - cap // 3)
    dense = np.full(cap, fd.SENTINEL, dtype=np.int64)
    dense[:live] = np.arange(5, 5 + live)
    x = np.concatenate([np.arange(0, live + 10), [fd.SENTINEL, fd.SENTINEL - 1]])
    for d, k, o in ((new, keys, old), (torch.from_numpy(dense), torch.from_numpy(x), old)):
        gids = torch.empty(k.numel(), dtype=torch.int32)
        perm = torch.empty(cap, dtype=torch.int32)
        fd.dict_ids(d, k, gids, o, perm)
        want = np.searchsorted(d.numpy(), k.numpy(), side="left")
        np.testing.assert_array_equal(gids.numpy(), np.minimum(want, cap - 1))
        on = o.numpy()
        np.testing.assert_array_equal(
            perm.numpy(), np.where(on < fd.SENTINEL, np.searchsorted(d.numpy(), on), cap))


@pytest.mark.parametrize("old_kind", fx.IDS_OLD)
def test_ids_case_through_the_plain_version(old_kind):
    """fx.ids_case's inputs through dict_ids on the CPU (its plain version):
    ids clipped to cap - 1, sentinel keys at cap - 1, each old slot's place
    in the new dictionary and cap for a sentinel slot; "same" keeps every
    slot and "moves" moves every one."""
    cap = 8193
    new, keys, old = fx.ids_case(cap, 3001, old_kind, 7, "cpu")
    gids = torch.empty(keys.numel(), dtype=torch.int32)
    perm = None if old is None else torch.empty(cap, dtype=torch.int32)
    fd.dict_ids(new, keys, gids, old, perm)
    d, k = new.numpy(), keys.numpy()
    np.testing.assert_array_equal(gids.numpy(), np.minimum(np.searchsorted(d, k), cap - 1))
    live = int((d < fd.SENTINEL).sum())
    assert (gids.numpy()[k == fd.SENTINEL] == min(live, cap - 1)).all()
    if old is None:
        return
    o = old.numpy()
    want = np.where(o < fd.SENTINEL, np.searchsorted(d, o), cap)
    np.testing.assert_array_equal(perm.numpy(), want)
    if old_kind == "same":
        np.testing.assert_array_equal(perm.numpy()[:live], np.arange(live))
    if old_kind == "moves":
        assert (perm.numpy() != np.arange(cap)).all()
    if old_kind == "sentinels":
        assert (o == fd.SENTINEL).any() and (perm.numpy() == cap).any()


def test_ids_constants_match_the_cuda_source():
    """DI_SMEM_KEYS of csrc/fused_dict.cu against the wrapper's CAP_MAX; one
    instance with the device-memory tail and one without; the table within
    the default shared memory a block."""
    import re
    from pathlib import Path

    text = (Path(fd.__file__).resolve().parent.parent / "csrc" / "fused_dict.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", text))
    assert int(defines["DI_SMEM_KEYS"]) == fd.CAP_MAX
    assert "dict_ids<true>" in text and "dict_ids<false>" in text
    assert int(defines["DI_SPLITS"]) * 8 <= 48 * 1024 and fd.CAP_MAX * 8 <= 232448
