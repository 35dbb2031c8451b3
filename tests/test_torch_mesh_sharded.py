"""Mesh-sharded warm serving of a cross-region batch (program #20) against
the JAX package.

The port's ``torch_eval.launch_xregion_sharded`` on ``make_mesh(["cpu"] *
8)`` (the plain versions of the batch kernels and of ``mesh_merge``) is held
byte for byte to ``tikv_tpu.parallel.mesh.run_xregion_sharded`` on conftest's
eight virtual CPU devices, to the port's single-device
``run_xregion_cached`` and to the CPU pipeline over the same KV bytes, for
an uneven placement, more regions than devices, a lone block-spread image,
encoded regions (with the run-length decline) and zone-pruned slabs.  No
plan sums a REAL column, so no tolerance is needed.

On the installed JAX, the reference's ``shard_map`` refuses its own scan
carry (the ``check_vma`` replication check), which is why its endpoint falls
back and three of its tests fail (ROADMAP queue 3 E3); here the reference
runs with that static check off (``_smap(..., check=False)``), the program
itself unchanged: its outputs leave through the collectives, replicated by
construction.
"""

import functools

import numpy as np
import pytest

from test_torch_batch import BR, Region, _port_evs, _riders, _schema
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag import Aggregation, DagRequest, Selection, TableScan
from tikv_tpu.copr.jax_eval import JaxDagEvaluator
from tikv_tpu.copr.rpn import call, col, const_int
from tikv_tpu.parallel import mesh as jm
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import encoding
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.torch_eval import launch_xregion_sharded, run_xregion_cached
from tikv_tpu_torch.parallel import mesh as pm

MESH = pm.make_mesh(["cpu"] * 8)


@pytest.fixture(autouse=True)
def reference_without_the_vma_check(monkeypatch):
    smap = jm._smap
    monkeypatch.setattr(jm, "_smap", lambda mesh, i, o, check=True: smap(mesh, i, o, check=False))


def _check(regions, names, jax_differs=False, mesh=MESH):
    """Each plan over the regions on both meshes and alone: the same bytes
    as the CPU pipeline; returns the last plan's pending batch, finalized."""
    pending = None
    br = regions[0].block_rows
    for name in names:
        _n, dag, oracle = _riders([name], nullable=regions[0].nullable)[0]
        ev = _port_evs([dag], block_rows=br)[0]
        caches = [r.pcache for r in regions]
        pending = launch_xregion_sharded(ev, caches, mesh)
        got = pending.finalize()
        jgot = jm.run_xregion_sharded(JaxDagEvaluator(dag, block_rows=br),
                                      [r.jcache for r in regions], jm.make_mesh())
        alone = run_xregion_cached(ev, caches)
        for region, resp, jresp, one in zip(regions, got, jgot, alone):
            want = region.cpu(dag)
            assert resp.encode() == want == one.encode()
            assert (jresp.encode() == want) != jax_differs
            if oracle is not None and not region.nullable:
                assert resp.iter_rows() == oracle(region.arrays)
    return pending


@functools.lru_cache(maxsize=1)
def _uneven():
    regions = [Region(3, 40), Region(1, 41, flags=b"AN"), Region(5, 42), Region(2, 43)]
    owners = [[0, 0, 3], [5], [0, 1, 1, 1, 2], [7, 7]]
    for region, own in zip(regions, owners):
        region.pcache.owner_devices = own
        region.jcache.owner_devices = own
    return regions


def test_an_uneven_placement():
    """Each image's blocks where ``owner_devices`` puts them: a region split
    over three devices, devices holding slabs of three regions, two idle."""
    regions = _uneven()
    assert pm.device_slab_load([r.pcache for r in regions], MESH) == {
        0: 3, 1: 3, 2: 1, 3: 1, 4: 0, 5: 1, 6: 0, 7: 2}
    _check(regions, ["q1", "q6", "group_by_returnflag", "bit_xor_by_linestatus"])


def test_more_regions_than_devices():
    """Eleven regions round-robin over eight devices: three devices hold
    two regions each."""
    regions = [Region(1 + r % 3, 50 + r, flags=b"AN" if r == 4 else b"ANR") for r in range(11)]
    assert pm.slab_assignment([r.pcache for r in regions], MESH)[10] == {2: [0, 1]}
    _check(regions, ["q1", "q6_count_sum_min_max"])


def test_a_lone_image_is_spread_block_by_block():
    region = Region(11, 60)
    assign = pm.slab_assignment([region.pcache], MESH)[0]
    assert assign[0] == [0, 8] and assign[3] == [3] and len(assign) == 8
    _check([region], ["q1", "q6"])


def test_a_mesh_with_groups_shards_slabs_over_every_device():
    mesh = pm.make_mesh(["cpu"] * 8, groups=2)
    assert pm.device_slab_load([Region(11, 61).pcache], mesh) == {
        d: 2 if d < 3 else 1 for d in range(8)}
    _check([Region(3, 62), Region(2, 63)], ["q1"], mesh=mesh)


def test_encoded_regions_ship_encoded():
    regions = [Region(3, 70).encode(), Region(2, 71, flags=b"AN").encode(),
               Region(4, 72).encode()]
    before = encoding.PATH_COUNTS.get(("mesh_sharded", "encoded"), 0)
    pending = _check(regions, ["q1", "q6"])
    assert pending.encoded
    assert encoding.PATH_COUNTS[("mesh_sharded", "encoded")] == before + 2


def test_run_length_lanes_decline_to_a_decoded_ship_and_slabs_prune():
    """A lone date-sorted image, spread block by block: its shipdate is
    run-length encoded, so the batch ships decoded lanes (``rle_sharded``)
    and leaves no decode on the host; Q6's zone maps prune slabs, which ship
    ``n_valid`` 0.  Blocks of 4,096 rows, so that the sorted dates form few
    enough runs."""
    region = Region(6, 81, sort=True, block_rows=4096).encode()
    kinds = {getattr(c, "kind", None) for b in region.pcache.blocks for c in b.cols}
    assert "rle" in kinds
    before = encoding.DECLINE_COUNTS.get(("mesh_sharded", "rle_sharded"), 0)
    pending = _check([region], ["q1", "q6"])
    assert not pending.encoded
    assert encoding.DECLINE_COUNTS[("mesh_sharded", "rle_sharded")] == before + 2
    assert 0 < pending.prunes[0][1] < len(region.pcache.blocks)
    enc_cols = [c for b in region.pcache.blocks for c in b.cols
                if isinstance(c, encoding.EncodedColumn)]
    assert enc_cols and all(c._data is None for c in enc_cols), "decodes left on the host"


def test_null_group_keys_match_the_cpu_pipeline():
    """Nullable keys: the port matches the CPU pipeline, where the
    reference's warm coded ids drop the NULL group (ROADMAP queue 3 C)."""
    _check([Region(2, 90, null_p=0.1), Region(3, 91, null_p=0.1)], ["q1"], jax_differs=True)


def test_slab_pins_are_reused_and_counted():
    regions = [Region(2, 92), Region(1, 93)]
    ev = _port_evs([_riders(["q6"])[0][1]])[0]
    caches = [r.pcache for r in regions]

    def slab_bytes():
        return sum(t.numel() * t.element_size() for c in caches
                   for sig, pins in c.blocks[0].device.items() if sig[0] == "shardslab"
                   for data, nulls in pins.values() for t in list(data) + list(nulls)
                   if t is not None)

    launch_xregion_sharded(ev, caches, MESH).finalize()
    first = slab_bytes()
    launch_xregion_sharded(ev, caches, MESH).finalize()
    assert first == slab_bytes() == 3 * BR * 8 * 4  # 3 blocks of Q6's 4 columns


def test_declines_raise_like_the_reference():
    region = Region(1, 94)
    first = DagRequest(executors=[TableScan(fx.TABLE_ID, _schema(False)),
                                  Aggregation([], [AggDescriptor("first", col(1))])])
    scan = DagRequest(executors=[TableScan(fx.TABLE_ID, _schema(False)),
                                 Selection([call("le", col(4), const_int(9000))])])
    q1 = _riders(["q1"])[0][1]
    empty, jempty = ColumnBlockCache(), type(region.jcache)()
    empty.filled = jempty.filled = True
    cases = ((first, [region], "mesh merge rule"),
             (scan, [region], "requires aggregation DAGs"),
             (q1, [], "at least one region"),
             (q1, [region, "empty"], "empty block cache"))
    for dag, regions, msg in cases:
        with pytest.raises(ValueError, match=msg):
            launch_xregion_sharded(_port_evs([dag])[0],
                                   [empty if r == "empty" else r.pcache for r in regions], MESH)
        with pytest.raises(ValueError, match=msg):
            jm.run_xregion_sharded(JaxDagEvaluator(dag, block_rows=BR),
                                   [jempty if r == "empty" else r.jcache for r in regions],
                                   jm.make_mesh())


def test_the_merged_states_equal_the_single_device_batch():
    """The packed (R, li, C) states of the sharded batch equal
    ``launch_xregion_cached``'s word for word (no REAL sum in Q1)."""
    from tikv_tpu_torch.copr.torch_eval import launch_xregion_cached

    regions = _uneven()
    ev = _port_evs([_riders(["q1"])[0][1]])[0]
    caches = [r.pcache for r in regions]
    sharded = launch_xregion_sharded(ev, caches, MESH)
    single = launch_xregion_cached(ev, caches)
    order = np.argsort(single._order)
    for got, want in zip(sharded._packed, single._packed):
        assert got.shape == want.shape
        assert np.array_equal(got.numpy(), want.numpy()[order])


@pytest.mark.parametrize("var_pop", [False, True], ids=["int", "f64"])
def test_a_sharded_batch_past_the_slots_rides_the_wide_route(var_pop):
    """The four-flag plan (480 coded slots, past a task's shared-memory
    rows; with f64 leaves or without) over regions spread on the mesh: each
    device's tasks are wide, ``mesh_merge`` folds them, and the answers
    equal the single-device batch, the JAX package's sharded batch and the
    CPU pipeline."""
    from test_torch_batch import SuppRegion, _close, _jax_dag

    regions = [SuppRegion(3, 44), SuppRegion(2, 45), SuppRegion(1, 46)]
    for region, own in zip(regions, [[0, 2, 2], [5, 1], [7]]):
        region.pcache.owner_devices = own
        region.jcache.owner_devices = own
    dag = _jax_dag(fx.flags4_dag(var_pop))
    ev = _port_evs([dag])[0]
    caches = [r.pcache for r in regions]
    got = launch_xregion_sharded(ev, caches, MESH).finalize()
    jgot = jm.run_xregion_sharded(JaxDagEvaluator(dag, block_rows=BR),
                                  [r.jcache for r in regions], jm.make_mesh())
    for region, resp, jresp, one in zip(regions, got, jgot, run_xregion_cached(ev, caches)):
        _close(resp, one, "single device")
        _close(resp, jresp, "JAX")
        _close(resp, region.cpu(dag), "CPU pipeline")
        assert len(resp.iter_rows()) > 100
