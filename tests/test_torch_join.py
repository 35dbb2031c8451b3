"""The join rung: the port's ``copr/torch_join.py`` against the JAX package's.

Programs #14 and #15 (``jax_join.rank``, ``jax_join.hash``): the port's plain
``rank_probe`` and ``hash_probe`` equal the reference's ``_rank_probe`` and
``_hash_probe`` run through ``jax.jit`` on the CPU, on keys with duplicates,
misses, negative keys, keys near +-2**63 and a table small enough to collide;
the port's ``_build_hash_table`` equals the reference's.  Then the plan pool
of ``tests/test_device_join.py`` (inner joins; shared, disjoint and
overlapping dictionaries and int keys; bare, Selection, Projection + Limit
and TopN downstreams) over encoded and decoded images built from the same
blocks: on every feasible path the port's response bytes equal
``jax_join.serve``'s and the reference CPU pipeline's.  The zone-pruned case
gives the reference's (examined, pruned) pair, every reachable decline the
reference's cause, the rank path leaves the build's encoded payloads
undecoded, and a join plan survives the wire both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encoding import jax_cache, port_cache
from tikv_tpu.copr import jax_join
from tikv_tpu.copr.dag import (
    ENC_TYPE_CHUNK,
    Aggregation,
    DagRequest,
    IndexScan,
    Join,
    Limit,
    Projection,
    Selection,
    TableScan,
    TopN,
    build_executors,
    make_response_encoder,
)
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.encoding import EncodedColumn as JaxEncodedColumn
from tikv_tpu.copr.executors import CachedBlocksExecutor
from tikv_tpu.copr.rpn import call, col, const_int
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_join, torch_join, zone_maps
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.dag_wire import dag_from_wire
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_dag_to_wire
from tikv_tpu_torch.copr.encoding import EncodedColumn
from tikv_tpu_torch.copr.torch_eval import decline_cause

INT, BYTES, REAL = "int", "bytes", "real"
PT, BT = 101, 102  # probe and build tables
COLUMNS = [
    ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
    ColumnInfo(2, FieldType.varchar()),
    ColumnInfo(3, FieldType.int64()),
    ColumnInfo(4, FieldType.int64()),
]


def _dictionary(values):
    d = np.empty(len(values), dtype=object)
    d[:] = values
    return d


CATS = _dictionary([b"alpha", b"beta", b"delta", b"eps", b"gamma"])  # sorted
BUILDS = {
    "shared": CATS,  # the probe's own dictionary object: the identity remap
    "disjoint": _dictionary([b"iota", b"theta", b"zeta"]),  # no value in common
    "overlap": _dictionary([b"beta", b"eps", b"omega"]),  # sorted, partly shared
}


def _table(n, dictionary, seed, block_rows, null_p=0.1):
    """Blocks of ``(id, category, small int, wide int)``: the category as
    codes of ``dictionary``, NULLs in the category and the small int."""
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    cat = rng.integers(0, len(dictionary), n)
    cat_nulls = rng.random(n) < null_p
    small = rng.integers(0, 9, n)
    small_nulls = rng.random(n) < null_p
    wide = rng.integers(0, 1 << 20, n)
    out = []
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        out.append(([(INT, ids[s:e], nz, 0, None),
                     (BYTES, np.where(cat_nulls[s:e], 0, cat[s:e]), cat_nulls[s:e], 0, dictionary),
                     (INT, np.where(small_nulls[s:e], 0, small[s:e]), small_nulls[s:e], 0, None),
                     (INT, wide[s:e], nz, 0, None)], e - s))
    return out


def _caches(probe_blocks, build_blocks, encode):
    """(JAX probe, JAX build, port probe, port build) over the same blocks."""
    return (jax_cache(probe_blocks, encode)[0], jax_cache(build_blocks, encode)[0],
            port_cache(probe_blocks, encode)[0], port_cache(build_blocks, encode)[0])


def _jdag(lk=1, rk=1, extra=(), jt="inner", below=(), build_extra=(), encode_type=0):
    return DagRequest(executors=[
        TableScan(PT, COLUMNS), *below,
        Join([TableScan(BT, COLUMNS), *build_extra], [], lk, rk, join_type=jt,
             build_context={"region_id": 8, "region_epoch": (1, 1), "apply_index": 3}),
        *extra,
    ], encode_type=encode_type)


def _cpu_pipeline(dag, jprobe, jbuild) -> bytes:
    """The reference CPU pipeline over the two JAX caches."""
    ex = build_executors(dag, None,
                         leaf=CachedBlocksExecutor(jprobe, dag.executors[0].columns_info),
                         build_leaf=CachedBlocksExecutor(jbuild, COLUMNS))
    enc = make_response_encoder(dag)
    batch = 32
    while True:
        r = ex.next_batch(batch)
        if r.chunk.num_rows:
            enc.add_chunk(r.chunk, dag.output_offsets)
        if r.is_drained:
            break
        batch = min(batch * 2, 1024)
    return enc.to_response().encode()


def _port(dag, pprobe, pbuild, prefer):
    return torch_join.serve(dag_from_wire(dag_to_wire(dag)), pprobe, pbuild, prefer=prefer,
                            device="cpu")


# ---------------------------------------------------------------------------
# the kernels' plain versions against the reference's programs
# ---------------------------------------------------------------------------

EDGE = np.array([-(1 << 63) + 1, -(1 << 63) + 2, -(1 << 62), -7, -1, 0, 1, 5,
                 (1 << 62), (1 << 63) - 2, (1 << 63) - 1], dtype=np.int64)


def _key_case(seed, n_build, n_probe):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([EDGE, rng.integers(-(1 << 63), (1 << 63) - 1, 40, dtype=np.int64),
                           rng.integers(-50, 50, 60)])
    build = np.sort(rng.choice(pool, n_build))  # duplicates, negatives, extremes
    probe = np.concatenate([rng.choice(pool, n_probe - 8), np.full(4, -1), EDGE[:4]])
    return build, probe


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_probe_plain_equals_the_reference(seed):
    build, probe = _key_case(seed, 300, 500)
    got = fused_join.rank_probe(torch.from_numpy(build), torch.from_numpy(probe))
    want = jax.jit(jax_join._rank_probe)(jnp.asarray(build), jnp.asarray(probe))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0


def _unique_spans(sorted_keys):
    lead = np.ones(len(sorted_keys), dtype=bool)
    lead[1:] = sorted_keys[1:] != sorted_keys[:-1]
    ustarts = np.flatnonzero(lead).astype(np.int64)
    return sorted_keys[ustarts], ustarts, np.diff(np.append(ustarts, len(sorted_keys)))


@pytest.mark.parametrize("seed,n_build", [(0, 300), (1, 3), (2, 1000)])
def test_hash_table_and_probe_plain_equal_the_reference(seed, n_build):
    build, probe = _key_case(seed, n_build, 700)
    ukeys, ustarts, ucounts = _unique_spans(build)
    got_t = torch_join._build_hash_table(ukeys, ustarts, ucounts)
    want_t = jax_join._build_hash_table(ukeys, ustarts, ucounts)
    for g, w in zip(got_t, want_t):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # load <= 0.5 in a small table: collisions walk
    size = len(got_t[0])
    home = fused_join.hash_slots(torch.from_numpy(ukeys), size.bit_length() - 1).numpy()
    assert len(np.unique(home)) < len(ukeys) or len(ukeys) < 4
    probe = probe.copy()
    probe[:3] = fused_join.EMPTY  # NULL / unmapped probes
    got = fused_join.hash_probe(*(torch.from_numpy(a) for a in (*got_t, probe)))
    want = jax.jit(jax_join._hash_probe)(*(jnp.asarray(a) for a in (*want_t, probe)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1][:3].sum()) == 0 and int(got[1].sum()) > 0


@pytest.mark.parametrize("log2_size", [3, 10, 31, 62])
def test_hash_slots_equal_the_uint64_slots(log2_size):
    rng = np.random.default_rng(log2_size)
    keys = np.concatenate([EDGE, rng.integers(-(1 << 63), (1 << 63) - 1, 500, dtype=np.int64),
                           -rng.integers(1, 1 << 40, 100)])
    want = ((keys.astype(np.uint64) * np.uint64(fused_join.MULT))
            >> np.uint64(64 - log2_size)).astype(np.int64)
    got = fused_join.hash_slots(torch.from_numpy(keys), log2_size).numpy()
    np.testing.assert_array_equal(got, want)


def test_sentinel_build_key_declines():
    with pytest.raises(torch_join.JoinDecline) as exc:
        torch_join._build_hash_table(np.array([fused_join.EMPTY, 3], dtype=np.int64),
                                     np.array([0, 1]), np.array([1, 1]))
    assert exc.value.cause == "sentinel_key"


def test_wrappers_refuse_other_devices():
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no join_rank_probe"):
        fused_join.rank_probe(meta, meta)
    with pytest.raises(ValueError, match="no join_hash_probe"):
        fused_join.hash_probe(meta, meta, meta, meta)
    cpu = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        fused_join.launch_rank(cpu, cpu, cpu, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        fused_join.launch_hash(cpu, cpu, cpu, cpu, cpu, cpu)


# ---------------------------------------------------------------------------
# the plan pool, byte for byte
# ---------------------------------------------------------------------------

DOWNSTREAMS = {
    "bare": (),
    "selection": (Selection([call("gt", col(6), const_int(2))]),),
    "projection_limit": (Projection([call("plus", col(0), col(4)), col(1), col(7)]), Limit(41)),
    "topn": (TopN([(col(7), True), (col(0), False)], 23),),
}
KEYS = {  # key form -> (left key, right key, build table, feasible paths)
    "shared_dict": (1, 1, "shared", ("rank", "hash")),
    "disjoint_dict": (1, 1, "disjoint", ("rank", "hash")),
    "overlap_dict": (1, 1, "overlap", ("rank", "hash")),
    "int": (2, 2, "shared", ("hash",)),
}
_POOL = {}


def _pool_caches(build, encode):
    key = (build, encode)
    if key not in _POOL:
        _POOL[key] = _caches(_table(240, CATS, 11, 64), _table(90, BUILDS[build], 12, 32), encode)
    return _POOL[key]


@pytest.mark.parametrize("encode", [True, False], ids=["encoded", "decoded"])
@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("downstream", list(DOWNSTREAMS))
def test_join_pool_is_byte_identical_to_jax_and_the_cpu_pipeline(downstream, keys, encode):
    lk, rk, build, paths = KEYS[keys]
    dag = _jdag(lk, rk, extra=DOWNSTREAMS[downstream])
    jprobe, jbuild, pprobe, pbuild = _pool_caches(build, encode)
    want = _cpu_pipeline(dag, jprobe, jbuild)
    for path in paths:
        resp, served, stats = _port(dag, pprobe, pbuild, path)
        assert served == path
        assert resp.encode() == want, f"port, {path} path, vs the CPU pipeline"
        jresp, jpath, jstats = jax_join.serve(dag, jprobe, jbuild, prefer=path)
        assert jpath == path
        assert jresp.encode() == want, f"JAX, {path} path, vs the CPU pipeline"
        assert (stats["build_rows"], stats["probe_rows"], stats["out_rows"], stats["prune"]) \
            == (jstats["build_rows"], jstats["probe_rows"], jstats["out_rows"], jstats["prune"])
    if keys == "disjoint_dict":
        assert stats["out_rows"] == 0
    elif downstream == "bare":
        assert stats["out_rows"] > 0


@pytest.mark.parametrize("encode", [True, False], ids=["encoded", "decoded"])
def test_join_pairs_follow_the_cpu_join_order(encode):
    """The pairs serve expands are the CPU join's: probe stream order, build
    rows in row order within a probe row's matches (the fixture's oracle)."""
    a, pc, bc = fx.join_caches(3000, 5, key="dict", encode=encode, block_rows=256)
    want = fx.join_oracle(a)
    for key, caches in (("dict", (pc, bc)), ("int", fx.join_caches(3000, 5, "int", encode,
                                                                     256)[1:])):
        for path in ("rank", "hash") if key == "dict" else ("hash",):
            pairs = torch_join.join_pairs(fx.join_dag(key=key), *caches, prefer=path,
                                          device="cpu")
            np.testing.assert_array_equal(pairs.probe_rows(), want[0])
            np.testing.assert_array_equal(pairs.build_rows(), want[1])
            for down in (False, True):
                dag = fx.join_dag(fx.join_downstream() if down else (), key=key)
                resp = torch_join.serve(dag, *caches, prefer=path, device="cpu")[0]
                assert resp.encode() == fx.join_oracle_bytes(a, want, key, down)


# ---------------------------------------------------------------------------
# zone pruning, declines, late materialization, the wire
# ---------------------------------------------------------------------------

def _range_blocks(keys, block_rows):
    n = len(keys)
    cats = np.arange(n) % 5
    out = []
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        nz = np.zeros(e - s, dtype=bool)
        out.append(([(INT, np.arange(s, e, dtype=np.int64), nz, 0, None),
                     (BYTES, cats[s:e], nz, 0, CATS),
                     (INT, keys[s:e].astype(np.int64), nz, 0, None),
                     (INT, np.arange(s, e, dtype=np.int64) * 3, nz, 0, None)], e - s))
    return out


@pytest.mark.parametrize("encode", [True, False], ids=["encoded", "decoded"])
def test_zone_maps_prune_join_blocks_as_the_reference(encode):
    """Int keys 0..255 against 100..163: the blocks whose key ranges cannot
    meet the other side prune, as the reference prunes them."""
    jp, jb, pp, pb = _caches(_range_blocks(np.arange(256), 32),
                             _range_blocks(np.arange(64) + 100, 32), encode)
    dag = _jdag(2, 2)
    before = dict(zone_maps.PRUNE_COUNTS)
    resp, _path, stats = _port(dag, pp, pb, None)
    jresp, _jpath, jstats = jax_join.serve(dag, jp, jb)
    assert resp.encode() == jresp.encode() == _cpu_pipeline(dag, jp, jb)
    assert stats["prune"] == jstats["prune"] == jresp._obs_prune
    examined, pruned = stats["prune"]
    assert examined == 10 and pruned > 0
    assert zone_maps.PRUNE_COUNTS["join", "pruned"] - before.get(("join", "pruned"), 0) == pruned
    assert zone_maps.PRUNE_COUNTS["join", "examined"] \
        - before.get(("join", "examined"), 0) == examined


def _decline_cases():
    """(name, dag, probe blocks, build blocks, path, encode) per cause."""
    probe = _table(60, CATS, 3, 32)
    build = _table(30, CATS, 4, 16)
    unsorted = _table(30, _dictionary([b"gamma", b"alpha", b"beta"]), 5, 16)
    unstable = _table(30, CATS, 6, 16)
    cols = list(unstable[1][0])
    cols[1] = (BYTES, cols[1][1], cols[1][2], 0, _dictionary(list(CATS)))  # an equal copy
    unstable[1] = (cols, unstable[1][1])
    objects = [([c if i != 1 else (BYTES, CATS[c[1]], c[2], 0, None) for i, c in enumerate(cs)],
                n) for cs, n in probe]
    sentinel = _range_blocks(np.array([5, -(1 << 63), 7, 9]), 2)
    index_leaf = DagRequest(executors=[
        IndexScan(PT, 1, COLUMNS), *_jdag().executors[1:]])
    double = DagRequest(executors=_jdag().executors + _jdag().executors[1:2])
    return {
        "not_join_plan": (DagRequest(executors=[TableScan(PT, COLUMNS), Limit(3)]), probe, build),
        "multi_join": (double, probe, build),
        "leaf_not_table_scan": (index_leaf, probe, build),
        "probe_selection": (_jdag(below=(Selection([call("gt", col(2), const_int(1))]),)),
                            probe, build),
        "outer_join": (_jdag(jt="left"), probe, build),
        "build_selection": (_jdag(build_extra=(Selection([call("le", col(2), const_int(4))]),)),
                            probe, build),
        "key_form_mismatch": (_jdag(1, 2), probe, build),
        "key_type": (_jdag(), objects, build),
        "unstable_dictionary": (_jdag(), probe, unstable),
        "dict_unsorted": (_jdag(), probe, unsorted),
        "sentinel_key": (_jdag(2, 2), _range_blocks(np.arange(8), 4), sentinel),
        "probe_empty_image": (_jdag(), [], build),
        "build_empty_image": (_jdag(), probe, []),
    }


@pytest.mark.parametrize("cause", list(_decline_cases()))
def test_declines_name_the_reference_cause(cause):
    dag, probe, build = _decline_cases()[cause]
    jp, jb, pp, pb = _caches(probe, build, encode=False)
    with pytest.raises(jax_join.JoinDecline) as jexc:
        jax_join.serve(dag, jp, jb)
    assert jexc.value.cause == cause
    with pytest.raises(torch_join.JoinDecline) as exc:
        torch_join.serve(dag_from_wire(dag_to_wire(dag)), pp, pb, device="cpu")
    assert exc.value.cause == cause


@pytest.mark.parametrize("cause,extra,encode_type", [
    ("join_downstream_aggregation", (Aggregation([], [AggDescriptor("count", None)]),), 0),
    ("chunk_encoding_not_ported", (Limit(5),), ENC_TYPE_CHUNK),
    ("op_not_ported", (Selection([call("mod", col(2), const_int(2))]),), 0),
])
def test_port_limits_decline_by_name(cause, extra, encode_type):
    """Where the port declines and the reference serves: the cause is named
    before any key lane decodes."""
    _jp, _jb, pp, pb = _caches(_table(60, CATS, 3, 32), _table(30, CATS, 4, 16), encode=True)
    dag = _jdag(extra=extra, encode_type=encode_type)
    with pytest.raises(torch_join.JoinDecline) as exc:
        torch_join.serve(dag_from_wire(dag_to_wire(dag)), pp, pb, device="cpu")
    assert exc.value.cause == cause
    assert all(c._data is None for b in pp.blocks for c in b.cols if isinstance(c, EncodedColumn))


@pytest.mark.parametrize("path", ["rank", "hash"])
def test_join_decodes_only_survivors(path):
    """The build image's encoded payload columns never fully decode: the key
    lanes decode without caching, the gather decodes the survivors only."""
    jp, jb, pp, pb = _caches(_table(240, CATS, 11, 64), _table(90, BUILDS["overlap"], 12, 32),
                             encode=True)
    enc_cols = [c for b in pb.blocks for c in b.cols if isinstance(c, EncodedColumn)]
    assert enc_cols, "the build image carries no encoded payload column"
    resp, _path, stats = _port(_jdag(), pp, pb, path)
    assert stats["out_rows"] > 0
    assert all(c._data is None for c in enc_cols), "the join decoded a whole encoded column"
    assert resp.encode() == jax_join.serve(_jdag(), jp, jb, prefer=path)[0].encode()
    assert all(c._data is None for b in jb.blocks for c in b.cols
               if isinstance(c, JaxEncodedColumn))


@pytest.mark.parametrize("dag,cause", [
    (_jdag(extra=(Projection([call("plus", col(0), col(4)), col(1)]), Limit(3))),
     "join_executor"),
    (DagRequest(executors=[TableScan(PT, COLUMNS), Projection([col(0), col(1)])]),
     "projection_executor"),
])
def test_wire_round_trip_and_evaluator_decline(dag, cause):
    wire = dag_to_wire(dag)
    port = dag_from_wire(wire)
    assert port_dag_to_wire(port) == wire
    assert decline_cause(port) == cause


def test_prefer_falls_back_to_a_feasible_path():
    """``prefer`` forces a feasible path only: int keys have no rank path,
    and without a preference dictionary keys take rank first."""
    _a, pc, bc = fx.join_caches(500, 2, key="int", encode=False, block_rows=128)
    assert torch_join.serve(fx.join_dag(key="int"), pc, bc, prefer="rank", device="cpu")[1] \
        == "hash"
    _a, pc, bc = fx.join_caches(500, 2, key="dict", encode=False, block_rows=128)
    assert torch_join.serve(fx.join_dag(), pc, bc, device="cpu")[1] == "rank"


def test_empty_cache_declines_without_blocks():
    empty = ColumnBlockCache()
    empty.filled = True
    _a, pc, _bc = fx.join_caches(200, 2, encode=False, block_rows=64)
    with pytest.raises(torch_join.JoinDecline) as exc:
        torch_join.serve(fx.join_dag(), pc, empty, device="cpu")
    assert exc.value.cause == "build_empty_image"
