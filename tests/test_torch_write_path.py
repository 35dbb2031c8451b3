"""The region write path of the port, against the reference and the oracles.

* Write-through deltas (the cases of the reference's
  ``tests/test_write_through.py`` that need neither the endpoint nor raft):
  the same committed ops go to both packages' ``notify_region_write``; the
  requests go three ways as in ``test_torch_region_cache.py``.
* ``mvcc_batch`` against the reference's (its ``tests/test_mvcc_batch.py``
  cases): keys, values, ``row_commit_ts``, ``max_commit_ts``,
  ``versions_exact``, and ``scan_delta``'s result.
* The slice as a whole: a lineitem region written as MVCC versions by the
  port's fixtures (``fixtures.region_engine``), in date order so that zone
  maps prune, served by the port's ``RegionColumnCache`` and
  ``TorchDagEvaluator(device="cpu")`` through in-place updates (rows moving
  into Q6's window inside blocks their zone maps excluded, a new
  l_returnflag value), the same update by write-through, and an
  insert-and-delete batch; after each write Q6, Q1 (zone route and
  ``route_hint="unary"``) and config 2's filter against the numpy oracles,
  and every patched stacked lane equal to a rebuild.
* ``fused_patch``'s plain version and its checks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from copr_fixtures import TABLE_ID, product_engine
from fixtures import delete_committed, lock_key, put_committed, put_committed_large, rollback
from test_torch_region_cache import (
    NON_HANDLE,
    REGION,
    Trio,
    agg_dag,
    assert_pins_equal_a_rebuild,
    port_engine_of,
    product_engine as big_product_engine,
    scan_dag,
    sel_dag,
    stacked_pins,
)

from tikv_tpu.copr import mvcc_batch as jmb
from tikv_tpu.copr import region_cache as jrc
from tikv_tpu.copr.rowv2 import encode_row_v2
from tikv_tpu.copr.table import decode_record_handles, encode_row, record_key, record_range
from tikv_tpu.storage.btree_engine import BTreeEngine
from tikv_tpu.storage.engine import CF_DEFAULT, CF_LOCK, CF_WRITE, WriteBatch
from tikv_tpu.storage.txn_types import Key, Lock, LockType, Write, WriteType
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_patch
from tikv_tpu_torch.copr import mvcc_batch as pmb
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.dag_wire import dag_to_wire
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
from tikv_tpu_torch.storage.mvcc import KeyIsLockedError as PortLockedError


def commit_ops(eng, raw_key, value, start_ts, commit_ts, force_default=False):
    """Apply a committed write to the reference engine and return the op
    tuples the raft apply path emits for it (value None: a DELETE)."""
    k = Key.from_raw(raw_key)
    ops = []
    if value is None:
        w = Write(WriteType.DELETE, start_ts)
    elif len(value) <= 255 and not force_default:
        w = Write(WriteType.PUT, start_ts, short_value=value)
    else:
        w = Write(WriteType.PUT, start_ts)
        ops.append(("put", CF_DEFAULT, k.append_ts(start_ts).encoded, value))
    ops.append(("put", CF_WRITE, k.append_ts(commit_ts).encoded, w.to_bytes()))
    ops.append(("delete", CF_LOCK, k.encoded, None))
    wb = WriteBatch()
    for op, cf, key, val in ops:
        if op == "put":
            wb.put_cf(cf, key, val)
        else:
            wb.delete_cf(cf, key)
    eng.write(wb)
    return ops


def lock_ops(eng, raw_key, start_ts, value=b"x"):
    """A prewrite's lock put."""
    k = Key.from_raw(raw_key)
    lock = Lock(LockType.PUT, raw_key, start_ts, ttl=30000, short_value=value)
    eng.put_cf(CF_LOCK, k.encoded, lock.to_bytes())
    return [("put", CF_LOCK, k.encoded, lock.to_bytes())]


def notify(t: Trio, ops, apply_index: int, getter: bool = False) -> None:
    """The same committed batch to both packages' write-through hooks, the
    port's engine first brought up to date (its getter reads it)."""
    t.sync()
    jrc.notify_region_write(REGION, ops, apply_index,
                            get_default=(lambda k: t.eng.get_cf(CF_DEFAULT, k)) if getter else None)
    prc.notify_region_write(REGION, ops, apply_index,
                            get_default=(lambda k: t.peng.get_cf(CF_DEFAULT, k)) if getter else None)


def notify_lost(t: Trio, apply_index: int) -> None:
    jrc.notify_region_write_lost(REGION, apply_index)
    prc.notify_region_write_lost(REGION, apply_index)


def row(name, count, price, v2=False):
    return (encode_row_v2 if v2 else encode_row)(NON_HANDLE, [name, count, price])


# ---------------------------------------------------------------------------
# write-through deltas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v2", [False, True], ids=["rowv1", "rowv2"])
@pytest.mark.parametrize("mk_dag", [scan_dag, sel_dag, agg_dag],
                         ids=["scan", "selection", "aggregation"])
def test_wt_delta_zero_scan_byte_identical(v2, mk_dag):
    """Committed writes between reads fold in from the buffered delta:
    outcome 'wt_delta', no CF_WRITE scan, the cold bytes; then hits."""
    eng = big_product_engine(v2=v2)
    t = Trio(eng)
    assert t.serve(mk_dag, 200, 3)[0] == "miss"
    ops = commit_ops(eng, record_key(TABLE_ID, 5), row(b"durian", 999, 5, v2), 210, 220)
    ops += commit_ops(eng, record_key(TABLE_ID, 1500), row(b"apple", 1000, 6, v2), 210, 220)
    notify(t, ops, 4)
    assert t.serve(mk_dag, 300, 4)[:2] == ("wt_delta", 2)
    assert t.port.stats.deltas == t.ref.stats.deltas == 0
    assert t.port.stats.wt_deltas == t.ref.stats.wt_deltas == 1
    assert t.serve(mk_dag, 300, 4)[0] == "hit"


def test_wt_delta_insert_and_delete_structural():
    eng = big_product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    ops = commit_ops(eng, record_key(TABLE_ID, 5000), row(b"elderberry", 7, 1), 210, 220)
    ops += commit_ops(eng, record_key(TABLE_ID, 0), None, 210, 220)
    notify(t, ops, 4)
    assert t.serve(scan_dag, 300, 4)[:2] == ("wt_delta", 2)
    assert t.port.stats.deltas == 0


def test_wt_delta_large_value_resolves_via_getter():
    eng = big_product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    ops = commit_ops(eng, record_key(TABLE_ID, 9), row(b"fig", 77, 88), 210, 220,
                     force_default=True)
    notify(t, ops, 4, getter=True)
    assert t.serve(scan_dag, 300, 4)[:2] == ("wt_delta", 1)
    assert t.port.stats.deltas == 0


def test_wt_large_value_without_getter_degrades_to_scan_delta():
    eng = big_product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    ops = commit_ops(eng, record_key(TABLE_ID, 9), row(b"fig", 77, 88), 210, 220,
                     force_default=True)
    notify(t, ops, 4)
    assert t.serve(scan_dag, 300, 4)[:2] == ("delta", 1)
    assert t.port.stats.wt_lost == t.ref.stats.wt_lost == 1


def test_wt_lock_blocks_reader_then_commit_serves():
    """A prewrite's lock flows through write-through: the warm read scans
    CF_LOCK and raises as the scanners do; the commit clears it."""
    eng = big_product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    notify(t, lock_ops(eng, record_key(TABLE_ID, 4), 250), 4)
    t.raises_alike(scan_dag, 300, 4, "locked")
    ops = commit_ops(eng, record_key(TABLE_ID, 4), row(b"grape", 1, 2), 250, 260)
    notify(t, ops, 5)
    assert t.serve(scan_dag, 300, 5)[:2] == ("wt_delta", 1)
    assert t.port.stats.deltas == 0


def test_wt_lost_marker_forces_scan_delta_then_recovers():
    eng = big_product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    notify(t, commit_ops(eng, record_key(TABLE_ID, 5), row(b"durian", 9, 9), 210, 220), 4)
    # a write of unknown content lands (emission off for it)
    put_committed(eng, record_key(TABLE_ID, 6), row(b"kiwi", 8, 8), 230, 240)
    notify_lost(t, 5)
    assert t.serve(scan_dag, 300, 5)[:2] == ("delta", 2)
    notify(t, commit_ops(eng, record_key(TABLE_ID, 7), row(b"lime", 3, 3), 250, 260), 6)
    assert t.serve(scan_dag, 400, 6)[:2] == ("wt_delta", 1)


def test_wt_image_built_mid_stream_never_splices_a_gap():
    """A notify that predates the image's build must not seed a pending
    chain: the read repairs through scan_delta."""
    eng = big_product_engine()
    t = Trio(eng)
    notify(t, commit_ops(eng, record_key(TABLE_ID, 5), row(b"durian", 9, 9), 110, 120), 4)
    t.serve(scan_dag, 200, 3)
    notify(t, commit_ops(eng, record_key(TABLE_ID, 6), row(b"kiwi", 8, 8), 210, 220), 5)
    assert t.serve(scan_dag, 300, 5)[0] == "delta"


def test_wt_disabled_cache_keeps_scan_delta_path():
    eng = big_product_engine()
    t = Trio(eng, write_through=False)
    t.serve(scan_dag, 200, 3)
    notify(t, commit_ops(eng, record_key(TABLE_ID, 5), row(b"durian", 9, 9), 210, 220), 4)
    assert t.serve(scan_dag, 300, 4)[:2] == ("delta", 1)
    assert t.port.stats.wt_deltas == t.ref.stats.wt_deltas == 0


def test_wt_update_patches_the_pins_in_place():
    """A write-through update-only fold patches a plain image's stacked
    pins (equal to a rebuild)."""
    eng = big_product_engine()
    t = Trio(eng, encode_columns=False)
    t.serve(agg_dag, 200, 3)
    cache = t.last_port_cache
    assert stacked_pins(cache)
    ops = []
    for i in (3, 1024, 2047, 2499):
        ops += commit_ops(eng, record_key(TABLE_ID, i), row(b"cherry", i % 5, 7), 210, 220)
    notify(t, ops, 4)
    assert t.serve(agg_dag, 300, 4)[:2] == ("wt_delta", 4)
    assert_pins_equal_a_rebuild(cache, t.evaluators(agg_dag)[3])


# ---------------------------------------------------------------------------
# mvcc_batch against the reference's
# ---------------------------------------------------------------------------


def _drain(src):
    keys, vals, drained = [], [], False
    while not drained:
        k, v, drained = src.next_batch(1000)
        keys.extend(k)
        vals.extend(v)
    return keys, vals


def _versions_engine():
    eng = BTreeEngine()
    for h in range(50):
        put_committed(eng, record_key(TABLE_ID, h), b"v1-%d" % h, 10, 20)
        put_committed(eng, record_key(TABLE_ID, h), b"v2-%d" % h, 30, 40)
    return eng


def _mixed_engine():
    eng = BTreeEngine()
    for h in range(20):
        put_committed(eng, record_key(TABLE_ID, h), b"v-%d" % h, 10, 20)
    delete_committed(eng, record_key(TABLE_ID, 3), 30, 40)
    rollback(eng, record_key(TABLE_ID, 4), 35)
    put_committed_large(eng, record_key(TABLE_ID, 5), b"L" * 300, 30, 41)
    return eng


MVCC_CASES = {
    "simple": (product_engine, (200,), None),
    "versions": (_versions_engine, (5, 20, 39, 40, 100), None),
    "mixed": (_mixed_engine, (20, 40, 100), None),
    "two_ranges": (product_engine, (200,),
                   [(record_key(TABLE_ID, 1), record_key(TABLE_ID, 3)),
                    (record_key(TABLE_ID, 5), record_key(TABLE_ID, 100))]),
}


@pytest.mark.parametrize("record", [False, True], ids=["plain", "record_versions"])
@pytest.mark.parametrize("case", sorted(MVCC_CASES))
def test_mvcc_batch_matches_the_reference(case, record):
    make, stamps, ranges = MVCC_CASES[case]
    eng = make()
    peng = port_engine_of(eng)
    ranges = ranges or [record_range(TABLE_ID)]
    for ts in stamps:
        want_src = jmb.MvccBatchScanSource(eng.snapshot(), ts, ranges, record_versions=record)
        got_src = pmb.MvccBatchScanSource(peng.snapshot(), ts, ranges, record_versions=record)
        want, got = _drain(want_src), _drain(got_src)
        assert got == want, ts
        assert got_src.versions_exact == want_src.versions_exact
        assert got_src.max_commit_ts == want_src.max_commit_ts
        if record:
            assert np.array_equal(got_src.row_commit_ts, want_src.row_commit_ts)


def test_mvcc_batch_lock_blocks_and_bypasses_alike():
    eng = product_engine()
    lock_key(eng, record_key(TABLE_ID, 3), b"pk", start_ts=150)
    peng = port_engine_of(eng)
    rng = [record_range(TABLE_ID)]
    with pytest.raises(PortLockedError):
        _drain(pmb.MvccBatchScanSource(peng.snapshot(), 200, rng))
    for ts, bypass in ((100, frozenset()), (200, frozenset([150]))):
        assert _drain(pmb.MvccBatchScanSource(peng.snapshot(), ts, rng, bypass_locks=bypass)) \
            == _drain(jmb.MvccBatchScanSource(eng.snapshot(), ts, rng, bypass_locks=bypass))


def test_scan_delta_matches_the_reference():
    """scan_delta's diff of the engine against an image's handles and commit
    timestamps: updates, a CF_DEFAULT value, a rollback pick, a delete and
    an insert."""
    eng = big_product_engine()
    rng = [record_range(TABLE_ID)]
    src = jmb.MvccBatchScanSource(eng.snapshot(), 200, rng, record_versions=True)
    keys, _vals = src._resolve_all()
    handles = decode_record_handles(keys)
    put_committed(eng, record_key(TABLE_ID, 5), row(b"durian", 999, 5), 210, 220)
    put_committed_large(eng, record_key(TABLE_ID, 1100), row(b"fig", 77, 88), 210, 221)
    rollback(eng, record_key(TABLE_ID, 9), 215)
    delete_committed(eng, record_key(TABLE_ID, 0), 210, 222)
    put_committed(eng, record_key(TABLE_ID, 9000), row(b"elder", 7, 1), 210, 223)
    peng = port_engine_of(eng)
    want = jmb.scan_delta(eng.snapshot(), 300, rng, handles, src.row_commit_ts)
    got = pmb.scan_delta(peng.snapshot(), 300, rng, handles, src.row_commit_ts)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k
    assert list(got["deleted_handles"]) == [0]
    assert 9000 in got["changed_handles"] and 9 in got["changed_handles"]


# ---------------------------------------------------------------------------
# the slice as a whole: a lineitem region written as MVCC versions
# ---------------------------------------------------------------------------

LI_ROWS = 6000
LI_BLOCK_ROWS = 1024


class LineitemRegion:
    """The port's engine holding a date-ordered lineitem region and the
    draws behind it; requests through the port's cache, checked against
    the numpy oracles."""

    def __init__(self, encode: bool):
        self.a = fx.sort_by_shipdate(fx.build_arrays(LI_ROWS, 11))
        self.eng = fx.region_engine(self.a)
        self.cache = prc.RegionColumnCache(block_rows=LI_BLOCK_ROWS, encode_columns=encode,
                                           data_token=None)
        self.evs = {}
        self.ai, self.ts = 3, 200

    def ev(self, name: str, hint=None):
        if (name, hint) not in self.evs:
            dag = {"q6": fx.q6_dag, "q1": fx.q1_dag,
                   "filter": lambda: fx.filter_dag("filter", None)}[name]()
            ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=LI_BLOCK_ROWS, device="cpu")
            ev.route_hint = hint
            self.evs[name, hint] = ev
        return self.evs[name, hint]

    def serve(self, want_outcome: str, want_rows: int = 0):
        """Serve Q6 and Q1 on both warm routes and the filter; the first
        serve of the round takes the write."""
        outcomes = []
        for name, hint in (("q6", None), ("q6", "unary"), ("q1", None), ("q1", "unary"),
                           ("filter", None)):
            bc, out, n = self.cache.serve(self.eng.snapshot(), fx.region_context(self.ai),
                                          fx.lineitem(), [record_range(fx.TABLE_ID)], self.ts)
            outcomes.append((out, n))
            got = self.ev(name, hint).run(None, bc).iter_rows()
            want = {"q6": lambda: [fx.q6_oracle(self.a)], "q1": lambda: fx.q1_oracle(self.a),
                    "filter": lambda: fx.filter_oracle(self.a, "filter", None)}[name]()
            assert got == want, (name, hint, out)
        assert outcomes[0] == (want_outcome, want_rows)
        assert all(o == ("hit", 0) for o in outcomes[1:])
        return bc

    def write(self, seed: int, notify_it: bool = False, **kw):
        b, puts, dels = fx.region_write(self.a, seed, **kw)
        ops = fx.region_write_ops(b, puts, dels, self.ts + 5, self.ts + 10)
        fx.apply_region_ops(self.eng, ops)
        self.ai += 1
        self.ts += 100
        if notify_it:
            prc.notify_region_write(fx.REGION_ID, ops, self.ai)
        self.a = b
        return len(puts) + len(dels)


@pytest.mark.parametrize("encode", [False, True], ids=["plain", "encoded"])
def test_lineitem_region_through_its_writes_matches_the_oracles(encode):
    r = LineitemRegion(encode)
    cache = r.serve("miss")
    assert r.ev("q6", "unary").prune_stats[1] > 0, "a date-ordered region prunes Q6's blocks"
    # 0.1% and 1% in place, through scan_delta: rows move into Q6's window
    # inside blocks their zone maps excluded, and a new l_returnflag value
    n = r.write(21, n_update=6, q6_movers=3)
    assert r.serve("delta", n) is cache
    n = r.write(22, n_update=60, q6_movers=10, new_flag=True)
    assert r.serve("delta", n) is cache
    assert fx.NEW_FLAG in [bytes(v) for v in cache.blocks[0].cols[5].dictionary]
    if not encode:
        assert_pins_equal_a_rebuild(cache, r.ev("q1", "unary"))
    # the same kind of update through write-through
    n = r.write(23, notify_it=True, n_update=60, q6_movers=5)
    assert r.serve("wt_delta", n) is cache
    if not encode:
        assert_pins_equal_a_rebuild(cache, r.ev("q1", "unary"))
    # inserts and deletes: the structural repack
    n = r.write(24, n_update=10, n_insert=40, n_delete=30)
    r.serve("delta", n)
    assert next(iter(r.cache._images.values())).n_rows == LI_ROWS + 10


# ---------------------------------------------------------------------------
# fused_patch: the plain version and its checks
# ---------------------------------------------------------------------------


def _lanes(n_data: int, n_null: int, shape=(3, 64), seed=0):
    g = torch.Generator().manual_seed(seed)
    data = [torch.randint(-1000, 1000, shape, generator=g, dtype=torch.int64) if j % 2 == 0
            else torch.rand(shape, generator=g, dtype=torch.float64) for j in range(n_data)]
    nulls = [torch.rand(shape, generator=g) < 0.3 for _ in range(n_null)]
    return data, nulls


@pytest.mark.parametrize("n_data,n_null", [(1, 0), (1, 1), (16, 16), (3, 2)])
def test_patch_stacked_plain_writes_every_lane(n_data, n_null):
    data, nulls = _lanes(n_data, n_null)
    rng = np.random.default_rng(1)
    pos = rng.choice(3 * 64, 40, replace=False).astype(np.int64)  # across the 3 blocks
    vals = np.stack([rng.integers(-5, 5, 40) if j % 2 == 0 else rng.random(40).view(np.int64)
                     for j in range(n_data)]).astype(np.int64)
    nls = rng.random((n_null, 40)) < 0.5
    want_d = [t.clone().view(-1) for t in data]
    want_n = [t.clone().view(-1) for t in nulls]
    for j, t in enumerate(want_d):
        t[torch.from_numpy(pos)] = torch.from_numpy(vals[j]).view(t.dtype)
    for j, t in enumerate(want_n):
        t[torch.from_numpy(pos)] = torch.from_numpy(nls[j])
    fused_patch.patch_stacked(data, nulls, pos, vals, nls)
    for got, want in zip(data + nulls, want_d + want_n):
        assert torch.equal(got.view(-1), want)


def test_patch_stacked_refuses_what_the_kernel_does_not_take():
    data, nulls = _lanes(2, 1)
    vals = np.zeros((2, 3), dtype=np.int64)
    nls = np.zeros((1, 3), dtype=bool)
    with pytest.raises(ValueError, match="unique"):
        fused_patch.patch_stacked(data, nulls, np.array([1, 5, 1]), vals, nls)
    with pytest.raises(ValueError, match="outside"):
        fused_patch.patch_stacked(data, nulls, np.array([1, 5, 192]), vals, nls)
    with pytest.raises(ValueError, match="at most 16"):
        many, _ = _lanes(17, 0)
        fused_patch.patch_stacked(many, [], np.array([1]), np.zeros((17, 1), np.int64),
                                  np.zeros((0, 1), bool))
    with pytest.raises(ValueError, match="int64 or float64"):
        fused_patch.patch_stacked([data[0].to(torch.int32)], [], np.array([1]),
                                  np.zeros((1, 1), np.int64), np.zeros((0, 1), bool))
    with pytest.raises(ValueError, match="needs CUDA"):
        fused_patch.launch(data, nulls, torch.tensor([1]), torch.zeros((2, 1), dtype=torch.int64),
                           torch.zeros((1, 1), dtype=torch.bool))


def test_pin_updates_gathers_positions_and_words():
    """One patch of one pin from a delta over two blocks: flat positions,
    the REAL lane's words as f64 bits, only the touched lanes."""
    br = 8
    data = [torch.zeros(3, br, dtype=torch.int64), torch.zeros(3, br, dtype=torch.float64),
            torch.zeros(3, br, dtype=torch.int64)]
    nulls = [None, torch.zeros(3, br, dtype=torch.bool), None]
    sig = ("stacked", (1, 2, 3), (2,), br, "cpu")
    updates = {2: (np.array([1]), {1: (np.array([7]), np.array([False])),
                                   2: (np.array([2.5]), np.array([True]))}),
               0: (np.array([3, 4]), {1: (np.array([5, 6]), np.array([False, False])),
                                      2: (np.array([0.5, -1.0]), np.array([False, False]))})}
    lanes, null_lanes, pos, vals, nls = fused_patch.pin_updates((data, nulls), sig, updates)
    assert lanes == data[:2] and null_lanes == [nulls[1]]
    assert pos.tolist() == [3, 4, 17]
    assert vals[0].tolist() == [5, 6, 7]
    assert vals[1].view(np.float64).tolist() == [0.5, -1.0, 2.5]
    assert nls.tolist() == [[False, False, True]]
