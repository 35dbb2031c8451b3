"""The port's region column cache against the reference's, request by request.

One engine of the reference package (``tikv_tpu.storage.btree_engine``,
written through ``tests/fixtures.py``) is carried into the port's own
engine, column family by column family (``BTreeEngine.load_triples``), so
both packages read the same bytes.  The same requests and writes then go
through three paths:

* the reference's ``RegionColumnCache.serve`` and ``JaxDagEvaluator``;
* the reference's CPU pipeline (``BatchExecutorsRunner`` over an
  ``MvccScanSource``), cold, the oracle;
* the port's ``RegionColumnCache.serve`` and ``TorchDagEvaluator(device="cpu")``.

Where a cache answers ``None`` (``off``, ``stale``, ``uncacheable``), both
evaluators serve cold from their own MVCC batch source.  Every served
request must give byte-identical ``SelectResponse`` bytes on all three, the
same outcome string and the same ``delta_rows``.  The cases are those of
the reference's ``tests/test_region_cache.py`` that need neither the
endpoint nor raft, at block_rows 1,024 over 2,500 rows so that deltas cross
blocks, and the encoded-column cases of its write path (demotion, in-place
patching, code lanes widened by dictionary growth).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from copr_fixtures import PRODUCT_COLUMNS, TABLE_ID
from fixtures import delete_committed, lock_key, put_committed, put_committed_large, rollback

from tikv_tpu.copr import jax_eval
from tikv_tpu.copr import region_cache as jrc
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag import Aggregation, BatchExecutorsRunner, DagRequest, Limit, Selection, TableScan
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.executors import MvccScanSource
from tikv_tpu.copr.rowv2 import encode_row_v2
from tikv_tpu.copr.rpn import call, col, const_int
from tikv_tpu.copr.table import encode_row, record_key, record_range
from tikv_tpu.storage.btree_engine import BTreeEngine
from tikv_tpu.storage.engine import DATA_CFS
from tikv_tpu_torch.copr import encoding as penc
from tikv_tpu_torch.copr import region_cache as prc
from tikv_tpu_torch.copr.dag_wire import dag_from_wire
from tikv_tpu_torch.copr.mvcc_batch import MvccBatchScanSource as PortBatchSource
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
from tikv_tpu_torch.storage.btree_engine import BTreeEngine as PortEngine

NON_HANDLE = [c for c in PRODUCT_COLUMNS if not c.is_pk_handle]
N_ROWS = 2500
BLOCK_ROWS = 1024
REGION = 7
NAMES = (b"apple", b"banana", b"cherry")


def product_engine(n=N_ROWS, v2=False, table_id=TABLE_ID):
    eng = BTreeEngine()
    enc = encode_row_v2 if v2 else encode_row
    for i in range(n):
        put_committed(eng, record_key(table_id, i),
                      enc(NON_HANDLE, [NAMES[i % 3], i * 7 % 23, 100 + i]), 90, 100)
    return eng


def scan_dag():
    return DagRequest(executors=[TableScan(TABLE_ID, PRODUCT_COLUMNS), Limit(1 << 20)])


def sel_dag():
    return DagRequest(executors=[TableScan(TABLE_ID, PRODUCT_COLUMNS),
                                 Selection([call("gt", col(2), const_int(5))])])


def agg_dag():
    aggs = [AggDescriptor("sum", col(2)), AggDescriptor("count", None)]
    return DagRequest(executors=[TableScan(TABLE_ID, PRODUCT_COLUMNS),
                                 Aggregation([col(1)], aggs)])


def port_engine_of(eng: BTreeEngine) -> PortEngine:
    """The port's engine holding the reference engine's data CFs, byte for byte."""
    snap = eng.snapshot()
    out = PortEngine()
    out.load_triples((cf, k, v) for cf in DATA_CFS for k, v in snap.scan_cf(cf, b"", None))
    return out


class Trio:
    """One reference engine served three ways (module docstring).  The
    evaluators of each plan are kept across requests, as a server keeps
    them, so the port's memos (zone-map decisions, pins) live through the
    writes."""

    def __init__(self, eng, block_rows: int = BLOCK_ROWS, **cache_kw):
        # bound to the engine up front, as a server binds its cache (the
        # snapshots carry no data token)
        cache_kw.setdefault("data_token", None)
        self.eng = eng
        self.block_rows = block_rows
        self.ref = jrc.RegionColumnCache(block_rows=block_rows, **cache_kw)
        self.port = prc.RegionColumnCache(block_rows=block_rows, **cache_kw)
        self.peng = port_engine_of(eng)
        self._evs: dict = {}
        self.last_port_cache = None

    def sync(self) -> None:
        """Carry the reference engine's current bytes into the port's."""
        self.peng = port_engine_of(self.eng)

    def evaluators(self, mk_dag):
        if mk_dag not in self._evs:
            dag = mk_dag()
            wire = dag_to_wire(dag)
            self._evs[mk_dag] = (dag, dag_from_wire(wire),
                                 jax_eval.JaxDagEvaluator(dag, block_rows=self.block_rows),
                                 TorchDagEvaluator(wire, block_rows=self.block_rows, device="cpu"))
        return self._evs[mk_dag]

    def serve(self, mk_dag, ts: int, apply_index: int, region: int = REGION, epoch=(1, 1),
              ranges=None, context=None):
        """Serve one request three ways; returns ``(outcome, delta_rows,
        response bytes)`` after asserting that the three agree."""
        self.sync()
        ranges = ranges or [record_range(TABLE_ID)]
        ctx = context if context is not None else {
            "region_id": region, "region_epoch": epoch, "apply_index": apply_index}
        dag, pdag, jev, pev = self.evaluators(mk_dag)
        snap, psnap = self.eng.snapshot(), self.peng.snapshot()
        cpu = BatchExecutorsRunner(mk_dag(), MvccScanSource(snap, ts, ranges)).handle_request()
        bc, out, n = self.ref.serve(snap, ctx, dag.executors[0].columns_info, ranges, ts)
        ref = jev.run(None, bc) if bc is not None else jev.run(MvccScanSource(snap, ts, ranges))
        pbc, pout, pn = self.port.serve(psnap, ctx, pdag.executors[0].columns_info, ranges, ts)
        port = (pev.run(None, pbc) if pbc is not None
                else pev.run(PortBatchSource(psnap, ts, ranges)))
        self.last_port_cache = pbc
        assert (pout, pn) == (out, n)
        assert port.encode() == ref.encode() == cpu.encode(), out
        return out, n, port.encode()

    def raises_alike(self, mk_dag, ts: int, apply_index: int, match: str) -> None:
        """All three paths raise the same kind of error at this request."""
        self.sync()
        ranges = [record_range(TABLE_ID)]
        ctx = {"region_id": REGION, "region_epoch": (1, 1), "apply_index": apply_index}
        dag, pdag, jev, pev = self.evaluators(mk_dag)
        with pytest.raises(Exception, match=match):
            BatchExecutorsRunner(mk_dag(), MvccScanSource(self.eng.snapshot(), ts, ranges)) \
                .handle_request()
        with pytest.raises(Exception, match=match):
            bc, _o, _n = self.ref.serve(self.eng.snapshot(), ctx, dag.executors[0].columns_info,
                                        ranges, ts)
            jev.run(None, bc)
        with pytest.raises(Exception, match=match) as exc:
            pbc, _o, _n = self.port.serve(self.peng.snapshot(), ctx,
                                          pdag.executors[0].columns_info, ranges, ts)
            pev.run(None, pbc)
        assert type(exc.value).__name__ == "KeyIsLockedError"


def port_image(trio: Trio) -> prc.RegionImage:
    (img,) = trio.port._images.values()
    return img


def ref_image(trio: Trio):
    (img,) = trio.ref._images.values()
    return img


def stacked_pins(cache) -> dict:
    return {sig: e for sig, e in cache.blocks[0].device.items() if sig[0] == "stacked"}


def assert_pins_equal_a_rebuild(cache, ev: TorchDagEvaluator) -> None:
    """Every pinned stacked lane equals the lane pinned afresh from the host
    blocks (``torch.equal``), NULL masks included."""
    pins = stacked_pins(cache)
    assert pins, "no stacked pin to check"
    saved = {sig: ([t.clone() for t in data], [None if m is None else m.clone() for m in nulls])
             for sig, (data, nulls) in pins.items()}
    cache.drop_device()
    for sig, (data, nulls) in saved.items():
        _kind, ship, nullable, _br, _dev = sig
        img = ev._stacked_device(cache, ship_cols=ship, nullable=nullable)
        assert len(img.cols) == len(data)
        for got, want in zip(data, img.cols):
            assert torch.equal(got, want), sig
        for got, want in zip(nulls, img.nulls):
            assert (got is None) == (want is None)
            if got is not None:
                assert torch.equal(got, want), sig


def column_forms(blocks) -> list:
    """Per column of the first block: ("bp" | "rle", lane dtype), or the
    data dtype of a plain column."""
    out = []
    for c in blocks[0].cols:
        kind = getattr(c, "kind", None)
        if kind == "bp":
            out.append(("bp", str(c.packed.dtype)))
        elif kind == "rle":
            out.append(("rle",))
        else:
            out.append(("plain", str(np.asarray(c.data).dtype)))
    return out


def assert_same_forms(trio: Trio) -> None:
    """The port's image encodes each column as the reference's does."""
    assert column_forms(port_image(trio).block_cache.blocks) == \
        column_forms(ref_image(trio).block_cache.blocks)


# ---------------------------------------------------------------------------
# delta apply, both scan_delta forms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("v2", [False, True], ids=["rowv1", "rowv2"])
@pytest.mark.parametrize("mk_dag", [scan_dag, sel_dag, agg_dag],
                         ids=["scan", "selection", "aggregation"])
def test_delta_apply_byte_identical(v2, mk_dag):
    """Insert, update and delete between two apply indexes serve the cold
    CPU bytes through the delta path, across blocks, then hits."""
    eng = product_engine(v2=v2)
    t = Trio(eng)
    assert t.serve(mk_dag, 200, 3)[0] == "miss"
    assert t.serve(mk_dag, 200, 3)[0] == "hit"
    enc = encode_row_v2 if v2 else encode_row
    # two updates in different blocks (one with a NEW dictionary value),
    # one insert past the last handle, one delete
    put_committed(eng, record_key(TABLE_ID, 5), enc(NON_HANDLE, [b"durian", 999, 5]), 210, 220)
    put_committed(eng, record_key(TABLE_ID, 1100), enc(NON_HANDLE, [b"apple", 1000, 6]),
                  210, 220)
    put_committed(eng, record_key(TABLE_ID, 5000), enc(NON_HANDLE, [b"elderberry", 7, 1]),
                  210, 220)
    delete_committed(eng, record_key(TABLE_ID, 0), 210, 220)
    assert t.serve(mk_dag, 300, 4)[:2] == ("delta", 4)
    assert t.serve(mk_dag, 300, 4)[0] == "hit"
    assert port_image(t).n_rows == N_ROWS


@pytest.mark.parametrize("encode", [False, True], ids=["plain", "encoded"])
def test_update_only_delta_scatters_into_pinned_arrays(encode):
    """An update-only delta takes the in-place path: a plain image's
    stacked pins are patched (the same tensors, equal to a rebuild), an
    encoded image's pins are dropped; later requests stay byte-identical."""
    eng = product_engine()
    t = Trio(eng, encode_columns=encode)
    t.serve(agg_dag, 200, 3)
    t.serve(agg_dag, 200, 3)
    t.serve(sel_dag, 200, 3)
    cache = t.last_port_cache
    before = {sig: [id(x) for x in e[0]] for sig, e in stacked_pins(cache).items()}
    assert bool(before) != encode
    for i in (2, 9, 1030, 2400):
        put_committed(eng, record_key(TABLE_ID, i), encode_row(NON_HANDLE, [b"banana", 4, 4]),
                      210, 220)
    assert t.serve(agg_dag, 300, 4)[:2] == ("delta", 4)
    after = {sig: [id(x) for x in e[0]] for sig, e in stacked_pins(cache).items()}
    if not encode:
        # patched where they lie, not dropped and pinned again
        assert set(before) <= set(after)
        assert all(after[sig] == ids for sig, ids in before.items())
    assert t.serve(sel_dag, 300, 4)[0] == "hit"
    if not encode:
        assert_pins_equal_a_rebuild(cache, t.evaluators(agg_dag)[3])


def test_stale_start_ts_falls_back():
    """A read below the image's snapshot ts serves cold ('stale')."""
    eng = product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    put_committed(eng, record_key(TABLE_ID, 1), encode_row(NON_HANDLE, [b"apple", 1, 1]),
                  110, 120)
    assert t.serve(scan_dag, 150, 4)[0] == "stale"
    assert t.ref.stats.stale == t.port.stats.stale == 1


def test_epoch_change_invalidates():
    eng = product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3, epoch=(1, 1))
    assert len(t.port) == 1
    assert t.serve(scan_dag, 300, 4, epoch=(1, 2))[0] == "miss"
    assert t.ref.stats.invalidations == t.port.stats.invalidations == 1


def test_epoch_notify_is_region_scoped():
    eng = product_engine(n=64)
    t = Trio(eng)
    t.serve(scan_dag, 200, 3, region=REGION)
    for hook in (jrc.notify_region_epoch_change, prc.notify_region_epoch_change):
        hook(REGION + 1)
    assert len(t.ref) == len(t.port) == 1
    for hook in (jrc.notify_region_epoch_change, prc.notify_region_epoch_change):
        hook(REGION, reason="merge")
    assert len(t.ref) == len(t.port) == 0
    assert t.serve(scan_dag, 200, 3)[0] == "miss"


def test_missing_context_is_off():
    t = Trio(product_engine(n=64))
    assert t.serve(scan_dag, 200, 3, context={"region_id": REGION})[0] == "off"
    assert len(t.port) == 0


def test_lru_eviction_under_byte_budget():
    """Three regions under a budget that fits about one image: the LRU
    evicts, every answer stays exact, the survivor still hits."""
    t = Trio(product_engine(n=128), byte_budget=1 << 14, max_regions=8, encode_columns=False)
    for rid in (1, 2, 3):
        assert t.serve(scan_dag, 200, 3, region=rid)[0] == "miss"
    assert t.port.stats.evictions == t.ref.stats.evictions >= 2
    assert t.port.total_bytes() == t.ref.total_bytes()
    assert t.serve(scan_dag, 200, 3, region=3)[0] == "hit"


def test_region_too_big_for_budget_degrades():
    t = Trio(product_engine(n=128), byte_budget=64, max_regions=8)
    assert t.serve(scan_dag, 200, 3)[0] == "too_big"
    assert len(t.port) == len(t.ref) == 0


def test_locked_range_raises_the_same_error():
    eng = product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    lock_key(eng, record_key(TABLE_ID, 4), record_key(TABLE_ID, 4), 250)
    t.raises_alike(scan_dag, 300, 4, "locked")


def test_delta_update_with_large_value_resolves_exactly():
    """A changed key whose new value lives in CF_DEFAULT re-resolves
    through the exact path, not as a delete."""
    eng = product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    put_committed_large(eng, record_key(TABLE_ID, 9), encode_row(NON_HANDLE, [b"fig", 77, 88]),
                        210, 220)
    assert t.serve(scan_dag, 300, 4)[:2] == ("delta", 1)


def test_delta_rollback_pick_resolves_older_version():
    """A rollback record newer than the image's version re-resolves to the
    surviving older version."""
    eng = product_engine()
    t = Trio(eng)
    t.serve(scan_dag, 200, 3)
    rollback(eng, record_key(TABLE_ID, 9), 150)
    assert t.serve(scan_dag, 300, 4)[0] == "delta"
    assert t.serve(sel_dag, 300, 4)[0] == "hit"


def test_a_build_over_mixed_records_is_exact():
    """An image filled over deletes, rollbacks and CF_DEFAULT values (the
    per-key exact pick of ``record_versions``) answers as the scanners."""
    eng = product_engine()
    delete_committed(eng, record_key(TABLE_ID, 3), 110, 120)
    rollback(eng, record_key(TABLE_ID, 4), 115)
    put_committed_large(eng, record_key(TABLE_ID, 5), encode_row(NON_HANDLE, [b"kiwi", 1, 2]),
                        110, 121)
    t = Trio(eng)
    assert t.serve(sel_dag, 200, 3)[0] == "miss"
    assert port_image(t).n_rows == N_ROWS - 1


# ---------------------------------------------------------------------------
# the encoded image under in-place writes
# ---------------------------------------------------------------------------

CODED = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
         ColumnInfo(2, FieldType.varchar()),  # name: a dictionary of 60
         ColumnInfo(3, FieldType.int64()),  # run: i // 256, run-length encoded
         ColumnInfo(4, FieldType.int64())]  # small: 100 + i % 50, bitpacked in int8
CODED_ROWS = 2048


def coded_engine():
    eng = BTreeEngine()
    for i in range(CODED_ROWS):
        put_committed(eng, record_key(TABLE_ID, i),
                      encode_row(CODED[1:], [b"n%02d" % (i % 60), i // 256, 100 + i % 50]), 90, 100)
    return eng


def coded_scan():
    return DagRequest(executors=[TableScan(TABLE_ID, CODED), Limit(1 << 20)])


def coded_agg():
    aggs = [AggDescriptor("sum", col(3)), AggDescriptor("max", col(2)),
            AggDescriptor("count", None)]
    return DagRequest(executors=[TableScan(TABLE_ID, CODED),
                                 Selection([call("ge", col(3), const_int(120))]),
                                 Aggregation([col(1)], aggs)])


def _update(eng, handles, rows, ts=(210, 220)):
    for h, row in zip(handles, rows):
        put_committed(eng, record_key(TABLE_ID, h), encode_row(CODED[1:], row), *ts)


def _encoded_trio():
    eng = coded_engine()
    t = Trio(eng)
    t.serve(coded_scan, 200, 3)
    t.serve(coded_agg, 200, 3)
    assert_same_forms(t)
    assert column_forms(port_image(t).block_cache.blocks)[1:] == [
        ("plain", "int8"), ("rle",), ("bp", "int8")]
    return eng, t


def test_an_update_demotes_a_run_length_column():
    """Any in-place write breaks an RLE column's runs: it is demoted
    image-wide before the write, and the answers stay exact."""
    eng, t = _encoded_trio()
    before = dict(penc.DEMOTE_COUNTS)
    _update(eng, [10, 1500], [[b"n10", 0, 110], [b"n00", 5, 100]])
    assert t.serve(coded_agg, 300, 4)[:2] == ("delta", 2)
    assert_same_forms(t)
    assert column_forms(port_image(t).block_cache.blocks)[2][0] == "plain"
    assert penc.DEMOTE_COUNTS.get(("rle", "inplace_update"), 0) == \
        before.get(("rle", "inplace_update"), 0) + 1
    assert t.serve(coded_scan, 300, 4)[0] == "hit"


def test_a_bitpacked_column_is_patched_in_place_then_demoted_by_range():
    """A bitpacked column takes new values that fit its lanes in place
    (``try_patch``); a value outside them demotes it (``value_range``)."""
    eng, t = _encoded_trio()
    _update(eng, [7, 1900], [[b"n07", 0, 149], [b"n40", 7, 100]])
    assert t.serve(coded_agg, 300, 4)[:2] == ("delta", 2)
    assert column_forms(port_image(t).block_cache.blocks)[3] == ("bp", "int8")
    assert_same_forms(t)
    before = penc.DEMOTE_COUNTS.get(("bp", "value_range"), 0)
    _update(eng, [8], [[b"n08", 0, 100_000]], ts=(310, 320))
    assert t.serve(coded_agg, 400, 5)[:2] == ("delta", 1)
    assert column_forms(port_image(t).block_cache.blocks)[3][0] == "plain"
    assert penc.DEMOTE_COUNTS[("bp", "value_range")] == before + 1
    assert_same_forms(t)
    assert t.serve(coded_scan, 400, 5)[0] == "hit"


def test_dictionary_growth_widens_narrowed_code_lanes():
    """70 new names grow the 60-entry dictionary past its int8 code lanes:
    the lanes widen image-wide, the pins drop, the warm coded route sizes
    its slots from the grown dictionary."""
    eng, t = _encoded_trio()
    version = port_image(t).block_cache.enc_version
    handles = list(range(0, 1400, 20))
    _update(eng, handles, [[b"new%03d" % j, 1, 120] for j in range(len(handles))])
    assert t.serve(coded_agg, 300, 4)[:2] == ("delta", len(handles))
    img = port_image(t)
    assert len(img.block_cache.blocks[0].cols[1].dictionary) == 60 + len(handles)
    assert column_forms(img.block_cache.blocks)[1] == ("plain", "int16")
    assert img.block_cache.enc_version > version
    assert_same_forms(t)
    assert t.serve(coded_scan, 300, 4)[0] == "hit"
