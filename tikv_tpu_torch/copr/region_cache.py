"""Device-resident per-region column cache with incremental delta apply.

The port's own copy of ``tikv_tpu/copr/region_cache.py``.  It keeps ONE
decoded image per ``(region, ranges, schema)``, keyed for freshness by
``(region_epoch, apply_index)``: base data stays resident in the device
format and only deltas move.

* build: vectorized MVCC range resolve (``MvccBatchScanSource``) and the
  batched row decoder fill fixed-width column blocks from the region's
  visible versions; the evaluator pins them on the card on first use.
* hit: the same ``apply_index`` means the engine cannot have changed: the
  resident blocks serve as they are (no scan, no decode, no transfer).
* delta: a newer ``apply_index`` (or a later ``start_ts`` while future
  versions exist) runs ``mvcc_batch.scan_delta``: one vectorized pass over
  the CF_WRITE keys finds the rows whose version moved; only those resolve
  and decode again.  In-place updates patch the pinned stacked lanes on the
  card (``cache.scatter_update``, the ``patch_stacked`` kernel); inserts and
  deletes repack the host blocks (no KV decode) and drop the pins.
* write-through: :func:`notify_region_write` hands a committed batch's ops
  to every live cache, which buffers the parsed rows on the region's images
  as a pending delta; the next warm read folds it in with no CF_WRITE scan
  (outcome ``wt_delta``).  ``scan_delta`` repairs whenever the pending chain
  could have a gap.
* fallback: a read below the image's snapshot ts, a range that does not
  vectorize, or a region over the byte budget answers through the caller's
  per-request path: the cache only ever degrades to it.

The outcome strings are the reference package's: ``off``, ``uncacheable``,
``stale``, ``miss`` (a build), ``too_big``, ``hit``, ``delta`` and
``wt_delta``.  Not ported (``ROADMAP.md``): the integrity fingerprints,
``checksum_serve`` and quarantine, tenant budgets, sharded placement over a
mesh, the raft apply hook that calls :func:`notify_region_write`, and the
reference's buffer-sanitizer and observatory hooks.  Counters are plain
dicts (``OUTCOME_COUNTS``, ``INVALIDATE_COUNTS``) in place of its metrics
registry.

Concurrency: lookups, builds' inserts and delta folds serialize under the
cache lock, but the evaluator reads an image's blocks after ``serve``
returns; callers that serve one region from several threads serialize per
region.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np

from ..storage.engine import CF_LOCK, CF_WRITE
from ..storage.mvcc import Statistics
from ..storage.mvcc.reader import _check_lock
from ..storage.txn_types import Key, Write, WriteType, append_ts, split_ts
from . import encoding as _encoding
from .cache import ColumnBlockCache
from .datatypes import Column, EvalType
from .mvcc_batch import MvccBatchScanSource, scan_delta
from .table import RowBatchDecoder, decode_record_handles

DEFAULT_BYTE_BUDGET = 256 << 20
DEFAULT_MAX_REGIONS = 64
_REBUILD_FRACTION = 0.25  # delta bigger than this fraction of rows => rebuild
_TOKEN_UNSET = object()  # cache not yet bound to an engine's data_token

_CACHES: "weakref.WeakSet[RegionColumnCache]" = weakref.WeakSet()

#: outcome -> serves (and "too_big" builds), across every cache
OUTCOME_COUNTS: dict[str, int] = {}
#: reason -> images dropped ("epoch", "delta_too_big", "unvectorizable", ...)
INVALIDATE_COUNTS: dict[str, int] = {}


def _count(table: dict, key: str, n: int = 1) -> None:
    table[key] = table.get(key, 0) + n


def notify_region_epoch_change(region_id: int, reason: str = "epoch") -> None:
    """A region's epoch moved (split / merge / conf change): every live cache
    drops its images of that region."""
    for c in list(_CACHES):
        c.invalidate_region(region_id, reason=reason)


def notify_region_write(region_id: int, ops, apply_index: int,
                        get_default=None, token=None) -> None:
    """Write-through hook: a committed data batch applied to ``region_id``
    at ``apply_index``.  ``ops`` are the batch's ``(op, cf, key, val)``
    tuples in MVCC key space; ``get_default`` resolves a ``CF_DEFAULT`` key
    for PUT records whose value is not inline; ``token`` identifies the
    emitting engine (each cache only accepts deltas from the engine it
    serves).  Interested caches buffer the parsed delta on their images of
    the region; warm reads fold it in without scanning CF_WRITE.  The parse
    runs at most once per notify and outside every cache lock."""
    memo: list = []

    def parse_once():
        if not memo:
            memo.append(_parse_write_ops(ops, get_default))
        return memo[0]

    for c in list(_CACHES):
        c.apply_write(region_id, parse_once, apply_index, token=token)


def notify_region_write_lost(region_id: int, apply_index: int, token=None) -> None:
    """A data change of unknown content landed: pending deltas are dropped
    and the notify watermark advances, so reads repair through
    ``scan_delta`` until a read's snapshot catches up past ``apply_index``."""
    for c in list(_CACHES):
        c.note_write_lost(region_id, apply_index, token=token)


def _parse_write_ops(ops, get_default):
    """A committed batch's ops as ``(writes, lock_keys)``: ``writes`` =
    [(raw_key, commit_ts, value | None for a delete)] in batch order,
    ``lock_keys`` = raw keys whose CF_LOCK state changed.  None when any
    CF_WRITE op is not an incremental row change (a delete on CF_WRITE, a gc
    fence, a missing CF_DEFAULT value): the caller then repairs through
    ``scan_delta``."""
    writes: list[tuple[bytes, int, bytes | None]] = []
    lock_keys: list[bytes] = []
    for op, cf, key, val in ops:
        if cf == CF_LOCK:
            try:
                lock_keys.append(Key.from_encoded(key).to_raw())
            except Exception:  # noqa: BLE001 — undecodable lock key
                return None
            continue
        if cf != CF_WRITE:
            continue  # CF_DEFAULT rides along with its CF_WRITE record
        if op != "put":
            return None  # GC / collapse deletes: not an incremental change
        try:
            enc_user, cts = split_ts(key)
            w = Write.from_bytes(val)
            raw = Key.from_encoded(enc_user).to_raw()
        except Exception:  # noqa: BLE001 — malformed record
            return None
        if w.write_type == WriteType.PUT:
            if w.gc_fence is not None:
                return None
            v = w.short_value
            if v is None:
                try:
                    v = get_default(append_ts(enc_user, w.start_ts)) if get_default else None
                except Exception:  # noqa: BLE001 — a faulting engine read degrades
                    v = None
                if v is None:
                    return None
            writes.append((raw, int(cts), v))
        elif w.write_type == WriteType.DELETE:
            writes.append((raw, int(cts), None))
        # LOCK / ROLLBACK records change no visible row: skipped
    return writes, lock_keys


def _in_ranges(raw: bytes, ranges) -> bool:
    return any(start <= raw < end for start, end in ranges)


def _epoch_of(ctx_epoch) -> tuple[int, int] | None:
    """``(conf_ver, version)`` from the context's region epoch, or None."""
    if isinstance(ctx_epoch, (tuple, list)) and len(ctx_epoch) == 2:
        return (int(ctx_epoch[0]), int(ctx_epoch[1]))
    return None


def schema_sig(columns_info) -> tuple:
    return tuple(
        (c.col_id, c.ftype.eval_type, c.ftype.decimal, c.ftype.flag,
         bool(c.ftype.is_unsigned), bool(c.is_pk_handle), c.default_value)
        for c in columns_info
    )


class RegionImage:
    """One region's decoded, device-pinnable columnar state."""

    def __init__(self, key, epoch, schema, block_rows: int):
        self.key = key
        self.epoch = epoch
        self.schema = schema
        self.block_rows = block_rows
        self.apply_index = -1
        self.snapshot_ts = -1
        self.max_commit_ts = 0
        self.handles = np.empty(0, dtype=np.int64)
        self.row_commit_ts = np.empty(0, dtype=np.int64)
        self.block_cache = ColumnBlockCache()
        self.decoder = RowBatchDecoder(schema)
        self.nbytes = 0
        # whether fill encoded the image (a repack then encodes again)
        self.encode_enabled = False
        # bytes -> code maps of dictionary columns, built on the first delta
        self._dict_maps: dict[int, dict] = {}
        # write-through pending delta (apply_write buffers; serve folds in):
        # {"base", "apply_index", "changed": {handle: (value, cts)},
        #  "deleted": set[handle], "max_ct"} or None
        self.wt_pending: dict | None = None
        # a write-through batch touched CF_LOCK in range: the next warm serve
        # scans locks again even at an unchanged start_ts, until a lock-free
        # scan ran on a snapshot at or after that batch (locks_dirty_at)
        self.locks_dirty = False
        self.locks_dirty_at = 0

    @property
    def n_rows(self) -> int:
        return len(self.handles)

    def _offsets(self) -> np.ndarray:
        nv = np.array([b.n_valid for b in self.block_cache.blocks], dtype=np.int64)
        return np.concatenate([[0], np.cumsum(nv)])

    def _recount(self) -> None:
        self.nbytes = (sum(_encoding.column_nbytes(c) for b in self.block_cache.blocks
                           for c in b.cols)
                       + self.handles.nbytes + self.row_commit_ts.nbytes)

    # -- build -------------------------------------------------------------

    def fill(self, handles: np.ndarray, values: list[bytes], cts: np.ndarray,
             max_commit_ts: int, apply_index: int, start_ts: int, encode: bool = False) -> None:
        self.handles = handles
        self.row_commit_ts = cts
        cache = self.block_cache
        cache.clear_blocks()
        br = self.block_rows
        for s in range(0, len(values), br):
            e = min(s + br, len(values))
            cache.add(self.decoder.decode(handles[s:e], values[s:e]), e - s)
        cache.filled = True
        # the fill-time stats pass: eligible columns become encoded
        # residents, and the budget counts their encoded bytes
        self.encode_enabled = bool(encode)
        if encode:
            _encoding.encode_blocks(cache, self.schema)
        self.apply_index = apply_index
        self.snapshot_ts = start_ts
        self.max_commit_ts = max_commit_ts
        self.wt_pending = None  # a rebuild reflects the engine directly
        self._recount()

    # -- delta -------------------------------------------------------------

    def apply_delta(self, delta: dict, apply_index: int, start_ts: int) -> int:
        """Apply a ``mvcc_batch.scan_delta`` result; returns rows touched."""
        ch = delta["changed_handles"]
        dh = delta["deleted_handles"]
        n_touched = len(ch) + len(dh)
        if n_touched:
            pos = np.searchsorted(self.handles, ch)
            pos_c = np.minimum(pos, max(self.n_rows - 1, 0))
            in_place = (len(dh) == 0 and self.n_rows > 0
                        and bool((self.handles[pos_c] == ch).all()))
            # dictionary codes decoded once here, not once per cell
            cols = ([c.decoded() for c in self.decoder.decode(ch, delta["changed_values"])]
                    if len(ch) else None)
            if in_place:
                self._apply_updates(pos, cols, delta["changed_commit_ts"])
            else:
                self._apply_structural(ch, cols, delta["changed_commit_ts"], dh)
        self.apply_index = apply_index
        self.snapshot_ts = start_ts
        self.max_commit_ts = delta["max_commit_ts"]
        self._recount()
        return n_touched

    def _code_of(self, ci: int, blocks, value: bytes) -> int:
        """Image dictionary code for ``value`` on column ``ci``, appending a
        new entry (shared by every block) when unseen."""
        dmap = self._dict_maps.get(ci)
        dictionary = blocks[0].cols[ci].dictionary
        if dmap is None:
            dmap = self._dict_maps[ci] = {bytes(v): j for j, v in enumerate(dictionary)}
        code = dmap.get(value)
        if code is None:
            code = len(dmap)
            dmap[value] = code
            grown = np.empty(code + 1, dtype=object)
            grown[:code] = dictionary
            grown[code] = value
            for b in blocks:
                b.cols[ci].dictionary = grown
        return code

    def _delta_cell(self, ci: int, blocks, col: Column, r: int):
        """(value, is_null) of delta row ``r`` in the image's representation."""
        nl = bool(np.asarray(col.nulls)[r])
        image_col = blocks[0].cols[ci] if blocks else None
        dict_encoded = image_col is not None and image_col.is_dict_encoded
        if isinstance(image_col, _encoding.EncodedColumn):
            # int-family lanes by construction; reading ``.data`` would
            # cache a full decode the encoded byte budget never counted
            obj_col = False
        else:
            obj_col = (
                image_col.data.dtype == object
                if image_col is not None and isinstance(image_col.data, np.ndarray)
                else self.schema[ci].ftype.eval_type in (EvalType.BYTES, EvalType.JSON)
                and not dict_encoded
            )
        if nl:
            return (b"" if obj_col and not dict_encoded else 0), True
        v = col.decoded().data[r] if col.is_dict_encoded else col.data[r]
        if dict_encoded:
            return self._code_of(ci, blocks, bytes(v)), False
        return v, False

    def _apply_updates(self, pos: np.ndarray, cols, cts: np.ndarray) -> None:
        """In-place row updates: host arrays (encoded payloads patched where
        the encoding survives), zone maps, then the pinned stacked lanes
        patched on the card (``cache.scatter_update``)."""
        blocks = self.block_cache.blocks
        offsets = self._offsets()
        bi_arr = np.searchsorted(offsets, pos, side="right") - 1
        # an in-place update breaks an RLE column's runs: demote it image-wide
        # up front (decode-on-next-serve), so the writes below land on plain
        # decoded arrays
        for ci in range(len(self.schema)):
            if self.schema[ci].is_pk_handle:
                continue
            c0 = blocks[0].cols[ci] if blocks else None
            if isinstance(c0, _encoding.EncodedColumn) and c0.kind == "rle":
                _encoding.demote_column(self.block_cache, ci, "inplace_update")
        updates: dict[int, tuple[np.ndarray, dict]] = {}
        for bi in np.unique(bi_arr):
            sel = np.flatnonzero(bi_arr == bi)
            rows = (pos[sel] - offsets[bi]).astype(np.int64)
            per_col: dict[int, tuple[np.ndarray, np.ndarray]] = {}
            for ci, col in enumerate(cols):
                if self.schema[ci].is_pk_handle:
                    continue  # handles are the row identity: they never change
                image_col = blocks[int(bi)].cols[ci]
                vals = np.empty(len(sel), dtype=_encoding.host_dtype(image_col))
                nls = np.zeros(len(sel), dtype=bool)
                for j, si in enumerate(sel):
                    vals[j], nls[j] = self._delta_cell(ci, blocks, col, int(si))
                if isinstance(image_col, _encoding.EncodedColumn):
                    if not image_col.try_patch(rows, vals, nls):
                        # the new values do not fit the narrow lanes: demote
                        # the column image-wide and write decoded
                        _encoding.demote_column(self.block_cache, ci, "value_range")
                        image_col = blocks[int(bi)].cols[ci]
                        image_col.data[rows] = vals.astype(image_col.data.dtype, copy=False)
                        image_col.nulls[rows] = nls
                else:
                    d = np.asarray(image_col.data)
                    if (image_col.dictionary is not None and d.dtype != object
                            and d.dtype.kind in "iu" and d.dtype.itemsize < 8 and len(vals)
                            and _encoding.ensure_code_capacity(blocks, ci, int(vals.max()))):
                        # narrowed code lanes widened (the delta grew the
                        # dictionary past them): the pins rebuild from host
                        self.block_cache.enc_version += 1
                        self.block_cache.drop_device()
                        image_col = blocks[int(bi)].cols[ci]
                    image_col.data[rows] = vals.astype(np.asarray(image_col.data).dtype,
                                                       copy=False)
                    image_col.nulls[rows] = nls
                per_col[ci] = (vals, nls)
            updates[int(bi)] = (rows, per_col)
        self.row_commit_ts[pos] = cts
        self.block_cache.scatter_update(updates)

    def _apply_structural(self, ch: np.ndarray, cols, cts: np.ndarray, dh: np.ndarray) -> None:
        """Inserts and/or deletes: repack the host blocks from the resident
        columns (no KV decode) and drop the device pins to rebuild lazily."""
        blocks = self.block_cache.blocks
        n_old = self.n_rows
        # a global view of each column, keeping dictionary codes
        gdata, gnulls = [], []
        for ci in range(len(self.schema)):
            if blocks:
                g = np.concatenate([np.asarray(b.cols[ci].data) for b in blocks])
                if (blocks[0].cols[ci].dictionary is not None and g.dtype != object
                        and g.dtype.kind in "iu" and g.dtype.itemsize < 8):
                    # narrowed code lanes widen for the repack (new codes may
                    # exceed them); the re-encode below narrows them again
                    g = g.astype(np.int64)
                gdata.append(g)
                gnulls.append(np.concatenate([np.asarray(b.cols[ci].nulls) for b in blocks]))
            else:
                et = self.schema[ci].ftype.eval_type
                dtype = (object if et in (EvalType.BYTES, EvalType.JSON)
                         else np.float64 if et == EvalType.REAL else np.int64)
                gdata.append(np.empty(0, dtype=dtype))
                gnulls.append(np.empty(0, dtype=bool))
        handles = self.handles
        row_cts = self.row_commit_ts
        if len(dh) and n_old:
            keep = np.ones(n_old, dtype=bool)
            dpos = np.searchsorted(handles, dh)
            ok = dpos < n_old
            ok &= handles[np.minimum(dpos, n_old - 1)] == dh
            keep[dpos[ok]] = False
            sel = np.flatnonzero(keep)
            handles = handles[sel]
            row_cts = row_cts[sel]
            gdata = [d[sel] for d in gdata]
            gnulls = [nl[sel] for nl in gnulls]
        if len(ch):
            # changed rows split into updates of surviving rows and inserts
            pos = np.searchsorted(handles, ch)
            pos_c = np.minimum(pos, max(len(handles) - 1, 0))
            is_upd = ((handles[pos_c] == ch) if len(handles)
                      else np.zeros(len(ch), dtype=bool))
            new_vals: list[list] = [[] for _ in self.schema]
            new_nulls: list[list] = [[] for _ in self.schema]
            for r in range(len(ch)):
                for ci, col in enumerate(cols):
                    if self.schema[ci].is_pk_handle:
                        v, nl = int(ch[r]), False
                    else:
                        v, nl = self._delta_cell(ci, blocks, col, r)
                    new_vals[ci].append(v)
                    new_nulls[ci].append(nl)
            upd_idx = np.flatnonzero(np.asarray(is_upd))
            for ci in range(len(self.schema)):
                if len(upd_idx) and not self.schema[ci].is_pk_handle:
                    gdata[ci][pos_c[upd_idx]] = np.array(
                        [new_vals[ci][int(i)] for i in upd_idx], dtype=gdata[ci].dtype)
                    gnulls[ci][pos_c[upd_idx]] = np.array(
                        [new_nulls[ci][int(i)] for i in upd_idx], dtype=bool)
            if len(upd_idx):
                row_cts = row_cts.copy()
                row_cts[pos_c[upd_idx]] = cts[upd_idx]
            ins_idx = np.flatnonzero(~np.asarray(is_upd))
            if len(ins_idx):
                ins_h = ch[ins_idx]
                ins_at = np.searchsorted(handles, ins_h)
                handles = np.insert(handles, ins_at, ins_h)
                row_cts = np.insert(row_cts, ins_at, cts[ins_idx])
                for ci in range(len(self.schema)):
                    ivals = np.array([new_vals[ci][int(i)] for i in ins_idx],
                                     dtype=gdata[ci].dtype)
                    gdata[ci] = np.insert(gdata[ci], ins_at, ivals)
                    gnulls[ci] = np.insert(gnulls[ci], ins_at, np.array(
                        [new_nulls[ci][int(i)] for i in ins_idx], dtype=bool))
        self.handles = handles
        self.row_commit_ts = row_cts
        # re-chunk into blocks (views over the global arrays); clear_blocks
        # drops the pins
        templates = [blocks[0].cols[ci] if blocks else None for ci in range(len(self.schema))]
        self.block_cache.clear_blocks()
        br = self.block_rows
        n = len(handles)
        for s in range(0, n, br):
            e = min(s + br, n)
            bcols = []
            for ci in range(len(self.schema)):
                t = templates[ci]
                bcols.append(Column(
                    t.eval_type if t is not None else self.schema[ci].ftype.eval_type,
                    gdata[ci][s:e], gnulls[ci][s:e],
                    t.frac if t is not None else self.schema[ci].ftype.decimal,
                    t.dictionary if t is not None else None))
            self.block_cache.add(bcols, e - s)
        self.block_cache.filled = True
        if self.encode_enabled:
            # a structural repack re-runs the stats pass over fresh value
            # ranges and runs (no KV decode)
            _encoding.encode_blocks(self.block_cache, self.schema)
        self.block_cache.drop_device()


class RegionCacheStats:
    __slots__ = ("hits", "misses", "deltas", "delta_rows", "stale", "uncacheable",
                 "evictions", "invalidations", "bytes_pinned", "wt_deltas", "wt_rows", "wt_lost")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.deltas = 0  # scan_delta serves (CF_WRITE scans)
        self.delta_rows = 0
        self.stale = 0
        self.uncacheable = 0
        self.evictions = 0
        self.invalidations = 0
        self.bytes_pinned = 0
        self.wt_deltas = 0  # write-through folds (no CF_WRITE scan)
        self.wt_rows = 0
        self.wt_lost = 0  # emission gaps forcing a scan_delta repair


class RegionColumnCache:
    """LRU of :class:`RegionImage` under a byte budget.  ``block_rows``
    defaults to the port's evaluator's (``torch_eval.DEFAULT_BLOCK_ROWS``);
    ``encode_columns=False`` keeps images plain (decoded residency), which
    is what lets the warm stacked pin exist and the patch kernel run."""

    def __init__(self, byte_budget: int = DEFAULT_BYTE_BUDGET,
                 max_regions: int = DEFAULT_MAX_REGIONS, block_rows: int | None = None,
                 write_through: bool = True, data_token: object = _TOKEN_UNSET,
                 encode_columns: bool = True):
        from .torch_eval import DEFAULT_BLOCK_ROWS

        self.byte_budget = byte_budget
        self.max_regions = max_regions
        self.block_rows = block_rows or DEFAULT_BLOCK_ROWS
        self.encode_columns = encode_columns
        self._images: dict = {}  # key -> RegionImage, insertion = LRU order
        self._mu = threading.RLock()
        self.stats = RegionCacheStats()
        # write-through intake: per region, the highest apply index whose
        # data change this cache has seen (as a parsed delta or a lost
        # marker).  A pending delta only starts on an image whose
        # apply_index has caught up to it; missed batches repair through
        # scan_delta, never through a gapped pending chain.
        self.write_through = write_through
        self._wt_seen: dict[int, int] = {}
        # the engine this cache serves: notifies from any other engine are
        # dropped.  Bound at construction, or learned from the first served
        # snapshot; a late-bound cache refuses to start a pending chain for a
        # region until one notify was seen and a read repaired past it.
        self._wt_token = data_token
        self._wt_late_bound = False
        _CACHES.add(self)

    # -- public ------------------------------------------------------------

    def serve(self, snap, context: dict, columns_info, ranges, start_ts: int):
        """Resolve a request against the cache.

        Returns ``(block_cache | None, outcome, delta_rows)``; a None block
        cache means "serve through the per-request path" (outcome says why)."""
        region_id = (context or {}).get("region_id")
        epoch = _epoch_of((context or {}).get("region_epoch"))
        apply_index = (context or {}).get("apply_index")
        if region_id is None or epoch is None or apply_index is None:
            return None, "off", 0
        key = (region_id, tuple(ranges), schema_sig(columns_info))
        stats = Statistics()
        with self._mu:
            if self._wt_token is _TOKEN_UNSET:
                # bind to the engine behind the first served snapshot
                self._wt_token = getattr(snap, "data_token", None)
                self._wt_late_bound = True
            img = self._images.get(key)
            if img is not None and img.epoch != epoch:
                self._drop(key, reason="epoch")
                img = None
            if img is not None:
                self._images.pop(key)  # LRU touch
                self._images[key] = img
        if img is None:
            # build outside the lock: a cold build must not stall warm hits
            return self._build(key, epoch, snap, columns_info, ranges, start_ts,
                               apply_index, stats)
        with self._mu:
            if self._images.get(key) is not img or img.epoch != epoch:
                # raced with an invalidation between lookup and here
                return self._outcome("uncacheable")
            if start_ts < img.snapshot_ts:
                return self._outcome("stale")
            if self._hit_fresh_locked(img, apply_index, start_ts, snap, ranges, stats):
                return self._outcome("hit", img)
            pend = img.wt_pending
            if pend is not None and img.apply_index > apply_index:
                # the reader's snapshot predates the image: a scan_delta
                # would rewind it under the pending chain's base
                return self._outcome("stale")
            if (pend is not None and apply_index >= pend["apply_index"]
                    and img.apply_index >= pend["base"]
                    and img.max_commit_ts <= img.snapshot_ts
                    and start_ts >= pend["max_ct"]):
                # write-through: every batch between the image's state and
                # the reader's snapshot is buffered here; fold it in with no
                # CF_WRITE scan.  A dirty lock state scans CF_LOCK first.
                if img.locks_dirty or start_ts > img.snapshot_ts:
                    seen = self._check_locks(snap, ranges, start_ts, stats)
                    if seen == 0 and apply_index >= img.locks_dirty_at:
                        img.locks_dirty = False
                n_touch = len(pend["changed"]) + len(pend["deleted"])
                if n_touch == 0:
                    # the batches touched nothing in this image's ranges
                    img.apply_index = apply_index
                    img.snapshot_ts = max(img.snapshot_ts, start_ts)
                    img.max_commit_ts = max(img.max_commit_ts, pend["max_ct"])
                    img.wt_pending = None
                    return self._outcome("hit", img)
                if img.n_rows and n_touch > _REBUILD_FRACTION * img.n_rows:
                    self._drop(key, reason="delta_too_big")
                    return self._build(key, epoch, snap, columns_info, ranges, start_ts,
                                       apply_index, stats)
                handles = np.array(sorted(pend["changed"]), dtype=np.int64)
                delta = {
                    "changed_handles": handles,
                    "changed_values": [pend["changed"][int(h)][0] for h in handles],
                    "changed_commit_ts": np.array(
                        [pend["changed"][int(h)][1] for h in handles], dtype=np.int64),
                    "deleted_handles": np.array(sorted(pend["deleted"]), dtype=np.int64),
                    "max_commit_ts": max(img.max_commit_ts, pend["max_ct"]),
                }
                n = img.apply_delta(delta, apply_index, start_ts)
                img.wt_pending = None
                self.stats.wt_deltas += 1
                self.stats.wt_rows += n
                self._enforce_budget(keep=key)
                return self._outcome("wt_delta", img, n)
            delta = scan_delta(snap, start_ts, ranges, img.handles, img.row_commit_ts,
                               statistics=stats)
            if delta is None:
                self._drop(key, reason="unvectorizable")
                return self._outcome("uncacheable")
            n_touch = len(delta["changed_handles"]) + len(delta["deleted_handles"])
            if img.n_rows and n_touch > _REBUILD_FRACTION * img.n_rows:
                self._drop(key, reason="delta_too_big")
                return self._build(key, epoch, snap, columns_info, ranges, start_ts,
                                   apply_index, stats)
            n = img.apply_delta(delta, apply_index, start_ts)
            if apply_index >= img.locks_dirty_at:
                # scan_delta lock-checked the ranges on a snapshot that holds
                # the dirtying batch
                img.locks_dirty = False
            pend = img.wt_pending
            if pend is not None and (pend["apply_index"] <= img.apply_index
                                     or img.apply_index < pend["base"]):
                # the scan repaired past the pending chain (or rewound under
                # its base): replaying it would regress rows
                img.wt_pending = None
            self.stats.deltas += 1
            self.stats.delta_rows += n
            self._enforce_budget(keep=key)
            return self._outcome("delta", img, n)

    def invalidate_region(self, region_id: int, reason: str = "epoch") -> None:
        with self._mu:
            for key in [k for k in self._images if k[0] == region_id]:
                self._drop(key, reason=reason)
            # the notify watermark dies with the images; a live region's
            # next notify seeds it again before a new image can be built
            self._wt_seen.pop(region_id, None)

    def total_bytes(self) -> int:
        with self._mu:
            return sum(img.nbytes for img in self._images.values())

    def __len__(self) -> int:
        return len(self._images)

    # -- write-through intake ----------------------------------------------

    def apply_write(self, region_id: int, parse_once, apply_index: int, token=None) -> None:
        """Buffer a committed batch's row changes on every resident image of
        ``region_id``.  Notifies arrive in apply-index order per region; an
        index at or below the watermark is a replay and is skipped.
        ``parse_once`` (which may read CF_DEFAULT) runs outside the lock."""
        with self._mu:
            if self._wt_token is _TOKEN_UNSET or token != self._wt_token:
                return  # not this cache's engine (or it never served yet)
            prev = self._wt_seen.get(region_id, -1)
            if apply_index <= prev:
                return
            # the watermark advances even with write-through off: turning it
            # back on must not start a pending chain across unseen batches
            self._wt_seen[region_id] = apply_index
            if not self.write_through:
                self._drop_pendings_locked(region_id)
                return
            if not any(k[0] == region_id for k in self._images):
                return
        parsed = parse_once()
        with self._mu:
            # images may have churned while parsing: list them again
            imgs = [img for k, img in self._images.items() if k[0] == region_id]
            if not imgs:
                return
            if parsed is None:
                # not expressible as row changes: the pendings are gapped now
                for img in imgs:
                    img.wt_pending = None
                self.stats.wt_lost += 1
                return
            writes, lock_keys = parsed
            for img in imgs:
                self._merge_pending(img, writes, lock_keys, prev, apply_index)

    def note_write_lost(self, region_id: int, apply_index: int, token=None) -> None:
        """A data change of unknown content landed: drop the pendings (a
        dropped chain costs a scan_delta repair; one kept across an unseen
        batch would serve wrong rows) and advance the watermark."""
        with self._mu:
            if self._wt_token is _TOKEN_UNSET or token != self._wt_token:
                return
            if apply_index > self._wt_seen.get(region_id, -1):
                self._wt_seen[region_id] = apply_index
            self._drop_pendings_locked(region_id)

    def _drop_pendings_locked(self, region_id: int) -> None:
        dropped = False
        for k, img in self._images.items():
            if k[0] == region_id and img.wt_pending is not None:
                img.wt_pending = None
                dropped = True
        if dropped:
            self.stats.wt_lost += 1

    def _merge_pending(self, img, writes, lock_keys, prev: int, apply_index: int) -> None:
        ranges = img.key[1]
        if any(_in_ranges(rk, ranges) for rk in lock_keys):
            img.locks_dirty = True
            img.locks_dirty_at = max(img.locks_dirty_at, apply_index)
        pend = img.wt_pending
        if pend is None:
            if prev > img.apply_index or apply_index <= img.apply_index:
                # a batch between the image's state and this one was never
                # buffered (image built mid-stream, or emission was off): the
                # image repairs through scan_delta, not a gapped chain
                return
            if self._wt_late_bound and prev < 0:
                # the first notify seen for this region on a late-bound
                # cache: earlier ones may have been dropped unseen
                return
            pend = img.wt_pending = {"base": img.apply_index, "apply_index": apply_index,
                                     "changed": {}, "deleted": set(), "max_ct": 0}
        else:
            pend["apply_index"] = apply_index
        for raw, cts, v in writes:
            if not _in_ranges(raw, ranges):
                continue
            if len(raw) != 19:
                # a non-record key inside a record range: not foldable
                self._drop_pending_img(img)
                return
            try:
                h = int(decode_record_handles([raw])[0])
            except Exception:  # noqa: BLE001
                self._drop_pending_img(img)
                return
            if v is None:
                pend["changed"].pop(h, None)
                pend["deleted"].add(h)
            else:
                pend["deleted"].discard(h)
                pend["changed"][h] = (v, cts)
            pend["max_ct"] = max(pend["max_ct"], cts)
        if len(pend["changed"]) + len(pend["deleted"]) > max(1024, img.n_rows):
            # the pending outgrew the image: a rebuild beats replaying it
            self._drop_pending_img(img)

    def _drop_pending_img(self, img) -> None:
        if img.wt_pending is not None:
            img.wt_pending = None
            self.stats.wt_lost += 1

    # -- internals ---------------------------------------------------------

    def _outcome(self, outcome: str, img=None, n: int = 0):
        """Count ``outcome`` and return the serve triple."""
        if outcome == "hit":
            self.stats.hits += 1
        elif outcome in ("stale", "uncacheable"):
            setattr(self.stats, outcome, getattr(self.stats, outcome) + 1)
        _count(OUTCOME_COUNTS, outcome)
        if n:
            _count(OUTCOME_COUNTS, "delta_rows", n)
        return (img.block_cache if img is not None else None), outcome, n

    def _build(self, key, epoch, snap, columns_info, ranges, start_ts, apply_index, stats):
        """Build an image for ``key`` (the expensive part outside the lock)
        and insert it; a racing build of the same key keeps the image of the
        newer apply index, and this request serves its own blocks."""
        src = MvccBatchScanSource(snap, start_ts, ranges, statistics=stats,
                                  record_versions=True)
        keys, values = src._resolve_all()
        if not src.versions_exact:
            return self._outcome("uncacheable")
        handles = decode_record_handles(keys)
        if len(handles) > 1 and not (handles[1:] > handles[:-1]).all():
            return self._outcome("uncacheable")
        img = RegionImage(key, epoch, list(columns_info), self.block_rows)
        img.fill(handles, values, src.row_commit_ts, src.max_commit_ts, apply_index, start_ts,
                 encode=self.encode_columns)
        if img.nbytes > self.byte_budget:
            # serve this request from the blocks just built, but keep nothing
            # resident: the budget is the memory guard
            self.stats.uncacheable += 1
            _count(OUTCOME_COUNTS, "too_big")
            return img.block_cache, "too_big", 0
        with self._mu:
            existing = self._images.get(key)
            if (existing is None or existing.epoch != epoch
                    or existing.apply_index <= apply_index):
                self._images[key] = img
                self._enforce_budget(keep=key)
            self.stats.misses += 1
            self.stats.bytes_pinned = sum(i.nbytes for i in self._images.values())
        _count(OUTCOME_COUNTS, "miss")
        return img.block_cache, "miss", 0

    def _hit_fresh_locked(self, img, apply_index, start_ts, snap, ranges, stats) -> bool:
        """True iff the image may serve ``start_ts`` as it is at
        ``apply_index``.  Scans CF_LOCK when it must (raising on a blocking
        lock, as the scanners do) and keeps ``locks_dirty`` and
        ``snapshot_ts`` as a served hit does.  Caller holds the lock."""
        if start_ts < img.snapshot_ts:
            # the image may hold rows committed above this reader's ts
            return False
        if not (apply_index == img.apply_index and (
                start_ts == img.snapshot_ts or img.max_commit_ts <= img.snapshot_ts)):
            return False
        if start_ts > img.snapshot_ts or img.locks_dirty:
            seen = self._check_locks(snap, ranges, start_ts, stats)
            if seen == 0 and apply_index >= img.locks_dirty_at:
                # this snapshot holds the dirtying batch and the range is
                # lock-free; an older snapshot seeing no lock proves nothing
                img.locks_dirty = False
            img.snapshot_ts = max(img.snapshot_ts, start_ts)
        return True

    def _check_locks(self, snap, ranges, ts, stats) -> int:
        """Raise on a blocking lock; return how many locks the ranges hold."""
        seen = 0
        for start, end in ranges:
            enc_start = Key.from_raw(start).encoded
            enc_end = Key.from_raw(end).encoded
            for k, v in snap.scan_cf(CF_LOCK, enc_start, enc_end):
                stats.lock.next += 1
                seen += 1
                _check_lock(v, Key.from_encoded(k).to_raw(), ts, frozenset())
        return seen

    def _drop(self, key, reason: str) -> None:
        img = self._images.pop(key, None)
        if img is None:
            return
        img.block_cache.clear_blocks()
        img.block_cache.filled = False
        self.stats.invalidations += 1
        _count(INVALIDATE_COUNTS, reason)
        self.stats.bytes_pinned = sum(i.nbytes for i in self._images.values())

    def _enforce_budget(self, keep) -> None:
        """Evict least recently used images (never ``keep``) while the cache
        holds more than ``max_regions`` images or, with more than one image,
        more than ``byte_budget`` bytes."""
        while len(self._images) > self.max_regions or (
                sum(i.nbytes for i in self._images.values()) > self.byte_budget
                and len(self._images) > 1):
            victim = next((k for k in self._images if k != keep), None)
            if victim is None:
                break
            img = self._images.pop(victim)
            img.block_cache.clear_blocks()
            img.block_cache.filled = False
            self.stats.evictions += 1
        self.stats.bytes_pinned = sum(i.nbytes for i in self._images.values())
