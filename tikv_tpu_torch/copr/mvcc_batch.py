"""Vectorized MVCC range resolution — the region image's fill and delta scan.

The port's own copy of ``tikv_tpu/copr/mvcc_batch.py``.  The per-key
``ForwardScanner`` walks cursors in interpreted Python, far too slow to fill
a region image of millions of rows; this module resolves a whole CF_WRITE
range columnwise:

  1. slice the snapshot's sorted write-CF range
  2. stack the fixed-width keys into an (n, W) byte matrix — record keys of
     one table all encode to the same width, checked in O(n) — and split
     user_key / desc(commit_ts) by slicing
  3. group rows by user key (adjacent-row compare), pick each key's newest
     version with commit_ts <= ts via a segment-min over row indices
  4. parse the chosen Write records vectorized when they share the common
     PUT+short_value layout; anything unusual (rollback/lock/delete/gc-fence,
     large values) resolves exactly, per picked key (``record_versions``) or
     through the per-key scanner for the range

:func:`scan_delta` diffs a range's newest visible versions against a cached
image's per-row commit_ts and resolves only the rows that moved.

Correctness contract: identical output to ``ForwardScanner``, lock checks
included.  This is host work feeding the device, so everything here is
numpy; there is no per-row Python in the common path.
"""

from __future__ import annotations

import numpy as np

from ..storage.engine import CF_DEFAULT, CF_LOCK, CF_WRITE, Snapshot
from ..storage.mvcc import ForwardScanner, Statistics
from ..storage.mvcc.reader import IsolationLevel, PointGetter, _check_lock
from ..storage.txn_types import Key, Write, WriteType, append_ts
from ..util import codec
from .executors import ScanSource
from .table import decode_record_handles

_TS_W = 8
_PUT = int(WriteType.PUT)
_SHORT_PREFIX = 0x76  # b'v'


def _decode_user_keys(key_rows: np.ndarray) -> list[bytes]:
    """Vectorized memcomparable decode of same-width encoded keys: drop the
    marker byte of each 9-byte group and trim the final group's padding
    (markers verified uniform; per-row fallback otherwise)."""
    n, w = key_rows.shape
    if w % 9 == 0:
        groups = w // 9
        markers = key_rows[:, 8::9]
        if (markers == markers[0]).all():
            raw0, _ = codec.decode_bytes(key_rows[0].tobytes())
            data_cols = np.concatenate(
                [key_rows[:, g * 9 : g * 9 + 8] for g in range(groups)], axis=1
            )[:, : len(raw0)]
            data_cols = np.ascontiguousarray(data_cols)
            return [r.tobytes() for r in data_cols]
    return [codec.decode_bytes(key_rows[i].tobytes())[0] for i in range(n)]


class MvccBatchScanSource(ScanSource):
    """Drop-in ScanSource resolving whole ranges vectorized.

    With ``record_versions=True`` the vectorized paths additionally record a
    per-output-row version fingerprint (the commit_ts of the newest CF_WRITE
    entry at or below ``ts``) plus the range's overall max commit_ts — the
    raw material the region column cache needs to detect deltas later.  A
    range that takes the exact per-key fallback clears ``versions_exact``;
    callers wanting version info must then decline (the cache simply does
    not form).
    """

    def __init__(
        self,
        snapshot: Snapshot,
        ts: int,
        ranges: list[tuple[bytes, bytes]],
        statistics: Statistics | None = None,
        bypass_locks: frozenset[int] = frozenset(),
        record_versions: bool = False,
    ):
        self.snap = snapshot
        self.ts = ts
        self.ranges = ranges
        self.stats = statistics or Statistics()
        self.bypass_locks = bypass_locks
        self.record_versions = record_versions
        self.versions_exact = True
        self.row_commit_ts: np.ndarray | None = None
        self.max_commit_ts = 0
        self._resolved: tuple[list[bytes], list[bytes]] | None = None
        self._pos = 0

    def _resolve_all(self) -> tuple[list[bytes], list[bytes]]:
        keys_out: list[bytes] = []
        vals_out: list[bytes] = []
        cts_out: list[np.ndarray] = []
        for start, end in self.ranges:
            k, v = self._resolve_range(start, end)
            keys_out.extend(k)
            vals_out.extend(v)
            if self.record_versions:
                if self._range_cts is None:
                    self.versions_exact = False
                else:
                    cts_out.append(self._range_cts)
                    self.max_commit_ts = max(self.max_commit_ts, self._range_max_ct)
        if self.record_versions and self.versions_exact:
            self.row_commit_ts = (
                np.concatenate(cts_out) if cts_out else np.empty(0, dtype=np.int64)
            )
        return keys_out, vals_out

    def _resolve_range(self, start: bytes, end: bytes) -> tuple[list[bytes], list[bytes]]:
        # version info for the range just resolved (record_versions bookkeeping)
        self._range_cts: np.ndarray | None = None
        self._range_max_ct = 0
        enc_start = Key.from_raw(start).encoded
        enc_end = Key.from_raw(end).encoded
        # lock checks, same rule as the scanner
        for k, v in self.snap.scan_cf(CF_LOCK, enc_start, enc_end):
            self.stats.lock.next += 1
            _check_lock(v, Key.from_encoded(k).to_raw(), self.ts, self.bypass_locks)

        # the generic path; a fixed-stride ``scan_raw`` fast path belongs
        # with an engine that offers one
        pairs = list(self.snap.scan_cf(CF_WRITE, enc_start, enc_end))
        if not pairs:
            self._range_cts = np.empty(0, dtype=np.int64)
            return [], []
        wkeys = [k for k, _ in pairs]
        width = len(wkeys[0])
        if any(len(k) != width for k in wkeys):
            return self._fallback(start, end)
        n = len(wkeys)
        arr = np.frombuffer(b"".join(wkeys), dtype=np.uint8).reshape(n, width)
        user = arr[:, : width - _TS_W]
        commit_ts = codec.decode_u64_batch(arr[:, width - _TS_W :]) ^ np.uint64(
            0xFFFFFFFFFFFFFFFF
        )
        # group boundaries: first row of each user key (rows sorted, versions
        # commit_ts-descending within a key)
        first = np.empty(n, dtype=bool)
        first[0] = True
        if n > 1:
            first[1:] = (user[1:] != user[:-1]).any(axis=1)
        gid = np.cumsum(first) - 1
        n_keys = int(gid[-1]) + 1

        visible = commit_ts <= np.uint64(self.ts)
        # newest visible version per key: reversed fancy-store keeps the
        # smallest row index (= highest commit_ts) per group
        pick_arr = np.full(n_keys, -1, dtype=np.int64)
        vis_idx = np.flatnonzero(visible)
        pick_arr[gid[vis_idx][::-1]] = vis_idx[::-1]
        pick = pick_arr[pick_arr >= 0]  # keys with at least one visible version
        self._range_max_ct = int(commit_ts.max())
        if len(pick) == 0:
            self._range_cts = np.empty(0, dtype=np.int64)
            return [], []
        pick_cts = commit_ts[pick].astype(np.int64)

        values = [pairs[i][1] for i in pick]
        # vectorized write-record parse: common layout check
        vlens = np.fromiter((len(v) for v in values), dtype=np.int64, count=len(values))
        if len(values) and (vlens == vlens[0]).all():
            vw = int(vlens[0])
            varr = np.frombuffer(b"".join(values), dtype=np.uint8).reshape(len(values), vw)
            simple = self._parse_simple_layout(varr, vw)
            if simple is not None:
                self.stats.write.processed_keys += len(pick)
                # the same raw keys as a per-key decode, without Python per key
                out_keys = _decode_user_keys(np.ascontiguousarray(arr[pick, : width - _TS_W]))
                self._range_cts = pick_cts
                return out_keys, simple
        if self.record_versions:
            return self._exact_picked(pick, pick_cts, arr, width, values)
        # mixed/unusual records: exact per-key resolution for the whole range
        return self._fallback(start, end)

    def _exact_picked(self, pick, pick_cts, arr, width, values):
        """Record-versions build path for ranges whose picked records don't
        share one layout: the key-space work stays vectorized, and only the
        picked (newest-visible) record of each key parses exactly — PUTs
        yield their value, DELETEs drop the key, LOCK/ROLLBACK re-resolve
        through older versions.  Version fingerprints stay the picked
        entry's commit_ts, matching ``scan_delta``."""
        key_rows = np.ascontiguousarray(arr[pick, : width - _TS_W])
        raw_keys = _decode_user_keys(key_rows)
        keep: list[int] = []
        vals: list[bytes] = []
        for j in range(len(pick)):
            w = Write.from_bytes(values[j])
            if w.write_type == WriteType.PUT:
                v = w.short_value
                if v is None:
                    enc = Key.from_raw(raw_keys[j]).encoded
                    self.stats.data.get += 1
                    v = self.snap.get_cf(CF_DEFAULT, append_ts(enc, w.start_ts))
                    if v is None:
                        raise ValueError(f"default value missing for {raw_keys[j]!r}")
            elif w.write_type == WriteType.DELETE:
                continue
            else:  # LOCK / ROLLBACK records: an older version decides
                enc = Key.from_raw(raw_keys[j]).encoded
                v = _resolve_one(self.snap, enc, self.ts, self.stats)
                if v is None:
                    continue
            keep.append(j)
            vals.append(v)
        self.stats.write.processed_keys += len(keep)
        self._range_cts = pick_cts[np.array(keep, dtype=np.int64)] if keep else np.empty(0, dtype=np.int64)
        return [raw_keys[j] for j in keep], vals

    def _parse_simple_layout(self, varr: np.ndarray, vw: int) -> list[bytes] | None:
        """All records = [P][varint start_ts][v][len][short_value]? Verify the
        constant skeleton and slice out the short values."""
        if not (varr[:, 0] == _PUT).all():
            return None
        # varint start_ts length: find first byte < 0x80 starting at col 1
        off = 1
        while off < vw and (varr[:, off] >= 0x80).any():
            # all rows must agree the byte is a continuation byte
            if not (varr[:, off] >= 0x80).all():
                return None
            off += 1
        off += 1  # the terminating varint byte
        if off + 1 >= vw:
            return None
        if not (varr[:, off] == _SHORT_PREFIX).all():
            return None
        ln = varr[:, off + 1]
        if not (ln == vw - off - 2).all():
            return None
        payload = varr[:, off + 2 :]
        return [p.tobytes() for p in payload]

    def _fallback(self, start: bytes, end: bytes) -> tuple[list[bytes], list[bytes]]:
        ks, vs = [], []
        for k, v in ForwardScanner(
            self.snap,
            self.ts,
            Key.from_raw(start),
            Key.from_raw(end),
            bypass_locks=self.bypass_locks,
            statistics=self.stats,
        ):
            ks.append(k)
            vs.append(v)
        return ks, vs

    def next_batch(self, n: int) -> tuple[list[bytes], list[bytes], bool]:
        if self._resolved is None:
            self._resolved = self._resolve_all()
        keys, vals = self._resolved
        lo = self._pos
        hi = min(lo + n, len(keys))
        self._pos = hi
        return keys[lo:hi], vals[lo:hi], hi >= len(keys)


# ---------------------------------------------------------------------------
# Delta resolution against a cached region image (region_cache.py)
# ---------------------------------------------------------------------------


def _resolve_one(snap: Snapshot, enc_user_key: bytes, ts: int, stats: Statistics) -> bytes | None:
    """Exact visible value of one key at ``ts`` — PointGetter under RC (no
    per-key lock check: callers lock-check the whole range once)."""
    return PointGetter(
        snap, ts, isolation=IsolationLevel.RC, statistics=stats
    ).get(Key.from_encoded(enc_user_key))


def scan_delta(
    snap: Snapshot,
    ts: int,
    ranges: list[tuple[bytes, bytes]],
    image_handles: np.ndarray,
    image_commit_ts: np.ndarray,
    statistics: Statistics | None = None,
    bypass_locks: frozenset[int] = frozenset(),
):
    """Diff the engine's newest-visible versions against a cached image.

    One vectorized pass over the CF_WRITE keys of ``ranges`` (no value
    parsing, no row decode) finds the keys whose version fingerprint — the
    commit_ts of the newest entry at or below ``ts`` — differs from the
    image's; only those are resolved exactly.  Returns None when the ranges
    are not vectorizable (non-uniform key widths or non-record keys), else::

        {"changed_handles", "changed_values", "changed_commit_ts",
         "deleted_handles", "max_commit_ts", "n_visible"}

    ``deleted_handles`` are image rows with no visible version anymore;
    ``changed_values`` align with ``changed_handles`` and are the exact MVCC
    values (a changed key that resolves to nothing joins the deleted set
    instead).  Lock checks run over each whole range, like the scanners.
    """
    stats = statistics or Statistics()
    vis_handles: list[np.ndarray] = []
    vis_cts: list[np.ndarray] = []
    vis_enc_keys: list[np.ndarray] = []  # (k, keylen) byte matrix per range
    vis_pick_vals: list[list] = []  # lazily-fetched picked record values
    max_ct = 0
    for start, end in ranges:
        enc_start = Key.from_raw(start).encoded
        enc_end = Key.from_raw(end).encoded
        for k, v in snap.scan_cf(CF_LOCK, enc_start, enc_end):
            stats.lock.next += 1
            _check_lock(v, Key.from_encoded(k).to_raw(), ts, bypass_locks)
        pairs = list(snap.scan_cf(CF_WRITE, enc_start, enc_end))
        if not pairs:
            continue
        wkeys = [k for k, _ in pairs]
        width = len(wkeys[0])
        if any(len(k) != width for k in wkeys):
            return None
        n = len(wkeys)
        arr = np.frombuffer(b"".join(wkeys), dtype=np.uint8).reshape(n, width)
        user = arr[:, : width - _TS_W]
        commit_ts = codec.decode_u64_batch(arr[:, width - _TS_W :]) ^ np.uint64(
            0xFFFFFFFFFFFFFFFF
        )
        max_ct = max(max_ct, int(commit_ts.max()))
        first = np.empty(n, dtype=bool)
        first[0] = True
        if n > 1:
            first[1:] = (user[1:] != user[:-1]).any(axis=1)
        gid = np.cumsum(first) - 1
        n_keys = int(gid[-1]) + 1
        visible = commit_ts <= np.uint64(ts)
        pick_arr = np.full(n_keys, -1, dtype=np.int64)
        vis_idx = np.flatnonzero(visible)
        pick_arr[gid[vis_idx][::-1]] = vis_idx[::-1]
        has_vis = pick_arr >= 0
        first_idx = np.flatnonzero(first)
        key_rows = np.ascontiguousarray(arr[first_idx[has_vis], : width - _TS_W])
        raw_keys = _decode_user_keys(key_rows)
        lens = {len(rk) for rk in raw_keys}
        if lens and lens != {19}:
            return None  # not record keys — the cache only images tables
        handles = decode_record_handles(raw_keys)
        if len(handles) > 1 and not (handles[1:] > handles[:-1]).all():
            return None
        vis_handles.append(handles)
        vis_cts.append(commit_ts[pick_arr[has_vis]].astype(np.int64))
        vis_enc_keys.append(key_rows)
        vis_pick_vals.append([pairs[i][1] for i in pick_arr[has_vis]])

    if vis_handles:
        handles = np.concatenate(vis_handles)
        cts = np.concatenate(vis_cts)
    else:
        handles = np.empty(0, dtype=np.int64)
        cts = np.empty(0, dtype=np.int64)
    if len(handles) > 1 and not (handles[1:] > handles[:-1]).all():
        return None  # ranges out of handle order — images are handle-sorted

    # changed = visible keys whose fingerprint disagrees with the image
    pos = np.searchsorted(image_handles, handles)
    pos_c = np.minimum(pos, max(len(image_handles) - 1, 0))
    if len(image_handles):
        present = image_handles[pos_c] == handles
        same = present & (image_commit_ts[pos_c] == cts)
    else:
        present = np.zeros(len(handles), dtype=bool)
        same = present
    changed_idx = np.flatnonzero(~same)

    # deleted = image rows whose handle no longer has a visible version
    gone = np.ones(len(image_handles), dtype=bool)
    if len(handles):
        ipos = np.searchsorted(handles, image_handles)
        ipos_c = np.minimum(ipos, len(handles) - 1)
        gone = handles[ipos_c] != image_handles
    deleted = set(image_handles[gone].tolist())

    changed_handles: list[int] = []
    changed_values: list[bytes] = []
    changed_cts: list[int] = []
    # re-encode only the changed keys (tiny): raw record key -> encoded form
    offsets = np.cumsum([0] + [len(h) for h in vis_handles])
    for ci in changed_idx:
        ri = int(np.searchsorted(offsets, ci, side="right") - 1)
        local = int(ci - offsets[ri])
        # vis_enc_keys rows ARE the memcomparable-encoded user keys (sliced
        # straight off the CF_WRITE key matrix) — use them as-is
        enc_user = vis_enc_keys[ri][local].tobytes()
        # fast path: the picked record is a plain PUT with a short value
        val = None
        rec = vis_pick_vals[ri][local]
        if rec and rec[0] == _PUT:
            try:
                w = _parse_write_short(rec)
            except ValueError:
                w = None
            if w is not None:
                val = w
        if val is None:
            val = _resolve_one(snap, enc_user, ts, stats)
        h = int(handles[ci])
        if val is None:
            if bool(present[ci]):
                deleted.add(h)
            continue
        changed_handles.append(h)
        changed_values.append(val)
        changed_cts.append(int(cts[ci]))

    return {
        "changed_handles": np.array(changed_handles, dtype=np.int64),
        "changed_values": changed_values,
        "changed_commit_ts": np.array(changed_cts, dtype=np.int64),
        "deleted_handles": np.array(sorted(deleted), dtype=np.int64),
        "max_commit_ts": max_ct,
        "n_visible": int(len(handles)),
    }


def _parse_write_short(rec: bytes) -> bytes | None:
    """Short-value payload of a PUT write record, or None when the record
    carries flags/indirection the fast path must not guess about."""
    w = Write.from_bytes(rec)
    if w.write_type != WriteType.PUT or w.gc_fence is not None:
        return None
    return w.short_value  # None ⇒ CF_DEFAULT value: exact path handles it
