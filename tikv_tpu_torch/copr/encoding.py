"""Encoded device-resident columns: the encodings, their payloads, late materialization.

The port's own copy of ``tikv_tpu/copr/encoding.py``, trimmed to what the
warm paths read.  A region image is encoded once, when it is filled
(:func:`encode_blocks`), with ONE form per column for the whole image so the
blocks stack into one tensor per column:

* **bitpack** (``bp``): int-family columns whose value range fits a narrow
  signed lane store ``value - ref`` in int8/int16/int32 under one frame of
  reference for the image;
* **rle**: columns dominated by runs store ``(run_values, run_ends,
  run_nulls)`` per block, padded to one run capacity ``k_cap``;
* **code**: dictionary codes narrowed to the smallest lane that holds the
  dictionary (:func:`narrow_dict_codes`); low-cardinality object BYTES get a
  sorted dictionary shared by every block (:func:`_dict_encode_blocks`).

The device pins the encoded payloads (:func:`device_plan`,
:func:`stack_block_payloads`) and every kernel that reads the image widens
them in-kernel (``copr/kernels.py:decode_device_column`` is the plain
version).  Decoding is exact and null slots decode to the canonical 0, so an
encoded image answers byte for byte as its decoded image does.  The rules
(thresholds, lane choice, "halve the bytes") are the JAX package's, so both
packages encode a table identically.

:func:`batch_plan` decides for the images of a batch at once whether they
ship encoded or decoded, and counts each decision and decline in
``PATH_COUNTS`` and ``DECLINE_COUNTS`` (the JAX package's ``count_path`` and
``count_decline`` metrics, as plain counters).

Write-through deltas (``copr/region_cache.py``) patch a bitpacked payload in
place while the new values fit its lanes (:meth:`EncodedColumn.try_patch`)
and otherwise demote the column image-wide to plain decoded arrays
(:func:`demote_column`, counted in ``DEMOTE_COUNTS``).  Not here: the
dictionary code-space predicate rewrite.
"""

from __future__ import annotations

import numpy as np

from .datatypes import Column, EvalType

# minimum win before a column trades decode work for bytes: bitpack must
# shed at least half the lanes, RLE must shed at least 3/4 of the slots
_RLE_MAX_RUN_FRACTION = 0.25
_NARROW_DTYPES = (np.int8, np.int16, np.int32)
_DICT_MAX_CARDINALITY = 65536

# dictionary -> (code map, sortedness) memo (id-keyed, bounded; the
# dictionary object is held so that its id cannot be recycled under the entry)
_DICT_MAPS: dict = {}
_DICT_MAPS_MAX = 64

#: (path, decision) -> batches: "encoded" or "decoded_ship" (batch_plan)
PATH_COUNTS: dict[tuple[str, str], int] = {}
#: (path, cause) -> batches declined from encoded serving ("enc_mismatch")
DECLINE_COUNTS: dict[tuple[str, str], int] = {}
#: (kind, cause) -> encoded columns demoted to plain decoded arrays
#: ("inplace_update": an update of an RLE column; "value_range": a bitpacked
#: column's new values outside its lanes)
DEMOTE_COUNTS: dict[tuple[str, str], int] = {}


def count_path(path: str, decision: str) -> None:
    PATH_COUNTS[path, decision] = PATH_COUNTS.get((path, decision), 0) + 1


def count_decline(path: str, cause: str) -> None:
    DECLINE_COUNTS[path, cause] = DECLINE_COUNTS.get((path, cause), 0) + 1


def count_demote(kind: str, cause: str) -> None:
    DEMOTE_COUNTS[kind, cause] = DEMOTE_COUNTS.get((kind, cause), 0) + 1


# ---------------------------------------------------------------------------
# EncodedColumn: a lazily decoding Column
# ---------------------------------------------------------------------------

class EncodedColumn(Column):
    """A :class:`Column` whose resident payload is encoded.

    ``data``/``nulls`` are properties that decode (and cache) on first
    touch, so the host consumers (response encoding, host group ids, the CPU
    executors) stay correct without knowing about encodings; the device
    paths read the payload and decode in-kernel.  ``take`` decodes only the
    selected rows (late materialization)."""

    __slots__ = ("kind", "packed", "ref", "run_values", "run_ends",
                 "run_nulls", "k_cap", "n", "_data", "_nulls")

    def __init__(self, eval_type, frac, kind, n, *, packed=None, ref=0,
                 run_values=None, run_ends=None, run_nulls=None, k_cap=0,
                 nulls=None):
        # no super().__init__: the base slots data/nulls are shadowed by
        # the properties below
        self.eval_type = eval_type
        self.frac = frac
        self.dictionary = None
        self.kind = kind  # "bp" | "rle"
        self.n = n
        self.packed = packed
        self.ref = int(ref)
        self.run_values = run_values
        self.run_ends = run_ends
        self.run_nulls = run_nulls
        self.k_cap = int(k_cap)
        self._data = None
        self._nulls = nulls  # bp keeps row-shaped bool nulls; rle expands lazily

    def __len__(self) -> int:
        return self.n

    @property
    def data(self):
        if self._data is None:
            self._data = self._decode_rows(None)
        return self._data

    @property
    def nulls(self):
        if self._nulls is None:  # rle only
            self._nulls = self.run_nulls[self._run_index(np.arange(self.n))]
        return self._nulls

    def _run_index(self, rows: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.run_ends, rows, side="right")

    def _decode_rows(self, rows):
        """Decode all rows (``rows`` None) or the selected ones; null slots
        decode to 0."""
        if self.kind == "bp":
            if rows is None:
                out = self.packed.astype(np.int64)
                out += self.ref
                out[self._nulls] = 0
            else:
                out = self.packed[rows].astype(np.int64)
                out += self.ref
                out[self._nulls[rows]] = 0
            return out
        idx = self._run_index(np.arange(self.n) if rows is None else rows)
        out = self.run_values[idx].astype(np.int64, copy=True)
        out[self.run_nulls[idx]] = 0
        return out

    def take(self, indices: np.ndarray) -> Column:
        """Late materialization: decode only the surviving rows."""
        indices = np.asarray(indices)
        data = self._decode_rows(indices)
        if self.kind == "bp":
            nulls = self._nulls[indices]
        else:
            nulls = self.run_nulls[self._run_index(indices)]
        return Column(self.eval_type, data, nulls.copy(), self.frac)

    def slice(self, start: int, stop: int) -> Column:
        return self.take(np.arange(start, stop))

    def purge_decoded(self) -> None:
        """Drop the cached full decode (the payload stays): a host pass that
        read ``data`` over a whole image need not leave it resident."""
        self._data = None
        if self.kind == "rle":
            self._nulls = None  # expanded from the run nulls on the next touch

    def encoded_nbytes(self) -> int:
        if self.kind == "bp":
            return self.packed.nbytes + self._nulls.nbytes
        return self.run_values.nbytes + self.run_ends.nbytes + self.run_nulls.nbytes

    def try_patch(self, rows: np.ndarray, vals: np.ndarray, nls: np.ndarray) -> bool:
        """In-place update of the encoded payload; False = encoding broken
        (the caller demotes).  Any in-place write to an RLE column breaks its
        runs; a bitpacked write survives while the new values fit the lanes."""
        if self.kind != "bp":
            return False
        info = np.iinfo(self.packed.dtype)
        v = np.asarray(vals, dtype=np.int64)
        live = ~np.asarray(nls, dtype=bool)
        rel = v - self.ref
        if live.any() and (int(rel[live].min()) < info.min or int(rel[live].max()) > info.max):
            return False
        self.packed[rows] = np.where(live, rel, 0).astype(self.packed.dtype)
        self._nulls[rows] = nls
        if self._data is not None:
            self._data[rows] = np.where(live, v, 0)
        return True


def decoded_data(col: Column):
    """The decoded data array without caching it on the column."""
    if isinstance(col, EncodedColumn):
        return col._data if col._data is not None else col._decode_rows(None)
    return col.data


def decoded_nulls(col: Column):
    """The row-shaped null mask without caching it on an RLE column."""
    if isinstance(col, EncodedColumn) and col.kind == "rle" and col._nulls is None:
        return col.run_nulls[col._run_index(np.arange(col.n))]
    return col.nulls


def _dict_map_for(dictionary) -> tuple[dict, bool]:
    """(bytes -> code map, is_sorted) for a dictionary object, memoized by
    identity: the join rung's remap and zone pruning read the sortedness."""
    key = id(dictionary)
    hit = _DICT_MAPS.get(key)
    if hit is not None and hit[0] is dictionary:
        return hit[1], hit[2]
    vals = [bytes(v) for v in dictionary]
    m = {v: j for j, v in enumerate(vals)}
    is_sorted = all(vals[j] < vals[j + 1] for j in range(len(vals) - 1))
    _DICT_MAPS[key] = (dictionary, m, is_sorted)
    while len(_DICT_MAPS) > _DICT_MAPS_MAX:
        _DICT_MAPS.pop(next(iter(_DICT_MAPS)))
    return m, is_sorted


def decode_column(col: Column) -> Column:
    """A plain decoded Column for ``col`` (identity for unencoded ones)."""
    if isinstance(col, EncodedColumn):
        return Column(col.eval_type, np.asarray(col.data), np.asarray(col.nulls).copy(),
                      col.frac)
    return col


def host_dtype(col: Column):
    """The decoded host dtype of a column (what delta cells compute in)."""
    if isinstance(col, EncodedColumn):
        return np.dtype(np.int64)
    d = np.asarray(col.data)
    if col.is_dict_encoded and d.dtype != object:
        return np.dtype(np.int64)  # codes widen before delta math
    return d.dtype


def demote_column(cache, ci: int, cause: str) -> None:
    """Replace an encoded column with its plain decoded form image-wide
    (every block: the stacked signatures must stay uniform) and drop the
    device pins; the next serve pins the decoded lanes.  The
    decode-on-next-serve rung for updates that break an encoding."""
    kind = None
    for b in cache.blocks:
        c = b.cols[ci]
        if isinstance(c, EncodedColumn):
            kind = c.kind
            b.cols[ci] = decode_column(c)
    if kind is not None:
        count_demote(kind, cause)
        cache.enc_version += 1
        cache.drop_device()


# ---------------------------------------------------------------------------
# The fill-time stats pass
# ---------------------------------------------------------------------------

def _narrow_lane(lo: int, hi: int, ref: int):
    for dt in _NARROW_DTYPES:
        info = np.iinfo(dt)
        if info.min <= lo - ref and hi - ref <= info.max:
            return dt
    return None


def _encode_one(col: Column, n_valid: int):
    """The encoded form of one block column, or None to keep it as it is.
    Int-family lanes only: REAL and object columns stay plain."""
    data = col.data if not isinstance(col, EncodedColumn) else None
    if data is None or not isinstance(data, np.ndarray) or data.dtype == object:
        return None
    if col.eval_type == EvalType.REAL or data.dtype.kind not in "iu":
        return None
    if col.is_dict_encoded:
        return None  # dictionary codes narrow through narrow_dict_codes
    n = len(data)
    if n == 0:
        return None
    nulls = np.asarray(col.nulls, dtype=bool)
    a = data.astype(np.int64, copy=False)
    # RLE probe: runs over (value, null) pairs
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(a[1:], a[:-1], out=change[1:])
    change[1:] |= nulls[1:] != nulls[:-1]
    run_starts = np.flatnonzero(change)
    r = len(run_starts)
    if r <= max(1, int(n * _RLE_MAX_RUN_FRACTION)):
        run_ends = np.empty(r, dtype=np.int64)
        run_ends[:-1] = run_starts[1:]
        run_ends[-1] = n
        return EncodedColumn(col.eval_type, col.frac, "rle", n,
                             run_values=a[run_starts].copy(), run_ends=run_ends,
                             run_nulls=nulls[run_starts].copy())
    live = ~nulls
    if not live.any():
        lo = hi = 0
    else:
        lo, hi = int(a[live].min()), int(a[live].max())
    ref = lo
    dt = _narrow_lane(lo, hi, ref)
    if dt is None or np.dtype(dt).itemsize * 2 > a.dtype.itemsize:
        return None  # no lane at least halves the bytes
    packed = np.where(live, a - ref, 0).astype(dt)
    return EncodedColumn(col.eval_type, col.frac, "bp", n, packed=packed, ref=ref,
                         nulls=nulls.copy())


def narrow_dict_codes(col: Column) -> Column:
    """Narrow a dictionary-coded column's code lanes in place (int64 codes
    to the smallest lane holding twice the dictionary: growth headroom)."""
    d = np.asarray(col.data)
    if col.dictionary is None or d.dtype == object or col.eval_type in (EvalType.ENUM,
                                                                       EvalType.SET):
        return col
    hi = max(len(col.dictionary), 1)
    dt = _narrow_lane(0, 2 * hi, 0)
    if dt is None or np.dtype(dt).itemsize >= d.dtype.itemsize:
        return col
    col.data = d.astype(dt)
    return col


def ensure_code_capacity(blocks, ci: int, max_code: int) -> bool:
    """Widen a narrowed dictionary-code column (image-wide) so ``max_code``
    fits; True when the lanes changed (the caller bumps the cache's
    ``enc_version`` and drops its pins: ``ColumnBlockCache.widen_codes``)."""
    d0 = np.asarray(blocks[0].cols[ci].data)
    if d0.dtype == object or d0.dtype.kind not in "iu":
        return False
    if max_code <= np.iinfo(d0.dtype).max:
        return False
    dt = _narrow_lane(0, 2 * max_code, 0) or np.int64
    for b in blocks:
        b.cols[ci].data = np.asarray(b.cols[ci].data).astype(dt)
    return True


def encode_blocks(cache, schema=None) -> dict:
    """Choose ONE encoding per column for the whole image and swap the block
    columns for their encoded forms; bump ``cache.enc_version`` if any
    changed and attach every block's zone maps.  Returns ``{column index:
    kind}`` for the columns that changed.  ``schema`` is unused, as in the
    JAX package (the columns carry their types)."""
    blocks = cache.blocks
    if not blocks:
        return {}
    changed: dict[int, str] = {}
    for ci in range(len(blocks[0].cols)):
        cols = [b.cols[ci] for b in blocks]
        if any(isinstance(c, EncodedColumn) for c in cols):
            continue
        if cols[0].is_dict_encoded:
            for b in blocks:
                narrow_dict_codes(b.cols[ci])
            d = np.asarray(blocks[0].cols[ci].data)
            if d.dtype != object and d.dtype.itemsize < 8:
                changed[ci] = "code"
            continue
        d0 = np.asarray(cols[0].data)
        if d0.dtype == object and cols[0].eval_type == EvalType.BYTES:
            # low-cardinality strings: a SORTED dictionary shared by every block
            if _dict_encode_blocks(blocks, ci):
                changed[ci] = "dict"
            continue
        encoded = [_encode_one(c, b.n_valid) for c, b in zip(cols, blocks)]
        if any(e is None for e in encoded):
            continue
        kinds = {e.kind for e in encoded}
        kind = kinds.pop() if len(kinds) == 1 else "bp"
        if kind == "bp":
            # bitpack everywhere (also the tie-break for mixed per-block
            # choices) under ONE frame of reference: one ref per column
            encoded = _unify_bitpack(cols)
            if encoded is None:
                continue
        else:
            k_cap = 1
            while k_cap < max(len(e.run_values) for e in encoded):
                k_cap *= 2
            for e in encoded:
                e.k_cap = k_cap
        for b, e in zip(blocks, encoded):
            b.cols[ci] = e
        changed[ci] = kind
    if changed:
        cache.enc_version = getattr(cache, "enc_version", 0) + 1
    # the stats pass bounded every encoded column already: zones are cheap now
    from . import zone_maps

    for b in blocks:
        b.zones = zone_maps.build_block_zones(b.cols, b.n_valid)
    return changed


def _dict_encode_blocks(blocks, ci: int) -> bool:
    """Dictionary-encode an object BYTES column image-wide: one sorted
    dictionary shared by every block, narrow code lanes, null slots coded 0."""
    parts = [np.asarray(b.cols[ci].data) for b in blocks]
    nullp = [np.asarray(b.cols[ci].nulls) for b in blocks]
    n = sum(len(p) for p in parts)
    if n == 0:
        return False
    cap = min(max(n // 4, 1), _DICT_MAX_CARDINALITY)
    values = set()
    try:
        for p, nl in zip(parts, nullp):
            for v, isnull in zip(p, nl):
                if not isnull:
                    values.add(bytes(v))
            if len(values) > cap:
                return False  # high cardinality: stop scanning at once
    except TypeError:
        return False  # not bytes payloads
    if not values or len(values) > cap:
        return False
    uniq = sorted(values)
    dictionary = np.empty(len(uniq), dtype=object)
    for j, v in enumerate(uniq):
        dictionary[j] = v
    dt = _narrow_lane(0, 2 * len(uniq), 0) or np.int64
    for b, p, nl in zip(blocks, parts, nullp):
        codes = np.searchsorted(dictionary, p).astype(dt)
        codes[nl] = 0
        c = b.cols[ci]
        b.cols[ci] = Column(c.eval_type, codes, np.asarray(c.nulls), c.frac, dictionary)
    return True


def _unify_bitpack(cols):
    """Bitpack every block of a column under ONE shared (ref, lane)."""
    lo = hi = None
    for c in cols:
        a = np.asarray(c.data).astype(np.int64, copy=False)
        live = ~np.asarray(c.nulls, dtype=bool)
        if not live.any():
            continue
        clo, chi = int(a[live].min()), int(a[live].max())
        lo = clo if lo is None else min(lo, clo)
        hi = chi if hi is None else max(hi, chi)
    if lo is None:
        lo = hi = 0
    ref = lo
    dt = _narrow_lane(lo, hi, ref)
    if dt is None or np.dtype(dt).itemsize * 2 > 8:
        return None
    out = []
    for c in cols:
        a = np.asarray(c.data).astype(np.int64, copy=False)
        nulls = np.asarray(c.nulls, dtype=bool)
        packed = np.where(~nulls, a - ref, 0).astype(dt)
        out.append(EncodedColumn(c.eval_type, c.frac, "bp", len(a), packed=packed, ref=ref,
                                 nulls=nulls.copy()))
    return out


# ---------------------------------------------------------------------------
# Byte accounting
# ---------------------------------------------------------------------------

def column_nbytes(col: Column) -> int:
    """Resident (encoded) host bytes of one block column."""
    if isinstance(col, EncodedColumn):
        return col.encoded_nbytes()
    data = np.asarray(col.data)
    total = data.nbytes if data.dtype != object else 32 * len(data)
    total += np.asarray(col.nulls).nbytes
    if col.dictionary is not None:
        total += 64 * len(col.dictionary)
    return total


def column_decoded_nbytes(col: Column) -> int:
    """What the column would cost decoded (int64 lanes and bool nulls)."""
    if isinstance(col, EncodedColumn):
        return col.n * 8 + col.n * 1
    data = np.asarray(col.data)
    if col.dictionary is not None and data.dtype != object and data.dtype.kind in "iu":
        return len(data) * 8 + np.asarray(col.nulls).nbytes + 64 * len(col.dictionary)
    return column_nbytes(col)


# ---------------------------------------------------------------------------
# Device consumption plans
# ---------------------------------------------------------------------------

class DevicePlan:
    """How one image's columns ship to the device for a (ship, nullable)
    column set: one static descriptor per shipped column (``sig``), one per
    nullable column (``null_sig``: run-shaped or row-shaped), and the frame
    of reference of each shipped column (``refs``)."""

    __slots__ = ("sig", "null_sig", "refs")

    def __init__(self, sig, null_sig, refs):
        self.sig = sig
        self.null_sig = null_sig
        self.refs = refs  # np.ndarray (n_ship,) int64

    @property
    def encoded(self) -> bool:
        return any(d[0] != "plain" for d in self.sig)


def _col_desc(col: Column):
    """``(descriptor, ref)`` of one column: ``("plain",)``, ``("bp", lane
    dtype)``, ``("code", lane dtype)`` or ``("rle", k_cap, values dtype)``."""
    if isinstance(col, EncodedColumn):
        if col.kind == "bp":
            return ("bp", col.packed.dtype.str), col.ref
        return ("rle", col.k_cap, col.run_values.dtype.str), 0
    d = np.asarray(col.data)
    if (col.dictionary is not None and d.dtype != object and d.dtype.kind in "iu"
            and d.dtype.itemsize < 8):
        return ("code", d.dtype.str), 0
    return ("plain",), 0


def device_plan(cache, ship_cols, nullable_cols) -> DevicePlan | None:
    """The consumption plan of ``cache``'s blocks for these columns, or None
    when every shipped column is plain (the image then pins as before)."""
    blocks = cache.blocks
    if not blocks:
        return None
    sig, refs = [], []
    for i in ship_cols:
        desc, ref = _col_desc(blocks[0].cols[i])
        sig.append(desc)
        refs.append(ref)
    null_sig = []
    for i in nullable_cols:
        c = blocks[0].cols[i]
        null_sig.append(("rle", c.k_cap) if isinstance(c, EncodedColumn) and c.kind == "rle"
                        else ("plain",))
    plan = DevicePlan(tuple(sig), tuple(null_sig), np.asarray(refs, dtype=np.int64))
    return plan if plan.encoded else None


def block_payload(col: Column, pad_rows: int):
    """The host array(s) to pin for one block column: plain/bp/code, the
    (narrow) row array padded to ``pad_rows``; rle, ``(run_values,
    run_ends)`` padded to the column's ``k_cap``, the ends with ``pad_rows``
    so that padding rows fall in an inert pad run."""
    if isinstance(col, EncodedColumn) and col.kind == "rle":
        rv = np.zeros(col.k_cap, dtype=col.run_values.dtype)
        rv[: len(col.run_values)] = col.run_values
        re_ = np.full(col.k_cap, pad_rows, dtype=np.int64)
        re_[: len(col.run_ends)] = col.run_ends
        return rv, re_
    arr = np.asarray(col.packed if isinstance(col, EncodedColumn) else col.data)
    if len(arr) == pad_rows:
        return arr
    if arr.dtype == object:
        ext = np.empty(pad_rows - len(arr), dtype=object)
        ext[:] = b""
        return np.concatenate([arr, ext])
    return np.concatenate([arr, np.zeros(pad_rows - len(arr), dtype=arr.dtype)])


def block_null_payload(col: Column, pad_rows: int):
    """Null payload: run-shaped (``[k_cap]``, pad runs NULL) for rle
    columns, row-shaped and padded with NULL otherwise."""
    if isinstance(col, EncodedColumn) and col.kind == "rle":
        rn = np.ones(col.k_cap, dtype=bool)
        rn[: len(col.run_nulls)] = col.run_nulls
        return rn
    nulls = np.asarray(col.nulls if not isinstance(col, EncodedColumn) else col._nulls)
    if len(nulls) == pad_rows:
        return nulls
    return np.concatenate([nulls, np.ones(pad_rows - len(nulls), dtype=bool)])


def stack_block_payloads(blocks, ship_cols, nullable_cols, plan, pad_rows: int):
    """The stacked payloads of every block: per shipped column a ``(B,
    rows)`` narrow array, or a ``((B, k), (B, k))`` run pair for rle; the
    padded null payloads; and the frame-of-reference vector.  Host numpy;
    callers move the arrays to their device."""
    data = []
    for j, i in enumerate(ship_cols):
        payloads = [block_payload(b.cols[i], pad_rows) for b in blocks]
        if plan.sig[j][0] == "rle":
            data.append((np.stack([p[0] for p in payloads]), np.stack([p[1] for p in payloads])))
        else:
            data.append(np.stack([np.asarray(p) for p in payloads]))
    nulls = [np.stack([block_null_payload(b.cols[i], pad_rows) for b in blocks])
             for i in nullable_cols]
    return data, nulls, np.asarray(plan.refs)


def batch_plan(caches, ship_cols, nullable_cols, path: str, allow_rle: bool = True):
    """One consumption plan per cache of a batch, or None to ship decoded
    lanes (``encoding.batch_plan``): the images ship encoded only when every
    one is encoded under the same descriptors.  None with no decline when
    nothing is encoded; None with the cause ``enc_mismatch`` when some are
    and some are not, or their descriptors differ (``rle_sharded`` for runs
    where ``allow_rle`` is False): a batch is only as encodable as its least
    compatible image."""
    plans = [device_plan(c, ship_cols, nullable_cols) for c in caches]
    if all(p is None for p in plans):
        return None
    cause = None
    if any(p is None for p in plans) or len({(p.sig, p.null_sig) for p in plans}) != 1:
        cause = "enc_mismatch"
    elif not allow_rle and any(d[0] == "rle" for d in plans[0].sig):
        cause = "rle_sharded"
    if cause is not None:
        count_decline(path, cause)
        count_path(path, "decoded_ship")
        return None
    count_path(path, "encoded")
    return plans


def late_materialize_chunk(columns, logical):
    """Selection output through the encodings: when any column is encoded,
    gather the surviving rows (each encoded column decodes only those)
    instead of letting the response encoder decode whole columns.  Returns
    ``(columns, logical rows)``, unchanged for plain blocks."""
    if not any(isinstance(c, EncodedColumn) for c in columns):
        return columns, logical
    return [c.take(logical) for c in columns], np.arange(len(logical))
