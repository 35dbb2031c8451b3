"""Per-block zone maps: min/max/null-count pruning statistics.

The port's own copy of ``tikv_tpu/copr/zone_maps.py``.  The fill-time stats
pass (``copr/encoding.py``) bounds every encoded block already: a bitpacked
column carries its frame, an RLE column its run values, a dictionary column
its code range.  This module turns those bounds (and a masked min/max for
plain numeric columns) into per-block zone maps, and evaluates a plan's
selection conjuncts against them, so that the warm paths skip blocks that
provably hold no qualifying row.

Soundness contract, the only invariant pruning relies on:

* every NON-NULL value ``v`` of the column in the block satisfies
  ``lo <= v <= hi`` (``lo is None``: the block holds no non-null value);
* the block's null count lies within ``[null_lo, null_hi]``.

Dictionary columns are tracked in code space; plain object BYTES/JSON
columns are untracked, so blocks always survive predicates over them.

Not here: the environment switch and the metrics of the JAX package, and
the write-through fold of in-place deltas (``fold_update``).
"""

from __future__ import annotations

import numpy as np

from .rpn import RpnExpression

_ENABLED = True


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Switch pruning off (tests compare the pruned and unpruned paths)."""
    global _ENABLED
    _ENABLED = bool(on)


class ColumnZone:
    """Value and null bounds of ONE column of ONE block (module contract)."""

    __slots__ = ("lo", "hi", "null_lo", "null_hi", "n")

    def __init__(self, lo, hi, null_lo: int, null_hi: int, n: int):
        self.lo = lo
        self.hi = hi
        self.null_lo = int(null_lo)
        self.null_hi = int(null_hi)
        self.n = int(n)

    def __repr__(self) -> str:
        return (f"ColumnZone(lo={self.lo}, hi={self.hi}, "
                f"nulls=[{self.null_lo},{self.null_hi}]/{self.n})")


def _scalar(v):
    """A numpy scalar as an exact Python number."""
    return v.item() if hasattr(v, "item") else v


def _zone_of_column(col, n_valid: int) -> ColumnZone | None:
    """The zone of one column, read from the encoded payload where one is
    resident (no decode); None for untracked (object) columns."""
    from .encoding import EncodedColumn

    if isinstance(col, EncodedColumn):
        if col.kind == "bp":
            nulls = np.asarray(col._nulls[:n_valid])
            live = ~nulls
            nn = int(nulls.sum())
            if not live.any():
                return ColumnZone(None, None, nn, nn, n_valid)
            pk = np.asarray(col.packed[:n_valid])[live]
            return ColumnZone(_scalar(pk.min()) + col.ref, _scalar(pk.max()) + col.ref,
                              nn, nn, n_valid)
        # rle: only the runs that intersect the valid prefix count
        ends = np.asarray(col.run_ends)
        starts = np.concatenate([[0], ends[:-1]])
        sel = starts < n_valid
        rv = np.asarray(col.run_values)[sel]
        rn = np.asarray(col.run_nulls)[sel]
        spans = np.minimum(ends[sel], n_valid) - starts[sel]
        nn = int(spans[rn].sum())
        live = rv[~rn]
        if len(live) == 0:
            return ColumnZone(None, None, nn, nn, n_valid)
        return ColumnZone(_scalar(live.min()), _scalar(live.max()), nn, nn, n_valid)
    data = np.asarray(col.data)
    if data.dtype == object:
        return None  # raw BYTES/JSON: untracked
    nulls = np.asarray(col.nulls[:n_valid])
    nn = int(nulls.sum())
    live = ~nulls
    if not live.any():
        return ColumnZone(None, None, nn, nn, n_valid)
    d = data[:n_valid][live]
    return ColumnZone(_scalar(d.min()), _scalar(d.max()), nn, nn, n_valid)


def build_block_zones(cols, n_valid: int) -> dict[int, ColumnZone]:
    """Zones of every trackable column of one block."""
    zones: dict[int, ColumnZone] = {}
    if n_valid <= 0:
        return zones
    for ci, col in enumerate(cols):
        try:
            z = _zone_of_column(col, n_valid)
        except Exception:  # noqa: BLE001 — statistics never break serving
            z = None
        if z is not None:
            zones[ci] = z
    return zones


def ensure_zones(cache) -> bool:
    """Attach zones to every block of a filled cache that has none yet
    (plain images build theirs here, on first prune).  False when the cache
    cannot carry zones."""
    blocks = getattr(cache, "blocks", None)
    if not blocks:
        return False
    for blk in blocks:
        if blk.zones is None:
            blk.zones = build_block_zones(blk.cols, blk.n_valid)
    return True


# ---------------------------------------------------------------------------
# Conjunct recognition and per-block emptiness tests
# ---------------------------------------------------------------------------

_CMP_FLIP = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}


def _recognize(rpn: RpnExpression):
    """The prunable conjunct shapes:

    * ``cmp(col, const)`` / ``cmp(const, col)`` -> ("cmp", ci, op, cscale, c),
      the decimal alignment pre-multiplied (exact Python ints);
    * ``in(col, const...)`` -> ("in", ci, cscale, consts);
    * ``is_null(col)`` -> ("is_null", ci).

    None for anything else: unrecognized conjuncts never prune."""
    nodes = rpn.nodes
    if len(nodes) == 2 and nodes[1].kind == "fn" and nodes[1].op == "is_null" \
            and nodes[0].kind == "col":
        return ("is_null", nodes[0].index)
    if len(nodes) == 3 and nodes[2].kind == "fn":
        op = nodes[2].op
        if op not in _CMP_FLIP:
            return None
        a, b, sb = nodes[0], nodes[1], nodes[2].scale_by
        if a.kind == "col" and b.kind == "const":
            c = None if b.value is None else b.value * sb[1]
            return ("cmp", a.index, op, sb[0], c)
        if a.kind == "const" and b.kind == "col":
            c = None if a.value is None else a.value * sb[0]
            return ("cmp", b.index, _CMP_FLIP[op], sb[1], c)
        return None
    if (len(nodes) >= 3 and nodes[-1].kind == "fn" and nodes[-1].op == "in"
            and nodes[0].kind == "col"
            and all(n.kind == "const" for n in nodes[1:-1])):
        sb = nodes[-1].scale_by
        if any(isinstance(n.value, (bytes, bytearray)) for n in nodes[1:-1]):
            return None  # bytes IN-lists never reach zones untranslated
        consts = tuple(None if n.value is None else n.value * m
                       for n, m in zip(nodes[1:-1], sb[1:]))
        return ("in", nodes[0].index, sb[0], consts)
    return None


def _cmp_empty(op: str, lo, hi, c) -> bool:
    """True iff NO value in [lo, hi] can satisfy ``col op c``."""
    if op == "lt":
        return lo >= c
    if op == "le":
        return lo > c
    if op == "gt":
        return hi <= c
    if op == "ge":
        return hi < c
    if op == "eq":
        return c < lo or c > hi
    # ne: only empty when every non-null value IS the constant
    return lo == c and hi == c


def _conjunct_prunes(rec, zones: dict[int, ColumnZone]) -> bool:
    """True iff the recognized conjunct proves the block yields NO row.  A
    NULL comparison never satisfies a filter, so value predicates also prune
    blocks with no non-null value."""
    kind = rec[0]
    if kind == "is_null":
        z = zones.get(rec[1])
        return z is not None and z.null_hi == 0
    if kind == "cmp":
        _, ci, op, cscale, c = rec
        z = zones.get(ci)
        if z is None:
            return False
        if c is None:
            return True  # cmp(col, NULL) is NULL on every row
        if z.lo is None:
            return True  # no non-null value in the block
        return _cmp_empty(op, z.lo * cscale, z.hi * cscale, c)
    _, ci, cscale, consts = rec  # "in"
    z = zones.get(ci)
    if z is None:
        return False
    if z.lo is None:
        return True
    lo, hi = z.lo * cscale, z.hi * cscale
    return all(c is None or c < lo or c > hi for c in consts)


class PruneStats:
    __slots__ = ("examined", "pruned")

    def __init__(self, examined: int = 0, pruned: int = 0):
        self.examined = examined
        self.pruned = pruned


def prune_blocks(cache, sel_rpns, stats: PruneStats | None = None) -> np.ndarray | None:
    """Per-block keep mask of a filled cache under the plan's selection
    conjuncts (AND: any conjunct that proves a block empty prunes it).  None
    when pruning is off, does not apply or proves nothing: callers then run
    their unpruned path."""
    if not enabled() or not sel_rpns:
        return None
    recs = [r for r in (_recognize(rpn) for rpn in sel_rpns) if r is not None]
    if not recs:
        return None
    if not ensure_zones(cache):
        return None
    blocks = cache.blocks
    keep = np.ones(len(blocks), dtype=bool)
    for bi, blk in enumerate(blocks):
        zones = blk.zones
        if not zones:
            continue
        for rec in recs:
            if _conjunct_prunes(rec, zones):
                keep[bi] = False
                break
    n_pruned = int((~keep).sum())
    if stats is not None:
        stats.examined += len(blocks)
        stats.pruned += n_pruned
    if n_pruned == 0:
        return None
    return keep


def batch_prune_keep(masks) -> np.ndarray | None:
    """The keep mask of a batch whose riders share one block stream
    (``jax_eval._batch_prune_keep``): a block is masked only when every
    rider's zone maps prune it.  ``masks`` holds each rider's keep mask
    (:func:`prune_blocks`); None for any rider (no selection, or nothing
    proved) keeps every block, and so does a union that keeps them all."""
    keep = None
    for m in masks:
        if m is None:
            return None
        keep = m.copy() if keep is None else keep | m
    if keep is None or keep.all():
        return None
    return keep


# ---------------------------------------------------------------------------
# TopN zone-order early exit
# ---------------------------------------------------------------------------

def topn_cutoff_order(blocks, keep, order_col: int, desc: bool, k: int):
    """Among the surviving blocks, those that can still contribute to the
    top ``k`` of a TopN whose first key is the bare column ``order_col``.

    Ascending: sort the candidate blocks by ``hi``; once the accumulated row
    count reaches ``k``, the threshold ``T`` is that prefix's largest ``hi``
    (NULLs sort first, so null rows count too).  A block with ``lo > T`` and
    no NULL holds only rows strictly above the k-th value: even losing every
    tie, none enters the top k, so it is skipped.  Descending is symmetric on
    ``lo``, the guaranteed count shrunk by ``null_hi`` (NULLs sort last).
    Returns an updated keep mask, or None when zone order bounds nothing."""
    cand = []
    for bi, blk in enumerate(blocks):
        if not keep[bi]:
            continue
        z = (blk.zones or {}).get(order_col)
        if z is None:
            return None  # untracked order column: no sound bound
        cand.append((bi, z))
    if not cand:
        return None
    if desc:
        ordered = sorted(cand, key=lambda t: _neg_key(t[1].lo))
        got = 0
        thresh = None
        for _bi, z in ordered:
            if z.lo is None:
                break  # all-null blocks bound nothing under desc
            got += max(0, z.n - z.null_hi)
            if got >= k:
                thresh = z.lo
                break
        if thresh is None:
            return None
        out = keep.copy()
        for bi, z in cand:
            if z.hi is not None and z.hi < thresh and z.null_hi == 0:
                out[bi] = False
        return out
    ordered = sorted(cand, key=lambda t: _pos_key(t[1].hi))
    got = 0
    thresh = None
    for _bi, z in ordered:
        got += z.n  # NULLs sort first ascending: every row sorts <= hi
        if z.lo is None:
            continue
        if got >= k:
            thresh = z.hi
            break
    if thresh is None:
        return None
    out = keep.copy()
    for bi, z in cand:
        if z.lo is not None and z.lo > thresh and z.null_hi == 0:
            out[bi] = False
    return out


def _pos_key(v):
    # all-null blocks (hi None) sort first: their rows sort before any value
    return (v is not None, v if v is not None else 0)


def _neg_key(v):
    # descending by lo, None (all-null) last
    return (v is None, -(v if v is not None else 0))
