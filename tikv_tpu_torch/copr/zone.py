"""The zone-tiled clustered warm rung: layout, tile classification, routing.

The port's own copy of ``tikv_tpu/copr/jax_zone.py``, the rung the JAX
package tries first for a warm aggregation.  The generic warm path walks the
bytecode over every row of the stacked image; this rung changes which rows
need the walk at all:

* rows are PERMUTED so each group slot's rows are contiguous (clustered by
  the stable dictionary codes), padded per run to a multiple of
  ``TILE_ROWS``, and sorted inside each run by a range-predicate column;
* the referenced columns are pinned NARROWED (int8/int16/int32/int64 chosen
  from the values, f64 for REAL) with per-tile min/max zones kept on the
  host;
* each query classifies every tile against its selection conjuncts by
  interval arithmetic: **full** (every row provably passes), **empty** (none
  can) or **partial**;
* full tiles reduce with no walk of the selection and no mask
  (``zone_full``), empty tiles are skipped, and only partial tiles (predicate
  boundaries, tiles with NULLs in a referenced column, pad tiles) walk the
  selection row by row (``zone_partial``);
* ``zone_fold`` folds the per-tile partials into the group slots in the
  layout's fold order, built once with the layout, each tile's row read
  from the map the tile kernels record: no order is sorted or uploaded per
  query (``copr/fused_zone.py``, ``csrc/fused_zone.cu``).

Exactness contract (``jax_zone.py:41-49``): REAL aggregate arguments are
declined; everything else is int64 arithmetic, so responses are
byte-identical to the CPU pipeline, group order included (each group's
minimum original valid-row index over its active rows).  ``var_pop``'s sum
of squares is f64: exact while the sum stays below 2^53, and the fixed fold
order keeps reruns bit-identical beyond it.

A plan the rung cannot serve is *declined* with a named cause and served by
the stacked kernels (the JAX package's ``count_path_fallback("zone", ...)``
causes).  A failure to build, launch or check a zone kernel is not a
decline: it raises.  The host work (clustering, gathers, zones,
classification) is numpy, as in the JAX package.  Not ported: the staged
same-dtype tile sums (``_stage_split``/``_tile_sum``) and the power-of-two
partial-tile bucket, which only keep XLA's reductions same-dtype and its
shapes static.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from .datatypes import EvalType
from .fused_agg import NO_ROW
from .fused_zone import (TileProgram, compile_tile_program, fold_order, zone_fold, zone_full,
                         zone_partial)
from .rpn import RpnExpression

TILE_ROWS = 4096
PARTIAL_FALLBACK = 0.6  # more than this fraction of partial tiles: the stacked kernels serve
_RIDX_PAD = np.int32(2**31 - 1)  # ridx of pad rows, which are never active

_ZONE_AGG_OPS = {"count", "sum", "avg", "min", "max", "var_pop"}
# null-preserving functions: non-null operands never give a NULL, so an
# expression's null mask is the OR of its operands' and a tile with no NULL in
# a referenced column has no NULL argument either
_NULLSAFE_OPS = {
    "plus", "minus", "multiply", "unary_minus", "abs",
    "bit_and", "bit_or", "bit_xor", "bit_neg",
    "lt", "le", "gt", "ge", "eq", "ne",
    "and", "or", "not", "is_not_null",
}
#: the named causes of a decline, as the JAX package counts them
DECLINE_CAUSES = ("agg_op", "unstable_group_dicts", "real_arg", "non_nullsafe_fn",
                  "null_literal", "unclassifiable_selection", "partial_fraction")

_FULL_PROGRAMS_MAX = 32  # distinct aggregate signatures kept per layout


def _narrow_dtype(lo: int, hi: int):
    """Smallest signed int dtype that holds [lo, hi] (and 0, the null fill)."""
    lo, hi = min(lo, 0), max(hi, 0)
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return dt
    return np.int64


def _rpn_sig(rpn: RpnExpression | None) -> tuple:
    if rpn is None:
        return ()
    return tuple((n.kind, n.eval_type, n.frac, n.index, n.value, n.op, n.arity,
                  tuple(n.scale_by or ())) for n in rpn.nodes)


def _recognize_conjunct(rpn: RpnExpression):
    """(col_index, op, col_scale, const_value_scaled) for ``cmp(col, const)``
    and ``cmp(const, col)`` RPNs, the comparison flipped so the column is on
    the left and both sides multiplied by the node's decimal-alignment
    factors (positive, so interval order holds); None for anything else
    (those classify every tile as partial)."""
    nodes = rpn.nodes
    if len(nodes) != 3 or nodes[2].kind != "fn":
        return None
    op = nodes[2].op
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq", "ne": "ne"}
    if op not in flip:
        return None
    a, b = nodes[0], nodes[1]
    sb = nodes[2].scale_by
    if a.kind == "col" and b.kind == "const":
        const = None if b.value is None else b.value * sb[1]
        return (a.index, op, sb[0], const)
    if a.kind == "const" and b.kind == "col":
        const = None if a.value is None else a.value * sb[0]
        return (b.index, flip[op], sb[1], const)
    return None


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def _lexsort(keys) -> np.ndarray:
    """``np.lexsort(keys)`` (the last key primary, stable): one 16-bit radix
    pass over the keys combined when their value spans multiply to at most
    2^16 (a group id and a date column), else numpy's lexsort."""
    n = len(keys[0])
    spans = []
    for k in keys:
        lo = int(k.min()) if n else 0
        spans.append((lo, (int(k.max()) - lo + 1) if n else 1))
    if int(np.prod([sp for _lo, sp in spans], dtype=object)) > 1 << 16:
        return np.lexsort(keys)
    combined = np.zeros(n, dtype=np.int64)
    for k, (lo, sp) in reversed(list(zip(keys, spans))):
        combined = combined * sp + (k.astype(np.int64) - lo)
    return np.argsort(combined.astype(np.uint16), kind="stable")


def purge_decoded(blocks) -> None:
    """Drop the host decode caches the layout's gathers filled
    (``EncodedColumn.purge_decoded``), so an encoded image does not keep its
    full decode next to its payload."""
    for blk in blocks:
        for c in blk.cols:
            purge = getattr(c, "purge_decoded", None)
            if purge is not None:
                purge()


class ZoneLayout:
    """Clustered, tiled, narrowed image of a filled block cache for one
    (group columns, sort column) signature.  Device tensors are flat over
    all tiles: ``cols[i]`` (narrowed int lanes, f64 for REAL; pad and NULL
    slots 0), ``nulls[i]`` (bool, nullable columns only), ``valid`` (bool;
    pad rows False), ``ridx`` (int32 global valid-row index) and
    ``tile_first`` (int64 per tile: its least ``ridx``, read for full
    tiles), and ``fold``, the order ``zone_fold`` folds every query's tiles
    in (:func:`copr.fused_zone.fold_order`).  The zones (``zone_lo``,
    ``zone_hi``, ``zone_has_null``), ``tile_gid`` and ``has_pad`` stay on
    the host.  ``full_programs`` keeps
    the full-tile programs of the plans served over it by aggregate
    signature: they hold no selection (on a full tile the classification is
    the selection), so plans that differ in their selection constants share
    one."""

    def __init__(self, blocks, group_cols, dicts, sort_col, needed_cols, schema, device,
                 tile_rows: int):
        tr = self.tile_rows = int(tile_rows)
        self.full_programs: dict[tuple, TileProgram] = {}
        self.group_cols = list(group_cols)
        self.sort_col = sort_col
        self.dicts = list(dicts)
        self.dict_lens = [len(d) for d in dicts]
        self.n_slots = 1
        for dl in self.dict_lens:
            self.n_slots *= dl + 1
        self.device = torch.device(device)

        # per block: the permuted source rows, -1 for pad rows, and its
        # tiles' slots
        srcs, tile_gids = [], []
        for blk in blocks:
            n_valid = blk.n_valid
            gid = np.zeros(n_valid, dtype=np.int64)
            for ci, dl in zip(group_cols, self.dict_lens):
                col = blk.cols[ci]
                codes = np.asarray(col.data[:n_valid], dtype=np.int64)
                nulls = np.asarray(col.nulls[:n_valid])
                gid = gid * (dl + 1) + np.where(nulls, dl, codes)
            keys = [gid] if sort_col is None else [
                np.asarray(blk.cols[sort_col].data[:n_valid]), gid]
            order = _lexsort(keys)
            gs = gid[order]
            # one run per slot present in the block, each padded to whole tiles
            run_at = np.flatnonzero(np.diff(gs)) + 1
            if n_valid:
                run_at = np.concatenate([[0], run_at])
            lens = np.diff(np.append(run_at, n_valid))
            padded = lens + (-lens) % tr
            src = np.full(int(padded.sum()), -1, dtype=np.int64)
            for a, s, m in zip(np.cumsum(padded) - padded, run_at, lens):
                src[a : a + m] = order[s : s + m]
            srcs.append(src)
            tile_gids.append(np.repeat(gs[run_at], padded // tr))
        self.tile_gid = np.concatenate(tile_gids).astype(np.int32)
        self.n_tiles = T = len(self.tile_gid)
        self.n_rows = n = T * tr

        # valid rows and their global valid-row index
        valid = np.empty(n, dtype=bool)
        ridx = np.empty(n, dtype=np.int32)
        pos = base = 0
        for blk, src in zip(blocks, srcs):
            m = len(src)
            valid[pos : pos + m] = src >= 0
            ridx[pos : pos + m] = np.where(src >= 0, base + src, _RIDX_PAD)
            pos += m
            base += blk.n_valid
        valid_count = valid.reshape(T, tr).sum(axis=1)
        self.has_pad = valid_count < tr
        first = np.where(valid, ridx, _RIDX_PAD).reshape(T, tr).min(axis=1).astype(np.int64)
        first[first == int(_RIDX_PAD)] = NO_ROW

        # each needed column gathered through the permutation, zoned,
        # narrowed and pinned in turn, so one column is on the host at a time
        self.cols: dict[int, torch.Tensor] = {}
        self.nulls: dict[int, torch.Tensor] = {}
        self.zone_lo: dict[int, np.ndarray] = {}
        self.zone_hi: dict[int, np.ndarray] = {}
        self.zone_has_null: dict[int, np.ndarray] = {}
        for i in needed_cols:
            is_real = schema[i][0] == EvalType.REAL
            arr = np.zeros(n, dtype=np.float64 if is_real else np.int64)
            nl = None
            if any(np.asarray(b.cols[i].nulls[: b.n_valid]).any() for b in blocks):
                nl = np.ones(n, dtype=bool)
            pos = 0
            for blk, src in zip(blocks, srcs):
                # pad rows (src -1) take row 0's slot: they are dead below
                m = len(src)
                arr[pos : pos + m] = np.take(np.asarray(blk.cols[i].data), src, mode="clip")
                if nl is not None:
                    nl[pos : pos + m] = np.take(np.asarray(blk.cols[i].nulls), src, mode="clip")
                pos += m
            if nl is not None:
                nl[~valid] = True
            dead = ~valid if nl is None else ~valid | nl
            # zones over live rows only, in the column's own domain (float
            # zones of int64 would round above 2^53 and could prove a
            # boundary tile full)
            if is_real:
                pos_id, neg_id = np.inf, -np.inf
            else:
                info = np.iinfo(np.int64)
                pos_id, neg_id = info.max, info.min
            self.zone_lo[i] = np.where(dead, pos_id, arr).reshape(T, tr).min(axis=1)
            self.zone_hi[i] = np.where(dead, neg_id, arr).reshape(T, tr).max(axis=1)
            self.zone_has_null[i] = (nl.reshape(T, tr).any(axis=1) if nl is not None
                                     else np.zeros(T, dtype=bool))
            arr[dead] = 0
            if not is_real:
                lo = int(self.zone_lo[i].min()) if T else 0
                hi = int(self.zone_hi[i].max()) if T else 0
                arr = arr.astype(_narrow_dtype(lo, hi))
            self.cols[i] = torch.from_numpy(arr).to(self.device)
            if nl is not None:
                self.nulls[i] = torch.from_numpy(nl).to(self.device)
            del arr, nl
        self.valid = torch.from_numpy(valid).to(self.device)
        self.ridx = torch.from_numpy(ridx).to(self.device)
        self.tile_first = torch.from_numpy(first).to(self.device)
        self.fold = fold_order(self.tile_gid, self.n_slots, self.device)
        # the gathers filled the decode caches of an encoded image
        purge_decoded(blocks)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor the layout pins (``ColumnBlockCache.device_nbytes``)."""
        return [*self.cols.values(), *self.nulls.values(), self.valid, self.ridx,
                self.tile_first, *self.fold.tensors()]


def build_layout(cache, group_cols, dicts, sort_col, needed_cols, schema, device,
                 tr: int) -> ZoneLayout:
    """The cache's layout for this signature at ``tr`` rows a tile, built
    and pinned on first use under the cache's device-pin LRU
    (``jax_zone.build_layout``)."""
    sig = ("zone_layout", tuple(group_cols), sort_col, tuple(sorted(needed_cols)), tr,
           str(device))
    blocks = cache.blocks

    def build(_blk):
        return ZoneLayout(blocks, group_cols, dicts, sort_col, sorted(needed_cols), schema,
                          device, tr)

    return cache.device_arrays(blocks[0], sig, build)


# ---------------------------------------------------------------------------
# The rung
# ---------------------------------------------------------------------------

@dataclass
class ZoneStats:
    """What the rung did (the JAX package's ``count_prune("zone", ...)`` and
    ``count_path_fallback("zone", cause)``): the tiles of the last served
    query by class, the queries served, and the declines by cause."""

    examined: int = 0
    full: int = 0
    partial: int = 0
    empty: int = 0
    served: int = 0
    last_decline: str | None = None
    declines: dict = field(default_factory=dict)

    def decline(self, cause: str) -> None:
        self.last_decline = cause
        self.declines[cause] = self.declines.get(cause, 0) + 1


class ZoneRung:
    """The zone rung for one :class:`TorchDagEvaluator` plan.  ``try_run``
    returns the packed state and its finalize inputs, or None after
    recording a named decline in the evaluator's ``zone_stats``."""

    def __init__(self, ev):
        self.ev = ev
        # images declined for their data (the selection classifies no tile,
        # or too many are partial): the same cause without building again,
        # until an in-place delta changes the data (cache.data_version)
        self._declined: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._partial_prog: TileProgram | None = None

    @property
    def stats(self) -> ZoneStats:
        return self.ev.zone_stats

    def eligible(self, blocks):
        """``(group_cols, dicts)``, or None with the decline recorded."""
        plan = self.ev.plan
        if any(op not in _ZONE_AGG_OPS for op, _rpn in plan.agg_rpns):
            return self._decline("agg_op")
        stable = self.ev._stable_dict_group_cols(blocks)
        if stable is None:
            return self._decline("unstable_group_dicts")
        for _op, rpn in plan.agg_rpns:
            if rpn is None:
                continue
            if rpn.eval_type == EvalType.REAL:
                # a float sum's order must match the CPU oracle
                return self._decline("real_arg")
            for node in rpn.nodes:
                if node.kind == "fn" and node.op not in _NULLSAFE_OPS:
                    return self._decline("non_nullsafe_fn")
                if node.kind == "const" and node.value is None:
                    return self._decline("null_literal")
        return stable

    def _decline(self, cause: str, cache=None):
        self.stats.decline(cause)
        if cache is not None:
            self._declined[cache] = (cause, cache.data_version)
        return None

    def declined(self, cache) -> str | None:
        """The cause this image was declined for, while its data stands."""
        hit = self._declined.get(cache)
        return hit[0] if hit is not None and hit[1] == cache.data_version else None

    def referenced_cols(self) -> set[int]:
        plan = self.ev.plan
        need: set[int] = set()
        for r in plan.sel_rpns:
            need |= r.referenced_columns()
        for _op, rpn in plan.agg_rpns:
            if rpn is not None:
                need |= rpn.referenced_columns()
        return need

    def classify_tiles(self, layout: ZoneLayout):
        """(full mask, partial tile indices); empty tiles are in neither.
        Pad tiles and tiles with a NULL in any referenced column are
        partial whatever the zones say."""
        T = layout.n_tiles
        status_full = np.ones(T, dtype=bool)
        status_empty = np.zeros(T, dtype=bool)
        for rpn in self.ev.plan.sel_rpns:
            rec = _recognize_conjunct(rpn)
            if rec is None or rec[0] not in layout.zone_lo:
                status_full[:] = False
                continue
            ci, op, cscale, c = rec
            if c is None:
                status_empty[:] = True
                status_full[:] = False
                continue
            lo, hi = layout.zone_lo[ci], layout.zone_hi[ci]
            if cscale != 1:
                # exact Python ints: int64 * scale may wrap in numpy, and a
                # wrapped bound could prove a tile full wrongly
                lo = lo.astype(object) * int(cscale)
                hi = hi.astype(object) * int(cscale)
            if op == "lt":
                cf, ce = hi < c, lo >= c
            elif op == "le":
                cf, ce = hi <= c, lo > c
            elif op == "gt":
                cf, ce = lo > c, hi <= c
            elif op == "ge":
                cf, ce = lo >= c, hi < c
            elif op == "eq":
                cf, ce = (lo == c) & (hi == c), (c < lo) | (c > hi)
            else:  # ne
                cf, ce = (c < lo) | (c > hi), (lo == c) & (hi == c)
            # a NULL row fails every comparison: NULLs block fullness
            status_full &= np.asarray(cf, dtype=bool) & ~layout.zone_has_null[ci]
            status_empty |= np.asarray(ce, dtype=bool)
        forced = layout.has_pad.copy()
        for ci in self.referenced_cols():
            if ci in layout.zone_has_null:
                forced |= layout.zone_has_null[ci]
        full = status_full & ~status_empty & ~forced
        partial = ~full & ~status_empty
        return full, np.flatnonzero(partial)

    def programs(self, layout: ZoneLayout) -> tuple[TileProgram, TileProgram]:
        """(full-tile program, partial-tile program); the full one is shared
        through the layout by every plan with the same aggregates."""
        plan = self.ev.plan
        track = bool(plan.group_rpns)
        fulls = layout.full_programs
        key = (tuple((op, _rpn_sig(rpn)) for op, rpn in plan.agg_rpns), track)
        full = fulls.get(key)
        if full is None:
            full = fulls[key] = compile_tile_program([], plan.agg_rpns, plan.schema, track,
                                                     partial=False)
            while len(fulls) > _FULL_PROGRAMS_MAX:
                fulls.pop(next(iter(fulls)))
        if self._partial_prog is None:
            self._partial_prog = compile_tile_program(plan.sel_rpns, plan.agg_rpns, plan.schema,
                                                      track, partial=True)
        return full, self._partial_prog

    def try_run(self, cache, tile_rows: int | None = None):
        """``(packed, program, n_slots, key_of)`` for ``_finalize_agg``, or
        None when declined.  Kernel failures raise."""
        tiles = self.plan_tiles(cache, tile_rows)
        return None if tiles is None else self.serve(tiles)

    def serve(self, tiles):
        """Launch a query planned by :meth:`plan_tiles`: ``(packed,
        program, n_slots, key_of)`` for ``_finalize_agg``."""
        layout, full_idx, partial_idx = tiles
        packed = self.launch(layout, full_idx, partial_idx)
        self.stats.served += 1
        return (packed, self.programs(layout)[0].prog, layout.n_slots,
                key_of(layout.dicts, layout.dict_lens))

    def plan_tiles(self, cache, tile_rows: int | None = None):
        """The query's host half: eligibility, the cache's layout (built and
        pinned on first use, at ``tile_rows``, ``TILE_ROWS`` by default) and
        its tiles classified, as ``(layout, full tile indices, partial tile
        indices)``; None when declined, with the cause recorded."""
        cause = self.declined(cache)
        if cause is not None:
            return self._decline(cause)
        el = self.eligible(cache.blocks)
        if el is None:
            return None
        group_cols, dicts = el
        plan = self.ev.plan
        recs = [_recognize_conjunct(r) for r in plan.sel_rpns]
        if recs and all(r is None for r in recs):
            # every tile would be partial: no layout is worth building
            return self._decline("unclassifiable_selection", cache)
        sort_col = None
        for rec in recs:
            if rec is not None and rec[0] not in group_cols \
                    and plan.schema[rec[0]][0] != EvalType.REAL:
                sort_col = rec[0]
                break
        layout = build_layout(cache, group_cols, dicts, sort_col, self.referenced_cols(),
                              plan.schema, self.ev.device,
                              TILE_ROWS if tile_rows is None else tile_rows)
        full, partial_idx = self.classify_tiles(layout)
        T = layout.n_tiles
        if T and len(partial_idx) / T > PARTIAL_FALLBACK:
            return self._decline("partial_fraction", cache)
        full_idx = np.flatnonzero(full)
        st = self.stats
        st.examined, st.full, st.partial = T, len(full_idx), len(partial_idx)
        st.empty = T - st.full - st.partial
        return layout, full_idx, partial_idx

    def launch(self, layout: ZoneLayout, full_idx: np.ndarray, partial_idx: np.ndarray):
        """The query's device half: the listed tiles uploaded in one piece,
        ``zone_full`` over the full ones, ``zone_partial`` over the partial
        ones (each only when it has tiles), each recording its tiles' rows
        in the query's own map, then ``zone_fold`` in the layout's fold
        order into the packed state at ``n_slots``."""
        full_prog, part_prog = self.programs(layout)
        dev = self.ev.device
        nf = len(full_idx)
        tiles = torch.from_numpy(np.concatenate([full_idx, partial_idx]).astype(np.int64)).to(dev)
        parts = torch.empty((len(tiles), len(full_prog.prog.leaves)), dtype=torch.int64,
                            device=dev)
        row_of = torch.empty(layout.n_tiles, dtype=torch.int32, device=dev)
        if nf:
            zone_full(full_prog, layout, tiles[:nf], parts[:nf], row_of, 0)
        if len(partial_idx):
            zone_partial(part_prog, layout, tiles[nf:], parts[nf:], row_of, nf)
        return zone_fold(full_prog, parts, tiles, row_of, layout.fold, layout.n_slots)


def key_of(dicts, dict_lens):
    """Slot -> group key tuple (the mixed radix of the dictionary codes;
    code ``dlen`` is NULL)."""
    def key(slot: int) -> tuple:
        parts = []
        rem = int(slot)
        for d, dl in zip(reversed(dicts), reversed(dict_lens)):
            c = rem % (dl + 1)
            rem //= dl + 1
            parts.append(None if c == dl else bytes(d[c]))
        return tuple(reversed(parts))

    return key
