"""Grouped fused scan-filter-aggregate: leaf layout, plain version, CUDA launcher.

The GROUP BY half of the port's device path, and every plan that uses one of
the ten device aggregates beyond count/sum/avg/min/max.  It replaces the JAX
package's block step (``jax_eval._fused_step`` with ``_DeviceAgg.update`` and
the first-active-row tracker) at capacity C >= 1 in its three programs:
``jax_eval.agg_step`` (cold, one launch per block, host group ids),
``jax_eval.scan`` (warm, host group ids for the stacked image) and
``jax_eval.scan_coded`` (warm, group ids computed on the device from resident
dictionary codes, ``_mixed_radix_gids``), and ``jax_eval.pack``.

* ``compile_group_program`` lays the plan out as *leaves*: the rows of the
  packed state in ``jax_eval._pack_state``'s order — the tracker, then each
  aggregate's carry leaves (count: cnt; sum/avg: cnt, sum; min/max: cnt,
  extreme; bit_and/or/xor: cnt, acc; var_pop: cnt, sum, f64 sum of squares;
  first: cnt, value, row) — over the bytecode of ``copr/fused_agg.py``.
* ``fused_group_agg_plain`` computes the packed state with torch scatter ops
  (``index_add_``, ``scatter_reduce_``; bitwise aggregates by per-bit counts),
  with the semantics of the JAX package's scatter branch; it serves CPU
  tensors.
* ``fused_group_agg_cuda`` launches the grouped pair (``csrc/fused_agg.cu``):
  ``fused_group_agg_partials`` then ``fused_group_agg_combine_pack`` where
  the group state fits the partials kernel's shared memory (``C <=
  c_max``; :data:`ROWS` rows of a block a thread through the tile walk,
  the fold of ``csrc/ga_fold.cuh`` that ``batch_partials`` shares, in the
  instance of :func:`partials_slots` stack slots), else the wide route
  ``group_wide_partials`` then ``group_wide_combine``: the same tile walk
  and instances, one state in device memory, integer atomics, and f64 sums
  added exactly (``XWORDS`` words a cell) and rounded once (the combine: a
  block a run of slots, a thread a slot, the slots' REAL-sum cells staged
  in shared memory and carried in registers), so any capacity is served
  bit-identically from run to run.
  ``wide_partials_plain`` and ``wide_combine_plain`` are their plain
  versions, word for word.
* ``fused_group_agg`` takes the plain version for a CPU image and the kernels
  for a CUDA image; on a CUDA tensor it launches them or raises.

The packed state is an int64 matrix ``[n_int, C]`` (row 0 the tracker: the
global index of each group's first active row, ``NO_ROW`` for none) and an
f64 matrix ``[n_f64, C]``.  A carry passed in is updated in place.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import torch

from . import fused_agg as fa
from .datatypes import EvalType
from .fused_agg import (GRID_MAX, LAUNCHES, NO_ROW, ROWS, THREADS, Image, Unsupported,
                        emit_program, launch_grid)

# leaf kinds: the same table as the GA_* enum in csrc/fused_agg.cu
LEAF_TRACK = 0
LEAF_COUNT = 1
LEAF_SUM = 2
LEAF_SUMSQ = 3
LEAF_MIN = 4
LEAF_MAX = 5
LEAF_AND = 6
LEAF_OR = 7
LEAF_XOR = 8
LEAF_FIRSTROW = 9
LEAF_FIRSTVAL = 10

# limits and geometry of the kernels (csrc/fused_agg.cu; THREADS, GRID_MAX
# and ROWS, the rows a partials thread walks at once, are the capacity-1
# pair's too)
MAX_LEAVES = 64
MAX_KEYS = 4
WARPS = THREADS // 32
SMEM_MAX = 232448  # dynamic shared memory one block may use on Hopper
XWORDS = 66  # words of an exact f64 sum (GA_XW): units 2^-1074 to past 2^1037
XFLAG_POSINF, XFLAG_NEGINF, XFLAG_NAN = 1, 2, 4

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_QNAN = 0x7FF8000000000000
_BIT_LEAF = {"bit_and": LEAF_AND, "bit_or": LEAF_OR, "bit_xor": LEAF_XOR}
_ADD_LEAVES = (LEAF_COUNT, LEAF_SUM, LEAF_SUMSQ)
_ROW_LEAVES = (LEAF_TRACK, LEAF_FIRSTROW)


def _bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def _x_leaf(leaf) -> bool:
    return leaf.is_f64 and leaf.kind in (LEAF_SUM, LEAF_SUMSQ)


@dataclass(frozen=True)
class Leaf:
    """One row of the packed state."""

    kind: int
    agg: int  # the aggregate it belongs to; -1 for the tracker
    is_f64: bool  # stored in the f64 matrix
    arg_f64: bool  # the aggregate's value lane is f64
    slot: int  # row in the int64 or f64 matrix
    aux: int = -1  # LEAF_FIRSTVAL: index of its LEAF_FIRSTROW leaf

    @property
    def ident(self) -> int:
        """The identity, as the raw 64-bit word of the leaf's matrix."""
        k = self.kind
        if k in _ROW_LEAVES:
            return NO_ROW
        if k == LEAF_MIN:
            return _bits(float("inf")) if self.is_f64 else _I64_MAX
        if k == LEAF_MAX:
            return _bits(float("-inf")) if self.is_f64 else _I64_MIN
        if k == LEAF_AND:
            return -1
        return 0

    @property
    def ident_value(self):
        """The identity as a value of the leaf's dtype."""
        if self.is_f64:
            return struct.unpack("<d", struct.pack("<q", self.ident))[0]
        return self.ident


@dataclass(frozen=True)
class GroupProgram:
    code: tuple[int, ...]
    consts: tuple[int, ...]
    col_f64: tuple[bool, ...]
    leaves: tuple[Leaf, ...]
    agg_leaves: tuple[tuple[int, ...], ...]  # per aggregate: its leaves, in carry order
    n_int: int
    n_f64: int
    key_slots: tuple[int, ...] | None  # coded ids: key column slots; None: host ids
    dict_lens: tuple[int, ...]
    track: bool  # GROUP BY: the tracker runs

    @property
    def c_max(self) -> int:
        """Most group slots the shared-memory partials kernel takes:
        ``WARPS * n_leaves * (32 + C) * 8`` bytes must fit in ``SMEM_MAX``.
        Past it the wide route serves."""
        return SMEM_MAX // (WARPS * 8 * len(self.leaves)) - 32

    def shared_rows(self, capacity: int) -> bool:
        return capacity <= self.c_max

    @property
    def x_leaves(self) -> tuple[int, ...]:
        """The leaves the wide route sums exactly: REAL sums and sums of
        squares, in leaf order."""
        return tuple(l for l, leaf in enumerate(self.leaves) if _x_leaf(leaf))


def compile_group_program(sel_rpns, aggs, ship_cols, schema, key_slots, dict_lens=(),
                          track: bool = True) -> GroupProgram:
    """The grouped program for ``aggs`` (``(op, rpn | None)`` pairs of the ten
    device aggregates) under ``sel_rpns``.  ``key_slots`` are the column
    slots of the dictionary-coded key columns (with ``dict_lens``) for ids
    computed on the device, ``()`` for a single group, or None for host ids."""
    if key_slots is not None and len(key_slots) > MAX_KEYS:
        raise Unsupported(f"more than {MAX_KEYS} coded key columns", "plan_too_large")
    em, lane_f64 = emit_program(sel_rpns, aggs, ship_cols, schema)
    leaves = [Leaf(LEAF_TRACK, -1, False, False, 0)]
    n_int, n_f64 = 1, 0

    def add(kind, k, is_f, arg_f, aux=-1) -> int:
        nonlocal n_int, n_f64
        if is_f:
            slot, n_f64 = n_f64, n_f64 + 1
        else:
            slot, n_int = n_int, n_int + 1
        leaves.append(Leaf(kind, k, is_f, arg_f, slot, aux))
        return len(leaves) - 1

    agg_leaves = []
    for k, ((op, _rpn), f) in enumerate(zip(aggs, lane_f64)):
        own = [add(LEAF_COUNT, k, False, f)]
        if op in ("sum", "avg"):
            own.append(add(LEAF_SUM, k, f, f))
        elif op in ("min", "max"):
            own.append(add(LEAF_MIN if op == "min" else LEAF_MAX, k, f, f))
        elif op in _BIT_LEAF:
            if f:
                raise Unsupported(f"{op} of a REAL argument", "agg_arg_type_not_ported")
            own.append(add(_BIT_LEAF[op], k, False, f))
        elif op == "var_pop":
            own.append(add(LEAF_SUM, k, f, f))
            own.append(add(LEAF_SUMSQ, k, True, f))
        elif op == "first":
            val = add(LEAF_FIRSTVAL, k, f, f)
            own.append(val)
            own.append(add(LEAF_FIRSTROW, k, False, f))
            leaves[val] = Leaf(LEAF_FIRSTVAL, k, f, f, leaves[val].slot, own[-1])
        elif op != "count":
            raise Unsupported(f"aggregate {op}", "agg_op_not_ported")
        agg_leaves.append(tuple(own))
    if len(leaves) > MAX_LEAVES:
        raise Unsupported(f"more than {MAX_LEAVES} state leaves", "plan_too_large")
    col_f64 = tuple(schema[c][0] == EvalType.REAL for c in ship_cols)
    return GroupProgram(tuple(em.code), tuple(em.consts), col_f64, tuple(leaves),
                        tuple(agg_leaves), n_int, n_f64,
                        None if key_slots is None else tuple(key_slots), tuple(dict_lens),
                        track)


def init_packed(prog: GroupProgram, capacity: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The identity state at ``capacity`` slots."""
    ints = torch.empty((prog.n_int, capacity), dtype=torch.int64, device=device)
    flts = torch.empty((prog.n_f64, capacity), dtype=torch.float64, device=device)
    for leaf in prog.leaves:
        (flts if leaf.is_f64 else ints)[leaf.slot].fill_(leaf.ident_value)
    return ints, flts


def grow_carry(prog: GroupProgram, packed, new_capacity: int):
    """``packed`` widened to ``new_capacity`` slots, new slots at the
    identity (``jax_eval._grow_carry``)."""
    ints, flts = packed
    new_i, new_f = init_packed(prog, new_capacity, ints.device)
    new_i[:, : ints.shape[1]] = ints
    new_f[:, : flts.shape[1]] = flts
    return new_i, new_f


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.minimum's f64 semantics: NaN propagates, -0.0 below +0.0."""
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(a.signbit() | b.signbit(), -0.0, 0.0),
                       torch.minimum(a, b))


def _fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    zeros = (a == 0) & (b == 0)
    return torch.where(zeros, torch.where(a.signbit() & b.signbit(), -0.0, 0.0),
                       torch.maximum(a, b))


def _merge(leaf: Leaf, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    k = leaf.kind
    if k in _ADD_LEAVES:
        return a + b
    if k in _ROW_LEAVES:
        return torch.minimum(a, b)
    if k == LEAF_MIN:
        return _fmin(a, b) if leaf.is_f64 else torch.minimum(a, b)
    if k == LEAF_MAX:
        return _fmax(a, b) if leaf.is_f64 else torch.maximum(a, b)
    if k == LEAF_AND:
        return a & b
    if k == LEAF_OR:
        return a | b
    if k == LEAF_XOR:
        return a ^ b
    return a  # LEAF_FIRSTVAL: taken at the winning row, not merged


def _seg_bitop(kind: int, seg: torch.Tensor, vals: torch.Tensor, n_seg: int) -> torch.Tensor:
    """Per-segment AND/OR/XOR from per-bit counts: torch has no bitwise
    scatter, and counting each bit is exact in any order."""
    dev = vals.device
    rows = torch.zeros(n_seg, dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.ones_like(vals))
    out = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    for b in range(64):
        c = torch.zeros(n_seg, dtype=torch.int64, device=dev).index_add_(0, seg, (vals >> b) & 1)
        if kind == LEAF_AND:
            hit = c == rows  # a segment with no rows keeps the identity, all ones
        elif kind == LEAF_OR:
            hit = c > 0
        else:
            hit = (c & 1) == 1
        out |= hit.to(torch.int64) << b
    return out


def _seg_reduce(leaf: Leaf, mask: torch.Tensor, vals, seg: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """``[n_seg]`` accumulators of the rows in ``mask``, from the identity:
    the JAX package's scatter branch (``_seg_sum``, ``_seg_extreme``,
    ``_seg_bitop`` under ``_scatter_ok``)."""
    dtype = torch.float64 if leaf.is_f64 else torch.int64
    acc = torch.full((n_seg,), leaf.ident_value, dtype=dtype, device=seg.device)
    if leaf.kind == LEAF_FIRSTVAL:
        return acc
    s, v = seg[mask], vals[mask].to(dtype)
    k = leaf.kind
    if k in _ADD_LEAVES:
        return acc.index_add_(0, s, v)
    if k in (LEAF_AND, LEAF_OR, LEAF_XOR):
        return _seg_bitop(k, s, v, n_seg)
    is_max = k == LEAF_MAX
    acc.scatter_reduce_(0, s, v, "amax" if is_max else "amin")
    if leaf.is_f64:
        # XLA's scatter-min keeps -0.0 over +0.0 whatever the row order
        # (scatter-max the reverse); torch's keeps whichever came first
        zero = v == 0
        want_sign = zero & (~v.signbit() if is_max else v.signbit())
        seen = torch.zeros(n_seg, dtype=torch.int64, device=seg.device).index_add_(
            0, s[want_sign], torch.ones_like(s[want_sign]))
        keep = 0.0 if is_max else -0.0
        acc = torch.where((acc == 0) & (seen > 0), keep, acc)
        acc = torch.where((acc == 0) & (seen == 0), -keep, acc)
    return acc


def _flat_gids(prog: GroupProgram, img: Image, capacity: int) -> torch.Tensor:
    """The group id of every flat row, -1 where it falls outside the slots.
    Coded ids read the key columns' dictionary codes widened to int64 (they
    are narrowed int8/int16 lanes in an encoded image)."""
    n = img.n_blocks * img.block_rows
    if prog.key_slots is None:
        g = img.gids.reshape(-1).to(torch.int64)
    else:
        g = torch.zeros(n, dtype=torch.int64, device=img.device)
        for slot, dlen in zip(prog.key_slots, prog.dict_lens):
            codes, nl = img.lanes(slot)
            codes = codes.reshape(-1)
            if nl is not None:
                codes = torch.where(nl.reshape(-1), dlen, codes)
            g = g * (dlen + 1) + codes
    return torch.where((g >= 0) & (g < capacity), g, -1)


def _row_terms(prog: GroupProgram, img: Image, capacity: int):
    """Per leaf, which rows add to it and what: ``(mask, values)``; with the
    rows' group ids and the walk's per-aggregate ``(live, value)``."""
    outs, active = fa.walk_rows(prog, img, len(prog.agg_leaves))
    gid = _flat_gids(prog, img, capacity)
    ok = active & (gid >= 0)
    flat = torch.arange(img.n_blocks * img.block_rows, device=img.device)
    none = torch.zeros_like(ok)
    ones = torch.ones_like(flat)
    terms = []
    for leaf in prog.leaves:
        if leaf.kind == LEAF_TRACK:
            terms.append((ok if prog.track else none, flat))
            continue
        if leaf.kind == LEAF_FIRSTVAL:
            terms.append((none, flat))
            continue
        live, value = outs[leaf.agg]
        mask = ok & live
        if leaf.kind == LEAF_COUNT:
            terms.append((mask, ones))
        elif leaf.kind == LEAF_SUMSQ:
            x = value.to(torch.float64)
            terms.append((mask, x * x))
        elif leaf.kind == LEAF_FIRSTROW:
            terms.append((mask, flat))
        else:
            terms.append((mask, value))
    return terms, gid, outs


def _global_rows(img: Image, flat: torch.Tensor) -> torch.Tensor:
    """Global row index of each flat index (block * block_rows + row);
    NO_ROW stays."""
    none = flat >= NO_ROW
    safe = torch.where(none, 0, flat)
    blk = safe // img.block_rows
    off = img.offsets[blk] if isinstance(img.offsets, torch.Tensor) else img.offsets
    return torch.where(none, NO_ROW, off + (safe - blk * img.block_rows))


def _finish(prog: GroupProgram, img: Image, capacity: int, totals, outs, carry):
    """Fold this launch's per-leaf totals (tracker and first's rows as flat
    indices) into the carry, carry first, in place."""
    packed = carry if carry is not None else init_packed(prog, capacity, img.device)
    ints, flts = packed
    res = []
    for leaf, t in zip(prog.leaves, totals):
        old = (flts if leaf.is_f64 else ints)[leaf.slot]
        if leaf.kind in _ROW_LEAVES:
            res.append(torch.minimum(old, _global_rows(img, t)))
        elif leaf.kind == LEAF_FIRSTVAL:
            row_leaf = prog.leaves[leaf.aux]
            win = totals[leaf.aux]
            better = _global_rows(img, win) < ints[row_leaf.slot]
            value = outs[leaf.agg][1].reshape(-1)[torch.where(win < NO_ROW, win, 0)]
            res.append(torch.where(better, value, old))
        else:
            res.append(_merge(leaf, old, t))
    for leaf, r in zip(prog.leaves, res):
        (flts if leaf.is_f64 else ints)[leaf.slot] = r
    return packed


def fused_group_agg_plain(prog: GroupProgram, img: Image, capacity: int, carry=None):
    """The plain PyTorch version of both kernels: the packed state after
    folding ``img`` into ``carry`` (None: the identity state)."""
    terms, gid, outs = _row_terms(prog, img, capacity)
    totals = [_seg_reduce(leaf, m, v, gid, capacity) for leaf, (m, v) in zip(prog.leaves, terms)]
    return _finish(prog, img, capacity, totals, outs, carry)


def wide_grid(img: Image) -> int:
    """Blocks of ``group_wide_partials``: the tile walk's grid, as
    :func:`launch_grid` (its updates commute, so no plain version follows
    it)."""
    return launch_grid(img)


def partials_plain(prog: GroupProgram, img: Image, capacity: int, grid: int | None = None,
                   rows_a_thread: int = ROWS) -> torch.Tensor:
    """Plain version of the shared-memory ``fused_group_agg_partials`` (and
    of ``batch_partials``' rows of a task): ``[grid, n_leaves, C]`` int64
    words (f64 as bits), by default at the kernel's :func:`launch_grid`.
    A thread takes ``rows_a_thread`` R rows of one block at once (the tile
    walk): row i of block b is in tile ``b * ceil(block_rows / R) + i //
    R``, and tile u goes to block ``(u mod grid*THREADS) // THREADS`` as in
    the kernel, so integer leaves agree word for word.  f64 leaves are
    summed in another order than the kernel's."""
    grid = launch_grid(img) if grid is None else grid
    terms, gid, _outs = _row_terms(prog, img, capacity)
    seg = fa.tile_blocks(img, grid, THREADS, rows_a_thread) * capacity + gid
    rows = []
    for leaf, (m, v) in zip(prog.leaves, terms):
        acc = _seg_reduce(leaf, m, v, seg, grid * capacity)
        rows.append(acc.view(torch.int64) if leaf.is_f64 else acc)
    return torch.stack(rows).reshape(len(prog.leaves), grid, capacity).transpose(0, 1).contiguous()


def combine_plain(prog: GroupProgram, img: Image, capacity: int, parts: torch.Tensor,
                  carry=None):
    """Plain version of ``fused_group_agg_combine_pack``: the partials folded
    in block order, then into the carry."""
    totals = []
    for l, leaf in enumerate(prog.leaves):
        col = parts[:, l, :]
        if leaf.is_f64:
            col = col.view(torch.float64)
        acc = torch.full((capacity,), leaf.ident_value, dtype=col.dtype, device=col.device)
        for q in range(col.shape[0]):
            acc = _merge(leaf, acc, col[q])
        totals.append(acc)
    outs = None
    if any(leaf.kind == LEAF_FIRSTVAL for leaf in prog.leaves):
        outs = fa.walk_rows(prog, img, len(prog.agg_leaves))[0]
    return _finish(prog, img, capacity, totals, outs, carry)


# ---------------------------------------------------------------------------
# The wide route (C > c_max): plain versions, word for word
# ---------------------------------------------------------------------------

def _fkey(x: torch.Tensor, is_max: bool) -> torch.Tensor:
    """``ga_fkey``: int64 keys that order as the f64 values do, -0.0 below
    +0.0; NaN the least key for min and the greatest for max."""
    b = x.contiguous().view(torch.int64)
    k = torch.where(b < 0, b ^ _I64_MAX, b)
    return torch.where(x.isnan(), _I64_MAX if is_max else _I64_MIN, k)


def _funkey(k: torch.Tensor, is_max: bool) -> torch.Tensor:
    """``ga_funkey``: the f64 value of a key (a NaN key: the quiet NaN)."""
    b = torch.where(k < 0, k ^ _I64_MAX, k)
    return torch.where(k == (_I64_MAX if is_max else _I64_MIN), _QNAN, b).view(torch.float64)


def wide_idents(prog: GroupProgram) -> list[int]:
    """Each leaf's initial word in the wide route's state: its identity; an
    f64 min or max leaf's as its key; 0 (no NaN or infinity seen) for an f64
    sum, whose value lies in its exact accumulator."""
    out = []
    for leaf in prog.leaves:
        if _x_leaf(leaf):
            out.append(0)
        elif leaf.is_f64 and leaf.kind in (LEAF_MIN, LEAF_MAX):
            ident = torch.tensor([leaf.ident_value], dtype=torch.float64)
            out.append(int(_fkey(ident, leaf.kind == LEAF_MAX)[0]))
        else:
            out.append(leaf.ident)
    return out


def wide_size(prog: GroupProgram, capacity: int) -> int:
    """int64 words of the wide route's state: ``[n_leaves, C]`` words, then
    ``[n_x, C, XWORDS]`` exact accumulators."""
    return (len(prog.leaves) + len(prog.x_leaves) * XWORDS) * capacity


def _wide_views(prog: GroupProgram, capacity: int, state: torch.Tensor):
    n = len(prog.leaves) * capacity
    return state[:n].view(len(prog.leaves), capacity), \
        state[n:].view(len(prog.x_leaves), capacity, XWORDS)


def _xdigits(v: torch.Tensor):
    """``ga_xadd``'s split of finite f64 values ``v = m * 2^(pos - 1074)``:
    the word of each value's lowest digit (``pos // 32``) and its three
    signed 32-bit digits."""
    b = v.contiguous().view(torch.int64)
    e = (b >> 52) & 0x7FF
    m = (b & 0xFFFFFFFFFFFFF) | torch.where(e > 0, 1 << 52, 0)
    pos = torch.where(e > 0, e - 1, 0)
    sh = pos & 31
    one = torch.ones_like(sh)
    hi = m >> (32 - sh)
    sign = torch.where(b < 0, -1, 1)
    lo = (m & ((one << (32 - sh)) - 1)) << sh
    return pos >> 5, [lo * sign, (hi & 0xFFFFFFFF) * sign, (hi >> 32) * sign]


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bits of each value in ``[1, 2^32)``."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        n += s * ((x >> (n + s)) > 0)
    return n + 1


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """``2^e`` for int64 ``e`` in ``[-1022, 1023]``, from its bits (a float
    ``pow`` need not be exact on every device)."""
    return ((e + 1023) << 52).view(torch.float64)


def _ldexp(m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``m * 2^e`` for f64 ``m`` of at most 53 bits and ``e`` up to 1023, in
    two exact steps (``2^e`` alone is not normal below 2^-1022)."""
    e1 = e.clamp(min=-1000)
    return m * _pow2(e1) * _pow2(e - e1)


def _xround(cells: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gw_xround`` over ``[n, XWORDS]`` exact sums: each
    sum rounded to the nearest f64, ties to even, by the same integer steps
    (the kernel keeps only the digits the rounding reads)."""
    n = cells.shape[0]
    c = torch.zeros(n, dtype=torch.int64, device=cells.device)
    for k in range(XWORDS):
        c = (cells[:, k] + c) >> 32
    neg = c < 0
    src = torch.where(neg[:, None], -cells, cells)
    d = torch.empty((n, XWORDS + 1), dtype=torch.int64, device=cells.device)
    c = torch.zeros_like(c)
    for k in range(XWORDS):
        v = src[:, k] + c
        d[:, k] = v & 0xFFFFFFFF
        c = v >> 32
    d[:, XWORDS] = c
    nz = d != 0
    idx = torch.arange(XWORDS + 1, device=cells.device)
    h = torch.where(nz, idx, -1).max(dim=1).values
    top = 32 * h + _bit_length(d.gather(1, h.clamp(min=0)[:, None])[:, 0].clamp(min=1)) - 1
    t = top - 61
    win = torch.zeros_like(c)
    sticky = (nz & (idx < (h - 2)[:, None])).any(dim=1)
    for j in range(3):
        k = h - j
        x = torch.where(k >= 0, d.gather(1, k.clamp(min=0)[:, None])[:, 0], 0)
        s = 32 * k - t
        r = (-s).clamp(min=0)
        win |= torch.where(s >= 0, x << s.clamp(min=0), x >> r)
        sticky |= (s < 0) & ((x & ((torch.ones_like(r) << r) - 1)) != 0)
    mant = win >> 9
    rem = (win & 0x1FF) | sticky.to(torch.int64)
    mant = mant + ((rem > 0x100) | ((rem == 0x100) & ((mant & 1) == 1))).to(torch.int64)
    out = _ldexp(mant.to(torch.float64), t + 9 - 1074)
    out = torch.where(neg, -out, out)
    return torch.where(h < 0, 0.0, out)


def _xtotal(flags: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """The total of an f64 sum cell (``group_wide_combine``): NaN where a
    NaN or both infinities were added, an infinity where one was, else the
    rounded exact sum."""
    out = _xround(cells)
    out = torch.where((flags & XFLAG_NEGINF) != 0, float("-inf"), out)
    out = torch.where((flags & XFLAG_POSINF) != 0, float("inf"), out)
    nan = ((flags & XFLAG_NAN) != 0) | ((flags & 3) == 3)
    return torch.where(nan, torch.tensor(_QNAN).view(torch.float64), out)


def wide_partials_plain(prog: GroupProgram, img: Image, capacity: int) -> torch.Tensor:
    """Plain version of ``group_wide_partials``: the flat state
    (:func:`wide_size` words) it leaves, word for word: integer leaves and
    rows by scatter, f64 min/max as keys, f64 sums as the exact sums of each
    row's digits with their specials in the leaf's word."""
    terms, gid, _outs = _row_terms(prog, img, capacity)
    dev = img.device
    state = torch.zeros(wide_size(prog, capacity), dtype=torch.int64, device=dev)
    words, xacc = _wide_views(prog, capacity, state)
    idents = wide_idents(prog)
    x = 0
    for l, (leaf, (m, v)) in enumerate(zip(prog.leaves, terms)):
        if _x_leaf(leaf):
            s, val = gid[m], v[m].to(torch.float64)
            for bit, hit in ((XFLAG_NAN, val.isnan()), (XFLAG_POSINF, val == float("inf")),
                             (XFLAG_NEGINF, val == float("-inf"))):
                seen = torch.zeros(capacity, dtype=torch.int64, device=dev).index_add_(
                    0, s[hit], torch.ones_like(s[hit]))
                words[l] |= torch.where(seen > 0, bit, 0)
            fin = val.isfinite() & (val != 0)
            k, digits = _xdigits(val[fin])
            base = s[fin] * XWORDS + k
            flat = xacc[x].view(-1)
            for q, dq in enumerate(digits):
                flat.index_add_(0, base + q, dq)
            x += 1
        elif leaf.kind == LEAF_FIRSTVAL:
            words[l] = idents[l]
        else:
            r = _seg_reduce(leaf, m, v, gid, capacity)
            words[l] = _fkey(r, leaf.kind == LEAF_MAX) if leaf.is_f64 else r
    return state


def wide_combine_plain(prog: GroupProgram, img: Image, capacity: int, state: torch.Tensor,
                       carry=None):
    """Plain version of ``group_wide_combine``: each cell's total (a word,
    a decoded key, a rounded exact sum) folded into the carry, in place."""
    words, xacc = _wide_views(prog, capacity, state)
    totals = []
    x = 0
    for l, leaf in enumerate(prog.leaves):
        if _x_leaf(leaf):
            totals.append(_xtotal(words[l], xacc[x]))
            x += 1
        elif leaf.is_f64 and leaf.kind in (LEAF_MIN, LEAF_MAX):
            totals.append(_funkey(words[l], leaf.kind == LEAF_MAX))
        else:
            totals.append(words[l])
    outs = None
    if any(leaf.kind == LEAF_FIRSTVAL for leaf in prog.leaves):
        outs = fa.walk_rows(prog, img, len(prog.agg_leaves))[0]
    return _finish(prog, img, capacity, totals, outs, carry)


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

class _GaParams(ctypes.Structure):
    """``GaParams`` of csrc/fused_agg.cu, passed to the kernels by value."""

    _fields_ = [
        ("col", ctypes.c_uint64 * fa.MAX_COLS),
        ("nul", ctypes.c_uint64 * fa.MAX_COLS),
        ("enc", fa._Enc),
        ("n_valids", ctypes.c_uint64),
        ("offsets", ctypes.c_uint64),
        ("gids", ctypes.c_uint64),
        ("n_valid_all", ctypes.c_int64),
        ("offset_all", ctypes.c_int64),
        ("n_blocks", ctypes.c_int64),
        ("block_rows", ctypes.c_int64),
        ("consts", ctypes.c_int64 * fa.MAX_CONSTS),
        ("leaf_ident", ctypes.c_int64 * MAX_LEAVES),
        ("code", ctypes.c_int32 * fa.MAX_CODE),
        ("n_code", ctypes.c_int32),
        ("n_cols", ctypes.c_int32),
        ("n_aggs", ctypes.c_int32),
        ("n_leaves", ctypes.c_int32),
        ("capacity", ctypes.c_int32),
        ("track", ctypes.c_int32),
        ("n_keys", ctypes.c_int32),
        ("key_slot", ctypes.c_int32 * MAX_KEYS),
        ("key_dlen", ctypes.c_int32 * MAX_KEYS),
        ("agg_leaf0", ctypes.c_int32 * fa.MAX_AGGS),
        ("agg_nleaves", ctypes.c_int32 * fa.MAX_AGGS),
        ("leaf_kind", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_f64", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_arg_f64", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_slot", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_agg", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_aux", ctypes.c_int8 * MAX_LEAVES),
    ]


def group_params(prog: GroupProgram, img: Image, capacity: int) -> _GaParams:
    """The kernels' parameter block for ``prog`` over ``img``."""
    p = _GaParams()
    p.consts[: len(prog.consts)] = prog.consts
    p.code[: len(prog.code)] = prog.code
    p.n_code = len(prog.code)
    p.n_cols = len(prog.col_f64)
    p.n_aggs = len(prog.agg_leaves)
    p.n_leaves = len(prog.leaves)
    p.capacity = capacity
    p.track = int(prog.track)
    for k, own in enumerate(prog.agg_leaves):
        p.agg_leaf0[k] = own[0]
        p.agg_nleaves[k] = len(own)
    for l, leaf in enumerate(prog.leaves):
        p.leaf_ident[l] = leaf.ident
        p.leaf_kind[l] = leaf.kind
        p.leaf_f64[l] = int(leaf.is_f64)
        p.leaf_arg_f64[l] = int(leaf.arg_f64)
        p.leaf_slot[l] = leaf.slot
        p.leaf_agg[l] = leaf.agg
        p.leaf_aux[l] = leaf.aux
    if prog.key_slots is not None:
        p.n_keys = len(prog.key_slots)
        p.key_slot[: p.n_keys] = prog.key_slots
        p.key_dlen[: p.n_keys] = prog.dict_lens
    fa.set_columns(p, img)
    if isinstance(img.n_valids, int):
        p.n_valids, p.n_valid_all = 0, img.n_valids
    else:
        p.n_valids = img.n_valids.data_ptr()
    if isinstance(img.offsets, int):
        p.offsets, p.offset_all = 0, img.offsets
    else:
        p.offsets = img.offsets.data_ptr()
    p.gids = 0 if img.gids is None else img.gids.data_ptr()
    p.n_blocks, p.block_rows = img.n_blocks, img.block_rows
    return p


_declared = False


def _kernels():
    """The kernel library (``fused_agg``), with the grouped entry points
    declared and the parameter block's layout checked."""
    global _declared
    lib = fa._kernels()
    if not _declared:
        vp = ctypes.c_void_p
        lib.ga_params_size.restype = ctypes.c_int
        lib.ga_smem_max.restype = ctypes.c_int
        lib.ga_xwords.restype = ctypes.c_int
        lib.ga_launch_partials.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           vp]
        lib.ga_partials_attributes.argtypes = [ctypes.c_int, vp]
        lib.ga_partials_attributes.restype = ctypes.c_int
        lib.ga_tile_rows.restype = ctypes.c_int
        lib.ga_launch_combine.argtypes = [vp, vp, ctypes.c_int, vp, vp, vp, vp, ctypes.c_int,
                                          vp]
        lib.ga_combine_attributes.argtypes = [ctypes.c_int, vp]
        lib.ga_combine_attributes.restype = ctypes.c_int
        lib.gw_launch_partials.argtypes = [vp, vp, vp, ctypes.c_int, ctypes.c_int, vp]
        lib.gw_partials_attributes.argtypes = [ctypes.c_int, vp]
        lib.gw_partials_attributes.restype = ctypes.c_int
        lib.gw_launch_combine.argtypes = [vp, vp, vp, vp, vp, vp, vp, ctypes.c_int, vp]
        lib.gw_combine_attributes.argtypes = [ctypes.c_int, vp]
        lib.gw_combine_attributes.restype = ctypes.c_int
        for fn in ("ga_launch_partials", "ga_launch_combine", "gw_launch_partials",
                   "gw_launch_combine"):
            getattr(lib, fn).restype = ctypes.c_int
        if lib.ga_params_size() != ctypes.sizeof(_GaParams):
            raise RuntimeError(
                f"GaParams layout mismatch: kernel {lib.ga_params_size()} bytes, "
                f"wrapper {ctypes.sizeof(_GaParams)}")
        if lib.ga_smem_max() != SMEM_MAX or lib.ga_xwords() != XWORDS \
                or lib.ga_tile_rows() != ROWS:
            raise RuntimeError("GA_SMEM_MAX, GA_XW or GA_ROWS of the kernel differs from the "
                               "wrapper's")
        _declared = True
    return lib


def partials_slots(prog: GroupProgram) -> int:
    """The stack slots of the ``fused_group_agg_partials`` or
    ``group_wide_partials`` instance that runs ``prog``: the fewest of 2, 4
    or 8 that hold its plan."""
    return fa.stack_slots([prog.code])


def partials_smem(prog: GroupProgram, capacity: int) -> int:
    """Dynamic shared memory of a ``fused_group_agg_partials`` block: the
    warps' stage ``[L][32]`` and rows ``[L][C]``."""
    return WARPS * len(prog.leaves) * (32 + capacity) * 8


def partials_attributes(slots: int, wide: bool = False) -> dict:
    """``cudaFuncGetAttributes`` of the ``fused_group_agg_partials`` (or,
    ``wide``, ``group_wide_partials``) instance of ``slots`` stack slots:
    registers a thread, local (spilled) bytes a thread, static shared bytes
    a block."""
    name = "group_wide_partials" if wide else "fused_group_agg_partials"
    out = (ctypes.c_int * 3)()
    lib = _kernels()
    rc = (lib.gw_partials_attributes if wide else lib.ga_partials_attributes)(slots, out)
    if rc != 0:
        raise RuntimeError(f"{name} attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2],
            "stackSlots": slots}


def combine_attributes(slots: int, wide: bool = False) -> dict:
    """``cudaFuncGetAttributes`` of the ``fused_group_agg_combine_pack`` (or,
    ``wide``, ``group_wide_combine``) instance of ``slots`` stack slots
    (first's walk at the winning row; :func:`combine_kernel` picks it):
    registers a thread, local (spilled) bytes a thread, static shared bytes
    a block."""
    name = "group_wide_combine" if wide else "fused_group_agg_combine_pack"
    out = (ctypes.c_int * 3)()
    lib = _kernels()
    rc = (lib.gw_combine_attributes if wide else lib.ga_combine_attributes)(slots, out)
    if rc != 0:
        raise RuntimeError(f"{name} attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2],
            "stackSlots": slots}


def combine_kernel(prog: GroupProgram, capacity: int) -> tuple[str, int]:
    """The combine that folds ``prog``'s partials at ``capacity`` slots, as
    ``(kernel, stack slots)``: ``fused_group_agg_combine_pack`` up to
    ``c_max``, ``group_wide_combine`` past it, each the instance whose walk
    of first's winning row holds the plan (:func:`partials_slots`, the
    partials' own)."""
    name = "fused_group_agg_combine_pack" if prog.shared_rows(capacity) else "group_wide_combine"
    return name, partials_slots(prog)


def check_capacity(prog: GroupProgram, capacity: int) -> None:
    """``ValueError`` for a capacity outside ``[1, 2^31)``; every capacity
    in it is served (past ``c_max`` by the wide route)."""
    if not 1 <= capacity < (1 << 31):
        raise ValueError(f"capacity {capacity} out of range")


def _check_group_image(prog: GroupProgram, img: Image, capacity: int) -> None:
    fa.check_columns(prog.col_f64, img)
    shape = (img.n_blocks, img.block_rows)
    if prog.key_slots is None:
        g = img.gids
        if g is None or g.device != img.device or g.dtype != torch.int32 \
                or tuple(g.shape) != shape or not g.is_contiguous():
            raise ValueError(f"gids: need contiguous int32 {shape} on {img.device}")
    else:
        for s in prog.key_slots:
            if prog.col_f64[s] or img.desc(s)[0] not in ("plain", "code"):
                raise ValueError(f"key column slot {s} must hold dictionary codes")
    off = img.offsets
    if not isinstance(off, int) and (off.device != img.device or off.dtype != torch.int64
                                     or tuple(off.shape) != (img.n_blocks,)
                                     or not off.is_contiguous()):
        raise ValueError(f"offsets: need contiguous int64 ({img.n_blocks},) on {img.device}")
    check_capacity(prog, capacity)


def new_partials(prog: GroupProgram, img: Image, capacity: int) -> torch.Tensor:
    """Scratch for ``launch_partials``: ``[grid, n_leaves, C]`` for the
    shared-memory kernel; the wide route's flat state (:func:`wide_size`
    words) at its initial words and zero accumulators past ``c_max``."""
    L = len(prog.leaves)
    if prog.shared_rows(capacity):
        return torch.empty((launch_grid(img), L, capacity), dtype=torch.int64, device=img.device)
    state = torch.zeros(wide_size(prog, capacity), dtype=torch.int64, device=img.device)
    ident = torch.tensor(wide_idents(prog), dtype=torch.int64).to(img.device)
    _wide_views(prog, capacity, state)[0].copy_(ident[:, None].expand(L, capacity))
    return state


def _check_parts(prog: GroupProgram, img: Image, capacity: int, parts: torch.Tensor) -> None:
    if prog.shared_rows(capacity):
        ok = parts.dim() == 3 and tuple(parts.shape[1:]) == (len(prog.leaves), capacity)
        want = f"[n, {len(prog.leaves)}, {capacity}]"
    else:
        ok = tuple(parts.shape) == (wide_size(prog, capacity),)
        want = f"({wide_size(prog, capacity)},)"
    if not ok or parts.device != img.device or parts.dtype != torch.int64 \
            or not parts.is_contiguous():
        raise ValueError(f"partials: need contiguous int64 {want} on {img.device}")


def launch_partials(prog: GroupProgram, img: Image, capacity: int, out: torch.Tensor) -> None:
    """Launch the partials kernel of the capacity's route into ``out``
    (:func:`new_partials`): ``fused_group_agg_partials`` (``C <= c_max``)
    or ``group_wide_partials``."""
    _check_group_image(prog, img, capacity)
    shared = prog.shared_rows(capacity)
    if shared and out.dim() == 3 and out.shape[0] != launch_grid(img):
        raise ValueError(f"partials: need {launch_grid(img)} rows for this image")
    _check_parts(prog, img, capacity, out)
    lib = _kernels()
    p = group_params(prog, img, capacity)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        if shared:
            name = "fused_group_agg_partials"
            rc = lib.ga_launch_partials(ctypes.byref(p), out.data_ptr(), launch_grid(img),
                                        partials_smem(prog, capacity), partials_slots(prog),
                                        stream)
        else:
            name = "group_wide_partials"
            fa.check_tiles(img)
            words, xacc = _wide_views(prog, capacity, out)
            rc = lib.gw_launch_partials(ctypes.byref(p), words.data_ptr(),
                                        xacc.data_ptr() if xacc.numel() else None,
                                        wide_grid(img), partials_slots(prog), stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def launch_combine(prog: GroupProgram, img: Image, capacity: int, parts: torch.Tensor,
                   carry, out) -> None:
    """Launch the combine of the capacity's route,
    ``fused_group_agg_combine_pack`` or ``group_wide_combine``: fold
    ``parts`` into ``carry`` (None: the identity state) and write the packed
    state to ``out``, which may be ``carry`` itself."""
    _check_group_image(prog, img, capacity)
    dev = img.device
    _check_parts(prog, img, capacity, parts)
    for packed in (out,) if carry is None else (out, carry):
        for t, dt, rows in zip(packed, (torch.int64, torch.float64), (prog.n_int, prog.n_f64)):
            if t.device != dev or t.dtype != dt or tuple(t.shape) != (rows, capacity) \
                    or not t.is_contiguous():
                raise ValueError(f"packed state: need contiguous {dt} ({rows}, {capacity}) on {dev}")
    lib = _kernels()
    p = group_params(prog, img, capacity)

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    ci, cf = carry if carry is not None else (None, None)
    name, slots = combine_kernel(prog, capacity)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if name == "fused_group_agg_combine_pack":
            rc = lib.ga_launch_combine(ctypes.byref(p), parts.data_ptr(), parts.shape[0],
                                       ptr(ci), ptr(cf), ptr(out[0]), ptr(out[1]), slots, stream)
        else:
            words, xacc = _wide_views(prog, capacity, parts)
            rc = lib.gw_launch_combine(ctypes.byref(p), words.data_ptr(), ptr(xacc), ptr(ci),
                                       ptr(cf), ptr(out[0]), ptr(out[1]), slots, stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def fused_group_agg_cuda(prog: GroupProgram, img: Image, capacity: int, carry=None):
    """Both kernels on the image's current stream; no host synchronisation."""
    parts = new_partials(prog, img, capacity)
    launch_partials(prog, img, capacity, parts)
    out = carry if carry is not None else (
        torch.empty((prog.n_int, capacity), dtype=torch.int64, device=img.device),
        torch.empty((prog.n_f64, capacity), dtype=torch.float64, device=img.device),
    )
    launch_combine(prog, img, capacity, parts, carry, out)
    return out


def fused_group_agg(prog: GroupProgram, img: Image, capacity: int, carry=None):
    """Packed state after folding ``img`` into ``carry`` at ``capacity``
    group slots: the plain version for a CPU image, the CUDA kernels of the
    capacity's route for a CUDA image."""
    if img.device.type == "cpu":
        check_capacity(prog, capacity)
        return fused_group_agg_plain(prog, img, capacity, carry)
    if img.device.type == "cuda":
        return fused_group_agg_cuda(prog, img, capacity, carry)
    raise ValueError(f"no fused_group_agg for device {img.device}")
