"""Zone-tile kernels: tile programs, plain versions, CUDA launchers.

The device half of the zone rung (``copr/zone.py``).  It replaces the JAX
package's programs #12 ``jax_zone.full`` (``jax_zone.py:496``) and #13
``jax_zone.partial`` (``:583``), with their ``jax.ops.segment_*`` calls and
``_merge_states`` (``:774``):

* ``compile_tile_program`` lays a plan out with the grouped kernels' leaves
  (``copr/fused_group_agg.py``: the first-active-row tracker, then each
  aggregate's count / sum / sum of squares / min / max leaves) over the
  bytecode of ``copr/fused_agg.py``.  A full-tile program holds the
  aggregate arguments alone (no selection: on a full tile every row passes
  it); a partial-tile program holds the selection too.
* ``zone_full`` reduces each listed full tile to one row of per-leaf
  partials: count, exact int64 sum, f64 sum of squares, int64 min and max,
  and the tile's least ``ridx``; no mask, no NULL (classification sends any
  tile with a NULL in a referenced column to the partial list).
* ``zone_partial`` does the same over the listed partial tiles, with the
  selection walked per row and pad rows and NULLs masked.
* ``zone_fold`` folds both lists' rows into the group slots in a fixed
  order (:func:`copr.zone.fold_order`) and writes the packed state that
  ``TorchDagEvaluator._finalize_agg`` reads: an int64 matrix ``[n_int, C]``
  (row 0 the tracker, ``NO_ROW`` for a group with no active row) and an f64
  matrix ``[n_f64, C]``.

Each wrapper runs its plain version for CPU tensors and its kernel of
``csrc/fused_zone.cu`` for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import fused_agg as fa
from .fused_agg import LAUNCHES, NO_ROW, Image
from .fused_group_agg import (
    LEAF_COUNT,
    LEAF_MAX,
    LEAF_MIN,
    LEAF_SUM,
    LEAF_SUMSQ,
    LEAF_TRACK,
    MAX_LEAVES,
    GroupProgram,
    compile_group_program,
    init_packed,
)

BARE_WALK = -1  # the argument is an expression: the walk computes it
BARE_COUNT = -2  # count(*): every row of a full tile counts

THREADS = 256  # of each kernel (csrc/fused_zone.cu)
_ADD = (LEAF_COUNT, LEAF_SUM, LEAF_SUMSQ)


@dataclass(frozen=True)
class TileProgram:
    """A tile program: the leaves and bytecode (``prog``), the layout
    columns it reads in slot order (``cols``), and per aggregate the slot
    of its bare column argument (``bare``: or ``BARE_WALK``/``BARE_COUNT``)."""

    prog: GroupProgram
    cols: tuple[int, ...]
    bare: tuple[int, ...]
    partial: bool

    @property
    def all_bare(self) -> bool:
        return all(b != BARE_WALK for b in self.bare)


def compile_tile_program(sel_rpns, agg_rpns, schema, track: bool, partial: bool) -> TileProgram:
    """The full-tile (``partial`` False: no selection) or partial-tile
    program of a plan's aggregates, over the columns they reference."""
    sel = list(sel_rpns) if partial else []
    need: set[int] = set()
    for rpn in sel + [r for _op, r in agg_rpns if r is not None]:
        need |= rpn.referenced_columns()
    cols = sorted(need)
    prog = compile_group_program(sel, agg_rpns, cols, schema, (), track=track)
    bare = []
    for _op, rpn in agg_rpns:
        if rpn is None:
            bare.append(BARE_COUNT)
        elif len(rpn.nodes) == 1 and rpn.nodes[0].kind == "col":
            bare.append(cols.index(rpn.nodes[0].index))
        else:
            bare.append(BARE_WALK)
    return TileProgram(prog, tuple(cols), tuple(bare), partial)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _rows_of(layout, tiles: torch.Tensor) -> torch.Tensor:
    tr = layout.tile_rows
    lane = torch.arange(tr, dtype=torch.int64, device=tiles.device)
    return (tiles.to(torch.int64)[:, None] * tr + lane).reshape(-1)


def _tile_image(tp: TileProgram, layout, rows: torch.Tensor) -> Image:
    """The listed tiles' rows of the program's columns as one block, narrow
    lanes widened by the column load's plain version."""
    cols, nulls, descs = [], [], []
    for i in tp.cols:
        c = layout.cols[i][rows]
        cols.append(c[None])
        descs.append(("plain",) if c.element_size() == 8 else ("code", str(c.dtype)))
        nl = layout.nulls.get(i) if tp.partial else None
        nulls.append(None if nl is None else nl[rows][None])
    n = len(rows)
    return Image(cols, nulls, n, 1, n, rows.device, descs=tuple(descs),
                 refs=(0,) * len(cols))


def _tile_partials(tp: TileProgram, layout, tiles: torch.Tensor) -> torch.Tensor:
    """``[len(tiles), n_leaves]`` int64 words (f64 leaves as their bits)."""
    prog = tp.prog
    nt, tr = len(tiles), layout.tile_rows
    rows = _rows_of(layout, tiles)
    outs, active = fa.walk_rows(prog, _tile_image(tp, layout, rows), len(prog.agg_leaves))
    valid = layout.valid[rows] if tp.partial else torch.ones_like(active)
    active = active & valid
    out = torch.empty((nt, len(prog.leaves)), dtype=torch.int64, device=tiles.device)
    for l, leaf in enumerate(prog.leaves):
        k = leaf.kind
        if k == LEAF_TRACK:
            if not prog.track:
                out[:, l] = NO_ROW
            elif tp.partial:
                r = torch.where(active, layout.ridx[rows].to(torch.int64), NO_ROW)
                out[:, l] = r.reshape(nt, tr).amin(1)
            else:
                out[:, l] = layout.tile_first[tiles.to(torch.int64)]
            continue
        live, value = outs[leaf.agg]
        live = (live & valid).reshape(nt, tr)
        if k == LEAF_COUNT:
            out[:, l] = live.sum(1)
            continue
        value = value.reshape(nt, tr)
        if k == LEAF_SUM:
            out[:, l] = torch.where(live, value, 0).sum(1)
        elif k == LEAF_SUMSQ:
            x = value.to(torch.float64)
            out[:, l] = torch.where(live, x * x, 0.0).sum(1).view(torch.int64)
        elif k in (LEAF_MIN, LEAF_MAX):
            masked = torch.where(live, value, leaf.ident)
            out[:, l] = masked.amin(1) if k == LEAF_MIN else masked.amax(1)
        else:
            raise ValueError(f"leaf kind {k} has no zone tile reduction")
    return out


def zone_full_plain(tp: TileProgram, layout, tiles: torch.Tensor) -> torch.Tensor:
    """Plain version of ``zone_full``: per-leaf partials of each full tile."""
    return _tile_partials(tp, layout, tiles)


def zone_partial_plain(tp: TileProgram, layout, tiles: torch.Tensor) -> torch.Tensor:
    """Plain version of ``zone_partial``: per-leaf partials of each partial
    tile over its active rows."""
    return _tile_partials(tp, layout, tiles)


def zone_fold_plain(tp: TileProgram, parts: torch.Tensor, order: torch.Tensor,
                    starts: torch.Tensor, capacity: int):
    """Plain version of ``zone_fold``: the packed state ``(ints, flts)`` at
    ``capacity`` slots.  f64 leaves are summed in another order than the
    kernel's."""
    prog = tp.prog
    dev = parts.device
    counts = (starts[1:] - starts[:-1]).to(torch.int64)
    slot = torch.repeat_interleave(torch.arange(capacity, device=dev), counts)
    rows = parts[order.to(torch.int64)]
    ints, flts = init_packed(prog, capacity, dev)
    for l, leaf in enumerate(prog.leaves):
        v = rows[:, l].view(torch.float64) if leaf.is_f64 else rows[:, l]
        acc = (flts if leaf.is_f64 else ints)[leaf.slot]
        if leaf.kind in _ADD:
            acc.index_add_(0, slot, v)
        else:
            acc.scatter_reduce_(0, slot, v, "amax" if leaf.kind == LEAF_MAX else "amin")
    return ints, flts


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

class _ZnParams(ctypes.Structure):
    """``ZnParams`` of csrc/fused_zone.cu, passed to the kernels by value."""

    _fields_ = [
        ("col", ctypes.c_uint64 * fa.MAX_COLS),
        ("nul", ctypes.c_uint64 * fa.MAX_COLS),
        ("enc", fa._Enc),
        ("valid", ctypes.c_uint64),
        ("ridx", ctypes.c_uint64),
        ("tile_first", ctypes.c_uint64),
        ("tiles", ctypes.c_uint64),
        ("n_list", ctypes.c_int64),
        ("tile_rows", ctypes.c_int64),
        ("consts", ctypes.c_int64 * fa.MAX_CONSTS),
        ("leaf_ident", ctypes.c_int64 * MAX_LEAVES),
        ("code", ctypes.c_int32 * fa.MAX_CODE),
        ("n_code", ctypes.c_int32),
        ("n_cols", ctypes.c_int32),
        ("n_aggs", ctypes.c_int32),
        ("n_leaves", ctypes.c_int32),
        ("track", ctypes.c_int32),
        ("all_bare", ctypes.c_int32),
        ("agg_leaf0", ctypes.c_int32 * fa.MAX_AGGS),
        ("agg_nleaves", ctypes.c_int32 * fa.MAX_AGGS),
        ("bare", ctypes.c_int32 * fa.MAX_AGGS),
        ("leaf_kind", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_f64", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_slot", ctypes.c_int8 * MAX_LEAVES),
    ]


def tile_params(tp: TileProgram, layout=None, tiles: torch.Tensor | None = None) -> _ZnParams:
    """The kernels' parameter block: the program, and the layout's columns
    and the listed tiles when given."""
    prog = tp.prog
    p = _ZnParams()
    p.consts[: len(prog.consts)] = prog.consts
    p.code[: len(prog.code)] = prog.code
    p.n_code = len(prog.code)
    p.n_cols = len(tp.cols)
    p.n_aggs = len(prog.agg_leaves)
    p.n_leaves = len(prog.leaves)
    p.track = int(prog.track)
    p.all_bare = int(tp.all_bare)
    for k, own in enumerate(prog.agg_leaves):
        p.agg_leaf0[k] = own[0]
        p.agg_nleaves[k] = len(own)
        p.bare[k] = tp.bare[k]
    for l, leaf in enumerate(prog.leaves):
        p.leaf_ident[l] = leaf.ident
        p.leaf_kind[l] = leaf.kind
        p.leaf_f64[l] = int(leaf.is_f64)
        p.leaf_slot[l] = leaf.slot
    if layout is not None:
        for j, i in enumerate(tp.cols):
            c = layout.cols[i]
            p.col[j], p.enc.width[j] = c.data_ptr(), c.element_size()
            p.enc.kind[j] = fa.ENC_PLAIN if c.element_size() == 8 else fa.ENC_NARROW
            nl = layout.nulls.get(i) if tp.partial else None
            p.nul[j] = 0 if nl is None else nl.data_ptr()
        p.valid = layout.valid.data_ptr()
        p.ridx = layout.ridx.data_ptr()
        p.tile_first = layout.tile_first.data_ptr()
        p.tile_rows = layout.tile_rows
    if tiles is not None:
        p.tiles, p.n_list = tiles.data_ptr(), len(tiles)
    return p


_lib = None


def _kernels():
    """The built ``fused_zone`` library, its C signatures declared and its
    parameter block's layout checked."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_zone")
        vp = ctypes.c_void_p
        lib.zn_params_size.restype = ctypes.c_int
        lib.zn_threads.restype = ctypes.c_int
        lib.zn_launch_tiles.argtypes = [vp, ctypes.c_int, vp, vp]
        lib.zn_launch_tiles.restype = ctypes.c_int
        lib.zn_launch_fold.argtypes = [vp, vp, vp, vp, ctypes.c_int, vp, vp, vp]
        lib.zn_launch_fold.restype = ctypes.c_int
        if lib.zn_params_size() != ctypes.sizeof(_ZnParams):
            raise RuntimeError(f"ZnParams layout mismatch: kernel {lib.zn_params_size()} "
                               f"bytes, wrapper {ctypes.sizeof(_ZnParams)}")
        if lib.zn_threads() != THREADS:
            raise RuntimeError("ZN_THREADS of the kernel differs from THREADS")
        _lib = lib
    return _lib


def _check(t: torch.Tensor, dev, dtype, shape, what: str) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} {tuple(shape)} on {dev}")


def _check_layout(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor) -> None:
    dev = tiles.device
    n = layout.n_rows
    for i in tp.cols:
        c = layout.cols[i]
        if c.dtype not in (torch.int8, torch.int16, torch.int32, torch.int64, torch.float64):
            raise ValueError(f"layout column {i}: {c.dtype} is no tile lane")
        _check(c, dev, c.dtype, (n,), f"layout column {i}")
        if tp.partial and i in layout.nulls:
            _check(layout.nulls[i], dev, torch.bool, (n,), f"layout nulls {i}")
    _check(layout.valid, dev, torch.bool, (n,), "layout valid")
    _check(layout.ridx, dev, torch.int32, (n,), "layout ridx")
    _check(layout.tile_first, dev, torch.int64, (layout.n_tiles,), "layout tile_first")
    _check(tiles, dev, torch.int64, (len(tiles),), "tiles")
    _check(out, dev, torch.int64, (len(tiles), len(tp.prog.leaves)), "tile partials")


def _launch_tiles(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor,
                  name: str) -> None:
    if tiles.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {tiles.device}")
    _check_layout(tp, layout, tiles, out)
    if not len(tiles):
        return
    lib = _kernels()
    p = tile_params(tp, layout, tiles)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        rc = lib.zn_launch_tiles(ctypes.byref(p), int(tp.partial), out.data_ptr(), stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _tiles_op(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor, name: str,
              plain) -> torch.Tensor:
    if tp.partial != (name == "zone_partial"):
        raise ValueError(f"{name} takes a {'partial' if name == 'zone_partial' else 'full'}"
                         "-tile program")
    if tiles.device.type == "cpu":
        out.copy_(plain(tp, layout, tiles))
    elif tiles.device.type == "cuda":
        _launch_tiles(tp, layout, tiles, out, name)
    else:
        raise ValueError(f"no {name} for device {tiles.device}")
    return out


def zone_full(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Per-leaf partials of the full tiles ``tiles`` (int64) into ``out``
    (``[len(tiles), n_leaves]`` int64): the plain version for CPU tensors,
    the kernel for CUDA tensors."""
    return _tiles_op(tp, layout, tiles, out, "zone_full", zone_full_plain)


def zone_partial(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Per-leaf partials of the partial tiles ``tiles`` into ``out``."""
    return _tiles_op(tp, layout, tiles, out, "zone_partial", zone_partial_plain)


def launch_fold(tp: TileProgram, parts: torch.Tensor, order: torch.Tensor,
                starts: torch.Tensor, capacity: int, out) -> None:
    """Launch ``zone_fold`` into ``out`` = ``(ints [n_int, C], flts [n_f64, C])``."""
    prog = tp.prog
    dev = parts.device
    if dev.type != "cuda":
        raise ValueError(f"zone_fold needs CUDA tensors, got {dev}")
    if not 1 <= capacity < (1 << 31):
        raise ValueError(f"capacity {capacity} out of range")
    _check(parts, dev, torch.int64, (parts.shape[0], len(prog.leaves)), "tile partials")
    _check(order, dev, torch.int32, (parts.shape[0],), "fold order")
    _check(starts, dev, torch.int32, (capacity + 1,), "fold starts")
    _check(out[0], dev, torch.int64, (prog.n_int, capacity), "packed ints")
    _check(out[1], dev, torch.float64, (prog.n_f64, capacity), "packed f64")
    lib = _kernels()
    p = tile_params(tp)

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zn_launch_fold(ctypes.byref(p), ptr(parts), ptr(order), starts.data_ptr(),
                                capacity, ptr(out[0]), ptr(out[1]), stream)
    LAUNCHES["zone_fold"] += 1
    if rc != 0:
        raise RuntimeError(f"zone_fold launch failed: cudaError {rc}")


def zone_fold(tp: TileProgram, parts: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
              capacity: int):
    """The packed state ``(ints, flts)`` of the tile partials ``parts``
    folded slot by slot in ``order`` (:func:`copr.zone.fold_order`)."""
    dev = parts.device
    if dev.type == "cpu":
        return zone_fold_plain(tp, parts, order, starts, capacity)
    if dev.type != "cuda":
        raise ValueError(f"no zone_fold for device {dev}")
    prog = tp.prog
    out = (torch.empty((prog.n_int, capacity), dtype=torch.int64, device=dev),
           torch.empty((prog.n_f64, capacity), dtype=torch.float64, device=dev))
    launch_fold(tp, parts, order, starts, capacity, out)
    return out
