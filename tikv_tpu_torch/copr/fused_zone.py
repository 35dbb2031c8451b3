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
  tile with a NULL in a referenced column to the partial list).  A program
  whose every argument is a bare column or count(*) runs the instance with
  no walk (``zone_bare``), any other the tile walk.
* ``zone_partial`` does the same over the listed partial tiles, with the
  selection walked ``ROWS`` rows a thread at a time and pad rows and NULLs
  masked.  The walk's instance holds 2, 4 or 8 stack slots, picked from the
  program's depth (:func:`tile_slots`).
* ``zone_fold`` folds both lists' rows into the group slots in the
  layout's fold order (:func:`fold_order`, built once with the layout:
  every tile by slot and tile, cut into segments of ``FOLD_TILES`` tiles,
  a block each), each listed tile's row read from the map the tile kernels
  record (``row_of``), and writes the packed state that
  ``TorchDagEvaluator._finalize_agg`` reads: an int64 matrix ``[n_int, C]``
  (row 0 the tracker, ``NO_ROW`` for a group with no active row) and an f64
  matrix ``[n_f64, C]``.

Each wrapper runs its plain version for CPU tensors and its kernel of
``csrc/fused_zone.cu`` for CUDA tensors, or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
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
ROWS = 8  # rows a thread walks at once (ZN_ROWS)
#: every instance of the two tile kernels, as (partial, stack slots); slots
#: 0 is the full-tile instance with no walk
TILE_INSTANCES = ((False, 0), (False, 2), (False, 4), (False, 8), (True, 2), (True, 4),
                  (True, 8))
FOLD_TILES = 512  # tiles of a segment of the fold order, a block's (ZN_FOLD_TILES)
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


@dataclass(frozen=True)
class FoldOrder:
    """The fold order of a layout, built once with it: ``slot_tiles``
    (int32 ``[n_tiles]``) lists every tile by (slot, tile), slot ``g``'s at
    ``slot_starts[g]:slot_starts[g + 1]`` (int32 ``[C + 1]``); ``segs``
    (int32 ``[5, n_segs]``: tile lo, tile hi, slot, the slot's first
    segment, the slot's segments) cuts each slot's range into segments of
    at most ``FOLD_TILES`` tiles, one for a slot with none, that
    ``zone_fold`` folds a block each and then in order; ``counts`` holds
    its slot counters, one buffer a stream (:meth:`slot_counts`)."""

    slot_tiles: torch.Tensor
    slot_starts: torch.Tensor
    segs: torch.Tensor
    counts: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_tiles(self) -> int:
        return len(self.slot_tiles)

    def tensors(self) -> list[torch.Tensor]:
        return [self.slot_tiles, self.slot_starts, self.segs, *self.counts.values()]

    def slot_counts(self) -> torch.Tensor:
        """``zone_fold``'s slot counters for its launches on the current
        stream: int32 ``[C]``, zeroed when made, which every launch leaves
        zero (its last block of a slot sets the slot's word back), so they
        cost no launch a query.  Launches on one stream run in order, and
        each stream has its own buffer; the buffers go with the order, and
        so with the layout."""
        dev = self.slot_tiles.device
        key = torch.cuda.current_stream(dev).cuda_stream
        buf = self.counts.get(key)
        if buf is None:
            buf = self.counts[key] = torch.zeros(len(self.slot_starts) - 1, dtype=torch.int32,
                                                 device=dev)
        return buf


def fold_segments(slot_starts: np.ndarray) -> np.ndarray:
    """``[5, n_segs]`` int64: each slot's tiles ``slot_starts[g]:
    slot_starts[g + 1]`` cut in order into segments of at most
    ``FOLD_TILES`` (one empty segment for a slot with no tile), as (tile
    lo, tile hi, slot, the slot's first segment, the slot's segments)."""
    starts = np.asarray(slot_starts, dtype=np.int64)
    count = np.maximum(1, -(-np.diff(starts) // FOLD_TILES))
    slot = np.repeat(np.arange(len(count)), count)
    first = np.cumsum(count) - count
    lo = starts[:-1][slot] + (np.arange(len(slot)) - first[slot]) * FOLD_TILES
    return np.stack([lo, np.minimum(lo + FOLD_TILES, starts[1:][slot]), slot, first[slot],
                     count[slot]])


def fold_order(tile_gid: np.ndarray, n_slots: int, device) -> FoldOrder:
    """A layout's :class:`FoldOrder` from its tiles' slots, on ``device``."""
    gid = np.asarray(tile_gid, dtype=np.int64)
    starts = np.zeros(n_slots + 1, dtype=np.int64)
    np.cumsum(np.bincount(gid, minlength=n_slots), out=starts[1:])
    segs = fold_segments(starts)
    if len(gid) >= 1 << 31 or 5 * segs.shape[1] >= 1 << 31:
        raise ValueError("a fold order indexes tiles and segments in 32 bits")

    def pin(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return FoldOrder(pin(np.argsort(gid, kind="stable")), pin(starts), pin(segs))


def listed_rows(row_of: torch.Tensor, tiles: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """The rows of partials of the tiles ``at`` (int64; -1 where a tile is
    not listed): ``row_of[t]``, trusted only where ``tiles[row_of[t]]`` is
    ``t``, as ``zone_fold`` reads the map."""
    r = row_of[at].to(torch.int64)
    ok = (r >= 0) & (r < len(tiles))
    if len(tiles):
        ok &= tiles[torch.where(ok, r, 0)] == at
    return torch.where(ok, r, -1)


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


def zone_fold_plain(tp: TileProgram, parts: torch.Tensor, tiles: torch.Tensor,
                    row_of: torch.Tensor, order: FoldOrder, capacity: int):
    """Plain version of ``zone_fold``: the packed state ``(ints, flts)`` at
    ``capacity`` slots, row ``i`` of ``parts`` being listed tile
    ``tiles[i]``'s and found through ``row_of`` (:func:`listed_rows`); each
    slot's listed rows folded in ascending tile order (the kernel folds the
    same rows a segment at a time, so its f64 leaves round otherwise)."""
    prog = tp.prog
    dev = parts.device
    row = listed_rows(row_of, tiles, order.slot_tiles.to(torch.int64))
    counts = (order.slot_starts[1:] - order.slot_starts[:-1]).to(torch.int64)
    slot = torch.repeat_interleave(torch.arange(capacity, device=dev), counts)
    listed = row >= 0
    rows, slot = parts[row[listed]], slot[listed]
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
        ("row_of", ctypes.c_uint64),
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
        ("row_base", ctypes.c_int32),
        ("agg_leaf0", ctypes.c_int32 * fa.MAX_AGGS),
        ("agg_nleaves", ctypes.c_int32 * fa.MAX_AGGS),
        ("bare", ctypes.c_int32 * fa.MAX_AGGS),
        ("leaf_kind", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_f64", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_slot", ctypes.c_int8 * MAX_LEAVES),
    ]


class _ZnFold(ctypes.Structure):
    """``ZnFold`` of csrc/fused_zone.cu, ``zone_fold``'s parameter block:
    its tensors, sizes and leaf tables."""

    _fields_ = [
        ("parts", ctypes.c_uint64),
        ("tiles", ctypes.c_uint64),
        ("row_of", ctypes.c_uint64),
        ("slot_tiles", ctypes.c_uint64),
        ("segs", ctypes.c_uint64),
        ("count", ctypes.c_uint64),
        ("rows", ctypes.c_uint64),
        ("out_i", ctypes.c_uint64),
        ("out_f", ctypes.c_uint64),
        ("n_list", ctypes.c_int64),
        ("leaf_ident", ctypes.c_int64 * MAX_LEAVES),
        ("n_tiles", ctypes.c_int32),
        ("n_segs", ctypes.c_int32),
        ("capacity", ctypes.c_int32),
        ("n_leaves", ctypes.c_int32),
        ("leaf_kind", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_f64", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_slot", ctypes.c_int8 * MAX_LEAVES),
    ]


def tile_params(tp: TileProgram, layout, tiles: torch.Tensor, row_of: torch.Tensor,
                row_base: int) -> _ZnParams:
    """The kernels' parameter block: the program, the layout's columns, the
    listed tiles and the row map (tile ``tiles[i]``'s row is ``row_base +
    i``)."""
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
    # narrow lanes hold their values as they are (frame 0, NULL slots 0):
    # plain loads at the lane's width
    for j, i in enumerate(tp.cols):
        c = layout.cols[i]
        p.col[j], p.enc.width[j] = c.data_ptr(), c.element_size()
        p.enc.kind[j] = fa.ENC_PLAIN
        nl = layout.nulls.get(i) if tp.partial else None
        p.nul[j] = 0 if nl is None else nl.data_ptr()
    p.valid = layout.valid.data_ptr()
    p.ridx = layout.ridx.data_ptr()
    p.tile_first = layout.tile_first.data_ptr()
    p.tile_rows = layout.tile_rows
    p.tiles, p.n_list = tiles.data_ptr(), len(tiles)
    p.row_of, p.row_base = row_of.data_ptr(), row_base
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
        lib.zn_launch_tiles.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, vp]
        lib.zn_launch_tiles.restype = ctypes.c_int
        lib.zn_tiles_attributes.argtypes = [ctypes.c_int, ctypes.c_int, vp]
        lib.zn_tiles_attributes.restype = ctypes.c_int
        lib.zn_launch_fold.argtypes = [vp, vp]
        lib.zn_launch_fold.restype = ctypes.c_int
        lib.zn_fold_attributes.argtypes = [vp]
        lib.zn_fold_attributes.restype = ctypes.c_int
        for fn in ("zn_fold_size", "zn_fold_tiles"):
            getattr(lib, fn).restype = ctypes.c_int
        for name, kernel, wrapper in (("ZnParams", lib.zn_params_size(), ctypes.sizeof(_ZnParams)),
                                      ("ZnFold", lib.zn_fold_size(), ctypes.sizeof(_ZnFold))):
            if kernel != wrapper:
                raise RuntimeError(f"{name} layout mismatch: kernel {kernel} bytes, "
                                   f"wrapper {wrapper}")
        if lib.zn_threads() != THREADS or lib.zn_fold_tiles() != FOLD_TILES:
            raise RuntimeError("ZN_THREADS or ZN_FOLD_TILES of the kernel differs from the "
                               "wrapper's")
        _lib = lib
    return _lib


def _check(t: torch.Tensor, dev, dtype, shape, what: str) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} {tuple(shape)} on {dev}")


def tile_slots(tp: TileProgram) -> int:
    """The instance of ``zone_full`` or ``zone_partial`` that runs ``tp``:
    0 (no walk) for a full-tile program whose every argument is a bare
    column or count(*), else the stack slots of the walk,
    ``fa.stack_slots`` of its code (2, 4 or 8); ``ValueError`` for a deeper
    plan."""
    if not tp.partial and tp.all_bare:
        return 0
    name = "zone_partial" if tp.partial else "zone_full"
    try:
        return fa.stack_slots([tp.prog.code])
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def tiles_attributes(partial: bool, slots: int) -> dict:
    """``cudaFuncGetAttributes`` of the tile kernels' instance ``(partial,
    slots)`` of :data:`TILE_INSTANCES`: registers a thread, local (spilled)
    bytes a thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = _kernels().zn_tiles_attributes(int(partial), slots, out)
    if rc != 0:
        raise RuntimeError(f"zone tile instance {(partial, slots)} attributes: cudaError {rc}")
    name = "zone_partial" if partial else "zone_full"
    return {"kernel": name, "stackSlots": slots, "numRegs": out[0], "localSizeBytes": out[1],
            "sharedSizeBytes": out[2]}


def _check_layout(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor,
                  row_of: torch.Tensor) -> None:
    dev = tiles.device
    n = layout.n_rows
    if not 1 <= layout.tile_rows < (1 << 31):
        raise ValueError(f"tile_rows {layout.tile_rows} out of range")
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
    _check(row_of, dev, torch.int32, (layout.n_tiles,), "row map")


def _launch_tiles(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor,
                  name: str, row_of: torch.Tensor, row_base: int) -> None:
    if tiles.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {tiles.device}")
    _check_layout(tp, layout, tiles, out, row_of)
    if not len(tiles):
        return
    slots = tile_slots(tp)
    lib = _kernels()
    p = tile_params(tp, layout, tiles, row_of, row_base)
    with torch.cuda.device(tiles.device):
        stream = torch.cuda.current_stream(tiles.device).cuda_stream
        rc = lib.zn_launch_tiles(ctypes.byref(p), int(tp.partial), slots, out.data_ptr(),
                                 stream)
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _tiles_op(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor, name: str,
              plain, row_of: torch.Tensor, row_base: int) -> torch.Tensor:
    if tp.partial != (name == "zone_partial"):
        raise ValueError(f"{name} takes a {'partial' if name == 'zone_partial' else 'full'}"
                         "-tile program")
    if not 0 <= row_base < (1 << 31) - len(tiles):
        raise ValueError(f"row_base {row_base} out of range")
    if tiles.device.type == "cpu":
        _check_layout(tp, layout, tiles, out, row_of)
        out.copy_(plain(tp, layout, tiles))
        row_of[tiles] = torch.arange(row_base, row_base + len(tiles), dtype=torch.int32)
    elif tiles.device.type == "cuda":
        _launch_tiles(tp, layout, tiles, out, name, row_of, row_base)
    else:
        raise ValueError(f"no {name} for device {tiles.device}")
    return out


def zone_full(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor,
              row_of: torch.Tensor, row_base: int) -> torch.Tensor:
    """Per-leaf partials of the full tiles ``tiles`` (int64) into ``out``
    (``[len(tiles), n_leaves]`` int64), and tile ``tiles[i]``'s row of
    partials, ``row_base + i``, into the row map ``row_of`` (int32
    ``[n_tiles]``) that ``zone_fold`` reads: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    return _tiles_op(tp, layout, tiles, out, "zone_full", zone_full_plain, row_of, row_base)


def zone_partial(tp: TileProgram, layout, tiles: torch.Tensor, out: torch.Tensor,
                 row_of: torch.Tensor, row_base: int) -> torch.Tensor:
    """Per-leaf partials of the partial tiles ``tiles`` into ``out``, and
    their rows into ``row_of`` as :func:`zone_full` records them."""
    return _tiles_op(tp, layout, tiles, out, "zone_partial", zone_partial_plain, row_of,
                     row_base)


def fold_attributes() -> dict:
    """``cudaFuncGetAttributes`` of ``zone_fold``: registers a thread,
    local (spilled) bytes a thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = _kernels().zn_fold_attributes(out)
    if rc != 0:
        raise RuntimeError(f"zone_fold attributes: cudaError {rc}")
    return {"kernel": "zone_fold", "numRegs": out[0], "localSizeBytes": out[1],
            "sharedSizeBytes": out[2]}


def launch_fold(tp: TileProgram, parts: torch.Tensor, tiles: torch.Tensor, row_of: torch.Tensor,
                order: FoldOrder, capacity: int, out) -> None:
    """Launch ``zone_fold`` into ``out`` = ``(ints [n_int, C], flts [n_f64,
    C])``: row ``i`` of ``parts`` is listed tile ``tiles[i]``'s (each tile
    listed at most once), and ``row_of[tiles[i]] == i`` (the tile kernels
    record it; the map's other words may hold anything)."""
    prog = tp.prog
    dev = parts.device
    if dev.type != "cuda":
        raise ValueError(f"zone_fold needs CUDA tensors, got {dev}")
    if not 1 <= capacity < (1 << 31) or len(order.slot_starts) != capacity + 1:
        raise ValueError(f"capacity {capacity} out of range or not the fold order's")
    L = len(prog.leaves)
    n_segs = order.segs.shape[1]
    _check(parts, dev, torch.int64, (parts.shape[0], L), "tile partials")
    if parts.data_ptr() % 16:
        raise ValueError("tile partials: need 16-byte aligned rows")  # read two words a load
    _check(tiles, dev, torch.int64, (parts.shape[0],), "listed tiles")
    _check(row_of, dev, torch.int32, (order.n_tiles,), "row map")
    _check(order.slot_tiles, dev, torch.int32, (order.n_tiles,), "slot tiles")
    _check(order.segs, dev, torch.int32, (5, n_segs), "fold segments")
    _check(out[0], dev, torch.int64, (prog.n_int, capacity), "packed ints")
    _check(out[1], dev, torch.float64, (prog.n_f64, capacity), "packed f64")
    lib = _kernels()
    rows = torch.empty((n_segs, L), dtype=torch.int64, device=dev)

    def ptr(t):
        return t.data_ptr() if t.numel() else 0

    f = _ZnFold(parts=ptr(parts), tiles=ptr(tiles), row_of=ptr(row_of),
                slot_tiles=ptr(order.slot_tiles), segs=order.segs.data_ptr(),
                count=order.slot_counts().data_ptr(), rows=rows.data_ptr(),
                out_i=ptr(out[0]), out_f=ptr(out[1]), n_list=len(tiles), n_tiles=order.n_tiles,
                n_segs=n_segs, capacity=capacity, n_leaves=L)
    for l, leaf in enumerate(prog.leaves):
        f.leaf_ident[l] = leaf.ident
        f.leaf_kind[l] = leaf.kind
        f.leaf_f64[l] = int(leaf.is_f64)
        f.leaf_slot[l] = leaf.slot
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.zn_launch_fold(ctypes.byref(f), stream)
    LAUNCHES["zone_fold"] += 1
    if rc != 0:
        raise RuntimeError(f"zone_fold launch failed: cudaError {rc}")


def zone_fold(tp: TileProgram, parts: torch.Tensor, tiles: torch.Tensor, row_of: torch.Tensor,
              order: FoldOrder, capacity: int):
    """The packed state ``(ints, flts)`` of the tile partials ``parts`` (row
    ``i`` listed tile ``tiles[i]``'s, recorded in ``row_of``) folded slot by
    slot in the layout's fold order: the plain version for CPU tensors, the
    kernel for CUDA tensors."""
    dev = parts.device
    if dev.type == "cpu":
        return zone_fold_plain(tp, parts, tiles, row_of, order, capacity)
    if dev.type != "cuda":
        raise ValueError(f"no zone_fold for device {dev}")
    prog = tp.prog
    out = (torch.empty((prog.n_int, capacity), dtype=torch.int64, device=dev),
           torch.empty((prog.n_f64, capacity), dtype=torch.float64, device=dev))
    launch_fold(tp, parts, tiles, row_of, order, capacity, out)
    return out
