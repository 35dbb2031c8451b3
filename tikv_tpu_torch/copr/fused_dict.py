"""The group dictionary built on the devices: key program, plain versions, CUDA launchers.

It replaces the dictionary half of the JAX package's program
``mesh.grouped_step`` (``parallel/mesh.py:ShardedGroupedEvaluator._build_step``)
with three kernels of ``csrc/fused_dict.cu``:

* ``dict_keys`` (``mesh.py:366-377``): the selection and the group
  expressions per row through the bytecode walk (``compile_key_program``:
  :func:`fused_agg.emit_program` with the conjuncts, then one OP_KEY per
  group expression), each value packed into one int64 key, ``key = (key <<
  key_bits) | (lane & lane_max)`` with ``lane_max = 2^key_bits - 1``; a
  NULL packs as ``lane_max``, a REAL value truncates toward zero, an active
  non-NULL value outside ``[0, lane_max)`` sets :data:`FLAG_RANGE`, an
  inactive row (selection false, or past ``n_valid``) is :data:`SENTINEL`.
  A thread walks :data:`KEY_ROWS` rows of a block on the tile walk, in the
  instance of :func:`key_slots` stack slots.
* ``dict_union`` (``:378-406``): the ``cap`` smallest distinct non-sentinel
  keys of (sorted dictionary ++ keys), sorted and padded with the
  sentinel; :data:`FLAG_CAPACITY` when there are more.  Up to
  :data:`CAP_MAX` slots it runs in passes: each tile of ``union_tile(cap)``
  keys keeps its first ``cap`` distinct keys, and the tiles' lists are the
  next pass's keys, until one tile is left (``csrc/fused_dict.cu`` says why
  that is exact).  Past it, the *sort route*: one ``dict_union`` pass sorts
  every tile of :data:`SORT_TILE` keys, ``dict_merge`` levels merge up to
  :data:`MERGE_FAN_MAX` sorted runs into one each (:func:`merge_plan`: two
  levels up to 64 runs), and ``dict_compact`` keeps the first ``cap``
  distinct keys and flags more, in one pass (a tile's offset by a decoupled
  look-back over the tiles before it, in :func:`compact_scratch`).  A
  block sorts its tile with :data:`KEYS_A_THREAD` keys a thread: in
  registers, then across its warp, then by merge path in shared memory.
* ``dict_ids`` (``:407-417``): ``clip(searchsorted(dict, key), 0, cap -
  1)`` per row into an image's ``gids`` lane; with the old dictionary,
  ``perm`` (``searchsorted(new_dict, old_key)``, ``cap`` for a sentinel
  slot) in the same launch, its slots spread over the grid beside the keys.
  A key a thread searches a shared-memory table: the dictionary itself up
  to :data:`CAP_MAX` slots, past it every stride-th key (at most 256), then
  halves in device memory.

Each has a plain PyTorch version here, which the wrappers take for CPU
tensors; on a CUDA tensor a wrapper launches its kernel or raises.  The
flag is an int32 ``[1]`` tensor the kernels OR their bits into, so it stays
on the device until the caller reads it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import fused_agg as fa
from .datatypes import EvalType
from .fused_agg import (
    LAUNCHES,
    MAX_CODE,
    MAX_COLS,
    MAX_CONSTS,
    Image,
    _Enc,
    check_columns,
    emit_keys,
    emit_program,
    set_columns,
    walk_rows,
)

SENTINEL = 1 << 62  # an empty dictionary slot; sorts after every key
KEY_ROWS = 4  # rows a dict_keys thread walks at once (DK_ROWS)
FLAG_RANGE = 1  # a group value outside [0, lane_max)
FLAG_CAPACITY = 2  # more distinct keys than the dictionary's slots
KEYS_A_THREAD = 16  # keys a dict_union thread sorts in registers (DU_E)
TILE_MIN = 1024  # the tile route's smallest tile
TILE_MAX = 16384  # the largest tile: 1,024 threads, 136 KB of shared memory
CAP_MAX = TILE_MAX // 2  # the tile route's largest dictionary; past it, the sort route
SORT_TILE = 4096  # the sort route's tile (DU_SORT_TILE)
COMPACT_TILE = 2048  # sorted keys a dict_compact block reads (DC_TILE)
MERGE_CHUNK = 2048  # keys of one run a dict_merge block places (DM_CHUNK)
MERGE_FAN_MAX = 8  # runs a dict_merge level merges into one (DM_FAN_MAX)
_I64_MIN = -(1 << 63)


@dataclass(frozen=True)
class KeyProgram:
    code: tuple[int, ...]
    consts: tuple[int, ...]
    col_f64: tuple[bool, ...]  # per shipped column slot
    key_f64: tuple[bool, ...]  # per group expression: its value lane is f64
    key_bits: int

    @property
    def lane_max(self) -> int:
        return (1 << self.key_bits) - 1


def compile_key_program(sel_rpns, key_rpns, ship_cols, schema, key_bits: int) -> KeyProgram:
    """The conjuncts ``sel_rpns``, then one OP_KEY per group expression of
    ``key_rpns``, over the shipped columns ``ship_cols`` (schema indices,
    in slot order).  ``ValueError`` when the keys do not pack into 62 bits."""
    if key_bits < 0 or len(key_rpns) * key_bits > 62:
        raise ValueError(f"{len(key_rpns)} group keys x {key_bits} bits "
                         "overflow the packed int64 key")
    em, _ = emit_program(sel_rpns, [], ship_cols, schema)
    key_f64 = emit_keys(em, key_rpns)
    col_f64 = tuple(schema[c][0] == EvalType.REAL for c in ship_cols)
    return KeyProgram(tuple(em.code), tuple(em.consts), col_f64, tuple(key_f64), key_bits)


def key_slots(prog: KeyProgram) -> int:
    """The stack slots of the ``dict_keys`` instance that runs ``prog``
    (2, 4 or 8: the fewest that hold its plan, which the C launcher also
    reads from the code); ``ValueError`` for a deeper plan."""
    try:
        return fa.stack_slots([prog.code])
    except ValueError as e:
        raise ValueError(f"dict_keys: {e}") from None


def check_capacity(cap: int) -> None:
    """``ValueError`` for a dictionary size outside ``[1, 2^31)``."""
    if not 1 <= cap < (1 << 31):
        raise ValueError(f"a group dictionary of {cap} slots")


def union_tile(cap: int) -> int:
    """Keys a ``dict_union`` block of the tile route sorts: a power of two,
    at least ``TILE_MIN`` and twice ``cap``, so that each pass halves the
    keys.  ``ValueError`` past :data:`CAP_MAX` (the sort route's)."""
    check_capacity(cap)
    if cap > CAP_MAX:
        raise ValueError(f"{cap} slots take the sort route, not a union tile")
    tile = TILE_MIN
    while tile < 2 * cap:
        tile *= 2
    return tile


def union_passes(n: int, cap: int) -> list[int]:
    """The keys each ``dict_union`` pass of the tile route reads for ``n``
    keys at ``cap`` slots (one launch a pass)."""
    tile = union_tile(cap)
    out = [n]
    while n > tile:
        n = -(-n // tile) * cap
        out.append(n)
    return out


def sorted_keys(n: int) -> int:
    """Keys the sort route's tiles of :data:`SORT_TILE` hold for ``n`` keys
    (the last tile padded)."""
    return max(1, -(-n // SORT_TILE)) * SORT_TILE


def fan_ins(runs: int, fan_max: int) -> list[int]:
    """The fan-in of each level that merges ``runs`` sorted runs into one,
    at most ``fan_max`` runs a group: the fewest levels, and in them fan-ins
    as even as they go (each the least ``f`` with ``f ** levels_left`` at
    least the runs left)."""
    levels, reach = 0, 1
    while reach < runs:
        levels, reach = levels + 1, reach * fan_max
    out = []
    while runs > 1:
        f = 2
        while f ** levels < runs:
            f += 1
        out.append(f)
        runs, levels = -(-runs // f), levels - 1
    return out


def merge_plan(n: int) -> list[tuple[int, int]]:
    """The sort route's ``dict_merge`` levels for ``n`` keys: per level (one
    launch) the width of the runs it reads and how many it merges into one.
    The fewest levels; the first merges :data:`MERGE_FAN_MAX` runs where
    that keeps them fewest (the tiles' windows are the smallest, and a
    dictionary's tiles, in order already, are copied), the rest as even as
    they go."""
    runs = sorted_keys(n) // SORT_TILE
    fans = fan_ins(runs, MERGE_FAN_MAX)
    if len(fans) > 1:
        fans = [MERGE_FAN_MAX] + fan_ins(-(-runs // MERGE_FAN_MAX), MERGE_FAN_MAX)
    out, w = [], SORT_TILE
    for f in fans:
        out.append((w, f))
        w *= f
    return out


def union_launches(n: int, cap: int) -> dict:
    """Launches of each kernel of one :func:`dict_union` of ``n`` keys."""
    if cap <= CAP_MAX:
        return {"dict_union": len(union_passes(n, cap))}
    return {"dict_union": 1, "dict_merge": len(merge_plan(n)), "dict_compact": 1}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _truncate(v: torch.Tensor) -> torch.Tensor:
    """f64 to int64 as numpy's ``astype(int64)`` on x86: toward zero,
    INT64_MIN for NaN and outside the int64 range."""
    ok = (v >= -2.0 ** 63) & (v < 2.0 ** 63)
    return torch.where(ok, torch.where(ok, v, 0.0).to(torch.int64), _I64_MIN)


def dict_keys_plain(prog: KeyProgram, img: Image) -> tuple[torch.Tensor, bool]:
    """Plain version of ``dict_keys``: int64 keys ``[n_blocks * block_rows]``
    and whether an active row's value fell outside ``[0, lane_max)``."""
    vals: list = [None] * len(prog.key_f64)
    _outs, active = walk_rows(prog, img, 0, vals)
    lane_max = prog.lane_max
    key = torch.zeros_like(active, dtype=torch.int64)
    bad = torch.zeros_like(active)
    for (v, nl), is_f in zip(vals, prog.key_f64):
        v, nl = v.reshape(-1), nl.reshape(-1)
        if is_f:
            v = _truncate(v)
        bad |= ~nl & ((v < 0) | (v >= lane_max))
        key = (key << prog.key_bits) | (torch.where(nl, lane_max, v) & lane_max)
    return torch.where(active, key, SENTINEL), bool((active & bad).any())


def union_pass_plain(keys: torch.Tensor, cap: int, tile: int) -> tuple[torch.Tensor, bool]:
    """One pass of ``dict_union``: per tile of ``tile`` keys (the last one
    padded with the sentinel), its first ``cap`` distinct non-sentinel keys
    sorted and padded, ``[tiles, cap]``; and whether a tile held more."""
    n = keys.numel()
    tiles = max(1, -(-n // tile))
    pad = torch.full((tiles * tile - n,), SENTINEL, dtype=torch.int64, device=keys.device)
    s = torch.sort(torch.cat([keys, pad]).view(tiles, tile), dim=1).values
    first = torch.ones((tiles, 1), dtype=torch.bool, device=keys.device)
    fresh = (s < SENTINEL) & torch.cat([first, s[:, 1:] != s[:, :-1]], dim=1)
    rank = torch.cumsum(fresh, dim=1) - 1
    out = torch.full((tiles, cap), SENTINEL, dtype=torch.int64, device=keys.device)
    rows, cols = torch.nonzero(fresh & (rank < cap), as_tuple=True)
    out[rows, rank[rows, cols]] = s[rows, cols]
    return out, bool((fresh.sum(dim=1) > cap).any())


def merge_pass_plain(keys: torch.Tensor, width: int, fan_in: int) -> torch.Tensor:
    """Plain version of ``dict_merge``: the sorted runs of ``width`` keys
    (the last may be short) merged ``fan_in`` at a time (equal keys are equal
    words, so a sort of each group is its stable merge)."""
    n = keys.numel()
    out = keys.clone()
    for a0 in range(0, n, fan_in * width):
        group = keys[a0 : a0 + fan_in * width]
        out[a0 : a0 + group.numel()] = torch.sort(group).values
    return out


def compact_plain(s: torch.Tensor, cap: int) -> tuple[torch.Tensor, bool]:
    """Plain version of ``dict_compact``: the first ``cap``
    distinct non-sentinel keys of the sorted ``s``, padded with the
    sentinel, and whether there are more."""
    fresh = s < SENTINEL
    fresh[1:] &= s[1:] != s[:-1]
    keys = s[fresh]
    out = torch.full((cap,), SENTINEL, dtype=torch.int64, device=s.device)
    out[: min(cap, keys.numel())] = keys[:cap]
    return out, keys.numel() > cap


def dict_union_plain(dict_keys: torch.Tensor | None, keys: torch.Tensor, cap: int,
                     tile: int | None = None) -> tuple[torch.Tensor, bool]:
    """Plain version of ``dict_union``, pass by pass as the kernels run:
    ``[cap]`` and whether there are more than ``cap`` distinct keys.  The
    tile route (tiles of ``union_tile(cap)`` keys, or ``tile``, at least
    ``2 * cap``), or past :data:`CAP_MAX` slots with no ``tile``, the sort
    route: tiles of :data:`SORT_TILE` keys sorted, merged level by level
    (:func:`merge_plan`), then compacted."""
    x = keys if dict_keys is None else torch.cat([dict_keys, keys])
    if tile is None and cap > CAP_MAX:
        s = union_pass_plain(x, SORT_TILE, SORT_TILE)[0].reshape(-1)
        for w, f in merge_plan(x.numel()):
            s = merge_pass_plain(s, w, f)
        return compact_plain(s, cap)
    tile = union_tile(cap) if tile is None else tile
    if tile < 2 * cap:
        raise ValueError(f"a union tile of {tile} keys cannot halve {cap}-key lists")
    over = False
    while True:
        out, o = union_pass_plain(x, cap, tile)
        over = over or o
        if out.shape[0] == 1:
            return out[0], over
        x = out.reshape(-1)


def dict_ids_plain(new_dict: torch.Tensor, keys: torch.Tensor, old: torch.Tensor | None = None):
    """Plain version of ``dict_ids``: int32 ids ``clip(searchsorted(new_dict,
    keys), 0, cap - 1)``, and with ``old`` the int32 ``perm`` of its slots
    (``cap`` for a sentinel slot), else None."""
    cap = new_dict.numel()
    ids = torch.searchsorted(new_dict, keys).clamp(0, cap - 1).to(torch.int32)
    if old is None:
        return ids, None
    perm = torch.where(old < SENTINEL, torch.searchsorted(new_dict, old), cap)
    return ids, perm.to(torch.int32)


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

class _DkParams(ctypes.Structure):
    """``DkParams`` of csrc/fused_dict.cu, passed to the kernel by value."""

    _fields_ = [
        ("col", ctypes.c_uint64 * MAX_COLS),
        ("nul", ctypes.c_uint64 * MAX_COLS),
        ("enc", _Enc),
        ("n_valids", ctypes.c_uint64),
        ("keys", ctypes.c_uint64),
        ("flag", ctypes.c_uint64),
        ("n_valid_all", ctypes.c_int64),
        ("n_blocks", ctypes.c_int64),
        ("block_rows", ctypes.c_int64),
        ("key_f64", ctypes.c_uint64),
        ("consts", ctypes.c_int64 * MAX_CONSTS),
        ("code", ctypes.c_int32 * MAX_CODE),
        ("n_code", ctypes.c_int32),
        ("n_cols", ctypes.c_int32),
        ("key_bits", ctypes.c_int32),
    ]


_lib = None


def kernels():
    """The built ``fused_dict`` library, its C signatures declared and its
    parameter block's layout and limits checked."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_dict")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dk_params_size.restype = ci
        lib.du_tile_max.restype = ci
        lib.du_attributes.argtypes = [vp]
        lib.dk_sentinel.restype = cll
        lib.dk_launch.argtypes = [vp, vp]
        lib.dk_slots.argtypes = [vp]
        lib.dk_attributes.argtypes = [ci, vp]
        lib.du_launch.argtypes = [vp, cll, vp, cll, vp, vp, ci, ci, vp, vp]
        lib.di_launch.argtypes = [vp, ci, vp, cll, vp, vp, vp, vp]
        lib.dm_launch.argtypes = [vp, cll, cll, ci, vp, vp, vp]
        lib.dm_attributes.argtypes = [vp]
        lib.dc_launch_compact.argtypes = [vp, cll, vp, vp, ci, vp, vp]
        lib.dc_attributes.argtypes = [vp]
        lib.di_table_stride.argtypes = [ci]
        lib.di_attributes.argtypes = [ci, vp]
        for fn in ("dk_launch", "dk_slots", "dk_attributes", "dk_rows", "du_launch",
                   "di_launch", "dm_launch", "dc_launch_compact", "dc_tile", "dc_attributes",
                   "di_smem_keys", "du_sort_tile", "du_attributes", "di_table_stride",
                   "di_attributes", "dm_attributes", "dm_chunk", "dm_fan_max"):
            getattr(lib, fn).restype = ci
        if lib.dk_params_size() != ctypes.sizeof(_DkParams):
            raise RuntimeError(f"DkParams layout mismatch: kernel {lib.dk_params_size()} bytes, "
                               f"wrapper {ctypes.sizeof(_DkParams)}")
        if lib.du_tile_max() != TILE_MAX or lib.dk_sentinel() != SENTINEL \
                or lib.dk_rows() != KEY_ROWS \
                or lib.dc_tile() != COMPACT_TILE or lib.di_smem_keys() != CAP_MAX \
                or lib.du_sort_tile() != SORT_TILE or lib.dm_chunk() != MERGE_CHUNK \
                or lib.dm_fan_max() != MERGE_FAN_MAX:
            raise RuntimeError("fused_dict.cu's limits differ from the wrapper's")
        _lib = lib
    return _lib


def _check(t: torch.Tensor, dtype, shape, dev, what: str) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} {tuple(shape)} on {dev}")


def _launched(name: str, rc: int) -> None:
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def key_params(prog: KeyProgram, img: Image, out: torch.Tensor, flag: torch.Tensor):
    """``dict_keys``' parameter block for ``prog`` over ``img`` into
    ``out``, ORing into ``flag``."""
    p = _DkParams()
    set_columns(p, img)
    if isinstance(img.n_valids, int):
        p.n_valids, p.n_valid_all = 0, img.n_valids
    else:
        p.n_valids = img.n_valids.data_ptr()
    p.keys, p.flag = out.data_ptr(), flag.data_ptr()
    p.n_blocks, p.block_rows = img.n_blocks, img.block_rows
    p.key_f64 = sum(int(f) << q for q, f in enumerate(prog.key_f64))
    p.consts[: len(prog.consts)] = prog.consts
    p.code[: len(prog.code)] = prog.code
    p.n_code, p.n_cols, p.key_bits = len(prog.code), len(prog.col_f64), prog.key_bits
    return p


def keys_attributes(slots: int) -> dict:
    """``cudaFuncGetAttributes`` of the ``dict_keys`` instance of ``slots``
    stack slots (2, 4 or 8): registers a thread, local (spilled) bytes a
    thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = kernels().dk_attributes(slots, out)
    if rc != 0:
        raise RuntimeError(f"dict_keys attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2],
            "stackSlots": slots}


def launch_keys(prog: KeyProgram, img: Image, out: torch.Tensor, flag: torch.Tensor) -> None:
    """Launch ``dict_keys`` into ``out`` (int64 ``[n_blocks * block_rows]``),
    ORing :data:`FLAG_RANGE` into ``flag`` (int32 ``[1]``); ``ValueError``
    for a plan deeper than the tile walk's stack."""
    key_slots(prog)
    check_columns(prog.col_f64, img)
    dev = img.device
    _check(out, torch.int64, (img.n_blocks * img.block_rows,), dev, "keys")
    _check(flag, torch.int32, (1,), dev, "flag")
    p = key_params(prog, img, out, flag)
    lib = kernels()
    with torch.cuda.device(dev):
        rc = lib.dk_launch(ctypes.byref(p), _stream(dev))
    _launched("dict_keys", rc)


def launch_union(dict_keys: torch.Tensor | None, keys: torch.Tensor, cap: int,
                 flag: torch.Tensor, out: torch.Tensor) -> None:
    """Launch ``dict_union`` pass by pass into ``out`` (int64 ``[cap]``),
    ORing :data:`FLAG_CAPACITY` into ``flag``, or past :data:`CAP_MAX`
    slots the sort route's kernels; the passes' keys live in scratch
    tensors allocated here."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"dict_union needs CUDA tensors, got {dev}")
    _check(keys, torch.int64, (keys.numel(),), dev, "keys")
    if dict_keys is not None:
        _check(dict_keys, torch.int64, (cap,), dev, "dictionary")
    _check(flag, torch.int32, (1,), dev, "flag")
    _check(out, torch.int64, (cap,), dev, "union")
    lib = kernels()
    d, n_d = dict_keys, 0 if dict_keys is None else cap
    x = keys
    if cap > CAP_MAX:
        _sort_union(lib, d, n_d, x, cap, flag, out)
        return
    tile = union_tile(cap)
    with torch.cuda.device(dev):
        while True:
            n = n_d + x.numel()
            tiles = max(1, -(-n // tile))
            dst = out if tiles == 1 else torch.empty(tiles * cap, dtype=torch.int64, device=dev)
            rc = lib.du_launch(None if d is None else d.data_ptr(), n_d, x.data_ptr(), x.numel(),
                               dst.data_ptr(), flag.data_ptr(), cap, tile, None, _stream(dev))
            _launched("dict_union", rc)
            if tiles == 1:
                return
            d, n_d, x = None, 0, dst


def _sort_union(lib, d, n_d: int, x: torch.Tensor, cap: int, flag: torch.Tensor,
                out: torch.Tensor) -> None:
    """The sort route of :func:`launch_union`: ``dict_union`` at ``cap = T =
    SORT_TILE`` sorts every tile (and counts each tile's live keys),
    ``dict_merge`` levels (:func:`merge_plan`) merge the runs in two scratch
    buffers, ``dict_compact`` writes ``out``."""
    dev = x.device
    n = n_d + x.numel()
    sorted_n = sorted_keys(n)
    src = torch.empty(sorted_n, dtype=torch.int64, device=dev)
    live = torch.empty(sorted_n // SORT_TILE, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        rc = lib.du_launch(None if d is None else d.data_ptr(), n_d, x.data_ptr(), x.numel(),
                           src.data_ptr(), flag.data_ptr(), SORT_TILE, SORT_TILE,
                           live.data_ptr(), stream)
        _launched("dict_union", rc)
        plan = merge_plan(n)
        if plan:
            dst = torch.empty_like(src)
            for w, f in plan:
                _launched("dict_merge", lib.dm_launch(src.data_ptr(), sorted_n, w, f,
                                                      live.data_ptr(), dst.data_ptr(), stream))
                src, dst = dst, src
        scratch = compact_scratch(dev, sorted_n)
        _launched("dict_compact", lib.dc_launch_compact(src.data_ptr(), sorted_n, out.data_ptr(),
                                                        flag.data_ptr(), cap, scratch.data_ptr(),
                                                        stream))


_compact_scratch: dict = {}


def compact_tiles(n: int) -> int:
    """Blocks of a ``dict_compact`` launch over ``n`` sorted keys (at least
    one, which writes the padding)."""
    return max(1, -(-n // COMPACT_TILE))


def compact_scratch(dev, n: int) -> torch.Tensor:
    """``dict_compact``'s scratch on ``dev`` for ``n`` sorted keys launched
    on the current stream: int64 words (a ticket, the blocks done, a status
    word a tile) that are zero before a launch and that the launch leaves
    zero, so they cost no launch of their own.  One buffer a device and
    stream (launches on one stream run in order), zeroed when it is made or
    grown."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    words = 2 + compact_tiles(n)
    buf = _compact_scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 2 + compact_tiles(1 << 18)), dtype=torch.int64, device=dev)
        _compact_scratch[key] = buf
    return buf


def compact_attributes() -> dict:
    """``cudaFuncGetAttributes`` of ``dict_compact``: registers a thread,
    local (spilled) bytes a thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = kernels().dc_attributes(out)
    if rc != 0:
        raise RuntimeError(f"dict_compact attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2]}


def union_attributes() -> dict:
    """``cudaFuncGetAttributes`` of ``dict_union``: registers a thread,
    local (spilled) bytes a thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = kernels().du_attributes(out)
    if rc != 0:
        raise RuntimeError(f"dict_union attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2]}


def merge_attributes() -> dict:
    """``cudaFuncGetAttributes`` of ``dict_merge``: registers a thread,
    local (spilled) bytes a thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = kernels().dm_attributes(out)
    if rc != 0:
        raise RuntimeError(f"dict_merge attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2]}


def ids_attributes(cap: int) -> dict:
    """``cudaFuncGetAttributes`` of the ``dict_ids`` instance that runs at
    ``cap`` slots (past :data:`CAP_MAX` the one with the device-memory
    tail): registers a thread, local (spilled) bytes a thread, static shared
    bytes a block, with the stride of its shared table (1: the whole
    dictionary)."""
    check_capacity(cap)
    lib = kernels()
    out = (ctypes.c_int * 3)()
    rc = lib.di_attributes(cap, out)
    if rc != 0:
        raise RuntimeError(f"dict_ids attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2],
            "tableStride": lib.di_table_stride(cap)}


def launch_ids(new_dict: torch.Tensor, keys: torch.Tensor, gids: torch.Tensor,
               old: torch.Tensor | None = None, perm: torch.Tensor | None = None) -> None:
    """Launch ``dict_ids``: int32 ``gids`` (``keys``' shape) and, with the
    old dictionary ``old``, int32 ``perm`` ``[cap]``."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"dict_ids needs CUDA tensors, got {dev}")
    cap = new_dict.numel()
    check_capacity(cap)
    _check(new_dict, torch.int64, (cap,), dev, "dictionary")
    _check(keys, torch.int64, (keys.numel(),), dev, "keys")
    _check(gids, torch.int32, (keys.numel(),), dev, "gids")
    if (old is None) != (perm is None):
        raise ValueError("dict_ids: the old dictionary and perm come together")
    if old is not None:
        _check(old, torch.int64, (cap,), dev, "old dictionary")
        _check(perm, torch.int32, (cap,), dev, "perm")
    lib = kernels()
    with torch.cuda.device(dev):
        rc = lib.di_launch(new_dict.data_ptr(), cap, keys.data_ptr(), keys.numel(),
                           gids.data_ptr(), None if old is None else old.data_ptr(),
                           None if perm is None else perm.data_ptr(), _stream(dev))
    _launched("dict_ids", rc)


# ---------------------------------------------------------------------------
# The wrappers: plain version for CPU tensors, the kernel for CUDA tensors
# ---------------------------------------------------------------------------

def _device(t: torch.Tensor, what: str):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {t.device}")
    return t.device


def dict_keys(prog: KeyProgram, img: Image, flag: torch.Tensor) -> torch.Tensor:
    """The image's packed keys, int64 ``[n_blocks * block_rows]``;
    :data:`FLAG_RANGE` ORed into ``flag`` (int32 ``[1]`` on the image's
    device) when a value falls outside its lane.  ``ValueError`` for a plan
    deeper than the kernel's stack (:func:`key_slots`), on either device."""
    dev = img.device
    if dev.type == "cpu":
        key_slots(prog)  # the card's limit holds here too
        keys, bad = dict_keys_plain(prog, img)
        if bad:
            flag |= FLAG_RANGE
        return keys
    if dev.type != "cuda":
        raise ValueError(f"no dict_keys for device {dev}")
    out = torch.empty(img.n_blocks * img.block_rows, dtype=torch.int64, device=dev)
    launch_keys(prog, img, out, flag)
    return out


def dict_union(dict_keys: torch.Tensor | None, keys: torch.Tensor, cap: int,
               flag: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The ``cap`` smallest distinct non-sentinel keys of ``dict_keys``
    (a sorted dictionary ``[cap]``, or None) and ``keys``, sorted and padded
    with :data:`SENTINEL`, in ``out`` (allocated when None);
    :data:`FLAG_CAPACITY` ORed into ``flag`` when there are more."""
    dev = _device(keys, "dict_union")
    if out is None:
        out = torch.empty(cap, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        res, over = dict_union_plain(dict_keys, keys, cap)
        out.copy_(res)
        if over:
            flag |= FLAG_CAPACITY
        return out
    launch_union(dict_keys, keys, cap, flag, out)
    return out


def dict_ids(new_dict: torch.Tensor, keys: torch.Tensor, gids: torch.Tensor,
             old: torch.Tensor | None = None, perm: torch.Tensor | None = None) -> None:
    """Write the keys' group ids into ``gids`` (int32, ``keys``' shape) and,
    with the old dictionary ``old``, its slots' positions in ``new_dict``
    into ``perm`` (int32 ``[cap]``)."""
    if _device(keys, "dict_ids").type == "cpu":
        ids, p = dict_ids_plain(new_dict, keys, old)
        gids.copy_(ids)
        if perm is not None:
            perm.copy_(p)
        return
    launch_ids(new_dict, keys, gids, old, perm)
