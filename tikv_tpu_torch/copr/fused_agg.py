"""Fused scan-filter-aggregate: bytecode compiler, plain version, CUDA launcher.

One pass over a columnar image evaluates the selection conjuncts and every
aggregate argument of a plan and accumulates count/sum/min/max per aggregate
(capacity 1: no GROUP BY).  It replaces the JAX package's ``jax_eval.agg_step``
(cold, one launch per block), ``jax_eval.scan`` (warm, one launch over the
stacked image) and ``jax_eval.pack``, with ``rpn.eval_rpn`` inlined.

* ``compile_program`` turns the plan's RPN lists into bytecode for a small
  stack machine over ``(64-bit value, null)`` slots.  Each instruction
  carries its operands' types, fixed at compile time (``int64`` or ``f64``).
* ``fused_agg_plain`` walks the same bytecode with vectorised torch ops,
  using the scalar kernels of ``copr/kernels.py``; it serves CPU tensors.
* ``fused_agg_cuda`` launches ``csrc/fused_agg.cu`` (``fused_agg_partials``
  then ``fused_agg_combine_pack``) on the tensors' stream: :data:`ROWS` rows
  of a block a thread through the tile walk, in the instance of
  :func:`partials_slots` stack slots, on the grid :func:`launch_grid` that
  the image's shape fixes; ``partials_plain`` follows that grid and its
  tiles.
* ``fused_agg`` takes the plain version for a CPU image and the kernel for a
  CUDA image; on a CUDA tensor it launches the kernel or raises.

The result is the packed state of ``jax_eval._pack_state``: an int64 matrix
``[n_int, 1]`` (row 0 the first-row leaf, then the integer carries in leaf
order) and an f64 matrix ``[n_f64, 1]``.  A carry passed in is updated in
place, as the JAX step donates its carry.
"""

from __future__ import annotations

import ctypes
import struct
from dataclasses import dataclass

import torch

from .datatypes import EvalType
from .kernels import KERNELS, decode_device_column
from .rpn import RpnExpression, RpnNode

# limits of the kernel's parameter block (csrc/fused_agg.cu)
MAX_COLS = 16
MAX_CONSTS = 64
MAX_CODE = 256
MAX_AGGS = 16
MAX_STACK = 8
# geometry of the partials kernels (FA_THREADS, FA_GRID, GA_ROWS)
THREADS = 256
GRID_MAX = 528
ROWS = 4  # rows of one block a thread walks at once (its tile)

NO_ROW = 1 << 62  # first-row sentinel of the packed state
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# opcodes: the same table as the enum in csrc/fa_walk.cuh
OP_COL = 1
OP_CONST = 2
OP_NULL = 3
OP_SCALE = 4
OP_LT = 5
OP_LE = 6
OP_GT = 7
OP_GE = 8
OP_EQ = 9
OP_NE = 10
OP_AND = 11
OP_OR = 12
OP_XOR = 13
OP_NOT = 14
OP_IS_NULL = 15
OP_IS_TRUE = 16
OP_IS_FALSE = 17
OP_PLUS = 18
OP_MINUS = 19
OP_MUL = 20
OP_FILTER = 21
OP_AGG = 22
OP_COUNT1 = 23
OP_KEY = 24
OP_NEG = 25
OP_ABS = 26
OP_BIT_AND = 27
OP_BIT_OR = 28
OP_BIT_XOR = 29
OP_BIT_NEG = 30
OP_IS_NOT_NULL = 31

AGG_COUNT = 0
AGG_SUM = 1
AGG_MIN = 2
AGG_MAX = 3

_FN_OPS = {
    "lt": OP_LT, "le": OP_LE, "gt": OP_GT, "ge": OP_GE, "eq": OP_EQ, "ne": OP_NE,
    "and": OP_AND, "or": OP_OR, "xor": OP_XOR, "not": OP_NOT,
    "is_null": OP_IS_NULL, "is_true": OP_IS_TRUE, "is_false": OP_IS_FALSE,
    "plus": OP_PLUS, "minus": OP_MINUS, "multiply": OP_MUL,
    "unary_minus": OP_NEG, "abs": OP_ABS, "bit_and": OP_BIT_AND, "bit_or": OP_BIT_OR,
    "bit_xor": OP_BIT_XOR, "bit_neg": OP_BIT_NEG, "is_not_null": OP_IS_NOT_NULL,
}
_OP_FNS = {v: k for k, v in _FN_OPS.items()}
_ARITH = (OP_PLUS, OP_MINUS, OP_MUL)
_SAME_TYPE = (OP_NEG, OP_ABS)  # typed like their one operand
_BITWISE = (OP_BIT_AND, OP_BIT_OR, OP_BIT_XOR, OP_BIT_NEG)
_AGG_KIND = {"count": AGG_COUNT, "sum": AGG_SUM, "avg": AGG_SUM, "min": AGG_MIN, "max": AGG_MAX}
#: the aggregates the capacity-1 kernels run
CAPACITY_ONE_OPS = frozenset(_AGG_KIND)

#: launches of each CUDA kernel, counted where its wrapper launches it (the
#: grouped pair's wrappers are in ``copr/fused_group_agg.py``, the mask's in
#: ``copr/fused_mask.py``, the top-K kernels' in ``copr/fused_topn.py``, the
#: zone-tile kernels' in ``copr/fused_zone.py``, the batch kernels' in
#: ``copr/fused_batch.py``, the join probes' in ``copr/fused_join.py``, the
#: mesh merge's and fold's in ``copr/fused_mesh.py``, the group dictionary's in
#: ``copr/fused_dict.py``, the image patch's in ``copr/fused_patch.py``)
LAUNCHES = {"fused_agg_partials": 0, "fused_agg_combine_pack": 0,
            "fused_group_agg_partials": 0, "fused_group_agg_combine_pack": 0,
            "group_wide_partials": 0, "group_wide_combine": 0,
            "fused_mask": 0, "topn_candidates": 0, "topn_merge": 0, "topn_pack": 0,
            "decode_column": 0, "zone_full": 0, "zone_partial": 0, "zone_fold": 0,
            "batch_partials": 0, "batch_combine_pack": 0,
            "join_rank_probe": 0, "join_hash_probe": 0, "mesh_merge": 0, "mesh_fold": 0,
            "dict_keys": 0, "dict_union": 0, "dict_ids": 0,
            "dict_merge": 0, "dict_compact": 0, "patch_stacked": 0}


_PUSH_OPS = frozenset({OP_COL, OP_CONST, OP_NULL})
_POP_OPS = frozenset({OP_LT, OP_LE, OP_GT, OP_GE, OP_EQ, OP_NE, OP_AND, OP_OR, OP_XOR, OP_PLUS,
                      OP_MINUS, OP_MUL, OP_BIT_AND, OP_BIT_OR, OP_BIT_XOR, OP_FILTER, OP_AGG,
                      OP_KEY})


def stack_depth(code) -> int:
    """The most operands the bytecode ``code`` holds at once (the mask's
    launcher, ``sc_stack_depth`` of csrc/fused_scan.cu, reads it the same
    way): SCALE, COUNT1 and the unary operators keep the depth."""
    depth = most = 0
    for word in code:
        op = word & 0xFF
        if op in _PUSH_OPS:
            depth += 1
            most = max(most, depth)
        elif op in _POP_OPS:
            depth -= 1
    return most


def stack_slots(codes) -> int:
    """The stack slots of the tile-walk instance (2, 4 or 8) that holds the
    deepest of the bytecodes ``codes``; ``ValueError`` past ``MAX_STACK``
    (the emitter refuses such plans)."""
    depth = max((stack_depth(c) for c in codes), default=0)
    if depth > MAX_STACK:
        raise ValueError(f"a plan {depth} operands deep: the tile walk holds {MAX_STACK}")
    return 2 if depth <= 2 else 4 if depth <= 4 else 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Unsupported(Exception):
    """A plan this slice does not run, with a bounded-cardinality cause."""

    def __init__(self, msg: str, cause: str):
        super().__init__(msg)
        self.cause = cause


# ---------------------------------------------------------------------------
# Bytecode
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AggLeaf:
    kind: int  # AGG_COUNT / AGG_SUM / AGG_MIN / AGG_MAX
    is_f64: bool
    cnt_slot: int  # row of the count in the packed int64 matrix
    val_slot: int  # row of the value in the int64 or f64 matrix; -1 for count


@dataclass(frozen=True)
class Program:
    code: tuple[int, ...]
    consts: tuple[int, ...]  # raw 64-bit words, as signed int64
    col_f64: tuple[bool, ...]  # per shipped column slot
    aggs: tuple[AggLeaf, ...]
    n_int: int  # rows of the packed int64 matrix (first-row leaf included)
    n_f64: int


def _word(op: int, arg: int = 0, flags: int = 0, depth: int = 0) -> int:
    return op | (arg << 8) | (flags << 16) | (depth << 24)


def _decode(word: int) -> tuple[int, int, int, int]:
    return word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF, (word >> 24) & 0xFF


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


class _Emitter:
    def __init__(self, slot_of: dict[int, int], schema):
        self.slot_of = slot_of
        self.schema = schema
        self.code: list[int] = []
        self.consts: list[int] = []
        self.types: list[bool] = []  # static f64-ness of each stack slot

    def const(self, word: int) -> int:
        if word not in self.consts:
            if len(self.consts) == MAX_CONSTS:
                raise Unsupported("too many constants for the kernel", "plan_too_large")
            self.consts.append(word)
        return self.consts.index(word)

    def emit(self, word: int) -> None:
        if len(self.code) == MAX_CODE:
            raise Unsupported("plan too long for the kernel", "plan_too_large")
        self.code.append(word)

    def push(self, is_f64: bool) -> None:
        self.types.append(is_f64)
        if len(self.types) > MAX_STACK:
            raise Unsupported(f"expression deeper than {MAX_STACK}", "expr_too_deep")

    def expr(self, rpn: RpnExpression) -> bool:
        """Emit one RPN list; returns whether its result is f64."""
        for node in rpn.nodes:
            if node.kind == "col":
                is_f = self.schema[node.index][0] == EvalType.REAL
                self.emit(_word(OP_COL, self.slot_of[node.index]))
                self.push(is_f)
            elif node.kind == "const":
                self._const_node(node)
            else:
                self._fn_node(node)
        return self.types[-1]

    def _const_node(self, node: RpnNode) -> None:
        is_f = node.eval_type == EvalType.REAL
        if node.value is None:
            self.emit(_word(OP_NULL, 0, int(is_f)))
        else:
            if is_f:
                word = _f64_bits(float(node.value))
            else:
                word = int(node.value)
                if not _I64_MIN <= word <= _I64_MAX:
                    raise Unsupported("constant outside int64", "expr_compile")
            self.emit(_word(OP_CONST, self.const(word), int(is_f)))
        self.push(is_f)

    def _fn_node(self, node: RpnNode) -> None:
        op = _FN_OPS.get(node.op)
        if op is None:
            raise Unsupported(f"scalar function {node.op!r}", "op_not_ported")
        arity = node.arity
        for pos, m in enumerate(node.scale_by):
            if m == 1:
                continue
            if not isinstance(m, int) or not _I64_MIN <= m <= _I64_MAX:
                raise Unsupported(f"decimal rescale by {m!r}", "expr_compile")
            depth = arity - 1 - pos
            self.emit(_word(OP_SCALE, self.const(m), int(self.types[-1 - depth]), depth))
        arg_types = self.types[-arity:]
        if op in _BITWISE and any(arg_types):
            # numpy has no bitwise operator on float64: the reference fails too
            raise Unsupported(f"{node.op} of a REAL operand", "op_not_ported")
        del self.types[-arity:]
        flags = sum(int(t) << i for i, t in enumerate(arg_types))
        self.emit(_word(op, 0, flags))
        self.push((op in _ARITH and any(arg_types)) or (op in _SAME_TYPE and arg_types[0]))


def emit_program(sel_rpns, aggs, ship_cols, schema) -> tuple[_Emitter, list[bool]]:
    """Bytecode for ``sel_rpns`` (conjuncts) and ``aggs`` (``(op, rpn | None)``
    pairs) over the shipped columns ``ship_cols`` (schema indices, in slot
    order): the conjuncts, then one OP_AGG (or OP_COUNT1) per aggregate.
    Returns the emitter and whether each aggregate's value lane is f64.
    Raises :class:`Unsupported` for what the kernels cannot run."""
    if len(ship_cols) > MAX_COLS:
        raise Unsupported(f"more than {MAX_COLS} columns", "plan_too_large")
    if len(aggs) > MAX_AGGS:
        raise Unsupported(f"more than {MAX_AGGS} aggregates", "plan_too_large")
    em = _Emitter({c: j for j, c in enumerate(ship_cols)}, schema)
    for rpn in sel_rpns:
        is_f = em.expr(rpn)
        em.emit(_word(OP_FILTER, 0, int(is_f)))
        em.types.pop()
    lane_f64 = []
    for k, (op, rpn) in enumerate(aggs):
        if rpn is None:
            em.emit(_word(OP_COUNT1, k))
            lane_f64.append(False)
            continue
        is_f = em.expr(rpn)
        if op != "count" and is_f != (rpn.eval_type == EvalType.REAL):
            # the value lane's type must be the carry's: an INT-typed
            # expression computed in f64 (int + real) has no exact carry
            raise Unsupported("aggregate argument typed unlike its lane",
                              "agg_arg_type_not_ported")
        em.emit(_word(OP_AGG, k, int(is_f)))
        em.types.pop()
        lane_f64.append(is_f)
    return em, lane_f64


def emit_keys(em: _Emitter, key_rpns) -> list[bool]:
    """Append one OP_KEY per sort key to ``em``'s bytecode; returns whether
    each key's value lane is f64."""
    key_f64 = []
    for q, rpn in enumerate(key_rpns):
        is_f = em.expr(rpn)
        em.emit(_word(OP_KEY, q, int(is_f)))
        em.types.pop()
        key_f64.append(is_f)
    return key_f64


def compile_program(sel_rpns, aggs, ship_cols, schema) -> Program:
    """The capacity-1 program of ``fused_agg_partials`` (count, sum, avg,
    min, max; no GROUP BY): :func:`emit_program`'s bytecode and the leaf
    layout of the packed state."""
    for op, _rpn in aggs:
        if op not in _AGG_KIND:
            raise Unsupported(f"aggregate {op}", "agg_op_not_ported")
    em, lane_f64 = emit_program(sel_rpns, aggs, ship_cols, schema)
    leaves = []
    n_int, n_f64 = 1, 0  # int64 row 0 holds the first-row leaf
    for (op, _rpn), is_f in zip(aggs, lane_f64):
        kind = _AGG_KIND[op]
        cnt_slot, n_int = n_int, n_int + 1
        if kind == AGG_COUNT:
            val_slot = -1
        elif is_f:
            val_slot, n_f64 = n_f64, n_f64 + 1
        else:
            val_slot, n_int = n_int, n_int + 1
        leaves.append(AggLeaf(kind, is_f, cnt_slot, val_slot))
    col_f64 = tuple(schema[c][0] == EvalType.REAL for c in ship_cols)
    return Program(tuple(em.code), tuple(em.consts), col_f64, tuple(leaves),
                   n_int, n_f64)


# ---------------------------------------------------------------------------
# The image the kernel reads
# ---------------------------------------------------------------------------

PLAIN = ("plain",)


@dataclass
class Image:
    """Shipped columns as ``[n_blocks, block_rows]`` tensors on one device.
    ``cols[j]`` is the pinned payload of column ``j`` under its encoding
    descriptor ``descs[j]`` (``encoding._col_desc``; ``descs`` None: every
    column plain): plain, int64 or f64 as ``Program.col_f64[j]``; bp or code,
    int8/int16/int32 lanes (bp adds ``refs[j]``); rle, the pair
    ``(run_values, run_ends)`` of shape ``[n_blocks, k_cap]``.  ``nulls[j]``
    is a bool mask, ``[n_blocks, block_rows]`` or, for an rle column,
    run-shaped ``[n_blocks, k_cap]`` (``k_cap < block_rows``), or None for a
    NOT NULL column.  ``n_valids`` is an int64 ``[n_blocks]``
    tensor, or one int for every block.  The grouped kernels also read
    ``offsets`` (the global row index of each block's row 0: an int64
    ``[n_blocks]`` tensor, or one int for a single block) and, for host
    group ids, ``gids`` (int32 ``[n_blocks, block_rows]``)."""

    cols: list
    nulls: list
    n_valids: object
    n_blocks: int
    block_rows: int
    device: torch.device
    offsets: object = 0
    gids: torch.Tensor | None = None
    descs: tuple | None = None
    refs: tuple | None = None

    def desc(self, j: int) -> tuple:
        return PLAIN if self.descs is None else self.descs[j]

    def ref(self, j: int) -> int:
        return 0 if self.refs is None else int(self.refs[j])

    def lanes(self, j: int):
        """Column ``j`` decoded: ``(data, nulls)`` of shape ``[n_blocks,
        block_rows]`` (nulls None for a NOT NULL column), through the plain
        version of program #1."""
        return decode_device_column(self.desc(j), self.cols[j], self.nulls[j], self.ref(j),
                                    self.block_rows)

    def blocks(self, start: int, end: int) -> "Image":
        """Blocks ``start:end`` (views, no copy)."""
        def cut(t):
            if t is None:
                return None
            return tuple(x[start:end] for x in t) if isinstance(t, tuple) else t[start:end]

        nv = self.n_valids if isinstance(self.n_valids, int) else self.n_valids[start:end]
        off = self.offsets if isinstance(self.offsets, int) else self.offsets[start:end]
        return Image([cut(c) for c in self.cols], [cut(m) for m in self.nulls], nv,
                     end - start, self.block_rows, self.device, off, cut(self.gids),
                     self.descs, self.refs)

    def pick(self, at: list[int]) -> "Image":
        """The image of columns ``at`` (positions in this image)."""
        return Image([self.cols[j] for j in at], [self.nulls[j] for j in at], self.n_valids,
                     self.n_blocks, self.block_rows, self.device, self.offsets, self.gids,
                     None if self.descs is None else tuple(self.descs[j] for j in at),
                     None if self.refs is None else tuple(self.refs[j] for j in at))


def _valid_mask(img: Image) -> torch.Tensor:
    lane = torch.arange(img.block_rows, device=img.device)
    if isinstance(img.n_valids, int):
        m = (lane < img.n_valids).expand(img.n_blocks, img.block_rows)
    else:
        m = lane[None, :] < img.n_valids[:, None]
    return m.reshape(-1)


def _ident(kind: int, is_f64: bool):
    if kind == AGG_MIN:
        return float("inf") if is_f64 else _I64_MAX
    if kind == AGG_MAX:
        return float("-inf") if is_f64 else _I64_MIN
    return 0.0 if is_f64 else 0


def _lane_dtype(is_f64: bool) -> torch.dtype:
    return torch.float64 if is_f64 else torch.int64


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _walk(prog: Program, img: Image):
    """Run the bytecode over every row at once.  Returns, per aggregate,
    ``(live mask, value or None)``."""
    return walk_rows(prog, img, len(prog.aggs))[0]


def walk_rows(prog, img: Image, n_aggs: int, keys: list | None = None):
    """:func:`_walk` for any program of ``n_aggs`` aggregates (this module's,
    the grouped one, the mask's or the top-K's), also returning the rows that
    passed the selection.  Sort key ``q`` (OP_KEY) goes to ``keys[q]`` as
    ``(value, null)``."""
    n = img.n_blocks * img.block_rows
    dev = img.device
    active = _valid_mask(img)
    no_nulls = torch.zeros(n, dtype=torch.bool, device=dev)
    stack: list[tuple[torch.Tensor, torch.Tensor]] = []
    out: list = [None] * n_aggs
    lanes: dict[int, tuple] = {}  # each column decoded once
    for word in prog.code:
        op, arg, flags, depth = _decode(word)
        fa = bool(flags & 1)
        if op == OP_COL:
            if arg not in lanes:
                d, nl = img.lanes(arg)
                lanes[arg] = (d.reshape(-1), no_nulls if nl is None else nl.reshape(-1))
            stack.append(lanes[arg])
        elif op == OP_CONST:
            raw = torch.tensor([prog.consts[arg]], dtype=torch.int64)
            value = (raw.view(torch.float64) if fa else raw).item()
            stack.append((torch.full((n,), value, dtype=_lane_dtype(fa), device=dev), no_nulls))
        elif op == OP_NULL:
            stack.append((torch.zeros(n, dtype=_lane_dtype(fa), device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev)))
        elif op == OP_SCALE:
            d, nl = stack[-1 - depth]
            stack[-1 - depth] = (d * prog.consts[arg], nl)
        elif op in _OP_FNS:
            arity, _rkind, fn = KERNELS[_OP_FNS[op]]
            args = stack[-arity:]
            del stack[-arity:]
            stack.append(fn(*args))
        elif op == OP_FILTER:
            d, nl = stack.pop()
            active = active & (d != 0) & ~nl
        elif op == OP_AGG:
            d, nl = stack.pop()
            out[arg] = (active & ~nl, d)
        elif op == OP_COUNT1:
            out[arg] = (active, None)
        elif op == OP_KEY:
            keys[arg] = stack.pop()
        else:
            raise ValueError(f"bad opcode {op}")
    return out, active


def _reduce(kind: int, is_f64: bool, live: torch.Tensor, value: torch.Tensor):
    """0-d reduction of the live values."""
    if kind == AGG_SUM:
        zero = torch.zeros((), dtype=value.dtype, device=value.device)
        return torch.where(live, value, zero).sum()
    ident = torch.full((), _ident(kind, is_f64), dtype=value.dtype, device=value.device)
    masked = torch.where(live, value, ident)
    if masked.numel() == 0:
        return ident
    return masked.amin() if kind == AGG_MIN else masked.amax()


def _merge(kind: int, carry: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    if kind == AGG_SUM:
        return carry + block
    return torch.minimum(carry, block) if kind == AGG_MIN else torch.maximum(carry, block)


def _init_packed(prog: Program, device) -> tuple[torch.Tensor, torch.Tensor]:
    ints = torch.zeros((prog.n_int, 1), dtype=torch.int64, device=device)
    flts = torch.zeros((prog.n_f64, 1), dtype=torch.float64, device=device)
    ints[0] = NO_ROW
    for leaf in prog.aggs:
        if leaf.kind in (AGG_MIN, AGG_MAX):
            (flts if leaf.is_f64 else ints)[leaf.val_slot] = _ident(leaf.kind, leaf.is_f64)
    return ints, flts


def _store(prog: Program, packed, totals) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-aggregate ``(count, value)`` totals into the packed carry."""
    ints, flts = packed
    for leaf, (cnt, val) in zip(prog.aggs, totals):
        ints[leaf.cnt_slot] = ints[leaf.cnt_slot] + cnt
        if leaf.kind != AGG_COUNT:
            m = flts if leaf.is_f64 else ints
            m[leaf.val_slot] = _merge(leaf.kind, m[leaf.val_slot], val)
    return ints, flts


def fused_agg_plain(prog: Program, img: Image, carry=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the same bytecode, vectorised over rows."""
    packed = carry if carry is not None else _init_packed(prog, img.device)
    totals = []
    for leaf, (live, value) in zip(prog.aggs, _walk(prog, img)):
        cnt = live.sum(dtype=torch.int64)
        val = None if leaf.kind == AGG_COUNT else _reduce(leaf.kind, leaf.is_f64, live, value)
        totals.append((cnt, val))
    return _store(prog, packed, totals)


def launch_grid(img: Image) -> int:
    """Blocks of the tile-walk partials kernels (``fused_agg_partials``,
    ``fused_group_agg_partials``, ``group_wide_partials``) for an image: one
    per ``THREADS`` tiles of ``ROWS`` rows of a block (a short block's last
    tile counts whole), at most ``GRID_MAX``; fixed by the image's shape."""
    tiles = img.n_blocks * -(-img.block_rows // ROWS)
    return max(1, min(GRID_MAX, -(-tiles // THREADS)))


def check_tiles(img: Image) -> None:
    """``ValueError`` for an image of ``2^31`` tiles or more: the partials
    kernels of the capacity-1 pair and the wide route index tiles in 32
    bits."""
    if img.n_blocks * -(-img.block_rows // ROWS) >= 1 << 31:
        raise ValueError(f"{img.n_blocks} blocks of {img.block_rows} rows: 2^31 tiles or more")


def tile_blocks(img: Image, grid: int, threads: int = THREADS,
                rows_a_thread: int = ROWS) -> torch.Tensor:
    """The kernel block that walks each flat row: a thread takes
    ``rows_a_thread`` R rows of one block at once, so row i of block b lies
    in tile ``b * ceil(block_rows / R) + i // R``, and tile u goes to block
    ``(u mod grid*threads) // threads``."""
    br = img.block_rows
    flat = torch.arange(img.n_blocks * br, device=img.device)
    b = flat // br
    tile = b * -(-br // rows_a_thread) + (flat - b * br) // rows_a_thread
    return (tile % (grid * threads)) // threads


def partials_plain(prog: Program, img: Image, grid: int | None = None, threads: int = THREADS,
                   rows_a_thread: int = ROWS) -> torch.Tensor:
    """Plain version of ``fused_agg_partials``: ``[grid, n_aggs, 2]`` int64
    words (count, value bits), by default at the kernel's
    :func:`launch_grid`, each row in the block :func:`tile_blocks` gives
    it, so that counts and integer values agree word for word.  f64
    partials are summed in another order than the kernel's."""
    grid = launch_grid(img) if grid is None else grid
    seg = tile_blocks(img, grid, threads, rows_a_thread)
    out = torch.zeros((grid, len(prog.aggs), 2), dtype=torch.int64, device=img.device)
    for k, (leaf, (live, value)) in enumerate(zip(prog.aggs, _walk(prog, img))):
        out[:, k, 0] = torch.zeros(grid, dtype=torch.int64, device=img.device).index_add_(
            0, seg, live.to(torch.int64))
        if leaf.kind == AGG_COUNT:
            continue
        dtype = _lane_dtype(leaf.is_f64)
        ident = torch.full((), _ident(leaf.kind, leaf.is_f64), dtype=dtype, device=img.device)
        masked = torch.where(live, value, ident)
        acc = torch.full((grid,), _ident(leaf.kind, leaf.is_f64), dtype=dtype, device=img.device)
        if leaf.kind == AGG_SUM:
            acc.index_add_(0, seg, masked)
        else:
            acc.scatter_reduce_(0, seg, masked, "amin" if leaf.kind == AGG_MIN else "amax")
        out[:, k, 1] = acc.view(torch.int64) if leaf.is_f64 else acc
    return out


def combine_plain(prog: Program, scratch: torch.Tensor, carry=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``fused_agg_combine_pack``."""
    packed = carry if carry is not None else _init_packed(prog, scratch.device)
    totals = []
    for k, leaf in enumerate(prog.aggs):
        cnt = scratch[:, k, 0].sum()
        val = None
        if leaf.kind != AGG_COUNT:
            vals = scratch[:, k, 1].clone()
            if leaf.is_f64:
                vals = vals.view(torch.float64)
            live = torch.ones_like(vals, dtype=torch.bool)
            val = _reduce(leaf.kind, leaf.is_f64, live, vals)
        totals.append((cnt, val))
    return _store(prog, packed, totals)


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

# column kinds of the walk's column load (program #1, FA_ENC_* in csrc/fa_walk.cuh)
ENC_PLAIN = 0
ENC_NARROW = 1  # bp and code: 1-, 2- or 4-byte lanes, sign-extended, + ref
ENC_RLE = 2


class _Enc(ctypes.Structure):
    """``FaEnc`` of csrc/fa_walk.cuh: how each column of a parameter block
    is loaded (its descriptor, inline in the block)."""

    _fields_ = [
        ("ref", ctypes.c_int64 * MAX_COLS),
        ("ends", ctypes.c_uint64 * MAX_COLS),
        ("k_cap", ctypes.c_int32 * MAX_COLS),
        ("kind", ctypes.c_int8 * MAX_COLS),
        ("width", ctypes.c_int8 * MAX_COLS),
        ("null_runs", ctypes.c_int8 * MAX_COLS),
        ("pad", ctypes.c_int8 * MAX_COLS),
    ]


class _Params(ctypes.Structure):
    """``FaParams`` of csrc/fused_agg.cu, passed to the kernel by value."""

    _fields_ = [
        ("col", ctypes.c_uint64 * MAX_COLS),
        ("nul", ctypes.c_uint64 * MAX_COLS),
        ("enc", _Enc),
        ("n_valids", ctypes.c_uint64),
        ("n_valid_all", ctypes.c_int64),
        ("n_blocks", ctypes.c_int64),
        ("block_rows", ctypes.c_int64),
        ("consts", ctypes.c_int64 * MAX_CONSTS),
        ("code", ctypes.c_int32 * MAX_CODE),
        ("n_code", ctypes.c_int32),
        ("n_cols", ctypes.c_int32),
        ("n_aggs", ctypes.c_int32),
        ("agg_kind", ctypes.c_int32 * MAX_AGGS),
        ("agg_f64", ctypes.c_int32 * MAX_AGGS),
        ("cnt_slot", ctypes.c_int32 * MAX_AGGS),
        ("val_slot", ctypes.c_int32 * MAX_AGGS),
    ]


def set_columns(p, img: Image) -> None:
    """Fill a parameter block's columns (``col``, ``nul``) and their
    descriptors (``enc``) from ``img``."""
    for j, (c, nl) in enumerate(zip(img.cols, img.nulls)):
        kind = img.desc(j)[0]
        if kind == "rle":
            values, ends = c
            p.col[j], p.enc.ends[j] = values.data_ptr(), ends.data_ptr()
            p.enc.k_cap[j], p.enc.width[j] = ends.shape[-1], values.element_size()
            p.enc.kind[j] = ENC_RLE
            p.enc.null_runs[j] = int(nl is not None and nl.shape[-1] != img.block_rows)
        else:
            p.col[j], p.enc.width[j] = c.data_ptr(), c.element_size()
            p.enc.kind[j] = ENC_PLAIN if kind == "plain" else ENC_NARROW
            p.enc.ref[j] = img.ref(j) if kind == "bp" else 0
        p.nul[j] = 0 if nl is None else nl.data_ptr()


def program_params(prog: Program) -> _Params:
    """The plan part of the kernel's parameter block."""
    p = _Params()
    p.consts[: len(prog.consts)] = prog.consts
    p.code[: len(prog.code)] = prog.code
    p.n_code = len(prog.code)
    p.n_cols = len(prog.col_f64)
    p.n_aggs = len(prog.aggs)
    for k, leaf in enumerate(prog.aggs):
        p.agg_kind[k] = leaf.kind
        p.agg_f64[k] = int(leaf.is_f64)
        p.cnt_slot[k] = leaf.cnt_slot
        p.val_slot[k] = leaf.val_slot
    return p


_lib = None


def _kernels():
    """The built kernel library, with its C signatures declared."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_agg")
        vp = ctypes.c_void_p
        ci = ctypes.c_int
        for fn in ("fa_params_size", "fa_grid", "fa_threads"):
            getattr(lib, fn).restype = ci
        lib.fa_launch_partials.argtypes = [vp, vp, ci, ci, vp]
        lib.fa_launch_partials.restype = ci
        lib.fa_partials_attributes.argtypes = [ci, vp]
        lib.fa_partials_attributes.restype = ci
        lib.fa_launch_combine.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp]
        lib.fa_launch_combine.restype = ci
        if lib.fa_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"FaParams layout mismatch: kernel {lib.fa_params_size()} bytes, "
                f"wrapper {ctypes.sizeof(_Params)}")
        if lib.fa_grid() != GRID_MAX or lib.fa_threads() != THREADS:
            raise RuntimeError("FA_GRID or FA_THREADS of the kernel differs from the wrapper's")
        _lib = lib
    return _lib


def partials_slots(prog: Program) -> int:
    """The stack slots of the ``fused_agg_partials`` instance that runs
    ``prog``: the fewest of 2, 4 or 8 that hold its plan."""
    return stack_slots([prog.code])


def partials_attributes(slots: int) -> dict:
    """``cudaFuncGetAttributes`` of the ``fused_agg_partials`` instance of
    ``slots`` stack slots: registers a thread, local (spilled) bytes a
    thread, static shared bytes a block."""
    out = (ctypes.c_int * 3)()
    rc = _kernels().fa_partials_attributes(slots, out)
    if rc != 0:
        raise RuntimeError(f"fused_agg_partials attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2],
            "stackSlots": slots}


def new_scratch(prog: Program, img: Image) -> torch.Tensor:
    """Scratch for :func:`launch_partials`: ``[launch_grid(img), n_aggs, 2]``."""
    return torch.empty((launch_grid(img), len(prog.aggs), 2), dtype=torch.int64,
                       device=img.device)


_NARROW_DTYPES = (torch.int8, torch.int16, torch.int32)
_RUN_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def _contiguous(t, dev, dtypes, shape) -> bool:
    return (isinstance(t, torch.Tensor) and t.device == dev and t.dtype in dtypes
            and tuple(t.shape) == shape and t.is_contiguous())


def check_columns(col_f64, img: Image) -> None:
    """Raise unless every column of ``img`` is what the kernels load under
    its descriptor (f64 where ``col_f64`` says so), on one CUDA device,
    contiguous."""
    dev = img.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA image, got {dev}")
    if len(img.cols) != len(col_f64) or len(img.nulls) != len(col_f64):
        raise ValueError("image columns do not match the program")
    if img.descs is not None and len(img.descs) != len(img.cols):
        raise ValueError("image descriptors do not match its columns")
    shape = (img.n_blocks, img.block_rows)
    for j, (c, nl) in enumerate(zip(img.cols, img.nulls)):
        desc = img.desc(j)
        null_shape = shape
        if desc[0] == "rle":
            runs = (img.n_blocks, desc[1])
            ok = (not col_f64[j] and isinstance(c, tuple) and len(c) == 2
                  and _contiguous(c[0], dev, _RUN_DTYPES, runs)
                  and _contiguous(c[1], dev, (torch.int64,), runs))
            want, null_shape = f"int run values and int64 run ends {runs}", runs
        elif desc[0] in ("bp", "code"):
            ok = not col_f64[j] and _contiguous(c, dev, _NARROW_DTYPES, shape)
            want = f"int8/int16/int32 lanes {shape}"
        elif desc[0] == "plain":
            ok = _contiguous(c, dev, (_lane_dtype(col_f64[j]),), shape)
            want = f"{_lane_dtype(col_f64[j])} {shape}"
        else:
            raise ValueError(f"column {j}: unknown descriptor {desc!r}")
        if not ok:
            raise ValueError(f"column {j} ({desc[0]}): need contiguous {want} on {dev}")
        if nl is not None and not (_contiguous(nl, dev, (torch.bool,), null_shape)
                                   or _contiguous(nl, dev, (torch.bool,), shape)):
            raise ValueError(f"null mask {j}: need contiguous bool {null_shape} on {dev}")
    nv = img.n_valids
    if not isinstance(nv, int) and not _contiguous(nv, dev, (torch.int64,), (img.n_blocks,)):
        raise ValueError(f"n_valids: need contiguous int64 ({img.n_blocks},) on {dev}")


def launch_partials(prog: Program, img: Image, scratch: torch.Tensor) -> None:
    """Launch ``fused_agg_partials`` into ``scratch`` (:func:`new_scratch`:
    ``[launch_grid(img), n_aggs, 2]`` int64)."""
    check_columns(prog.col_f64, img)
    check_tiles(img)
    lib = _kernels()
    grid = launch_grid(img)
    if scratch.device != img.device or scratch.dtype != torch.int64 \
            or tuple(scratch.shape) != (grid, len(prog.aggs), 2) or not scratch.is_contiguous():
        raise ValueError(f"scratch: need contiguous int64 [{grid}, n_aggs, 2] on the image's "
                         "device")
    p = program_params(prog)
    set_columns(p, img)
    if isinstance(img.n_valids, int):
        p.n_valids, p.n_valid_all = 0, img.n_valids
    else:
        p.n_valids = img.n_valids.data_ptr()
    p.n_blocks, p.block_rows = img.n_blocks, img.block_rows
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.fa_launch_partials(ctypes.byref(p), scratch.data_ptr(), grid,
                                    partials_slots(prog), stream)
    LAUNCHES["fused_agg_partials"] += 1
    if rc != 0:
        raise RuntimeError(f"fused_agg_partials launch failed: cudaError {rc}")


def launch_combine(prog: Program, scratch: torch.Tensor, carry, out) -> None:
    """Launch ``fused_agg_combine_pack``: fold ``scratch`` into ``carry``
    (None: the identity state) and write the packed state to ``out``, which
    may be ``carry`` itself."""
    dev = scratch.device
    ints, flts = out
    for t, dt, rows in ((ints, torch.int64, prog.n_int), (flts, torch.float64, prog.n_f64)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (rows, 1) or not t.is_contiguous():
            raise ValueError(f"packed output: need contiguous {dt} ({rows}, 1) on {dev}")
    if carry is not None:
        for t, o in zip(carry, out):
            if t.device != dev or t.dtype != o.dtype or t.shape != o.shape or not t.is_contiguous():
                raise ValueError("carry must match the packed output's layout")
    lib = _kernels()
    p = program_params(prog)

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    ci, cf = carry if carry is not None else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fa_launch_combine(ctypes.byref(p), scratch.data_ptr(), scratch.shape[0],
                                   ptr(ci), ptr(cf), ptr(ints), ptr(flts), stream)
    LAUNCHES["fused_agg_combine_pack"] += 1
    if rc != 0:
        raise RuntimeError(f"fused_agg_combine_pack launch failed: cudaError {rc}")


def fused_agg_cuda(prog: Program, img: Image, carry=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Both kernels on the image's current stream; no host synchronisation."""
    scratch = new_scratch(prog, img)
    launch_partials(prog, img, scratch)
    out = carry if carry is not None else (
        torch.empty((prog.n_int, 1), dtype=torch.int64, device=img.device),
        torch.empty((prog.n_f64, 1), dtype=torch.float64, device=img.device),
    )
    launch_combine(prog, scratch, carry, out)
    return out


def fused_agg(prog: Program, img: Image, carry=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed state after folding ``img`` into ``carry``: the plain version
    for a CPU image, the CUDA kernels for a CUDA image."""
    if img.device.type == "cpu":
        return fused_agg_plain(prog, img, carry)
    if img.device.type == "cuda":
        return fused_agg_cuda(prog, img, carry)
    raise ValueError(f"no fused_agg for device {img.device}")

