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
  then ``fused_agg_combine_pack``) on the tensors' stream.
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
from .kernels import KERNELS
from .rpn import RpnExpression, RpnNode

# limits of the kernel's parameter block (csrc/fused_agg.cu)
MAX_COLS = 16
MAX_CONSTS = 64
MAX_CODE = 256
MAX_AGGS = 16
MAX_STACK = 8

NO_ROW = 1 << 62  # first-row sentinel of the packed state
_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# opcodes: the same table as the enum in csrc/fused_agg.cu
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

AGG_COUNT = 0
AGG_SUM = 1
AGG_MIN = 2
AGG_MAX = 3

_FN_OPS = {
    "lt": OP_LT, "le": OP_LE, "gt": OP_GT, "ge": OP_GE, "eq": OP_EQ, "ne": OP_NE,
    "and": OP_AND, "or": OP_OR, "xor": OP_XOR, "not": OP_NOT,
    "is_null": OP_IS_NULL, "is_true": OP_IS_TRUE, "is_false": OP_IS_FALSE,
    "plus": OP_PLUS, "minus": OP_MINUS, "multiply": OP_MUL,
}
_OP_FNS = {v: k for k, v in _FN_OPS.items()}
_ARITH = (OP_PLUS, OP_MINUS, OP_MUL)
_AGG_KIND = {"count": AGG_COUNT, "sum": AGG_SUM, "avg": AGG_SUM, "min": AGG_MIN, "max": AGG_MAX}
#: the aggregates the capacity-1 kernels run
CAPACITY_ONE_OPS = frozenset(_AGG_KIND)

#: launches of each CUDA kernel, counted where its wrapper launches it (the
#: grouped pair's wrappers are in ``copr/fused_group_agg.py``)
LAUNCHES = {"fused_agg_partials": 0, "fused_agg_combine_pack": 0,
            "fused_group_agg_partials": 0, "fused_group_agg_combine_pack": 0}


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
        del self.types[-arity:]
        flags = sum(int(t) << i for i, t in enumerate(arg_types))
        self.emit(_word(op, 0, flags))
        self.push(op in _ARITH and any(arg_types))


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

@dataclass
class Image:
    """Shipped columns as ``[n_blocks, block_rows]`` tensors on one device.
    ``cols[j]`` is int64 or f64 as ``Program.col_f64[j]``; ``nulls[j]`` is a
    bool mask or None for a NOT NULL column.  ``n_valids`` is an int64
    ``[n_blocks]`` tensor, or one int for every block.  The grouped kernels
    also read ``offsets`` (the global row index of each block's row 0: an
    int64 ``[n_blocks]`` tensor, or one int for a single block) and, for host
    group ids, ``gids`` (int32 ``[n_blocks, block_rows]``)."""

    cols: list
    nulls: list
    n_valids: object
    n_blocks: int
    block_rows: int
    device: torch.device
    offsets: object = 0
    gids: torch.Tensor | None = None


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


def walk_rows(prog, img: Image, n_aggs: int):
    """:func:`_walk` for any program of ``n_aggs`` aggregates (this module's
    or the grouped one), also returning the rows that passed the selection."""
    n = img.n_blocks * img.block_rows
    dev = img.device
    active = _valid_mask(img)
    no_nulls = torch.zeros(n, dtype=torch.bool, device=dev)
    stack: list[tuple[torch.Tensor, torch.Tensor]] = []
    out: list = [None] * n_aggs
    for word in prog.code:
        op, arg, flags, depth = _decode(word)
        fa = bool(flags & 1)
        if op == OP_COL:
            nl = img.nulls[arg]
            stack.append((img.cols[arg].reshape(-1), no_nulls if nl is None else nl.reshape(-1)))
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


def partials_plain(prog: Program, img: Image, grid: int, threads: int) -> torch.Tensor:
    """Plain version of ``fused_agg_partials``: ``[grid, n_aggs, 2]`` int64
    words (count, value bits), flat row r going to block
    ``(r mod grid*threads) // threads`` as in the kernel.  f64 partials are
    summed in another order than the kernel's."""
    n = img.n_blocks * img.block_rows
    seg = (torch.arange(n, device=img.device) % (grid * threads)) // threads
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

class _Params(ctypes.Structure):
    """``FaParams`` of csrc/fused_agg.cu, passed to the kernel by value."""

    _fields_ = [
        ("col", ctypes.c_uint64 * MAX_COLS),
        ("nul", ctypes.c_uint64 * MAX_COLS),
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
        lib.fa_params_size.restype = ctypes.c_int
        lib.fa_grid.restype = ctypes.c_int
        lib.fa_threads.restype = ctypes.c_int
        lib.fa_launch_partials.argtypes = [vp, vp, vp]
        lib.fa_launch_partials.restype = ctypes.c_int
        lib.fa_launch_combine.argtypes = [vp, vp, ctypes.c_int, vp, vp, vp, vp, vp]
        lib.fa_launch_combine.restype = ctypes.c_int
        if lib.fa_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError(
                f"FaParams layout mismatch: kernel {lib.fa_params_size()} bytes, "
                f"wrapper {ctypes.sizeof(_Params)}")
        _lib = lib
    return _lib


def kernel_grid() -> tuple[int, int]:
    """(blocks, threads) of ``fused_agg_partials`` — fixed, not data-sized."""
    lib = _kernels()
    return lib.fa_grid(), lib.fa_threads()


def _check_image(prog: Program, img: Image) -> None:
    if img.device.type != "cuda":
        raise ValueError(f"the kernel needs a CUDA image, got {img.device}")
    if len(img.cols) != len(prog.col_f64) or len(img.nulls) != len(prog.col_f64):
        raise ValueError("image columns do not match the program")
    shape = (img.n_blocks, img.block_rows)
    for j, (c, nl) in enumerate(zip(img.cols, img.nulls)):
        want = _lane_dtype(prog.col_f64[j])
        if c.device != img.device or c.dtype != want or tuple(c.shape) != shape \
                or not c.is_contiguous():
            raise ValueError(f"column {j}: need contiguous {want} {shape} on {img.device}")
        if nl is not None and (nl.device != img.device or nl.dtype != torch.bool
                               or tuple(nl.shape) != shape or not nl.is_contiguous()):
            raise ValueError(f"null mask {j}: need contiguous bool {shape} on {img.device}")
    nv = img.n_valids
    if not isinstance(nv, int) and (nv.device != img.device or nv.dtype != torch.int64
                                    or tuple(nv.shape) != (img.n_blocks,) or not nv.is_contiguous()):
        raise ValueError(f"n_valids: need contiguous int64 ({img.n_blocks},) on {img.device}")


def launch_partials(prog: Program, img: Image, scratch: torch.Tensor) -> None:
    """Launch ``fused_agg_partials`` into ``scratch`` ([grid, n_aggs, 2] int64)."""
    _check_image(prog, img)
    lib = _kernels()
    grid, _threads = kernel_grid()
    if scratch.device != img.device or scratch.dtype != torch.int64 \
            or tuple(scratch.shape) != (grid, len(prog.aggs), 2) or not scratch.is_contiguous():
        raise ValueError("scratch: need contiguous int64 [grid, n_aggs, 2] on the image's device")
    p = program_params(prog)
    for j, (c, nl) in enumerate(zip(img.cols, img.nulls)):
        p.col[j] = c.data_ptr()
        p.nul[j] = 0 if nl is None else nl.data_ptr()
    if isinstance(img.n_valids, int):
        p.n_valids, p.n_valid_all = 0, img.n_valids
    else:
        p.n_valids = img.n_valids.data_ptr()
    p.n_blocks, p.block_rows = img.n_blocks, img.block_rows
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.fa_launch_partials(ctypes.byref(p), scratch.data_ptr(), stream)
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
    grid, _threads = kernel_grid()
    scratch = torch.empty((grid, len(prog.aggs), 2), dtype=torch.int64, device=img.device)
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

