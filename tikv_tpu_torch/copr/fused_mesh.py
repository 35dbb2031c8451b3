"""The cross-shard merge of the mesh path: tables, plain version, CUDA launcher.

It replaces the collectives of the JAX package's mesh programs
(``parallel/mesh.py``: ``_collective`` and ``_combine``, the psum, pmin,
pmax and gather-and-fold over the ``regions`` axis) in ``mesh.agg_step``
and ``mesh.xshard``.  The shards' packed states (``fused_group_agg``'s
layout: ``[n_int, C]`` int64, ``[n_f64, C]`` f64) are stacked on the merging
device as *parts*, ``(P, n_int, C)`` and ``(P, n_f64, C)``; a *table*, int32
``(R, max_parts)``, lists for each output region the part rows to fold, in
order, -1 for an empty entry.

* :func:`mesh_merge_plain` folds each region's parts leaf by leaf through
  ``fused_group_agg._merge`` from the leaf's identity, in the table's order,
  then combines the result into the carry; it serves CPU tensors.
* :func:`launch_mesh_merge` launches ``mesh_merge`` (``csrc/fused_mesh.cu``).
* :func:`mesh_merge` takes the plain version for CPU parts and the kernel
  for CUDA parts; on a CUDA tensor it launches the kernel or raises.

The output holds the slot window ``[lo, hi)`` of every region:
``(R, n_int, hi - lo)`` and ``(R, n_f64, hi - lo)``; a carry has the
output's shape and may be the output itself.  With ``perm`` (int32
``[C]``, nondecreasing; the whole window only) the carry's slot ``i`` goes
to slot ``perm[i]`` (dropped at ``perm[i] >= C``), a slot that no carry slot
moves to starting from its identity: the remap of ``mesh.grouped_step``
(``mesh.py:413-433``) when new keys reshuffle the sorted group dictionary;
the output may then not be the carry.  ``first``'s value leaf has no
merge rule (its carry is a paired argmin): :func:`check_mergeable` refuses
a program that holds it, as the JAX package's ``_require_mesh_mergeable``
refuses the plan.
"""

from __future__ import annotations

import ctypes

import torch

from . import fused_group_agg as ga
from .fused_agg import LAUNCHES
from .fused_group_agg import LEAF_FIRSTVAL, GroupProgram

MAX_LEAVES = ga.MAX_LEAVES


def check_mergeable(prog: GroupProgram) -> None:
    """Raise ``ValueError`` for a program with a leaf that has no merge rule."""
    if any(leaf.kind == LEAF_FIRSTVAL for leaf in prog.leaves):
        raise ValueError("aggregate 'first' has no mesh merge rule")


def merge_table(region_parts, n_parts: int, device) -> torch.Tensor:
    """The int32 ``(R, max_parts)`` table of ``region_parts`` (per region,
    its part rows in fold order, each below ``n_parts``), padded with -1, on
    ``device``.  The rows are checked here, on the host: the kernel trusts
    them."""
    if any(not 0 <= q < n_parts for p in region_parts for q in p):
        raise ValueError(f"merge table: part rows must lie in 0..{n_parts - 1}")
    width = max([1] + [len(p) for p in region_parts])
    rows = [list(p) + [-1] * (width - len(p)) for p in region_parts]
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _window(parts, lo: int, hi) -> tuple[int, int]:
    cap = parts[0].shape[2]
    hi = cap if hi is None else hi
    if not 0 <= lo < hi <= cap:
        raise ValueError(f"slot window [{lo}, {hi}) outside 0..{cap}")
    return lo, hi


def _check_perm(perm, lo: int, hi: int, cap: int, dev) -> None:
    if perm is None:
        return
    if (lo, hi) != (0, cap):
        raise ValueError("perm: the carry remap takes the whole slot window")
    if perm.device != dev or perm.dtype != torch.int32 or tuple(perm.shape) != (cap,) \
            or not perm.is_contiguous():
        raise ValueError(f"perm: need contiguous int32 ({cap},) on {dev}")


def _carry_slots(perm: torch.Tensor) -> torch.Tensor:
    """Per output slot, the first carry slot that ``perm`` moves to it, or
    ``C`` for none."""
    cap = perm.numel()
    src = torch.full((cap + 1,), cap, dtype=torch.int64, device=perm.device)
    dst = perm.to(torch.int64).clamp(max=cap)  # a dropped slot lands on the spare entry
    src.scatter_reduce_(0, dst, torch.arange(cap, device=perm.device), "amin")
    return src[:cap]


def mesh_merge_plain(prog: GroupProgram, parts, table: torch.Tensor, carry=None, lo: int = 0,
                     hi: int | None = None, perm: torch.Tensor | None = None):
    """Plain version of ``mesh_merge``: ``(R, n_int, hi - lo)`` int64 and
    ``(R, n_f64, hi - lo)`` f64, each region's parts folded in the table's
    order from the identity, then ``_merge(carry, folded)`` (the carry
    remapped through ``perm`` first)."""
    check_mergeable(prog)
    lo, hi = _window(parts, lo, hi)
    _check_perm(perm, lo, hi, parts[0].shape[2], table.device)
    moved = None if perm is None or carry is None else _carry_slots(perm)
    n_regions = table.shape[0]
    listed = table >= 0
    rows = table.clamp(min=0).to(torch.int64)
    out = [torch.empty((n_regions, prog.n_int, hi - lo), dtype=torch.int64, device=table.device),
           torch.empty((n_regions, prog.n_f64, hi - lo), dtype=torch.float64,
                       device=table.device)]
    for leaf in prog.leaves:
        m = 1 if leaf.is_f64 else 0
        vals = parts[m][:, leaf.slot, lo:hi][rows]  # (R, max_parts, width)
        acc = torch.full((n_regions, hi - lo), leaf.ident_value, dtype=vals.dtype,
                         device=vals.device)
        for q in range(table.shape[1]):
            acc = torch.where(listed[:, q, None], ga._merge(leaf, acc, vals[:, q]), acc)
        if carry is not None:
            c = carry[m][:, leaf.slot]
            if moved is not None:
                c = torch.where(moved < c.shape[1], c[:, moved.clamp(max=c.shape[1] - 1)],
                                torch.full((), leaf.ident_value, dtype=c.dtype))
            acc = ga._merge(leaf, c, acc)
        out[m][:, leaf.slot] = acc
    return out[0], out[1]


class _MmParams(ctypes.Structure):
    """``MmParams`` of csrc/fused_mesh.cu, passed to the kernel by value."""

    _fields_ = [
        ("parts_i", ctypes.c_uint64),
        ("parts_f", ctypes.c_uint64),
        ("table", ctypes.c_uint64),
        ("carry_i", ctypes.c_uint64),
        ("carry_f", ctypes.c_uint64),
        ("out_i", ctypes.c_uint64),
        ("out_f", ctypes.c_uint64),
        ("perm", ctypes.c_uint64),
        ("leaf_ident", ctypes.c_int64 * MAX_LEAVES),
        ("n_regions", ctypes.c_int32),
        ("max_parts", ctypes.c_int32),
        ("n_int", ctypes.c_int32),
        ("n_f64", ctypes.c_int32),
        ("capacity", ctypes.c_int32),
        ("lo", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("n_leaves", ctypes.c_int32),
        ("leaf_kind", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_f64", ctypes.c_int8 * MAX_LEAVES),
        ("leaf_slot", ctypes.c_int8 * MAX_LEAVES),
    ]


_lib = None


def _kernels():
    """The kernel library (``fused_mesh``), its entry point declared and the
    parameter block's layout checked."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_mesh")
        lib.mm_params_size.restype = ctypes.c_int
        lib.mm_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mm_launch.restype = ctypes.c_int
        if lib.mm_params_size() != ctypes.sizeof(_MmParams):
            raise RuntimeError(f"MmParams layout mismatch: kernel {lib.mm_params_size()} bytes, "
                               f"wrapper {ctypes.sizeof(_MmParams)}")
        _lib = lib
    return _lib


def _check(t, dtype, shape, dev, what: str) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous {dtype} {tuple(shape)} on {dev}")


def launch_mesh_merge(prog: GroupProgram, parts, table: torch.Tensor, carry, lo: int,
                      hi: int | None, out, perm: torch.Tensor | None = None) -> None:
    """Launch ``mesh_merge`` into ``out`` (:func:`mesh_merge`'s shapes)."""
    check_mergeable(prog)
    lo, hi = _window(parts, lo, hi)
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"mesh_merge needs CUDA tensors, got {dev}")
    n_parts, _n, cap = parts[0].shape
    _check_perm(perm, lo, hi, cap, dev)
    if perm is not None and carry is not None and any(
            o.numel() and o.data_ptr() == c.data_ptr() for o, c in zip(out, carry)):
        raise ValueError("mesh_merge: with perm the output may not be the carry")
    _check(parts[0], torch.int64, (n_parts, prog.n_int, cap), dev, "parts")
    _check(parts[1], torch.float64, (n_parts, prog.n_f64, cap), dev, "f64 parts")
    if table.dtype != torch.int32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table: need a contiguous int32 (R, max_parts) matrix")
    n_regions = table.shape[0]
    for packed, what in ((out, "output"),) if carry is None else ((out, "output"),
                                                                 (carry, "carry")):
        _check(packed[0], torch.int64, (n_regions, prog.n_int, hi - lo), dev, what)
        _check(packed[1], torch.float64, (n_regions, prog.n_f64, hi - lo), dev, f"f64 {what}")
    p = _MmParams()

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else 0

    p.parts_i, p.parts_f, p.table = ptr(parts[0]), ptr(parts[1]), table.data_ptr()
    if carry is not None:
        p.carry_i, p.carry_f = ptr(carry[0]), ptr(carry[1])
    p.out_i, p.out_f = ptr(out[0]), ptr(out[1])
    p.perm = 0 if perm is None else perm.data_ptr()
    p.n_regions, p.max_parts = n_regions, table.shape[1]
    p.n_int, p.n_f64, p.capacity = prog.n_int, prog.n_f64, cap
    p.lo, p.width, p.n_leaves = lo, hi - lo, len(prog.leaves)
    for l, leaf in enumerate(prog.leaves):
        p.leaf_ident[l], p.leaf_kind[l] = leaf.ident, leaf.kind
        p.leaf_f64[l], p.leaf_slot[l] = int(leaf.is_f64), leaf.slot
    lib = _kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mm_launch(ctypes.byref(p), stream)
    LAUNCHES["mesh_merge"] += 1
    if rc != 0:
        raise RuntimeError(f"mesh_merge launch failed: cudaError {rc}")


def mesh_merge(prog: GroupProgram, parts, table: torch.Tensor, carry=None, lo: int = 0,
               hi: int | None = None, out=None, perm: torch.Tensor | None = None):
    """Each region's listed parts folded in the table's order, combined into
    ``carry`` (None: no carry; remapped through ``perm`` when given), over
    the slots ``[lo, hi)``: the plain version for CPU tensors, the kernel on
    the tensors' current stream, with no host synchronisation, for CUDA
    tensors.  Writes ``out`` (allocated when None; it may be ``carry``
    without a ``perm``) and returns it."""
    dev = table.device
    if dev.type == "cpu":
        res = mesh_merge_plain(prog, parts, table, carry, lo, hi, perm)
        if out is None:
            return res
        out[0].copy_(res[0])
        out[1].copy_(res[1])
        return out
    if dev.type != "cuda":
        raise ValueError(f"no mesh_merge for device {dev}")
    lo, hi = _window(parts, lo, hi)
    if out is None:
        out = (torch.empty((table.shape[0], prog.n_int, hi - lo), dtype=torch.int64, device=dev),
               torch.empty((table.shape[0], prog.n_f64, hi - lo), dtype=torch.float64,
                           device=dev))
    launch_mesh_merge(prog, parts, table, carry, lo, hi, out, perm)
    return out
