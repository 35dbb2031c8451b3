"""The selection mask: bytecode, plain version, CUDA launcher.

One pass over a columnar image evaluates a plan's selection conjuncts per
row and writes the row mask ``valid & AND_i (sel_i != 0 & ~null_i)``, a bool
``[n_blocks, block_rows]`` (False past each block's ``n_valid``).  It
replaces the JAX package's ``jax_eval.mask`` (``_build_mask_fn``), with
``rpn.eval_rpn`` inlined: the program is :func:`fused_agg.emit_program`'s
bytecode with the conjuncts and no aggregate.

* ``fused_mask_plain`` walks the bytecode with vectorised torch ops; it
  serves CPU tensors.
* ``launch_mask`` launches ``fused_mask`` of ``csrc/fused_scan.cu`` on the
  tensors' stream: :data:`MASK_ROWS` rows a thread, the instance whose
  stack holds the plan (the kernel library reads its depth from the code),
  over a grid the kernel library sizes to the card.
* ``fused_mask`` takes the plain version for a CPU image and the kernel for a
  CUDA image; on a CUDA tensor it launches the kernel or raises.

The parameter block and the library loader of ``csrc/fused_scan.cu`` live
here; ``copr/fused_topn.py`` shares them.  So does :func:`decode_column`,
the launcher of program #1 alone (``csrc/fused_scan.cu:decode_column``, the
column load every kernel inlines): the checks hold the load to
``kernels.decode_device_column`` and time it with it; no query path calls it.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_agg import (
    LAUNCHES,
    MAX_CODE,
    MAX_COLS,
    MAX_CONSTS,
    Image,
    Program,
    _Enc,
    check_columns,
    compile_program,
    set_columns,
    walk_rows,
)
from .kernels import decode_device_column

# limits of csrc/fused_scan.cu
MAX_KEYS = 4
MAX_PAYLOAD = 16
SMEM_MAX = 232448
MASK_THREADS = 256
MASK_ROWS = 4  # rows a mask thread walks at once (SC_MASK_ROWS)
TOPN_STEP_ROWS = 1024  # rows a top-K candidate block walks at once (TN_THREADS * TN_ROWS)
TOPN_STEPS = 4  # such steps a tile holds at most (TN_STEPS)
MERGE_FAN_MAX = 64  # runs a topn_merge block merges at most (TN_FAN_MAX)
DECODE_GRID_MAX = 4096


def compile_mask_program(sel_rpns, ship_cols, schema) -> Program:
    """The mask's program: the conjuncts over the shipped columns
    ``ship_cols`` (schema indices, in slot order), no aggregate."""
    return compile_program(sel_rpns, [], ship_cols, schema)


def fused_mask_plain(prog: Program, img: Image) -> torch.Tensor:
    """The plain PyTorch version: the same bytecode, vectorised over rows."""
    return walk_rows(prog, img, 0)[1].reshape(img.n_blocks, img.block_rows)


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

class _ScParams(ctypes.Structure):
    """``ScParams`` of csrc/fused_scan.cu, passed to the kernels by value."""

    _fields_ = [
        ("col", ctypes.c_uint64 * MAX_COLS),
        ("nul", ctypes.c_uint64 * MAX_COLS),
        ("enc", _Enc),
        ("n_valids", ctypes.c_uint64),
        ("n_valid_all", ctypes.c_int64),
        ("n_blocks", ctypes.c_int64),
        ("block_rows", ctypes.c_int64),
        ("src_base", ctypes.c_int64),
        ("consts", ctypes.c_int64 * MAX_CONSTS),
        ("code", ctypes.c_int32 * MAX_CODE),
        ("n_code", ctypes.c_int32),
        ("n_cols", ctypes.c_int32),
        ("n_keys", ctypes.c_int32),
        ("k", ctypes.c_int32),
        ("tile", ctypes.c_int32),
        ("key_desc", ctypes.c_int32 * MAX_KEYS),
        ("key_f64", ctypes.c_int32 * MAX_KEYS),
    ]


def scan_params(prog, img: Image) -> _ScParams:
    """The walk's part of the parameter block: ``prog``'s bytecode (a
    :class:`Program` or a top-K program) and ``img``'s columns."""
    check_columns(prog.col_f64, img)
    p = _ScParams()
    p.consts[: len(prog.consts)] = prog.consts
    p.code[: len(prog.code)] = prog.code
    p.n_code = len(prog.code)
    p.n_cols = len(prog.col_f64)
    set_columns(p, img)
    if isinstance(img.n_valids, int):
        p.n_valids, p.n_valid_all = 0, img.n_valids
    else:
        p.n_valids = img.n_valids.data_ptr()
    p.n_blocks, p.block_rows = img.n_blocks, img.block_rows
    return p


class _TpParams(ctypes.Structure):
    """``TpParams`` of csrc/fused_scan.cu (``topn_pack``)."""

    _fields_ = [
        ("col", ctypes.c_uint64 * MAX_PAYLOAD),
        ("nul", ctypes.c_uint64 * MAX_PAYLOAD),
        ("enc", _Enc),
        ("carry_i", ctypes.c_uint64),
        ("carry_f", ctypes.c_uint64),
        ("run", ctypes.c_uint64),
        ("out_i", ctypes.c_uint64),
        ("out_f", ctypes.c_uint64),
        ("out_run", ctypes.c_uint64),
        ("src_base", ctypes.c_int64),
        ("block_rows", ctypes.c_int64),
        ("k", ctypes.c_int32),
        ("n_words", ctypes.c_int32),
        ("n_pay", ctypes.c_int32),
        ("pay_f64", ctypes.c_int32 * MAX_PAYLOAD),
        ("pay_row", ctypes.c_int32 * MAX_PAYLOAD),
        ("pay_null_row", ctypes.c_int32 * MAX_PAYLOAD),
    ]


_lib = None


def kernels():
    """The built ``fused_scan`` library, with its C signatures declared and
    its parameter blocks' layouts checked."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_scan")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn in ("sc_params_size", "tp_params_size", "tn_smem_max", "sc_mask_rows",
                   "tn_step_rows"):
            getattr(lib, fn).restype = ci
        lib.sc_launch_mask.argtypes = [vp, vp, vp]
        lib.sc_mask_attributes.argtypes = [vp, vp]
        lib.tn_launch_candidates.argtypes = [vp, vp, ci, ci, ci, vp]
        lib.tn_candidates_attributes.argtypes = [ci, vp]
        lib.tn_launch_merge.argtypes = [vp, cll, vp, vp, ci, ci, ci, vp]
        lib.tn_merge_staged.argtypes = [ci, ci, ci]
        lib.tn_merge_attributes.argtypes = [ci, ci, vp]
        lib.tn_launch_pack.argtypes = [vp, vp]
        lib.tp_attributes.argtypes = [vp]
        lib.dc_launch.argtypes = [vp, vp, vp, ci, vp]
        for fn in ("sc_launch_mask", "sc_mask_attributes", "tn_launch_candidates",
                   "tn_candidates_attributes", "tn_launch_merge", "tn_launch_pack",
                   "dc_launch", "tn_merge_staged", "tn_merge_attributes", "tn_fan_max",
                   "tp_attributes"):
            getattr(lib, fn).restype = ci
        for name, want, got in (("ScParams", ctypes.sizeof(_ScParams), lib.sc_params_size()),
                                ("TpParams", ctypes.sizeof(_TpParams), lib.tp_params_size())):
            if want != got:
                raise RuntimeError(f"{name} layout mismatch: kernel {got} bytes, wrapper {want}")
        if lib.tn_smem_max() != SMEM_MAX or lib.sc_mask_rows() != MASK_ROWS \
                or lib.tn_step_rows() != TOPN_STEP_ROWS or lib.tn_fan_max() != MERGE_FAN_MAX:
            raise RuntimeError("fused_scan.cu's limits differ from the wrapper's")
        _lib = lib
    return _lib


def check_launch(name: str, rc: int) -> None:
    """Count a launch of kernel ``name`` and raise if it was refused."""
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def launch_mask(prog: Program, img: Image, out: torch.Tensor) -> None:
    """Launch ``fused_mask`` into ``out`` (bool ``[n_blocks, block_rows]``)."""
    p = scan_params(prog, img)
    shape = (img.n_blocks, img.block_rows)
    if out.device != img.device or out.dtype != torch.bool or tuple(out.shape) != shape \
            or not out.is_contiguous():
        raise ValueError(f"mask: need contiguous bool {shape} on {img.device}")
    lib = kernels()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.sc_launch_mask(ctypes.byref(p), out.data_ptr(), stream)
    check_launch("fused_mask", rc)


def mask_attributes(prog: Program, img: Image) -> dict:
    """``cudaFuncGetAttributes`` of the mask instance that runs ``prog``
    over ``img``: registers a thread, local (spilled) bytes a thread,
    static shared bytes a block, and the instance's stack slots."""
    p = scan_params(prog, img)
    out = (ctypes.c_int * 4)()
    rc = kernels().sc_mask_attributes(ctypes.byref(p), out)
    if rc != 0:
        raise RuntimeError(f"fused_mask attributes: cudaError {rc}")
    return {"numRegs": out[0], "localSizeBytes": out[1], "sharedSizeBytes": out[2],
            "stackSlots": out[3]}


def fused_mask(prog: Program, img: Image) -> torch.Tensor:
    """The row mask of ``img``: the plain version for a CPU image, the CUDA
    kernel for a CUDA image."""
    if img.device.type == "cpu":
        return fused_mask_plain(prog, img)
    if img.device.type == "cuda":
        out = torch.empty((img.n_blocks, img.block_rows), dtype=torch.bool, device=img.device)
        if out.numel():
            launch_mask(prog, img, out)
        return out
    raise ValueError(f"no fused_mask for device {img.device}")


# ---------------------------------------------------------------------------
# Program #1 alone: decode_column
# ---------------------------------------------------------------------------

_DECODE_PROGRAM = Program((), (), (False,), (), 1, 0)


def launch_decode(img: Image, out: torch.Tensor, out_nulls: torch.Tensor) -> None:
    """Launch ``decode_column`` over the one column of ``img``: its int64
    lanes into ``out`` and its null bytes into ``out_nulls`` (both
    ``[n_blocks, block_rows]``), through the walk's column load."""
    p = scan_params(_DECODE_PROGRAM, img)
    shape = (img.n_blocks, img.block_rows)
    for t, dt, what in ((out, torch.int64, "lanes"), (out_nulls, torch.bool, "nulls")):
        if t.device != img.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"decoded {what}: need contiguous {dt} {shape} on {img.device}")
    grid = max(1, min(DECODE_GRID_MAX, -(-out.numel() // MASK_THREADS)))
    lib = kernels()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.dc_launch(ctypes.byref(p), out.data_ptr(), out_nulls.data_ptr(), grid, stream)
    check_launch("decode_column", rc)


def decode_column(desc, payload, nulls, ref, n_rows: int):
    """One column's ``(int64 lanes, bool nulls)`` ``[n_blocks, n_rows]`` from
    its ``[n_blocks, ...]`` payload: :func:`kernels.decode_device_column` for
    CPU tensors, the ``decode_column`` kernel for CUDA tensors.  ``nulls``
    None (a NOT NULL column) gives all-False nulls."""
    first = payload[0] if isinstance(payload, tuple) else payload
    n_blocks = first.shape[0]
    if first.device.type == "cpu":
        data, nl = decode_device_column(desc, payload, nulls, ref, n_rows)
        if nl is None:
            nl = torch.zeros((n_blocks, n_rows), dtype=torch.bool)
        return data, nl
    img = Image([payload], [nulls], n_rows, n_blocks, n_rows, first.device,
                descs=(tuple(desc),), refs=(int(ref),))
    out = torch.empty((n_blocks, n_rows), dtype=torch.int64, device=first.device)
    out_nulls = torch.empty((n_blocks, n_rows), dtype=torch.bool, device=first.device)
    if out.numel():
        launch_decode(img, out, out_nulls)
    return out, out_nulls
