"""The in-place patch of a pinned stacked image: plain version and CUDA launcher.

The device work of the JAX package's write-through deltas,
``ColumnBlockCache.scatter_update`` through ``_patch_stacked``
(``tikv_tpu/copr/cache.py:186, :241``): after a committed write changes rows
of a region in place, the new values and null flags are written into the
image's pinned ``("stacked", ...)`` lanes on the card, with no round trip of
the image.

:func:`pin_updates` turns a delta (``block -> (rows, {column: (values,
nulls)})``) into one patch of one pin: the flat positions ``block *
block_rows + row`` and, per patched lane, its values cast to the lane's
dtype (int64, or f64 for REAL) as 8-byte words and its null flags.
:func:`patch_stacked` writes them: the plain version (``index_put_`` per
lane on the flattened view) for CPU tensors, one launch of
``patch_stacked`` of ``csrc/fused_patch.cu`` for CUDA tensors, or raises.
A delta's handles are unique, so its positions are; the wrapper checks that
on the host and raises otherwise, and the kernel needs no ordering.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .fused_agg import LAUNCHES

MAX_LANES = 16  # data lanes and null lanes each: the device-column limit (fused_agg.py)
GRID_MAX = 8192  # the kernel strides the (lane, update) pairs beyond this many blocks
_LANE_NP = {torch.int64: np.int64, torch.float64: np.float64}


def pin_updates(entry, sig: tuple, updates: dict):
    """``(data lanes, null lanes, positions, values, nulls)`` patching the
    stacked pin ``entry`` (data per shipped column, null mask per shipped
    column or None) under ``sig = ("stacked", ship, nullable, block_rows,
    device)`` with ``updates``: every updated block must carry the same
    columns (a delta decodes whole rows).  ``values`` is int64 ``[lanes,
    U]`` holding each lane's words, ``nulls`` bool ``[null lanes, U]``."""
    _, ship, _nullable, br, _dev = sig
    data, nulls = entry
    order = sorted(updates)
    col_sets = {frozenset(updates[bi][1]) for bi in order}
    if len(col_sets) > 1:
        raise ValueError("a delta must update the same columns in every block")
    touched = col_sets.pop() if col_sets else frozenset()
    pos = np.concatenate([bi * br + np.asarray(updates[bi][0], dtype=np.int64)
                          for bi in order]) if order else np.empty(0, dtype=np.int64)
    lanes, vals, null_lanes, nls = [], [], [], []
    for j, ci in enumerate(ship):
        if ci not in touched:
            continue
        lane = data[j]
        words = np.concatenate([np.asarray(updates[bi][1][ci][0]).astype(_LANE_NP[lane.dtype])
                                for bi in order])
        lanes.append(lane)
        vals.append(words.view(np.int64))
        if nulls[j] is not None:
            null_lanes.append(nulls[j])
            nls.append(np.concatenate([np.asarray(updates[bi][1][ci][1], dtype=bool)
                                       for bi in order]))
    return (lanes, null_lanes, pos, np.array(vals, dtype=np.int64).reshape(len(lanes), len(pos)),
            np.array(nls, dtype=bool).reshape(len(null_lanes), len(pos)))


def patch_stacked_plain(lanes, null_lanes, pos: torch.Tensor, vals: torch.Tensor,
                        nls: torch.Tensor) -> None:
    """The plain version of ``patch_stacked``: ``index_put_`` per lane on
    its flattened view, the words reinterpreted as the lane's dtype."""
    for j, lane in enumerate(lanes):
        lane.view(-1).index_put_((pos,), vals[j].view(lane.dtype))
    for j, lane in enumerate(null_lanes):
        lane.view(-1).index_put_((pos,), nls[j])


def _check(lanes, null_lanes, pos: np.ndarray, vals: np.ndarray, nls: np.ndarray):
    if len(lanes) > MAX_LANES or len(null_lanes) > MAX_LANES:
        raise ValueError(f"patch_stacked: at most {MAX_LANES} data and {MAX_LANES} null lanes")
    every = list(lanes) + list(null_lanes)
    if not every:
        return None
    dev, numel = every[0].device, every[0].numel()
    for t in lanes:
        if t.dtype not in _LANE_NP:
            raise ValueError(f"patch_stacked: a data lane must be int64 or float64, not {t.dtype}")
    for t in null_lanes:
        if t.dtype != torch.bool:
            raise ValueError("patch_stacked: a null lane must be bool")
    for t in every:
        if t.device != dev or t.numel() != numel or not t.is_contiguous():
            raise ValueError("patch_stacked: lanes must be contiguous, of one size, on one device")
    if pos.ndim != 1 or vals.shape != (len(lanes), len(pos)) \
            or nls.shape != (len(null_lanes), len(pos)):
        raise ValueError("patch_stacked: positions, values and nulls disagree in shape")
    if len(pos) and (pos.min() < 0 or pos.max() >= numel):
        raise ValueError("patch_stacked: a position lies outside the lanes")
    if len(np.unique(pos)) != len(pos):
        raise ValueError("patch_stacked: positions must be unique")
    return dev


def patch_stacked(lanes, null_lanes, pos: np.ndarray, vals: np.ndarray, nls: np.ndarray) -> None:
    """Write ``vals`` (int64 words, ``[lanes, U]``) and ``nls`` (bool,
    ``[null lanes, U]``) at the flat positions ``pos`` of each lane, in
    place: the plain version for CPU lanes, one launch of the kernel for
    CUDA lanes."""
    dev = _check(lanes, null_lanes, np.asarray(pos), np.asarray(vals), np.asarray(nls))
    if dev is None or not len(pos):
        return
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no patch_stacked for device {dev}")
    args = (torch.from_numpy(np.ascontiguousarray(pos, dtype=np.int64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(vals, dtype=np.int64)).to(dev),
            torch.from_numpy(np.ascontiguousarray(nls, dtype=bool)).to(dev))
    if dev.type == "cpu":
        patch_stacked_plain(lanes, null_lanes, *args)
    else:
        launch(lanes, null_lanes, *args)


# ---------------------------------------------------------------------------
# CUDA launcher
# ---------------------------------------------------------------------------

_lib = None


def kernels():
    """The built ``fused_patch`` library with its C signatures declared."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_patch")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.fp_threads.restype = ci
        lib.fp_max_lanes.restype = ci
        lib.fp_launch.argtypes = [vp, ci, vp, ci, vp, cll, vp, vp, ci, vp]
        lib.fp_launch.restype = ci
        if lib.fp_max_lanes() != MAX_LANES:
            raise RuntimeError("fused_patch.cu and fused_patch.py disagree on the lane limit")
        _lib = lib
    return _lib


def launch(lanes, null_lanes, pos: torch.Tensor, vals: torch.Tensor, nls: torch.Tensor) -> None:
    """One launch of ``patch_stacked`` over device tensors already checked
    by :func:`patch_stacked` (the positions unique and inside the lanes)."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"patch_stacked needs CUDA tensors, got {dev}")
    for t in (pos, vals, nls, *lanes, *null_lanes):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("patch_stacked: contiguous update tensors on the lanes' device")
    if pos.dtype != torch.int64 or vals.dtype != torch.int64 or nls.dtype != torch.bool:
        raise ValueError("patch_stacked: int64 positions and words, bool nulls")
    n = pos.numel()
    lib = kernels()
    data_ptrs = (ctypes.c_ulonglong * MAX_LANES)(*[t.data_ptr() for t in lanes])
    null_ptrs = (ctypes.c_ulonglong * MAX_LANES)(*[t.data_ptr() for t in null_lanes])
    total = n * (len(lanes) + len(null_lanes))
    grid = max(1, min(GRID_MAX, -(-total // lib.fp_threads())))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fp_launch(ctypes.addressof(data_ptrs), len(lanes), ctypes.addressof(null_ptrs),
                           len(null_lanes), pos.data_ptr(), n, vals.data_ptr(), nls.data_ptr(),
                           grid, stream)
    if rc != 0:
        raise RuntimeError(f"patch_stacked launch failed: cudaError {rc}")
    LAUNCHES["patch_stacked"] += 1
