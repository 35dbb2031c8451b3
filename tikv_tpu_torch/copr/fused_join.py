"""The join rung's probe kernels: plain versions and CUDA launchers.

Programs #14 and #15 of the JAX package, ``jax_join.rank`` and
``jax_join.hash`` (``tikv_tpu/copr/jax_join.py:_rank_probe``,
``_hash_probe``).  Each gives every probe row a ``(start, count)`` span, two
int64 tensors, into the one stable-sorted build order of the join
(``copr/torch_join.py``):

* :func:`rank_probe` over the sorted int64 build codes: searchsorted left
  and right;
* :func:`hash_probe` over the open-addressing table that
  ``torch_join._build_hash_table`` packs on the host: a Fibonacci hash
  (:func:`hash_slots`) and a linear probe to the key or an empty slot
  (``EMPTY``, which as a probe key matches nothing).

Each takes its plain version for CPU tensors and launches its kernel of
``csrc/fused_join.cu`` for CUDA tensors, or raises.  Unlike the reference,
the inputs are not padded to a power of two: that padding only bucketed
jit compile keys and spans no rows.
"""

from __future__ import annotations

import ctypes

import torch

from .fused_agg import LAUNCHES

MULT = 0x9E3779B97F4A7C15  # Fibonacci hashing multiplier (mod 2**64)
_MULT_I64 = MULT - (1 << 64)  # the same 64 bits as a signed int64
EMPTY = -(1 << 63)  # the open-addressing empty-slot sentinel
GRID_MAX = 8192  # the kernels stride the rows beyond this many blocks


def rank_probe_plain(sorted_keys: torch.Tensor, probe: torch.Tensor):
    """The plain version of ``join_rank_probe``: ``torch.searchsorted``
    left and right."""
    lo = torch.searchsorted(sorted_keys, probe, side="left")
    hi = torch.searchsorted(sorted_keys, probe, side="right")
    return lo, hi - lo


def hash_slots(keys: torch.Tensor, log2_size: int) -> torch.Tensor:
    """Home slots ``(key * MULT mod 2**64) >> (64 - log2_size)`` in int64
    arithmetic: CPU torch has no uint64 multiply or shift, so the product
    wraps as int64 and the arithmetic shift is masked to the slot bits."""
    shift = 64 - log2_size
    return ((keys * _MULT_I64) >> shift) & ((1 << log2_size) - 1)


def _log2_size(table_keys: torch.Tensor) -> int:
    size = table_keys.numel()
    if size < 2 or size & (size - 1):
        raise ValueError(f"hash table size {size} is not a power of two >= 2")
    return size.bit_length() - 1


def hash_probe_plain(table_keys, table_starts, table_counts, probe):
    """The plain version of ``join_hash_probe``: the linear probe over the
    rows still walking, one slot step per round."""
    log2_size = _log2_size(table_keys)
    mask = (1 << log2_size) - 1
    starts = torch.zeros(probe.shape, dtype=torch.int64, device=probe.device)
    counts = torch.zeros_like(starts)
    idx = torch.nonzero(probe != EMPTY).flatten()
    keys = probe[idx]
    slot = hash_slots(keys, log2_size)
    while idx.numel():
        t = table_keys[slot]
        found = t == keys
        starts[idx[found]] = table_starts[slot[found]]
        counts[idx[found]] = table_counts[slot[found]]
        walk = ~found & (t != EMPTY)
        idx, keys, slot = idx[walk], keys[walk], (slot[walk] + 1) & mask
    return starts, counts


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_lib = None


def kernels():
    """The built ``fused_join`` library with its C signatures declared."""
    global _lib
    if _lib is None:
        from .. import _build

        lib = _build.load("fused_join")
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.jn_threads.restype = ci
        lib.jn_launch_rank.argtypes = [vp, cll, vp, cll, vp, vp, ci, vp]
        lib.jn_launch_hash.argtypes = [vp, vp, vp, ci, vp, cll, vp, vp, ci, vp]
        lib.jn_launch_rank.restype = ci
        lib.jn_launch_hash.restype = ci
        _lib = lib
    return _lib


def _check(t: torch.Tensor, dev, what: str) -> None:
    if t.device != dev or t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: need a contiguous 1-D int64 tensor on {dev}")


def _outputs(probe: torch.Tensor):
    n = probe.numel()
    return (torch.empty(n, dtype=torch.int64, device=probe.device),
            torch.empty(n, dtype=torch.int64, device=probe.device))


def _grid(lib, n: int) -> int:
    return max(1, min(GRID_MAX, -(-n // lib.jn_threads())))


def _count(name: str, rc: int) -> None:
    LAUNCHES[name] += 1
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _timed(launch, timing: list | None) -> int:
    """``launch()``, with a pair of CUDA events recorded on the current
    stream right around it and appended to ``timing`` when one is given."""
    if timing is None:
        return launch()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    rc = launch()
    ev1.record()
    timing.append((ev0, ev1))
    return rc


def launch_rank(sorted_keys: torch.Tensor, probe: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, timing: list | None = None) -> None:
    """Launch ``join_rank_probe`` into ``starts`` and ``counts``; with
    ``timing``, append the CUDA events recorded around the launch alone."""
    dev = probe.device
    if dev.type != "cuda":
        raise ValueError(f"join_rank_probe needs CUDA tensors, got {dev}")
    for t, what in ((sorted_keys, "sorted build keys"), (probe, "probe keys"),
                    (starts, "starts"), (counts, "counts")):
        _check(t, dev, what)
    n = probe.numel()
    if starts.numel() != n or counts.numel() != n:
        raise ValueError(f"join_rank_probe: starts and counts need {n} rows")
    lib = kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _timed(lambda: lib.jn_launch_rank(
            sorted_keys.data_ptr(), sorted_keys.numel(), probe.data_ptr(), n, starts.data_ptr(),
            counts.data_ptr(), _grid(lib, n), stream), timing)
    _count("join_rank_probe", rc)


def launch_hash(table_keys, table_starts, table_counts, probe, starts, counts,
                timing: list | None = None) -> None:
    """Launch ``join_hash_probe`` into ``starts`` and ``counts``; with
    ``timing``, as :func:`launch_rank`."""
    dev = probe.device
    if dev.type != "cuda":
        raise ValueError(f"join_hash_probe needs CUDA tensors, got {dev}")
    for t, what in ((table_keys, "table keys"), (table_starts, "table starts"),
                    (table_counts, "table counts"), (probe, "probe keys"),
                    (starts, "starts"), (counts, "counts")):
        _check(t, dev, what)
    log2_size = _log2_size(table_keys)
    if table_starts.numel() != table_keys.numel() or table_counts.numel() != table_keys.numel():
        raise ValueError("join_hash_probe: the table's three arrays differ in size")
    n = probe.numel()
    if starts.numel() != n or counts.numel() != n:
        raise ValueError(f"join_hash_probe: starts and counts need {n} rows")
    lib = kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _timed(lambda: lib.jn_launch_hash(
            table_keys.data_ptr(), table_starts.data_ptr(), table_counts.data_ptr(), log2_size,
            probe.data_ptr(), n, starts.data_ptr(), counts.data_ptr(), _grid(lib, n), stream),
            timing)
    _count("join_hash_probe", rc)


def rank_probe(sorted_keys: torch.Tensor, probe: torch.Tensor, timing: list | None = None):
    """``(starts, counts)`` int64 of each probe code's span over the sorted
    build codes: the plain version for CPU tensors, the kernel for CUDA
    tensors (``timing`` as :func:`launch_rank`)."""
    if probe.device.type == "cpu":
        return rank_probe_plain(sorted_keys, probe)
    if probe.device.type != "cuda":
        raise ValueError(f"no join_rank_probe for device {probe.device}")
    starts, counts = _outputs(probe)
    if probe.numel():
        launch_rank(sorted_keys, probe, starts, counts, timing)
    return starts, counts


def hash_probe(table_keys, table_starts, table_counts, probe, timing: list | None = None):
    """``(starts, counts)`` int64 of each probe key's span, found in the
    open-addressing table: the plain version for CPU tensors, the kernel
    for CUDA tensors (``timing`` as :func:`launch_rank`)."""
    if probe.device.type == "cpu":
        return hash_probe_plain(table_keys, table_starts, table_counts, probe)
    if probe.device.type != "cuda":
        raise ValueError(f"no join_hash_probe for device {probe.device}")
    starts, counts = _outputs(probe)
    if probe.numel():
        launch_hash(table_keys, table_starts, table_counts, probe, starts, counts, timing)
    return starts, counts
