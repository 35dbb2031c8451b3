"""Batched grouped aggregation: the task table, plain versions, CUDA launchers.

The batch half of the port's device path.  It replaces two programs of the
JAX package, both of which fold ``jax_eval._fused_step`` (with
``_mixed_radix_gids``) over several scans at once and pack every state into
one int64 and one f64 matrix for one pull:

* ``jax_eval.run_batch_cached`` (site ``jax_eval.fused_batch``, program #10):
  K aggregation plans over one cached region image;
* ``jax_eval.launch_xregion_cached`` (site ``jax_eval.xregion``, #11): one
  plan over R region images, with per-region dictionary radices and frames
  of reference.

Both are a list of *tasks* here, each one ``(GroupProgram, Image,
capacity)``: the program compiled against the image's shipped columns, with
group ids from dictionary codes (``key_slots``, ``()`` for a single group).
A same-region batch gives K tasks over one image; a cross-region batch R
tasks of one plan, each over its region's image.

* :class:`Batch` lays the tasks out for one launch: each task's CTAs (a
  share of ``BATCH_CTAS`` by its rows), its rows of partials and the packed
  output ``(T, n_int, C)`` / ``(T, n_f64, C)``, padded with zeros to the
  largest task.  A task with more group slots than its shared-memory rows
  hold (``c_max``) is *wide*: it takes no CTA of the batch kernels and is
  served, in the same call, by the grouped pair's wide route
  (``fused_group_agg``: ``group_wide_partials`` + ``group_wide_combine``),
  its state copied into its rows of the output.
* ``batch_partials_plain`` and ``batch_combine_pack_plain`` are the plain
  PyTorch versions of the two kernels, task by task on
  ``fused_group_agg``'s parts; they serve CPU tensors.
* ``launch_batch_partials`` and ``launch_batch_combine_pack`` launch
  ``batch_partials`` and ``batch_combine_pack`` (``csrc/fused_batch.cu``)
  over a descriptor table the wrapper fills and copies to the device per
  batch.
* :func:`fused_batch` takes the plain versions for CPU images and the
  kernels for CUDA images; on a CUDA tensor it launches them or raises.

Task t's packed state is ``ints[t, :n_int, :C]`` and ``flts[t, :n_f64, :C]``
with ``fused_group_agg_combine_pack``'s layout, so the evaluator finalizes
it as it finalizes a unary warm answer.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import fused_agg as fa
from . import fused_group_agg as ga
from .fused_agg import LAUNCHES, Image
from .fused_group_agg import GroupProgram

THREADS = ga.THREADS
WARPS = ga.WARPS
#: the partials CTAs of a whole batch, shared among its tasks by rows: four
#: per SM of an H100, the grouped kernel's grid (``GRID_MAX``)
BATCH_CTAS = ga.GRID_MAX


@dataclass(frozen=True)
class Task:
    """One plan over one image: a rider of a same-region batch, or a region
    of a cross-region batch."""

    prog: GroupProgram
    img: Image
    capacity: int


class _BtTask(ctypes.Structure):
    """``BtTask`` of csrc/fused_batch.cu: one task's descriptor, one entry of
    the table the kernels read from device memory."""

    _fields_ = [
        ("col", ctypes.c_uint64 * fa.MAX_COLS),
        ("nul", ctypes.c_uint64 * fa.MAX_COLS),
        ("enc", fa._Enc),
        ("n_valids", ctypes.c_uint64),
        ("offsets", ctypes.c_uint64),
        ("n_blocks", ctypes.c_int64),
        ("block_rows", ctypes.c_int64),
        ("part0", ctypes.c_int64),
        ("consts", ctypes.c_int64 * fa.MAX_CONSTS),
        ("leaf_ident", ctypes.c_int64 * ga.MAX_LEAVES),
        ("code", ctypes.c_int32 * fa.MAX_CODE),
        ("n_code", ctypes.c_int32),
        ("n_cols", ctypes.c_int32),
        ("n_aggs", ctypes.c_int32),
        ("n_leaves", ctypes.c_int32),
        ("capacity", ctypes.c_int32),
        ("track", ctypes.c_int32),
        ("n_keys", ctypes.c_int32),
        ("cta0", ctypes.c_int32),
        ("n_ctas", ctypes.c_int32),
        ("out_task", ctypes.c_int32),
        ("key_slot", ctypes.c_int32 * ga.MAX_KEYS),
        ("key_dlen", ctypes.c_int32 * ga.MAX_KEYS),
        ("agg_leaf0", ctypes.c_int32 * fa.MAX_AGGS),
        ("agg_nleaves", ctypes.c_int32 * fa.MAX_AGGS),
        ("leaf_kind", ctypes.c_int8 * ga.MAX_LEAVES),
        ("leaf_f64", ctypes.c_int8 * ga.MAX_LEAVES),
        ("leaf_arg_f64", ctypes.c_int8 * ga.MAX_LEAVES),
        ("leaf_slot", ctypes.c_int8 * ga.MAX_LEAVES),
        ("leaf_agg", ctypes.c_int8 * ga.MAX_LEAVES),
        ("leaf_aux", ctypes.c_int8 * ga.MAX_LEAVES),
    ]


#: dynamic shared memory of a partials CTA: the 227 KB less the task's
#: descriptor, which the CTA copies into static shared memory
SMEM_MAX = ga.SMEM_MAX - ctypes.sizeof(_BtTask)


def c_max(prog: GroupProgram) -> int:
    """Most group slots a task of ``prog`` takes on the batch kernels: its
    warps' shared-memory rows, ``WARPS * n_leaves * (32 + C) * 8`` bytes,
    must fit ``SMEM_MAX``.  A task past it is wide."""
    return SMEM_MAX // (WARPS * 8 * len(prog.leaves)) - 32


def check_task(prog: GroupProgram, cap: int) -> None:
    """``ValueError`` for a task the batch does not take: host group ids (a
    batch computes them from dictionary codes) or a capacity outside
    ``[1, 2^31)``."""
    if prog.key_slots is None:
        raise ValueError("a batch takes group ids from dictionary codes, not host ids")
    ga.check_capacity(prog, cap)


class Batch:
    """The launch layout of a list of tasks.  Tasks within ``c_max`` run on
    the batch kernels (``shared``, in task order): each one's share of the
    partials grid (``grids``: at least one CTA, at most one per ``THREADS``
    rows, else ``BATCH_CTAS`` shared by rows, so the grid and each f64 sum's
    order depend on the shapes alone), where its partials start (``part0``,
    int64 words: ``[grid, n_leaves, C]`` each).  Wide tasks (``wide``) have
    a grid of 0.  The packed output is ``(T, li, c_max)`` / ``(T, lf,
    c_max)`` for every task."""

    def __init__(self, tasks):
        self.tasks = list(tasks)
        if not self.tasks:
            raise ValueError("a batch needs at least one task")
        self.device = self.tasks[0].img.device
        for t in self.tasks:
            if t.img.device != self.device:
                raise ValueError("a batch's images must share one device")
            check_task(t.prog, t.capacity)
        self.wide = [i for i, t in enumerate(self.tasks) if t.capacity > c_max(t.prog)]
        self.shared = [i for i in range(len(self.tasks)) if i not in self.wide]
        rows = [0 if i in self.wide else t.img.n_blocks * t.img.block_rows
                for i, t in enumerate(self.tasks)]
        total = max(sum(rows), 1)
        self.grids = [0 if i in self.wide else
                      max(1, min(-(-r // THREADS), -(-BATCH_CTAS * r // total)))
                      for i, r in enumerate(rows)]
        self.cta0, self.part0 = [], []
        cta = part = 0
        for t, g in zip(self.tasks, self.grids):
            self.cta0.append(cta)
            self.part0.append(part)
            cta += g
            part += g * len(t.prog.leaves) * t.capacity
        self.n_ctas, self.n_parts = cta, part
        self.li = max(t.prog.n_int for t in self.tasks)
        self.lf = max(t.prog.n_f64 for t in self.tasks)
        self.c_max = max(t.capacity for t in self.tasks)
        shared = [self.tasks[i] for i in self.shared]
        #: the widest shared task: the combine's words per packed row
        self.c_shared = max((t.capacity for t in shared), default=0)
        self.smem = max((WARPS * len(t.prog.leaves) * (32 + t.capacity) * 8 for t in shared),
                        default=0)

    def __len__(self) -> int:
        return len(self.tasks)

    def parts_of(self, parts: torch.Tensor, i: int) -> torch.Tensor:
        """Task ``i``'s partials, ``[grid, n_leaves, C]``, viewed in ``parts``."""
        t, g = self.tasks[i], self.grids[i]
        n = g * len(t.prog.leaves) * t.capacity
        return parts[self.part0[i] : self.part0[i] + n].view(g, len(t.prog.leaves), t.capacity)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def batch_partials_plain(batch: Batch) -> torch.Tensor:
    """Plain version of ``batch_partials``: each shared task's
    ``fused_group_agg`` partials at its grid, flat, in task order (f64
    leaves summed in another order than the kernel's)."""
    dev = batch.device
    return torch.cat([torch.zeros(0, dtype=torch.int64, device=dev)] + [
        ga.partials_plain(t.prog, t.img, t.capacity, batch.grids[i]).reshape(-1)
        for i, t in ((i, batch.tasks[i]) for i in batch.shared)])


def _new_out(batch: Batch, zero: bool = True):
    """The packed output, zeros or (``zero`` false: every word to be
    written) uninitialised."""
    dev, new = batch.device, torch.zeros if zero else torch.empty
    return (new((len(batch), batch.li, batch.c_max), dtype=torch.int64, device=dev),
            new((len(batch), batch.lf, batch.c_max), dtype=torch.float64, device=dev))


def batch_combine_pack_plain(batch: Batch, parts: torch.Tensor):
    """Plain version of ``batch_combine_pack``: each shared task's partials
    folded in CTA order into its packed state, placed in the zero-padded
    ``(T, li, c_max)`` int64 and ``(T, lf, c_max)`` f64 matrices (a wide
    task's rows stay zero: :func:`fused_batch` fills them)."""
    ints, flts = _new_out(batch)
    for i in batch.shared:
        t = batch.tasks[i]
        pi, pf = ga.combine_plain(t.prog, t.img, t.capacity, batch.parts_of(parts, i))
        ints[i, : t.prog.n_int, : t.capacity] = pi
        flts[i, : t.prog.n_f64, : t.capacity] = pf
    return ints, flts


def _serve_wide(batch: Batch, out) -> None:
    """Each wide task's packed state by the grouped pair (the plain version
    for a CPU image, the wide route's kernels for a CUDA one), copied into
    its rows of ``out``."""
    for i in batch.wide:
        t = batch.tasks[i]
        pi, pf = ga.fused_group_agg(t.prog, t.img, t.capacity)
        out[0][i, : t.prog.n_int, : t.capacity] = pi
        out[1][i, : t.prog.n_f64, : t.capacity] = pf


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

_declared = False


def _kernels():
    """The kernel library (``fused_batch``), its entry points declared and
    the descriptor's layout checked."""
    global _declared
    from .. import _build

    lib = _build.load("fused_batch")
    if not _declared:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bt_task_size.restype = ci
        lib.bt_smem_max.restype = ci
        lib.bt_launch_partials.argtypes = [vp, ci, ci, vp, ci, vp]
        lib.bt_launch_partials.restype = ci
        lib.bt_launch_combine.argtypes = [vp, ci, vp, ci, ci, ci, ci, vp, vp, vp]
        lib.bt_launch_combine.restype = ci
        if lib.bt_task_size() != ctypes.sizeof(_BtTask):
            raise RuntimeError(f"BtTask layout mismatch: kernel {lib.bt_task_size()} bytes, "
                               f"wrapper {ctypes.sizeof(_BtTask)}")
        if lib.bt_smem_max() != SMEM_MAX:
            raise RuntimeError("the kernel's shared-memory limit differs from SMEM_MAX")
        _declared = True
    return lib


def _check_task_image(t: Task) -> None:
    """Raise unless the task's image is what the kernels load: the columns
    under their descriptors (``fa.check_columns``), dictionary codes in the
    key slots, and ``n_valids`` and ``offsets`` as int64 vectors."""
    img, prog = t.img, t.prog
    fa.check_columns(prog.col_f64, img)
    for s in prog.key_slots:
        if prog.col_f64[s] or img.desc(s)[0] not in ("plain", "code"):
            raise ValueError(f"key column slot {s} must hold dictionary codes")
    for name in ("n_valids", "offsets"):
        v = getattr(img, name)
        if not fa._contiguous(v, img.device, (torch.int64,), (img.n_blocks,)):
            raise ValueError(f"{name}: need contiguous int64 ({img.n_blocks},) on {img.device}")


def task_table(batch: Batch):
    """The descriptor table of ``batch``: one ``_BtTask`` per shared task,
    with the task's row of the packed output (``out_task``)."""
    table = (_BtTask * len(batch.shared))()
    for e, i in enumerate(batch.shared):
        t = batch.tasks[i]
        _check_task_image(t)
        prog, img, p = t.prog, t.img, table[e]
        p.out_task = i
        p.consts[: len(prog.consts)] = prog.consts
        p.code[: len(prog.code)] = prog.code
        p.n_code, p.n_cols = len(prog.code), len(prog.col_f64)
        p.n_aggs, p.n_leaves = len(prog.agg_leaves), len(prog.leaves)
        p.capacity, p.track, p.n_keys = t.capacity, int(prog.track), len(prog.key_slots)
        p.key_slot[: p.n_keys] = prog.key_slots
        p.key_dlen[: p.n_keys] = prog.dict_lens
        for k, own in enumerate(prog.agg_leaves):
            p.agg_leaf0[k], p.agg_nleaves[k] = own[0], len(own)
        for l, leaf in enumerate(prog.leaves):
            p.leaf_ident[l], p.leaf_kind[l] = leaf.ident, leaf.kind
            p.leaf_f64[l], p.leaf_arg_f64[l] = int(leaf.is_f64), int(leaf.arg_f64)
            p.leaf_slot[l], p.leaf_agg[l], p.leaf_aux[l] = leaf.slot, leaf.agg, leaf.aux
        fa.set_columns(p, img)
        p.n_valids, p.offsets = img.n_valids.data_ptr(), img.offsets.data_ptr()
        p.n_blocks, p.block_rows = img.n_blocks, img.block_rows
        p.part0, p.cta0, p.n_ctas = batch.part0[i], batch.cta0[i], batch.grids[i]
    return table


def upload_table(batch: Batch) -> torch.Tensor:
    """The descriptor table in device memory: filled on the host, staged in
    pinned memory and copied on the current stream, without a sync."""
    table = task_table(batch)
    host = torch.empty(ctypes.sizeof(table), dtype=torch.uint8, pin_memory=True)
    ctypes.memmove(host.data_ptr(), ctypes.addressof(table), ctypes.sizeof(table))
    return host.to(batch.device, non_blocking=True)


def _check_table(batch: Batch, table: torch.Tensor) -> None:
    if table.device != batch.device or table.dtype != torch.uint8 or not table.is_contiguous() \
            or table.numel() != len(batch.shared) * ctypes.sizeof(_BtTask):
        raise ValueError("table: need the batch's descriptors (upload_table) on its device")


def launch_batch_partials(batch: Batch, table: torch.Tensor, parts: torch.Tensor) -> None:
    """Launch ``batch_partials`` into ``parts`` (``n_parts`` int64 words)."""
    if batch.device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA images, got {batch.device}")
    _check_table(batch, table)
    if parts.device != batch.device or parts.dtype != torch.int64 \
            or tuple(parts.shape) != (batch.n_parts,) or not parts.is_contiguous():
        raise ValueError(f"partials: need contiguous int64 ({batch.n_parts},) on {batch.device}")
    lib = _kernels()
    with torch.cuda.device(batch.device):
        stream = torch.cuda.current_stream(batch.device).cuda_stream
        rc = lib.bt_launch_partials(table.data_ptr(), len(batch.shared), batch.n_ctas,
                                    parts.data_ptr(), batch.smem, stream)
    LAUNCHES["batch_partials"] += 1
    if rc != 0:
        raise RuntimeError(f"batch_partials launch failed: cudaError {rc}")


def launch_batch_combine_pack(batch: Batch, table: torch.Tensor, parts: torch.Tensor,
                              out) -> None:
    """Launch ``batch_combine_pack``: fold each shared task's partials into
    its packed state in ``out``, ``(T, li, c_max)`` int64 and ``(T, lf,
    c_max)`` f64, padding zeros up to ``c_shared`` slots (``out`` is zero
    past them)."""
    dev = batch.device
    _check_table(batch, table)
    if parts.device != dev or parts.dtype != torch.int64 \
            or tuple(parts.shape) != (batch.n_parts,) or not parts.is_contiguous():
        raise ValueError(f"partials: need contiguous int64 ({batch.n_parts},) on {dev}")
    for t, dt, rows in zip(out, (torch.int64, torch.float64), (batch.li, batch.lf)):
        shape = (len(batch), rows, batch.c_max)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"packed state: need contiguous {dt} {shape} on {dev}")
    lib = _kernels()
    ints, flts = out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bt_launch_combine(table.data_ptr(), len(batch.shared), parts.data_ptr(),
                                   batch.li, batch.lf, batch.c_shared, batch.c_max,
                                   ints.data_ptr(), flts.data_ptr() if flts.numel() else None,
                                   stream)
    LAUNCHES["batch_combine_pack"] += 1
    if rc != 0:
        raise RuntimeError(f"batch_combine_pack launch failed: cudaError {rc}")


def fused_batch(tasks) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed states of every task: ``(T, li, c_max)`` int64 and
    ``(T, lf, c_max)`` f64, by the plain versions for CPU images and by the
    kernels on the images' current stream, with no host synchronisation,
    for CUDA images: the batch kernels for the shared tasks, the grouped
    pair's wide route for the wide ones."""
    batch = Batch(tasks)
    dev = batch.device
    if dev.type == "cpu":
        out = batch_combine_pack_plain(batch, batch_partials_plain(batch))
    elif dev.type != "cuda":
        raise ValueError(f"no fused_batch for device {dev}")
    else:
        # batch_combine_pack writes all c_shared slots of every row, which is
        # every word when no task is wide
        out = _new_out(batch, zero=bool(batch.wide))
        if batch.shared:
            table = upload_table(batch)
            parts = torch.empty(batch.n_parts, dtype=torch.int64, device=dev)
            launch_batch_partials(batch, table, parts)
            launch_batch_combine_pack(batch, table, parts, out)
    _serve_wide(batch, out)
    return out
