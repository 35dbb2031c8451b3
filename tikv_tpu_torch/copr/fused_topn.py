"""The running top-K of a raw TopN: key encoding, plain versions, CUDA launchers.

It replaces the JAX package's ``jax_eval.topn`` (``_build_topn_fn`` and its
step ``_topn_step``, key operands ``_topn_key_operands``) and
``jax_eval.pack_topn`` (``_pack_leaves``), with ``rpn.eval_rpn`` inlined.
One step folds an image (a cold block, or the whole warm image) into the
carried best K rows:

1. ``topn_candidates``: per row the walk of the selection and the sort
   keys gives an *entry*, a tuple of 64-bit words compared as unsigned,
   lexicographically: rank (0: the row passed the selection, 1: it did not
   or lies past its block's ``n_valid``), then per key its null rank and its
   order-preserving key word, then ``src``, the row's place in the stream
   (``src_base`` + flat row index).  Each tile of ``tile`` rows is sorted and
   its first K entries written as a run ``[n_words, K]``.
2. ``topn_merge``: runs merged pairwise into their first K, level by level,
   until one is left.  The carry of a cold step is one more run whose
   ``src`` is its slot (0..K-1): earlier in the stream than any of the
   block's rows (``src_base`` = K), and in stream order among themselves.
3. ``topn_pack``: the packed state of the final run: int64 row 0 the rank,
   then each payload column's value (int64 rows, or f64 rows) and null flag
   (int64 rows), gathered from the carry or the image for the rank-0
   entries; and the run as the next step's carry.

``src`` is unique, so the order is total: it is ``_topn_step``'s stable sort
with the carry ahead of the block, and the CPU comparator's
(``executors._row_cmp``) order.  A key word is the value made order-preserving
as u64 (int64: sign bit flipped; f64: -0 as +0, then the sign-flip
transform), bit-NOT for a descending key, 0 for NULL; its null rank puts
NULLs first ascending and last descending.  Words live in int64 tensors
(u64 bits).

On a CUDA image ``topn_step`` launches the kernels of ``csrc/fused_scan.cu``
or raises; on a CPU image it runs the plain versions.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from .datatypes import EvalType
from .fused_agg import (
    Image,
    Unsupported,
    _valid_mask,
    check_columns,
    emit_keys,
    emit_program,
    set_columns,
    walk_rows,
)
from .fused_mask import (
    MAX_KEYS,
    MAX_PAYLOAD,
    SMEM_MAX,
    _TpParams,
    check_launch,
    kernels,
    scan_params,
)

_SIGN = -(1 << 63)  # the u64 sign bit as an int64
_MAGNITUDE = (1 << 63) - 1
TILE_MAX = 4096


@dataclass(frozen=True)
class TopnProgram:
    code: tuple[int, ...]
    consts: tuple[int, ...]
    col_f64: tuple[bool, ...]  # per column of the candidate image
    key_desc: tuple[bool, ...]
    key_f64: tuple[bool, ...]  # the key's value lane is f64
    k: int
    tile: int  # rows a candidate block sorts: a power of two >= k
    pay_f64: tuple[bool, ...]  # per payload column
    pay_row: tuple[int, ...]  # row of its value in the int64 or f64 matrix
    pay_null_row: tuple[int, ...]  # row of its null flag in the int64 matrix
    n_int: int
    n_f64: int

    @property
    def n_keys(self) -> int:
        return len(self.key_desc)

    @property
    def n_words(self) -> int:
        return 2 + 2 * self.n_keys


def tile_rows(n_words: int) -> int:
    """The largest power of two up to ``TILE_MAX`` whose entries (words and a
    16-bit index each) fit in a block's shared memory."""
    tile = TILE_MAX
    while tile * (8 * n_words + 2) > SMEM_MAX:
        tile //= 2
    return tile


def compile_topn_program(sel_rpns, keys, ref_cols, schema, payload_cols, k: int) -> TopnProgram:
    """The top-K program: conjuncts ``sel_rpns`` and sort keys ``keys``
    (``(rpn, desc)`` pairs) over the candidate columns ``ref_cols``, payload
    ``payload_cols`` (schema indices), ``k`` entries."""
    if len(keys) > MAX_KEYS:
        raise Unsupported(f"more than {MAX_KEYS} sort keys", "plan_too_large")
    if len(payload_cols) > MAX_PAYLOAD:
        raise Unsupported(f"more than {MAX_PAYLOAD} payload columns", "plan_too_large")
    em, _ = emit_program(sel_rpns, [], ref_cols, schema)
    key_f64 = emit_keys(em, [rpn for rpn, _ in keys])
    pay_f64 = tuple(schema[c][0] == EvalType.REAL for c in payload_cols)
    n_int, n_f64 = 1, 0  # int64 row 0: the rank
    pay_row = []
    for is_f in pay_f64:
        if is_f:
            pay_row.append(n_f64)
            n_f64 += 1
        else:
            pay_row.append(n_int)
            n_int += 1
    pay_null_row = tuple(range(n_int, n_int + len(payload_cols)))
    n_words = 2 + 2 * len(keys)
    tile = tile_rows(n_words)
    if not 1 <= k <= tile:
        raise ValueError(f"k = {k} outside 1..{tile}")
    col_f64 = tuple(schema[c][0] == EvalType.REAL for c in ref_cols)
    return TopnProgram(tuple(em.code), tuple(em.consts), col_f64,
                       tuple(bool(d) for _, d in keys), tuple(key_f64), k, tile, pay_f64,
                       tuple(pay_row), pay_null_row, n_int + len(payload_cols), n_f64)


def n_tiles(prog: TopnProgram, img: Image) -> int:
    return max(1, -(-img.n_blocks * img.block_rows // prog.tile))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _order_words(value: torch.Tensor) -> torch.Tensor:
    """Order-preserving u64 bits (as int64) of an int64 or f64 lane."""
    if value.dtype == torch.float64:
        b = value.contiguous().view(torch.int64)
        b = torch.where((b & _MAGNITUDE) == 0, torch.zeros_like(b), b)  # -0 ties +0
        return torch.where(b < 0, ~b, b | _SIGN)
    return value ^ _SIGN


def entry_words(prog: TopnProgram, img: Image, src_base: int) -> torch.Tensor:
    """The entries of the image's rows, int64 ``[n_words, rows]`` (u64 bits):
    rank, (null rank, key word) per key, src.  Rows past their block's
    ``n_valid`` have rank 1 and key words 0."""
    keys: list = [None] * prog.n_keys
    _outs, active = walk_rows(prog, img, 0, keys)
    valid = _valid_mask(img)
    n = valid.numel()
    zero = torch.zeros(n, dtype=torch.int64, device=img.device)
    words = [torch.where(active, zero, zero + 1)]
    for (value, null), desc in zip(keys, prog.key_desc):
        kw = _order_words(value.reshape(-1))
        if desc:
            kw = ~kw
        null = null.reshape(-1)
        nr = (null == desc).to(torch.int64)
        words += [torch.where(valid, nr, zero), torch.where(valid & ~null, kw, zero)]
    words.append(torch.arange(n, dtype=torch.int64, device=img.device) + src_base)
    return torch.stack(words)


def _lexsort(words: torch.Tensor) -> torch.Tensor:
    """Per batch row, the permutation that sorts the entries of ``words``
    (``[n_words, batch, n]``, u64 bits) ascending: stable sorts from the
    last word to the first."""
    _w, batch, n = words.shape
    perm = torch.arange(n, device=words.device).expand(batch, n)
    for w in range(words.shape[0] - 1, -1, -1):
        key = (words[w] ^ _SIGN).gather(1, perm)  # unsigned order as signed
        perm = perm.gather(1, torch.sort(key, dim=1, stable=True).indices)
    return perm


def candidates_plain(prog: TopnProgram, img: Image, src_base: int) -> torch.Tensor:
    """Plain version of ``topn_candidates``: ``[n_tiles, n_words, k]``, the
    first k entries of each tile of ``prog.tile`` flat rows, in order; rows
    past the image pad the last tile as entries of rank 1 with src = ~0."""
    words = entry_words(prog, img, src_base)
    nt, t = n_tiles(prog, img), prog.tile
    pad = nt * t - words.shape[1]
    if pad:
        filler = torch.zeros((prog.n_words, pad), dtype=torch.int64, device=words.device)
        filler[0] = 1
        filler[-1] = -1
        words = torch.cat([words, filler], dim=1)
    words = words.reshape(prog.n_words, nt, t)
    perm = _lexsort(words)[:, : prog.k]
    return torch.stack([words[w].gather(1, perm) for w in range(prog.n_words)], dim=1)


def merge_plain(runs: torch.Tensor, extra: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``topn_merge``: runs ``[n, n_words, k]`` (and the
    carry run ``extra`` ``[n_words, k]`` as one more) merged pairwise: run j
    of the result is the first k entries of runs 2j and 2j+1; an odd last
    run is copied."""
    if extra is not None:
        runs = torch.cat([runs, extra[None]])
    n, n_words, k = runs.shape
    pairs = n // 2
    both = runs[: 2 * pairs].reshape(pairs, 2, n_words, k).permute(2, 0, 1, 3) \
        .reshape(n_words, pairs, 2 * k)
    perm = _lexsort(both)[:, :k]
    out = torch.stack([both[w].gather(1, perm) for w in range(n_words)], dim=1)
    if n % 2:
        out = torch.cat([out, runs[-1:]])
    return out


def pack_plain(prog: TopnProgram, run: torch.Tensor, pay: Image, carry, src_base: int):
    """Plain version of ``topn_pack``: ``(ints [n_int, k], flts [n_f64, k],
    next carry run [n_words, k])`` from the final run ``[n_words, k]``."""
    k = prog.k
    rank, src = run[0], run[-1]
    live = rank == 0
    from_carry = live & ((src ^ _SIGN) < (src_base ^ _SIGN))
    from_img = live & ~from_carry
    slot = torch.where(from_carry, src, torch.zeros_like(src))
    n_flat = pay.n_blocks * pay.block_rows
    flat = torch.where(from_img, src - src_base, torch.zeros_like(src)).clamp(0, max(n_flat - 1, 0))
    ints = torch.zeros((prog.n_int, k), dtype=torch.int64, device=run.device)
    flts = torch.zeros((prog.n_f64, k), dtype=torch.float64, device=run.device)
    ints[0] = rank
    for j, (is_f, row, nrow) in enumerate(zip(prog.pay_f64, prog.pay_row, prog.pay_null_row)):
        col, nl = pay.lanes(j)  # an encoded payload column decoded
        col = col.reshape(-1)
        mat = flts if is_f else ints
        zero = torch.zeros((), dtype=mat.dtype, device=run.device)
        v = torch.where(from_img, col[flat] if n_flat else zero, zero)
        nv = torch.zeros(k, dtype=torch.int64, device=run.device)
        if nl is not None and n_flat:
            nv = torch.where(from_img, nl.reshape(-1)[flat].to(torch.int64), nv)
        if carry is not None:
            cmat = carry[1] if is_f else carry[0]
            v = torch.where(from_carry, cmat[row][slot], v)
            nv = torch.where(from_carry, carry[0][nrow][slot], nv)
        mat[row] = v
        ints[nrow] = nv
    next_run = run.clone()
    next_run[-1] = torch.arange(k, dtype=torch.int64, device=run.device)
    return ints, flts, next_run


# ---------------------------------------------------------------------------
# CUDA launchers
# ---------------------------------------------------------------------------

def _check_words(t: torch.Tensor, shape, dev, what: str) -> None:
    if t.device != dev or t.dtype != torch.int64 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: need contiguous int64 {tuple(shape)} on {dev}")


def launch_candidates(prog: TopnProgram, img: Image, runs: torch.Tensor, src_base: int) -> None:
    """Launch ``topn_candidates`` into ``runs`` (``[n_tiles, n_words, k]``)."""
    p = scan_params(prog, img)
    nt = n_tiles(prog, img)
    _check_words(runs, (nt, prog.n_words, prog.k), img.device, "runs")
    p.src_base, p.n_keys, p.k, p.tile = src_base, prog.n_keys, prog.k, prog.tile
    for q, (desc, is_f) in enumerate(zip(prog.key_desc, prog.key_f64)):
        p.key_desc[q], p.key_f64[q] = int(desc), int(is_f)
    lib = kernels()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        rc = lib.tn_launch_candidates(ctypes.byref(p), runs.data_ptr(), nt, stream)
    check_launch("topn_candidates", rc)


def launch_merge(runs: torch.Tensor, extra: torch.Tensor | None, out: torch.Tensor) -> None:
    """Launch ``topn_merge``: runs (and ``extra``) pairwise into ``out``."""
    n, n_words, k = runs.shape
    dev = runs.device
    if dev.type != "cuda":
        raise ValueError(f"topn_merge needs CUDA runs, got {dev}")
    _check_words(runs, (n, n_words, k), dev, "runs")
    if extra is not None:
        _check_words(extra, (n_words, k), dev, "carry run")
    n_runs = n + (extra is not None)
    _check_words(out, ((n_runs + 1) // 2, n_words, k), dev, "merged runs")
    lib = kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tn_launch_merge(runs.data_ptr(), n, None if extra is None else extra.data_ptr(),
                                 out.data_ptr(), n_words, k, stream)
    check_launch("topn_merge", rc)


def launch_pack(prog: TopnProgram, run: torch.Tensor, pay: Image, carry, src_base: int,
                out, out_run: torch.Tensor) -> None:
    """Launch ``topn_pack``: the packed state ``out`` = ``(ints, flts)`` of
    the final ``run``, payload from ``carry`` (a packed state or None) and
    the payload image ``pay``; ``out_run`` takes the next carry run."""
    dev, k = run.device, prog.k
    if dev.type != "cuda" or pay.device != dev:
        raise ValueError(f"topn_pack needs CUDA tensors, got {dev} and {pay.device}")
    _check_words(run, (prog.n_words, k), dev, "run")
    ints, flts = out
    _check_words(ints, (prog.n_int, k), dev, "packed ints")
    if flts.device != dev or flts.dtype != torch.float64 or tuple(flts.shape) != (prog.n_f64, k) \
            or not flts.is_contiguous():
        raise ValueError(f"packed f64: need contiguous float64 ({prog.n_f64}, {k}) on {dev}")
    _check_words(out_run, (prog.n_words, k), dev, "next carry run")
    check_columns(prog.pay_f64, pay)
    p = _TpParams()
    set_columns(p, pay)
    for j, is_f in enumerate(prog.pay_f64):
        p.pay_f64[j] = int(is_f)
        p.pay_row[j] = prog.pay_row[j]
        p.pay_null_row[j] = prog.pay_null_row[j]
    if carry is not None:
        _check_words(carry[0], (prog.n_int, k), dev, "carry ints")
        p.carry_i = carry[0].data_ptr()
        p.carry_f = carry[1].data_ptr() if prog.n_f64 else 0
    p.run, p.out_i = run.data_ptr(), ints.data_ptr()
    p.out_f = flts.data_ptr() if prog.n_f64 else 0
    p.out_run = out_run.data_ptr()
    p.src_base, p.k, p.n_words, p.n_pay = src_base, k, prog.n_words, len(prog.pay_f64)
    p.block_rows = pay.block_rows
    lib = kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tn_launch_pack(ctypes.byref(p), stream)
    check_launch("topn_pack", rc)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def _merge_all(runs: torch.Tensor, extra, cuda: bool) -> torch.Tensor:
    """Merge levels until one run is left; returns it ``[n_words, k]``."""
    while runs.shape[0] + (extra is not None) > 1:
        if cuda:
            n_runs = runs.shape[0] + (extra is not None)
            out = torch.empty(((n_runs + 1) // 2,) + tuple(runs.shape[1:]), dtype=torch.int64,
                              device=runs.device)
            launch_merge(runs, extra, out)
            runs = out
        else:
            runs = merge_plain(runs, extra)
        extra = None
    return runs[0]


def topn_step(prog: TopnProgram, cand: Image, pay: Image, carry=None, src_base: int = 0):
    """Fold the image into the carried top K: ``cand`` holds the columns the
    program reads, ``pay`` the payload columns (both over the same rows);
    ``carry`` is the previous step's ``(ints, flts, run)`` or None.  Returns
    the new ``(ints, flts, run)``: the plain versions for a CPU image, the
    CUDA kernels for a CUDA image."""
    return topn_step_run(prog, cand, pay, carry, src_base)[:3]


def topn_step_run(prog: TopnProgram, cand: Image, pay: Image, carry=None, src_base: int = 0):
    """:func:`topn_step`, with the merged run before the pack as a fourth
    value: its ``src`` word says where each winner came from (the carry's
    slot below ``src_base``, else ``src_base`` + the image's flat row)."""
    if carry is not None and src_base < prog.k:
        raise ValueError("a carried step needs src_base >= k: the carry's src is its slot")
    extra = carry[2] if carry is not None else None
    if cand.device.type == "cpu":
        run = _merge_all(candidates_plain(prog, cand, src_base), extra, cuda=False)
        return (*pack_plain(prog, run, pay, carry, src_base), run)
    if cand.device.type != "cuda":
        raise ValueError(f"no topn_step for device {cand.device}")
    dev = cand.device
    runs = torch.empty((n_tiles(prog, cand), prog.n_words, prog.k), dtype=torch.int64, device=dev)
    launch_candidates(prog, cand, runs, src_base)
    run = _merge_all(runs, extra, cuda=True)
    out = (torch.empty((prog.n_int, prog.k), dtype=torch.int64, device=dev),
           torch.empty((prog.n_f64, prog.k), dtype=torch.float64, device=dev))
    next_run = torch.empty((prog.n_words, prog.k), dtype=torch.int64, device=dev)
    launch_pack(prog, run, pay, carry, src_base, out, next_run)
    return out[0], out[1], next_run, run

