"""Scalar-function kernels over torch ``(data, nulls)`` pairs.

The port's subset of ``tikv_tpu/copr/kernels.py``: the comparisons, MySQL
three-valued logic, null predicates, ``+ - *``, unary minus, ``abs`` and the
bit operators that the slices' plans use.
Each kernel maps operand pairs to a result pair with the reference's
semantics (numpy type promotion, int64 wraparound, NaN compares false except
under ``ne``).  ``copr/rpn.py`` evaluates expressions with them, and the plain
version of the fused kernel (``copr/fused_agg.py``) walks its bytecode with
the same functions, so the two cannot drift apart.

Conventions:
* data: int64 / float64 tensors; comparisons and logic return int64 0/1
* nulls: bool tensor, True = NULL
* decimals are scaled int64; frac bookkeeping happens in rpn.py
"""

from __future__ import annotations

import operator

import torch

# name -> (arity, result_kind, fn(*operand_pairs) -> (data, nulls))
# result_kind: "int" | "same" (typed like the first operand)
KERNELS: dict[str, tuple[int, str, object]] = {}


def _reg(name: str, arity: int, rkind: str):
    def deco(fn):
        KERNELS[name] = (arity, rkind, fn)
        return fn

    return deco


# -- comparisons ------------------------------------------------------------

def _cmp(pyop):
    def fn(a, b):
        (ad, an), (bd, bn) = a, b
        # torch promotes int64 against float64 to float64, as numpy does
        return pyop(ad, bd).to(torch.int64), an | bn

    return fn


for _name, _op in [
    ("lt", operator.lt),
    ("le", operator.le),
    ("gt", operator.gt),
    ("ge", operator.ge),
    ("eq", operator.eq),
    ("ne", operator.ne),
]:
    KERNELS[_name] = (2, "int", _cmp(_op))


# -- logical (MySQL three-valued) ------------------------------------------

@_reg("and", 2, "int")
def _and(a, b):
    (ad, an), (bd, bn) = a, b
    at = (ad != 0) & ~an
    bt = (bd != 0) & ~bn
    af = (ad == 0) & ~an
    bf = (bd == 0) & ~bn
    # false AND anything = false (not null); null only if neither side false
    return (at & bt).to(torch.int64), (an | bn) & ~af & ~bf


@_reg("or", 2, "int")
def _or(a, b):
    (ad, an), (bd, bn) = a, b
    at = (ad != 0) & ~an
    bt = (bd != 0) & ~bn
    return (at | bt).to(torch.int64), (an | bn) & ~at & ~bt


@_reg("xor", 2, "int")
def _xor(a, b):
    (ad, an), (bd, bn) = a, b
    return ((ad != 0) ^ (bd != 0)).to(torch.int64), an | bn


@_reg("not", 1, "int")
def _not(a):
    ad, an = a
    return (ad == 0).to(torch.int64), an


# -- null predicates --------------------------------------------------------

@_reg("is_null", 1, "int")
def _is_null(a):
    _ad, an = a
    return an.to(torch.int64), torch.zeros_like(an)


@_reg("is_true", 1, "int")
def _is_true(a):
    ad, an = a
    return ((ad != 0) & ~an).to(torch.int64), torch.zeros_like(an)


@_reg("is_false", 1, "int")
def _is_false(a):
    ad, an = a
    return ((ad == 0) & ~an).to(torch.int64), torch.zeros_like(an)


# -- arithmetic (int64 wraps, like numpy) -----------------------------------

@_reg("plus", 2, "same")
def _plus(a, b):
    (ad, an), (bd, bn) = a, b
    return ad + bd, an | bn


@_reg("minus", 2, "same")
def _minus(a, b):
    (ad, an), (bd, bn) = a, b
    return ad - bd, an | bn


@_reg("multiply", 2, "same")
def _multiply(a, b):
    (ad, an), (bd, bn) = a, b
    return ad * bd, an | bn


@_reg("unary_minus", 1, "same")
def _unary_minus(a):
    ad, an = a
    return -ad, an  # -INT64_MIN wraps to INT64_MIN


@_reg("abs", 1, "same")
def _abs(a):
    ad, an = a
    return ad.abs(), an  # abs(INT64_MIN) wraps to INT64_MIN


# -- bit operators (MySQL u64 results, kept as the int64 bit pattern) --------

@_reg("bit_and", 2, "int")
def _bit_and(a, b):
    (ad, an), (bd, bn) = a, b
    return ad & bd, an | bn


@_reg("bit_or", 2, "int")
def _bit_or(a, b):
    (ad, an), (bd, bn) = a, b
    return ad | bd, an | bn


@_reg("bit_xor", 2, "int")
def _bit_xor(a, b):
    (ad, an), (bd, bn) = a, b
    return ad ^ bd, an | bn


@_reg("bit_neg", 1, "int")
def _bit_neg(a):
    ad, an = a
    return ~ad, an


@_reg("is_not_null", 1, "int")
def _is_not_null(a):
    _ad, an = a
    return (~an).to(torch.int64), torch.zeros_like(an)


# -- program #1: the in-kernel decode of an encoded column -------------------

def decode_device_column(desc, payload, nulls, ref, n_rows: int):
    """``(data, nulls)`` lanes of one shipped column from its pinned payload:
    the plain version of the column load in ``csrc/fa_walk.cuh`` (``fa_load``)
    and of the JAX package's ``kernels.decode_device_column``.

    ``desc`` is the column's descriptor (``encoding._col_desc``): ``("plain",)``
    returns the payload as it is; ``("bp", lane)`` widens the narrow lanes to
    int64 and adds ``ref``; ``("code", lane)`` widens dictionary codes;
    ``("rle", k_cap, dtype)`` takes ``payload = (run_values, run_ends)``, finds
    each row's run with ``searchsorted(run_ends, row, right=True)`` clipped to
    ``k_cap - 1`` (rows past the last run fall in the inert pad run) and
    gathers its value, and its null flag where ``nulls`` is run-shaped.
    Payloads are ``[rows]`` or ``[blocks, rows]`` (``[..., k_cap]`` for runs);
    ``nulls`` is a bool tensor or None (NOT NULL).  Unlike the JAX package,
    the null slots of an encoded column decode to 0, as the host decode
    (``EncodedColumn._decode_rows``) and the plain image hold them."""
    kind = desc[0]
    if kind == "plain":
        return payload, nulls
    if kind == "rle":
        run_values, run_ends = payload
        rows = torch.arange(n_rows, dtype=torch.int64, device=run_ends.device)
        rows = rows.expand(*run_ends.shape[:-1], n_rows).contiguous()
        idx = torch.searchsorted(run_ends.contiguous(), rows, right=True).clamp_(0, desc[1] - 1)
        data = run_values.to(torch.int64).gather(-1, idx)
        if nulls is not None and nulls.shape[-1] != n_rows:  # run-shaped
            nulls = nulls.gather(-1, idx)
    elif kind in ("bp", "code"):
        data = payload.to(torch.int64)
        if kind == "bp" and ref:
            data = data + int(ref)
    else:
        raise AssertionError(f"unknown encoding descriptor {desc!r}")
    if nulls is not None:
        data = data.masked_fill(nulls, 0)
    return data, nulls
