"""Scalar-function kernels over torch ``(data, nulls)`` pairs.

The port's subset of ``tikv_tpu/copr/kernels.py``: the comparisons, MySQL
three-valued logic, null predicates and ``+ - *`` that the slice's plans use.
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
