"""Aggregate descriptors and finalize states.

The port's subset of ``tikv_tpu/copr/aggr.py``: ``AggDescriptor`` and the
``AggState`` finalize surface (``grow`` + ``result_columns``) for the ten
device aggregates.  The device computes the per-group carries; ``to_state``
in ``copr/torch_eval.py`` fills an ``AggState`` from them, and finalization
then runs this code, as the reference finalizes its device carries through
the CPU path's ``AggState``.  Like the reference's pushdown protocol, AVG
emits two result columns (count, sum) and VAR_POP three (count, sum,
sum_sq): the client finishes the division.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .datatypes import Column, EvalType
from .rpn import Expr

#: the JAX package's device aggregates (``jax_eval._DEVICE_AGG_OPS``)
PORTED_AGG_OPS = ("count", "sum", "avg", "min", "max", "var_pop",
                  "first", "bit_and", "bit_or", "bit_xor")


@dataclass
class AggDescriptor:
    """One aggregate call: op over an expression (tipb aggregate Expr)."""

    op: str  # one of PORTED_AGG_OPS (others decline)
    expr: Expr | None  # None for count(1)


class AggState:
    """Per-group state for one aggregate over one compiled expr."""

    def __init__(self, op: str, input_type: EvalType, frac: int):
        if op not in PORTED_AGG_OPS:
            raise ValueError(f"aggregate {op!r} is not ported")
        self.op = op
        self.input_type = input_type
        self.frac = frac
        dtype = np.float64 if input_type == EvalType.REAL else np.int64
        self.count = np.zeros(0, dtype=np.int64)
        if op in ("sum", "avg", "var_pop"):
            self.sum = np.zeros(0, dtype=dtype)
        if op == "var_pop":
            self.sum_sq = np.zeros(0, dtype=np.float64)
        if op in ("min", "max", "first"):
            self.value = np.zeros(0, dtype=dtype)
            self.has_value = np.zeros(0, dtype=bool)
        if op in ("bit_and", "bit_or", "bit_xor"):
            self.value = np.zeros(0, dtype=np.int64)

    def grow(self, n_groups: int) -> None:
        add = n_groups - len(self.count)
        if add <= 0:
            return
        self.count = np.concatenate([self.count, np.zeros(add, dtype=np.int64)])
        if hasattr(self, "sum"):
            self.sum = np.concatenate([self.sum, np.zeros(add, dtype=self.sum.dtype)])
        if hasattr(self, "sum_sq"):
            self.sum_sq = np.concatenate([self.sum_sq, np.zeros(add, dtype=np.float64)])
        if hasattr(self, "value"):
            init = -1 if self.op == "bit_and" else 0
            self.value = np.concatenate([self.value, np.full(add, init, dtype=self.value.dtype)])
        if hasattr(self, "has_value"):
            self.has_value = np.concatenate([self.has_value, np.zeros(add, dtype=bool)])

    def result_columns(self, n_groups: int) -> list[Column]:
        """Finalize into result columns (count/sum layouts per module docstring)."""
        op = self.op
        zeros = np.zeros(n_groups, dtype=bool)
        empty = self.count[:n_groups] == 0
        if op == "count":
            return [Column(EvalType.INT, self.count[:n_groups], zeros)]
        if op == "sum":
            return [Column(self.input_type, self.sum[:n_groups], empty, self.frac)]
        if op == "avg":
            return [
                Column(EvalType.INT, self.count[:n_groups], zeros),
                Column(self.input_type, self.sum[:n_groups], empty, self.frac),
            ]
        if op == "var_pop":
            return [
                Column(EvalType.INT, self.count[:n_groups], zeros),
                Column(EvalType.REAL, self.sum[:n_groups].astype(np.float64), empty),
                Column(EvalType.REAL, self.sum_sq[:n_groups], empty),
            ]
        if op in ("bit_and", "bit_or", "bit_xor"):
            return [Column(EvalType.INT, self.value[:n_groups], zeros)]
        return [
            Column(self.input_type, self.value[:n_groups], ~self.has_value[:n_groups], self.frac)
        ]
