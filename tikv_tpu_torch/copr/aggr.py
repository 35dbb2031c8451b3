"""Aggregate descriptors and finalize states.

The port's subset of ``tikv_tpu/copr/aggr.py``: ``AggDescriptor`` and the
``AggState`` finalize surface (``grow`` + ``result_columns``) for ``count sum
avg min max``.  The device computes the per-group carries; ``to_state`` in
``copr/torch_eval.py`` fills an ``AggState`` from them, and finalization then
runs this code, as the reference finalizes its device carries through the
CPU path's ``AggState``.  Like the reference's pushdown protocol, AVG emits
two result columns (count, sum) and the client finishes the division.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .datatypes import Column, EvalType
from .rpn import Expr

PORTED_AGG_OPS = ("count", "sum", "avg", "min", "max")


@dataclass
class AggDescriptor:
    """One aggregate call: op over an expression (tipb aggregate Expr)."""

    op: str  # count | sum | avg | min | max (others decline)
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
        if op in ("sum", "avg"):
            self.sum = np.zeros(0, dtype=dtype)
        if op in ("min", "max"):
            self.value = np.zeros(0, dtype=dtype)
            self.has_value = np.zeros(0, dtype=bool)

    def grow(self, n_groups: int) -> None:
        add = n_groups - len(self.count)
        if add <= 0:
            return
        self.count = np.concatenate([self.count, np.zeros(add, dtype=np.int64)])
        if hasattr(self, "sum"):
            self.sum = np.concatenate([self.sum, np.zeros(add, dtype=self.sum.dtype)])
        if hasattr(self, "value"):
            self.value = np.concatenate([self.value, np.zeros(add, dtype=self.value.dtype)])
            self.has_value = np.concatenate([self.has_value, np.zeros(add, dtype=bool)])

    def result_columns(self, n_groups: int) -> list[Column]:
        """Finalize into result columns (count/sum layouts per module docstring)."""
        op = self.op
        zeros = np.zeros(n_groups, dtype=bool)
        if op == "count":
            return [Column(EvalType.INT, self.count[:n_groups], zeros)]
        if op == "sum":
            return [
                Column(self.input_type, self.sum[:n_groups], self.count[:n_groups] == 0, self.frac)
            ]
        if op == "avg":
            return [
                Column(EvalType.INT, self.count[:n_groups], zeros),
                Column(self.input_type, self.sum[:n_groups], self.count[:n_groups] == 0, self.frac),
            ]
        return [
            Column(self.input_type, self.value[:n_groups], ~self.has_value[:n_groups], self.frac)
        ]
