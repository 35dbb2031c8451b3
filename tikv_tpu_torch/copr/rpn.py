"""RPN expression engine over torch tensors.

The port's counterpart of ``tikv_tpu/copr/rpn.py``: expression trees compile
to a postfix (RPN) node list with static type and decimal-frac inference, and
``eval_rpn`` runs the list as a stack machine over whole ``(data, nulls)``
tensor columns.  On the device path the same node list is compiled once more,
into the fused kernel's bytecode (``copr/fused_agg.py``).

Only the scalar functions of ``copr/kernels.py`` compile here; the evaluator
declines plans that reach any other function before compiling them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .datatypes import EvalType
from .kernels import KERNELS


# ---------------------------------------------------------------------------
# Expression tree (tipb::Expr equivalent)
# ---------------------------------------------------------------------------

@dataclass
class ColumnRef:
    index: int


@dataclass
class Constant:
    value: object  # None | int | float (decimal: pre-scaled int)
    eval_type: EvalType
    frac: int = 0


@dataclass
class FuncCall:
    op: str  # kernel name
    children: list
    # filled by type inference:
    eval_type: EvalType | None = None
    frac: int = 0


Expr = ColumnRef | Constant | FuncCall


# ---------------------------------------------------------------------------
# RPN compilation with static type/frac inference
# ---------------------------------------------------------------------------

@dataclass
class RpnNode:
    kind: str  # "col" | "const" | "fn"
    eval_type: EvalType
    frac: int = 0
    index: int = 0  # col index
    value: object = None  # const value
    op: str = ""  # fn kernel name
    arity: int = 0
    scale_by: tuple[int, ...] = ()  # per-operand decimal rescale multipliers


@dataclass
class RpnExpression:
    nodes: list[RpnNode]

    @property
    def eval_type(self) -> EvalType:
        return self.nodes[-1].eval_type

    @property
    def frac(self) -> int:
        return self.nodes[-1].frac

    def referenced_columns(self) -> set[int]:
        return {n.index for n in self.nodes if n.kind == "col"}


def compile_expr(expr: Expr, schema: list[tuple[EvalType, int]]) -> RpnExpression:
    """Compile a tree to RPN. ``schema`` maps column index → (eval_type, frac)."""
    nodes: list[RpnNode] = []
    _compile(expr, schema, nodes)
    return RpnExpression(nodes)


def _compile(expr: Expr, schema, nodes: list[RpnNode]) -> tuple[EvalType, int]:
    if isinstance(expr, ColumnRef):
        et, frac = schema[expr.index]
        nodes.append(RpnNode("col", et, frac, index=expr.index))
        return et, frac
    if isinstance(expr, Constant):
        nodes.append(RpnNode("const", expr.eval_type, expr.frac, value=expr.value))
        return expr.eval_type, expr.frac
    if isinstance(expr, FuncCall):
        if expr.op not in KERNELS:
            raise ValueError(f"unsupported scalar function {expr.op!r}")
        arity, rkind, _ = KERNELS[expr.op]
        if arity != len(expr.children):
            raise ValueError(f"{expr.op} expects {arity} args, got {len(expr.children)}")
        child_types = [_compile(c, schema, nodes) for c in expr.children]
        et, frac, scale_by = _infer(expr.op, rkind, child_types)
        nodes.append(
            RpnNode("fn", et, frac, op=expr.op, arity=arity, scale_by=scale_by)
        )
        expr.eval_type, expr.frac = et, frac
        return et, frac
    raise TypeError(f"not an expression: {expr!r}")


def _infer(op: str, rkind: str, child_types) -> tuple[EvalType, int, tuple[int, ...]]:
    """Result type + frac + the decimal rescaling each operand needs.

    Mixed-frac decimal operands are aligned to the max frac by multiplying the
    lower-frac side by 10^diff — done once, statically planned here.  Only
    the result kinds of the ported kernels ("int", "same") occur.
    """
    scale_by = tuple(1 for _ in child_types)
    types = [t[0] for t in child_types]
    fracs = [t[1] for t in child_types]
    has_decimal = EvalType.DECIMAL in types

    if op == "multiply" and has_decimal:
        # scaled(a*b) = scaled(a)*scaled(b), frac adds — no rescale needed
        return EvalType.DECIMAL, sum(f for t, f in child_types if t == EvalType.DECIMAL), scale_by

    if has_decimal and len(child_types) >= 2:
        # align fracs for +, - and comparisons
        f = max(fracs)
        scale_by = tuple(10 ** (f - fi) for fi in fracs)
        if rkind == "int":
            return EvalType.INT, 0, scale_by
        return EvalType.DECIMAL, f, scale_by

    if rkind == "int":
        return EvalType.INT, 0, scale_by
    if rkind == "same":
        return types[0], fracs[0], scale_by
    raise AssertionError(rkind)


# ---------------------------------------------------------------------------
# Stack-machine evaluation
# ---------------------------------------------------------------------------

_DTYPE = {
    EvalType.INT: torch.int64,
    EvalType.DECIMAL: torch.int64,
    EvalType.DATETIME: torch.int64,
    EvalType.DURATION: torch.int64,
    EvalType.REAL: torch.float64,
}


def const_tensor(node: RpnNode, n_rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A const node as a full ``(data, nulls)`` column.  Values convert as
    numpy's ``full(n, value, dtype)`` does: a float into int64 truncates."""
    dtype = _DTYPE.get(node.eval_type)
    if dtype is None:
        raise ValueError(f"constant of type {node.eval_type} is not ported")
    if node.value is None:
        return (torch.zeros(n_rows, dtype=dtype, device=device),
                torch.ones(n_rows, dtype=torch.bool, device=device))
    value = float(node.value) if dtype == torch.float64 else int(node.value)
    return (torch.full((n_rows,), value, dtype=dtype, device=device),
            torch.zeros(n_rows, dtype=torch.bool, device=device))


def eval_rpn(rpn: RpnExpression, columns, n_rows: int, device=None):
    """Evaluate over column (data, nulls) tensor pairs. Returns (data, nulls).

    ``columns`` maps column index → (data, nulls); only referenced indices
    need to be present.  Constants are built on ``device`` (default: that of
    the first referenced column, else the CPU)."""
    if device is None:
        device = next((d.device for d, _ in columns.values()), torch.device("cpu"))
    stack: list[tuple[torch.Tensor, torch.Tensor]] = []
    for node in rpn.nodes:
        if node.kind == "col":
            stack.append(columns[node.index])
        elif node.kind == "const":
            stack.append(const_tensor(node, n_rows, device))
        else:
            _, _, fn = KERNELS[node.op]
            args = stack[-node.arity :]
            del stack[-node.arity :]
            if any(m != 1 for m in node.scale_by):
                args = [
                    (d * m, nl) if m != 1 else (d, nl)
                    for (d, nl), m in zip(args, node.scale_by)
                ]
            stack.append(fn(*args))
    if len(stack) != 1:
        raise ValueError("malformed RPN")
    return stack[0]


# -- convenience builders ---------------------------------------------------

def col(i: int) -> ColumnRef:
    return ColumnRef(i)


def const_int(v: int | None) -> Constant:
    return Constant(v, EvalType.INT)


def const_real(v: float | None) -> Constant:
    return Constant(v, EvalType.REAL)


def const_decimal(scaled: int | None, frac: int) -> Constant:
    return Constant(scaled, EvalType.DECIMAL, frac)


def call(op: str, *children) -> FuncCall:
    return FuncCall(op, list(children))
