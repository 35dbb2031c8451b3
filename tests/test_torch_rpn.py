"""Differential: the port's RPN evaluation against the JAX package's.

For each ported scalar function over int, decimal (mixed frac, so
``scale_by`` fires), real, mixed int/real and NULL-bearing operands, the JAX
``eval_rpn(xp=jnp)`` and the port's ``eval_rpn`` must give bit-identical
``(data, nulls)``; so must the port's fused bytecode walked by its plain
version (``fused_agg_plain``), whose count/sum/min/max then agree with the
JAX values reduced by numpy.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tikv_tpu.copr import rpn as jrpn
from tikv_tpu.copr.datatypes import EvalType as JEvalType
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import rpn as trpn
from tikv_tpu_torch.copr.datatypes import EvalType

N = 257
# schema: 0 int, 1 int (extremes), 2 decimal(2), 3 decimal(4), 4 real, 5 real
# (specials), 6 decimal(2) — every column nullable
SCHEMA = [("int", 0), ("int", 0), ("decimal", 2), ("decimal", 4), ("real", 0),
          ("real", 0), ("decimal", 2)]


def _columns(seed: int = 7):
    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)
    ext = np.array([0, 1, -1, i64.max, i64.min, 3, -(1 << 62), 1 << 62], dtype=np.int64)
    specials = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 1e308])
    data = [
        rng.integers(-50, 50, N).astype(np.int64),
        ext[rng.integers(0, len(ext), N)],
        rng.integers(-10**6, 10**6, N).astype(np.int64),
        rng.integers(-10**8, 10**8, N).astype(np.int64),
        rng.uniform(-100.0, 100.0, N).round(1),
        specials[rng.integers(0, len(specials), N)],
        rng.integers(-3, 4, N).astype(np.int64) * 100,
    ]
    nulls = [rng.random(N) < 0.15 for _ in data]
    return data, nulls


def _trees(mod, et):
    """Expressions built with ``mod``'s builders (the JAX package or the port)."""
    c, call = mod.col, mod.call
    ci, cd, cr = mod.const_int, mod.const_decimal, mod.const_real
    null_int = mod.Constant(None, et.INT)
    return {
        "lt_int": call("lt", c(0), ci(3)),
        "le_dec_mixed_frac": call("le", c(2), c(3)),
        "gt_real": call("gt", c(4), cr(0.5)),
        "ge_int_real": call("ge", c(0), c(4)),
        "eq_dec_const": call("eq", c(6), cd(1, 0)),
        "ne_real_specials": call("ne", c(5), cr(0.0)),
        "eq_real_specials": call("eq", c(5), c(5)),
        "lt_int_null_const": call("lt", c(0), null_int),
        "and_cmp": call("and", call("gt", c(0), ci(0)), call("lt", c(4), cr(10.0))),
        "and_real_int": call("and", c(5), c(0)),
        "or_cmp": call("or", call("eq", c(0), ci(1)), call("ge", c(3), cd(5, 1))),
        "or_real": call("or", c(4), c(5)),
        "xor": call("xor", c(0), c(6)),
        "xor_real": call("xor", c(5), c(1)),
        "not_int": call("not", c(0)),
        "not_real": call("not", c(5)),
        "is_null": call("is_null", c(2)),
        "is_true_real": call("is_true", c(5)),
        "is_false_int": call("is_false", c(0)),
        "plus_int_wraps": call("plus", c(1), c(1)),
        "plus_dec_mixed_frac": call("plus", c(2), c(3)),
        "plus_int_real": call("plus", c(0), c(4)),
        "minus_int_wraps": call("minus", c(1), ci(-5)),
        "minus_dec_const": call("minus", c(3), cd(25, 1)),
        "minus_real": call("minus", c(5), c(4)),
        "multiply_int_wraps": call("multiply", c(1), ci(7)),
        "multiply_dec": call("multiply", c(2), c(6)),
        "multiply_real_int": call("multiply", c(4), c(0)),
        "multiply_dec_int": call("multiply", c(3), c(0)),
        "nested_scale": call("lt", call("plus", c(2), cd(3, 1)), call("minus", c(3), c(6))),
    }


CASES = sorted(_trees(trpn, EvalType))


def _jax_schema():
    return [(JEvalType(t), f) for t, f in SCHEMA]


def _port_schema():
    return [(EvalType(t), f) for t, f in SCHEMA]


def _jax_eval(name):
    data, nulls = _columns()
    rpn = jrpn.compile_expr(_trees(jrpn, JEvalType)[name], _jax_schema())
    cols = {i: (jnp.asarray(d), jnp.asarray(n)) for i, (d, n) in enumerate(zip(data, nulls))}
    d, nl = jrpn.eval_rpn(rpn, cols, N, xp=jnp)
    return np.asarray(d), np.asarray(nl), rpn


def _bits(a: np.ndarray) -> np.ndarray:
    """int64 view for bit comparison; NaNs map to one pattern."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = np.where(np.isnan(a), np.nan, a)
        return a.view(np.int64)
    return a.astype(np.int64)


def _assert_bit_identical(got_d, got_n, want_d, want_n, what):
    assert got_d.dtype == want_d.dtype, (what, got_d.dtype, want_d.dtype)
    np.testing.assert_array_equal(got_n, want_n, err_msg=f"{what}: nulls")
    np.testing.assert_array_equal(_bits(got_d), _bits(want_d), err_msg=f"{what}: data")


@pytest.mark.parametrize("name", CASES)
def test_eval_rpn_bit_identical(name):
    want_d, want_n, jr = _jax_eval(name)
    data, nulls = _columns()
    rpn = trpn.compile_expr(_trees(trpn, EvalType)[name], _port_schema())
    assert [(n.kind, n.eval_type.value, n.frac, n.scale_by) for n in rpn.nodes] == \
        [(n.kind, n.eval_type.value, n.frac, n.scale_by) for n in jr.nodes]
    cols = {i: (torch.from_numpy(d), torch.from_numpy(n)) for i, (d, n) in enumerate(zip(data, nulls))}
    d, nl = trpn.eval_rpn(rpn, cols, N)
    _assert_bit_identical(d.numpy(), nl.numpy(), want_d, want_n, name)


def _image(data, nulls):
    cols = [torch.from_numpy(d).reshape(1, N) for d in data]
    nls = [torch.from_numpy(n).reshape(1, N) for n in nulls]
    return fa.Image(cols, nls, N, 1, N, torch.device("cpu"))


@pytest.mark.parametrize("name", CASES)
def test_bytecode_walk_bit_identical(name):
    """``count(expr)`` exposes the walker's per-row value and null mask."""
    want_d, want_n, _ = _jax_eval(name)
    data, nulls = _columns()
    rpn = trpn.compile_expr(_trees(trpn, EvalType)[name], _port_schema())
    prog = fa.compile_program([], [("count", rpn)], list(range(len(SCHEMA))), _port_schema())
    [(live, value)] = fa._walk(prog, _image(data, nulls))
    _assert_bit_identical(value.numpy(), (~live).numpy(), want_d, want_n, name)


@pytest.mark.parametrize("name", CASES)
def test_fused_plain_aggregates_match_jax_values(name):
    want_d, want_n, _ = _jax_eval(name)
    data, nulls = _columns()
    schema = _port_schema()
    rpn = trpn.compile_expr(_trees(trpn, EvalType)[name], schema)
    is_f = want_d.dtype == np.float64
    if is_f != (rpn.eval_type == EvalType.REAL):
        # an INT-typed expression computed in f64 has no exact carry: declined
        with pytest.raises(fa.Unsupported) as exc:
            fa.compile_program([], [("sum", rpn)], list(range(len(SCHEMA))), schema)
        assert exc.value.cause == "agg_arg_type_not_ported"
        return
    aggs = [("count", rpn), ("sum", rpn), ("min", rpn), ("max", rpn)]
    prog = fa.compile_program([], aggs, list(range(len(SCHEMA))), schema)
    ints, flts = fa.fused_agg_plain(prog, _image(data, nulls))
    live = ~want_n
    vals = want_d[live]
    assert ints[prog.aggs[0].cnt_slot, 0] == live.sum()
    m = flts if is_f else ints
    got_sum = m[prog.aggs[1].val_slot, 0].item()
    if is_f:
        with np.errstate(over="ignore", invalid="ignore"):
            want_sum = vals.sum()  # inf - inf is NaN on both sides
        np.testing.assert_allclose(got_sum, want_sum, rtol=1e-12)
        assert np.array_equal(m[prog.aggs[2].val_slot, 0].numpy(), vals.min(initial=np.inf),
                              equal_nan=True)
        assert np.array_equal(m[prog.aggs[3].val_slot, 0].numpy(), vals.max(initial=-np.inf),
                              equal_nan=True)
    else:
        assert got_sum == vals.sum()  # int64 wraps alike
        i64 = np.iinfo(np.int64)
        assert m[prog.aggs[2].val_slot, 0].item() == vals.min(initial=i64.max)
        assert m[prog.aggs[3].val_slot, 0].item() == vals.max(initial=i64.min)


def test_selection_bytecode_matches_jax_mask():
    """Every comparison/logic case as a selection conjunct: the walker's
    active mask equals the JAX ``d != 0 & ~null``."""
    data, nulls = _columns()
    schema = _port_schema()
    names = [n for n in CASES if not n.startswith(("plus", "minus", "multiply"))]
    want = np.ones(N, dtype=bool)
    sel = []
    for name in names:
        d, nl, _ = _jax_eval(name)
        want &= (d != 0) & ~nl
        sel.append(trpn.compile_expr(_trees(trpn, EvalType)[name], schema))
    prog = fa.compile_program(sel, [("count", None)], list(range(len(SCHEMA))), schema)
    [(active, _)] = fa._walk(prog, _image(data, nulls))
    np.testing.assert_array_equal(active.numpy(), want)
