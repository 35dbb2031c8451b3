"""The port's group dictionary and host group-id helpers against the JAX package's.

``tikv_tpu_torch.copr.groupby.GroupDict`` must hand out the same dense ids,
in the same first-occurrence order, with the same key tuples, as
``tikv_tpu.copr.groupby.GroupDict``, batch after batch: the device path's
group order and its group keys come from it.  Inputs come from
``np.random.default_rng`` with NULLs in every key column.
"""

import numpy as np
import pytest

from tikv_tpu.copr import executors as jax_executors
from tikv_tpu.copr import rpn as jax_rpn
from tikv_tpu.copr.datatypes import Column as JaxColumn
from tikv_tpu.copr.datatypes import EvalType as JaxEvalType
from tikv_tpu.copr.groupby import GroupDict as JaxGroupDict
from tikv_tpu_torch.copr import executors
from tikv_tpu_torch.copr import rpn
from tikv_tpu_torch.copr.datatypes import Column, EvalType
from tikv_tpu_torch.copr.groupby import GroupDict

N_BATCHES = 4


def _dict(values):
    d = np.empty(len(values), dtype=object)
    d[:] = values
    return d


def _same(port: GroupDict, ref: JaxGroupDict, got, want):
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    # repr: NaN keys compare unequal to themselves
    assert repr(port.rows) == repr(ref.rows)
    assert repr(list(port.index.items())) == repr(list(ref.index.items()))


def _key_column(kind, rng, n):
    nulls = rng.random(n) < 0.15
    if kind == "int":
        return rng.integers(-5, 20, n), nulls
    if kind == "float":
        v = rng.integers(0, 8, n) / 4.0
        v[rng.random(n) < 0.05] = np.nan
        return v, nulls
    data = np.empty(n, dtype=object)
    data[:] = [b"k%d" % x if x % 5 else b"k\x00" for x in rng.integers(0, 12, n)]
    return data, nulls


@pytest.mark.parametrize("kinds", [("int",), ("float",), ("bytes",), ("int", "bytes"),
                                   ("bytes", "float", "int")])
def test_assign_matches_jax(kinds):
    rng = np.random.default_rng(7)
    port, ref = GroupDict(), JaxGroupDict()
    for b in range(N_BATCHES):
        n = 0 if b == 2 else 300
        parts = [_key_column(k, rng, n) for k in kinds]
        _same(port, ref, port.assign(parts), ref.assign(parts))


def _int_keys(case, rng, b, n):
    """Block ``b`` of an integer key column for ``test_integer_keys_match_jax``."""
    if case == "sparse":  # wide ranges: keys far apart, hits and misses
        v = rng.integers(-(1 << 62), 1 << 62, n)
        v[: n // 2] = rng.choice(v[: n // 4], n // 2)
        return v
    if case == "growing":  # each block repeats earlier keys and adds new ones
        return rng.integers(-50, 400 * (b + 1), n)
    if case == "uint64_high":  # SET-like keys with bit 63 set
        top = np.uint64(1 << 63)
        return np.where(rng.random(n) < 0.5, top + rng.integers(0, 40, n).astype(np.uint64),
                        rng.integers(0, 40, n).astype(np.uint64))
    return rng.integers(-300, 300, n).astype(np.int32)


@pytest.mark.parametrize("case", ["sparse", "growing", "uint64_high", "int32"])
def test_integer_keys_match_jax(case):
    rng = np.random.default_rng(11)
    port, ref = GroupDict(), JaxGroupDict()
    for b in range(12):
        n = 0 if b == 5 else 1500
        parts = [(_int_keys(case, rng, b, n), rng.random(n) < 0.1)]
        _same(port, ref, port.assign(parts), ref.assign(parts))
    assert len(port) > 50


def test_assign_coded_matches_jax():
    rng = np.random.default_rng(8)
    port, ref = GroupDict(), JaxGroupDict()
    d = _dict([b"A", b"N", b"R", b"\x00"])
    for _ in range(N_BATCHES):
        codes = rng.integers(0, len(d), 500)
        nulls = rng.random(500) < 0.1
        _same(port, ref, port.assign_coded(codes, nulls, d), ref.assign_coded(codes, nulls, d))


def test_assign_coded_multi_matches_jax():
    rng = np.random.default_rng(9)
    port, ref = GroupDict(), JaxGroupDict()
    dicts = [_dict([b"A", b"N", b"R"]), _dict([b"F", b"O"]), _dict([b"x"])]
    for _ in range(N_BATCHES):
        parts = [(rng.integers(0, len(d), 400), rng.random(400) < 0.1, d) for d in dicts]
        _same(port, ref, port.assign_coded_multi(parts), ref.assign_coded_multi(parts))


def _columns(port: bool, rng):
    """Four columns: int, dictionary-coded bytes (nullable), plain bytes,
    and an ENUM-typed dictionary column, as both packages build them."""
    n = 64
    mod = (Column, EvalType) if port else (JaxColumn, JaxEvalType)
    col, et = mod
    d = _dict([b"a", b"b", b"c"])
    codes = rng.integers(0, 3, n)
    nulls = rng.random(n) < 0.2
    plain = np.empty(n, dtype=object)
    plain[:] = [b"p%d" % c for c in codes]
    return [col(et.INT, codes * 7, np.zeros(n, dtype=bool)),
            col(et.BYTES, codes, nulls, 0, d),
            col(et.BYTES, plain, nulls),
            col(et.ENUM, codes, np.zeros(n, dtype=bool), 0, d)]


@pytest.mark.parametrize("keys", [[1], [1, 1], [0], [2], [3], [1, 0]])
def test_coded_group_parts_matches_jax(keys):
    port_cols = _columns(True, np.random.default_rng(3))
    ref_cols = _columns(False, np.random.default_rng(3))
    schema = [(EvalType.INT, 0), (EvalType.BYTES, 0), (EvalType.BYTES, 0), (EvalType.INT, 0)]
    ref_schema = [(JaxEvalType.INT, 0), (JaxEvalType.BYTES, 0), (JaxEvalType.BYTES, 0),
                  (JaxEvalType.INT, 0)]
    port_rpns = [rpn.compile_expr(rpn.col(k), schema) for k in keys]
    ref_rpns = [jax_rpn.compile_expr(jax_rpn.col(k), ref_schema) for k in keys]
    rows = np.arange(0, 64, 3)
    got = executors._coded_group_parts(port_rpns, port_cols, rows)
    want = jax_executors._coded_group_parts(ref_rpns, ref_cols, rows)
    assert (got is None) == (want is None)
    for (gc, gn, gd), (wc, wn, wd) in zip(got or [], want or []):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gn, wn)
        assert list(gd) == list(wd)


def test_cols_for_eval_matches_jax():
    port_cols = _columns(True, np.random.default_rng(4))
    ref_cols = _columns(False, np.random.default_rng(4))
    for needed in (None, {1}, {0, 2}):
        got = executors.cols_for_eval(port_cols, needed)
        want = jax_executors.cols_for_eval(ref_cols, needed)
        assert got.keys() == want.keys()
        for i in got:
            assert list(got[i][0]) == list(want[i][0])
            np.testing.assert_array_equal(got[i][1], want[i][1])
