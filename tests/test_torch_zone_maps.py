"""Zone maps: the port's ``copr/zone_maps.py`` against the JAX package's.

On the same caches (plain, where zones are built lazily, and encoded, where
the stats pass builds them from the payloads) every block's zones, every
keep mask of ``prune_blocks`` and every ``topn_cutoff_order`` mask equal the
JAX package's.  The conjuncts are compiled once by the JAX package and
carried across node by node, so both sides see the same RPN, including the
``in`` and NULL-constant shapes the port's evaluator does not compile.
"""

import numpy as np
import pytest

from test_torch_encoding import _blocks, jax_cache, port_cache
from tikv_tpu.copr import zone_maps as jzm
from tikv_tpu.copr.datatypes import EvalType as JaxEvalType
from tikv_tpu.copr.rpn import Constant, call, col, compile_expr, const_decimal, const_int
from tikv_tpu_torch.copr import zone_maps as pzm
from tikv_tpu_torch.copr.datatypes import EvalType
from tikv_tpu_torch.copr.rpn import RpnExpression, RpnNode

_LINEITEM = [("int", 0), ("int", 0), ("decimal", 2), ("decimal", 2), ("int", 0), ("bytes", 0),
             ("bytes", 0)]
_NULLABLE = [("int", 0), ("int", 0), ("int", 0), ("int", 0), ("decimal", 2), ("real", 0),
             ("bytes", 0), ("bytes", 0), ("bytes", 0), ("int", 0)]


def _port_rpn(rpn) -> RpnExpression:
    """A JAX-compiled RPN as the port's, node for node."""
    return RpnExpression([RpnNode(n.kind, EvalType(n.eval_type.value), n.frac, n.index,
                                  n.value, n.op, n.arity, tuple(n.scale_by)) for n in rpn.nodes])


def _conjuncts(table):
    schema = [(JaxEvalType(et), f) for et, f in (_NULLABLE if table == "nullable" else _LINEITEM)]
    if table == "nullable":
        sets = {
            "is_null_all_null": [call("is_null", col(1))],
            "is_null_mixed": [call("is_null", col(2))],
            "runs_ge": [call("ge", col(3), const_int(3))],
            "runs_eq_null_const": [call("eq", col(3), Constant(None, JaxEvalType.INT))],
            "mixed_range": [call("gt", col(2), const_int(150)), call("lt", col(9), const_int(8))],
            "half_eq": [call("eq", col(9), const_int(7))],
            "half_ne": [call("ne", col(9), const_int(7))],
            "wide": [call("lt", col(4), const_decimal(-(1 << 41), 2))],
            "handle_in": [call("in", col(0), const_int(5), const_int(2999))],
            "codes": [call("ge", col(8), const_int(3))],
        }
    else:
        sets = {
            "q6": [call("ge", col(4), const_int(9000)), call("lt", col(4), const_int(9365)),
                   call("ge", col(3), const_decimal(2, 2)),
                   call("le", col(3), const_decimal(4, 2)), call("lt", col(1), const_int(24))],
            "selective": [call("lt", col(4), const_int(8410)), call("gt", col(1), const_int(5)),
                          call("ge", col(2), const_int(100000))],
            "const_first": [call("gt", const_int(8500), col(4))],
            "late": [call("ge", col(4), const_int(10590))],
            "handle_le": [call("le", col(0), const_int(2000))],
            "ship_in": [call("in", col(4), const_int(8401), const_int(10599))],
            "price_decimal": [call("gt", col(2), const_decimal(10499000, 2))],
        }
    return {name: [compile_expr(e, schema) for e in conds] for name, conds in sets.items()}


@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("table", ["lineitem", "lineitem_shipdate", "nullable"])
def test_zones_match_the_jax_package(table, encode):
    jc, _ = jax_cache(_blocks(table), encode)
    pc, _ = port_cache(_blocks(table), encode)
    assert all(b.zones is None for b in pc.blocks) != encode
    assert jzm.ensure_zones(jc) and pzm.ensure_zones(pc)
    for jb, pb in zip(jc.blocks, pc.blocks):
        assert sorted(jb.zones) == sorted(pb.zones)
        for ci, jz in jb.zones.items():
            pz = pb.zones[ci]
            assert (jz.lo, jz.hi, jz.null_lo, jz.null_hi, jz.n) == \
                (pz.lo, pz.hi, pz.null_lo, pz.null_hi, pz.n), (ci, jz, pz)


@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("table", ["lineitem", "lineitem_shipdate", "nullable"])
def test_prune_blocks_keep_masks_match_the_jax_package(table, encode):
    jc, _ = jax_cache(_blocks(table), encode)
    pc, _ = port_cache(_blocks(table), encode)
    pruned_some = False
    for name, rpns in _conjuncts(table).items():
        prpns = [_port_rpn(r) for r in rpns]
        assert [jzm._recognize(r) for r in rpns] == [pzm._recognize(r) for r in prpns], name
        js, ps = jzm.PruneStats(), pzm.PruneStats()
        want = jzm.prune_blocks(jc, rpns, stats=js, count=False)
        got = pzm.prune_blocks(pc, prpns, ps)
        assert (want is None) == (got is None), name
        if got is not None:
            np.testing.assert_array_equal(got, want, err_msg=name)
            pruned_some = True
        assert (js.examined, js.pruned) == (ps.examined, ps.pruned), name
    assert pruned_some


def test_date_sorted_q6_prunes_most_blocks():
    pc, _ = port_cache(_blocks("lineitem_shipdate"))
    keep = pzm.prune_blocks(pc, [_port_rpn(r) for r in _conjuncts("lineitem")["q6"]])
    assert keep is not None and keep.sum() <= len(keep) // 4


def test_pruning_can_be_switched_off():
    pc, _ = port_cache(_blocks("lineitem_shipdate"))
    rpns = [_port_rpn(r) for r in _conjuncts("lineitem")["q6"]]
    assert pzm.enabled()
    pzm.set_enabled(False)
    try:
        assert pzm.prune_blocks(pc, rpns) is None
    finally:
        pzm.set_enabled(True)
    assert pzm.prune_blocks(pc, rpns) is not None
    assert pzm.prune_blocks(pc, []) is None


@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("table", ["lineitem", "lineitem_shipdate", "nullable"])
def test_topn_cutoff_order_matches_the_jax_package(table, encode):
    jc, _ = jax_cache(_blocks(table), encode)
    pc, _ = port_cache(_blocks(table), encode)
    jzm.ensure_zones(jc)
    pzm.ensure_zones(pc)
    n = len(pc.blocks)
    keeps = [np.ones(n, dtype=bool), np.arange(n) % 3 != 1]
    cols = range(10) if table == "nullable" else range(7)
    cut_some = False
    for keep in keeps:
        for ci in cols:
            for desc in (False, True):
                for k in (1, 100, 2048, 10 ** 6):
                    want = jzm.topn_cutoff_order(jc.blocks, keep, ci, desc, k)
                    got = pzm.topn_cutoff_order(pc.blocks, keep, ci, desc, k)
                    assert (want is None) == (got is None), (ci, desc, k)
                    if got is not None:
                        np.testing.assert_array_equal(got, want)
                        cut_some |= bool((keep & ~got).any())
    assert cut_some or table == "lineitem"
