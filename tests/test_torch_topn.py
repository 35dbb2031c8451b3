"""TopN plans: the port against the JAX evaluator and the CPU pipeline.

Raw TopN (``TableScan → Selection? → TopN → Limit?``, no aggregation) over a
few thousand rows, cold and warm, byte for byte against ``JaxDagEvaluator``
and the CPU ``BatchExecutorsRunner`` (the cases of the reference's
``test_raw_topn_identical``, ``_with_nulls_identical`` and
``_extreme_values_identical``, and more: TopN + Limit, Limit(0), K above the
matching rows, a varchar payload), the unstable-dictionary raise, and the
plain top-K step against ``jax_eval._topn_step`` on seeded draws.  Then a
TopN or Limit after an aggregation (TPC-H Q1 + TopN, BASELINE config 4's
shape), served on the host over the aggregated chunk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from copr_fixtures import TABLE_ID, numeric_table_kvs
from test_torch_scan_filter import three_way
from tikv_tpu.copr import jax_eval
from tikv_tpu.copr.dag import DagRequest, Limit, Selection, TableScan, TopN
from tikv_tpu.copr.dag_wire import dag_to_wire, expr_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, EvalType, FieldType, FieldTypeTp
from tikv_tpu.copr.executors import FixtureScanSource as JaxSource
from tikv_tpu.copr.rpn import call, col, compile_expr, const_int
from tikv_tpu.copr.table import encode_row, record_key
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_topn as ft
from tikv_tpu_torch.copr import rpn as trpn
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.dag_wire import dag_from_wire, expr_from_wire
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_wire
from tikv_tpu_torch.copr.datatypes import EvalType as TEvalType
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.fused_agg import Image
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator, decline_cause

CPU = torch.device("cpu")
NUMERIC_COLS, NUMERIC_KVS, _ABC = numeric_table_kvs(3000)


def _numeric_cases():
    return {
        "asc_int": ([(col(1), False)], None, 10, None),
        "desc_int": ([(col(1), True)], None, 10, None),
        "asc_decimal": ([(col(3), False)], None, 25, None),
        "multi_key_ties": ([(col(2), False), (col(1), True)], None, 50, None),
        "filter": ([(col(1), False)], call("lt", col(2), const_int(30)), 20, None),
        "k_above_matching_rows": ([(col(1), False)], call("lt", col(1), const_int(3)), 500,
                                  None),
        "desc_handle": ([(col(0), True)], None, 7, None),
        "then_smaller_limit": ([(col(2), True), (col(0), False)], None, 300, 40),
        "then_larger_limit": ([(col(3), True)], None, 30, 1000),
        "then_limit_zero": ([(col(1), False)], None, 10, 0),
        "k_2048": ([(col(2), False), (col(3), False)], call("gt", col(1), const_int(100)),
                   2048, None),
        "expression_key": ([(call("plus", col(1), col(2)), True)], None, 60, None),
    }


def _numeric_dag(case):
    order_by, sel, k, limit = _numeric_cases()[case]
    execs = [TableScan(TABLE_ID, NUMERIC_COLS)]
    if sel is not None:
        execs.append(Selection([sel]))
    execs.append(TopN(order_by, k))
    if limit is not None:
        execs.append(Limit(limit))
    return DagRequest(executors=execs), k if limit is None else min(k, limit)


@pytest.mark.parametrize("case", sorted(_numeric_cases()))
def test_raw_topn_byte_identical_cold_and_warm(case):
    dag, k = _numeric_dag(case)
    assert decline_cause(dag_from_wire(dag_to_wire(dag))) is None
    resp = three_way(dag, NUMERIC_KVS, 256)
    if _numeric_cases()[case][1] is None:
        assert len(resp.iter_rows()) == min(k, 3000)


def test_raw_topn_with_output_offsets():
    dag = DagRequest(executors=[TableScan(TABLE_ID, NUMERIC_COLS), TopN([(col(1), True)], 33)],
                     output_offsets=[3, 1])
    three_way(dag, NUMERIC_KVS, 1024)


def _nullable_cols():
    return [ColumnInfo(col_id=1, ftype=FieldType.int64(), is_pk_handle=True),
            ColumnInfo(col_id=2, ftype=FieldType(FieldTypeTp.LONGLONG)),
            ColumnInfo(col_id=3, ftype=FieldType(FieldTypeTp.DOUBLE))]


def _nullable_kvs():
    cols = _nullable_cols()
    rng = np.random.default_rng(11)
    kvs = []
    for h in range(300):
        iv = None if h % 7 == 0 else int(rng.integers(-50, 50))
        fv = None if h % 11 == 0 else float(rng.normal())
        kvs.append((record_key(TABLE_ID, h + 1), encode_row(cols[1:], [iv, fv])))
    return kvs


@pytest.mark.parametrize("order_by", [
    [(1, False)], [(1, True)], [(2, False)], [(2, True)], [(1, False), (2, True)]])
def test_raw_topn_with_nulls_byte_identical(order_by):
    """NULLs first ascending, last descending; ties among NULLs in stream order."""
    dag = DagRequest(executors=[TableScan(TABLE_ID, _nullable_cols()),
                                TopN([(col(i), d) for i, d in order_by], 37)])
    three_way(dag, _nullable_kvs(), 64)


def _extreme_kvs():
    cols = _nullable_cols()
    vals = [(2**63 - 1, float("inf")), (-(2**63), float("-inf")), (0, 0.0), (1, 1.5),
            (-1, -1.5), (2**62, 1e308), (-(2**62), -1e308), (5, -0.0), (-5, 0.0), (7, -0.0)]
    return [(record_key(TABLE_ID, h + 1), encode_row(cols[1:], [iv, fv]))
            for h, (iv, fv) in enumerate(vals)]


@pytest.mark.parametrize("order_by", [[(1, False)], [(1, True)], [(2, False)], [(2, True)]])
def test_raw_topn_extreme_values_byte_identical(order_by):
    """+-inf, INT64_MIN/MAX (bit-NOT, never negation, for desc), -0.0 tying +0.0."""
    dag = DagRequest(executors=[TableScan(TABLE_ID, _nullable_cols()),
                                TopN([(col(i), d) for i, d in order_by], 8)])
    three_way(dag, _extreme_kvs(), 4)


def test_raw_topn_with_a_varchar_payload():
    dag = DagRequest(executors=[TableScan(TABLE_ID, bench._lineitem()),
                                Selection([call("gt", col(1), const_int(10))]),
                                TopN([(col(3), True), (col(4), False)], 90)])
    resp = three_way(dag, bench.build_kvs(3000, seed=8), 256)
    assert {r[5] for r in resp.iter_rows()} <= {b"A", b"N", b"R"}


def _unstable_kvs():
    """A varchar column whose values change between 64-row blocks: the row
    decoder gives each block its own dictionary."""
    cols = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()), ColumnInfo(3, FieldType.varchar())]
    kvs = [(record_key(TABLE_ID, h), encode_row(cols[1:], [h % 13, b"ab"[h // 64 : h // 64 + 1]]))
           for h in range(128)]
    return cols, kvs


def test_unstable_payload_dictionary_raises_like_jax():
    cols, kvs = _unstable_kvs()
    dag = DagRequest(executors=[TableScan(TABLE_ID, cols), TopN([(col(1), False)], 5)])
    with pytest.raises(ValueError, match="unstable dictionary"):
        jax_eval.JaxDagEvaluator(dag, block_rows=64).run(JaxSource(kvs))
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=64, device="cpu")
    with pytest.raises(ValueError, match="unstable dictionary"):
        port.run(FixtureScanSource(kvs))
    # warm: two resident blocks with unequal dictionaries
    d_a, d_b = np.array([b"a"], dtype=object), np.array([b"b"], dtype=object)
    z = np.zeros(64, dtype=bool)
    blocks = [([(TEvalType.INT.value, np.arange(64) + 64 * i, z, 0, None),
                (TEvalType.INT.value, np.arange(64) % 13, z, 0, None),
                (TEvalType.BYTES.value, np.zeros(64, dtype=np.int64), z, 0, d)], 64)
              for i, d in enumerate((d_a, d_b))]
    with pytest.raises(ValueError, match="unstable dictionary"):
        port.run(None, ColumnBlockCache.from_numpy_blocks(blocks))
    blocks[1][0][2] = (TEvalType.BYTES.value, np.zeros(64, dtype=np.int64), z, 0, d_a.copy())
    rows = port.run(None, ColumnBlockCache.from_numpy_blocks(blocks)).iter_rows()
    assert [r[2] for r in rows] == [b"a"] * 5  # equal dictionaries are stable


def test_non_dictionary_bytes_payload_raises():
    z = np.zeros(4, dtype=bool)
    raw = np.array([b"p", b"q", b"r", b"s"], dtype=object)
    cache = ColumnBlockCache.from_numpy_blocks([([
        (TEvalType.INT.value, np.arange(4), z, 0, None),
        (TEvalType.INT.value, np.arange(4), z, 0, None),
        (TEvalType.BYTES.value, raw, z, 0, None)], 4)])
    cols, _kvs = _unstable_kvs()
    dag = DagRequest(executors=[TableScan(TABLE_ID, cols), TopN([(col(1), False)], 2)])
    with pytest.raises(ValueError, match="not dict-coded"):
        TorchDagEvaluator(dag_to_wire(dag), block_rows=4, device="cpu").run(None, cache)


def test_empty_source_gives_no_rows():
    dag, _k = _numeric_dag("asc_int")
    want = jax_eval.JaxDagEvaluator(dag, block_rows=256).run(JaxSource([]))
    got = TorchDagEvaluator(dag_to_wire(dag), block_rows=256, device="cpu").run(
        FixtureScanSource([]))
    assert got.encode() == want.encode() and got.iter_rows() == []


def _declined():
    scan = TableScan(TABLE_ID, NUMERIC_COLS)
    lineitem = TableScan(TABLE_ID, bench._lineitem())
    return {
        # the reference serves a mod key; the port has no mod kernel yet
        "op_not_ported": DagRequest(
            executors=[scan, TopN([(call("mod", col(1), const_int(7)), False)], 40)]),
        "topn_limit_too_large": DagRequest(executors=[scan, TopN([(col(1), False)], 4096)]),
        "bytes_predicate": DagRequest(executors=[lineitem, TopN([(col(6), True)], 5)]),
        "plan_too_large": DagRequest(executors=[scan, TopN(
            [(col(1), False), (col(2), False), (col(3), False), (col(0), False),
             (call("plus", col(1), col(2)), True)], 5)]),
        "executor_shape": DagRequest(
            executors=[scan, Limit(3), TopN([(col(1), False)], 5)]),
    }


@pytest.mark.parametrize("case", sorted(_declined()))
def test_topn_plans_outside_the_port_decline_by_name(case):
    assert decline_cause(dag_from_wire(dag_to_wire(_declined()[case]))) == case


def test_raw_topn_matches_the_numpy_oracle():
    n = 5000
    a = fx.build_arrays(n, seed=13)
    ev = TorchDagEvaluator(port_wire(fx.topn_dag(100)), block_rows=1024, device="cpu")
    want = fx.topn_oracle(a, 100)
    assert ev.run(FixtureScanSource(fx.build_kvs(n, seed=13))).iter_rows() == want
    assert ev.run(None, fx.build_cache(n, 1024, seed=13)).iter_rows() == want


def test_port_topn_plan_is_the_bench_plan():
    _ep, dag, _req = bench._topn_endpoint(10, enable_device=False)
    assert port_wire(fx.topn_dag(100)) == dag_to_wire(dag())


# ---------------------------------------------------------------------------
# the plain top-K step against jax_eval._topn_step
# ---------------------------------------------------------------------------

_SCHEMA = [(EvalType.INT, 0), (EvalType.REAL, 0), (EvalType.DECIMAL, 2), (EvalType.INT, 0)]
_TSCHEMA = [(TEvalType(et.value), f) for et, f in _SCHEMA]


def _draws(rng, n, n_valid):
    data = [rng.integers(-8, 8, n),
            rng.choice(np.array([-0.0, 0.0, np.inf, -np.inf, 0.5, -3.0]), n),
            rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
            rng.integers(-100, 100, n)]
    nulls = [rng.random(n) < p for p in (0.2, 0.15, 0.0, 0.1)]
    return data, nulls, n_valid


def _jax_step(sel, keys, k, block_rows, blocks):
    sel_rpns = [compile_expr(e, _SCHEMA) for e in sel]
    order = [(compile_expr(e, _SCHEMA), d) for e, d in keys]
    dts = [jnp.int64]
    for rpn, _d in order:
        dts += [jnp.int64, jnp.float64 if rpn.eval_type == EvalType.REAL else jnp.int64]
    for et, _f in _SCHEMA:
        dts += [jnp.float64 if et == EvalType.REAL else jnp.int64, jnp.bool_]
    state = tuple((jnp.ones if i == 0 else jnp.zeros)(k, dtype=dt) for i, dt in enumerate(dts))
    for data, nulls, n_valid in blocks:
        cols = {i: (jnp.asarray(d), jnp.asarray(m)) for i, (d, m) in enumerate(zip(data, nulls))}
        state = jax_eval._topn_step(sel_rpns, order, list(range(4)), k, block_rows, cols,
                                    n_valid, state)
    state = [np.asarray(s) for s in state]
    n_out = int((state[0] == 0).sum())
    base = 1 + 2 * len(keys)
    return [(state[base + 2 * j][:n_out], state[base + 2 * j + 1][:n_out]) for j in range(4)]


def _port_step(sel, keys, k, block_rows, blocks):
    sel_rpns = [trpn.compile_expr(_to_port(e), _TSCHEMA) for e in sel]
    order = [(trpn.compile_expr(_to_port(e), _TSCHEMA), d) for e, d in keys]
    prog = ft.compile_topn_program(sel_rpns, order, [0, 1, 2, 3], _TSCHEMA, [0, 1, 2, 3], k)
    state = None
    for data, nulls, n_valid in blocks:
        img = Image([torch.from_numpy(np.ascontiguousarray(d).reshape(1, -1)) for d in data],
                    [torch.from_numpy(m.reshape(1, -1)) for m in nulls], n_valid, 1,
                    block_rows, CPU)
        state = ft.topn_step(prog, img, img, state, src_base=k)
    ints, flts = state[0].numpy(), state[1].numpy()
    n_out = int((ints[0] == 0).sum())
    return [((flts if prog.pay_f64[j] else ints)[prog.pay_row[j], :n_out],
             ints[prog.pay_null_row[j], :n_out].astype(bool)) for j in range(4)]


def _to_port(e):
    return expr_from_wire(expr_to_wire(e))


@pytest.mark.parametrize("keys", [
    [(col(0), False)],
    [(col(0), True), (col(1), False)],
    [(col(1), True), (col(2), True)],
    [(col(2), False)],
    [(call("plus", col(0), col(3)), True), (col(1), True)],
])
@pytest.mark.parametrize("k", [1, 37, 300])
def test_plain_topn_step_matches_jax_topn_step(keys, k):
    rng = np.random.default_rng(k + len(keys))
    block_rows = 256
    blocks = [_draws(rng, block_rows, nv) for nv in (256, 0, 200, 256)]
    sel = [call("gt", col(3), const_int(-60))]
    want = _jax_step(sel, keys, k, block_rows, blocks)
    got = _port_step(sel, keys, k, block_rows, blocks)
    for j, ((gd, gn), (wd, wn)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gn, wn, err_msg=f"payload {j} nulls")
        # payload under a NULL is not compared: the response never reads it
        np.testing.assert_array_equal(np.where(gn, 0, gd).view(np.int64),
                                      np.where(wn, 0, wd).view(np.int64),
                                      err_msg=f"payload {j}")


def _sorted_runs(rng, n, n_words, k, src_base=0):
    """``n`` runs ``[n_words, k]``, each sorted: ties in every word but
    ``src`` (unique)."""
    entries = np.zeros((n, n_words, k), dtype=np.int64)
    entries[:, 0] = rng.integers(0, 2, size=(n, k))
    for w in range(1, n_words - 1):
        entries[:, w] = rng.integers(-2, 2, size=(n, k))
    entries[:, -1] = src_base + rng.permutation(n * k).reshape(n, k)
    runs = torch.from_numpy(entries)
    return torch.stack([r[:, ft._lexsort(r[:, None, :])[0]] for r in runs])


def _first_k(runs, k):
    both = torch.cat(list(runs), dim=1)
    return both[:, ft._lexsort(both[:, None, :])[0][:k]]


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("fan_in,n_runs", [(2, 7), (3, 7), (5, 3), (0, 0), (0, 1)])
def test_merge_plain_takes_the_first_k_of_each_pair(fan_in, n_runs, carry):
    """merge_plain at fan-in 2 and 3 over 7 runs, 5 over 3, and at the most runs a
    topn_merge block takes at this shape (F, fan_in 0 here) over F and F + 1
    runs (a last group of one run, copied), with and without the carry as
    the last run: run j of the result is the first k entries of its group's
    runs, stably sorted in run order."""
    rng = np.random.default_rng(3 + n_runs)
    k, n_words = 16, 4
    if fan_in == 0:
        fan_in = ft.merge_fan_max(n_words, k)
        n_runs += fan_in
    runs = _sorted_runs(rng, n_runs, n_words, k)
    extra = runs[-1].clone() if carry else None
    ins = runs[:-1] if carry else runs
    out = ft.merge_plain(ins, extra, fan_in)
    assert out.shape == (-(-n_runs // fan_in), n_words, k)
    for j in range(out.shape[0]):
        group = runs[j * fan_in : (j + 1) * fan_in]
        assert torch.equal(out[j], group[0] if len(group) == 1 else _first_k(group, k))


@pytest.mark.parametrize("n_words,k,n_runs,carry", [
    (4, 100, 32, True),  # a mesh shard step: 32 tiles and the carry
    (4, 100, 16, True),  # a cold 1M-row block
    (5, 100, 8, False),  # the mesh finalize: 8 shards, one more word
    (4, 3, 900, False),  # three levels
    (4, 2048, 16, True),  # read in place, seventeen runs a block
    (11, 4096, 16, True),  # the runs read in place
    (11, 1, 70, True),
])
def test_merge_all_keeps_the_first_k_of_every_run(n_words, k, n_runs, carry):
    """The plan's levels (merge_fans) end in the first k entries of all the
    runs in run order, the carry last: what the pairwise levels gave."""
    rng = np.random.default_rng(n_runs + k)
    runs = _sorted_runs(rng, n_runs + carry, n_words, k)
    extra = runs[-1].clone() if carry else None
    got = ft._merge_all(runs[:n_runs].clone(), extra, cuda=False)
    assert torch.equal(got, _first_k(runs, k))


def test_merge_fans_take_one_launch_where_the_runs_fit():
    """One topn_merge launch merges a mesh shard step's 33 runs (K = 100,
    4 words), a cold 1M-row block's 17 and the mesh finalize's 8 (5 words);
    the warm 100M image's 24,415 take three; every K up to the tile at up to
    11 words has a block shape in shared memory."""
    from tikv_tpu_torch.copr import fused_mask as fm

    assert ft.merge_fans(33, 4, 100) == (33,)
    assert ft.merge_fans(17, 4, 100) == (17,)
    assert ft.merge_fans(8, 5, 100) == (8,)
    assert ft.merge_fans(24_415, 4, 100) == (30, 29, 29)
    assert ft.MERGE_SMEM == fm.SMEM_MAX - 8 * fm.MERGE_FAN_MAX  # TN_MERGE_SMEM
    assert ft.merge_fans(1, 4, 100) == ()
    assert ft.merge_staged(33, 4, 100) and not ft.merge_staged(2, 4, 4096)
    assert ft.merge_fan_max(4, 100) >= 33
    assert not ft.merge_staged(ft.merge_fan_max(4, 2048), 4, 2048)
    for n_words in (4, 5, 8, 10, 11):
        for k in (1, 100, 2048, 4096):
            f = ft.merge_fan_max(n_words, k)
            assert 2 <= f <= fm.MERGE_FAN_MAX
            assert ft.merge_smem(f, n_words, k, ft.merge_staged(f, n_words, k)) <= ft.MERGE_SMEM
            assert len(ft.merge_fans(24_415, n_words, k)) <= 15


def test_u64_order_words_order_like_the_values():
    vals = torch.tensor([float("-inf"), -1e308, -1.5, -0.0, 0.0, 1.5, 1e308, float("inf")],
                        dtype=torch.float64)
    w = ft._order_words(vals) ^ ft._SIGN
    assert torch.equal(w, torch.sort(w).values)
    assert w[3] == w[4]  # -0.0 ties +0.0
    ints = torch.tensor([-(2**63), -5, 0, 7, 2**63 - 1], dtype=torch.int64)
    wi = ft._order_words(ints) ^ ft._SIGN
    assert torch.equal(wi, torch.sort(wi).values)
    assert torch.equal((~ft._order_words(ints) ^ ft._SIGN).flip(0),
                       torch.sort(~ft._order_words(ints) ^ ft._SIGN).values)  # desc: bit-NOT


def test_synthetic_topn_case_runs_cold_and_warm_to_one_answer():
    gen = torch.Generator().manual_seed(4)
    prog, cand, pay = fx.synthetic_topn_case(6, 1024, 64, gen, CPU)
    warm = ft.topn_step(prog, cand, pay)
    state = None
    for b in range(6):
        blk = Image([c[b : b + 1] for c in cand.cols],
                    [None if m is None else m[b : b + 1] for m in cand.nulls],
                    int(cand.n_valids[b]), 1, 1024, CPU)
        state = ft.topn_step(prog, blk, blk, state, src_base=prog.k)
    n_out = int((warm[0][0] == 0).sum())
    assert n_out == prog.k
    assert torch.equal(warm[0][:, :n_out], state[0][:, :n_out])
    assert torch.equal(warm[1][:, :n_out].view(torch.int64), state[1][:, :n_out].view(torch.int64))


def test_topn_kernel_path_refuses_cpu_and_other_devices():
    gen = torch.Generator().manual_seed(5)
    prog, cand, pay = fx.synthetic_topn_case(1, 1024, 8, gen, CPU)
    runs = torch.zeros((ft.n_tiles(prog, cand), prog.n_words, prog.k), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA image"):
        ft.launch_candidates(prog, cand, runs, 0)
    with pytest.raises(ValueError, match="CUDA runs"):
        ft.launch_merge(runs, None, runs, 2)
    cand.device = torch.device("meta")
    with pytest.raises(ValueError, match="no topn_step"):
        ft.topn_step(prog, cand, pay)


# ---------------------------------------------------------------------------
# TopN and Limit after an aggregation
# ---------------------------------------------------------------------------

def _post_agg_cases():
    q1_topn = bench.q1_dag()
    q1_topn.executors.append(TopN([(col(7), False), (col(8), False)], 4))
    q1_desc = bench.q1_dag()
    q1_desc.executors += [TopN([(col(6), True), (col(8), True)], 5), Limit(3)]
    q1_limit = bench.q1_dag()
    q1_limit.executors.append(Limit(2))
    qty = bench.q1_dag()
    qty.executors[-1].group_by = [col(1)]
    qty.executors.append(TopN([(call("plus", col(0), col(6)), True), (col(7), False)], 7))
    return {"q1_topn": q1_topn, "q1_topn_desc_then_limit": q1_desc, "q1_limit": q1_limit,
            "int_key_expression_topn": qty}


@pytest.mark.parametrize("block_rows", [256, 1024])
@pytest.mark.parametrize("case", sorted(_post_agg_cases()))
def test_post_aggregation_topn_and_limit_byte_identical(case, block_rows):
    dag = _post_agg_cases()[case]
    assert decline_cause(dag_from_wire(dag_to_wire(dag))) is None
    three_way(dag, bench.build_kvs(3000, seed=9), block_rows)


def test_q1_topn_matches_the_numpy_oracle_and_cuts_two_groups():
    n = 8000
    a = fx.build_arrays(n, seed=14)
    want = fx.q1_topn_oracle(fx.q1_oracle(a))
    assert len(fx.q1_oracle(a)) == 6 and len(want) == 4
    ev = TorchDagEvaluator(port_wire(fx.q1_topn_dag()), block_rows=1024, device="cpu")
    assert ev.run(FixtureScanSource(fx.build_kvs(n, seed=14))).iter_rows() == want
    assert ev.run(None, fx.build_cache(n, 1024, seed=14)).iter_rows() == want
    # the TopN's keys are the group keys: columns 7 and 8 of the aggregated chunk
    assert ev.plan.agg_schema[7:] == [(TEvalType.BYTES, 0), (TEvalType.BYTES, 0)]
    jax_dag = bench.q1_dag()
    jax_dag.executors.append(TopN([(col(7), False), (col(8), False)], 4))
    assert port_wire(fx.q1_topn_dag()) == dag_to_wire(jax_dag)


def test_mask_tile_constants_match_the_cuda_source():
    """The mask kernel's tile (rows a thread) and its instances' stack slots
    in csrc/fused_scan.cu and csrc/fa_walk.cuh against the wrapper's: an
    instance of 2, 4 and 8 slots (the last the stack the compiler allows)
    and one with no stack."""
    import re
    from pathlib import Path

    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_mask as fm

    csrc = Path(fm.__file__).resolve().parent.parent / "csrc"
    scan = (csrc / "fused_scan.cu").read_text()
    walk = (csrc / "fa_walk.cuh").read_text()
    assert int(re.search(r"#define SC_MASK_ROWS (\d+)", scan).group(1)) == fm.MASK_ROWS
    assert int(re.search(r"#define FA_MAX_STACK (\d+)", walk).group(1)) == fa.MAX_STACK
    # the instances the launcher picks from, by the plan's stack depth
    for slots in (0, 2, 4, fa.MAX_STACK):
        assert f"fused_mask<{slots}>" in scan
    assert fm.MASK_ROWS == 4


@pytest.mark.parametrize("name", list(fx.PACK_EDGE_CASES))
def test_pack_edge_cases_through_the_plain_version(name):
    """pack_plain on each topn_pack edge case (``fx.pack_edge_case``: K of
    1, 100 and 2,048; 0, 5, 7 and 16 payload columns; winners from the carry
    and from the image mixed with rank-1 slots; REAL payload with NaN,
    +-inf and -0.0; an encoded payload image; the mesh finalize's [8, K]
    image) against numpy: row 0 the rank, each column's value and NULL flag
    from the carry's slot or the image's flat row, 0 and 0 for a rank-1
    slot, f64 values bit for bit; the next carry run the run with its slot
    as src."""
    prog, run, pay, carry, src_base = fx.pack_edge_case(name, "cpu")
    k = prog.k
    ints, flts, nxt = ft.pack_plain(prog, run, pay, carry, src_base)
    r = run.numpy()
    rank, src = r[0], r[-1]
    live = rank == 0
    from_carry = live & (src < src_base)
    from_img = live & ~from_carry
    assert from_img.any()
    if k >= 100:
        assert (~live).any() and (from_carry.any() == (carry is not None))
    np.testing.assert_array_equal(ints[0].numpy(), rank)
    for j, (is_f, row, nrow) in enumerate(zip(prog.pay_f64, prog.pay_row, prog.pay_null_row)):
        data, nl = pay.lanes(j)
        data = data.reshape(-1).numpy()
        nl = np.zeros(data.shape, dtype=bool) if nl is None else nl.reshape(-1).numpy()
        want = np.zeros(k, dtype=data.dtype)
        want_nl = np.zeros(k, dtype=np.int64)
        want[from_img] = data[src[from_img] - src_base]
        want_nl[from_img] = nl[src[from_img] - src_base]
        if carry is not None:
            want[from_carry] = (carry[1] if is_f else carry[0])[row].numpy()[src[from_carry]]
            want_nl[from_carry] = carry[0][nrow].numpy()[src[from_carry]]
        got = (flts if is_f else ints)[row].numpy()
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
        np.testing.assert_array_equal(ints[nrow].numpy(), want_nl)
    np.testing.assert_array_equal(nxt.numpy(), np.concatenate([r[:-1], np.arange(k)[None]]))
    assert ints.shape == (prog.n_int, k) and flts.shape == (prog.n_f64, k)


def test_pack_grid_matches_the_cuda_source():
    """topn_pack's grid in csrc/fused_scan.cu: a thread a (payload column,
    slot) cell and a (word, slot) cell of the run, ceil(k * (n_pay +
    n_words) / TP_THREADS) blocks of whole warps."""
    import re
    from pathlib import Path

    from tikv_tpu_torch.copr import fused_mask as fm

    text = (Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_scan.cu").read_text()
    threads = int(re.search(r"#define TP_THREADS (\d+)", text).group(1))
    assert threads % 32 == 0
    assert "(long long)p->k * (p->n_pay + p->n_words)" in text
    # the largest launch: K at the tile, every payload column, a finalize's words
    assert ft.TILE_MAX * (fm.MAX_PAYLOAD + ft.MERGE_WORDS_MAX) < 1 << 30


def test_scan_limits_and_parameter_blocks_match_the_cuda_source():
    import ctypes
    import re
    from pathlib import Path

    from tikv_tpu_torch.copr import fused_mask as fm

    text = (Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_scan.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", text))
    assert int(defines["TN_MAX_KEYS"]) == fm.MAX_KEYS
    assert int(defines["TN_MAX_PAYLOAD"]) == fm.MAX_PAYLOAD
    assert int(defines["TN_SMEM_MAX"]) == fm.SMEM_MAX
    assert int(defines["TN_FAN_MAX"]) == fm.MERGE_FAN_MAX
    assert int(defines["TN_MERGE_WORDS"]) == ft.MERGE_WORDS_MAX
    assert "case 2: return tm_kernel_w<2>" in text and "case 11: return tm_kernel_w<11>" in text
    assert fm.MERGE_FAN_MAX < 1 << 16 and ft.TILE_MAX <= 1 << 16  # a handle: run << 16 | slot
    assert int(defines["SC_MASK_THREADS"]) == fm.MASK_THREADS
    # ScParams: 33 pointers, the 384-byte column descriptors (FaEnc), four
    # int64, 64 constants, 256 code words, five int32, two int32[4], padded
    # to 8 bytes; TpParams: 38 pointers, the column descriptors, two int64,
    # three int32, three int32[16], padded.  Both stay under the 4 KB
    # kernel-parameter limit; the wrappers re-check the kernel's sizeof at
    # load.
    assert ctypes.sizeof(fm._ScParams) == 2272
    assert ctypes.sizeof(fm._TpParams) == 912
    # the largest entry fits the tile in shared memory, and every K fits a tile
    words = 2 + 2 * fm.MAX_KEYS
    assert ft.tile_rows(words) * (8 * words + 2) <= fm.SMEM_MAX
    assert ft.tile_rows(words) >= 2048 and ft.tile_rows(6) == ft.TILE_MAX


# ---------------------------------------------------------------------------
# topn_candidates' select: its sizes and its chunks
# ---------------------------------------------------------------------------

def test_candidate_select_sizes_match_the_cuda_source():
    """topn_candidates walks steps of TN_THREADS * TN_ROWS rows, at most
    TN_STEPS a tile, and gathers at most select_cap(k, tile) candidates:
    a power of two, at least 2k and 256, at most the tile, so every K up to
    the tile is served and the candidates' words fit shared memory."""
    import re
    from pathlib import Path

    from tikv_tpu_torch.copr import fused_mask as fm

    text = (Path(fm.__file__).resolve().parent.parent / "csrc" / "fused_scan.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", text))
    assert int(defines["TN_THREADS"]) * int(defines["TN_ROWS"]) == fm.TOPN_STEP_ROWS
    assert int(defines["TN_STEPS"]) == fm.TOPN_STEPS
    assert ft.TILE_MAX == fm.TOPN_STEP_ROWS * fm.TOPN_STEPS
    for slots in (2, 4, 8):
        assert f"topn_candidates<{slots}>" in text
    assert [ft.select_cap(k, 4096) for k in (1, 100, 128, 129, 1000, 2048, 4096)] == \
        [256, 256, 256, 512, 2048, 4096, 4096]
    for n_keys in range(fm.MAX_KEYS + 1):
        words = 2 + 2 * n_keys
        tile = ft.tile_rows(words)
        assert tile % fm.TOPN_STEP_ROWS == 0 and tile // fm.TOPN_STEP_ROWS <= fm.TOPN_STEPS
        for k in (1, 100, tile // 2 + 1, tile):
            cap = ft.select_cap(k, tile)
            assert cap & (cap - 1) == 0 and k <= cap <= tile
            assert words * cap * 8 + cap * 2 <= fm.SMEM_MAX


def _u64_shr(x, s):
    return (x >> s) & ((1 << (64 - s)) - 1)


def _select_chunks(words, n_keys, tile):
    """The chunks topn_candidates selects by (csrc/fused_scan.cu), from an
    entry's words [n_words, rows]: rank, key 0's null rank and its word's top
    62 bits; per key its word, then the next key's null rank and top 63
    bits; last the row's index in its tile."""
    rank = words[0]
    if n_keys == 0:
        chunks = [rank << 63]
    else:
        chunks = [rank << 63 | words[1] << 62 | _u64_shr(words[2], 2)]
        for q in range(n_keys):
            chunks.append(words[2 + 2 * q])
            if q + 1 < n_keys:
                chunks.append(words[3 + 2 * q] << 63 | _u64_shr(words[4 + 2 * q], 1))
    chunks.append(torch.arange(words.shape[1]) % tile)
    return torch.stack(chunks)


@pytest.mark.parametrize("name", fx.TOPN_EDGE_CASES)
def test_select_chunks_order_the_entries_as_their_words(name):
    """A tile's entries sorted by the select's chunk strings come out in the
    order of their words (the plain version's), ties, NULLs, -0.0 and the
    rows past the image included: the select narrows the right entries."""
    prog, img = fx.topn_edge_case(name, CPU, seed=3)
    words = ft.entry_words(prog, img, 0)
    pad = ft.n_tiles(prog, img) * prog.tile - words.shape[1]
    filler = torch.zeros((prog.n_words, pad), dtype=torch.int64)
    filler[0], filler[-1] = 1, -1
    words = torch.cat([words, filler], dim=1)
    chunks = _select_chunks(words, prog.n_keys, prog.tile)
    nt, t = ft.n_tiles(prog, img), prog.tile
    by_words = ft._lexsort(words.reshape(prog.n_words, nt, t))
    by_chunks = ft._lexsort(chunks.reshape(chunks.shape[0], nt, t))
    tiles = words.reshape(prog.n_words, nt, t)
    for w in range(prog.n_words):
        assert torch.equal(tiles[w].gather(1, by_words), tiles[w].gather(1, by_chunks))
