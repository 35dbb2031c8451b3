"""Scan/filter plans: the port against the JAX evaluator and the CPU pipeline.

``TableScan → Selection? → Limit?`` over a few thousand lineitem rows, cold
(KV bytes through the row decoder) and warm (a resident block cache carried
across from the JAX cache's decoded blocks), at block_rows 256 and 1024.
``SelectResponse.encode()`` of the port (``device="cpu"``: the mask's plain
version) must equal that of ``JaxDagEvaluator`` and of the CPU
``BatchExecutorsRunner``, byte for byte.  Also: the plain mask against the
JAX package's mask program on the same seeded draws, the early stop of a
cold Limit, the warm doubling prefix, and a TopN-free Limit after an
aggregation (Q6 + Limit).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from tikv_tpu.copr import jax_eval
from tikv_tpu.copr.cache import ColumnBlockCache as JaxCache
from tikv_tpu.copr.dag import BatchExecutorsRunner, DagRequest, Limit, Selection, TableScan
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.executors import CachedBlocksExecutor, FixtureScanSource as JaxSource
from tikv_tpu.copr.rpn import call, col, const_decimal, const_int, const_real
from tikv_tpu.copr.table import encode_row, record_key
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_mask as fm
from tikv_tpu_torch.copr import torch_eval
from tikv_tpu_torch.copr.cache import ColumnBlockCache
from tikv_tpu_torch.copr.dag_wire import dag_from_wire
from tikv_tpu_torch.copr.dag_wire import dag_to_wire as port_wire
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.fused_agg import Image
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator, decline_cause

N_ROWS = 3000
CPU = torch.device("cpu")


def _nullable_schema():
    return [ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
            ColumnInfo(2, FieldType.int64()),
            ColumnInfo(3, FieldType.decimal_type(2)),
            ColumnInfo(4, FieldType.double()),
            ColumnInfo(5, FieldType.varchar())]


def _nullable_kvs(n):
    rng = np.random.default_rng(21)
    holes = rng.random((4, n)) < 0.15
    a, b, c = rng.integers(-50, 50, n), rng.integers(0, 10**6, n), rng.normal(size=n)
    kvs = []
    for h in range(n):
        vals = [int(a[h]), int(b[h]), float(c[h]), b"xyz"[h % 3 : h % 3 + 1]]
        vals = [None if holes[j, h] else v for j, v in enumerate(vals)]
        kvs.append((record_key(bench.TABLE_ID, h), encode_row(_nullable_schema()[1:], vals)))
    return kvs


_KVS = {}


def _kvs(kind):
    if kind not in _KVS:
        _KVS[kind] = bench.build_kvs(N_ROWS, seed=4) if kind == "lineitem" else _nullable_kvs(N_ROWS)
    return _KVS[kind]


def _plans():
    scan = TableScan(bench.TABLE_ID, bench._lineitem())
    nscan = TableScan(bench.TABLE_ID, _nullable_schema())
    return {
        "scan_limit": (bench._filter_dag("scan", 700), "lineitem"),
        "scan_all": (DagRequest(executors=[scan]), "lineitem"),
        "scan_offsets": (DagRequest(executors=[scan, Limit(900)], output_offsets=[6, 0, 2]),
                         "lineitem"),
        "one_predicate": (DagRequest(executors=[scan, Selection([
            call("le", col(4), const_int(9000))])]), "lineitem"),
        "three_predicates": (bench._filter_dag("filter"), "lineitem"),
        "three_predicates_limit": (bench._filter_dag("filter", 50), "lineitem"),
        "selection_limit_across_blocks": (DagRequest(executors=[scan, Selection([
            call("gt", col(1), const_int(25))]), Limit(1100)]), "lineitem"),
        "limit_zero": (DagRequest(executors=[scan, Selection([
            call("gt", col(1), const_int(25))]), Limit(0)]), "lineitem"),
        "nullable": (DagRequest(executors=[nscan, Selection([
            call("or", call("lt", col(1), const_int(0)), call("is_null", col(2))),
            call("ge", col(2), const_decimal(-3000, 2))])]), "nullable"),
        "real_and_offsets": (DagRequest(executors=[nscan, Selection([
            call("gt", col(3), const_real(0.25))]), Limit(400)], output_offsets=[4, 3]),
            "nullable"),
    }


def _blocks_of(jax_cache):
    return [([(c.eval_type.value, np.asarray(c.data), np.asarray(c.nulls), c.frac, c.dictionary)
              for c in b.cols], b.n_valid) for b in jax_cache.blocks]


def three_way(dag, kvs, block_rows):
    """The port cold and warm against the JAX evaluator and the CPU
    pipeline, cold and warm: every response byte-identical."""
    want = BatchExecutorsRunner(dag, JaxSource(kvs)).handle_request().encode()
    jax_cache = JaxCache()
    assert jax_eval.JaxDagEvaluator(dag, block_rows=block_rows).run(
        JaxSource(kvs), jax_cache).encode() == want
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cpu")
    cold = port.run(FixtureScanSource(kvs))
    assert cold.encode() == want, "cold port vs CPU pipeline"
    if not jax_cache.filled:  # a TopN of K = 0 reads no block: fill it with a bare scan
        jax_eval.JaxDagEvaluator(DagRequest(executors=dag.executors[:1]),
                                 block_rows=block_rows).run(JaxSource(kvs), jax_cache)
    warm = port.run(None, ColumnBlockCache.from_numpy_blocks(_blocks_of(jax_cache)))
    assert warm.encode() == want, "warm port vs CPU pipeline"
    assert jax_eval.JaxDagEvaluator(dag, block_rows=block_rows).run(
        None, jax_cache).encode() == want, "warm JAX"
    cpu_warm = BatchExecutorsRunner(
        dag, None, leaf=CachedBlocksExecutor(jax_cache, dag.executors[0].columns_info)
    ).handle_request()
    assert cpu_warm.encode() == want, "warm CPU pipeline"
    return cold


@pytest.mark.parametrize("block_rows", [256, 1024])
@pytest.mark.parametrize("case", sorted(_plans()))
def test_scan_filter_byte_identical_cold_and_warm(case, block_rows):
    dag, kind = _plans()[case]
    assert decline_cause(dag_from_wire(dag_to_wire(dag))) is None
    resp = three_way(dag, _kvs(kind), block_rows)
    if case == "limit_zero":
        assert resp.iter_rows() == []


@pytest.mark.parametrize("kind,limit", [("scan", 1000), ("filter", 100_000), ("selective", None),
                                        ("filter", 20)])
def test_filter_plans_match_the_numpy_oracle(kind, limit):
    n = 6000
    a = fx.build_arrays(n, seed=12)
    ev = TorchDagEvaluator(port_wire(fx.filter_dag(kind, limit)), block_rows=512, device="cpu")
    want = fx.filter_oracle(a, kind, limit)
    assert ev.run(FixtureScanSource(fx.build_kvs(n, seed=12))).iter_rows() == want
    assert ev.run(None, fx.build_cache(n, 512, seed=12)).iter_rows() == want


def test_port_filter_plans_are_the_bench_plans():
    for kind in ("scan", "filter"):
        assert port_wire(fx.filter_dag(kind)) == dag_to_wire(bench._filter_dag(kind))


def _mask_inputs(rng, block_rows, n_valid):
    """Seeded draws for the nullable schema's columns 1-3 and their masks."""
    data = [rng.integers(-60, 60, block_rows), rng.integers(-10**4, 10**4, block_rows),
            rng.normal(size=block_rows)]
    nulls = [rng.random(block_rows) < 0.2 for _ in data]
    valid = np.arange(block_rows) < n_valid
    return data, nulls, valid


@pytest.mark.parametrize("n_valid", [256, 200, 0])
def test_plain_mask_matches_the_jax_mask_program(n_valid):
    dag = _plans()["nullable"][0]
    dag.executors[1].conditions.append(call("le", col(3), const_real(1.0)))
    block_rows = 256
    rng = np.random.default_rng(n_valid + 3)
    data, nulls, valid = _mask_inputs(rng, block_rows, n_valid)
    jev = jax_eval.JaxDagEvaluator(dag, block_rows=block_rows)
    assert jev.device_cols == jev.nullable_cols == [1, 2, 3]
    want = np.asarray(jev._build_mask_fn()([jnp.asarray(d) for d in data],
                                           [jnp.asarray(m) for m in nulls],
                                           jnp.asarray(valid), None))
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cpu")
    img = Image([torch.from_numpy(d.reshape(1, -1)) for d in data],
                [torch.from_numpy(m.reshape(1, -1)) for m in nulls], n_valid, 1, block_rows, CPU)
    got = fm.fused_mask(port.plan.mask_program, img)
    assert got.shape == (1, block_rows)
    np.testing.assert_array_equal(got.numpy()[0], want)


@pytest.mark.parametrize("n_valid", [256, 203])
def test_plain_mask_of_every_opcode_matches_the_jax_mask_program(n_valid):
    """The conjuncts that reach every opcode of a mask program with a stack
    eight deep (``fx.every_op_selection``, the mask kernel's edge case) over
    the nullable schema's int, decimal and double columns: the port's plain
    mask against the JAX package's mask program."""
    from tikv_tpu.copr import rpn as jax_rpn

    conds = fx.every_op_selection(jax_rpn.call, jax_rpn.col, jax_rpn.const_int,
                                  jax_rpn.const_decimal, jax_rpn.const_real, cols=(1, 2, 3))
    dag = DagRequest(executors=[TableScan(bench.TABLE_ID, _nullable_schema()), Selection(conds)])
    block_rows = 256
    data, nulls, valid = _mask_inputs(np.random.default_rng(n_valid + 11), block_rows, n_valid)
    jev = jax_eval.JaxDagEvaluator(dag, block_rows=block_rows)
    assert jev.device_cols == jev.nullable_cols == [1, 2, 3]
    want = np.asarray(jev._build_mask_fn()([jnp.asarray(d) for d in data],
                                           [jnp.asarray(m) for m in nulls],
                                           jnp.asarray(valid), None))
    port = TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cpu")
    assert _stack_depth(port.plan.mask_program.code) == 8
    img = Image([torch.from_numpy(d.reshape(1, -1)) for d in data],
                [torch.from_numpy(m.reshape(1, -1)) for m in nulls], n_valid, 1, block_rows, CPU)
    got = fm.fused_mask(port.plan.mask_program, img)
    assert 0 < int(got.sum()) < n_valid
    np.testing.assert_array_equal(got.numpy()[0], want)


def _stack_depth(code) -> int:
    """The most operand slots a program's bytecode holds at once."""
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr.kernels import KERNELS

    depth = most = 0
    for word in code:
        op = word & 0xFF
        if op in (fa.OP_COL, fa.OP_CONST, fa.OP_NULL):
            depth += 1
        elif op in fa._OP_FNS:
            depth -= KERNELS[fa._OP_FNS[op]][0] - 1
        elif op in (fa.OP_FILTER, fa.OP_AGG, fa.OP_KEY):
            depth -= 1
        most = max(most, depth)
    return most


def test_mask_edge_plans_reach_every_stack_instance():
    """The mask kernel's edge plans (``fx.mask_edge_cases``) and config 2's
    plan reach each stack size of the kernel's instances (2, 4 and 8
    slots), so the on-card edge tests run every instance (the conjunct
    plans, config 2's among them, run the one with no stack)."""
    from tikv_tpu_torch.copr import fused_agg as fa

    cases = fx.mask_edge_cases(CPU)
    depths = {name: _stack_depth(prog.code) for name, (prog, _img) in cases.items()}
    assert depths == {"ragged": 2, "view": 2, "conjuncts": 2, "conjuncts_view": 2, "small": 2,
                      "encoded": 3, "encoded_view": 3, "every_op": 8}
    assert {next(s for s in (2, 4, 8) if s >= d) for d in depths.values()} == {2, 4, 8}
    prog = TorchDagEvaluator(dag_to_wire(bench._filter_dag("filter")), block_rows=1024,
                             device="cpu").plan.mask_program
    assert _stack_depth(prog.code) == 2  # config 2's plan
    assert _stack_depth([fa.OP_COL] * 3 + [fa._FN_OPS["lt"]] * 2 + [fa.OP_FILTER]) == 3


def test_mask_edge_cases_agree_with_their_plain_images():
    """The mask's edge images through the plain version: a view of blocks
    1-2 gives those blocks' rows of the whole image's mask, an encoded image
    the mask of its decoded lanes (program #1), rows past each block's
    n_valid are never kept."""
    cases = fx.mask_edge_cases(CPU, seed=3)
    whole = fm.fused_mask_plain(*cases["ragged"])
    assert torch.equal(fm.fused_mask_plain(*cases["view"]), whole[1:3])
    prog, enc = cases["encoded"]
    lanes = [enc.lanes(j) for j in range(len(enc.cols))]
    decoded = Image([d for d, _nl in lanes], [nl for _d, nl in lanes], enc.n_valids,
                    enc.n_blocks, enc.block_rows, CPU)
    got = fm.fused_mask_plain(prog, enc)
    assert torch.equal(got, fm.fused_mask_plain(prog, decoded))
    assert torch.equal(fm.fused_mask_plain(*cases["encoded_view"]), got[1:3])
    for name, (prog, img) in cases.items():
        m = fm.fused_mask_plain(prog, img)
        past = torch.arange(img.block_rows)[None, :] >= img.n_valids[:, None]
        assert not bool((m & past).any()), name
        assert 0 < int(m.sum()), name


class _CountingSource(FixtureScanSource):
    def next_batch(self, n):
        out = super().next_batch(n)
        self.rows_read = self.pos
        return out


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "decode-prefetch"]


def test_cold_limit_stops_decoding_and_the_prefetch_worker():
    n, br = 20 * 256, 256
    kvs = bench.build_kvs(n, seed=5)
    dag = bench._filter_dag("scan", 300)
    src = _CountingSource(kvs)
    before = len(_prefetch_threads())
    got = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cpu").run(src)
    assert got.encode() == BatchExecutorsRunner(dag, JaxSource(kvs)).handle_request().encode()
    # the Limit is met in block 2; the worker decodes at most two blocks ahead
    assert src.rows_read <= 5 * br
    deadline = time.monotonic() + 5
    while len(_prefetch_threads()) > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(_prefetch_threads()) == before


def test_cold_run_with_a_limit_still_fills_a_cache():
    kvs = _kvs("lineitem")
    dag = bench._filter_dag("filter", 10)
    ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=256, device="cpu")
    cache = ColumnBlockCache()
    cold = ev.run(FixtureScanSource(kvs), cache)
    assert cache.filled and cache.total_rows == N_ROWS
    assert ev.run(None, cache).encode() == cold.encode()


def test_warm_limit_launches_over_a_doubling_prefix(monkeypatch):
    n, br = 40 * 64, 64
    cache = fx.build_cache(n, br, seed=6)
    a = fx.build_arrays(n, seed=6)
    seen = []
    real = torch_eval.fused_mask

    def spy(prog, img):
        seen.append(img.n_blocks)
        return real(prog, img)

    monkeypatch.setattr(torch_eval, "fused_mask", spy)
    dag = fx.filter_dag("filter", 3)
    want = fx.filter_oracle(a, "filter", 3)
    assert TorchDagEvaluator(port_wire(dag), block_rows=br, device="cpu").run(
        None, cache).iter_rows() == want
    first = int(np.flatnonzero(fx.filter_mask(a, "filter"))[2]) // br  # block of the 3rd row
    assert seen[:-1] == [1 << i for i in range(len(seen) - 1)]
    assert seen[-1] <= 1 << (len(seen) - 1)
    assert sum(seen[:-1]) <= first < sum(seen)
    seen.clear()
    TorchDagEvaluator(port_wire(fx.filter_dag("filter", None)), block_rows=br,
                      device="cpu").run(None, cache)
    assert seen == [40]  # no Limit: one launch over the whole image


def test_scan_without_selection_launches_no_mask(monkeypatch):
    def boom(*_a):
        raise AssertionError("no mask without a selection")

    monkeypatch.setattr(torch_eval, "fused_mask", boom)
    kvs = _kvs("lineitem")
    three_way(bench._filter_dag("scan", 500), kvs, 256)


@pytest.mark.parametrize("limit", [0, 1])
def test_q6_then_limit_matches_jax_and_the_cpu_pipeline(limit):
    dag = bench.q6_dag()
    dag.executors.append(Limit(limit))
    resp = three_way(dag, _kvs("lineitem"), 1024)
    assert len(resp.iter_rows()) == limit


def test_mask_kernel_path_refuses_cpu_and_other_devices():
    gen = torch.Generator().manual_seed(1)
    prog, img = fx.synthetic_mask_case(1, 1024, gen, CPU)
    with pytest.raises(ValueError, match="CUDA image"):
        fm.launch_mask(prog, img, torch.zeros((1, 1024), dtype=torch.bool))
    img.device = torch.device("meta")
    with pytest.raises(ValueError, match="no fused_mask"):
        fm.fused_mask(prog, img)


def test_synthetic_mask_case_keeps_and_drops_rows():
    gen = torch.Generator().manual_seed(2)
    prog, img = fx.synthetic_mask_case(6, 1024, gen, CPU)
    m = fm.fused_mask_plain(prog, img)
    assert m.shape == (6, 1024)
    assert not m[1].any() and not m[-1, 1024 - 777:].any()
    assert 0 < int(m.sum()) < int(img.n_valids.sum())
