"""Differential: the port's fused block step and scan against the JAX programs.

The JAX package's ``_build_agg_fn(1)`` (one block) and ``_build_scan_fn(1,
nb)`` (a stacked image), run here on the CPU, against the port's plain
version of the fused kernel on the same inputs: the packed states must
agree, int leaves exactly and f64 leaves to rel 1e-12 (REAL sums are summed
in another order: the JAX package's own exemption, jax_eval.py:19-20).  Also
the kernel's layout contract and the compiler's declines.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__ as graft
from tikv_tpu.copr import jax_eval
from tikv_tpu.copr.aggr import AggDescriptor
from tikv_tpu.copr.dag import Aggregation, DagRequest, Selection, TableScan
from tikv_tpu.copr.dag_wire import dag_to_wire
from tikv_tpu.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu.copr.rpn import call, col, const_int, const_real
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import rpn as trpn
from tikv_tpu_torch.copr.datatypes import EvalType
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

CPU = torch.device("cpu")


def _real_dag():
    """A REAL-argument plan: selection and every aggregate over f64 lanes."""
    cols = [
        ColumnInfo(1, FieldType.int64(), is_pk_handle=True),
        ColumnInfo(2, FieldType.int64()),
        ColumnInfo(3, FieldType.double()),
        ColumnInfo(4, FieldType.decimal_type(2)),
    ]
    conds = [call("lt", col(2), const_real(7000.0)), call("ge", col(1), const_int(5))]
    aggs = [
        AggDescriptor("count", col(2)),
        AggDescriptor("sum", call("multiply", col(2), col(2))),
        AggDescriptor("avg", col(2)),
        AggDescriptor("min", col(2)),
        AggDescriptor("max", call("plus", col(2), col(1))),
        AggDescriptor("sum", col(3)),
    ]
    return DagRequest(executors=[TableScan(1, cols), Selection(conds), Aggregation([], aggs)])


def _inputs(ev, n_rows, n_blocks, rng, null_p):
    """Per device column ``[n_blocks, n_rows]`` data (f64 for REAL lanes)
    and per nullable column a null mask."""
    data, nulls = [], []
    for i in ev.device_cols:
        et = ev.schema[i][0]
        if et.value == "real":
            data.append(rng.uniform(0.0, 10000.0, (n_blocks, n_rows)))
        else:
            data.append(rng.integers(1, 10000, (n_blocks, n_rows)).astype(np.int64))
    for _ in ev.nullable_cols:
        nulls.append(rng.random((n_blocks, n_rows)) < null_p)
    return data, nulls


def _port(ev_jax, n_rows):
    port = TorchDagEvaluator(dag_to_wire(ev_jax.dag), block_rows=n_rows, device="cpu")
    assert port.plan.device_cols == ev_jax.device_cols
    assert port.plan.nullable_cols == ev_jax.nullable_cols
    return port


def _image(port, data, nulls, n_valids):
    nb, br = data[0].shape
    null_of = dict(zip(port.plan.nullable_cols, nulls))
    cols = [torch.from_numpy(d) for d in data]
    nls = [None if i not in null_of else torch.from_numpy(null_of[i])
           for i in port.plan.device_cols]
    nv = n_valids if isinstance(n_valids, int) else torch.from_numpy(n_valids)
    return fa.Image(cols, nls, nv, nb, br, CPU)


def _assert_packed(got, want_int, want_flt):
    gi, gf = got[0].numpy(), got[1].numpy()
    np.testing.assert_array_equal(gi, np.asarray(want_int))
    np.testing.assert_allclose(gf, np.asarray(want_flt), rtol=1e-12, atol=0)


def _packed_carry(ev_jax, state):
    ints, flts = jax_eval._pack_state(state)
    return (torch.from_numpy(np.array(ints)), torch.from_numpy(np.array(flts)))


def _init_state(ev_jax):
    return (jnp.full(1, jax_eval._NO_ROW, dtype=jnp.int64),
            tuple(da.init_carry(1) for da in ev_jax.device_aggs))


def test_graft_entry_block_step():
    """The JAX package's own example step: zeroed carries in, one block."""
    agg_fn, (col_data, col_nulls, n_valid, gids, off, state) = graft.entry()
    ev = jax_eval.JaxDagEvaluator(graft._dag(), block_rows=n_valid)
    port = _port(ev, n_valid)
    carry = _packed_carry(ev, state)
    img = _image(port, [np.asarray(d)[None, :] for d in col_data],
                 [np.asarray(m)[None, :] for m in col_nulls], n_valid)
    got = fa.fused_agg_plain(port.program, img, carry)
    want = jax_eval._pack_state(agg_fn(col_data, col_nulls, n_valid, gids, off, state))
    _assert_packed(got, *want)


@pytest.mark.parametrize("variant", ["graft", "graft_nullable", "real", "real_nullable"])
@pytest.mark.parametrize("n_valid", [2048, 1500, 0])
def test_block_step_matches_jax(variant, n_valid):
    rng = np.random.default_rng(11)
    dag = graft._dag() if variant.startswith("graft") else _real_dag()
    null_p = 0.2 if variant.endswith("nullable") else 0.0
    n_rows = 2048
    ev = jax_eval.JaxDagEvaluator(dag, block_rows=n_rows)
    port = _port(ev, n_rows)
    data, nulls = _inputs(ev, n_rows, 1, rng, null_p)
    state = _init_state(ev)
    gids = np.zeros(n_rows, dtype=np.int32)
    out = ev._build_agg_fn(1)([d[0] for d in data], [m[0] for m in nulls], n_valid, gids, 0,
                              state)
    want = jax_eval._pack_state(out)
    got = fa.fused_agg(port.program, _image(port, data, nulls, n_valid))
    _assert_packed(got, *want)
    # and carried across a second block, as the cold path does
    data2, nulls2 = _inputs(ev, n_rows, 1, rng, null_p)
    out2 = ev._build_agg_fn(1)([d[0] for d in data2], [m[0] for m in nulls2], n_rows, gids,
                               n_valid, out)
    got2 = fa.fused_agg(port.program, _image(port, data2, nulls2, n_rows), got)
    _assert_packed(got2, *jax_eval._pack_state(out2))


@pytest.mark.parametrize("variant", ["graft", "graft_nullable", "real", "real_nullable"])
def test_stacked_scan_matches_jax(variant):
    rng = np.random.default_rng(5)
    dag = graft._dag() if variant.startswith("graft") else _real_dag()
    null_p = 0.25 if variant.endswith("nullable") else 0.0
    n_rows, nb = 512, 7
    ev = jax_eval.JaxDagEvaluator(dag, block_rows=n_rows)
    port = _port(ev, n_rows)
    data, nulls = _inputs(ev, n_rows, nb, rng, null_p)
    n_valids = np.array([512, 0, 512, 300, 0, 512, 77], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(n_valids)[:-1]]).astype(np.int64)
    gids = np.zeros((nb, n_rows), dtype=np.int32)
    want = ev._build_scan_fn(1, nb)(tuple(data), tuple(nulls), n_valids, gids, offsets, None)
    got = fa.fused_agg(port.program, _image(port, data, nulls, n_valids))
    _assert_packed(got, *want)


def test_partials_then_combine_equals_fused_plain():
    gen = torch.Generator().manual_seed(3)
    from tikv_tpu_torch.fixtures import synthetic_case

    prog, img = synthetic_case(9, 1024, gen, CPU)
    want = fa.fused_agg_plain(prog, img)
    scratch = fa.partials_plain(prog, img, grid=5, threads=64)
    got = fa.combine_plain(prog, scratch)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0)
    # a carry folds in place, leaf by leaf
    carry = (want[0].clone(), want[1].clone())
    fa.combine_plain(prog, scratch, carry)
    again = fa.fused_agg_plain(prog, img, (want[0].clone(), want[1].clone()))
    assert torch.equal(carry[0], again[0])
    torch.testing.assert_close(carry[1], again[1], rtol=1e-12, atol=0)


def test_opcodes_match_the_cuda_source():
    csrc = Path(fa.__file__).resolve().parent.parent / "csrc"
    text = (csrc / "fa_walk.cuh").read_text() + (csrc / "fused_agg.cu").read_text()
    table = {m.group(1): int(m.group(2))
             for m in re.finditer(r"FA_(OP_\w+|AGG_\w+) = (\d+)", text)}
    assert len(table) == 35
    names = {k: v for k, v in vars(fa).items() if k.startswith(("OP_", "AGG_")) and isinstance(v, int)}
    assert table == names


def test_params_struct_layout():
    # FaParams in csrc/fused_agg.cu: 16+16 pointers, the 384-byte column
    # descriptors (FaEnc: int64[16], 16 pointers, int32[16], four int8[16]),
    # n_valids pointer, three int64, 64 int64 constants, 256 int32 code words,
    # three int32, four int32[16] tables, padded to 8 bytes; the wrapper
    # re-checks the kernel's sizeof at load
    assert ctypes.sizeof(fa._Enc) == 384
    assert ctypes.sizeof(fa._Params) == 2480
    p = fa.program_params(TorchDagEvaluator(
        dag_to_wire(graft._dag()), block_rows=64, device="cpu").program)
    assert p.n_aggs == 4 and p.n_cols == 4


def _schema(n):
    return [(EvalType.INT, 0)] * n


def test_compiler_declines_deep_expressions():
    e = trpn.col(0)
    for _ in range(fa.MAX_STACK):
        e = trpn.call("plus", trpn.col(0), e)
    rpn = trpn.compile_expr(e, _schema(1))
    with pytest.raises(fa.Unsupported) as exc:
        fa.compile_program([], [("sum", rpn)], [0], _schema(1))
    assert exc.value.cause == "expr_too_deep"


def test_compiler_declines_too_many_columns():
    n = fa.MAX_COLS + 1
    rpn = trpn.compile_expr(trpn.col(0), _schema(n))
    with pytest.raises(fa.Unsupported) as exc:
        fa.compile_program([], [("sum", rpn)], list(range(n)), _schema(n))
    assert exc.value.cause == "plan_too_large"


def test_kernel_path_refuses_cpu_and_other_devices():
    prog = TorchDagEvaluator(dag_to_wire(graft._dag()), block_rows=64, device="cpu").program
    img = fa.Image([torch.zeros((1, 64), dtype=torch.int64)] * 4, [None] * 4, 64, 1, 64, CPU)
    with pytest.raises(ValueError, match="CUDA image"):
        fa.launch_partials(prog, img, torch.zeros((1, 4, 2), dtype=torch.int64))
    meta = fa.Image(img.cols, img.nulls, 64, 1, 64, torch.device("meta"))
    with pytest.raises(ValueError, match="no fused_agg"):
        fa.fused_agg(prog, meta)


def test_library_name_hashes_the_shared_header(tmp_path, monkeypatch):
    from tikv_tpu_torch import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for rel in [*_build.SOURCES.values(), "csrc/fa_walk.cuh"]:
        (tmp_path / rel).write_bytes((_build.PACKAGE_DIR / rel).read_bytes())
    monkeypatch.setattr(_build, "PACKAGE_DIR", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    (csrc / "fa_walk.cuh").write_text((csrc / "fa_walk.cuh").read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)  # every name hashes the headers
