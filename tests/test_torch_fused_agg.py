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
from tikv_tpu_torch import fixtures as fx
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


# ---------------------------------------------------------------------------
# fused_agg_partials' tile walk: its grid, its rows, its instance
# ---------------------------------------------------------------------------

def _int_image(rng, n_blocks, block_rows, n_valids):
    """One nullable INT column over ``n_blocks`` blocks, and the capacity-1
    program count(*), count, sum, min, max of it."""
    from tikv_tpu_torch.copr.rpn import col as tcol, compile_expr

    schema = _schema(1)
    data = rng.integers(-(1 << 40), 1 << 40, (n_blocks, block_rows))
    nulls = rng.random((n_blocks, block_rows)) < 0.1
    rpn = compile_expr(tcol(0), schema)
    aggs = [("count", None), ("count", rpn), ("sum", rpn), ("min", rpn), ("max", rpn)]
    prog = fa.compile_program([], aggs, [0], schema)
    img = fa.Image([torch.from_numpy(data)], [torch.from_numpy(nulls)],
                   torch.from_numpy(np.asarray(n_valids, dtype=np.int64)), n_blocks, block_rows,
                   CPU)
    return prog, img, data, nulls


@pytest.mark.parametrize("block_rows", [1001, 1024])
def test_partials_plain_follows_the_tile_assignment(block_rows):
    """partials_plain's per-block counts, sums, minima and maxima under the
    kernel's tile assignment equal a numpy assignment of the same rows:
    row i of block b lies in tile b * ceil(block_rows / 4) + i // 4 and tile
    u in block (u mod grid * THREADS) // THREADS; n_valid 0, n_valid not a
    multiple of 4 and a block's short last tile (1,001 rows) among them,
    and enough blocks that the grid strides."""
    rng = np.random.default_rng(41)
    nb = 600
    nv = rng.integers(0, block_rows + 1, nb)
    nv[::7] = 0
    nv[1::7] = block_rows
    nv[2::7] = rng.integers(0, block_rows // 4, len(nv[2::7])) * 4 + 3
    prog, img, data, nulls = _int_image(rng, nb, block_rows, nv)
    grid = fa.launch_grid(img)
    assert grid == fa.GRID_MAX and grid * fa.THREADS * fa.ROWS < nb * block_rows
    parts = fa.partials_plain(prog, img)
    assert tuple(parts.shape) == (grid, len(prog.aggs), 2)
    rows = np.arange(nb * block_rows)
    b, i = rows // block_rows, rows % block_rows
    tile = b * -(-block_rows // fa.ROWS) + i // fa.ROWS
    blk = (tile % (grid * fa.THREADS)) // fa.THREADS
    valid = i < nv[b]
    live = valid & ~nulls.reshape(-1)
    x = data.reshape(-1)
    counts = [np.bincount(blk[valid], minlength=grid), np.bincount(blk[live], minlength=grid)]
    sums = np.zeros(grid, dtype=np.int64)
    np.add.at(sums, blk[live], x[live])
    mins = np.full(grid, np.iinfo(np.int64).max)
    np.minimum.at(mins, blk[live], x[live])
    maxs = np.full(grid, np.iinfo(np.int64).min)
    np.maximum.at(maxs, blk[live], x[live])
    np.testing.assert_array_equal(parts[:, 0, 0].numpy(), counts[0])
    for k, want in ((1, None), (2, sums), (3, mins), (4, maxs)):
        np.testing.assert_array_equal(parts[:, k, 0].numpy(), counts[1])
        if want is not None:
            np.testing.assert_array_equal(parts[:, k, 1].numpy(), want)


@pytest.mark.parametrize("name", fx.AGG_EDGE_CASES)
def test_capacity_one_edges_through_the_plain_pair(name):
    """fx.agg_edge_cases on the CPU: the partials' plain version at the
    kernel's grid and tiles, folded by the combine's, equals the one-pass
    plain version: count, sum, min and max over int64, decimal and f64
    lanes, NaN and +-inf among the REAL values (integers exactly, f64 to rel
    1e-12 with NaN equal to NaN), over ragged and encoded images and blocks
    zone maps pruned."""
    prog, img = fx.agg_edge_cases(CPU, (name,))[name]
    parts = fa.partials_plain(prog, img)
    assert parts.shape[0] == fa.launch_grid(img)
    got = fa.combine_plain(prog, parts)
    want = fa.fused_agg_plain(prog, img)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0, equal_nan=True)
    kinds = {leaf.kind for leaf in prog.aggs}
    if not name.startswith("date_sorted"):
        assert kinds == {fa.AGG_COUNT, fa.AGG_SUM, fa.AGG_MIN, fa.AGG_MAX}
        assert {leaf.is_f64 for leaf in prog.aggs} == {False, True}
        assert bool(want[1].isnan().any() or want[1].isinf().any())
    else:
        nv = img.n_valids
        assert bool((nv == 0).any()) and bool((nv > 0).any())  # blocks pruned, blocks kept


def test_capacity_one_grid_depends_on_the_image_shape_alone():
    """fused_agg_partials' grid: one block per THREADS tiles of ROWS rows of
    a block (a short last tile counts whole), at most GRID_MAX, whatever
    the rows hold or how many of them are valid."""
    rng = np.random.default_rng(43)
    for (nb, br), want in (((763, 1 << 17), 528), ((1, 1 << 16), 64), ((16, 1 << 16), 528),
                           ((3, 1001), 3), ((1, 1), 1), ((0, 4096), 1)):
        grids = set()
        for nv in (br, 0, torch.from_numpy(rng.integers(0, br + 1, nb))):
            grids.add(fa.launch_grid(fa.Image([], [], nv, nb, br, CPU)))
        if nb * br <= 1 << 20:
            grids.add(fa.launch_grid(_int_image(rng, nb, br, rng.integers(0, br + 1, nb))[1]))
        assert grids == {want}, (nb, br)


@pytest.mark.parametrize("slots", [2, 4, 8])
def test_capacity_one_instance_follows_the_plan(slots):
    """The launcher runs the fused_agg_partials instance whose stack holds
    the plan: the fewest of 2, 4 or 8 slots, read from the plan's code as
    the grouped launchers read it."""
    for shape in ("ragged", "encoded"):
        name = f"{shape}_s{slots}"
        prog, _img = fx.agg_edge_cases(CPU, (name,))[name]
        depth = fa.stack_depth(prog.code)
        assert fa.partials_slots(prog) == fa.stack_slots([prog.code]) == slots
        assert depth <= slots and (slots == 2 or depth > slots // 2)


def test_capacity_one_and_wide_instances_match_the_cuda_source():
    """The partials kernels' geometry and instances in csrc/fused_agg.cu
    against the wrappers': FA_THREADS, FA_GRID and GA_ROWS, the instances of
    2, 4 and 8 stack slots of fused_agg_partials and group_wide_partials,
    both on the tile walk (the wide route's selection first), and no
    one-row walk of the row loop left."""
    src = (Path(fa.__file__).resolve().parent.parent / "csrc" / "fused_agg.cu").read_text()
    defines = dict(re.findall(r"#define (\w+) (\d+)", src))
    assert int(defines["FA_THREADS"]) == fa.THREADS
    assert int(defines["FA_GRID"]) == fa.GRID_MAX
    assert int(defines["GA_ROWS"]) == fa.ROWS
    for slots in (2, 4, 8):
        assert f"fused_agg_partials<{slots}>" in src and f"group_wide_partials<{slots}>" in src
    assert "fa_walk_tile<R, D>(" in src and src.count("fa_walk_tile<R, D, false, true>(") == 1
    assert "ga_rows(" not in src and "ga_tile_ids<1>" in src and "gw_row<D>" in src


def test_partials_launchers_refuse_2_to_the_31_tiles():
    """fused_agg_partials and the wide route index tiles in 32 bits: an
    image of 2^31 tiles (of ROWS rows) or more is refused, one below it
    passes."""
    fa.check_tiles(fa.Image([], [], 0, (1 << 31) // 1024 - 1, 4096, CPU))
    with pytest.raises(ValueError, match="2\\^31 tiles"):
        fa.check_tiles(fa.Image([], [], 0, (1 << 31) // 1024, 4096, CPU))
    with pytest.raises(ValueError, match="2\\^31 tiles"):
        fa.check_tiles(fa.Image([], [], 0, 1, (1 << 33) + 1, CPU))
