"""The port's CUDA kernels on the card (marker ``gpu``).

Each test takes the ``cuda`` fixture, which skips when no CUDA device is
present, so every worker collects the same tests.  On a machine with the
card: ``python -m pytest tests/test_torch_gpu.py -m gpu -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import fused_group_agg as ga
from tikv_tpu_torch.copr import fused_mask as fm
from tikv_tpu_torch.copr import fused_topn as ft
from tikv_tpu_torch.copr.fused_agg import Image
from tikv_tpu_torch.copr.dag_wire import dag_to_wire
from tikv_tpu_torch.copr.executors import FixtureScanSource
from tikv_tpu_torch.copr.rpn import call, col, const_int
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _assert_close(got, want):
    assert torch.equal(got[0].cpu(), want[0].cpu())  # int leaves exact
    # NaN where the plain version has NaN (the host_wide case adds NaN rows)
    torch.testing.assert_close(got[1].cpu(), want[1].cpu(), rtol=1e-12, atol=0, equal_nan=True)


@pytest.mark.parametrize("n_blocks,block_rows", [(1, 1 << 16), (40, 1 << 17)])
def test_kernel_matches_plain_version(cuda, n_blocks, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(1)
    prog, img = fx.synthetic_case(n_blocks, block_rows, gen, cuda)
    got = fa.fused_agg(prog, img)
    _assert_close(got, fa.fused_agg_plain(prog, img))
    again = fa.fused_agg(prog, img)
    assert torch.equal(got[0], again[0])
    assert torch.equal(got[1].view(torch.int64), again[1].view(torch.int64))
    scratch = fa.new_scratch(prog, img)
    fa.launch_partials(prog, img, scratch)
    want = fa.partials_plain(prog, img)
    for k, leaf in enumerate(prog.aggs):
        assert torch.equal(scratch[:, k, 0], want[:, k, 0])
        if leaf.is_f64:
            torch.testing.assert_close(scratch[:, k, 1].view(torch.float64),
                                       want[:, k, 1].view(torch.float64), rtol=1e-12, atol=0)
        elif leaf.kind != fa.AGG_COUNT:
            assert torch.equal(scratch[:, k, 1], want[:, k, 1])


def test_kernel_rejects_mismatched_tensors(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    prog, img = fx.synthetic_case(1, 1024, gen, cuda)
    img.cols[0] = img.cols[0].to(torch.float64)
    with pytest.raises(ValueError):
        fa.fused_agg(prog, img)


def test_cold_q6_matches_the_oracle(cuda):
    n = 200_000
    ev = TorchDagEvaluator(dag_to_wire(fx.q6_dag()), block_rows=1 << 16, device=cuda)
    fa.reset_launches()
    resp = ev.run(FixtureScanSource(fx.build_kvs(n, seed=4)))
    assert resp.iter_rows() == [fx.q6_oracle(fx.build_arrays(n, seed=4))]
    assert fa.LAUNCHES["fused_agg_partials"] == 4  # one per block
    assert fa.LAUNCHES["fused_agg_combine_pack"] == 4


def test_warm_q6_matches_the_oracle(cuda):
    n = 3_000_000
    a = fx.build_arrays(n, seed=6)
    cache = fx.build_cache(n, 1 << 17, seed=6, arrays=a)
    ev = TorchDagEvaluator(dag_to_wire(fx.q6_dag()), block_rows=1 << 17, device=cuda)
    fa.reset_launches()
    assert ev.run(None, cache).iter_rows() == [fx.q6_oracle(a)]  # the zone rung
    assert ev.zone_stats.served == 1 and fa.LAUNCHES["zone_partial"] == 1
    ev.route_hint = "unary"  # the stacked kernels
    assert ev.run(None, cache).iter_rows() == [fx.q6_oracle(a)]
    assert ev.run(None, cache).iter_rows() == [fx.q6_oracle(a)]
    assert fa.LAUNCHES["fused_agg_partials"] == 2  # one per query
    ev_g = TorchDagEvaluator(dag_to_wire(fx.q6_count_sum_min_max_dag()), block_rows=1 << 17,
                             device=cuda)
    assert ev_g.run(None, cache).iter_rows() == [fx.q6_count_sum_min_max_oracle(a)]


# -- grouped kernels ----------------------------------------------------------

def _assert_same_bits(a, b):
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].view(torch.int64), b[1].view(torch.int64))


@pytest.mark.parametrize("kind", fx.GROUP_CASES)
@pytest.mark.parametrize("n_blocks,block_rows", [(1, 1 << 16), (40, 1 << 17)])
def test_grouped_kernel_matches_plain_version(cuda, kind, n_blocks, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(3)
    prog, img, cap = fx.synthetic_group_case(kind, n_blocks, block_rows, gen, cuda)
    got = ga.fused_group_agg(prog, img, cap)
    want = ga.fused_group_agg_plain(prog, img, cap)
    _assert_close(got, want)
    _assert_same_bits(got, ga.fused_group_agg(prog, img, cap))
    # folded once more into its own result, as the cold path carries it
    carry = (got[0].clone(), got[1].clone())
    ga.fused_group_agg(prog, img, cap, carry)
    _assert_close(carry, ga.fused_group_agg_plain(prog, img, cap, (want[0].clone(),
                                                                   want[1].clone())))
    if prog.shared_rows(cap):
        parts = ga.new_partials(prog, img, cap)
        ga.launch_partials(prog, img, cap, parts)
        want_p = ga.partials_plain(prog, img, cap, ga.launch_grid(img), ga.ROWS)
        for l, leaf in enumerate(prog.leaves):
            if leaf.is_f64:
                torch.testing.assert_close(parts[:, l].view(torch.float64),
                                           want_p[:, l].view(torch.float64), rtol=1e-12, atol=0)
            else:
                assert torch.equal(parts[:, l], want_p[:, l]), l
        _assert_close(ga.combine_plain(prog, img, cap, parts), got)
        fx.group_partials_check(prog, img, cap)  # two runs bit for bit


@pytest.mark.parametrize("name", fx.GROUP_EDGE_CASES)
def test_grouped_partials_edges_match_plain_version(cuda, name):
    """fused_group_agg_partials at its edges (fx.group_edge_cases): host ids
    past C and below 0, coded ids, one slot with no key, blocks of 1,001
    rows with n_valid cutting a tile, every leaf kind of fx.mixed_dag over a
    plain and an encoded image: integer words exact, f64 leaves to rel
    1e-12, two runs bit-identical, the combine over its partials and the
    pair end to end against the plain versions."""
    prog, img, cap = fx.group_edge_cases(cuda, (name,))[name]
    assert prog.shared_rows(cap)
    out = fx.group_partials_check(prog, img, cap)
    assert out["grid"] == ga.launch_grid(img)
    _assert_close(ga.fused_group_agg(prog, img, cap), ga.fused_group_agg_plain(prog, img, cap))


def _dadd(a, b):
    """ga_dadd on f64 bits: a's NaN if a is one, else b's, else the sum."""
    fa_, fb_ = a.view(torch.float64), b.view(torch.float64)
    return torch.where(fa_.isnan(), fa_, torch.where(fb_.isnan(), fb_, fa_ + fb_)).view(torch.int64)


def _dext(a, b, is_max):
    """ga_dmin / ga_dmax on f64 bits: NaN first in operand order, then the
    least (greatest) value, -0.0 below +0.0."""
    fa_, fb_ = a.view(torch.float64), b.view(torch.float64)
    first = fa_ > fb_ if is_max else fa_ < fb_
    second = fb_ > fa_ if is_max else fb_ < fa_
    tie = torch.where(a < 0, b, a) if is_max else torch.where(a < 0, a, b)
    out = torch.where(fa_.isnan(), a, torch.where(fb_.isnan(), b, torch.where(
        first, a, torch.where(second, b, tie))))
    return out


def _rule(leaf, a, b):
    """ga_merge_ordered's rule of a leaf on int64 words (f64 as bits)."""
    k = leaf.kind
    if k in (ga.LEAF_COUNT, ga.LEAF_SUM, ga.LEAF_SUMSQ):
        return _dadd(a, b) if leaf.is_f64 else a + b
    if k in (ga.LEAF_TRACK, ga.LEAF_FIRSTROW):
        return torch.minimum(a, b)
    if k in (ga.LEAF_MIN, ga.LEAF_MAX):
        if leaf.is_f64:
            return _dext(a, b, k == ga.LEAF_MAX)
        return torch.maximum(a, b) if k == ga.LEAF_MAX else torch.minimum(a, b)
    return {ga.LEAF_AND: a & b, ga.LEAF_OR: a | b, ga.LEAF_XOR: a ^ b}[k]


def _parent_combine(prog, img, cap, parts, carry):
    """The combine's words as its first design wrote them, on the card's
    tensors: a block of 256 threads a cell, part q folded into thread q mod
    256 in ascending q from the identity, then the halving tree (thread t
    takes t + s for s = 128, ..., 1), then the carry first, the tracker's
    flat row made global and first's value at the winning row (the plain
    version's ``_finish``, whose words those are)."""
    n = parts.shape[0]
    totals = []
    for l, leaf in enumerate(prog.leaves):
        fl = leaf.aux if leaf.kind == ga.LEAF_FIRSTVAL else l
        src = prog.leaves[fl]
        acc = torch.full((256, cap), src.ident, dtype=torch.int64, device=parts.device)
        for q0 in range(0, n, 256):
            chunk = parts[q0:q0 + 256, fl]
            acc[: len(chunk)] = _rule(src, acc[: len(chunk)], chunk)
        s = 128
        while s:
            acc[:s] = _rule(src, acc[:s], acc[s:2 * s])
            s //= 2
        totals.append(acc[0])
    outs = None
    if any(leaf.kind == ga.LEAF_FIRSTVAL for leaf in prog.leaves):
        outs = fa.walk_rows(prog, img, len(prog.agg_leaves))[0]
    ints, flts = carry if carry is not None else ga.init_packed(prog, cap, img.device)
    old = [(flts[leaf.slot].view(torch.int64) if leaf.is_f64 else ints[leaf.slot]).clone()
           for leaf in prog.leaves]
    want = ga._finish(prog, img, cap, [t.view(torch.float64) if leaf.is_f64 else t
                                       for leaf, t in zip(prog.leaves, totals)],
                      outs, (ints.clone(), flts.clone()))
    for leaf, t, o in zip(prog.leaves, totals, old):
        if leaf.kind in (ga.LEAF_TRACK, ga.LEAF_FIRSTROW, ga.LEAF_FIRSTVAL):
            continue  # integer rows, and first's value read at its row: _finish's words
        word = _rule(leaf, o, t)
        (want[1][leaf.slot].view(torch.int64) if leaf.is_f64 else want[0][leaf.slot]).copy_(word)
    return want


@pytest.mark.parametrize("n_parts", [1, 64, 256, 300])
@pytest.mark.parametrize("kind", ["host", "coded"])
def test_combine_writes_the_parents_words(cuda, kind, n_parts):
    """fused_group_agg_combine_pack word for word against the first
    design's order (a model of it in torch above), over every leaf kind of
    the synthetic cases (first, var_pop, f64 and int min/max, the bitwise
    leaves) with NaN, +-inf and +-0.0 written into the f64 words, at 1, 64,
    256 and 300 parts; then into a carry that is its own output; and against
    the plain version, to rel 1e-12."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    prog, img, cap = fx.synthetic_group_case(kind, 40, 1 << 15, gen, cuda)
    assert prog.shared_rows(cap)
    base = ga.new_partials(prog, img, cap)
    ga.launch_partials(prog, img, cap, base)
    parts = base[torch.arange(n_parts, device=cuda) % base.shape[0]].contiguous()
    special = torch.tensor([float("nan"), float("nan"), float("inf"), float("-inf"), -0.0],
                           dtype=torch.float64, device=cuda).view(torch.int64)
    special[1] |= 0x5  # another NaN payload
    for l, leaf in enumerate(prog.leaves):
        if leaf.is_f64 and leaf.kind != ga.LEAF_FIRSTVAL:
            hit = torch.rand(parts[:, l].shape, generator=gen, device=cuda) < 0.05
            pick = torch.randint(0, 5, parts[:, l].shape, generator=gen, device=cuda)
            parts[:, l] = torch.where(hit, special[pick], parts[:, l])
    out = (torch.empty((prog.n_int, cap), dtype=torch.int64, device=cuda),
           torch.empty((prog.n_f64, cap), dtype=torch.float64, device=cuda))
    fa.reset_launches()
    ga.launch_combine(prog, img, cap, parts, None, out)
    assert fa.LAUNCHES["fused_group_agg_combine_pack"] == 1
    _assert_same_bits(out, _parent_combine(prog, img, cap, parts, None))
    carry = (out[0].clone(), out[1].clone())
    want = _parent_combine(prog, img, cap, parts, carry)
    ga.launch_combine(prog, img, cap, parts, carry, carry)  # the carry is the output
    _assert_same_bits(carry, want)
    clean = base[torch.arange(n_parts, device=cuda) % base.shape[0]].contiguous()
    got = (torch.empty_like(out[0]), torch.empty_like(out[1]))
    ga.launch_combine(prog, img, cap, clean, None, got)
    _assert_close(got, ga.combine_plain(prog, img, cap, clean))


def test_partials_instances_keep_no_local_memory(cuda):
    """Every instance of fused_group_agg_partials and batch_partials (2, 4
    and 8 stack slots) and both of dict_ids keep their state in registers:
    no local (spilled) bytes."""
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_dict as fd

    for slots in (2, 4, 8):
        for attrs in (ga.partials_attributes(slots), fb.partials_attributes(slots)):
            assert attrs["localSizeBytes"] == 0, attrs
    for cap in (64, 32768):
        assert fd.ids_attributes(cap)["localSizeBytes"] == 0, cap


@pytest.mark.parametrize("name", fx.AGG_EDGE_CASES)
def test_capacity_one_edges_match_plain_version(cuda, name):
    """fused_agg_partials on the tile walk at its edges
    (fx.agg_edge_cases), each instance of 2, 4 and 8 stack slots: n_valid
    not a multiple of 4 and short last tiles, bitpack lanes, narrowed
    codes and runs, NaN and +-inf, date-ordered blocks zone maps pruned;
    counts and integer values exact, f64 to rel 1e-12, two runs
    bit-identical, the combine and the pair against their plain versions."""
    prog, img = fx.agg_edge_cases(cuda, (name,))[name]
    out = fx.agg_partials_check(prog, img)
    assert out["grid"] == fa.launch_grid(img)
    if name[-3:] in ("_s2", "_s4", "_s8"):
        assert out["slots"] == int(name[-1])


@pytest.mark.parametrize("name", fx.WIDE_EDGE_CASES)
def test_wide_route_edges_match_plain_versions(cuda, name):
    """group_wide_partials on the tile walk at its edges
    (fx.wide_edge_cases), each instance: host ids past C and below 0 with
    the tracker and first, ids from narrowed codes over an encoded image,
    date-ordered blocks zone maps pruned, and one hot slot that every live
    row falls into; the state word for word against wide_partials_plain,
    the combine bit for bit, two runs bit-identical."""
    prog, img, cap = fx.wide_edge_cases(cuda, (name,))[name]
    fa.reset_launches()
    fx.wide_kernel_check(prog, img, cap)
    assert fa.LAUNCHES["group_wide_partials"] > 0 and fa.LAUNCHES["fused_group_agg_partials"] == 0


def test_capacity_one_and_wide_instances_keep_no_local_memory(cuda):
    """Every instance (2, 4 and 8 stack slots) of fused_agg_partials and of
    group_wide_partials keeps its walk and its accumulators out of local
    memory."""
    for slots in (2, 4, 8):
        for attrs in (fa.partials_attributes(slots), ga.partials_attributes(slots, wide=True)):
            assert attrs["localSizeBytes"] == 0, attrs


@pytest.mark.parametrize("times", [1, 4], ids=["c_max_plus_1", "4_c_max"])
@pytest.mark.parametrize("kind", fx.GROUP_CASES)
def test_wide_route_matches_its_plain_versions(cuda, kind, times):
    """group_wide_partials and group_wide_combine past the shared-memory
    slots, every leaf kind (NaN, +-inf and +-0.0 in the host_wide case):
    the state word for word and the combine bit for bit against their plain
    versions, the pair against fused_group_agg_plain to rel 1e-12, two runs
    bit-identical; a wrongly typed gids lane is refused."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    prog, img, _cap = fx.synthetic_group_case(kind, 40, 1 << 14, gen, cuda)
    cap = times * prog.c_max + (1 if times == 1 else 0)
    fa.reset_launches()
    fx.wide_kernel_check(prog, img, cap)
    assert fa.LAUNCHES["group_wide_partials"] > 0 and fa.LAUNCHES["group_wide_combine"] > 0
    assert fa.LAUNCHES["fused_group_agg_partials"] == 0
    if img.gids is not None:
        img.gids = img.gids.to(torch.int64)
        with pytest.raises(ValueError):
            ga.fused_group_agg(prog, img, cap)


def test_a_batch_rider_past_its_slots_on_the_card(cuda):
    """Q1 grouped by the four flag columns (480 coded slots) with f64
    leaves, beside Q1 and Q6, over a supplier image: the batch kernels held
    to their plain versions, the wide rider to fused_group_agg_plain, two
    runs bit-identical; the responses equal their oracles."""
    from tikv_tpu_torch.copr import fused_batch
    from tikv_tpu_torch.copr.torch_eval import batch_tasks, run_batch_cached

    br = 1 << 16
    n = 6 * br - 321
    a = fx.supp_arrays(n, seed=17)
    cache = fx.supp_cache(n, br, seed=17, arrays=a)
    dags = [fx.flags4_dag(var_pop=True), fx.q1_dag(), fx.xor_dag()]
    evs = [TorchDagEvaluator(dag_to_wire(d), block_rows=br, device=cuda) for d in dags]
    tasks = batch_tasks(evs, cache)[0]
    assert fused_batch.Batch(tasks).wide == [0]
    out = fx.batch_kernel_check(tasks)
    assert out["wide_tasks"] == [0]
    fa.reset_launches()
    got = run_batch_cached(evs, cache)
    assert fa.LAUNCHES["group_wide_partials"] == 1 and fa.LAUNCHES["batch_partials"] == 1
    want = fx.flags4_oracle(a, var_pop=True)
    for g_row, w_row in zip(got[0].iter_rows(), want, strict=True):
        assert g_row == pytest.approx(w_row, rel=1e-12, abs=0)
    assert got[1].iter_rows() == fx.q1_oracle(a) and got[2].iter_rows() == fx.xor_oracle(a)


def test_cold_q1_matches_the_oracle(cuda):
    n = 200_000
    ev = TorchDagEvaluator(dag_to_wire(fx.q1_dag()), block_rows=1 << 16, device=cuda)
    fa.reset_launches()
    resp = ev.run(FixtureScanSource(fx.build_kvs(n, seed=4)))
    assert resp.iter_rows() == fx.q1_oracle(fx.build_arrays(n, seed=4))
    assert fa.LAUNCHES["fused_group_agg_partials"] == 4  # one per block
    assert fa.LAUNCHES["fused_group_agg_combine_pack"] == 4


def test_warm_q1_and_a_host_id_group_by_match_the_oracle(cuda):
    n = 3_000_000
    a = fx.build_arrays(n, seed=6)
    cache = fx.build_cache(n, 1 << 17, seed=6, arrays=a)
    ev = TorchDagEvaluator(dag_to_wire(fx.q1_dag()), block_rows=1 << 17, device=cuda)
    fa.reset_launches()
    assert ev.run(None, cache).iter_rows() == fx.q1_oracle(a)  # the zone rung
    assert ev.zone_stats.served == 1
    assert fa.LAUNCHES["zone_full"] == fa.LAUNCHES["zone_fold"] == 1
    ev.route_hint = "unary"  # the stacked kernels
    assert ev.run(None, cache).iter_rows() == fx.q1_oracle(a)
    assert ev.run(None, cache).iter_rows() == fx.q1_oracle(a)
    assert fa.LAUNCHES["fused_group_agg_partials"] == 2  # one per query, coded ids
    ev_q = TorchDagEvaluator(dag_to_wire(fx.qty_dag()), block_rows=1 << 17, device=cuda)
    assert ev_q.run(None, cache).iter_rows() == fx.qty_oracle(a)


# -- the mask and the top-K kernels --------------------------------------------

@pytest.mark.parametrize("n_blocks,block_rows", [(1, 1 << 16), (40, 1 << 17), (3, 1001),
                                                (5, 4099)])
def test_mask_kernel_matches_plain_version(cuda, n_blocks, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(5)
    prog, img = fx.synthetic_mask_case(n_blocks, block_rows, gen, cuda)
    got = fm.fused_mask(prog, img)
    assert torch.equal(got, fm.fused_mask_plain(prog, img))
    assert torch.equal(got, fm.fused_mask(prog, img))


@pytest.mark.parametrize("name", ["ragged", "view", "conjuncts", "conjuncts_view", "small",
                                  "encoded", "encoded_view", "every_op"])
def test_mask_kernel_edges_match_plain_version(cuda, name):
    """The tile walk at its edges (``fx.mask_edge_cases``): n_valid and
    block_rows not multiples of the tile, a view whose base is not 16-byte
    aligned, column-constant conjuncts only, 13-row blocks, bitpack, code
    and run lanes with run-shaped NULLs, every opcode at a stack 8 deep;
    twice bit for bit."""
    prog, img = fx.mask_edge_cases(cuda)[name]
    want = fm.fused_mask_plain(prog, img)
    outs = [torch.empty_like(want) for _ in range(2)]
    for out in outs:
        fm.launch_mask(prog, img, out)
    assert torch.equal(outs[0], want)
    assert torch.equal(outs[1], outs[0])


def test_mask_kernel_keeps_its_walk_in_registers(cuda):
    """The instance that runs each edge plan holds the plan's stack in the
    fewest slots (2, 4 or 8; none for column-constant conjuncts only) and
    spills nothing to local memory; a plan past the kernel's 8 slots is
    refused."""
    slots = {"ragged": 2, "view": 2, "conjuncts": 0, "conjuncts_view": 0, "small": 2,
             "encoded": 4, "encoded_view": 4, "every_op": 8}
    for name, (prog, img) in fx.mask_edge_cases(cuda).items():
        attrs = fm.mask_attributes(prog, img)
        assert attrs["stackSlots"] == slots[name], (name, attrs)
        assert attrs["localSizeBytes"] == 0, (name, attrs)
    prog, img = fx.mask_edge_cases(cuda)["ragged"]
    col, lt, filt = fa.OP_COL, fa._FN_OPS["lt"], fa.OP_FILTER
    deep = dataclasses.replace(prog, code=tuple([col] * 9 + [lt] * 8 + [filt]))
    with pytest.raises(RuntimeError, match="cudaError"):
        fm.launch_mask(deep, img, torch.empty((img.n_blocks, img.block_rows), dtype=torch.bool,
                                              device=cuda))


def _block(img, b):
    return Image([c[b : b + 1] for c in img.cols],
                 [None if m is None else m[b : b + 1] for m in img.nulls],
                 int(img.n_valids[b]), 1, img.block_rows, img.device)


def _assert_state(got, want):
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int64), want[1].view(torch.int64))
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("k", [1, 100, 2048])
def test_topn_kernels_match_plain_versions(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(6)
    prog, cand, pay = fx.synthetic_topn_case(12, 1 << 14, k, gen, cuda)
    # warm: one step over every block
    got = ft.topn_step(prog, cand, pay)
    _assert_state(got, ft.topn_step(prog, cand, pay))  # bit-identical rerun
    plain = ft._merge_all(ft.candidates_plain(prog, cand, 0), None, cuda=False)
    _assert_state(got, ft.pack_plain(prog, plain, pay, None, 0))
    # each kernel alone
    runs = torch.empty((ft.n_tiles(prog, cand), prog.n_words, k), dtype=torch.int64, device=cuda)
    ft.launch_candidates(prog, cand, runs, 0)
    want_runs = ft.candidates_plain(prog, cand, 0)
    assert torch.equal(runs, want_runs)
    for f in {2, ft.merge_fan_max(prog.n_words, k)}:
        fx.topn_merge_check(runs, runs[0].clone(), f)
    # cold: one step per block, the carry on the card
    state = plain_state = None
    for b in range(12):
        blk = _block(cand, b)
        state = ft.topn_step(prog, blk, blk, state, src_base=k)
        plain_state = ft.topn_step(prog, _to_cpu(blk), _to_cpu(blk),
                                   None if plain_state is None else plain_state, src_base=k)
        _assert_state(tuple(None if t is None else t.cpu() for t in state), plain_state)
    n_out = int((got[0][0] == 0).sum())
    assert torch.equal(state[0][:, :n_out], got[0][:, :n_out])


def _cpu_image(img):
    nv = img.n_valids.cpu() if isinstance(img.n_valids, torch.Tensor) else img.n_valids
    return Image([c.cpu() for c in img.cols], [None if m is None else m.cpu() for m in img.nulls],
                 nv, img.n_blocks, img.block_rows, torch.device("cpu"))


@pytest.mark.parametrize("name", fx.TOPN_EDGE_CASES)
def test_topn_candidates_edges_match_plain_version(cuda, name):
    """The select of topn_candidates at its edges, bit for bit against
    candidates_plain: tiles with fewer than K passing rows and with none,
    every key tied, NULL keys ascending and descending, -0.0 and +0.0, K = 1
    and K at its limit, blocks whose rows are not a multiple of a thread's
    tile and a short last tile; then the whole step warm and block by block
    with the carry, and reruns bit-identical."""
    prog, img = fx.topn_edge_case(name, cuda, seed=13)
    host = _cpu_image(img)
    runs = torch.empty((ft.n_tiles(prog, img), prog.n_words, prog.k), dtype=torch.int64,
                       device=cuda)
    again = torch.empty_like(runs)
    ft.launch_candidates(prog, img, runs, 0)
    ft.launch_candidates(prog, img, again, 0)
    assert torch.equal(runs.cpu(), ft.candidates_plain(prog, host, 0))
    assert torch.equal(runs, again)
    got = ft.topn_step(prog, img, img)
    _assert_state(tuple(t.cpu() for t in got), ft.topn_step(prog, host, host))
    state = plain = None
    for b in range(img.n_blocks):
        blk, hblk = _block(img, b), _block(host, b)
        state = ft.topn_step(prog, blk, blk, state, src_base=prog.k)
        plain = ft.topn_step(prog, hblk, hblk, plain, src_base=prog.k)
        _assert_state(tuple(t.cpu() for t in state), plain)


@pytest.mark.parametrize("name", list(fx.PACK_EDGE_CASES))
def test_topn_pack_edges_match_its_plain_version(cuda, name):
    """topn_pack, a thread a (payload column, slot) cell and a run cell, at
    its edges (``fx.pack_edge_case``: K of 1, 100 and 2,048; 0, 5, 7 and
    16 payload columns; winners from the carry and the image mixed with
    rank-1 slots; f64 payload with NaN, +-inf and -0.0; an encoded payload
    image; the mesh finalize's [8, K] image): the packed state, its f64
    rows bit for bit and the next carry run equal to the plain version's,
    two launches bit-identical, no local memory."""
    prog, run, pay, carry, src_base = fx.pack_edge_case(name, cuda)
    out = fx.pack_kernel_check(prog, run, pay, carry, src_base)
    assert out["launches"] == 2 and out["live"] > 0
    if prog.k >= 100:
        assert (out["from_carry"] > 0) == (carry is not None)
    assert ft.pack_attributes()["localSizeBytes"] == 0


def test_redesigned_kernels_keep_their_walks_in_registers(cuda):
    """batch_partials and topn_candidates spill nothing to local memory in
    any instance (2, 4 and 8 stack slots); fused_mask's four instances keep
    the registers the tile walk gave them before it handed values out."""
    from tikv_tpu_torch.copr import fused_batch as fb

    prog, _img = fx.topn_edge_case("k1", cuda)
    for slots in (2, 4, 8):
        assert fb.partials_attributes(slots)["localSizeBytes"] == 0, slots
        code = prog.code + (fa.OP_COL,) * (slots - 1) + (fa.OP_FILTER,) * (slots - 1)
        attrs = ft.candidates_attributes(dataclasses.replace(prog, code=code))
        assert attrs["stackSlots"] == slots and attrs["localSizeBytes"] == 0, attrs
    regs = {name: fm.mask_attributes(p, i) for name, (p, i) in fx.mask_edge_cases(cuda).items()}
    assert {a["stackSlots"]: a["numRegs"] for a in regs.values()} == {0: 62, 2: 78, 4: 98, 8: 137}


def _to_cpu(img):
    return Image([c.cpu() for c in img.cols], [None if m is None else m.cpu() for m in img.nulls],
                 img.n_valids, img.n_blocks, img.block_rows, torch.device("cpu"))


def test_filter_and_topn_plans_match_their_oracles(cuda):
    n = 400_000
    a = fx.build_arrays(n, seed=7)
    kvs = fx.build_kvs(n, seed=7)
    cache = fx.build_cache(n, 1 << 16, seed=7, arrays=a)
    fa.reset_launches()
    for kind, limit in (("scan", 1000), ("filter", 5000), ("selective", None)):
        ev = TorchDagEvaluator(dag_to_wire(fx.filter_dag(kind, limit)), block_rows=1 << 16,
                               device=cuda)
        want = fx.filter_oracle(a, kind, limit)
        assert ev.run(FixtureScanSource(kvs)).iter_rows() == want
        assert ev.run(None, cache).iter_rows() == want
    assert fa.LAUNCHES["fused_mask"] > 0
    ev = TorchDagEvaluator(dag_to_wire(fx.topn_dag(100)), block_rows=1 << 16, device=cuda)
    assert ev.run(FixtureScanSource(kvs)).iter_rows() == fx.topn_oracle(a, 100)
    assert ev.run(None, cache).iter_rows() == fx.topn_oracle(a, 100)
    ev = TorchDagEvaluator(dag_to_wire(fx.q1_topn_dag()), block_rows=1 << 16, device=cuda)
    assert ev.run(FixtureScanSource(kvs)).iter_rows() == fx.q1_topn_oracle(fx.q1_oracle(a))
    assert ev.run(None, cache).iter_rows() == fx.q1_topn_oracle(fx.q1_oracle(a))
    for name in ("topn_candidates", "topn_merge", "topn_pack"):
        assert fa.LAUNCHES[name] > 0, name


@pytest.mark.parametrize("n_words", [4, 11])
@pytest.mark.parametrize("k", [1, 100, 2048, 4096])
def test_topn_merge_matches_its_plain_version_at_every_shape(cuda, n_words, k):
    """topn_merge at K = 1, 100, 2,048 and 4,096, 4 and 11 words (staged in
    shared memory where F runs fit, else read in place): each level of the
    plan over 33 runs and the carry, at fan-in 2 and the largest, against
    merge_plain exactly, twice bit for bit; the levels end in the first K of
    every run; neither instance spills."""
    runs, extra = fx.topn_merge_case(32, n_words, k, k + n_words, cuda)
    f_max = ft.merge_fan_max(n_words, k)
    for f in (2, f_max):
        fx.topn_merge_check(runs, extra, f)
    fa.reset_launches()
    got = ft._merge_all(runs, extra, cuda=True)
    assert fa.LAUNCHES["topn_merge"] == len(ft.merge_fans(33, n_words, k))
    want = ft._merge_all(runs.cpu(), extra.cpu(), cuda=False)
    assert torch.equal(got.cpu(), want)
    for staged in (True, False):
        for w in range(2, ft.MERGE_WORDS_MAX + 1):
            assert ft.merge_attributes(w, staged)["localSizeBytes"] == 0, (w, staged)


@pytest.mark.parametrize("n", [163_840, 262_144, 5 * 4096 + 777])
def test_dict_merge_matches_its_plain_version(cuda, n):
    """The sort route's dict_merge levels at the mesh path's shard union
    (163,840 keys: the carried 32,768 slots and a shard's 131,072 keys) and
    global union (262,144), and at a ragged size: each level against
    merge_pass_plain exactly, twice bit for bit, at most two levels; the
    whole union against dict_union_plain; no spill."""
    from tikv_tpu_torch.copr import fused_dict as fd

    rng = np.random.default_rng(n)
    keys = rng.integers(0, 60_000, n)
    keys[rng.random(n) < 0.2] = fd.SENTINEL
    cap = 32768
    d = None
    if n == 163_840:
        d = fd.dict_union_plain(None, torch.from_numpy(rng.integers(0, 60_000, 4 * cap)), cap)[0]
        keys = keys[cap:]
    keys = torch.from_numpy(keys)
    out = fx.sort_route_levels(d, keys, cuda)
    assert 1 <= len(out["levels"]) <= 2
    fx.union_kernel_check(d, keys, cap, cuda)
    assert fd.merge_attributes()["localSizeBytes"] == 0


# -- program #1 and encoded images ---------------------------------------------

def _tensors(payload, nulls, device):
    def to(a):
        return None if a is None else torch.from_numpy(a).to(device)

    return (tuple(to(x) for x in payload) if isinstance(payload, tuple) else to(payload)), to(nulls)


@pytest.mark.parametrize("case", fx.DECODE_CASES,
                         ids=[f"{k}-{np.dtype(t).name}-{n}" for k, t, n in fx.DECODE_CASES])
def test_decode_column_matches_plain_version(cuda, case):
    rows = 1 << 12
    desc, payload, nulls, ref = fx.synthetic_encoded_column(*case, 40, rows, seed=3)
    fa.reset_launches()
    got = fm.decode_column(desc, *_tensors(payload, nulls, cuda), ref, rows)
    want = fm.decode_column(desc, *_tensors(payload, nulls, torch.device("cpu")), ref, rows)
    assert fa.LAUNCHES["decode_column"] == 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("order", ["load", "shipdate"])
def test_kernels_on_an_encoded_image_match_the_plain_image(cuda, order):
    n, br = 2_000_000, 1 << 17
    a = fx.build_arrays(n, seed=8)
    if order == "shipdate":
        a = fx.sort_by_shipdate(a)
    enc = fx.build_cache(n, br, arrays=a, encode=True)
    kinds = {getattr(c, "kind", None) for c in enc.blocks[0].cols}
    assert kinds == ({"bp", "rle", None} if order == "shipdate" else {"bp", None})
    got = fx.warm_kernel_outputs(enc, br, cuda)
    want = fx.warm_kernel_outputs(fx.build_cache(n, br, arrays=a), br, cuda)
    for name, (kernel, plain) in got.items():
        for g, p_, w in zip(kernel, plain, want[name][0]):
            assert torch.equal(g.view(torch.int64) if g.dtype == torch.float64 else g,
                               p_.view(torch.int64) if p_.dtype == torch.float64 else p_), name
            assert torch.equal(g, w), name


def _stacked_nbytes(cache) -> int:
    """``device_nbytes`` without the pinned zone layouts."""
    layouts = [e for b in cache.blocks for s, e in b.device.items() if s[0] == "zone_layout"]
    return cache.device_nbytes() - sum(t.numel() * t.element_size()
                                       for e in layouts for t in e.tensors())


@pytest.mark.parametrize("order", ["load", "shipdate"])
def test_encoded_warm_plans_match_their_oracles(cuda, order):
    n, br = 3_000_000, 1 << 17
    a = fx.build_arrays(n, seed=9)
    if order == "shipdate":
        a = fx.sort_by_shipdate(a)
    cache = fx.build_cache(n, br, arrays=a, encode=True)
    plain = fx.build_cache(n, br, arrays=a)
    cases = {"q6": (fx.q6_dag(), [fx.q6_oracle(a)]), "q1": (fx.q1_dag(), fx.q1_oracle(a)),
             "qty": (fx.qty_dag(), fx.qty_oracle(a)),
             "filter": (fx.filter_dag("filter", 5000), fx.filter_oracle(a, "filter", 5000)),
             "selective": (fx.filter_dag("selective", None),
                           fx.filter_oracle(a, "selective", None)),
             "topn": (fx.topn_dag(100), fx.topn_oracle(a, 100)),
             "q1_topn": (fx.q1_topn_dag(), fx.q1_topn_oracle(fx.q1_oracle(a)))}
    fa.reset_launches()
    for name, (dag, want) in cases.items():
        # aggregations on both warm rungs: the zone rung, then the stacked
        # kernels (route_hint "unary")
        for hint in (None, "unary") if name in ("q6", "q1", "q1_topn") else (None,):
            ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device=cuda)
            ev.route_hint = hint
            assert ev.run(None, cache).iter_rows() == want, name
            if name == "q6" and order == "shipdate" and hint == "unary":
                assert ev.prune_stats[1] > ev.prune_stats[0] // 2  # most blocks pruned
            assert ev.run(None, plain).iter_rows() == want, name
    # every kernel these warm plans run launched; the batch kernels serve
    # batches only (test_batches_match_the_unary_route_and_the_oracles), the
    # join probes joins only (test_join_kernels_match_their_plain_versions),
    # the mesh merge and fold the mesh only (test_mesh_merge_matches_its_plain_version,
    # test_mesh_fold_matches_its_plain_version_and_the_pair),
    # the dictionary kernels the mesh's device-built group dictionary only
    # (test_dictionary_kernels_match_their_plain_versions), the wide route
    # group slots past the shared rows only (test_wide_route_matches_its_plain_versions),
    # the image patch in-place writes only (test_patch_stacked_matches_its_plain_version)
    for name, count in fa.LAUNCHES.items():
        assert count > 0 or name in ("decode_column", "batch_partials", "batch_combine_pack",
                                     "join_rank_probe", "join_hash_probe", "mesh_merge",
                                     "mesh_fold",
                                     "dict_keys", "dict_union", "dict_ids", "dict_merge",
                                     "dict_compact", "group_wide_partials",
                                     "group_wide_combine", "patch_stacked"), name
    # the same shipped columns pin in at most 30% of the plain bytes (the
    # zone layouts narrow themselves whatever the encoding: left out)
    assert _stacked_nbytes(cache) <= 0.3 * _stacked_nbytes(plain)


# -- the zone rung ----------------------------------------------------------------

def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.parametrize("tile_rows,max_tiles", [(256, None), (1000, None), (1001, None),
                                                (4096, None), (4096, 1)])
def test_zone_kernels_match_plain_versions(cuda, tile_rows, max_tiles):
    """zone_full, zone_partial and zone_fold against their plain versions
    on a layout with NULLs in the key and values, negative values,
    var_pop/min/max and the null-safe ops: integers exactly, f64 to rel
    1e-12, and two runs bit-identical.  1,000 rows are no multiple of the
    rows a warp's step covers, 1,001 of a thread's (``fz.ROWS``) either, so
    lanes load row by row; one case lists one tile of each kind."""
    cache = fx.zone_cache(400_000, 1 << 16, seed=5)
    ev = TorchDagEvaluator(dag_to_wire(fx.zone_dag()), block_rows=1 << 16, device=cuda)
    fa.reset_launches()
    out, _layout, n_full, n_partial = fx.zone_kernel_outputs(ev, cache, tile_rows, max_tiles)
    assert n_full > 0 and n_partial > 0
    assert max_tiles is None or n_full == n_partial == max_tiles
    for name, (got, want) in out.items():
        assert fa.LAUNCHES[name] == 1, name
        for g, w in zip(got, want):
            if g.dtype == torch.float64:
                torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-12, atol=0)
            else:
                assert torch.equal(g.cpu(), w.cpu()), name
    again = fx.zone_kernel_outputs(ev, cache, tile_rows, max_tiles)[0]
    for name, (got, _want) in out.items():
        assert all(torch.equal(_bits(g), _bits(h)) for g, h in zip(got, again[name][0])), name


def test_zone_bare_instance_matches_its_plain_version(cuda):
    """Q1's full-tile program (every argument a bare column, so the instance
    with no walk) and a var_pop/min/max program of bare columns over int8,
    int16 and int32 lanes, at 4,096- and 1,001-row tiles."""
    from tikv_tpu_torch.copr import fused_zone as fz

    n = 600_000
    cache = fx.build_cache(n, 1 << 17, seed=12)
    for dag in (fx.q1_dag(), fx.zone_bare_dag()):
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device=cuda)
        for tile_rows in (4096, 1001):
            out, layout, n_full, _n_partial = fx.zone_kernel_outputs(ev, cache, tile_rows)
            assert n_full > 0
            full = ev._zone_rung().programs(layout)[0]
            assert fz.tile_slots(full) == 0, dag
            for name, (got, want) in out.items():
                for g, w in zip(got, want):
                    if g.dtype == torch.float64:
                        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=1e-12, atol=0)
                    else:
                        assert torch.equal(g.cpu(), w.cpu()), (name, tile_rows)


def test_zone_tile_instances_keep_no_local_memory(cuda):
    """Every instance of zone_full and zone_partial (the one with no walk,
    the walks of 2, 4 and 8 stack slots) keeps its accumulators out of
    local memory."""
    from tikv_tpu_torch.copr import fused_zone as fz

    for partial, slots in fz.TILE_INSTANCES:
        attrs = fz.tiles_attributes(partial, slots)
        assert attrs["localSizeBytes"] == 0, attrs


@pytest.mark.parametrize("name", list(fx.ZONE_FOLD_CASES))
def test_zone_fold_matches_its_plain_version_at_its_edges(cuda, name):
    """zone_fold in the layout's fold order against its plain version
    (integer words exactly, f64 to rel 1e-12) and its own second launch
    (bit for bit), through a row map full of stale words: one slot and
    many, slots with no tile, a slot with no listed tile, 49 leaves (past a
    warp's lanes), a slot of 79 segments, no listed tile at all; one launch
    a call, 0 local bytes."""
    from tikv_tpu_torch.copr import fused_zone as fz

    tp, parts, tiles, row_of, order, cap = fx.zone_fold_case(name, cuda)
    fa.reset_launches()
    out = fx.zone_fold_check(tp, parts, tiles, row_of, order, cap)
    assert fa.LAUNCHES["zone_fold"] == 2
    assert out["rows"] == len(tiles) and (out["rows"] > 0) == (name != "all_empty")
    assert fz.fold_attributes()["localSizeBytes"] == 0


def test_zone_layout_shared_by_two_plans_folds_each_plan(cuda):
    """Two plans that differ only in their selection's constants share one
    pinned layout, and so its fold order; each plan's fold over its own
    listed tiles equals its plain version, and its request the stacked
    kernels' bytes."""
    from tikv_tpu_torch.copr import fused_zone as fz

    cache = fx.zone_cache(400_000, 1 << 16, seed=6)
    dags = [fx.zone_dag(), fx.zone_dag()]
    dags[1].executors[1].conditions[1] = call("le", col(1), const_int(200))
    layouts = []
    for dag in dags:
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 16, device=cuda)
        out, layout, _nf, _np = fx.zone_kernel_outputs(ev, cache)
        got, want = out["zone_fold"]
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0)
        unary = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 16, device=cuda)
        unary.route_hint = "unary"
        assert ev.run(None, cache).encode() == unary.run(None, cache).encode()
        layouts.append(layout)
    assert layouts[0] is layouts[1] and isinstance(layouts[0].fold, fz.FoldOrder)


def test_zone_rung_matches_the_stacked_kernels_byte_for_byte(cuda):
    n = 3_000_000
    a = fx.build_arrays(n, seed=8)
    cache = fx.build_cache(n, 1 << 17, seed=8, arrays=a)
    zcache = fx.zone_cache(1_000_000, 1 << 17, seed=8)
    for dag, c in ((fx.q6_dag(), cache), (fx.q1_dag(), cache), (fx.q1_topn_dag(), cache),
                   (fx.zone_dag(), zcache)):
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device=cuda)
        unary = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device=cuda)
        unary.route_hint = "unary"
        assert ev.run(None, c).encode() == unary.run(None, c).encode()
        assert ev.zone_stats.served == 1 or ev.zone_stats.last_decline == "partial_fraction"


def _batch_riders(device, block_rows):
    dags = [d for _n, d, _o in fx.batch_plans()] + [fx.mixed_dag()]
    return [TorchDagEvaluator(dag_to_wire(d), block_rows=block_rows, device=device)
            for d in dags]


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("kind", ["same_region", "xregion"])
def test_batch_kernels_match_plain_versions(cuda, kind, encoded):
    """batch_partials and batch_combine_pack against their plain versions:
    nine riders (every leaf kind) over one image, or Q1 and the mixed plan
    over twelve regions of 1 to 4 blocks (one with a returnflag dictionary
    of two); integer words exactly, f64 to rel 1e-12, two runs
    bit-identical."""
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr.torch_eval import batch_tasks, xregion_tasks

    br = 1 << 16
    if kind == "same_region":
        cache = fx.build_cache(24 * br - 999, br, seed=9, encode=encoded)
        runs = [batch_tasks(_batch_riders(cuda, br), cache)[0]]
    else:
        regions = [c for _a, c in fx.region_caches([1 + r % 4 for r in range(12)], br, seed=10,
                                                   two_flags=(5,))]
        if encoded:
            for c in regions:
                encoding.encode_blocks(c, fx.lineitem())
        riders = _batch_riders(cuda, br)
        runs = [xregion_tasks(ev, regions)[0] for ev in (riders[2], riders[-1])]
    for tasks in runs:
        assert (tasks[0].img.descs is not None) == encoded
        fx.batch_kernel_check(tasks)


@pytest.mark.parametrize("case", ["mixed_leaves", "capacities_and_wide", "no_group", "encoded",
                                  "ragged_blocks", "ids_past_c"])
def test_batch_partials_edges_match_plain_version(cuda, case):
    """The tile walk of batch_partials against its plain version: the mixed
    rider's leaf kinds (var_pop, first, the bit leaves, min and max) beside
    Q1; one plan at three capacities, the last past c_max (wide); riders
    with no group (Q6's shapes); an encoded image; blocks of 1,001 rows (not
    a multiple of a thread's 4) with a short last block; Q1 at 4 slots, so
    most ids lie past C and touch nothing.  Integer words exactly, f64 to
    rel 1e-12, two runs bit-identical (``fixtures.batch_kernel_check``)."""
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr.torch_eval import batch_tasks

    br = 1001 if case == "ragged_blocks" else 1 << 14
    cache = fx.build_cache(7 * br - 345, br, seed=14, encode=case == "encoded")
    plans = {n: d for n, d, _o in fx.batch_plans()}
    names = {"mixed_leaves": ["q1", "mixed"], "no_group": ["q6", "q6_count_sum_min_max",
                                                            "q6_price"]}.get(
        case, ["q1", "q6", "bit_xor_by_linestatus"])
    dags = [fx.mixed_dag() if n == "mixed" else plans[n] for n in names]
    evs = [TorchDagEvaluator(dag_to_wire(d), block_rows=br, device=cuda) for d in dags]
    tasks = batch_tasks(evs, cache)[0]
    if case == "capacities_and_wide":
        t = tasks[0]
        tasks = [fb.Task(t.prog, t.img, c) for c in (16, 64, fb.c_max(t.prog) + 1)] + tasks[1:]
    elif case == "ids_past_c":
        tasks = [fb.Task(tasks[0].prog, tasks[0].img, 4)] + tasks[1:]
    check = fx.batch_kernel_check(tasks)
    assert check["wide_tasks"] == ([2] if case == "capacities_and_wide" else [])


def test_batch_kernels_reject_mismatched_tensors(cuda):
    from tikv_tpu_torch.copr import fused_batch
    from tikv_tpu_torch.copr.torch_eval import batch_tasks

    cache = fx.build_cache(100_000, 1 << 15, seed=11)
    tasks = batch_tasks(_batch_riders(cuda, 1 << 15)[:3], cache)[0]
    img = tasks[1].img
    bad = Image([c.to(torch.int32) for c in img.cols], img.nulls, img.n_valids, img.n_blocks,
                img.block_rows, img.device, img.offsets)
    with pytest.raises(ValueError):
        fused_batch.fused_batch([tasks[0], fused_batch.Task(tasks[1].prog, bad, 16)])
    bad_off = Image(img.cols, img.nulls, img.n_valids, img.n_blocks, img.block_rows, img.device,
                    img.offsets.to(torch.int32))
    with pytest.raises(ValueError, match="offsets"):
        fused_batch.fused_batch([fused_batch.Task(tasks[0].prog, bad_off, 1)])


def test_batches_match_the_unary_route_and_the_oracles(cuda):
    """Both entry points on the card: each response equal to its numpy
    oracle and, byte for byte, to the same plan served alone; one
    batch_partials launch for each batch."""
    from tikv_tpu_torch.copr.torch_eval import run_batch_cached, run_xregion_cached

    br = 1 << 16
    n = 10 * br
    a = fx.build_arrays(n, seed=12)
    cache = fx.build_cache(n, br, seed=12, arrays=a)
    riders = _batch_riders(cuda, br)[:-1]
    fa.reset_launches()
    got = run_batch_cached(riders, cache)
    assert fa.LAUNCHES["batch_partials"] == 1 and fa.LAUNCHES["batch_combine_pack"] == 1
    for (name, dag, oracle), resp in zip(fx.batch_plans(), got):
        assert resp.iter_rows() == oracle(a), name
        alone = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device=cuda)
        alone.route_hint = "unary"
        assert alone.run(None, cache).encode() == resp.encode(), name
    regions = fx.region_caches([3, 1, 2, 4], br, seed=13, two_flags=(1,))
    for name, dag, oracle in fx.batch_plans()[:3]:
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device=cuda)
        before = fa.LAUNCHES["batch_partials"]
        outs = run_xregion_cached(ev, [c for _a, c in regions])
        assert fa.LAUNCHES["batch_partials"] == before + 1
        for (ra, _c), resp in zip(regions, outs):
            assert resp.iter_rows() == oracle(ra), name


# -- the join rung ---------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(n_keys=62_500, mult=4, n_probe=1_000_000, seed=1),
    dict(n_keys=100_000, mult=3, n_probe=700_000, seed=2, wide=True, null_p=0.05),
    dict(n_keys=5, mult=7, n_probe=10_000, seed=3, wide=True, null_p=0.2),
])
def test_join_kernels_match_their_plain_versions(cuda, case):
    """join_rank_probe and join_hash_probe against their plain versions:
    int64-exact, two runs bit-identical, NULL and missing probes, negative
    and extreme keys, colliding home slots; one launch per call."""
    c = fx.join_probe_case(**case)
    fa.reset_launches()
    out = fx.join_kernel_check(c, cuda)
    assert fa.LAUNCHES["join_rank_probe"] == 2 and fa.LAUNCHES["join_hash_probe"] == 2
    assert 0 < out["join_hash_probe_matched"] < case["n_probe"]


def test_join_kernels_reject_mismatched_tensors(cuda):
    from tikv_tpu_torch.copr import fused_join

    keys = torch.arange(16, dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        fused_join.rank_probe(keys.to(torch.int32), keys)
    with pytest.raises(ValueError):
        fused_join.rank_probe(keys.cpu(), keys)
    with pytest.raises(ValueError, match="power of two"):
        fused_join.hash_probe(keys[:12], keys[:12], keys[:12], keys)


@pytest.mark.parametrize("key", ["dict", "int"])
def test_join_serve_on_the_card_matches_the_oracle(cuda, key):
    """serve over encoded images of the join event: the pairs and the bytes
    equal the oracle's and the CPU plain versions', one launch per serve."""
    from tikv_tpu_torch.copr import torch_join

    a, pc, bc = fx.join_caches(200_000, 4, key=key, encode=True)
    want = fx.join_oracle(a)
    for path in ("rank", "hash") if key == "dict" else ("hash",):
        fa.reset_launches()
        resp, served, _stats = torch_join.serve(fx.join_dag(key=key), pc, bc, prefer=path,
                                                device=cuda)
        assert served == path and fa.LAUNCHES[f"join_{path}_probe"] == 1
        assert resp.encode() == fx.join_oracle_bytes(a, want, key)
        pairs = torch_join.join_pairs(fx.join_dag(key=key), pc, bc, prefer=path, device=cuda)
        assert np.array_equal(pairs.probe_rows(), want[0])
        assert np.array_equal(pairs.build_rows(), want[1])
        dag = fx.join_dag(fx.join_downstream(), key=key)
        assert torch_join.serve(dag, pc, bc, prefer=path, device=cuda)[0].encode() \
            == torch_join.serve(dag, pc, bc, prefer=path, device="cpu")[0].encode()


# -- the mesh path ---------------------------------------------------------------

@pytest.mark.parametrize("n_parts,capacity", [(8, 16), (64, 331)])
def test_mesh_merge_matches_its_plain_version(cuda, n_parts, capacity):
    """mesh_merge against its plain version: every mergeable leaf kind, NaN,
    +-0.0, +-inf and int64 wrap; with and without a carry, over the whole
    width and a member's window; two runs bit-identical."""
    from tikv_tpu_torch.copr import fused_mesh

    prog, parts, table, carry = fx.mesh_merge_case(n_parts, 9, capacity, n_parts, cuda)
    fa.reset_launches()
    fx.mesh_merge_check(prog, parts, table)
    half = capacity // 2
    window = tuple(t[:, :, half:].contiguous() for t in carry)
    fx.mesh_merge_check(prog, parts, table, window, half, capacity)
    assert fa.LAUNCHES["mesh_merge"] == 4
    with pytest.raises(ValueError):
        fused_mesh.mesh_merge(prog, (parts[0].to(torch.int32), parts[1]), table)


def test_an_eight_shard_mesh_on_one_card_matches_the_single_device_route(cuda):
    """make_mesh(["cuda:0"] * 8): cold Q6 and Q1 through MeshServingRunner
    (#16), the raw TopN through ShardedTopNEvaluator (#18, #19) and Q1 and
    Q6 over region images through launch_xregion_sharded (#20), each equal
    to its oracle and to the single-device route; mesh_fold launched on the
    cold mesh (the grouped combine not at all), mesh_merge on the regions."""
    from tikv_tpu_torch.copr.torch_eval import launch_xregion_sharded, run_xregion_cached
    from tikv_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh([cuda] * 8, groups=2)
    n = 150_000
    kvs, a = fx.build_kvs(n, seed=14), fx.build_arrays(n, seed=14)
    on_mesh = dict.fromkeys(("mesh_fold", "fused_group_agg_combine_pack", "mesh_merge"), 0)
    for dag, want in ((fx.q6_dag(), [fx.q6_oracle(a)]), (fx.q1_dag(), fx.q1_oracle(a))):
        runner = pm.MeshServingRunner(dag_to_wire(dag), mesh, rows_per_shard=4096)
        fa.reset_launches()
        resp = runner.run(FixtureScanSource(kvs))
        for name in on_mesh:
            on_mesh[name] += fa.LAUNCHES[name]
        assert resp.iter_rows() == want
        one = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 16, device=cuda)
        assert resp.encode() == one.run(FixtureScanSource(kvs)).encode()
    assert on_mesh["mesh_fold"] > 0
    assert on_mesh["fused_group_agg_combine_pack"] == on_mesh["mesh_merge"] == 0
    fa.reset_launches()
    topn = pm.ShardedTopNEvaluator(dag_to_wire(fx.topn_dag(100)), pm.make_mesh([cuda] * 8),
                                   1 << 13)
    total = topn.total_rows
    out = topn.finalize(topn.run_blocks([(fx.mesh_columns(a, s, min(s + total, n)),
                                          min(total, n - s)) for s in range(0, n, total)]))
    want = fx.topn_oracle(a, 100)
    assert [r[0] for r in want] == list(out["gidx"]) == list(out["payload"][0][0])
    regions = [c for _a, c in fx.region_caches([3, 1, 2, 4, 2], 1 << 15, seed=15,
                                               two_flags=(1,))]
    for dag in (fx.q1_dag(), fx.q6_dag()):
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 15, device=cuda)
        got = launch_xregion_sharded(ev, regions, mesh).finalize()
        assert [r.encode() for r in got] == [r.encode() for r in run_xregion_cached(ev, regions)]
    assert fa.LAUNCHES["mesh_merge"] > 0


# (n_shards, partial rows a shard, slots, rows a shard, windows, empty shards,
# a perm): the cold mesh at 1,024 and 65,536 rows a shard, G = 1 and 2; the
# grouped mesh's shard of 131,072 rows with its remap; 300 rows a shard (the
# combine's strided fold past its 256 threads); a partial super-block
FOLD_CASES = {"cold_1024": (8, 1, 16, 1024, 1, (), False),
              "cold_65536": (8, 64, 16, 1 << 16, 1, (), False),
              "cold_1024_g2": (4, 1, 16, 1024, 2, (), False),
              "grouped_64": (8, 128, 64, 1 << 17, 1, (), True),
              "strided": (3, 300, 16, 300 * 1024, 1, (), False),
              "empty_shards": (8, 2, 16, 2048, 2, (5, 6, 7), False)}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_mesh_fold_matches_its_plain_version_and_the_pair(cuda, case):
    """mesh_fold against its plain version (integer words equal, f64 leaves
    to rel 1e-12) and against what it replaces, fused_group_agg_combine_pack
    per shard and mesh_merge of their states (every word, f64 bit for
    bit), at the mesh paths' shapes: every mergeable leaf kind, NaN, +-0.0,
    +-inf, int64 wrap; two runs bit-identical; one launch a call, 0 local
    bytes."""
    from tikv_tpu_torch.copr import fused_mesh

    n_shards, n_parts, cap, rps, n_win, empty, with_perm = FOLD_CASES[case]
    seed = sum(map(ord, case))
    prog, rows, shards, base, width, windows = fx.mesh_fold_case(
        n_shards, n_parts, cap, rps, seed, cuda, n_win, empty)
    perm = fx.merge_perm(cap, seed, cuda) if with_perm else None
    images = fx.fold_pair_images(prog, shards, base, rps, cuda)
    fa.reset_launches()
    fx.mesh_fold_check(prog, rows, shards, base, width, windows, perm, images)
    assert fa.LAUNCHES["mesh_fold"] == 2
    assert fused_mesh.fold_attributes()["localSizeBytes"] == 0
    with pytest.raises(ValueError):
        fused_mesh.mesh_fold(prog, rows.to(torch.int32), shards, base, width, windows)
    if perm is not None:  # the carry may not be the output with a perm
        with pytest.raises(ValueError):
            fused_mesh.mesh_fold(prog, rows, shards, base, width, windows,
                                 outs=[windows[0][1]], perm=perm)


# -- the device-built group dictionary (program #17) --------------------------------

@pytest.mark.parametrize("cap,distinct,bad", [(8, 1, False), (8, 50, False), (64, 15, False),
                                              (64, 15, True), (4096, 1000, False),
                                              (4096, 3000, False), (16384, 3000, False),
                                              (32768, 20000, False), (9000, 20000, False)])
def test_dictionary_kernels_match_their_plain_versions(cuda, cap, distinct, bad):
    """dict_keys, dict_union and dict_ids against their plain versions over
    200,000 rows (NULL keys, a REAL key, rows past n_valid) and a dictionary
    that grows from the first half's keys to all of them; a full dictionary,
    overflow and out-of-range keys; past 8,192 slots the union's sort route
    (dict_merge, dict_compact) and dict_ids in device memory;
    two runs bit-identical; then mesh_merge moving a carry through a perm at
    the same capacity."""
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import fused_mesh

    n = 200_000
    prog, img, old = fx.dict_case(n, cap, distinct, cap + distinct, cuda, bad)
    fa.reset_launches()
    out = fx.dict_kernel_check(prog, img, old, cap)
    assert bool(out["flag"] & fd.FLAG_RANGE) == bad
    if not bad:  # (distinct + NULL) x 4 truncated REAL values
        assert bool(out["flag"] & fd.FLAG_CAPACITY) == ((distinct + 1) * 4 > cap)
    assert fa.LAUNCHES["dict_keys"] == fa.LAUNCHES["dict_ids"] == 2
    for name, count in fd.union_launches(n + cap, cap).items():
        assert fa.LAUNCHES[name] == 2 * count, name
    mprog, parts, table, carry = fx.mesh_merge_case(8, 1, cap, cap, cuda)
    fx.mesh_merge_check(mprog, parts, table, carry, perm=fx.merge_perm(cap, cap, cuda))
    with pytest.raises(ValueError):  # the carry may not be the output with a perm
        fused_mesh.mesh_merge(mprog, parts, table, carry, out=carry,
                              perm=fx.merge_perm(cap, cap, cuda))


@pytest.mark.parametrize("name", list(fx.KEY_EDGE_CASES))
def test_dict_keys_edges_match_its_plain_version(cuda, name):
    """dict_keys on the tile walk at its edges (``fx.key_edge_case``):
    blocks of 1,001 and 1,003 rows (not a multiple of a thread's tile)
    with per-block n_valid inside a tile, the 2-, 4- and 8-slot instances,
    NULL keys, REAL keys with NaN, +-inf and -0.0, bitpack, code and run
    columns, the range flag set and clear: keys and flag equal to the plain
    version's, two runs bit-identical, the instance the launcher picks the
    one the case was built for."""
    from tikv_tpu_torch.copr import fused_dict as fd

    slots, flagged = fx.KEY_EDGE_CASES[name]
    prog, img = fx.key_edge_case(name, cuda)
    out = fx.keys_kernel_check(prog, img)
    assert out["slots"] == slots and out["launches"] == 2
    assert bool(out["flag"] & fd.FLAG_RANGE) == flagged


def test_dict_keys_instances_keep_no_local_memory(cuda):
    """Every instance of dict_keys (2, 4 and 8 stack slots) keeps its walk
    in registers: 0 local bytes."""
    from tikv_tpu_torch.copr import fused_dict as fd

    for slots in (2, 4, 8):
        attrs = fd.keys_attributes(slots)
        assert attrs["localSizeBytes"] == 0 and attrs["stackSlots"] == slots, attrs


@pytest.mark.parametrize("name", fx.UNION_EDGE_CASES)
def test_union_kernel_edges_match_plain_version(cuda, name):
    """dict_union at its edges (``fx.union_edge_case``): 1, T - 1, T and
    T + 1 keys, all sentinel, all equal, exactly cap and cap + 1 distinct
    keys, a carried dictionary, every tile the tile route takes, the sort
    route; against its plain version, the flag too, twice bit for bit."""
    from tikv_tpu_torch.copr import fused_dict as fd

    d, keys, cap = fx.union_edge_case(name)
    fa.reset_launches()
    fx.union_kernel_check(d, keys, cap, cuda)
    assert fa.LAUNCHES["dict_union"] >= 2
    assert fd.union_attributes()["localSizeBytes"] == 0


@pytest.mark.parametrize("name", fx.COMPACT_EDGE_CASES + (fx.COMPACT_GRID_CASE,))
def test_dict_compact_edges_match_its_plain_version(cuda, name):
    """dict_compact in one launch at its edges (``fx.compact_edge_case``:
    equal keys across a tile boundary, all sentinel, exactly cap and cap + 1
    distinct keys, one sort tile, the mesh path's shard and global unions,
    and 4,194,304 keys: 2,048 tiles, more blocks than the card holds at
    once, so that tickets order them) against compact_plain, the flag too,
    twice bit for bit, its scratch left zero; then the whole union of the
    keys shuffled against dict_union_plain, one compaction a union."""
    from tikv_tpu_torch.copr import fused_dict as fd

    s, cap = fx.compact_edge_case(name)
    out = fx.compact_kernel_check(s, cap, cuda)
    assert out["blocks"] == fd.compact_tiles(s.numel())
    keys = torch.from_numpy(np.random.default_rng(2).permutation(s.numpy()))
    fa.reset_launches()
    fx.union_kernel_check(None, keys, cap, cuda)
    assert fa.LAUNCHES["dict_compact"] == 2 and "dict_count" not in fa.LAUNCHES
    assert fa.LAUNCHES["dict_merge"] == 2 * len(fd.merge_plan(keys.numel()))


def test_compaction_and_wide_combine_keep_no_local_memory(cuda):
    """dict_compact and every instance (2, 4 and 8 stack slots) of
    group_wide_combine and fused_group_agg_combine_pack keep their state in
    registers and shared memory: 0 local bytes."""
    from tikv_tpu_torch.copr import fused_dict as fd

    assert fd.compact_attributes()["localSizeBytes"] == 0
    for slots in (2, 4, 8):
        for wide in (True, False):
            attrs = ga.combine_attributes(slots, wide=wide)
            assert attrs["localSizeBytes"] == 0, (wide, attrs)


def test_wide_combine_matches_its_plain_version_on_crafted_states(cuda):
    """group_wide_combine over a state whose f64 sum cells hold the
    rounding's edges (``fx.wide_combine_crafted``: random signed words in
    every position, ties at the rounding bit of both parities, subnormals,
    sums that cancel, negative sums, sums past the largest double, words
    carrying into the next) and every combination of the NaN and infinity
    flags: bit for bit against wide_combine_plain, NaN equal to NaN, from
    the identity and into a carry, twice."""
    prog, img, cap, state = fx.wide_combine_crafted(cuda)
    fa.reset_launches()
    for _ in range(2):
        fx.wide_combine_check(prog, img, cap, state)
    assert fa.LAUNCHES["group_wide_combine"] == 4


def test_sharded_grouped_evaluator_on_the_card(cuda):
    """ShardedGroupedEvaluator on make_mesh(["cuda:0"] * 8): Q1's grouped
    shape at G = 2 and (quantity, linestatus) at G = 1, each equal to the
    same evaluator on eight CPU shards and to the oracle, twice bit for bit;
    every dictionary kernel and the fold launched."""
    from tikv_tpu_torch.parallel import mesh as pm

    n = 300_000
    a = fx.build_arrays(n, seed=16)
    for keys, cap, groups in ((("rf", "ls"), 64, 2), (("qty", "ls"), 128, 1)):
        wire = dag_to_wire(fx.grouped_dag(keys))
        card, cpu = (pm.ShardedGroupedEvaluator(wire, pm.make_mesh([d] * 8, groups), 8192,
                                                capacity=cap) for d in (cuda, "cpu"))
        total = card.total_rows
        blocks = [(fx.grouped_columns(a, s, min(s + total, n)), min(total, n - s))
                  for s in range(0, n, total)]
        fa.reset_launches()
        runs = [card.unpack(card.run_blocks(blocks)) for _ in range(2)]
        for name in ("dict_keys", "dict_union", "dict_ids", "mesh_fold"):
            assert fa.LAUNCHES[name] > 0, name
        assert fa.LAUNCHES["fused_group_agg_combine_pack"] == fa.LAUNCHES["mesh_merge"] == 0
        want = cpu.unpack(cpu.run_blocks(blocks))
        for got in runs:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            for g_agg, w_agg in zip(got[2], want[2]):
                for g, w in zip(g_agg, w_agg):
                    np.testing.assert_array_equal(g, w)
            assert got[3] == want[3] is False
        fin, oracle = card.finalize(card.run_blocks(blocks)), fx.grouped_oracle(a, keys)
        np.testing.assert_array_equal(fin["keys"], oracle["keys"])
        np.testing.assert_array_equal(fin["first"], oracle["first"])
        for g_agg, w_agg in zip(fin["aggs"], oracle["aggs"]):
            for g, w in zip(g_agg, w_agg):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_data,n_null", [(1, 0), (1, 1), (2, 0), (5, 3), (16, 16)])
def test_patch_stacked_matches_its_plain_version(cuda, n_data, n_null):
    """patch_stacked against index_put_ per lane, bit for bit: int64 and
    f64 lanes (NaN, -0.0, +-inf), nullable and not, 1 to 16 lanes, 10,000
    positions spread over 40 blocks of 131,072 rows; one launch."""
    case = fx.patch_case(40, 1 << 17, n_data, n_null, 10_000, seed=n_data * 17 + n_null, device=cuda)
    fa.reset_launches()
    assert fx.patch_kernel_check(*case) == 1
    assert fa.LAUNCHES["patch_stacked"] == 1


def test_patch_stacked_refuses_duplicate_positions(cuda):
    from tikv_tpu_torch.copr import fused_patch

    lanes, nulls, _pos, vals, nls = fx.patch_case(2, 1024, 2, 1, 3, seed=5, device=cuda)
    with pytest.raises(ValueError, match="unique"):
        fused_patch.patch_stacked(lanes, nulls, np.array([7, 1500, 7]), vals, nls)
    with pytest.raises(ValueError, match="one device"):
        fused_patch.patch_stacked([lanes[0], lanes[1].cpu()], nulls, np.array([1, 2, 3]), vals,
                                  nls)


def test_region_write_path_on_the_card(cuda):
    """A date-ordered lineitem region written as MVCC versions, served warm
    on the card from a plain image: an in-place update through scan_delta
    and one through write-through patch the pinned stacked lanes with
    patch_stacked (one launch a pin), the pins equal to a rebuild, every
    answer equal to its oracle; an insert-and-delete batch repacks."""
    from tikv_tpu_torch.copr import region_cache as prc
    from tikv_tpu_torch.copr.cache import ColumnBlockCache
    from tikv_tpu_torch.copr.table import record_range

    a = fx.sort_by_shipdate(fx.build_arrays(200_000, seed=18))
    eng = fx.region_engine(a)
    rc = prc.RegionColumnCache(block_rows=1 << 15, encode_columns=False, data_token=None)
    evs = [TorchDagEvaluator(dag_to_wire(d), block_rows=1 << 15, device="cuda")
           for d in (fx.q6_dag(), fx.q1_dag())]
    for ev, hint in zip(evs, ("unary", None)):
        ev.route_hint = hint
    ai, ts = 3, 200

    def serve(want):
        bc, out, n = rc.serve(eng.snapshot(), fx.region_context(ai), fx.lineitem(),
                              [record_range(fx.TABLE_ID)], ts)
        assert evs[0].run(None, bc).iter_rows() == [fx.q6_oracle(a)]
        assert evs[1].run(None, bc).iter_rows() == fx.q1_oracle(a)
        assert (out, n) == want
        return bc

    cache = serve(("miss", 0))
    for seed, kw, wt in ((1, dict(n_update=200, q6_movers=20, new_flag=True), False),
                         (2, dict(n_update=2000, q6_movers=50), True),
                         (3, dict(n_update=10, n_insert=300, n_delete=200), False)):
        b, puts, dels = fx.region_write(a, seed, **kw)
        ops = fx.region_write_ops(b, puts, dels, ts + 5, ts + 10)
        fx.apply_region_ops(eng, ops)
        ai, ts, a = ai + 1, ts + 100, b
        if wt:
            prc.notify_region_write(fx.REGION_ID, ops, ai)
        pins = sum(1 for sig in cache.blocks[0].device if sig[0] == "stacked")
        fa.reset_launches()
        serve(("wt_delta" if wt else "delta", len(puts) + len(dels)))
        if "n_insert" in kw:  # the structural repack drops the pins
            assert fa.LAUNCHES["patch_stacked"] == 0
            continue
        assert pins > 0 and fa.LAUNCHES["patch_stacked"] == pins
        copy = ColumnBlockCache.from_numpy_blocks(
            [([(c.eval_type.value, np.asarray(c.data), np.asarray(c.nulls), c.frac, c.dictionary)
               for c in blk.cols], blk.n_valid) for blk in cache.blocks])
        for sig, pin in list(cache.blocks[0].device.items()):
            if sig[0] == "stacked":
                fresh = evs[1]._stacked_device(copy, ship_cols=sig[1], nullable=sig[2])
                for got, want in zip(pin[0], fresh.cols):
                    assert torch.equal(got, want)


@pytest.mark.parametrize("old_kind", fx.IDS_OLD)
@pytest.mark.parametrize("cap", [64, 8193, 32768, 262_144])
def test_dict_ids_matches_plain_version(cuda, cap, old_kind):
    """dict_ids in shared memory (64 slots) and past it with the
    device-memory tail (8,193 slots, the grouped mesh's 32,768, the global
    union's 262,144 of the high-capacity phase): keys below, above, equal to
    and between the dictionary's and the sentinel, 100,003 of them (not a
    multiple of the keys a thread takes); old dictionaries with sentinel
    slots, equal to the new one, and with every slot moved: ids and perm
    equal to the plain version's, two runs bit-identical."""
    new, keys, old = fx.ids_case(cap, 100_003, old_kind, cap + len(old_kind), cuda)
    fa.reset_launches()
    assert fx.ids_kernel_check(new, keys, old) == {
        "ids": 100_003, "perm": 0 if old is None else cap}
    assert fa.LAUNCHES["dict_ids"] == 2
