"""The port's CUDA kernels on the card (marker ``gpu``).

Each test takes the ``cuda`` fixture, which skips when no CUDA device is
present, so every worker collects the same tests.  On a machine with the
card: ``python -m pytest tests/test_torch_gpu.py -m gpu -q``.
"""

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
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def _assert_close(got, want):
    assert torch.equal(got[0].cpu(), want[0].cpu())  # int leaves exact
    torch.testing.assert_close(got[1].cpu(), want[1].cpu(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_blocks,block_rows", [(1, 1 << 16), (40, 1 << 17)])
def test_kernel_matches_plain_version(cuda, n_blocks, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(1)
    prog, img = fx.synthetic_case(n_blocks, block_rows, gen, cuda)
    got = fa.fused_agg(prog, img)
    _assert_close(got, fa.fused_agg_plain(prog, img))
    again = fa.fused_agg(prog, img)
    assert torch.equal(got[0], again[0])
    assert torch.equal(got[1].view(torch.int64), again[1].view(torch.int64))
    grid, threads = fa.kernel_grid()
    scratch = torch.empty((grid, len(prog.aggs), 2), dtype=torch.int64, device=cuda)
    fa.launch_partials(prog, img, scratch)
    want = fa.partials_plain(prog, img, grid, threads)
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
        want_p = ga.partials_plain(prog, img, cap, ga.launch_grid(img))
        for l, leaf in enumerate(prog.leaves):
            if leaf.is_f64:
                torch.testing.assert_close(parts[:, l].view(torch.float64),
                                           want_p[:, l].view(torch.float64), rtol=1e-12, atol=0)
            else:
                assert torch.equal(parts[:, l], want_p[:, l]), l
        _assert_close(ga.combine_plain(prog, img, cap, parts), got)


def test_grouped_kernel_declines_f64_leaves_past_its_capacity(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    prog, img, _cap = fx.synthetic_group_case("host", 1, 4096, gen, cuda)
    before = dict(fa.LAUNCHES)
    with pytest.raises(fa.Unsupported) as exc:
        ga.fused_group_agg(prog, img, prog.c_max + 1)
    assert exc.value.cause == "real_group_capacity_not_ported"
    assert fa.LAUNCHES == before
    img.gids = img.gids.to(torch.int64)
    with pytest.raises(ValueError):
        ga.fused_group_agg(prog, img, 64)


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
    assert ev.run(None, cache).iter_rows() == fx.q1_oracle(a)
    assert ev.run(None, cache).iter_rows() == fx.q1_oracle(a)
    assert fa.LAUNCHES["fused_group_agg_partials"] == 2  # one per query, coded ids
    ev_q = TorchDagEvaluator(dag_to_wire(fx.qty_dag()), block_rows=1 << 17, device=cuda)
    assert ev_q.run(None, cache).iter_rows() == fx.qty_oracle(a)


# -- the mask and the top-K kernels --------------------------------------------

@pytest.mark.parametrize("n_blocks,block_rows", [(1, 1 << 16), (40, 1 << 17)])
def test_mask_kernel_matches_plain_version(cuda, n_blocks, block_rows):
    gen = torch.Generator(device=cuda).manual_seed(5)
    prog, img = fx.synthetic_mask_case(n_blocks, block_rows, gen, cuda)
    got = fm.fused_mask(prog, img)
    assert torch.equal(got, fm.fused_mask_plain(prog, img))
    assert torch.equal(got, fm.fused_mask(prog, img))


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
    merged = torch.empty(((runs.shape[0] + 2) // 2, prog.n_words, k), dtype=torch.int64,
                         device=cuda)
    ft.launch_merge(runs, runs[0].clone(), merged)
    assert torch.equal(merged, ft.merge_plain(want_runs, want_runs[0].clone()))
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
        ev = TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device=cuda)
        assert ev.run(None, cache).iter_rows() == want, name
        if name == "q6" and order == "shipdate":
            assert ev.prune_stats[1] > ev.prune_stats[0] // 2  # most blocks pruned
        assert ev.run(None, plain).iter_rows() == want, name
    for name, count in fa.LAUNCHES.items():
        assert count > 0 or name == "decode_column", name
    # the same shipped columns pin in at most 30% of the plain bytes
    assert cache.device_nbytes() <= 0.3 * plain.device_nbytes()
