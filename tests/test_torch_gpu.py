"""The port's CUDA kernels on the card (marker ``gpu``).

Each test takes the ``cuda`` fixture, which skips when no CUDA device is
present, so every worker collects the same tests.  On a machine with the
card: ``python -m pytest tests/test_torch_gpu.py -m gpu -q``.
"""

import pytest
import torch

from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_agg as fa
from tikv_tpu_torch.copr import fused_group_agg as ga
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
