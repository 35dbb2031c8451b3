"""The port's CUDA kernels on the card (marker ``gpu``).

Each test takes the ``cuda`` fixture, which skips when no CUDA device is
present, so every worker collects the same tests.  On a machine with the
card: ``python -m pytest tests/test_torch_gpu.py -m gpu -q``.
"""

import pytest
import torch

from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_agg as fa
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
