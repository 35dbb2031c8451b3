"""``mesh_fold``: the mesh path's fold of the shards' raw partial rows, on the CPU.

``mesh_fold`` takes the rows ``fused_group_agg_partials`` writes for each
shard of a super-block and gives, in one launch on the card, what
``fused_group_agg_combine_pack`` per shard, then ``mesh_merge`` over the
packed states in shard order and into the carry, give.  Its plain version
is held here word for word (f64 leaves by their bits) to that composition
written with each shard's own one-block image (``combine_plain``, then
``mesh_merge_plain``): every mergeable leaf kind with NaN, +-inf and
+-0.0, int64 wrap, the tracker through distinct shard offsets, one and
several partial rows a shard (past the combine's 256 threads too), empty
shards, two windows, the carry remap (``perm``) and ``first`` refused.  The
integer leaves are also held to direct numpy statements.  The sharded
evaluators' steps (``parallel/mesh.py``) are held to the same composition
at their own inputs; their answers stay held to the JAX package's mesh by
``tests/test_torch_mesh.py`` and ``tests/test_torch_mesh_grouped.py``.
"""

import numpy as np
import pytest
import torch

from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_group_agg as ga
from tikv_tpu_torch.copr import fused_mesh
from tikv_tpu_torch.copr.aggr import AggDescriptor
from tikv_tpu_torch.copr.dag import Aggregation, DagRequest, Selection, TableScan
from tikv_tpu_torch.copr.dag_wire import dag_to_wire
from tikv_tpu_torch.copr.datatypes import ColumnInfo, FieldType
from tikv_tpu_torch.copr.fused_agg import NO_ROW, Image
from tikv_tpu_torch.copr.rpn import call, col, const_int
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
from tikv_tpu_torch.parallel import mesh as pm

U64 = 1 << 64


def _composition(prog, rows, shards, base, width, windows, images, perm=None):
    """``combine_plain`` over each shard's rows with its image, then
    ``mesh_merge_plain`` of the packed states in shard order over each
    window into its carry."""
    cap = rows.shape[2]
    states = [ga.combine_plain(prog, img, cap, rows[r0:r0 + n])
              for (r0, n, _off), img in zip(shards.tolist(), images)]
    parts = (torch.stack([s[0] for s in states]), torch.stack([s[1] for s in states]))
    table = fused_mesh.merge_table([range(len(states))], len(states), "cpu")
    out = []
    for lo, carry in windows:
        c = None if carry is None else (carry[0][None], carry[1][None])
        ints, flts = fused_mesh.mesh_merge_plain(prog, parts, table, c, lo, lo + width, perm)
        out.append((ints[0], flts[0]))
    return out


def _images(shards, base, rows_per_shard):
    """Each shard's one block of ``rows_per_shard`` rows at its global row."""
    return [Image([], [], 0, 1, rows_per_shard, torch.device("cpu"), base + off)
            for _r0, _n, off in shards.tolist()]


def _same_words(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
        assert torch.equal(g[1].view(torch.int64), w[1].view(torch.int64))


@pytest.mark.parametrize("n_parts", [1, 3, 300])
@pytest.mark.parametrize("n_windows", [1, 2])
def test_fold_plain_is_the_combines_then_the_merge(n_parts, n_windows):
    """Every mergeable leaf kind, NaN, +-0.0, +-inf and int64 wrap; one
    partial row a shard (1,024-row shards), three, and 300 (the combine's
    strided fold past its 256 threads); one window, or two members' halves
    of the slots, each into its own carry."""
    rps = 1024 * n_parts
    prog, rows, shards, base, width, windows = fx.mesh_fold_case(8, n_parts, 16, rps,
                                                                 n_parts + n_windows, "cpu",
                                                                 n_windows)
    assert {leaf.kind for leaf in prog.leaves} == set(range(ga.LEAF_TRACK, ga.LEAF_XOR + 1))
    got = fused_mesh.mesh_fold(prog, rows, shards, base, width, windows)
    _same_words(got, _composition(prog, rows, shards, base, width, windows,
                                  _images(shards, base, rps)))
    # no carry: the shards' fold alone
    bare = [(lo, None) for lo, _c in windows]
    _same_words(fused_mesh.mesh_fold(prog, rows, shards, base, width, bare),
                _composition(prog, rows, shards, base, width, bare, _images(shards, base, rps)))


def test_fold_integer_leaves_and_the_tracker_as_numpy_states():
    """The integer leaves against direct numpy statements over every row of
    the window's slots: counts and sums add with wrap, min and max, the
    bitwise folds, and the tracker: the least global row, each shard's flat
    rows moved by its own offset (shuffled, not in shard order) and the
    launch's base, NO_ROW where no row is."""
    prog, rows, _shards, base, width, windows = fx.mesh_fold_case(6, 2, 16, 4096, 7, "cpu", 2)
    offsets = [5 * 4096, 0, 3 * 4096, 4096, 4 * 4096, 2 * 4096]
    shards = fused_mesh.shard_table([(2 * k, 2, off) for k, off in enumerate(offsets)], 12,
                                    "cpu")
    got = fused_mesh.mesh_fold(prog, rows, shards, base, width, windows)
    _same_words(got, _composition(prog, rows, shards, base, width, windows,
                                  _images(shards, base, 4096)))
    r = rows.numpy()
    for (lo, carry), (ints, _flts) in zip(windows, got):
        for l, leaf in enumerate(prog.leaves):
            if leaf.is_f64:
                continue
            words = r[:, l, lo:lo + width]
            c = carry[0][leaf.slot].numpy()
            k = leaf.kind
            if k == ga.LEAF_TRACK:
                shift = np.repeat(np.array(offsets, dtype=np.int64) + base, 2)[:, None]
                glob = np.where(words >= NO_ROW, NO_ROW, words + shift)
                want = np.minimum(c, glob.min(0))
            elif k in (ga.LEAF_COUNT, ga.LEAF_SUM):
                total = (c.astype(object) + words.astype(object).sum(0)) % U64
                want = np.array([t - U64 if t >= 1 << 63 else t for t in total], dtype=np.int64)
            elif k == ga.LEAF_MIN:
                want = np.minimum(c, words.min(0))
            elif k == ga.LEAF_MAX:
                want = np.maximum(c, words.max(0))
            elif k == ga.LEAF_AND:
                want = c & np.bitwise_and.reduce(words, 0)
            elif k == ga.LEAF_OR:
                want = c | np.bitwise_or.reduce(words, 0)
            else:
                want = c ^ np.bitwise_xor.reduce(words, 0)
            np.testing.assert_array_equal(ints[leaf.slot].numpy(), want, err_msg=str(leaf))


def test_fold_over_a_partial_super_block_with_empty_shards():
    """Shards past the super-block's valid rows hold their identities: the
    fold is the composition, its integer words those of the live shards
    alone and its f64 leaves equal in value (an identity sum may turn -0.0
    into +0.0)."""
    prog, rows, shards, base, width, windows = fx.mesh_fold_case(8, 2, 16, 2048, 11, "cpu", 2,
                                                                 empty=(5, 6, 7))
    got = fused_mesh.mesh_fold(prog, rows, shards, base, width, windows)
    _same_words(got, _composition(prog, rows, shards, base, width, windows,
                                  _images(shards, base, 2048)))
    live = fused_mesh.mesh_fold(prog, rows[:10], shards[:5], base, width, windows)
    for g, w in zip(got, live):
        assert torch.equal(g[0], w[0])
        assert bool(((g[1] == w[1]) | (g[1].isnan() & w[1].isnan())).all())


def test_fold_moves_the_carry_through_perm():
    """The grouped mesh's remap: the carry's slot i goes to slot perm[i]
    (dropped past the slots), a slot no carry slot moves to starts from the
    identity; a perm takes one window of every slot."""
    cap = 64
    prog, rows, shards, base, width, windows = fx.mesh_fold_case(8, 4, cap, 1 << 12, 13, "cpu")
    perm = fx.merge_perm(cap, 13, "cpu")
    assert len(set(perm.tolist())) < cap  # slots move, some merge, some drop
    got = fused_mesh.mesh_fold(prog, rows, shards, base, width, windows, perm=perm)
    _same_words(got, _composition(prog, rows, shards, base, width, windows,
                                  _images(shards, base, 1 << 12), perm))
    # the same as the carry scattered through perm, then the bare fold into it
    bare = fused_mesh.mesh_fold(prog, rows, shards, base, width, [(0, None)])[0]
    moved = ga.init_packed(prog, cap, "cpu")
    carry = windows[0][1]
    for i, dst in enumerate(perm.tolist()):
        if dst < cap and not any(perm[j] == dst for j in range(i)):
            moved[0][:, dst] = carry[0][:, i]
            moved[1][:, dst] = carry[1][:, i]
    for leaf in prog.leaves:
        m = 1 if leaf.is_f64 else 0
        want = ga._merge(leaf, moved[m][leaf.slot], bare[m][leaf.slot])
        assert torch.equal(got[0][m][leaf.slot].view(torch.int64), want.view(torch.int64))
    two = fx.mesh_fold_case(8, 4, cap, 1 << 12, 13, "cpu", 2)
    with pytest.raises(ValueError, match="perm"):
        fused_mesh.mesh_fold(*two, perm=perm)


def test_fold_refuses_first_bad_tables_and_windows():
    ev = TorchDagEvaluator(dag_to_wire(DagRequest(executors=[
        TableScan(1, _COLS), Aggregation([col(2)], [AggDescriptor("first", col(1))])])),
        device="cpu")
    prog = ev.plan.group_program
    rows = torch.zeros((1, len(prog.leaves), 4), dtype=torch.int64)
    table = fused_mesh.shard_table([(0, 1, 0)], 1, "cpu")
    with pytest.raises(ValueError, match="mesh merge rule"):
        fused_mesh.mesh_fold(prog, rows, table, 0, 4, [(0, None)])
    with pytest.raises(ValueError, match="rows"):
        fused_mesh.shard_table([(0, 2, 0)], 1, "cpu")
    with pytest.raises(ValueError, match="shards"):
        fused_mesh.shard_table([], 1, "cpu")
    prog, rows, shards, base, width, windows = fx.mesh_fold_case(2, 1, 16, 1024, 3, "cpu", 2)
    with pytest.raises(ValueError, match="window"):
        fused_mesh.mesh_fold(prog, rows, shards, base, width, [(12, None)])
    with pytest.raises(ValueError, match="CUDA"):
        fused_mesh.launch_mesh_fold(prog, rows, shards, base, width, windows, [None, None])


# ---------------------------------------------------------------------------
# the sharded evaluators' steps
# ---------------------------------------------------------------------------

_COLS = [ColumnInfo(1, FieldType.int64(), is_pk_handle=True), ColumnInfo(2, FieldType.int64()),
         ColumnInfo(3, FieldType.int64()), ColumnInfo(4, FieldType.double())]


def _every_leaf_dag(group: bool):
    aggs = [AggDescriptor("count", None), AggDescriptor("sum", col(1)),
            AggDescriptor("sum", col(3)), AggDescriptor("avg", col(3)),
            AggDescriptor("var_pop", col(3)), AggDescriptor("min", col(3)),
            AggDescriptor("max", col(3)), AggDescriptor("min", col(1)),
            AggDescriptor("bit_and", col(1)), AggDescriptor("bit_or", col(2)),
            AggDescriptor("bit_xor", col(1))]
    return DagRequest(executors=[TableScan(1, _COLS),
                                 Selection([call("lt", col(1), const_int(900))]),
                                 Aggregation([col(2)] if group else [], aggs)])


def _columns(n, seed):
    """Host columns of :data:`_COLS`: the REAL column with NaN, +-inf and
    +-0.0 among its values."""
    rng = np.random.default_rng(seed)
    real = rng.standard_normal(n) * 1e3
    pick = rng.random(n) < 0.02
    real[pick] = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0])[rng.integers(0, 5, pick.sum())]
    data = [np.arange(n), rng.integers(0, 1000, n), rng.integers(0, 12, n), real]
    return {i: (d, np.zeros(n, dtype=bool)) for i, d in enumerate(data)}


@pytest.mark.parametrize("groups", [1, 2])
def test_sharded_step_folds_the_shards_rows_as_the_pair(groups, monkeypatch):
    """``ShardedDagEvaluator.step`` on eight CPU shards, every mergeable
    aggregate, a partial last super-block whose last shards are empty: each
    step's state is, word for word, the composition over the shards' own
    rows and images from the state before it; the partials are each
    shard's ``partials_plain``."""
    rps, cap = 64, 16
    ev = pm.ShardedDagEvaluator(dag_to_wire(_every_leaf_dag(False)),
                                pm.make_mesh(["cpu"] * 8, groups), rps, capacity=cap)
    seen = []
    shard_rows = pm._shard_rows

    def record(prog, images, c, lead):
        rows = shard_rows(prog, images, c, lead)
        seen.append((images, rows))
        return rows

    monkeypatch.setattr(pm, "_shard_rows", record)
    total = ev.total_rows
    cols = _columns(3 * total, groups)
    gids = np.random.default_rng(5).integers(0, cap, 3 * total).astype(np.int32)
    state = ev.init_state()
    w = ev.slice_width
    for b, n_valid in enumerate((total, total, 2 * rps + 5)):
        sl = slice(b * total, (b + 1) * total)
        before = [(s[0].clone(), s[1].clone()) for s in state]
        state = ev.step([cols[i][0][sl] for i in ev.ev.plan.device_cols], [], n_valid, gids[sl],
                        state,
                        block_base=b * total)
        images, rows = seen[-1]
        n = pm._parts_a_shard(rps)
        for k, img in enumerate(images):
            assert torch.equal(rows[k * n:(k + 1) * n], ga.partials_plain(ev.prog, img, cap))
        shards = fused_mesh.shard_table([(k * n, n, k * rps) for k in range(8)], 8 * n, "cpu")
        want = _composition(ev.prog, rows, shards, b * total, w,
                            [(g * w, before[g]) for g in range(groups)], images)
        _same_words(state, want)
    assert seen[-1][0][-1].n_valids == 0  # the last shard of the last super-block is empty


def test_grouped_step_folds_with_the_remap(monkeypatch):
    """``ShardedGroupedEvaluator.step``: the second super-block brings new
    keys, so the carry moves through a perm; the fold's output is, word for
    word, the composition over the shards' rows and images with that perm."""
    rps, cap = 128, 16
    ev = pm.ShardedGroupedEvaluator(dag_to_wire(_every_leaf_dag(True)),
                                    pm.make_mesh(["cpu"] * 8), rps, capacity=cap)
    seen, folds = [], []
    shard_rows, fold = pm._shard_rows, fused_mesh.mesh_fold

    def record_rows(prog, images, c, lead):
        rows = shard_rows(prog, images, c, lead)
        seen.append(images)
        return rows

    def record_fold(prog, rows, shards, base, width, windows, outs=None, perm=None):
        out = fold(prog, rows, shards, base, width, windows, outs, perm)
        folds.append((rows, shards, base, width, [(lo, (c[0].clone(), c[1].clone()))
                                                  for lo, c in windows], perm, out))
        return out

    monkeypatch.setattr(pm, "_shard_rows", record_rows)
    monkeypatch.setattr(fused_mesh, "mesh_fold", record_fold)
    total = ev.total_rows
    cols = _columns(2 * total, 9)
    cols[2] = (np.concatenate([np.arange(total) % 5, 5 + np.arange(total) % 7]),
               cols[2][1])  # keys 0-4, then 5-11 sort among them
    state = ev.init_state()
    for b in range(2):
        sl = slice(b * total, (b + 1) * total)
        state = ev.step([cols[i][0][sl] for i in ev.ship_cols], [], total, state,
                        block_base=b * total)
    rows, shards, base, width, windows, perm, out = folds[-1]
    assert perm is not None and perm.tolist() != list(range(cap))
    _same_words(out, _composition(ev.prog, rows, shards, base, width, windows, seen[-1], perm))
    fin = ev.finalize(state)
    assert len(fin["keys"]) == 12 and not fin["overflow"]
