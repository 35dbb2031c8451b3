#!/usr/bin/env python3
"""Run phases of ``chip_smoke.py`` from two checkouts in turns on one card.

    python3 scripts/paired_phases.py BASE_DIR [--phases mesh_grouped] [--rounds 1]

``BASE_DIR`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a directory that ``.gitignore``
lists); this script's own checkout is the change.  Each phase runs in a
fresh process from each checkout, in the order base, change, change, base
(``--rounds`` times), so that the two versions share the card and the host
and drift between them cancels.  A phase takes ``(fixtures, card, device)``
(``mesh_grouped``, ``join``), or is ``filters``: config 2's filter cold over
1M rows and warm over the 10M image, and the warm selective filter, as
``chip_smoke.py``'s scan phase serves them (no oracle check: that script
holds the answers), or ``mask``: ``fused_mask`` alone under the selective
filter's plan over config 2's 10M-row image, plain then encoded in place
(``chip_smoke.time_mask``, held to its plain version; five CUDA-event times
of 20 launches each, reported in seconds a launch), or ``batch_kernels``:
``batch_partials`` alone (``chip_smoke.time_batch``: CUDA events, 5 or 10
launches a time, five times) at batch A's eight riders over the 100M-row
image (and again with each rider on an image object of its own, so that
the riders take CTAs of their own), Q1 over the 64 region images and over
the 8 encoded ones, or
``topn_kernels``: ``topn_candidates`` alone (``chip_smoke.time_topn``, three
times) at the warm raw TopN over the 100M-row image, plain then encoded in
place, each beside its plain version's ms and its bound, or ``requests``:
batch A (the batch kernels) and batch B (the zone rung) over the 100M-row
image, four runs each after a first that pins, the warm raw TopN likewise,
and the cold raw TopN over 1M KV rows three times (host clock around
synchronized runs), or ``group_kernels``: ``fused_group_agg_partials`` alone
(``chip_smoke.time_group_kernels`` once, held to its plain version, then
four more CUDA-event times) at a cold Q1 block (65,536 rows, 8 slots), a
grouped-mesh shard's shape (131,072 rows of Q1, 64 slots), warm GROUP BY
l_quantity (host ids), Q6's one slot beside ``fused_agg_partials`` on the
same image and warm Q1 over the 100M image, plain then encoded in place,
the wide route (``group_wide_partials``) at 4,096 slots on the plain one,
or ``slice15_kernels``: over the supplier table's 100M-row image (which
holds lineitem's draws), ``fused_agg_partials`` at warm Q6, the grouped
partials at Q6's one slot and at warm Q1, ``batch_partials`` at batch A,
``group_wide_partials`` at the per-supplier query (262,144 slots) and at
Q1 grouped by the four flag columns (512 slots, almost every row kept), then
``fused_agg_partials`` at a cold 65,536-row Q6 block, the wide partials at
the per-supplier query's cold block (16,384 slots) and at a grouped-mesh
shard (131,072 rows, 32,768 slots), then the warm cases again over the
image encoded in place (five CUDA-event times each), or
``slice15_requests``: warm Q6 on the stacked route, cold Q6, the
per-supplier query cold over 1M KV rows and warm over the 100M image (host
clock; warm Q6 and the warm per-supplier query once more under
``torch.profiler``), or ``dict_ids``: ``dict_ids``
alone at a shard's 131,072 keys into 32,768 slots (16,664 consecutive
integers filled; again 20,000 random 31-bit values), into 64 (4 filled) and
at the grouped mesh's own inputs at 32,768 slots (captured from its second
super-block), with the carried dictionary and without it, beside
``torch.searchsorted`` of the keys and of the keys and the carried
dictionary (the kernel's whole function), five CUDA-event times of 50
launches each, or ``group_requests``: warm Q1 and warm GROUP BY
l_quantity on the stacked route (``route_hint="unary"``) over the 100M-row
image, cold Q1 over 1M KV rows and batch A, or ``mesh_requests``: the
grouped mesh at 32,768 slots (per-supplier statistics over 10M rows on 8
shards), each request run several times in one process (host clock around
synchronized runs; a warm first run, which pins, left out) and once more
under ``torch.profiler`` (the device's busy time, reported as the case
``<name>_device``, and the kernels that take most of it), or
``zone_kernels``: ``zone_full`` and ``zone_partial`` (and ``zone_fold``)
alone at the zone rung's Q6 and Q1 layouts of the 100M-row plain image,
each first held to its plain version (``chip_smoke.check_zone_outputs``),
then five CUDA-event times (``chip_smoke.time_zone``, which also gives the
plain version's ms, the bound and, for ``zone_full``, the one-column
yardstick), or ``zone_requests``: warm Q6, Q1 and Q1 + TopN over the same
image on the zone rung and with ``route_hint="unary"`` in one process,
byte-identical, each route pinned by a first run and then seven runs of
each in turns (host clock around synchronized runs), or ``merge_kernels``:
the top-K merge as a whole stage (``_merge_all``, every level; five
CUDA-event times) at the warm 100M-row raw TopN's runs, a mesh shard
step's 32 tiles and a cold 65,536-row block's 16 with a carry run, and
the mesh finalize's 8 runs of one more word; the dictionary union's merge
stage (every ``dict_merge`` launch of the sort route) and the whole union
at the grouped mesh's shard and global unions at 32,768 slots (inputs
captured from its second super-block), or ``merge_requests``: the warm raw
TopN over the 100M-row image, the mesh raw TopN over 10M rows (8 shards,
131,072 rows a shard) and the grouped mesh at 32,768 slots (host clock,
a first run left out; once more under ``torch.profiler``), or
``fold_split``: one cold Q1 super-block of the mesh (8 shards of 1,024
rows on the card, G = 1, and 4 shards at G = 2; its second, which has a
carry) stepped 20 times from the same state, each step's host ms split by
the mesh module's functions it calls (``_shard_images``, the shards' own
work in ``_shard_states`` or ``_shard_rows``, and ``mesh_merge`` or
``mesh_fold``; the rest ``other``) and the wait for the card after it, the
medians reported as cases, or ``fold_requests``: cold Q1 and Q6 over 1M KV
rows through ``MeshServingRunner`` on 8 shards of the card at 1,024 rows a
shard (G = 1 and, for Q1, 2) and Q1 at 65,536 (host clock, four runs; once
more under ``torch.profiler``), or ``slice19_kernels``: the sort route's
compaction alone (each checkout's: one launch, or the pair of count and
compact) over the merge stage's sorted keys at the grouped mesh's shard and
global unions at 32,768 slots (inputs captured from its second
super-block) and the whole unions, then ``group_wide_combine`` alone at a
grouped-mesh shard (32,768 slots), the cold per-supplier block (16,384),
the warm per-supplier query over the 100M-row supplier image (262,144), the
same ids at ``c_max + 1`` and the batch riders past their rows (Q1 by the
four flag columns, 512 slots; five CUDA-event times each), or
``slice19_requests``: the grouped mesh at 32,768 slots and the cold
per-supplier query over 1M KV rows (host clock, a first run left out; once
more under ``torch.profiler``, with the launches counted), or
``slice20_kernels``: ``dict_keys`` alone at the grouped mesh's shards
(Q1 at 64 slots, the per-supplier query at 32,768; inputs captured from
their second super-blocks) and at Q1's shard with its lanes bitpacked, then
``topn_pack`` alone at the main paths' captured inputs: the warm raw TopN
over the 100M-row image (plain, then encoded in place), a cold 65,536-row
block with the carry, a mesh shard step with the carry and the mesh
finalize's [8, K] image (each held to its plain version, then five
CUDA-event times of 50 launches), or ``slice20_requests``: the grouped mesh
over 10M rows at 64 and 32,768 slots, the mesh raw TopN over 10M rows and
the warm raw TopN over 100M rows (host clock, a first run left out; once
more under ``torch.profiler``, with the launches counted and each kernel's
device ms), or ``slice21_kernels``: ``zone_fold`` alone at the zone rung's
warm Q6 and Q1 layouts over the 100M-row image (each checkout's
``chip_smoke.time_zone``, five times), then
``fused_group_agg_combine_pack`` alone at the grouped pair's captured
inputs, a cold 65,536-row Q1 block, warm Q1 and warm GROUP BY l_quantity
on the stacked route (each held to its plain version, then five
CUDA-event times of 200 launches), or ``slice21_requests``: the
zone-served warm Q6, Q1 and Q1 + TopN (seven runs after a first that pins,
then each checkout's ``chip_smoke.zone_request_split``, its steps reported
as cases ``zone_<q>_split_<step>``), cold Q1 over 1M KV rows and warm Q1
with ``route_hint="unary"`` (host clock; once more under
``torch.profiler``).  Each process
builds its checkout's kernels first (outside the phase's clock).  Prints
one JSON line per run (the checkout, the phase's request times by case,
the phase's seconds) and a last line with each case's median, quartiles
and count over the runs of each checkout.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

CHANGE_DIR = Path(__file__).resolve().parent.parent

CHILD = """
import json, sys, time, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from tikv_tpu_torch import _build, fixtures as fx
_build.build_all()
t0 = time.perf_counter()


# fused_agg_partials' scratch for an image, by either checkout's launcher
# (a grid by the image's shape, or a fixed one)
def fa_scratch(fa, prog, img):
    if hasattr(fa, "new_scratch"):
        return fa.new_scratch(prog, img)
    grid, _threads = fa.kernel_grid()
    return torch.empty((grid, len(prog.aggs), 2), dtype=torch.int64, device=img.device)


if sys.argv[1] == "filters":
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
    cache = fx.build_cache(cs.FILTER_ROWS, 1 << 17, cs.SEED)
    kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)
    plans = {"cold_filter": ("filter", cs.SCAN_LIMIT, 1 << 16),
             "warm_filter": ("filter", cs.SCAN_LIMIT, 1 << 17),
             "warm_selective": ("selective", None, 1 << 17)}
    cases = {}
    for name, (kind, limit, br) in plans.items():
        ev = TorchDagEvaluator(dag_to_wire(fx.filter_dag(kind, limit)), block_rows=br,
                               device="cuda")
        cold = name.startswith("cold")
        secs = [cs.timed_run(ev, FixtureScanSource(kvs) if cold else None,
                             None if cold else cache)[1] for _ in range(2 if cold else 4)]
        cases[name] = {"request_s": secs if cold else secs[1:]}  # a warm first run pins
    print(json.dumps({"cases": cases}))
elif sys.argv[1] == "mask":
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_mask as fm
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
    cache = fx.build_cache(cs.FILTER_ROWS, 1 << 17, cs.SEED)
    ev = TorchDagEvaluator(dag_to_wire(fx.filter_dag("selective")), block_rows=1 << 17,
                           device="cuda")
    cases = {}
    for name in ("mask_plain", "mask_encoded"):
        if name == "mask_encoded":
            encoding.encode_blocks(cache)
        img = ev._stacked_device(cache)
        cases[name] = {"request_s": [cs.time_mask(fm, ev.plan.mask_program, img)["ms"] / 1e3
                                     for _ in range(5)]}
        del img
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("batch_kernels", "topn_kernels", "requests"):
    import copy
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_topn as ft
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource

    def ev_of(dag):
        return te.TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device="cuda")

    def partials_ms(tasks, iters):
        batch = fb.Batch(tasks)
        table = fb.upload_table(batch)
        parts = torch.empty(batch.n_parts, dtype=torch.int64, device=batch.device)
        return cs.cuda_ms(lambda: fb.launch_batch_partials(batch, table, parts), iters)

    cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    plans = fx.batch_plans()
    cases = {}
    if sys.argv[1] == "batch_kernels":
        evs = [ev_of(d) for _n, d, _o in plans]
        ev_q1 = evs[[n for n, _d, _o in plans].index("q1")]
        counts = [cs.XREGION_BLOCKS[r % len(cs.XREGION_BLOCKS)] for r in range(cs.XREGION_REGIONS)]
        regions = [c for _a, c in fx.region_caches(counts, 1 << 17, cs.SEED + 100,
                                                   two_flags=(3, 17))]
        enc = [c for _a, c in fx.region_caches(counts[: cs.XREGION_ENCODED], 1 << 17,
                                               cs.SEED + 100, two_flags=(3,))]
        for c in enc:
            encoding.encode_blocks(c, fx.lineitem())
        tasks_a = te.batch_tasks(evs, cache)[0]
        # batch A again with each rider's own image object (the same
        # tensors): the riders then take CTAs of their own, task by task
        alone = [fb.Task(t.prog, copy.copy(t.img), t.capacity) for t in tasks_a]
        for name, tasks, iters in (("batch_a", tasks_a, 5), ("batch_a_task_by_task", alone, 5),
                                   ("xregion_q1", te.xregion_tasks(ev_q1, regions)[0], 10),
                                   ("xregion_q1_encoded", te.xregion_tasks(ev_q1, enc)[0], 10)):
            t = cs.time_batch(fb, tasks, iters)
            cases[name] = {"request_s": [t["partials_ms"] / 1e3] + [
                               partials_ms(tasks, iters) / 1e3 for _ in range(4)],
                           "plain_ms": t["partials_plain_ms"], "bound_ms": t["partials_bound_ms"]}
            del tasks
    elif sys.argv[1] == "topn_kernels":
        ev = ev_of(fx.topn_dag(cs.TOPN_K))
        payload = list(range(len(ev.plan.schema)))
        for name in ("topn_plain", "topn_encoded"):
            if name == "topn_encoded":
                encoding.encode_blocks(cache)
            pay = ev._stacked_device(cache, payload)
            cand = te._pick(pay, payload, ev.plan.device_cols)
            t = [cs.time_topn(ft, ev.plan.topn_program, cand, pay) for _ in range(3)]
            cases[name] = {"request_s": [x["topn_candidates"]["ms"] / 1e3 for x in t],
                           "plain_ms": t[0]["topn_candidates"]["plain_ms"],
                           "bound_ms": t[0]["topn_candidates"]["bound_ms"],
                           "merge_levels": t[0]["merge_levels"]}
            del pay, cand
    else:
        evs_a = [ev_of(d) for _n, d, _o in plans]
        evs_b = [ev_of(d) for n, d, _o in plans if n != "bit_xor_by_linestatus"]
        ev_t = ev_of(fx.topn_dag(cs.TOPN_K))
        kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for name, fn, n in (("batch_a", lambda: te.run_batch_cached(evs_a, cache), 5),
                            ("batch_b", lambda: te.run_batch_cached(evs_b, cache), 5),
                            ("warm_topn", lambda: ev_t.run(None, cache), 5),
                            ("cold_topn", lambda: ev_t.run(FixtureScanSource(kvs)), 3)):
            secs = [timed(fn) for _ in range(n)]
            cases[name] = {"request_s": secs[1:] if name != "cold_topn" else secs}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] == "group_kernels":
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.copr.groupby import GroupDict
    from tikv_tpu_torch.copr.torch_eval import (GROUP_CAPACITY_START, TorchDagEvaluator,
                                                _capacity_for)

    def ev_of(dag, br=1 << 17):
        return TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cuda")

    cases = {}

    def timed(name, prog, img, cap, iters):
        t = cs.time_group_kernels(ga, prog, img, cap, iters)
        parts = ga.new_partials(prog, img, cap)
        cases[name] = {"request_s": [t["partials_ms"] / 1e3] + [
                           cs.cuda_ms(lambda: ga.launch_partials(prog, img, cap, parts),
                                      iters) / 1e3 for _ in range(4)],
                       "plain_ms": t["partials_plain_ms"], "bound_ms": t["partials_bound_ms"],
                       "grid": t["grid"], "attributes": t.get("partials_attributes")}

    # a cold Q1 block (65,536 rows, host ids, C = 8) and a grouped-mesh
    # shard's shape (131,072 rows of Q1, host ids, 64 slots)
    kvs = fx.build_kvs(1 << 17, cs.SEED)
    for name, br, cap in (("cold_q1_block", 1 << 16, GROUP_CAPACITY_START),
                          ("mesh_shard_shape", 1 << 17, 64)):
        ev = ev_of(fx.q1_dag(), br)
        cols, nv = next(ev._decode_blocks(FixtureScanSource(kvs[:br])))
        gids, _n = ev._assign_gids(cols, nv, GroupDict())
        timed(name, ev.plan.group_program, ev._block_image(cols, nv, gids, 0), cap, 50)
    cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    # GROUP BY l_quantity: host ids for every block of the 100M image
    ev_q = ev_of(fx.qty_dag())
    groups = GroupDict()
    all_gids = torch.stack([torch.from_numpy(ev_q._assign_gids(b.cols, b.n_valid, groups)[0])
                            for b in cache.blocks]).to("cuda")
    prog_q = ev_q.plan.group_program
    timed("warm_l_quantity", prog_q, ev_q._stacked_device(cache, gids=all_gids),
          _capacity_for(prog_q, 1, len(groups)), 10)
    del all_gids
    # Q6's one slot on the grouped kernel, beside fused_agg_partials
    ev6 = ev_of(fx.q6_dag())
    plan6, prog6 = ev6.plan, ev6.program
    img6 = ev6._stacked_device(cache)
    prog_g6 = ga.compile_group_program(plan6.sel_rpns, plan6.agg_rpns, plan6.device_cols,
                                       plan6.schema, (), track=False)
    timed("warm_q6_one_slot", prog_g6, img6, 1, 10)
    scratch = fa_scratch(fa, prog6, img6)
    cases["warm_q6_fused_agg_partials"] = {"request_s": [
        cs.cuda_ms(lambda: fa.launch_partials(prog6, img6, scratch), 10) / 1e3
        for _ in range(5)]}
    del img6, scratch
    # warm Q1 (ids from the dictionary codes), plain then encoded in place
    ev1 = ev_of(fx.q1_dag())
    group_cols, dicts = ev1._stable_dict_group_cols(cache.blocks)
    dict_lens = tuple(len(d) for d in dicts)
    prog1 = ev1._coded_program(group_cols, dict_lens)
    cap1 = _capacity_for(prog1, 1, (dict_lens[0] + 1) * (dict_lens[1] + 1))
    for name in ("warm_q1", "warm_q1_encoded"):
        if name == "warm_q1_encoded":
            encoding.encode_blocks(cache)
        img1 = ev1._stacked_device(cache, ev1._ship_cols(group_cols))
        timed(name, prog1, img1, cap1, 10)
        if name == "warm_q1":
            # the wide route (group_wide_partials) on the same image at 4,096
            # slots: its state accumulates over the timed launches
            wide = ga.new_partials(prog1, img1, 4096)
            cases["warm_q1_wide_4096"] = {"request_s": [
                cs.cuda_ms(lambda: ga.launch_partials(prog1, img1, 4096, wide), 10) / 1e3
                for _ in range(5)]}
            del wide
        del img1
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("slice15_kernels", "slice15_requests"):
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    def ev_of(dag, br=1 << 17):
        ev = te.TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cuda")
        ev.route_hint = "unary"
        return ev

    # the supplier table's 100M-row image holds lineitem's draws and columns
    # too: Q6, Q1 and batch A read it as the lineitem image
    cache = fx.supp_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    cases = {}
    if sys.argv[1] == "slice15_kernels":
        def repeat(name, fn, iters):
            cases[name] = {"request_s": [cs.cuda_ms(fn, iters) / 1e3 for _ in range(5)]}

        ev6, ev1 = ev_of(fx.q6_dag()), ev_of(fx.q1_dag())
        plan6, prog6 = ev6.plan, ev6.program
        prog_g6 = ga.compile_group_program(plan6.sel_rpns, plan6.agg_rpns, plan6.device_cols,
                                           plan6.schema, (), track=False)
        group_cols, dicts = ev1._stable_dict_group_cols(cache.blocks)
        dict_lens = tuple(len(d) for d in dicts)
        prog1 = ev1._coded_program(group_cols, dict_lens)
        cap1 = te._capacity_for(prog1, 1, (dict_lens[0] + 1) * (dict_lens[1] + 1))

        def warm_cases(suffix):
            img6 = ev6._stacked_device(cache)
            scratch = fa_scratch(fa, prog6, img6)
            repeat("warm_q6" + suffix, lambda: fa.launch_partials(prog6, img6, scratch), 10)
            parts = ga.new_partials(prog_g6, img6, 1)
            repeat("warm_q6_one_slot" + suffix,
                   lambda: ga.launch_partials(prog_g6, img6, 1, parts), 10)
            img1 = ev1._stacked_device(cache, ev1._ship_cols(group_cols))
            parts1 = ga.new_partials(prog1, img1, cap1)
            repeat("warm_q1" + suffix, lambda: ga.launch_partials(prog1, img1, cap1, parts1), 10)

        warm_cases("")
        tasks_a = te.batch_tasks([ev_of(d) for _n, d, _o in fx.batch_plans()], cache)[0]
        batch = fb.Batch(tasks_a)
        table = fb.upload_table(batch)
        bparts = torch.empty(batch.n_parts, dtype=torch.int64, device=batch.device)
        repeat("batch_a", lambda: fb.launch_batch_partials(batch, table, bparts), 5)
        del tasks_a, batch, table, bparts
        # the per-supplier query's wide partials at its own inputs (host ids,
        # 262,144 slots); the state takes every timed launch
        ev_s = ev_of(fx.supp_dag())
        _r, calls = cs.capture_calls(te, "fused_group_agg", lambda: ev_s.run(None, cache))
        prog_s, img_s, cap_s = calls[0][:3]
        state = ga.new_partials(prog_s, img_s, cap_s)
        repeat("supp_warm_wide", lambda: ga.launch_partials(prog_s, img_s, cap_s, state), 10)
        del calls, img_s, state
        # a plan that keeps almost every row on the wide route: Q1 grouped
        # by the four flag columns (512 coded slots) with var_pop
        ev_f = ev_of(fx.flags4_dag(var_pop=True))
        _r, calls = cs.capture_calls(te, "fused_group_agg", lambda: ev_f.run(None, cache))
        prog_f, img_f, cap_f = calls[0][:3]
        st_f = ga.new_partials(prog_f, img_f, cap_f)
        repeat("flags4_wide", lambda: ga.launch_partials(prog_f, img_f, cap_f, st_f), 5)
        del calls, img_f, st_f
        # a cold Q6 block; the per-supplier query's cold block at 16,384 slots
        ev_c6 = te.TorchDagEvaluator(dag_to_wire(fx.q6_dag()), block_rows=1 << 16, device="cuda")
        cols, nv = next(ev_c6._decode_blocks(FixtureScanSource(fx.build_kvs(1 << 16, cs.SEED))))
        img_c6 = ev_c6._block_image(cols, nv)
        scr_c6 = fa_scratch(fa, ev_c6.program, img_c6)
        repeat("cold_q6_block", lambda: fa.launch_partials(ev_c6.program, img_c6, scr_c6), 50)
        ev_cs = te.TorchDagEvaluator(dag_to_wire(fx.supp_dag()), block_rows=1 << 16,
                                     device="cuda")
        _r, calls = cs.capture_calls(te, "fused_group_agg", lambda: ev_cs.run(
            FixtureScanSource(fx.supp_kvs(cs.HC_COLD_ROWS, cs.SEED))))
        cap_c = max(c[2] for c in calls)
        prog_c, img_c = next(c[:2] for c in calls if c[2] == cap_c)
        st_c = ga.new_partials(prog_c, img_c, cap_c)
        repeat("supp_cold_block_wide", lambda: ga.launch_partials(prog_c, img_c, cap_c, st_c),
               50)
        del calls
        # a shard of the grouped mesh at 32,768 slots (the first super-block)
        a_mesh = fx.supp_arrays(cs.HC_MESH_ROWS, cs.SEED)
        mev = pm.ShardedGroupedEvaluator(
            dag_to_wire(fx.supp_dag()), pm.make_mesh([torch.device("cuda", 0)] * cs.MESH_SHARDS,
                                                     groups=1),
            cs.MESH_GROUPED_RPS, capacity=cs.HC_MESH_CAP)
        total = mev.total_rows
        blk0 = (fx.supp_columns(a_mesh, 0, total, total), total)
        _st, calls = cs.capture_calls(pm, "_shard_states", lambda: mev.step(
            *cs._block_args(mev, blk0), mev.init_state()))
        sprog, simages, scap, _lead = calls[0]
        st_m = ga.new_partials(sprog, simages[0], scap)
        repeat("mesh_shard_wide", lambda: ga.launch_partials(sprog, simages[0], scap, st_m), 50)
        del a_mesh, calls, simages
        encoding.encode_blocks(cache)
        warm_cases("_encoded")
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)
        skvs = fx.supp_kvs(cs.HC_COLD_ROWS, cs.SEED)
        ev6, ev_s = ev_of(fx.q6_dag()), ev_of(fx.supp_dag())
        ev6c = ev_of(fx.q6_dag(), 1 << 16)
        ev_sc = ev_of(fx.supp_dag(), 1 << 16)
        # (name, request, runs, how many of the first are left out: a warm
        # first run pins)
        for name, fn, n, skip in (("warm_q6_unary", lambda: ev6.run(None, cache), 7, 1),
                                  ("cold_q6", lambda: ev6c.run(FixtureScanSource(kvs)), 3, 0),
                                  ("supp_cold", lambda: ev_sc.run(FixtureScanSource(skvs)), 2, 0),
                                  ("supp_warm", lambda: ev_s.run(None, cache), 3, 1)):
            secs = [timed(fn) for _ in range(n)]
            cases[name] = {"request_s": secs[skip:]}
            if name in ("warm_q6_unary", "supp_warm"):
                prof = cs.profile_runs(fn, 1)
                top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:6]
                cases[name]["device_ms"] = [sum(prof["device_ms"].values())]
                cases[name]["top_kernels_ms"] = {k[:80]: v for k, v in top}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] == "dict_ids":
    import numpy as np
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.parallel import mesh as pm

    inputs = []
    # synthetic dict_ids inputs of the grouped mesh's shape: a shard's
    # 131,072 keys (a tenth of them inactive rows, the sentinel) into a
    # dictionary of `cap` slots, `live` of them filled, and the carried
    # dictionary's slots; at 32,768 slots dense keys (consecutive integers)
    # and sparse ones (random 31-bit values)
    for name, cap, live, dense in (("32768", 32768, 16664, True),
                                   ("32768_sparse", 32768, 20000, False),
                                   ("64", 64, 4, False)):
        rng = np.random.default_rng(cap)
        if dense:
            vals = np.arange(1, live + 1, dtype=np.int64)
        else:
            vals = np.sort(rng.choice(1 << 31, live, replace=False)).astype(np.int64)
        new = np.full(cap, fd.SENTINEL, dtype=np.int64)
        new[:live] = vals
        keys = vals[rng.integers(0, live, 1 << 17)]
        keys[rng.random(1 << 17) < 0.1] = fd.SENTINEL
        carried = np.sort(rng.choice(vals, max(1, live * 3 // 4), replace=False))
        old = np.full(cap, fd.SENTINEL, dtype=np.int64)
        old[: len(carried)] = carried
        inputs.append((name, *(torch.from_numpy(a).cuda() for a in (new, keys, old))))
    # the path's own: the first dict_ids call with the carried dictionary of
    # the grouped mesh at 32,768 slots (chip_smoke.py's high_capacity phase:
    # per-supplier statistics, the second super-block)
    a_mesh = fx.supp_arrays(cs.HC_MESH_ROWS, cs.SEED)
    mev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.supp_dag()),
                                     pm.make_mesh([torch.device("cuda", 0)] * cs.MESH_SHARDS,
                                                  groups=1),
                                     cs.MESH_GROUPED_RPS, capacity=cs.HC_MESH_CAP)
    total = mev.total_rows
    mblocks = [(fx.supp_columns(a_mesh, s, s + total, total), total) for s in (0, total)]
    state = mev.step(*cs._block_args(mev, mblocks[0]), mev.init_state())
    seen = cs.capture_dict(fd, lambda: mev.step(*cs._block_args(mev, mblocks[1]), state,
                                                block_base=total))
    inputs.append(("path", *seen["dict_ids"]))
    del a_mesh, mblocks, state
    cases = {}
    for name, new, keys, old in inputs:
        cap, n = new.numel(), keys.numel()
        gids = torch.empty(n, dtype=torch.int32, device="cuda")
        perm = torch.empty(cap, dtype=torch.int32, device="cuda")
        fd.launch_ids(new, keys, gids, old, perm)
        want_ids, want_perm = fd.dict_ids_plain(new.cpu(), keys.cpu(), old.cpu())
        assert torch.equal(gids.cpu(), want_ids) and torch.equal(perm.cpu(), want_perm)
        b_ms, _by = cs.bound(cap * 8 + n * 8 + n * 4 + cap * 12,
                             (n + cap) * max(1, cap.bit_length()))
        for case, fn in (
                (f"ids_{name}", lambda: fd.launch_ids(new, keys, gids, old, perm)),
                (f"ids_{name}_without_old", lambda: fd.launch_ids(new, keys, gids)),
                (f"searchsorted_{name}", lambda: torch.searchsorted(new, keys)),
                (f"searchsorted_with_perm_{name}", lambda: (torch.searchsorted(new, keys),
                                                            torch.searchsorted(new, old)))):
            cases[case] = {"request_s": [cs.cuda_ms(fn, 50) / 1e3 for _ in range(5)],
                           "bound_ms": b_ms}
        cases[f"ids_{name}"]["plain_ms"] = cs.cuda_ms(
            lambda: fd.dict_ids_plain(new, keys, old), 3, warmup=1)
        cases[f"ids_{name}"]["shape"] = {"keys": n, "capacity": cap,
                                         "live": int((new < fd.SENTINEL).sum())}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("group_requests", "mesh_requests"):
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    def ev_of(dag, br=1 << 17, unary=True):
        ev = te.TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cuda")
        if unary:
            ev.route_hint = "unary"
        return ev

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # (name, request, runs, how many of the first are left out: a warm
    # first run pins)
    plan = []
    if sys.argv[1] == "group_requests":
        cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
        kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)
        ev_q1, ev_qty = ev_of(fx.q1_dag()), ev_of(fx.qty_dag())
        ev_cold = ev_of(fx.q1_dag(), 1 << 16, unary=False)
        evs_a = [ev_of(d, unary=False) for _n, d, _o in fx.batch_plans()]
        plan = [("warm_q1_unary", lambda: ev_q1.run(None, cache), 5, 1),
                ("warm_l_quantity", lambda: ev_qty.run(None, cache), 2, 1),
                ("cold_q1", lambda: ev_cold.run(FixtureScanSource(kvs)), 3, 0),
                ("batch_a", lambda: te.run_batch_cached(evs_a, cache), 5, 1)]
    else:
        a_mesh = fx.supp_arrays(cs.HC_MESH_ROWS, cs.SEED)
        mev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.supp_dag()),
                                         pm.make_mesh([torch.device("cuda", 0)] * cs.MESH_SHARDS,
                                                      groups=1),
                                         cs.MESH_GROUPED_RPS, capacity=cs.HC_MESH_CAP)
        total = mev.total_rows
        mblocks = [(fx.supp_columns(a_mesh, s, min(s + total, cs.HC_MESH_ROWS), total),
                    min(total, cs.HC_MESH_ROWS - s)) for s in range(0, cs.HC_MESH_ROWS, total)]
        plan = [("mesh_grouped_32768", lambda: mev.finalize(mev.run_blocks(mblocks)), 9, 1)]
    cases = {}
    for name, fn, n, skip in plan:
        secs = [timed(fn) for _ in range(n)]
        # one more run under torch.profiler: the device's busy ms and the
        # kernels that take most of it
        prof = cs.profile_runs(fn, 1)
        top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:6]
        cases[name] = {"request_s": secs[skip:],
                       "device_ms": [sum(prof["device_ms"].values())],
                       "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("merge_kernels", "merge_requests"):
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import fused_topn as ft
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda", 0)
    cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    ev_t = te.TorchDagEvaluator(dag_to_wire(fx.topn_dag(cs.TOPN_K)), block_rows=1 << 17,
                                device="cuda")
    a_mesh = fx.supp_arrays(cs.HC_MESH_ROWS, cs.SEED)
    mev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.supp_dag()),
                                     pm.make_mesh([dev] * cs.MESH_SHARDS, groups=1),
                                     cs.MESH_GROUPED_RPS, capacity=cs.HC_MESH_CAP)
    total = mev.total_rows
    mblocks = [(fx.supp_columns(a_mesh, s, min(s + total, cs.HC_MESH_ROWS), total),
                min(total, cs.HC_MESH_ROWS - s)) for s in range(0, cs.HC_MESH_ROWS, total)]
    cases = {}
    if sys.argv[1] == "merge_kernels":
        # topn_merge's stages (every level, CUDA events): the warm 100M
        # image's runs, a mesh shard step's 32 tiles and a cold block's 16
        # with a carry, the mesh finalize's 8 runs of one more word
        prog = ev_t.plan.topn_program
        payload = list(range(len(ev_t.plan.schema)))
        pay = ev_t._stacked_device(cache, payload)
        cand = te._pick(pay, payload, ev_t.plan.device_cols)
        runs = torch.empty((ft.n_tiles(prog, cand), prog.n_words, prog.k), dtype=torch.int64,
                           device=dev)
        ft.launch_candidates(prog, cand, runs, 0)
        del pay, cand
        merged = [ft._merge_all(runs[32 * j : 32 * j + 32].contiguous(), None, cuda=True)
                  for j in range(9)]
        carry = merged[8].clone()
        pos = torch.arange(8 * prog.k, device=dev).view(8, 1, prog.k)
        fin = torch.cat([torch.stack(merged[:8]), pos], dim=1).contiguous()
        stages = {"topn_merge_warm_100m": (runs, None, 5),
                  "topn_merge_shard_step": (runs[:32].contiguous(), carry, 20),
                  "topn_merge_cold_block": (runs[:16].contiguous(), carry, 20),
                  "topn_merge_finalize": (fin, None, 20)}
        for name, (r, x, iters) in stages.items():
            if not torch.equal(ft._merge_all(r, x, cuda=True), ft._merge_all(r, x, cuda=False)):
                raise AssertionError(f"{name}: the merge differs from its plain version")
            fa.reset_launches()
            ft._merge_all(r, x, cuda=True)
            launches = fa.LAUNCHES["topn_merge"]
            cases[name] = {"request_s": [cs.cuda_ms(lambda: ft._merge_all(r, x, cuda=True),
                                                    iters) / 1e3 for _ in range(5)],
                           "launches": launches}
        del runs, merged, stages
        # dict_merge's stage at the grouped mesh's shard union (the carried
        # 32,768 slots and a shard's 131,072 keys) and global union (the 8
        # shard dictionaries), the inputs captured from its second super-block
        state = mev.step(*cs._block_args(mev, mblocks[0]), mev.init_state())
        seen = cs.capture_dict(fd, lambda: mev.step(*cs._block_args(mev, mblocks[1]), state,
                                                    block_base=total))
        lib = fd.kernels()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, (d, k, cap) in (("dict_merge_shard_union", seen["dict_union"]),
                                  ("dict_merge_global_union", seen["dict_union_global"])):
            n = (0 if d is None else d.numel()) + k.numel()
            sorted_n = fd.sorted_keys(n)
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            tiles = torch.empty(sorted_n, dtype=torch.int64, device=dev)
            live = torch.empty(sorted_n // fd.SORT_TILE, dtype=torch.int32, device=dev)
            multi = hasattr(fd, "merge_plan")  # the multi-way levels, or the pairwise passes
            rc = lib.du_launch(None if d is None else d.data_ptr(), 0 if d is None else d.numel(),
                               k.data_ptr(), k.numel(), tiles.data_ptr(), flag.data_ptr(),
                               fd.SORT_TILE, fd.SORT_TILE, *((live.data_ptr(),) if multi else ()),
                               stream)
            bufs = [torch.empty_like(tiles) for _ in range(2)]
            if multi:
                calls = [(w, (f, live.data_ptr())) for w, f in fd.merge_plan(n)]
            else:
                calls = [(w, ()) for w in fd.merge_widths(n)]

            def stage():
                src, rcs = tiles, []
                for i, (w, f) in enumerate(calls):
                    rcs.append(lib.dm_launch(src.data_ptr(), sorted_n, w, *f,
                                             bufs[i % 2].data_ptr(), stream))
                    src = bufs[i % 2]
                return src, rcs

            got, rcs = stage()
            if rc != 0 or any(rcs) or not torch.equal(got, torch.sort(tiles).values):
                raise AssertionError(f"{name}: the merge stage failed or left the keys unsorted")
            out = torch.empty(cap, dtype=torch.int64, device=dev)
            cases[name] = {"request_s": [cs.cuda_ms(stage, 20) / 1e3 for _ in range(5)],
                           "launches": len(calls)}
            cases[name.replace("dict_merge", "union")] = {"request_s": [
                cs.cuda_ms(lambda: fd.launch_union(d, k, cap, flag, out), 20) / 1e3
                for _ in range(5)]}
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        a10 = fx.build_arrays(cs.FILTER_ROWS, cs.SEED)
        topn = pm.ShardedTopNEvaluator(dag_to_wire(fx.topn_dag(cs.TOPN_K)),
                                       pm.make_mesh([dev] * cs.MESH_SHARDS), cs.MESH_TOPN_RPS)
        ttotal = topn.total_rows
        tblocks = [(fx.mesh_columns(a10, s, min(s + ttotal, cs.FILTER_ROWS)),
                    min(ttotal, cs.FILTER_ROWS - s)) for s in range(0, cs.FILTER_ROWS, ttotal)]
        # (name, request, runs, how many of the first are left out)
        plan = [("warm_topn_100m", lambda: ev_t.run(None, cache), 8, 1),
                ("mesh_topn_10m", lambda: topn.finalize(topn.run_blocks(tblocks)), 6, 1),
                ("mesh_grouped_32768", lambda: mev.finalize(mev.run_blocks(mblocks)), 7, 1)]
        for name, fn, n, skip in plan:
            secs = [timed(fn) for _ in range(n)]
            prof = cs.profile_runs(fn, 1)
            top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:6]
            cases[name] = {"request_s": secs[skip:],
                           "device_ms": [sum(prof["device_ms"].values())],
                           "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("slice19_kernels", "slice19_requests"):
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda", 0)
    a_mesh = fx.supp_arrays(cs.HC_MESH_ROWS, cs.SEED)
    mev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.supp_dag()),
                                     pm.make_mesh([dev] * cs.MESH_SHARDS, groups=1),
                                     cs.MESH_GROUPED_RPS, capacity=cs.HC_MESH_CAP)
    total = mev.total_rows
    mblocks = [(fx.supp_columns(a_mesh, s, min(s + total, cs.HC_MESH_ROWS), total),
                min(total, cs.HC_MESH_ROWS - s)) for s in range(0, cs.HC_MESH_ROWS, total)]
    skvs = fx.supp_kvs(cs.HC_COLD_ROWS, cs.SEED)
    cases = {}
    if sys.argv[1] == "slice19_kernels":
        def repeat(name, fn, iters, **extra):
            cases[name] = {"request_s": [cs.cuda_ms(fn, iters) / 1e3 for _ in range(5)], **extra}

        def ok(rc):
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        # the compaction (this checkout's: one launch, or the pair count +
        # compact) at the grouped mesh's shard and global unions, the inputs
        # captured from its second super-block, over the merge stage's sorted
        # keys; then the whole union
        state, calls = cs.capture_calls(pm, "_shard_states", lambda: mev.step(
            *cs._block_args(mev, mblocks[0]), mev.init_state()))
        seen = cs.capture_dict(fd, lambda: mev.step(*cs._block_args(mev, mblocks[1]), state,
                                                    block_base=total))
        lib = fd.kernels()
        stream = torch.cuda.current_stream(dev).cuda_stream
        for name, (d, k, cap) in (("compact_shard_union", seen["dict_union"]),
                                  ("compact_global_union", seen["dict_union_global"])):
            srt = fx.sort_route_levels(None if d is None else d.cpu(), k.cpu(), dev)["sorted"]
            sorted_n = srt.numel()
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            out = torch.empty(cap, dtype=torch.int64, device=dev)
            if hasattr(lib, "dc_launch_count"):
                counts = torch.empty(-(-sorted_n // fd.CHUNK), dtype=torch.int32, device=dev)

                def compact():
                    ok(lib.dc_launch_count(srt.data_ptr(), sorted_n, counts.data_ptr(), stream))
                    ok(lib.dc_launch_compact(srt.data_ptr(), sorted_n, counts.data_ptr(),
                                             out.data_ptr(), flag.data_ptr(), cap, stream))
                launches = 2
            else:
                scratch = fd.compact_scratch(dev, sorted_n)

                def compact():
                    ok(lib.dc_launch_compact(srt.data_ptr(), sorted_n, out.data_ptr(),
                                             flag.data_ptr(), cap, scratch.data_ptr(), stream))
                launches = 1
            compact()
            if not torch.equal(out.cpu(), fd.compact_plain(srt.cpu(), cap)[0]):
                raise AssertionError(f"{name}: the compaction differs from its plain version")
            repeat(name, compact, 20, launches=launches, keys=sorted_n)
            repeat(name.replace("compact", "union"),
                   lambda: fd.launch_union(d, k, cap, flag, out), 20)
        # group_wide_combine at its five shapes: a grouped-mesh shard (131,072
        # rows, 32,768 slots), the cold per-supplier block (16,384), the
        # warm query over 100M rows (262,144), the same ids at c_max + 1 and
        # the batch riders past their rows (Q1 by the four flag columns, 512)
        def combine(name, prog, img, cap, iters):
            st = ga.new_partials(prog, img, cap)
            ga.launch_partials(prog, img, cap, st)
            out = ga.init_packed(prog, cap, img.device)
            repeat(name, lambda: ga.launch_combine(prog, img, cap, st, None, out), iters,
                   capacity=cap, x_leaves=len(prog.x_leaves))

        sprog, simages, scap, _lead = calls[0]
        combine("combine_mesh_shard", sprog, simages[0], scap, 50)
        del calls, simages, seen
        ev_cs = te.TorchDagEvaluator(dag_to_wire(fx.supp_dag()), block_rows=1 << 16,
                                     device="cuda")
        _r, ccalls = cs.capture_calls(te, "fused_group_agg",
                                      lambda: ev_cs.run(FixtureScanSource(skvs)))
        cap_c = max(c[2] for c in ccalls)
        prog_c, img_c = next(c[:2] for c in ccalls if c[2] == cap_c)
        combine("combine_cold_block", prog_c, img_c, cap_c, 50)
        del ccalls
        cache = fx.supp_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)

        def ev_of(dag):
            ev = te.TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device="cuda")
            ev.route_hint = "unary"
            return ev

        _r, wcalls = cs.capture_calls(te, "fused_group_agg",
                                      lambda: ev_of(fx.supp_dag()).run(None, cache))
        prog_w, img_w, cap_w = wcalls[0][:3]
        combine("combine_warm_262144", prog_w, img_w, cap_w, 10)
        cross = type(img_w)(img_w.cols, img_w.nulls, img_w.n_valids, img_w.n_blocks,
                            img_w.block_rows, img_w.device, img_w.offsets,
                            img_w.gids % prog_w.c_max)
        combine("combine_ids_at_c_max_plus_1", prog_w, cross, prog_w.c_max + 1, 10)
        del wcalls, img_w, cross
        tasks = te.batch_tasks([ev_of(fx.flags4_dag()), ev_of(fx.flags4_dag(var_pop=True))],
                               cache)[0]
        for i in fb.Batch(tasks).wide:
            combine(f"combine_rider_{i}", tasks[i].prog, tasks[i].img, tasks[i].capacity, 20)
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        ev_c = te.TorchDagEvaluator(dag_to_wire(fx.supp_dag()), block_rows=1 << 16,
                                    device="cuda")
        plan = [("mesh_grouped_32768", lambda: mev.finalize(mev.run_blocks(mblocks)), 7, 1),
                ("cold_supp_1m", lambda: ev_c.run(FixtureScanSource(skvs)), 5, 1)]
        for name, fn, n, skip in plan:
            secs = [timed(fn) for _ in range(n)]
            fa.reset_launches()
            prof = cs.profile_runs(fn, 1)
            top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:8]
            cases[name] = {"request_s": secs[skip:],
                           "device_ms": [sum(prof["device_ms"].values())],
                           "launches": sum(fa.LAUNCHES.values()),
                           "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("slice20_kernels", "slice20_requests"):
    import numpy as np
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import fused_topn as ft
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda", 0)
    n10 = cs.MESH_GROUPED_ROWS
    a10 = fx.build_arrays(n10, cs.SEED)
    q1 = pm.ShardedGroupedEvaluator(dag_to_wire(fx.grouped_dag(("rf", "ls"))),
                                    pm.make_mesh([dev] * cs.MESH_SHARDS, groups=1),
                                    cs.MESH_GROUPED_RPS, capacity=64, key_bits=31)
    qt = q1.total_rows
    qblocks = [(fx.grouped_columns(a10, s, min(s + qt, n10)), min(qt, n10 - s))
               for s in range(0, n10, qt)]
    a_mesh = fx.supp_arrays(cs.HC_MESH_ROWS, cs.SEED)
    mev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.supp_dag()),
                                     pm.make_mesh([dev] * cs.MESH_SHARDS, groups=1),
                                     cs.MESH_GROUPED_RPS, capacity=cs.HC_MESH_CAP)
    mt = mev.total_rows
    mblocks = [(fx.supp_columns(a_mesh, s, min(s + mt, cs.HC_MESH_ROWS), mt),
                min(mt, cs.HC_MESH_ROWS - s)) for s in range(0, cs.HC_MESH_ROWS, mt)]
    topn = pm.ShardedTopNEvaluator(dag_to_wire(fx.topn_dag(cs.TOPN_K)),
                                   pm.make_mesh([dev] * cs.MESH_SHARDS), cs.MESH_TOPN_RPS)
    tt = topn.total_rows
    tblocks = [(fx.mesh_columns(a10, s, min(s + tt, cs.FILTER_ROWS)),
                min(tt, cs.FILTER_ROWS - s)) for s in range(0, cs.FILTER_ROWS, tt)]
    cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    ev_t = te.TorchDagEvaluator(dag_to_wire(fx.topn_dag(cs.TOPN_K)), block_rows=1 << 17,
                                device="cuda")
    cases = {}
    if sys.argv[1] == "slice20_kernels":
        def repeat(name, fn, iters, **extra):
            cases[name] = {"request_s": [cs.cuda_ms(fn, iters) / 1e3 for _ in range(5)], **extra}

        def narrowed(img):
            # the image's int64 lanes bitpacked into the narrowest lane that
            # holds each column's range (its frame the minimum): the same
            # values through program #1's encoded load
            cols, descs, refs = [], [], []
            for c in img.cols:
                lo, hi = (int(c.min()), int(c.max())) if c.dtype == torch.int64 else (0, 1 << 40)
                for dt, npt in ((torch.int8, np.int8), (torch.int16, np.int16),
                                (torch.int32, np.int32), (None, None)):
                    if dt is not None and hi - lo <= torch.iinfo(dt).max - torch.iinfo(dt).min:
                        break
                if dt is None:
                    cols.append(c)
                    descs.append(("plain",))
                    refs.append(0)
                    continue
                base = lo - torch.iinfo(dt).min
                cols.append((c - base).to(dt).contiguous())
                descs.append(("bp", np.dtype(npt).str))
                refs.append(base)
            return type(img)(cols, img.nulls, img.n_valids, img.n_blocks, img.block_rows,
                             img.device, img.offsets, img.gids, tuple(descs), tuple(refs))

        def keys_case(name, prog, img):
            flag = torch.zeros(1, dtype=torch.int32, device=dev)
            out = torch.empty(img.n_blocks * img.block_rows, dtype=torch.int64, device=dev)
            fd.launch_keys(prog, img, out, flag)
            if not torch.equal(out, fd.dict_keys_plain(prog, img)[0]):
                raise AssertionError(f"{name}: dict_keys differs from its plain version")
            repeat(name, lambda: fd.launch_keys(prog, img, out, flag), 50,
                   rows=img.n_blocks * img.block_rows)

        # dict_keys at the grouped mesh's shards: Q1 at 64 slots and the
        # per-supplier query at 32,768, captured from their second
        # super-blocks; Q1's shard again with its lanes bitpacked
        for name, ev, bl, total in (("keys_q1_64", q1, qblocks, qt),
                                    ("keys_supp_32768", mev, mblocks, mt)):
            state = ev.step(*cs._block_args(ev, bl[0]), ev.init_state())
            seen = cs.capture_dict(fd, lambda: ev.step(*cs._block_args(ev, bl[1]), state,
                                                       block_base=total))
            prog, img = seen["dict_keys"]
            keys_case(name, prog, img)
            if name == "keys_q1_64":
                keys_case("keys_q1_64_encoded", prog, narrowed(img))
            del state, seen, img

        def pack_case(name, args):
            prog, run, pay, carry, src_base, out, nxt = args
            ft.launch_pack(*args)
            want = ft.pack_plain(prog, run, pay, carry, src_base)
            if not (torch.equal(out[0], want[0])
                    and torch.equal(out[1].view(torch.int64), want[1].view(torch.int64))
                    and torch.equal(nxt, want[2])):
                raise AssertionError(f"{name}: topn_pack differs from its plain version")
            repeat(name, lambda: ft.launch_pack(*args), 50, k=prog.k,
                   payload=len(prog.pay_f64), carry=carry is not None)

        # topn_pack at the main paths' own inputs: the warm raw TopN over the
        # 100M image (plain, then encoded in place), a cold 65,536-row block
        # with the carry (its second), a mesh shard step with the carry (the
        # second super-block's first shard) and the mesh finalize
        _r, calls = cs.capture_calls(ft, "launch_pack", lambda: ev_t.run(None, cache))
        pack_case("pack_warm_100m", calls[0])
        kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)
        ev_c = te.TorchDagEvaluator(dag_to_wire(fx.topn_dag(cs.TOPN_K)), block_rows=1 << 16,
                                    device="cuda")
        _r, calls = cs.capture_calls(ft, "launch_pack", lambda: ev_c.run(FixtureScanSource(kvs)))
        pack_case("pack_cold_block", calls[1])
        state, calls = cs.capture_calls(ft, "launch_pack", lambda: topn.run_blocks(tblocks))
        pack_case("pack_mesh_shard_step", calls[cs.MESH_SHARDS])
        _r, calls = cs.capture_calls(ft, "launch_pack", lambda: topn.merge(state))
        pack_case("pack_mesh_finalize", calls[0])
        del calls, state
        encoding.encode_blocks(cache)
        _r, calls = cs.capture_calls(ft, "launch_pack", lambda: ev_t.run(None, cache))
        pack_case("pack_warm_100m_encoded", calls[0])
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        plan = [("mesh_grouped_q1_64", lambda: q1.finalize(q1.run_blocks(qblocks)), 7, 1),
                ("mesh_grouped_32768", lambda: mev.finalize(mev.run_blocks(mblocks)), 7, 1),
                ("mesh_topn_10m", lambda: topn.finalize(topn.run_blocks(tblocks)), 7, 1),
                ("warm_topn_100m", lambda: ev_t.run(None, cache), 8, 1)]
        for name, fn, n, skip in plan:
            secs = [timed(fn) for _ in range(n)]
            fa.reset_launches()
            prof = cs.profile_runs(fn, 1)
            cases[name] = {"request_s": secs[skip:],
                           "device_ms": [sum(prof["device_ms"].values())],
                           "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
                           "kernels_ms": {k[:60]: v for k, v in prof["device_ms"].items()}}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("slice21_kernels", "slice21_requests"):
    import numpy as np
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr import fused_zone as fz
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource

    cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)

    def ev_of(dag, unary=False, block_rows=1 << 17):
        ev = te.TorchDagEvaluator(dag_to_wire(dag), block_rows=block_rows, device="cuda")
        if unary:
            ev.route_hint = "unary"
        return ev

    zone_dags = {"q6": fx.q6_dag(), "q1": fx.q1_dag(), "q1_topn": fx.q1_topn_dag()}
    cases = {}
    if sys.argv[1] == "slice21_kernels":
        # zone_fold at the Q6 and Q1 layouts' own inputs (each checkout's
        # chip_smoke.time_zone, after its kernels are held to their plain
        # versions), five CUDA-event times of 50 launches
        for q in ("q6", "q1"):
            ev = ev_of(zone_dags[q])
            out = fx.zone_kernel_outputs(ev, cache)[0]
            cs.check_zone_outputs(out, fx.zone_kernel_outputs(ev, cache)[0], f"zone {q}")
            del out
            times = [cs.time_zone(fz, ev, cache)["zone_fold"] for _ in range(5)]
            cases[f"zone_fold_{q}"] = {"request_s": [t["ms"] / 1e3 for t in times],
                                       **{m: times[0][m] for m in
                                          ("rows_folded", "slots", "plain_ms", "bound_ms")}}

        # fused_group_agg_combine_pack at the grouped pair's captured inputs:
        # a cold Q1 block (65,536 rows, 8 slots), warm Q1 and warm GROUP BY
        # l_quantity (64 slots) on the stacked route; held to its plain
        # version, then five CUDA-event times of 200 launches
        def combine(name, call):
            prog, img, cap = call[:3]
            parts = ga.new_partials(prog, img, cap)
            ga.launch_partials(prog, img, cap, parts)
            out = ga.init_packed(prog, cap, img.device)
            ga.launch_combine(prog, img, cap, parts, None, out)
            cs.compare_packed(prog, out, ga.combine_plain(prog, img, cap, parts), name)
            cases[name] = {"request_s": [cs.cuda_ms(lambda: ga.launch_combine(
                               prog, img, cap, parts, None, out), 200) / 1e3 for _ in range(5)],
                           "capacity": cap, "parts": parts.shape[0],
                           "leaves": len(prog.leaves)}

        for name, ev, source in (
                ("combine_cold_q1_block", ev_of(fx.q1_dag(), block_rows=1 << 16),
                 lambda: FixtureScanSource(kvs)),
                ("combine_warm_q1", ev_of(fx.q1_dag(), unary=True), None),
                ("combine_warm_l_quantity", ev_of(fx.qty_dag(), unary=True), None)):
            _r, calls = cs.capture_calls(te, "fused_group_agg", lambda: ev.run(
                None if source is None else source(), None if source else cache))
            combine(name, calls[1] if len(calls) > 1 else calls[0])
            del calls
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        # the zone-served warm queries (the default route), each pinned by a
        # first run, then seven runs, the host split of three more by step
        # (each checkout's own chip_smoke.zone_request_split) and one profile
        for q, dag in zone_dags.items():
            ev = ev_of(dag)
            ev.run(None, cache)
            secs = [timed(lambda: ev.run(None, cache)) for _ in range(7)]
            if ev.zone_stats.served != 8:
                raise AssertionError(f"{q}: the zone rung served {ev.zone_stats.served} of 8")
            split = cs.zone_request_split(ev, cache, q)
            fa.reset_launches()
            prof = cs.profile_runs(lambda: ev.run(None, cache), 1)
            cases[f"zone_{q}"] = {"request_s": secs, "device_ms": [sum(prof["device_ms"].values())],
                                  "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
                                  "kernels_ms": {k[:60]: v for k, v in prof["device_ms"].items()}}
            for step, ms in split.items():
                cases[f"zone_{q}_split_{step}"] = {"request_s": [ms / 1e3]}
        # cold Q1 over 1M KV rows and warm Q1 on the stacked route
        for name, ev, run, n in (
                ("cold_q1", ev_of(fx.q1_dag(), block_rows=1 << 16),
                 lambda ev: ev.run(FixtureScanSource(kvs)), 3),
                ("warm_q1_unary", ev_of(fx.q1_dag(), unary=True),
                 lambda ev: ev.run(None, cache), 8)):
            run(ev)
            secs = [timed(lambda: run(ev)) for _ in range(n)]
            fa.reset_launches()
            prof = cs.profile_runs(lambda: run(ev), 1)
            cases[name] = {"request_s": secs, "device_ms": [sum(prof["device_ms"].values())],
                           "launches": {k: v for k, v in fa.LAUNCHES.items() if v},
                           "kernels_ms": {k[:60]: v for k, v in prof["device_ms"].items()}}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("zone_kernels", "zone_requests"):
    from tikv_tpu_torch.copr import fused_zone as fz
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
    cache = fx.build_cache(cs.WARM_ROWS, 1 << 17, cs.SEED)
    dags = {"q6": fx.q6_dag(), "q1": fx.q1_dag(), "q1_topn": fx.q1_topn_dag()}
    cases = {}
    if sys.argv[1] == "zone_kernels":
        for q in ("q6", "q1"):
            ev = TorchDagEvaluator(dag_to_wire(dags[q]), block_rows=1 << 17, device="cuda")
            out = fx.zone_kernel_outputs(ev, cache)[0]
            cs.check_zone_outputs(out, fx.zone_kernel_outputs(ev, cache)[0], f"zone {q}")
            del out
            times = [cs.time_zone(fz, ev, cache) for _ in range(5)]
            for k in ("zone_full", "zone_partial", "zone_fold"):
                if times[0][k] is None:
                    continue
                cases[f"{q}_{k}"] = {"request_s": [t[k]["ms"] / 1e3 for t in times],
                                     **{m: times[0][k].get(m) for m in
                                        ("tiles", "rows", "plain_ms", "bound_ms", "library_ms")}}
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t1

        for q, dag in dags.items():
            ev_z = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device="cuda")
            ev_u = TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device="cuda")
            ev_u.route_hint = "unary"
            runs = {"zone": ev_z, "unary": ev_u}
            if ev_z.run(None, cache).encode() != ev_u.run(None, cache).encode():  # both pin
                raise AssertionError(f"{q}: the zone rung differs from route_hint='unary'")
            secs = {k: [] for k in runs}
            for _ in range(7):  # the two routes in turns
                for k, ev in runs.items():
                    secs[k].append(timed(lambda: ev.run(None, cache)))
            if ev_z.zone_stats.served != 8:
                raise AssertionError(f"{q}: the zone rung served {ev_z.zone_stats.served} of 8")
            for k in runs:
                cases[f"{q}_{k}"] = {"request_s": secs[k]}
    print(json.dumps({"cases": cases}))
elif sys.argv[1] in ("fold_split", "fold_requests"):
    from tikv_tpu_torch.copr import fused_mesh as fme
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    kvs = fx.build_kvs(cs.COLD_ROWS, cs.SEED)
    dev = torch.device("cuda", 0)
    meshes = {g: pm.make_mesh([dev] * cs.MESH_SHARDS, groups=g) for g in (1, 2)}
    cases = {}
    if sys.argv[1] == "fold_split":
        spent = {}

        def wrap(mod, name):
            fn = getattr(mod, name)

            def timed_fn(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
                return out
            setattr(mod, name, timed_fn)

        for mod, name in ((pm, "_shard_images"), (pm, "_shard_states"), (pm, "_shard_rows"),
                          (fme, "mesh_merge"), (fme, "mesh_fold")):
            if hasattr(mod, name):
                wrap(mod, name)
        for g in (1, 2):
            runner = pm.MeshServingRunner(dag_to_wire(fx.q1_dag()), meshes[g], rows_per_shard=1024)
            ev, seen = runner.sharded, []
            step = ev.step

            def record(col_data, col_nulls, n_valid, gids, state, block_base=0):
                if len(seen) < 2:
                    seen.append((col_data, col_nulls, n_valid, gids,
                                 [(a.clone(), b.clone()) for a, b in state], block_base))
                return step(col_data, col_nulls, n_valid, gids, state, block_base=block_base)

            ev.step = record
            runner.run(FixtureScanSource(kvs))
            del ev.step
            col_data, col_nulls, n_valid, gids, state0, base = seen[1]
            split = {}
            for _ in range(20):
                state = [(a.clone(), b.clone()) for a, b in state0]
                spent.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ev.step(col_data, col_nulls, n_valid, gids, state, block_base=base)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                for name, sec in spent.items():
                    split.setdefault(name, []).append(sec)
                split.setdefault("other", []).append(t1 - t0 - sum(spent.values()))
                split.setdefault("device_wait", []).append(t2 - t1)
                split.setdefault("step", []).append(t2 - t0)
            for name, secs in split.items():
                cases[f"g{g}_{name}"] = {"request_s": [sorted(secs)[len(secs) // 2]]}
    else:
        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for name, dag, g, rps in (("q1_g1_rps1024", fx.q1_dag(), 1, 1024),
                                  ("q1_g2_rps1024", fx.q1_dag(), 2, 1024),
                                  ("q6_g1_rps1024", fx.q6_dag(), 1, 1024),
                                  ("q1_g1_rps65536", fx.q1_dag(), 1, 1 << 16)):
            runner = pm.MeshServingRunner(dag_to_wire(dag), meshes[g], rows_per_shard=rps)
            runner.run(FixtureScanSource(kvs))
            secs = [timed(lambda: runner.run(FixtureScanSource(kvs))) for _ in range(4)]
            prof = cs.profile_runs(lambda: runner.run(FixtureScanSource(kvs)), 1)
            top = sorted(prof["device_ms"].items(), key=lambda kv: -kv[1])[:6]
            cases[name] = {"request_s": secs, "device_ms": [sum(prof["device_ms"].values())],
                           "top_kernels_ms": {k[:80]: v for k, v in top}}
    print(json.dumps({"cases": cases}))
else:
    getattr(cs, "phase_" + sys.argv[1])(fx, cs.card_line(), torch.device("cuda", 0))
print(json.dumps({"phase_wall_s": time.perf_counter() - t0}))
"""


def run_phase(checkout: Path, phase: str) -> dict:
    """One phase in a fresh process from ``checkout``: its request times by
    case (``cases.*.request_s``) and its wall seconds."""
    proc = subprocess.run([sys.executable, "-c", CHILD, phase], cwd=checkout,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{phase} from {checkout} failed:\n{proc.stderr[-4000:]}")
    out = {"requests_s": {}}
    for line in proc.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        for case, res in obj.get("cases", {}).items():
            if isinstance(res, dict) and "request_s" in res:
                out["requests_s"][case] = res["request_s"]
            if isinstance(res, dict) and "device_ms" in res:
                out["requests_s"][case + "_device"] = [ms / 1e3 for ms in res["device_ms"]]
            if isinstance(res, dict) and "launches" in res:
                out.setdefault("launches", {})[case] = res["launches"]
            if isinstance(res, dict) and "kernels_ms" in res:
                out.setdefault("kernels_ms", {})[case] = res["kernels_ms"]
        if "phase_wall_s" in obj:
            out["phase_wall_s"] = obj["phase_wall_s"]
    return out


def quartiles(t: list[float]) -> dict:
    """The median of ``t``, its first and third quartiles and its count."""
    q = statistics.quantiles(t, n=4) if len(t) > 1 else [t[0]] * 3
    return {"q1": q[0], "median": statistics.median(t), "q3": q[2], "n": len(t)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("--phases", default="mesh_grouped")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    checkouts = {"base": args.base.resolve(), "change": CHANGE_DIR}
    summary = {}
    for phase in args.phases.split(","):
        per = {"base": {}, "change": {}}
        for _ in range(args.rounds):
            for which in ("base", "change", "change", "base"):
                res = run_phase(checkouts[which], phase)
                print(json.dumps({"phase": phase, "checkout": which, **res}), flush=True)
                for case, times in res["requests_s"].items():
                    per[which].setdefault(case, []).extend(times)
        summary[phase] = {which: {case: quartiles(t) for case, t in cases.items()}
                          for which, cases in per.items()}
    print(json.dumps({"request_s_quartiles": summary,
                      "card": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
