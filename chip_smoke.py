#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device  — the card (nvidia-smi name and power limit); exits 1 without CUDA
2. build   — nvcc builds every kernel from ``tikv_tpu_torch/csrc``; ptxas report
3. kernels — each kernel against its plain PyTorch version on the same seeded
             inputs, at a cold block (65,536 rows) and at the warm stacked
             shape (the grouped cases at 128 of its 763 blocks): int leaves
             equal, f64 leaves to rel 1e-12, two runs
             bit-identical; the grouped kernels with ids from two
             dictionary-code columns with NULLs, 60 host ids (all ten
             aggregates), 300 host ids (integer leaves) and 3,000 host ids
             (all ten, NaN and +-inf and +-0.0 among the REAL values): the
             last two past the shared rows, on the wide route
4. cold    — TPC-H Q6 as a wire-dict request over 1,000,000 rows of lineitem
             KV bytes (block_rows 65,536), checked against a numpy oracle
5. warm    — the same request, and the count/sum/min/max shape, over a
             resident 100,000,000-row image (block_rows 131,072), checked the
             same way; steps down to no less than 10,000,000 rows if the
             host's or the card's memory cannot hold it, and says so
6. cold    — TPC-H Q1 (GROUP BY returnflag, linestatus) over the same
             1,000,000 KV rows, two runs, each equal to its numpy oracle
7. warm    — Q1 over the resident image (group ids from the dictionary
             codes on the card): the first run with the pin, then 5 runs;
             and GROUP BY l_quantity (host group ids, 50 groups), twice
8. scan    — BASELINE configs 1-2: the scan (all 7 columns, Limit 100,000)
             and the 3-predicate filter (Limit 100,000) cold over the same
             1,000,000 KV rows, the filter and a selective variant (shipdate
             < 8410, no Limit) warm over a resident 10,000,000-row image,
             each equal to its numpy oracle
9. topn    — the raw TopN of bench._topn_endpoint (5 columns, shipdate <=
             10500, ORDER BY price DESC, quantity, K = 100) cold over the 1M
             KV rows and warm over the 100M image; then BASELINE config 4,
             Q1 + TopN on the group keys (LIMIT 4: 2 of 6 groups cut), cold
             and warm; each equal to its numpy oracle
10. timings — cold/warm rows/s (host clock around synchronized work), each
             kernel's ms per launch (CUDA events), its bound, the plain
             version's time and a one-call PyTorch yardstick where one exists;
             the mask and top-K kernels held to their plain versions on the
             main path's own inputs
11. profile — device time by kernel and the device's busy share of the
             wall time (torch.profiler), over one cold and three warm runs of
             Q6 and of Q1, and runs of the warm filters and the raw TopN
12. encoded — the same 100M and 10M images encoded in place as a filled
             region image is (copr/encoding.py: bitpacked lanes, narrowed
             dictionary codes), after their plain pins are released: the
             pinned bytes of the whole row and of Q6's columns, plain against
             encoded (at most 30%); every kernel over the encoded image equal
             to its plain version and to its own output over the plain image;
             warm Q6, Q1, the selective filter, config 2 with its Limit, the
             raw TopN and Q1 + TopN against their oracles; a date-sorted
             100M-row image (l_shipdate RLE, zone maps prune) with Q6, Q1 and
             the raw TopN against oracles from the permuted draws, with the
             blocks examined and pruned; each kernel's ms over the encoded
             image and decode_column (program #1 alone) against its bound,
             its plain version and the torch yardsticks; the zone rung's Q1
             layout built over the encoded image (the host gathers decode
             the encoded columns, then drop the decodes) and its Q6 over
             the date-sorted image

Phases 5-12 pin their evaluators to the stacked kernels (``route_hint =
"unary"``).  Between phases 11 and 12, phase ``zone`` runs the default
route, the zone rung, over the plain 100M-row image: the layouts' host
build seconds and pinned bytes; warm Q6, Q1 and Q1 + TopN against their
oracles and byte for byte against the unary route, with the tiles full,
partial and empty and both routes' s/query; ``zone_full``, ``zone_partial``
and ``zone_fold`` against their plain versions on the Q6 and Q1 layouts and
on a synthetic one (NULLs in the key and values, negative values, var_pop,
the null-safe ops, 256- and 1,001-row tiles), ``zone_fold`` also at its
edges (``fixtures.ZONE_FOLD_CASES``), then timed at Q1's and Q6's layouts;
every instance of the tile kernels and the fold with its registers and 0
local bytes; one warm Q6 and one Q1 request split by host step
(``zone_request_split``).

Between phases ``zone`` and 12, phase ``batch`` serves batches of warm
aggregations (programs #10 and #11, ``csrc/fused_batch.cu``): over the plain
100M-row image, batch B (seven riders, every one zone-eligible: the zone
rung serves them all, no batch kernel launches) and batch A (eight riders:
Q6, count/sum/min/max, Q1, Q1 + TopN, GROUP BY l_returnflag, Q1 with
shipdate <= 9500, a two-column Q6 variant and bit_xor(l_quantity) GROUP BY
l_linestatus, which the rung declines, so all eight run on the batch
kernels); then Q1 and Q6 each as one batch over 64 region images of 6 to
10 blocks (two with a returnflag dictionary of two), over 8 encoded region
images, and over 7 of those with one plain image (decoded lanes, the
``enc_mismatch`` decline counted).  Every response equals its numpy oracle
and, byte for byte, the same request served alone on the stacked unary
route, whose times are summed beside the batch's; both kernels are held to
their plain versions (with a rider of every leaf kind) and timed.

Between phases ``batch`` and 12, phase ``mesh`` drives the mesh path
(programs #16, #18, #19 and #20, ``tikv_tpu_torch/parallel/mesh.py``, the
cross-shard kernels ``mesh_fold`` and ``mesh_merge`` of
``csrc/fused_mesh.cu``) on eight shards of the one card,
``make_mesh(["cuda:0"] * 8, groups)``: ``mesh_merge`` against its plain
version on synthetic states (every mergeable leaf kind, NaN, +-0.0, +-inf,
int64 wrap; 8 and 64 parts, 16 and 331 slots); cold Q6 and Q1 over the
1,000,000 KV rows through ``MeshServingRunner`` at 1,024 and 65,536 rows
per shard, groups 1 and 2 (the grouped combine launched 0 times: the
shards' raw rows fold in ``mesh_fold``); warm Q1 and Q6 through
``launch_xregion_sharded`` over phase ``batch``'s 64 region images, its 8
encoded ones and the 100M image alone (spread block by block); the raw
TopN (K = 100) over 10M rows through ``ShardedTopNEvaluator`` at 131,072
rows per shard.  Every answer equals its numpy oracle and, byte for byte,
the single-device route's, whose times stand beside; then ``mesh_fold``
at the path's own inputs (cold Q1's second super-block at G = 1 and 2 and
1,024 rows a shard, and at 65,536) against its plain version and, every
word, against the combines and ``mesh_merge`` it replaces, timed beside
them; one cold super-block split by host step (``mesh_step_split``);
``mesh_merge`` at the regions' inputs, the busiest device's batch kernels
and one shard's top-K kernels against their plain versions and timed; the
slab bytes pinned.

After phase 12, phase ``join`` drives the join rung (programs #14 and #15,
``csrc/fused_join.cu``) through ``copr/torch_join.serve``: the join event of
``bench._op_join`` cut to half its depth (a probe region of 500,000 rows
``(id, key, pay)`` against a build region of 125,000 rows keyed from half
the probe keys'
pool, encoded images, block_rows 65,536), on the rank and the hash path
over dictionary keys and on the hash path over int keys, then with
Selection, Projection and Limit(100,000) over columns of both sides; each
serve's pairs (``torch_join.join_pairs``) and response bytes equal the
numpy oracle's, with the host seconds of each step; both kernels equal
their plain versions at the phase's shape, on a seeded case with NULLs,
misses, extreme keys and colliding slots, and on a 32M-row probe lane
against 8M keys of 4 rows, then are timed at both shapes beside their
bounds, their plain versions and ``torch.searchsorted``.

After phase ``join``, phase ``mesh_grouped`` drives program #17, the group
dictionary built on the card (``ShardedGroupedEvaluator``,
``csrc/fused_dict.cu``: ``dict_keys``, ``dict_union``, ``dict_ids``; the
carry remap in ``mesh_fold``), on eight shards of the card over
10,000,000 lineitem rows (super-blocks of 8 x 131,072 rows, the last one
partial), each case twice: Q1's grouped shape (GROUP BY l_returnflag,
l_linestatus as INT codes) at G = 1 and 2, GROUP BY l_quantity,
(l_quantity, l_linestatus) at 128 slots, l_quantity at 8 slots (the
capacity flag) and at 5 bits a key (the range flag); each answer equal to
its numpy oracle (or its flag), the two runs bit for bit, the first
1,048,576 rows equal to the same evaluator on eight CPU shards; each
dictionary kernel and ``mesh_fold`` with the remap at the path's inputs
equal to its plain version (the fold also to the combines and
``mesh_merge`` it replaces, bit for bit), timed beside ``torch.unique`` and
``torch.searchsorted``.

After phase ``mesh_grouped``, phase ``high_capacity`` drives group slots
past the grouped pair's shared-memory rows (its wide route,
``group_wide_partials`` and ``group_wide_combine`` of ``csrc/fused_agg.cu``)
and a device dictionary past 8,192 slots (the union's sort route,
``dict_merge`` and ``dict_compact``, one launch each level and one
compaction, of ``csrc/fused_dict.cu``) with per-supplier statistics over TPC-H Q15's
window (``fixtures.supp_dag``, GROUP BY l_suppkey, var_pop's f64 sum of
squares): cold over 1,000,000 KV rows (10,000 suppliers), the DOUBLE price's
first/min/max/sum/var_pop cold, warm over the 100M image (about 166,000
suppliers, 262,144 slots, host ids), a same-region batch with Q1 grouped by
the four flag columns (480 coded slots; integer and f64 riders) beside
batch A's eight, against the same requests one by one, and
``ShardedGroupedEvaluator`` at 32,768 slots over 10,000,000 rows on eight
shards of the card; each answer equal to its numpy oracle, the reruns bit
for bit; the new kernels against their plain versions at the path's inputs
(the wide state word for word, its combine bit for bit; the batch kernels
over the path's own ten-rider batch) and timed beside
the same image on the shared rows at ``c_max`` slots and the same ids on
the wide route at ``c_max + 1``, ``index_add_`` and ``scatter_reduce_``,
``torch.sort`` and ``torch.unique_consecutive``; the wide route also at a
shard of the grouped mesh (131,072 rows at 32,768 slots) and at the
batch's riders past their rows.  Phase
``mesh_grouped`` also times the grouped pair alone at a shard's shape
(131,072 rows, Q1 at 64 slots), phase ``mesh`` at the cold mesh's 1,024-row
shards.

After phase ``high_capacity``, phase ``write_path`` drives the region write
path (``copr/region_cache.py``; the image patch ``patch_stacked`` of
``csrc/fused_patch.cu``, ``cache.scatter_update``): one 96 MiB region (TiKV
v5.1's ``coprocessor.region-split-size``), 1,000,000 date-ordered lineitem
rows written as MVCC versions into the port's engine; its plain image built
cold from those versions, then warm Q6 and Q1 (zone route and
``route_hint="unary"``) and config 2's filter against their oracles; four
committed batches, each followed by the same requests: 1,000 and 10,000 rows
updated in place through ``scan_delta`` (rows moving into Q6's window inside
blocks whose zone maps excluded them, a new l_returnflag value), 10,000 rows
through ``notify_region_write``, 5,000 inserts with 5,000 deletes; after
each the outcome string, the answers, one patch launch per stacked pin and
every pin equal to a rebuilt pin.  Then the encoded image once (a delta
drops its encoded pins; the next request pins them again), the kernel
against its plain version bit for bit on the region's Q1 pin, and its times
there and on config 2's 10M image (10,000 scattered rows into Q1's six lanes)
beside ``index_put_`` per lane and a full re-pin.

Phase 3 also holds the mask and top-K kernels to their plain versions on
seeded synthetic cases (the top-K at K = 100 and K = 2048, nullable INT and
REAL keys with ties, -0.0 and +-inf, warm and with the carry over 16 cold
blocks).  Then the card's line, the kernels line and, last, the ok line.
The launch counts in the kernels line are those of the main paths only: Q6
(phases 4-5) for the capacity-1 kernels, Q1 (phases 6-7) for the grouped
ones, configs 1-2 (phase 8) for the mask, the raw TopN (phase 9) for the
top-K kernels, phase ``zone`` for the zone-tile kernels, phase ``batch``
for the batch kernels, phase ``join`` for the join probes, phase ``mesh``
for ``mesh_fold`` and ``mesh_merge`` (each reused kernel's
``mesh_launches`` too, the grouped combine's 0), phase
``mesh_grouped`` for the dictionary kernels (``mesh_grouped_launches`` of
the reused ones), phase ``high_capacity`` for the wide route and the sort
route (``high_capacity_launches`` of the reused ones), phase ``write_path``
for the image patch, each counted from 0 just before its path and read just
after; each entry's ``encoded`` gives
its launches on the encoded path of phase 12 (counted from 0 just before
it).  Program #1 runs inside every
kernel that reads the image (the column load of ``csrc/fa_walk.cuh``): its
entry, ``decode_column``, counts the launches of those kernels on the
encoded path; the export itself is launched by the checks only
(``launches_standalone``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# no int64 rate is published: the f32 CUDA-core rate (NVIDIA data sheet)
# stands for the kernels' int64/f64 scalar work
OPS_PER_S = 67e12
REL_TOL = 1e-12
SEED = 0
COLD_ROWS = 1_000_000  # bench.py's BENCH_COLD_ROWS default
WARM_ROWS = 100_000_000  # BASELINE config 4
WARM_ROWS_FLOOR = 10_000_000  # BASELINE config 3
FILTER_ROWS = 10_000_000  # BASELINE config 2
SCAN_LIMIT = 100_000  # bench._filter_dag's Limit
TOPN_K = 100  # bench._topn_endpoint's TopN
ORACLE_THREADS = 4  # numpy oracles over 100M draws computed at once


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also says when it ended (``t_s``,
    seconds since the script started).  Group keys are bytes: printed as
    text."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - T_START)
    print(json.dumps(obj, default=lambda b: b.decode("latin-1")), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` from CUDA events, after warm-up.  The
    stream first sleeps on the card while the host enqueues the calls, so
    the launches run back to back and host overhead is not timed."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def isolated_ms(fn, iters: int = 10) -> float:
    """Median ms of ``fn`` timed alone: CUDA events around one call, the
    card idle before it (launch latency included)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return sorted(out)[iters // 2]


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least ms the card could take: the larger of bytes over the HBM
    rate and operations over the compute rate, and which of the two."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


MAIN_PATH_KERNELS = ("fused_agg_partials", "fused_agg_combine_pack", "fused_group_agg_partials",
                     "fused_group_agg_combine_pack", "fused_mask", "topn_candidates",
                     "topn_merge", "topn_pack")
# the kernels that read the image, each through the column load of program #1
IMAGE_READERS = ("fused_agg_partials", "fused_group_agg_partials", "fused_mask",
                 "topn_candidates", "topn_pack")


def image_bytes(img, rows: int) -> int:
    """Bytes a kernel must read of ``img``'s columns for ``rows`` valid
    rows: a row-shaped payload or null mask at its lane width per row (1, 2,
    4 or 8 bytes), an RLE column's runs (values, ends, run-shaped nulls)
    whole."""
    total = 0
    for c, nl in zip(img.cols, img.nulls):
        if isinstance(c, tuple):
            total += sum(t.numel() * t.element_size() for t in c)
            if nl is not None:
                total += nl.numel() if nl.shape[-1] != img.block_rows else rows
        else:
            total += rows * c.element_size() + (rows if nl is not None else 0)
    return total


def mem_available_bytes() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("MemAvailable missing from /proc/meminfo")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def compare_packed(prog, got, want, what: str) -> float:
    """Int rows equal, f64 rows to REL_TOL; returns the max abs error."""
    gi, gf = (t.cpu() for t in got)
    wi, wf = (t.cpu() for t in want)
    if not torch.equal(gi, wi):
        raise AssertionError(f"{what}: int leaves differ\n{gi.flatten()}\n{wi.flatten()}")
    return compare_f64(gf, wf, what)


def compare_f64(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.numel() == 0:
        return 0.0
    same_nan = torch.isnan(got) == torch.isnan(want)
    exact = (got == want) | torch.isnan(want)  # NaN equal to NaN
    close = (got - want).abs() <= REL_TOL * want.abs()
    if not bool((same_nan & (exact | close)).all()):
        raise AssertionError(f"{what}: f64 leaves differ beyond rel {REL_TOL}\n{got}\n{want}")
    diff = torch.where(exact, torch.zeros_like(got), (got - want).abs())
    return float(diff.max())


def check_partials(prog, got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Scratch rows of fused_agg_partials against partials_plain."""
    err = 0.0
    for k, leaf in enumerate(prog.aggs):
        if not torch.equal(got[:, k, 0], want[:, k, 0]):
            raise AssertionError(f"{what}: partial counts of aggregate {k} differ")
        if leaf.kind == 0:
            continue
        if leaf.is_f64:
            err = max(err, compare_f64(got[:, k, 1].view(torch.float64),
                                       want[:, k, 1].view(torch.float64), f"{what} agg {k}"))
        elif not torch.equal(got[:, k, 1], want[:, k, 1]):
            raise AssertionError(f"{what}: partial values of aggregate {k} differ")
    return err


def phase_kernels(fa, fx, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    errs = {"fused_agg_partials": 0.0, "fused_agg_combine_pack": 0.0}
    for n_blocks, block_rows, name in ((1, 1 << 16, "cold_block"), (763, 1 << 17, "warm_stacked")):
        prog, img = fx.synthetic_case(n_blocks, block_rows, gen, device)
        got = fa.fused_agg(prog, img)
        again = fa.fused_agg(prog, img)
        want = fa.fused_agg_plain(prog, img)
        if not (torch.equal(got[0], again[0])
                and torch.equal(got[1].view(torch.int64), again[1].view(torch.int64))):
            raise AssertionError(f"{name}: two kernel runs are not bit-identical")
        err_e2e = compare_packed(prog, got, want, f"{name} end to end")
        scratch = fa.new_scratch(prog, img)
        fa.launch_partials(prog, img, scratch)
        err_p = check_partials(prog, scratch, fa.partials_plain(prog, img), f"{name} partials")
        out = (torch.empty_like(got[0]), torch.empty_like(got[1]))
        fa.launch_combine(prog, scratch, None, out)
        err_c = compare_packed(prog, out, fa.combine_plain(prog, scratch), f"{name} combine")
        # a carried state: fold the image into the kernel's own result again
        carry = (got[0].clone(), got[1].clone())
        fa.fused_agg(prog, img, carry)
        want2 = fa.fused_agg_plain(prog, img, (want[0].clone(), want[1].clone()))
        err_e2e = max(err_e2e, compare_packed(prog, carry, want2, f"{name} with carry"))
        errs["fused_agg_partials"] = max(errs["fused_agg_partials"], err_p)
        errs["fused_agg_combine_pack"] = max(errs["fused_agg_combine_pack"], err_c)
        emit({"phase": "kernels", "case": name, "n_blocks": n_blocks, "block_rows": block_rows,
              "rows": int(img.n_valids if isinstance(img.n_valids, int) else img.n_valids.sum()),
              "int_leaves_equal": True, "f64_rel_tol": REL_TOL, "bit_identical_reruns": True,
              "max_abs_err_end_to_end": err_e2e, "max_abs_err_partials": err_p,
              "max_abs_err_combine": err_c})
        del prog, img, got, again, want, scratch, out, carry, want2
        torch.cuda.empty_cache()
    # the partials on the tile walk at their edges, each instance: ragged
    # tiles, encoded lanes, NaN and +-inf, blocks zone maps pruned
    for name, (prog, img) in fx.agg_edge_cases(device).items():
        chk = fx.agg_partials_check(prog, img)
        errs["fused_agg_partials"] = max(errs["fused_agg_partials"], chk["max_abs_err"])
        emit({"phase": "kernels", "case": f"agg_edge_{name}", "int_leaves_equal": True,
              "f64_rel_tol": REL_TOL, "bit_identical_reruns": True, **chk})
    no_local_memory("fused_agg_partials", [fa.partials_attributes(d) for d in (2, 4, 8)])
    return errs


def no_local_memory(name: str, attrs: list) -> list:
    """Raise unless every instance's ``cudaFuncGetAttributes`` shows 0
    local (spilled) bytes; return the attributes."""
    for a in attrs:
        if a["localSizeBytes"] != 0:
            raise AssertionError(f"{name} spills to local memory: {a}")
    return attrs


def time_agg_partials(fa, prog, img, iters: int) -> dict:
    """``fused_agg_partials`` at one image: held to its plain version
    (counts and integers exactly, f64 to REL_TOL), then CUDA-event ms per
    launch, the plain version's ms and the bound from the image's valid
    rows: the shipped columns' bytes and n_valids read once, the partials
    written once; one operation per bytecode word per row.  The instance's
    registers and local bytes beside them."""
    scratch = fa.new_scratch(prog, img)
    ms = cuda_ms(lambda: fa.launch_partials(prog, img, scratch), iters)
    err = check_partials(prog, scratch, fa.partials_plain(prog, img), "timed partials")
    plain_ms = cuda_ms(lambda: fa.partials_plain(prog, img), 3, warmup=1)
    nv = img.n_valids
    rows = int(nv if isinstance(nv, int) else nv.sum())
    b_ms, by = bound(image_bytes(img, rows) + img.n_blocks * 8 + scratch.numel() * 8,
                     rows * len(prog.code))
    attrs = no_local_memory("fused_agg_partials",
                            [fa.partials_attributes(fa.partials_slots(prog))])[0]
    return {"rows": rows, "grid": scratch.shape[0], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "max_abs_err": err, "attributes": attrs}


def check_group_partials(prog, got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Scratch of the shared-memory fused_group_agg_partials against
    partials_plain: int leaves equal, f64 leaves to REL_TOL."""
    err = 0.0
    for l, leaf in enumerate(prog.leaves):
        if leaf.is_f64:
            err = max(err, compare_f64(got[:, l].view(torch.float64),
                                       want[:, l].view(torch.float64), f"{what} leaf {l}"))
        elif not torch.equal(got[:, l], want[:, l]):
            raise AssertionError(f"{what}: partials of leaf {l} differ")
    return err


def bit_identical(a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int64), b[1].view(torch.int64))


def phase_group_kernels(ga, fx, device) -> dict:
    """The grouped kernels against their plain versions on the seeded
    grouped cases, at a cold block and at 128 blocks of the warm stacked
    shape (the timings phase holds them to their plain versions on the warm
    main path's own 763-block image)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    errs = dict.fromkeys(("fused_group_agg_partials", "fused_group_agg_combine_pack")
                         + WIDE_KERNELS, 0.0)
    for n_blocks, block_rows, shape in ((1, 1 << 16, "cold_block"), (128, 1 << 17, "warm_stacked")):
        for kind in fx.GROUP_CASES:
            prog, img, cap = fx.synthetic_group_case(kind, n_blocks, block_rows, gen, device)
            got = ga.fused_group_agg(prog, img, cap)
            if not bit_identical(got, ga.fused_group_agg(prog, img, cap)):
                raise AssertionError(f"{shape} {kind}: two kernel runs are not bit-identical")
            want = ga.fused_group_agg_plain(prog, img, cap)
            err_e2e = compare_packed(prog, got, want, f"{shape} {kind} end to end")
            carry = (got[0].clone(), got[1].clone())
            ga.fused_group_agg(prog, img, cap, carry)
            want2 = ga.fused_group_agg_plain(prog, img, cap, (want[0].clone(), want[1].clone()))
            err_e2e = max(err_e2e, compare_packed(prog, carry, want2, f"{shape} {kind} carried"))
            err_p = err_c = 0.0
            shared = prog.shared_rows(cap)
            if shared:
                parts = ga.new_partials(prog, img, cap)
                ga.launch_partials(prog, img, cap, parts)
                err_p = check_group_partials(
                    prog, parts, ga.partials_plain(prog, img, cap, ga.launch_grid(img), ga.ROWS),
                    f"{shape} {kind} partials")
                out = (torch.empty_like(got[0]), torch.empty_like(got[1]))
                ga.launch_combine(prog, img, cap, parts, None, out)
                err_c = compare_packed(prog, out, ga.combine_plain(prog, img, cap, parts),
                                       f"{shape} {kind} combine")
                names = ("fused_group_agg_partials", "fused_group_agg_combine_pack")
            else:
                # the wide route: its state word for word, its combine bit
                # for bit against their plain versions, two runs identical
                err_p = fx.wide_kernel_check(prog, img, cap)["pair"]
                parts = out = None
                names = WIDE_KERNELS
            errs[names[0]] = max(errs.get(names[0], 0.0), err_p, err_e2e)
            errs[names[1]] = max(errs.get(names[1], 0.0), err_c)
            nv = img.n_valids
            emit({"phase": "kernels", "case": f"group_{kind}_{shape}", "n_blocks": n_blocks,
                  "block_rows": block_rows, "rows": int(nv if isinstance(nv, int) else nv.sum()),
                  "capacity": cap, "leaves": len(prog.leaves), "c_max": prog.c_max,
                  "partials": "shared" if shared else "wide",
                  "int_leaves_equal": True, "f64_rel_tol": REL_TOL, "bit_identical_reruns": True,
                  "max_abs_err_end_to_end": err_e2e, "max_abs_err_partials": err_p,
                  "max_abs_err_combine": err_c})
            del prog, img, got, want, carry, want2, parts, out
            torch.cuda.empty_cache()
    # the shared-memory partials at their edges: ids past C, one slot, short
    # tiles and n_valid cutting one, every leaf kind, an encoded image
    for name, (prog, img, cap) in fx.group_edge_cases(device).items():
        chk = fx.group_partials_check(prog, img, cap)
        errs["fused_group_agg_partials"] = max(errs["fused_group_agg_partials"],
                                               chk["max_abs_err"])
        emit({"phase": "kernels", "case": f"group_edge_{name}", "capacity": cap,
              "leaves": len(prog.leaves), "int_leaves_equal": True, "f64_rel_tol": REL_TOL,
              "bit_identical_reruns": True, **chk})
    # the wide route on the tile walk at its edges, each instance: ragged
    # tiles with ids past C, the tracker and first, coded ids over encoded
    # lanes, pruned blocks, one hot slot (word for word)
    for name, (prog, img, cap) in fx.wide_edge_cases(device).items():
        chk = fx.wide_kernel_check(prog, img, cap)
        errs["group_wide_partials"] = max(errs["group_wide_partials"], chk["pair"])
        emit({"phase": "kernels", "case": f"wide_edge_{name}", "capacity": cap,
              "leaves": len(prog.leaves), "slots": ga.partials_slots(prog),
              "state_words_equal": True, "combine_bit_identical": True,
              "f64_rel_tol": REL_TOL, "bit_identical_reruns": True, **chk})
    no_local_memory("group_wide_partials",
                    [ga.partials_attributes(d, wide=True) for d in (2, 4, 8)])
    # the combine, a warp a cell: each instance (first's walk of 2, 4 or 8
    # stack slots) in registers
    emit({"phase": "kernels", "case": "combine_instances",
          "attributes": no_local_memory("fused_group_agg_combine_pack",
                                        [ga.combine_attributes(d) for d in (2, 4, 8)])})
    return errs


def same_state(a, b) -> bool:
    """Two top-K states ``(ints, flts, run)`` bit for bit."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int64), b[1].view(torch.int64))
            and torch.equal(a[2], b[2]))


def block_of(img, b: int):
    """Block ``b`` of a stacked image as a one-block image."""
    from tikv_tpu_torch.copr.fused_agg import Image

    return Image([c[b : b + 1] for c in img.cols],
                 [None if m is None else m[b : b + 1] for m in img.nulls],
                 int(img.n_valids[b]), 1, img.block_rows, img.device)


def check_topn_kernels(ft, fx, prog, cand, pay, what: str) -> None:
    """Each top-K kernel against its plain version on one image (warm: one
    step, ``src_base`` 0), all words and packed leaves exactly, and a rerun
    bit-identical."""
    runs = torch.empty((ft.n_tiles(prog, cand), prog.n_words, prog.k), dtype=torch.int64,
                       device=cand.device)
    ft.launch_candidates(prog, cand, runs, 0)
    want_runs = ft.candidates_plain(prog, cand, 0)
    if not torch.equal(runs, want_runs):
        raise AssertionError(f"{what}: topn_candidates differs from its plain version")
    fx.topn_merge_check(runs, None, (ft.merge_fans(runs.shape[0], prog.n_words, prog.k)
                                     or [2])[0])
    del runs, want_runs
    got = ft.topn_step(prog, cand, pay)
    if not same_state(got, ft.topn_step(prog, cand, pay)):
        raise AssertionError(f"{what}: two top-K runs are not bit-identical")
    plain = plain_topn_step(ft, prog, cand, pay, None, 0)
    if not same_state(got, plain):
        raise AssertionError(f"{what}: topn_pack (or the chain) differs from its plain version")


def phase_scan_kernels(fm, ft, fx, device) -> None:
    """The mask and the top-K kernels against their plain versions on seeded
    synthetic cases: the mask at a cold block and at config 2's 10M rows,
    and at its edges (``fx.mask_edge_cases``: every stack instance);
    the top-K at K = 100 and K = 2048 over 16 blocks of 65,536 rows, warm
    (one step) and cold (one step per block, the carry on the card), and
    ``topn_pack`` at its edges (``fx.pack_edge_case``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    for n_blocks, block_rows in ((1, 1 << 16), (77, 1 << 17)):
        prog, img = fx.synthetic_mask_case(n_blocks, block_rows, gen, device)
        got = fm.fused_mask(prog, img)
        if not (torch.equal(got, fm.fused_mask_plain(prog, img))
                and torch.equal(got, fm.fused_mask(prog, img))):
            raise AssertionError(f"fused_mask at {n_blocks} x {block_rows} differs or reruns differ")
        emit({"phase": "kernels", "case": f"mask_{n_blocks}x{block_rows}",
              "rows": int(img.n_valids if isinstance(img.n_valids, int) else img.n_valids.sum()),
              "kept": int(got.sum()), "equal": True, "bit_identical_reruns": True})
        del prog, img, got
    for name, (prog, img) in fx.mask_edge_cases(device, SEED).items():
        want = fm.fused_mask_plain(prog, img)
        outs = [torch.empty_like(want) for _ in range(2)]
        for out in outs:
            fm.launch_mask(prog, img, out)
        if not (torch.equal(outs[0], want) and torch.equal(outs[1], want)):
            raise AssertionError(f"fused_mask edge case {name} differs or reruns differ")
        attrs = fm.mask_attributes(prog, img)
        if attrs["localSizeBytes"] != 0:
            raise AssertionError(f"fused_mask spills to local memory at {name}: {attrs}")
        emit({"phase": "kernels", "case": f"mask_edge_{name}", "blocks": img.n_blocks,
              "block_rows": img.block_rows, "attributes": attrs, "kept": int(want.sum()),
              "equal": True, "bit_identical_reruns": True})
    for name in fx.PACK_EDGE_CASES:
        chk = fx.pack_kernel_check(*fx.pack_edge_case(name, device, SEED))
        emit({"phase": "kernels", "case": f"pack_edge_{name}", "k": fx.PACK_EDGE_CASES[name][0],
              "payload_columns": fx.PACK_EDGE_CASES[name][1], "equal": True,
              "bit_identical_reruns": True, **chk})
    for k in (TOPN_K, 2048):
        prog, cand, pay = fx.synthetic_topn_case(16, 1 << 16, k, gen, device)
        check_topn_kernels(ft, fx, prog, cand, pay, f"synthetic K={k}")
        state = plain = None
        for b in range(16):
            blk = block_of(cand, b)
            state = ft.topn_step(prog, blk, blk, state, src_base=k)
            plain = plain_topn_step(ft, prog, blk, blk, plain, k)
            if not same_state(state, plain):
                raise AssertionError(f"synthetic K={k}: cold step {b} differs from the plain one")
        n_out = int((state[0][0] == 0).sum())
        emit({"phase": "kernels", "case": f"topn_k{k}_16x65536", "rows": int(cand.n_valids.sum()),
              "tile": prog.tile, "words": prog.n_words, "active_out": n_out, "equal": True,
              "cold_carry_blocks": 16, "bit_identical_reruns": True})
        del prog, cand, pay, state, plain
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 12: encoded images
# ---------------------------------------------------------------------------

def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def check_encoded_outputs(got: dict, plain_image: dict) -> None:
    """``fixtures.warm_kernel_outputs`` over the encoded image: each kernel
    equals its plain version there, and its own output over the plain image
    of the same rows, bit for bit."""
    for name, (kernel, plain) in got.items():
        for g, p_, w in zip(kernel, plain, plain_image[name][0]):
            if not torch.equal(bits(g), bits(p_)):
                raise AssertionError(f"{name} on the encoded image differs from its plain version")
            if not torch.equal(bits(g), bits(w)):
                raise AssertionError(f"{name}: encoded image and plain image give other outputs")


def pinned_bytes(cache, pins: dict) -> dict:
    """``cache.device_nbytes()`` with one image pinned at a time: for each
    name, an evaluator and the columns it ships (None: its device columns)."""
    out = {}
    for name, (ev, ship) in pins.items():
        cache.drop_device()
        ev._stacked_device(cache, ship)
        torch.cuda.synchronize()
        out[name] = cache.device_nbytes()
    cache.drop_device()
    torch.cuda.empty_cache()
    return out


def time_decode(fm, img, j: int) -> dict:
    """Program #1 alone: ``decode_column`` over column ``j`` of an image
    (every row of every block), held bit for bit to
    ``kernels.decode_device_column`` on the same tensors, its CUDA-event ms,
    the plain version's, and the yardstick: ``to(int64) + ref`` for a
    narrow lane, ``torch.searchsorted`` + gather for runs.  Bound: the
    payload (and null payload) read once, int64 lanes and null bytes
    written once; for runs, a binary-search step per row and run bit."""
    from tikv_tpu_torch.copr.fused_agg import Image
    from tikv_tpu_torch.copr.kernels import decode_device_column

    desc, payload, nulls, ref = img.desc(j), img.cols[j], img.nulls[j], img.ref(j)
    nb, br, dev = img.n_blocks, img.block_rows, img.device
    one = Image([payload], [nulls], br, nb, br, dev, descs=(desc,), refs=(ref,))
    out = torch.empty((nb, br), dtype=torch.int64, device=dev)
    out_n = torch.empty((nb, br), dtype=torch.bool, device=dev)
    fm.launch_decode(one, out, out_n)
    want, want_n = decode_device_column(desc, payload, nulls, ref, br)
    if not torch.equal(out, want) or not torch.equal(
            out_n, torch.zeros_like(out_n) if want_n is None else want_n):
        raise AssertionError(f"decode_column ({desc}) differs from decode_device_column")
    del want, want_n
    ms = cuda_ms(lambda: fm.launch_decode(one, out, out_n), 20)
    plain_ms = cuda_ms(lambda: decode_device_column(desc, payload, nulls, ref, br), 10)
    pieces = payload if isinstance(payload, tuple) else (payload,)
    read = sum(t.numel() * t.element_size() for t in pieces) + (0 if nulls is None else nulls.numel())
    steps = 1
    if desc[0] == "rle":
        values, ends = payload
        lane_rows = torch.arange(br, device=dev).expand(nb, br).contiguous()

        def library():
            idx = torch.searchsorted(ends, lane_rows, right=True).clamp_(max=desc[1] - 1)
            return values.gather(1, idx)

        name = "torch.searchsorted + gather"
        steps = desc[1].bit_length() + 1
    else:
        def library():
            return payload.to(torch.int64) + ref

        name = "to(int64) + ref"
    lib_ms = cuda_ms(library, 20)
    b_ms, b_by = bound(read + nb * br * 9, nb * br * steps)
    return {"desc": list(desc), "rows": nb * br, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": name, "bound_ms": b_ms, "bound_by": b_by,
            "bit_identical": True}


def plain_topn_step(ft, prog, cand, pay, carry, src_base: int):
    """``topn_step`` through the plain versions, on the image's own device."""
    run = ft._merge_all(ft.candidates_plain(prog, cand, src_base),
                        None if carry is None else carry[2], cuda=False)
    return ft.pack_plain(prog, run, pay, carry, src_base)


# ---------------------------------------------------------------------------
# phases 4-11
# ---------------------------------------------------------------------------

def stacked(ev):
    """``ev`` pinned to the stacked kernels (``route_hint="unary"``): the
    warm phases before phase ``zone`` measure the kernels they name."""
    ev.route_hint = "unary"
    return ev


def warm_rows_that_fit(want: int, floor: int) -> tuple[int, str | None]:
    """Rows of the warm image this machine can hold: the draws and the host
    stage take about 80 bytes a row on the host; the pinned images of Q6,
    Q1 and the GROUP BY l_quantity query, the host group ids and the plain
    versions' temporaries about 400 on the card."""
    host = mem_available_bytes()
    free_dev, _total = torch.cuda.mem_get_info()
    n = want
    while n > floor and (n * 80 > host * 0.8 or n * 400 > free_dev * 0.9):
        n //= 2
    n = max(n, floor)
    if n * 80 > host * 0.8 or n * 400 > free_dev * 0.9:
        raise RuntimeError(f"not even {floor} rows fit: host {host} B, device {free_dev} B free")
    reason = None if n == want else (
        f"cut from {want} to {n} rows: {host} B host memory available, {free_dev} B free on the card")
    return n, reason


def profile_runs(run, n: int) -> dict:
    """Device time by kernel (torch.profiler) over ``n`` runs, and the
    share of the window's wall time the device was busy.  A window in which
    the profiler recorded no device activity at all is taken once more."""
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        device_ms, calls = {}, {}
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue  # host-side ops repeat their kernels' device time
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            if us > 0:
                device_ms[evt.key] = us / 1e3
                calls[evt.key] = evt.count
        if device_ms:
            break
    busy = sum(device_ms.values())
    return {"runs": n, "wall_ms": wall_ms, "device_ms": device_ms, "device_calls": calls,
            "device_busy_share": busy / wall_ms if wall_ms else None}


def timed_run(ev, source, cache) -> tuple[object, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = ev.run(source, cache)
    torch.cuda.synchronize()
    return resp, time.perf_counter() - t0


def check_rows(resp, want, what: str) -> None:
    got = resp.iter_rows()
    if got != want:
        raise AssertionError(f"{what}: {got} != oracle {want}")


def time_group_kernels(ga, prog, img, cap: int, iters: int) -> dict:
    """CUDA-event ms per launch of both grouped kernels at one image, the
    plain versions' ms, and each kernel's bound from the image's valid rows:
    bytes of the shipped columns, null masks and host ids read once and the
    partials written once; one operation per bytecode word and leaf per row."""
    parts = ga.new_partials(prog, img, cap)
    out = (torch.empty((prog.n_int, cap), dtype=torch.int64, device=img.device),
           torch.empty((prog.n_f64, cap), dtype=torch.float64, device=img.device))
    p_ms = cuda_ms(lambda: ga.launch_partials(prog, img, cap, parts), iters)
    c_ms = cuda_ms(lambda: ga.launch_combine(prog, img, cap, parts, None, out), 200)
    grid = parts.shape[0]
    err_p = 0.0
    attrs = None
    if prog.shared_rows(cap):
        err_p = check_group_partials(prog, parts, ga.partials_plain(prog, img, cap, grid, ga.ROWS),
                                     "timed partials")
        # the instance this shape runs keeps its state in registers
        attrs = dict(ga.partials_attributes(ga.partials_slots(prog)), rows_a_thread=ga.ROWS)
        if attrs["localSizeBytes"] != 0:
            raise AssertionError(f"fused_group_agg_partials spills: {attrs}")
    err_c = compare_packed(prog, out, ga.combine_plain(prog, img, cap, parts), "timed combine")
    pp_ms = cuda_ms(lambda: ga.partials_plain(prog, img, cap, grid, ga.ROWS), 3, warmup=1)
    cp_ms = cuda_ms(lambda: ga.combine_plain(prog, img, cap, parts), 3, warmup=1)
    nv = img.n_valids
    rows = int(nv if isinstance(nv, int) else nv.sum())
    L = len(prog.leaves)
    read = image_bytes(img, rows) + (4 * rows if img.gids is not None else 0)
    part_bytes = parts.numel() * 8
    p_bound, p_by = bound(read + 16 * img.n_blocks + part_bytes, rows * (len(prog.code) + L))
    c_bound, c_by = bound(part_bytes + (prog.n_int + prog.n_f64) * cap * 8, parts.numel())
    return {"rows": rows, "capacity": cap, "grid": grid, "partials_ms": p_ms,
            "partials_bound_ms": p_bound, "partials_bound_by": p_by, "partials_plain_ms": pp_ms,
            "combine_ms": c_ms, "combine_bound_ms": c_bound, "combine_bound_by": c_by,
            "combine_plain_ms": cp_ms, "max_abs_err_partials": err_p,
            "max_abs_err_combine": err_c, "partials_attributes": attrs}


def time_mask(fm, prog, img) -> dict:
    """CUDA-event ms of ``fused_mask`` over a stacked image, its plain
    version's, and the yardstick: the same mask from torch comparisons over
    config 2's three columns (shipdate, quantity, extendedprice in the
    image's slot order 1, 2, 4 -> 0, 1, 2).  Bound: the valid rows of the
    shipped columns and ``n_valids`` read once, the mask written once.  Also
    the attributes of the instance the path runs (raises if it spills to
    local memory)."""
    from tikv_tpu_torch import fixtures as fx

    out = torch.empty((img.n_blocks, img.block_rows), dtype=torch.bool, device=img.device)
    want = fm.fused_mask_plain(prog, img)
    ms = cuda_ms(lambda: fm.launch_mask(prog, img, out), 20)
    if not torch.equal(out, want):
        raise AssertionError("timed fused_mask differs from its plain version")
    attrs = fm.mask_attributes(prog, img)
    if attrs["localSizeBytes"] != 0:
        raise AssertionError(f"fused_mask spills to local memory: {attrs}")
    plain_ms = cuda_ms(lambda: fm.fused_mask_plain(prog, img), 3, warmup=1)
    lane = torch.arange(img.block_rows, device=img.device)

    def library():
        # an encoded image's lanes are widened (to(int64) + ref) first
        qty, price, ship = (c if img.desc(j)[0] == "plain" else c.to(torch.int64) + img.ref(j)
                            for j, c in enumerate(img.cols))
        return ((lane[None, :] < img.n_valids[:, None]) & (ship < fx.SELECTIVE_SHIP_LT)
                & (qty > fx.FILTER_QTY_GT) & (price >= fx.FILTER_PRICE_GE * 100))

    if not torch.equal(library(), out):
        raise AssertionError("the torch yardstick computes another mask")
    lib_ms = cuda_ms(library, 20)
    rows = int(img.n_valids.sum())
    b_ms, b_by = bound(image_bytes(img, rows) + img.n_blocks * 8 + out.numel(),
                       rows * len(prog.code))
    return {"rows": rows, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "torch comparisons and ANDs over the three columns and the valid lanes",
            "bound_ms": b_ms, "bound_by": b_by, "kept": int(out.sum()),
            "rows_a_thread": fm.MASK_ROWS, "attributes": attrs}


def merge_stage(ft, runs, extra, iters: int) -> dict:
    """The top-K merge of ``runs`` (and the carry ``extra``) as one stage:
    CUDA-event ms of ``_merge_all`` on the card (every level of the plan),
    its launches, the plain version's ms, the bound (each run read once, the
    final run written once; one operation a word read) and the resources
    of the instance it runs; the stage's result against the plain one's."""
    n, w, k = runs.shape
    fans = ft.merge_fans(n + (extra is not None), w, k)
    got = ft._merge_all(runs, extra, cuda=True)
    want = ft._merge_all(runs, extra, cuda=False)  # the plain levels, on the card
    if not torch.equal(got, want):
        raise AssertionError("topn_merge's levels differ from their plain versions")
    ms = cuda_ms(lambda: ft._merge_all(runs, extra, cuda=True), iters)
    plain_ms = cuda_ms(lambda: ft._merge_all(runs, extra, cuda=False), 2, warmup=1)
    words = (n + (extra is not None)) * w * k
    b_ms, b_by = bound(words * 8 + w * k * 8, words)
    staged = bool(fans) and ft.merge_staged(fans[0], w, k)
    attrs = ft.merge_attributes(w, staged)
    if attrs["localSizeBytes"] != 0:
        raise AssertionError(f"topn_merge spills to local memory: {attrs}")
    return {"runs": n + (extra is not None), "words": w, "k": k, "fan_ins": fans,
            "launches": len(fans), "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "attributes": attrs}


def time_topn(ft, prog, cand, pay, carried: bool = False) -> dict:
    """CUDA-event ms of each top-K kernel at one step over the image (a warm
    raw TopN's: no carry; a mesh shard's with ``carried``: the carry as one
    more run, the candidates at ``src_base`` K), the plain versions' ms,
    and the yardstick ``torch.topk`` over the first key's column alone (it
    computes less: one key, no selection, no stable tie order).  The merge
    is timed whole (:func:`merge_stage`), and at a cold 65,536-row block's
    16 runs and the carry.  Bounds: bytes read once and written once -- the
    candidate columns' valid rows and the runs out (candidates), the runs in
    and the final run out (merge), the run, the K winners' payload and the
    packed state (pack)."""
    dev, k, w = cand.device, prog.k, prog.n_words
    nt = ft.n_tiles(prog, cand)
    src_base = k if carried else 0
    runs = torch.empty((nt, w, k), dtype=torch.int64, device=dev)
    cand_ms = cuda_ms(lambda: ft.launch_candidates(prog, cand, runs, src_base), 5)
    attrs = ft.candidates_attributes(prog)
    if attrs["localSizeBytes"] != 0:
        raise AssertionError(f"topn_candidates spills to local memory: {attrs}")
    # the carry: the first step's next run (its src the slots 0..K-1)
    carry = ft.topn_step(prog, cand, pay)[2] if carried else None
    merge = merge_stage(ft, runs, carry, 5)
    if not carried and nt >= 16:
        merge["cold_block"] = merge_stage(ft, runs[:16].contiguous(),
                                          ft.topn_step(prog, cand, pay)[2], 20)
    run = ft._merge_all(runs, carry, cuda=True)
    out = (torch.empty((prog.n_int, k), dtype=torch.int64, device=dev),
           torch.empty((prog.n_f64, k), dtype=torch.float64, device=dev))
    nxt = torch.empty((w, k), dtype=torch.int64, device=dev)
    pack_ms = cuda_ms(lambda: ft.launch_pack(prog, run, pay, None, 0, out, nxt), 50)
    pack_attrs = no_local_memory("topn_pack", [ft.pack_attributes()])[0]
    cand_plain_ms = cuda_ms(lambda: ft.candidates_plain(prog, cand, src_base), 2, warmup=1)
    pack_plain_ms = cuda_ms(lambda: ft.pack_plain(prog, run, pay, None, 0), 20)
    key = pay.lanes(2)[0].reshape(-1)  # extendedprice, the first key, widened
    lib_ms = cuda_ms(lambda: torch.topk(key, k), 5)
    rows = int(cand.n_valids.sum())
    c_bound = bound(image_bytes(cand, rows) + cand.n_blocks * 8 + nt * w * k * 8,
                    rows * len(prog.code))
    p_bound = bound(w * k * 8 * 2 + k * 9 * len(prog.pay_f64) + (prog.n_int + prog.n_f64) * k * 8,
                    k * len(prog.pay_f64))
    return {"rows": rows, "k": k, "tile": prog.tile, "words": w, "tiles": nt,
            "merge_levels": merge["launches"],
            "topn_candidates": {"ms": cand_ms, "plain_ms": cand_plain_ms,
                                "bound_ms": c_bound[0], "bound_by": c_bound[1],
                                "attributes": attrs, "select_cap": ft.select_cap(k, prog.tile)},
            "topn_merge": merge,
            "topn_pack": {"ms": pack_ms, "plain_ms": pack_plain_ms,
                          "bound_ms": p_bound[0], "bound_by": p_bound[1],
                          "attributes": pack_attrs},
            "library_ms": lib_ms,
            "library": "torch.topk over the first key's column alone (one key, no selection)"}


ZONE_KERNELS = ("zone_full", "zone_partial", "zone_fold")


def check_zone_outputs(out: dict, again: dict, what: str) -> dict:
    """``fixtures.zone_kernel_outputs`` of two runs: each kernel against its
    plain version (int64 words exactly, f64 to REL_TOL) and against its own
    rerun (bit for bit).  Returns each kernel's max abs error."""
    errs = {}
    for name, (got, want) in out.items():
        err = 0.0
        for g, w, h in zip(got, want, again[name][0]):
            if not torch.equal(bits(g), bits(h)):
                raise AssertionError(f"{what}: two {name} runs are not bit-identical")
            if g.dtype == torch.float64:
                err = max(err, compare_f64(g.cpu(), w.cpu(), f"{what} {name}"))
            elif not torch.equal(g, w):
                leaves = (g != w).nonzero()[:8].tolist()
                raise AssertionError(f"{what}: {name} differs from its plain version at {leaves}")
        errs[name] = err
    return errs


def time_zone(fz, ev, cache) -> dict:
    """CUDA-event ms of each zone kernel over ``ev``'s layout of ``cache``
    for its own query, the plain versions' ms, the bounds and, for
    ``zone_full``, the yardstick: one bare column's tile sums as one torch
    call.  Bounds: the listed tiles' rows of the program's lanes at their
    own widths (and, for partial tiles, the null, valid and ridx bytes),
    the tile list, the per-tile partials and row-map words written; one
    operation per bytecode word and leaf per row; for the fold the listed
    tiles' partials and tile words and the packed state, one operation per
    leaf a row.  The tile kernels are timed as the rung launches them, each
    recording its tiles' rows in the query's map that the fold reads."""
    from tikv_tpu_torch.copr.fused_group_agg import LEAF_SUM

    rung = ev._zone_rung()
    layout, full_idx, partial_idx = rung.plan_tiles(cache)
    full, part = rung.programs(layout)
    dev, tr, L = ev.device, layout.tile_rows, len(full.prog.leaves)
    track = full.prog.track
    res = {"tiles": layout.n_tiles, "full": len(full_idx), "partial": len(partial_idx),
           "tile_rows": tr, "leaves": L}
    lists = []
    # the query's row map, as the rung launches the tile kernels: each
    # records its tiles' rows there for the fold
    row_of = torch.empty(layout.n_tiles, dtype=torch.int32, device=dev)
    for name, tp, idx in (("zone_full", full, full_idx), ("zone_partial", part, partial_idx)):
        t = torch.from_numpy(idx).to(dev)
        out = torch.empty((len(idx), L), dtype=torch.int64, device=dev)
        launch = fz.zone_full if name == "zone_full" else fz.zone_partial
        plain = fz.zone_full_plain if name == "zone_full" else fz.zone_partial_plain
        base = 0 if name == "zone_full" else len(full_idx)
        launch(tp, layout, t, out, row_of, base)
        lists.append(out)
        if not len(idx):
            res[name] = None
            continue
        ms = cuda_ms(lambda: launch(tp, layout, t, out, row_of, base), 20)
        alone_ms = isolated_ms(lambda: launch(tp, layout, t, out, row_of, base))
        plain_ms = cuda_ms(lambda: plain(tp, layout, t), 3, warmup=1)
        rows = len(idx) * tr
        per_row = sum(layout.cols[i].element_size() for i in tp.cols)
        if tp.partial:
            per_row += sum(1 for i in tp.cols if i in layout.nulls) + 1 + (4 if track else 0)
        per_tile = 8 + (8 if track and not tp.partial else 0) + 8 * L + 4  # + its row_of word
        b_ms, b_by = bound(rows * per_row + len(idx) * per_tile, rows * (len(tp.prog.code) + L))
        entry = {"tiles": len(idx), "rows": rows, "ms": ms, "ms_alone": alone_ms,
                 "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        bare = [k for k, b in enumerate(tp.bare) if b >= 0]
        if name == "zone_full" and bare:
            k = bare[0]
            ci = tp.cols[tp.bare[k]]
            lane = layout.cols[ci].view(layout.n_tiles, tr)
            entry["library_ms"] = cuda_ms(lambda: lane[t].sum(1, dtype=torch.int64), 20)
            entry["library"] = (f"view(T, {tr})[full_idx].sum(1, dtype=torch.int64) over column "
                                f"{ci} ({lane.dtype}) alone")
            sums = [l for l in tp.prog.agg_leaves[k] if tp.prog.leaves[l].kind == LEAF_SUM]
            if sums and not torch.equal(lane[t].sum(1, dtype=torch.int64), out[:, sums[0]]):
                raise AssertionError("the yardstick's tile sums differ from zone_full's")
        elif name == "zone_partial":
            entry["library"] = "none: the walk has no one-call equivalent"
        res[name] = entry
    parts = torch.cat(lists)
    tiles = torch.from_numpy(np.concatenate([full_idx, partial_idx]).astype(np.int64)).to(dev)
    order, C = layout.fold, layout.n_slots
    packed = (torch.empty((full.prog.n_int, C), dtype=torch.int64, device=dev),
              torch.empty((full.prog.n_f64, C), dtype=torch.float64, device=dev))
    ms = cuda_ms(lambda: fz.launch_fold(full, parts, tiles, row_of, order, C, packed), 50)
    alone_ms = isolated_ms(lambda: fz.launch_fold(full, parts, tiles, row_of, order, C, packed))
    plain_ms = cuda_ms(lambda: fz.zone_fold_plain(full, parts, tiles, row_of, order, C), 5,
                       warmup=1)
    n, n_segs = parts.shape[0], order.segs.shape[1]
    # what folding the listed rows into their slots needs: the rows and one
    # index word a listed tile read once, the packed state written once
    # (not the layout-wide slot_tiles and row_of words this design scans)
    b_ms, b_by = bound(n * L * 8 + 8 * n + (full.prog.n_int + full.prog.n_f64) * C * 8, n * L)
    res["zone_fold"] = {"rows_folded": n, "slots": C, "segments": n_segs, "ms": ms,
                        "ms_alone": alone_ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "library": "none: sum, min and max leaves need a call each",
                        "attributes": no_local_memory("zone_fold", [fz.fold_attributes()])[0]}
    return res


def zone_request_split(ev, cache, what: str, runs: int = 3) -> dict:
    """One warm zone-served request split by step, in ms on the host clock,
    the median of ``runs`` (the rung's own steps, ``ZoneRung.serve`` and
    ``launch``, taken one at a time): eligibility, the pinned layout's
    lookup and the tile classification (``plan_tiles``); the listed tiles'
    upload, in one piece; the three launches (the host's enqueue); the wait
    for the card to finish them; the pull and finalize (``_finalize_agg``).
    The fold's order is the layout's own (``layout.fold``) and the tile
    kernels record each tile's row for it, so no step sorts, uploads or
    clears one.  Its bytes must equal a request's served the usual
    way."""
    from tikv_tpu_torch.copr import fused_zone as fz
    from tikv_tpu_torch.copr.zone import key_of

    rung, dev = ev._zone_rung(), ev.device
    want = ev.run(None, cache).encode()
    steps: dict[str, list] = {}
    for _ in range(runs):
        torch.cuda.synchronize()
        marks = [("start", time.perf_counter())]
        layout, full_idx, partial_idx = rung.plan_tiles(cache)
        marks.append(("eligibility_and_classification", time.perf_counter()))
        tiles = torch.from_numpy(np.concatenate([full_idx, partial_idx]).astype(np.int64)).to(dev)
        marks.append(("index_uploads", time.perf_counter()))
        full, part = rung.programs(layout)
        nf = len(full_idx)
        parts = torch.empty((len(tiles), len(full.prog.leaves)), dtype=torch.int64, device=dev)
        row_of = torch.empty(layout.n_tiles, dtype=torch.int32, device=dev)
        if nf:
            fz.zone_full(full, layout, tiles[:nf], parts[:nf], row_of, 0)
        if len(partial_idx):
            fz.zone_partial(part, layout, tiles[nf:], parts[nf:], row_of, nf)
        packed = fz.zone_fold(full, parts, tiles, row_of, layout.fold, layout.n_slots)
        marks.append(("launches", time.perf_counter()))
        torch.cuda.synchronize()
        marks.append(("device_wait", time.perf_counter()))
        resp = ev._finalize_agg(packed, full.prog, layout.n_slots,
                                key_of(layout.dicts, layout.dict_lens))
        marks.append(("pull_and_finalize", time.perf_counter()))
        if resp.encode() != want:
            raise AssertionError(f"zone {what}: the split request differs from a served one")
        for (_a, t0), (name, t1) in zip(marks, marks[1:]):
            steps.setdefault(name, []).append((t1 - t0) * 1e3)
        steps.setdefault("total", []).append((marks[-1][1] - marks[0][1]) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in steps.items()}


# ---------------------------------------------------------------------------
# phase batch: programs #10 and #11
# ---------------------------------------------------------------------------

BATCH_KERNELS = ("batch_partials", "batch_combine_pack")
# the JAX package's read scheduler batches at most max_batch = 64 requests
# (tikv_tpu/copr/scheduler.py:94); a TiKV region splits near 96 MB, about a
# million lineitem rows: 6 to 10 blocks of 131,072 rows
XREGION_REGIONS = 64
XREGION_BLOCKS = (6, 7, 8, 9, 10)
XREGION_ENCODED = 8


def img_nbytes(img) -> int:
    """Bytes an image's tensors hold on the card (its pin)."""
    ts = [t for c in img.cols for t in (c if isinstance(c, tuple) else (c,))]
    ts += [m for m in img.nulls if m is not None] + [img.n_valids, img.offsets]
    return sum(t.numel() * t.element_size() for t in ts)


def time_batch(fb, tasks, iters: int) -> dict:
    """CUDA-event ms per launch of both batch kernels at one batch's tasks,
    the plain versions' ms, and the bounds: each distinct image's shipped
    lanes over its valid rows read once (an image K riders share, once),
    its n_valid and offset vectors, the partials written once; one
    operation per bytecode word and leaf per row of each task (partials),
    one per partial word folded (combine)."""
    batch = fb.Batch(tasks)
    table = fb.upload_table(batch)
    dev = batch.device
    parts = torch.empty(batch.n_parts, dtype=torch.int64, device=dev)
    out = (torch.empty((len(batch), batch.li, batch.c_max), dtype=torch.int64, device=dev),
           torch.empty((len(batch), batch.lf, batch.c_max), dtype=torch.float64, device=dev))
    p_ms = cuda_ms(lambda: fb.launch_batch_partials(batch, table, parts), iters)
    attrs = fb.partials_attributes(fb.partials_slots(batch))
    if attrs["localSizeBytes"] != 0:
        raise AssertionError(f"batch_partials spills to local memory: {attrs}")
    c_ms = cuda_ms(lambda: fb.launch_batch_combine_pack(batch, table, parts, out), 100)
    pp_ms = cuda_ms(lambda: fb.batch_partials_plain(batch), 1, warmup=1)
    cp_ms = cuda_ms(lambda: fb.batch_combine_pack_plain(batch, parts), 2, warmup=1)
    images = {id(t.img): t.img for t in tasks}
    rows = {k: int(img.n_valids.sum()) for k, img in images.items()}
    read = sum(image_bytes(img, rows[k]) + 16 * img.n_blocks for k, img in images.items())
    ops = sum(rows[id(t.img)] * (len(t.prog.code) + len(t.prog.leaves)) for t in tasks)
    p_bound, p_by = bound(read + batch.n_parts * 8, ops)
    out_words = len(batch) * (batch.li + batch.lf) * batch.c_max
    c_bound, c_by = bound(batch.n_parts * 8 + out_words * 8, batch.n_parts)
    return {"tasks": len(batch), "rows": sum(rows.values()), "ctas": batch.n_ctas,
            "partial_words": batch.n_parts, "partials_ms": p_ms, "partials_plain_ms": pp_ms,
            "partials_bound_ms": p_bound, "partials_bound_by": p_by, "combine_ms": c_ms,
            "combine_plain_ms": cp_ms, "combine_bound_ms": c_bound, "combine_bound_by": c_by,
            "partials_attributes": attrs}


def phase_batch(cache, wants: dict, card: str, br: int = 1 << 17) -> dict:
    """Programs #10 and #11 over the plain 100M-row image and 64 region
    images: the batch main path (counted from 0), the kernels against their
    plain versions and timed, every response against its numpy oracle and,
    byte for byte, the same request served alone on the stacked unary route,
    timed one by one beside the batch."""
    from tikv_tpu_torch import fixtures as fx
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire

    t_phase = time.perf_counter()
    plans = fx.batch_plans()
    names = [name for name, _d, _o in plans]

    def evaluators(dags):
        return [te.TorchDagEvaluator(dag_to_wire(d), block_rows=br, device="cuda") for d in dags]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def per_batch(before: dict) -> dict:
        return {k: fa.LAUNCHES[k] - before[k] for k in BATCH_KERNELS + ZONE_KERNELS}

    # the regions: 64 of 6 to 10 blocks, two of them with a returnflag
    # dictionary of two; 8 more images hold regions 0-7's rows again, to be
    # encoded in place
    counts = [XREGION_BLOCKS[r % len(XREGION_BLOCKS)] for r in range(XREGION_REGIONS)]
    t0 = time.perf_counter()
    regions = fx.region_caches(counts, br, SEED + 100, two_flags=(3, 17))
    enc_regions = fx.region_caches(counts[:XREGION_ENCODED], br, SEED + 100, two_flags=(3,))
    for _a, c in enc_regions:
        encoding.encode_blocks(c, fx.lineitem())
    mixed_regions = [c for _a, c in enc_regions[: XREGION_ENCODED - 1]] + [regions[7][1]]
    x_plans = {name: (dag, oracle) for name, dag, oracle in plans if name in ("q1", "q6")}
    x_wants = {name: [oracle(a) for a, _c in regions] for name, (_d, oracle) in x_plans.items()}
    regions_build_s = time.perf_counter() - t0

    # ---- the batch main path: counts from 0 here to its end -------------------
    fa.reset_launches()
    runs, resps, launches, totals = {}, {}, {}, {}

    def drive(key, fn, want, n=4):
        runs[key] = []
        start = dict(fa.LAUNCHES)
        for i in range(n):
            before = dict(fa.LAUNCHES)
            out, sec = timed(fn)
            runs[key].append(sec)
            if i == 0:
                launches[key] = per_batch(before)
            for j, (resp, w) in enumerate(zip(out, want)):
                check_rows(resp, w, f"batch {key} response {j}")
        resps[key] = out
        totals[key] = per_batch(start)

    # batch B: every rider zone-eligible, so the rung serves all of them
    evs_b = evaluators([d for name, d, _o in plans if name != "bit_xor_by_linestatus"])
    drive("same_region_zone", lambda: te.run_batch_cached(evs_b, cache),
          [wants[name] for name in names[:-1]])
    for name, ev in zip(names, evs_b):
        if ev.zone_stats.served != 4:
            raise AssertionError(f"batch B: {name} not zone-served ({ev.zone_stats})")
    # batch A: the eight riders; bit_xor declines the rung (agg_op), so all
    # eight run on the batch kernels
    evs_a = evaluators([d for _n, d, _o in plans])
    drive("same_region", lambda: te.run_batch_cached(evs_a, cache), [wants[n] for n in names])
    if any(ev.zone_stats.served for ev in evs_a) or \
            evs_a[-1].zone_stats.declines.get("agg_op") != 4:
        raise AssertionError("batch A: a rider rode the zone rung")
    evs_x = {name: evaluators([dag])[0] for name, (dag, _o) in x_plans.items()}
    plain_caches = [c for _a, c in regions]
    for name, ev in evs_x.items():
        drive(f"xregion_{name}", lambda ev=ev: te.run_xregion_cached(ev, plain_caches),
              x_wants[name], 3)
        enc_before = encoding.PATH_COUNTS.get(("xregion", "encoded"), 0)
        drive(f"xregion_{name}_encoded",
              lambda ev=ev: te.run_xregion_cached(ev, [c for _a, c in enc_regions]),
              x_wants[name][:XREGION_ENCODED], 3)
        if encoding.PATH_COUNTS[("xregion", "encoded")] != enc_before + 3:
            raise AssertionError(f"xregion {name}: the encoded regions did not ship encoded")
        dec_before = encoding.DECLINE_COUNTS.get(("xregion", "enc_mismatch"), 0)
        drive(f"xregion_{name}_enc_mismatch",
              lambda ev=ev: te.run_xregion_cached(ev, mixed_regions),
              x_wants[name][:XREGION_ENCODED], 3)
        if encoding.DECLINE_COUNTS[("xregion", "enc_mismatch")] != dec_before + 3:
            raise AssertionError(f"xregion {name}: the mismatch did not decode-ship")
    batch_launches = dict(fa.LAUNCHES)
    # ---- end of the batch main path -------------------------------------------
    for key, counted in launches.items():
        want = 0 if key == "same_region_zone" else 1
        if counted["batch_partials"] != want or counted["batch_combine_pack"] != want:
            raise AssertionError(f"batch {key} launched {counted}")

    # the kernels against their plain versions: batch A with the mixed rider
    # (every leaf kind: var_pop's f64 sums, first), and Q1 and the mixed plan
    # over the 64 plain and the 8 encoded regions
    ev_mixed = evaluators([fx.mixed_dag()])[0]
    checks = {"same_region_9_riders": fx.batch_kernel_check(
        te.batch_tasks(evs_a + [ev_mixed], cache)[0])}
    for label, caches in (("xregion", plain_caches),
                          ("xregion_encoded", [c for _a, c in enc_regions])):
        for name, ev in (("q1", evs_x["q1"]), ("mixed", ev_mixed)):
            checks[f"{label}_{name}"] = fx.batch_kernel_check(te.xregion_tasks(ev, caches)[0])
    tasks_a = te.batch_tasks(evs_a, cache)[0]
    t_same = time_batch(fb, tasks_a, 5)
    # one task alone, to split a task's cost in batch A: Q1 over batch A's
    # pin (6 columns and 4 null masks, the union) and over its own pin (its
    # 6 columns), beside fused_group_agg_partials on that pin (phase timings)
    ev_q1 = evs_a[names.index("q1")]
    gc, dicts = ev_q1._stable_dict_group_cols(cache.blocks)
    own = ev_q1._ship_cols(gc)
    dl = tuple(len(d) for d in dicts)
    prog_own = ev_q1._batch_program(own, ev_q1.plan.schema, gc, dl)
    one_task = {
        "q1_over_the_union_pin": time_batch(fb, [tasks_a[names.index("q1")]], 5)["partials_ms"],
        "q1_over_its_own_pin": time_batch(
            fb, [fb.Task(prog_own, ev_q1._stacked_device(cache, own), 16)], 5)["partials_ms"]}
    t_x = time_batch(fb, te.xregion_tasks(evs_x["q1"], plain_caches)[0], 10)
    t_xe = time_batch(fb, te.xregion_tasks(evs_x["q1"], [c for _a, c in enc_regions])[0], 10)
    pinned = {"same_region": img_nbytes(tasks_a[0].img),
              "xregion": sum(img_nbytes(t.img) for t in
                             te.xregion_tasks(evs_x["q1"], plain_caches)[0])}
    del tasks_a
    # where a cross-region batch's time goes: the host's tasks (zone maps,
    # pins, programs), the launch pair to its end, the pull and 64 finalizes
    split = {}
    for name, ev in evs_x.items():
        secs = {"tasks_s": [], "kernels_s": [], "pull_and_finalize_s": []}
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tasks, specs, order, prunes, enc = te.xregion_tasks(ev, plain_caches)
            t1 = time.perf_counter()
            packed = fb.fused_batch(tasks)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            te.XRegionPending(ev, specs, [t.prog for t in tasks], packed, order, prunes,
                              enc).finalize()
            t3 = time.perf_counter()
            for k, v in zip(secs, (t1 - t0, t2 - t1, t3 - t2)):
                secs[k].append(v)
        split[f"xregion_{name}"] = secs

    # each request alone on the stacked unary route: the same bytes, and the
    # sum of their times beside the batch's
    unary = {}

    def alone(dag, c, want: bytes) -> float:
        ev = stacked(te.TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cuda"))
        secs = []
        for _ in range(3 if c is cache else 2):
            resp, sec = timed(lambda: ev.run(None, c))
            if resp.encode() != want:
                raise AssertionError("a batch response differs from the unary route's")
            secs.append(sec)
        return sorted(secs[1:])[len(secs[1:]) // 2]

    for key in ("same_region", "same_region_zone"):
        unary[key] = [alone(dag, cache, r.encode())
                      for (_n, dag, _o), r in zip(plans, resps[key])]
    for name, (dag, _o) in x_plans.items():
        for label, caches in (("", plain_caches),
                              ("_encoded", [c for _a, c in enc_regions]),
                              ("_enc_mismatch", mixed_regions)):
            key = f"xregion_{name}{label}"
            unary[key] = [alone(dag, c, r.encode()) for c, r in zip(caches, resps[key])]
    for key, secs in runs.items():
        emit({"phase": "batch", "batch": key, "requests": len(unary[key]),
              "matches_oracle": True, "byte_identical_to_unary": True,
              "first_run_s": secs[0], "seconds": secs[1:],
              "median_s": sorted(secs[1:])[len(secs[1:]) // 2],
              "unary_sum_s": sum(unary[key]), "unary_s": unary[key],
              "launches_per_batch": launches[key], "card": card})
    emit({"phase": "batch", "case": "kernels", "card": card, "checks": checks,
          "int_words_equal": True, "f64_rel_tol": REL_TOL, "bit_identical_reruns": True,
          "same_region": t_same, "xregion": t_x, "xregion_encoded": t_xe,
          "one_task_partials_ms": one_task,
          "pinned_bytes": pinned, "launches": batch_launches,
          "regions": {"count": len(regions), "blocks": counts, "rows": sum(counts) * br,
                      "two_flag_regions": [3, 17], "build_and_encode_s": regions_build_s},
          "encoding": {"paths": {f"{k[0]}/{k[1]}": v for k, v in encoding.PATH_COUNTS.items()},
                       "declines": {f"{k[0]}/{k[1]}": v
                                    for k, v in encoding.DECLINE_COUNTS.items()}},
          "xregion_split": split,
          "kernel_share_same_region": t_same["partials_ms"] / 1e3
          / sorted(runs["same_region"][1:])[len(runs["same_region"][1:]) // 2],
          "phase_seconds": time.perf_counter() - t_phase})
    err = {k: max(max(c["partials"] for c in checks.values()) if k == "batch_partials"
                  else max(c["combine"] for c in checks.values()), 0.0) for k in BATCH_KERNELS}
    return {"launches": batch_launches, "same_region": t_same, "xregion": t_x,
            "xregion_encoded": t_xe, "max_abs_err": err, "regions": plain_caches,
            "enc_regions": [c for _a, c in enc_regions], "x_wants": x_wants,
            "encoded_launches": {k: sum(totals[f"xregion_{n}_encoded"][k] for n in x_plans)
                                 for k in BATCH_KERNELS}}


# ---------------------------------------------------------------------------
# phase join: programs #14 and #15
# ---------------------------------------------------------------------------

JOIN_KERNELS = ("join_rank_probe", "join_hash_probe")
# half of bench._op_join's 1,000,000 probe rows (a region splits near 96 MB),
# cut so that the script with phase high_capacity stays within half its limit
JOIN_ROWS = 500_000
JOIN_SYNTH = (1 << 23, 4, 1 << 25)  # distinct build keys, rows per key, probe rows
JOIN_SRC = "tikv_tpu_torch/csrc/fused_join.cu"


def time_join_kernels(fj, case: dict, device, iters: int) -> dict:
    """Each probe kernel's ms per launch (CUDA events) over ``case``
    (``fixtures.join_probe_case`` layout), beside its bound, its plain
    version's ms and, for the rank kernel, torch.searchsorted left plus right
    over the same tensors.  The bounds: 8 probe bytes read and 16 written per
    row, plus the sorted keys read once (rank), or every slot's 8-byte key
    and the 16 bytes of start and count of each occupied slot (hash: an
    empty slot's start and count are never read), over the HBM rate."""
    keys = torch.from_numpy(case["sorted"]).to(device)
    rp = torch.from_numpy(case["rank_probe"]).to(device)
    table = [torch.from_numpy(x).to(device) for x in case["table"]]
    hp = torch.from_numpy(case["hash_probe"]).to(device)
    n, m, slots = rp.numel(), keys.numel(), table[0].numel()
    occupied = int((table[0] != fj.EMPTY).sum())
    r_bound, r_by = bound(24 * n + 8 * m, 0)
    h_bound, h_by = bound(24 * n + 8 * slots + 16 * occupied, 0)
    out = {
        "probe_rows": n, "build_keys": m, "table_slots": slots, "occupied_slots": occupied,
        "join_rank_probe": {
            "ms": cuda_ms(lambda: fj.rank_probe(keys, rp), iters),
            "plain_ms": cuda_ms(lambda: fj.rank_probe_plain(keys, rp), iters),
            "library_ms": cuda_ms(lambda: (torch.searchsorted(keys, rp, side="left"),
                                           torch.searchsorted(keys, rp, side="right")), iters),
            "bound_ms": r_bound, "bound_by": r_by},
        "join_hash_probe": {
            "ms": cuda_ms(lambda: fj.hash_probe(*table, hp), iters),
            "plain_ms": cuda_ms(lambda: fj.hash_probe_plain(*table, hp), 3, warmup=1),
            "library_ms": None, "bound_ms": h_bound, "bound_by": h_by},
    }
    del keys, rp, table, hp
    torch.cuda.empty_cache()
    return out


def phase_join(fx, card: str, device) -> dict:
    """Programs #14 and #15 on their main path: the join event of
    ``bench._op_join`` at 500,000 probe rows against 125,000 build rows
    (encoded images, block_rows 65,536), served on the rank and the hash
    path over dictionary keys and on the hash path over int keys, bare and
    with Selection, Projection and Limit(100,000) over both sides; pairs
    and bytes against the numpy oracle; both kernels against their plain
    versions at this shape, on a seeded case with NULLs, misses and colliding
    slots and at 32M probe rows against 8M keys of 4 rows; their timings."""
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_join as fj
    from tikv_tpu_torch.copr import torch_join as tj

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    a, pc, bc = fx.join_caches(JOIN_ROWS, SEED, "dict", encode=True)
    _a, pci, bci = fx.join_caches(JOIN_ROWS, SEED, "int", encode=True)
    caches = {"dict": (pc, bc), "int": (pci, bci)}
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = fx.join_oracle(a)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want_bytes = {(key, down): fx.join_oracle_bytes(a, want, key, down)
                  for key in ("dict", "int") for down in (False, True)}
    oracle_bytes_s = time.perf_counter() - t0

    runs = (("rank_dict", "rank", "dict", False), ("hash_dict", "hash", "dict", False),
            ("hash_int", "hash", "int", False), ("rank_dict_downstream", "rank", "dict", True),
            ("hash_int_downstream", "hash", "int", True))
    # ---- the join main path: counts from 0 here to the last serve ----------
    fa.reset_launches()
    served = {}
    for name, path, key, down in runs:
        dag = fx.join_dag(fx.join_downstream() if down else (), key=key)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp, got_path, stats = tj.serve(dag, *caches[key], prefer=path, device=device)
        seconds = time.perf_counter() - t0
        if got_path != path:
            raise AssertionError(f"join {name} served on {got_path}")
        if resp.encode() != want_bytes[key, down]:
            raise AssertionError(f"join {name}: response bytes differ from the oracle's")
        served[name] = {"path": path, "key": key, "seconds": seconds,
                        "out_rows": stats["out_rows"], "probe_rows": stats["probe_rows"],
                        "build_rows": stats["build_rows"], "prune": stats["prune"],
                        "steps": stats["seconds"]}
    launches = {k: fa.LAUNCHES[k] for k in JOIN_KERNELS}
    for k, n in (("join_rank_probe", 2), ("join_hash_probe", 3)):
        if launches[k] != n:
            raise AssertionError(f"{k} launched {launches[k]} times on the join path, not {n}")

    # the pairs each bare serve expands, against the oracle's
    pairs = {}
    for name, path, key, down in runs:
        if down:
            continue
        pairs[name] = tj.join_pairs(fx.join_dag(key=key), *caches[key], prefer=path,
                                    device=device)
        if not (np.array_equal(pairs[name].probe_rows(), want[0])
                and np.array_equal(pairs[name].build_rows(), want[1])):
            raise AssertionError(f"join {name}: pairs differ from the oracle's")
    rank_in, hash_in = pairs["rank_dict"].inputs, pairs["hash_dict"].inputs
    phase_case = {"sorted": rank_in[0], "rank_probe": rank_in[1], "table": hash_in[:3],
                  "hash_probe": hash_in[3]}
    checks = {"phase_shape": fx.join_kernel_check(phase_case, device),
              "seeded": fx.join_kernel_check(
                  fx.join_probe_case(100_000, 3, 1_000_000, SEED + 1, wide=True, null_p=0.05),
                  device)}
    t_phase_shape = time_join_kernels(fj, phase_case, device, 20)
    t0 = time.perf_counter()
    synth = fx.join_probe_case(*JOIN_SYNTH, seed=SEED + 2)
    synth_s = time.perf_counter() - t0
    checks["synthetic"] = fx.join_kernel_check(synth, device)
    t_synth = time_join_kernels(fj, synth, device, 10)
    del synth
    out = {"phase": "join", "card": card, "probe_rows": JOIN_ROWS,
           "build_rows": int(len(a["build_key"])), "block_rows": 1 << 16,
           "out_rows": int(len(want[0])), "image_build_s": build_s, "oracle_s": oracle_s,
           "oracle_bytes_s": oracle_bytes_s, "synthetic_case_s": synth_s, "serves": served,
           "launches": launches, "checks": checks, "phase_shape": t_phase_shape,
           "synthetic": t_synth, "phase_seconds": time.perf_counter() - t_phase}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase mesh: programs #16, #18, #19 and #20 on eight shards of one card
# ---------------------------------------------------------------------------

MESH_SHARDS = 8
# MeshServingRunner's default rows per shard (tikv_tpu/parallel/mesh.py:1056),
# and the cold path's block
MESH_COLD_RPS = (1024, 1 << 16)
MESH_TOPN_RPS = 1 << 17  # eight shards: super-blocks of 1,048,576 rows
MESH_SRC = "tikv_tpu_torch/csrc/fused_mesh.cu"
# the kernels the mesh main path launches: the fold, the merge and the
# reused ones; the grouped combine is counted too, and must not launch there
MESH_KERNELS = ("mesh_fold", "mesh_merge", "fused_group_agg_partials", "batch_partials",
                "batch_combine_pack", "topn_candidates", "topn_merge", "topn_pack")
MESH_COUNTED = MESH_KERNELS + ("fused_group_agg_combine_pack",)


class _Enough(Exception):
    """Raised by a capture once it holds what it asked for: ``run`` stops
    there."""


def capture_fold(fm_mod, pm, run, which: int = 1) -> dict:
    """The inputs of the ``which``-th ``mesh_fold`` call that ``run`` makes
    (cloned: the main path's own shapes and values; one call a super-block
    on one card) and the shard images of the same super-block (the
    ``which``-th ``_shard_rows`` call's), for the checks and timings; ``run``
    stops after that call."""
    folds, images = [], []
    fold, rows_of = fm_mod.mesh_fold, pm._shard_rows

    def record_rows(prog, imgs, cap, lead):
        if len(images) <= which:
            images.append(imgs)
        return rows_of(prog, imgs, cap, lead)

    def record(prog, rows, shards, base, width, windows, outs=None, perm=None):
        folds.append({"prog": prog, "rows": rows.clone(), "shards": shards.clone(),
                      "base": base, "width": width,
                      "windows": [(lo, None if c is None else tuple(t.clone() for t in c))
                                  for lo, c in windows],
                      "perm": None if perm is None else perm.clone()})
        out = fold(prog, rows, shards, base, width, windows, outs, perm)
        if len(folds) > which:
            raise _Enough
        return out

    fm_mod.mesh_fold, pm._shard_rows = record, record_rows
    try:
        run()
    except _Enough:
        pass
    finally:
        fm_mod.mesh_fold, pm._shard_rows = fold, rows_of
    return dict(folds[which], images=images[which])


def check_fold(fx, case: dict) -> float:
    """``fx.mesh_fold_check`` at a captured case: the fold against its plain
    version and, every word, against the combines and ``mesh_merge`` it
    replaces; two runs bit-identical."""
    return fx.mesh_fold_check(case["prog"], case["rows"], case["shards"], case["base"],
                              case["width"], case["windows"], case["perm"], case["images"])


def time_fold(fm_mod, ga, case: dict, iters: int) -> dict:
    """CUDA-event ms per ``mesh_fold`` launch at a captured case beside the
    launches it replaces at the same inputs (``fused_group_agg_combine_pack``
    per shard, then ``mesh_merge`` per window), the plain version's ms, and
    the bound: the windows' words of every row read once, the shard table
    and the carries read once, the outputs written once; one operation per
    row word read."""
    prog, rows, shards, base, width = (case[k] for k in ("prog", "rows", "shards", "base",
                                                         "width"))
    windows, perm, images = case["windows"], case["perm"], case["images"]
    dev, cap = rows.device, rows.shape[2]
    n_win, leaves = len(windows), len(prog.leaves)

    def packed(n):
        return (torch.empty((n, prog.n_int, width), dtype=torch.int64, device=dev),
                torch.empty((n, prog.n_f64, width), dtype=torch.float64, device=dev))

    outs = [(o[0][0], o[1][0]) for o in (packed(1) for _ in windows)]
    ms = cuda_ms(lambda: fm_mod.launch_mesh_fold(prog, rows, shards, base, width, windows, outs,
                                                 perm), iters)
    pi = torch.empty((len(images), prog.n_int, cap), dtype=torch.int64, device=dev)
    pf = torch.empty((len(images), prog.n_f64, cap), dtype=torch.float64, device=dev)
    table = fm_mod.merge_table([range(len(images))], len(images), dev)
    spans = [(r0, r0 + n) for r0, n, _off in shards.tolist()]
    merges = [(lo, None if c is None else (c[0][None], c[1][None]), packed(1))
              for lo, c in windows]

    def pair():
        for k, ((a, b), img) in enumerate(zip(spans, images)):
            ga.launch_combine(prog, img, cap, rows[a:b], None, (pi[k], pf[k]))
        for lo, carry, out in merges:
            fm_mod.launch_mesh_merge(prog, (pi, pf), table, carry, lo, lo + width, out, perm)

    pair_ms = cuda_ms(pair, iters)
    plain_ms = cuda_ms(lambda: fm_mod.mesh_fold_plain(prog, rows, shards, base, width, windows,
                                                      perm), 3, warmup=1)
    words = rows.shape[0] * leaves * width * n_win
    n_bytes = words * 8 + shards.numel() * 8 + n_win * leaves * width * 8 * (
        1 + sum(c is not None for _lo, c in windows) / n_win) + (
        0 if perm is None else perm.numel() * 4)
    b_ms, b_by = bound(int(n_bytes), words)
    return {"shards": shards.shape[0], "rows": rows.shape[0], "windows": n_win,
            "leaves": leaves, "slots": width, "perm": perm is not None, "ms": ms,
            "pair_ms": pair_ms, "pair_launches": len(images) + n_win, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def capture_step(runner, run, which: int = 1) -> tuple:
    """The arguments of the ``which``-th ``step`` of ``runner``'s sharded
    evaluator that ``run`` makes, the state before it cloned; ``run`` stops
    there."""
    seen = []
    ev = runner.sharded
    step = ev.step

    def record(col_data, col_nulls, n_valid, gids, state, block_base=0):
        seen.append((col_data, col_nulls, n_valid, gids,
                     [(a.clone(), b.clone()) for a, b in state], block_base))
        if len(seen) > which:
            raise _Enough
        return step(col_data, col_nulls, n_valid, gids, state, block_base=block_base)

    ev.step = record
    try:
        run()
    except _Enough:
        pass
    finally:
        del ev.step
    return ev, seen[which]


def mesh_step_split(pm, ev, args, runs: int = 5) -> dict:
    """One cold mesh super-block split by host step, in ms on the host
    clock, the median of ``runs``: staging (``ShardedDagEvaluator.images``:
    the pinned stage and its copy to each device), the partials launches
    (``_shard_rows``, one a shard), the fold (``fold``: the carry updated in
    place by one ``mesh_fold`` a merging device), the wait for the card.
    Its state must equal the step's served the usual way, bit for bit."""
    col_data, col_nulls, n_valid, gids, state0, base = args

    def fresh():
        return [(a.clone(), b.clone()) for a, b in state0]

    want = ev.step(col_data, col_nulls, n_valid, gids, fresh(), block_base=base)
    steps: dict[str, list] = {}
    for _ in range(runs):
        state = fresh()
        torch.cuda.synchronize()
        marks = [("start", time.perf_counter())]
        images = ev.images(col_data, col_nulls, n_valid, gids, base)
        marks.append(("staging", time.perf_counter()))
        rows = pm._shard_rows(ev.prog, images, ev.capacity, ev.mesh.lead)
        marks.append(("partials_launches", time.perf_counter()))
        ev.fold(rows, state, base)
        marks.append(("fold_launch", time.perf_counter()))
        torch.cuda.synchronize()
        marks.append(("device_wait", time.perf_counter()))
        if not all(bit_identical(a, b) for a, b in zip(state, want)):
            raise AssertionError("mesh step split: the state differs from a served step's")
        for (_a, t0), (name, t1) in zip(marks, marks[1:]):
            steps.setdefault(name, []).append((t1 - t0) * 1e3)
        steps.setdefault("total", []).append((marks[-1][1] - marks[0][1]) * 1e3)
    return {k: sorted(v)[len(v) // 2] for k, v in steps.items()}


def capture_merge(fm_mod, run) -> tuple:
    """The inputs of the first ``mesh_merge`` call that ``run`` makes, cloned
    (the main path's own shapes and values), for the checks and timings."""
    seen = []
    launch = fm_mod.mesh_merge

    def record(prog, parts, table, carry=None, lo=0, hi=None, out=None, perm=None):
        if not seen:
            seen.append((prog, tuple(t.clone() for t in parts), table.clone(),
                         None if carry is None else tuple(t.clone() for t in carry), lo, hi,
                         None if perm is None else perm.clone()))
        return launch(prog, parts, table, carry, lo, hi, out, perm)

    fm_mod.mesh_merge = record
    try:
        run()
    finally:
        fm_mod.mesh_merge = launch
    return seen[0]


def time_merge(fm_mod, case, iters: int) -> dict:
    """CUDA-event ms per ``mesh_merge`` launch at a captured case, the plain
    version's ms on the same tensors, and the bound: each listed part's
    window read once, the carry read once, the output written once; one
    operation per listed part word."""
    prog, parts, table, carry, lo, hi, perm = case
    hi = parts[0].shape[2] if hi is None else hi
    width, leaves = hi - lo, prog.n_int + prog.n_f64
    n_regions = table.shape[0]
    out = (torch.empty((n_regions, prog.n_int, width), dtype=torch.int64, device=table.device),
           torch.empty((n_regions, prog.n_f64, width), dtype=torch.float64, device=table.device))
    ms = cuda_ms(lambda: fm_mod.launch_mesh_merge(prog, parts, table, carry, lo, hi, out, perm),
                 iters)
    plain_ms = cuda_ms(lambda: fm_mod.mesh_merge_plain(prog, parts, table, carry, lo, hi, perm),
                       3, warmup=1)
    listed = int((table >= 0).sum())
    words = listed * leaves * width
    n_bytes = words * 8 + table.numel() * 4 + n_regions * leaves * width * 8 * (
        2 if carry is not None else 1) + (0 if perm is None else perm.numel() * 4)
    b_ms, b_by = bound(n_bytes, words)
    return {"parts": parts[0].shape[0], "regions": n_regions, "listed_parts": listed,
            "leaves": leaves, "slots": width, "carry": carry is not None, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def time_topn_finalize(ft, topn, state) -> dict:
    """CUDA-event ms of program #19's kernels at the mesh's shape: the
    ``topn_merge`` stage over the S gathered runs (``n_words + 1`` words,
    :func:`merge_stage`), ``topn_pack`` of the K winners from the ``[S, K]``
    image, and the whole finalize's device work (the gathers too); the plain
    versions' ms; the bounds as :func:`time_topn`'s."""
    prog, k = topn.prog, topn.k
    runs, pay = topn.gather(state)
    merge = merge_stage(ft, runs, None, 20)
    final = ft._merge_all(runs, None, cuda=True)
    run = torch.cat([final[: prog.n_words - 1], final[prog.n_words:]]).contiguous()
    dev = run.device
    out = (torch.empty((prog.n_int, k), dtype=torch.int64, device=dev),
           torch.empty((prog.n_f64, k), dtype=torch.float64, device=dev))
    nxt = torch.empty((prog.n_words, k), dtype=torch.int64, device=dev)
    pack_ms = cuda_ms(lambda: ft.launch_pack(prog, run, pay, None, 0, out, nxt), 50)
    pack_plain_ms = cuda_ms(lambda: ft.pack_plain(prog, run, pay, None, 0), 20)
    p_bound = bound(prog.n_words * k * 8 * 2 + k * 9 * len(prog.pay_f64)
                    + (prog.n_int + prog.n_f64) * k * 8, k * len(prog.pay_f64))
    return {"runs": runs.shape[0], "words": runs.shape[1], "merge_levels": merge["launches"],
            "topn_merge": merge,
            "topn_pack": {"ms": pack_ms, "plain_ms": pack_plain_ms, "bound_ms": p_bound[0],
                          "bound_by": p_bound[1],
                          "attributes": no_local_memory("topn_pack", [ft.pack_attributes()])[0]},
            "finalize_device_ms": cuda_ms(lambda: topn.merge(state), 20)}


def slab_bytes(caches) -> int:
    """Bytes the caches pin on the card under ``shardslab`` signatures."""
    total = 0
    for c in caches:
        for sig, pins in c.blocks[0].device.items():
            if sig[0] == "shardslab":
                total += sum(t.numel() * t.element_size() for data, nulls in pins.values()
                             for t in list(data) + list(nulls) if t is not None)
    return total


def phase_mesh(fx, card: str, device, kvs, cold_arrays, cache, want_batch: dict,
               bt: dict) -> dict:
    """Programs #16, #18, #19 and #20 on ``make_mesh(["cuda:0"] * 8,
    groups)``: ``mesh_merge`` against its plain version; the mesh main path
    (counted from 0): cold Q6 and Q1 through ``MeshServingRunner`` at G = 1
    and 2, warm Q1 and Q6 through ``launch_xregion_sharded`` over phase
    ``batch``'s 64 regions, its 8 encoded ones and the 100M image alone, the
    raw TopN over 10M rows through ``ShardedTopNEvaluator``; every answer
    against its oracle and, byte for byte, the single-device route's, whose
    times stand beside; the grouped combine launched 0 times; the per-device
    kernels, ``mesh_fold`` (beside the combines and merges it replaces) and
    ``mesh_merge`` timed at the path's own inputs; one cold super-block
    split by host step."""
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_mesh as fme
    from tikv_tpu_torch.copr import fused_topn as ft
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    errs = {}
    for n_parts, cap in ((8, 16), (64, 16), (8, 331), (64, 331)):
        prog, parts, table, carry = fx.mesh_merge_case(n_parts, 64, cap, n_parts + cap, device)
        half = cap // 2
        window = tuple(t[:, :, half:].contiguous() for t in carry)
        errs[f"p{n_parts}_c{cap}"] = max(fx.mesh_merge_check(prog, parts, table),
                                         fx.mesh_merge_check(prog, parts, table, window, half,
                                                             cap))
    del parts, carry, window
    meshes = {g: pm.make_mesh([device] * MESH_SHARDS, groups=g) for g in (1, 2)}
    cold = {"q6": (fx.q6_dag(), [fx.q6_oracle(cold_arrays)]),
            "q1": (fx.q1_dag(), fx.q1_oracle(cold_arrays))}
    a10 = fx.build_arrays(FILTER_ROWS, SEED)
    want_topn = fx.topn_oracle(a10, TOPN_K)
    regions, enc_regions = bt["regions"], bt["enc_regions"]
    warm_sets = {"regions_64": regions, "regions_8_encoded": enc_regions, "lone_100m": [cache]}
    warm_wants = {"regions_64": bt["x_wants"],
                  "regions_8_encoded": {k: v[:len(enc_regions)] for k, v in bt["x_wants"].items()},
                  "lone_100m": {"q1": [want_batch["q1"]], "q6": [want_batch["q6"]]}}
    x_evs = {name: te.TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 17, device="cuda")
             for name, dag in (("q1", fx.q1_dag()), ("q6", fx.q6_dag()))}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def delta(before):
        return {k: fa.LAUNCHES[k] - before[k] for k in MESH_COUNTED}

    # the single-device cold answers and times, the yardstick of the cold mesh
    single_cold = {}
    for name, (dag, want) in cold.items():
        ev = te.TorchDagEvaluator(dag_to_wire(dag), block_rows=1 << 16, device="cuda")
        secs = []
        for _ in range(2):
            resp, s = timed_run(ev, FixtureScanSource(kvs), None)
            check_rows(resp, want, f"single-device cold {name}")
            secs.append(s)
        single_cold[name] = (resp.encode(), secs)

    # the single-device warm answers and times, the yardstick of the warm mesh
    single_warm = {}
    for label, caches in warm_sets.items():
        for name, ev in x_evs.items():
            secs = []
            for _ in range(3):
                got_one, s = timed(lambda: te.run_xregion_cached(ev, caches))
                secs.append(s)
            single_warm[label, name] = ([r.encode() for r in got_one], secs)

    # ---- the mesh main path: counts from 0 here to its end -------------------
    fa.reset_launches()
    out = {"cold": {}, "warm": {}, "topn": {}}
    for g, mesh in meshes.items():
        for name, (dag, want) in cold.items():
            for rps in MESH_COLD_RPS:
                runner = pm.MeshServingRunner(dag_to_wire(dag), mesh, rows_per_shard=rps)
                secs, before = [], dict(fa.LAUNCHES)
                for _ in range(2):
                    resp, s = timed(lambda: runner.run(FixtureScanSource(kvs)))
                    check_rows(resp, want, f"mesh cold {name} G={g} rps={rps}")
                    if resp.encode() != single_cold[name][0]:
                        raise AssertionError(f"mesh cold {name}: not the single-device bytes")
                    secs.append(s)
                out["cold"][f"{name}_g{g}_rps{rps}"] = {
                    "groups": g, "rows_per_shard": rps, "super_block_rows": runner.total_rows,
                    "capacity": runner.sharded.capacity, "seconds": secs,
                    "rows_per_s": len(kvs) / min(secs),
                    "single_device_seconds": single_cold[name][1],
                    "launches_per_request": {k: v / 2 for k, v in delta(before).items()}}
    mesh = meshes[1]
    for label, caches in warm_sets.items():
        for name, ev in x_evs.items():
            want = warm_wants[label][name]
            one_bytes, single = single_warm[label, name]
            mesh_s, before = [], dict(fa.LAUNCHES)
            for _ in range(4):  # the first run pins the slabs
                got, s = timed(lambda: te.launch_xregion_sharded(ev, caches, mesh).finalize())
                mesh_s.append(s)
                if len(got) != len(one_bytes):
                    raise AssertionError(f"mesh warm {label} {name}: {len(got)} responses")
                for j, (resp, one) in enumerate(zip(got, one_bytes)):
                    check_rows(resp, want[j], f"mesh warm {label} {name} region {j}")
                    if resp.encode() != one:
                        raise AssertionError(f"mesh warm {label} {name}: not the single bytes")
            out["warm"][f"{label}_{name}"] = {
                "regions": len(caches), "rows": sum(c.total_rows for c in caches),
                "slab_load": pm.device_slab_load(caches, mesh),
                "first_run_with_pins_s": mesh_s[0], "seconds": mesh_s[1:],
                "median_s": sorted(mesh_s[1:])[1],
                "single_device_seconds": single, "single_device_median_s": sorted(single)[1],
                "launches_per_batch": {k: v / 4 for k, v in delta(before).items()}}
        out["warm"][f"{label}_slab_bytes"] = slab_bytes(caches)
    topn = pm.ShardedTopNEvaluator(dag_to_wire(fx.topn_dag(TOPN_K)), mesh, MESH_TOPN_RPS)
    total = topn.total_rows
    blocks = [(fx.mesh_columns(a10, s, min(s + total, FILTER_ROWS)), min(total, FILTER_ROWS - s))
              for s in range(0, FILTER_ROWS, total)]
    step_s, fin_s, before = [], [], dict(fa.LAUNCHES)
    for _ in range(2):
        state, s = timed(lambda: topn.run_blocks(blocks))
        step_s.append(s)
        res, s = timed(lambda: topn.finalize(state))
        fin_s.append(s)
        if list(res["gidx"]) != [r[0] for r in want_topn] or \
                [[int(v) for v in vs] for vs in zip(*(p[0] for p in res["payload"]))] != \
                [[r[0], r[1], r[2][0], r[3][0], r[4]] for r in want_topn]:
            raise AssertionError("mesh raw TopN differs from the oracle")
    out["topn"] = {"rows": FILTER_ROWS, "k": TOPN_K, "rows_per_shard": MESH_TOPN_RPS,
                   "super_blocks": len(blocks), "step_seconds": step_s,
                   "finalize_seconds": fin_s,
                   "launches_per_request": {k: v / 2 for k, v in delta(before).items()}}
    mesh_launches = dict(fa.LAUNCHES)
    # ---- end of the mesh main path -------------------------------------------
    for k in MESH_KERNELS:
        if mesh_launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the mesh main path")
    if mesh_launches["fused_group_agg_combine_pack"] != 0:
        raise AssertionError("the grouped combine launched on the mesh main path")
    # programs #18 and #19 at the phase's shapes: one shard's step (its
    # first super-block's 131,072 rows) and the finalize over the 8 runs
    pay = pm._shard_images(topn.shard_devices, MESH_TOPN_RPS,
                           [blocks[0][0][i][0] for i in topn.payload_cols], topn._pay_f64,
                           [None] * len(topn.payload_cols), blocks[0][1], 0)[0]
    pay.n_valids = torch.tensor([pay.n_valids], dtype=torch.int64, device=pay.device)
    check_topn_kernels(ft, fx, topn.prog, pay.pick(topn.ev.plan.device_cols), pay,
                       "a mesh shard")
    t_topn = {"step_shard": time_topn(ft, topn.prog, pay.pick(topn.ev.plan.device_cols), pay,
                                      carried=True),
              "finalize": time_topn_finalize(ft, topn, state)}
    del blocks, pay
    # mesh_merge at its main-path inputs: Q1 over the 64 regions and the
    # 100M image alone; each against its plain version, then timed
    from tikv_tpu_torch.copr import fused_group_agg as ga

    q1 = dag_to_wire(fx.q1_dag())
    cases = {
        "xregion_q1_64": capture_merge(fme, lambda: te.launch_xregion_sharded(
            x_evs["q1"], regions, mesh)),
        "lone_100m_q1": capture_merge(fme, lambda: te.launch_xregion_sharded(
            x_evs["q1"], [cache], mesh))}
    t_merge = {}
    for key, case in cases.items():
        errs[key] = fx.mesh_merge_check(*case)
        t_merge[key] = time_merge(fme, case, 50)
    # mesh_fold at its main-path inputs: cold Q1's second super-block (a
    # carry) at 1,024 rows a shard, G = 1 (8 shards, a partial row each) and
    # G = 2 (4 shards, two windows), and at 65,536 rows a shard (64 rows
    # each); against its plain version and the combines and merges it
    # replaces, then timed beside them
    fold_cases = {
        f"cold_q1_g{g}_rps{rps}": capture_fold(fme, pm, lambda g=g, rps=rps: pm.MeshServingRunner(
            q1, meshes[g], rows_per_shard=rps).run(FixtureScanSource(kvs)))
        for g, rps in ((1, MESH_COLD_RPS[0]), (2, MESH_COLD_RPS[0]), (1, MESH_COLD_RPS[1]))}
    fold_errs, t_fold = {}, {}
    for key, case in fold_cases.items():
        fold_errs[key] = check_fold(fx, case)
        t_fold[key] = time_fold(fme, ga, case, 50)
    # the grouped pair at the cold mesh's 1,024-row shards (cold Q1, G = 1:
    # 984 partials launches a request), at a shard of its second super-block
    small = fold_cases["cold_q1_g1_rps1024"]
    t_small_shard = time_group_kernels(ga, small["prog"], small["images"][0],
                                       small["rows"].shape[2], 50)
    del fold_cases, small
    fold_attrs = no_local_memory("mesh_fold", [fme.fold_attributes()])
    # one cold Q1 super-block at 1,024 rows a shard (G = 1) by host step
    runner = pm.MeshServingRunner(q1, meshes[1], rows_per_shard=MESH_COLD_RPS[0])
    split_ev, split_args = capture_step(runner, lambda: runner.run(FixtureScanSource(kvs)))
    t_split = mesh_step_split(pm, split_ev, split_args)
    del split_args
    # the per-device batch kernels of #20: the busiest device's tasks, held
    # to their plain versions, then timed
    t_dev, dev_checks = {}, {}
    for label in ("regions_64", "lone_100m"):
        device_tasks = pm.xshard_tasks(x_evs["q1"], warm_sets[label], mesh)[0]
        _pos, tasks = max(device_tasks, key=lambda dt: sum(t.img.n_blocks for t in dt[1]))
        dev_checks[label] = fx.batch_kernel_check(tasks)
        t_dev[label] = time_batch(fb, tasks, 10)
    for key, results in out.items():
        same = {} if key == "topn" else {"byte_identical_to_single_device": True}
        emit({"phase": "mesh", "case": key, "card": card, "matches_oracle": True, **same,
              "results": results})
    emit({"phase": "mesh", "case": "kernels", "card": card, "shards": MESH_SHARDS,
          "mesh_merge_checks": errs, "int_words_equal": True, "f64_rel_tol": REL_TOL,
          "bit_identical_reruns": True, "mesh_merge": t_merge,
          "mesh_fold_checks": fold_errs, "mesh_fold_equals_the_pair_bit_for_bit": True,
          "mesh_fold": t_fold, "mesh_fold_attributes": fold_attrs,
          "cold_q1_super_block_split_ms": t_split, "per_device_batch": t_dev,
          "per_device_batch_checks": dev_checks, "topn_shard_check": "equal", "topn": t_topn,
          "grouped_pair_1024_row_shard": t_small_shard, "launches": mesh_launches,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"launches": mesh_launches, "merge": t_merge, "max_abs_err": max(errs.values()),
            "fold": t_fold, "fold_err": max(fold_errs.values()), "fold_attributes": fold_attrs,
            "split": t_split, "per_device": t_dev, "topn": t_topn,
            "small_shard": t_small_shard}


# ---------------------------------------------------------------------------
# phase mesh_grouped: program #17, the group dictionary built on the card
# ---------------------------------------------------------------------------

MESH_GROUPED_ROWS = 10_000_000  # about ten ~96 MB lineitem regions
MESH_GROUPED_RPS = 1 << 17  # eight shards: super-blocks of 1,048,576 rows
MESH_GROUPED_CPU_ROWS = 1 << 20  # held to the same evaluator on eight CPU shards
DICT_SRC = "tikv_tpu_torch/csrc/fused_dict.cu"
DICT_KERNELS = ("dict_keys", "dict_union", "dict_ids")
MESH_GROUPED_KERNELS = DICT_KERNELS + ("mesh_fold", "fused_group_agg_partials")
# counted too, and must not launch at these capacities: the grouped combine
# and the packed merge
MESH_GROUPED_COUNTED = MESH_GROUPED_KERNELS + ("fused_group_agg_combine_pack", "mesh_merge")
# (case, GROUP BY, capacity, groups, key_bits, the flag word it must end with:
# 1 a value past its lane, 2 more keys than slots)
MESH_GROUPED_CASES = (
    ("q1_g1", ("rf", "ls"), 64, 1, 31, 0),
    ("q1_g2", ("rf", "ls"), 64, 2, 31, 0),
    ("qty", ("qty",), 64, 1, 31, 0),
    ("qty_ls", ("qty", "ls"), 128, 1, 31, 0),
    ("qty_cap8", ("qty",), 8, 1, 31, 2),
    ("qty_5bit", ("qty",), 64, 1, 5, 1),
)


def same_unpacked(a, b) -> bool:
    """Two unpacked grouped states ``(dict, first, carries, overflow)`` bit
    for bit (f64 leaves by their bits)."""
    def bits(x):
        x = np.asarray(x)
        return x.view(np.int64) if x.dtype == np.float64 else x

    leaves_a = [leaf for agg in a[2] for leaf in agg]
    leaves_b = [leaf for agg in b[2] for leaf in agg]
    return (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[3] == b[3]
            and len(leaves_a) == len(leaves_b)
            and all(np.array_equal(bits(x), bits(y)) for x, y in zip(leaves_a, leaves_b)))


def check_unpacked(got, want, what: str) -> float:
    """The card's unpacked grouped state against the CPU's: dictionary,
    first rows, flag and integer leaves equal, f64 leaves to rel 1e-12.
    Returns the largest absolute f64 difference."""
    if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            and got[3] == want[3]):
        raise AssertionError(f"{what}: dictionary, first rows or flag differ from the CPU's")
    err = 0.0
    for g_agg, w_agg in zip(got[2], want[2]):
        for g, w in zip(g_agg, w_agg):
            if np.asarray(w).dtype == np.float64:
                err = max(err, compare_f64(torch.from_numpy(g), torch.from_numpy(w), what))
            elif not np.array_equal(g, w):
                raise AssertionError(f"{what}: an integer leaf differs from the CPU's")
    return err


def capture_dict(fd_mod, run) -> dict:
    """The inputs of the first ``dict_keys``, shard union (with the carried
    dictionary), global union and ``dict_ids`` (with the old dictionary)
    calls that ``run`` makes: the main path's own shapes and values."""
    seen = {}
    fns = {n: getattr(fd_mod, n) for n in DICT_KERNELS}

    def keys(prog, img, flag):
        seen.setdefault("dict_keys", (prog, img))
        return fns["dict_keys"](prog, img, flag)

    def union(d, k, cap, flag, out=None):
        seen.setdefault("dict_union" if d is not None else "dict_union_global", (d, k, cap))
        return fns["dict_union"](d, k, cap, flag, out)

    def ids(new, k, gids, old=None, perm=None):
        if old is not None:
            seen.setdefault("dict_ids", (new, k, old))
        return fns["dict_ids"](new, k, gids, old, perm)

    for n, fn in (("dict_keys", keys), ("dict_union", union), ("dict_ids", ids)):
        setattr(fd_mod, n, fn)
    try:
        run()
    finally:
        for n, fn in fns.items():
            setattr(fd_mod, n, fn)
    return seen


def time_dict(fx, fd, seen: dict) -> dict:
    """Each dictionary kernel at its captured main-path inputs: its output
    against its plain version on CPU copies (equal, integers), then its
    CUDA-event ms, the plain version's ms on the same tensors, the torch
    yardstick's (``torch.unique`` of the concatenation, cut to ``cap``;
    ``torch.searchsorted``) and the bound: each input read once and each
    output written once (the key kernel: the columns its walk reads)."""
    out = {}
    prog, img = seen["dict_keys"]
    dev = img.device
    rows = img.n_blocks * img.block_rows
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    keys = torch.empty(rows, dtype=torch.int64, device=dev)
    fd.launch_keys(prog, img, keys, flag)
    want, _bad = fd.dict_keys_plain(prog, fx.image_on(img, "cpu"))
    if not torch.equal(keys.cpu(), want):
        raise AssertionError("dict_keys: differs from its plain version at the path's shape")
    b_ms, b_by = bound(image_bytes(img, rows) + rows * 8, rows * len(prog.code))
    attrs = no_local_memory("dict_keys", [fd.keys_attributes(s) for s in (2, 4, 8)])
    out["dict_keys"] = {
        "rows": rows, "columns": len(img.cols), "rows_a_thread": fd.KEY_ROWS,
        "stack_slots": fd.key_slots(prog),
        "attributes": {a["stackSlots"]: a for a in attrs},
        "ms": cuda_ms(lambda: fd.launch_keys(prog, img, keys, flag), 50),
        "plain_ms": cuda_ms(lambda: fd.dict_keys_plain(prog, img), 3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    for name in ("dict_union", "dict_union_global"):
        d, k, cap = seen[name]
        res = torch.empty(cap, dtype=torch.int64, device=dev)
        fd.launch_union(d, k, cap, flag, res)
        want, _over = fd.dict_union_plain(None if d is None else d.cpu(), k.cpu(), cap)
        if not torch.equal(res.cpu(), want):
            raise AssertionError(f"{name}: differs from its plain version at the path's shape")
        n = k.numel() + (0 if d is None else cap)
        b_ms, b_by = bound(n * 8 + cap * 8, n)
        out[name] = {
            "keys": n, "capacity": cap, "launches": fd.union_launches(n, cap),
            "tile": fd.union_tile(cap), "passes": len(fd.union_passes(n, cap)),
            "ms": cuda_ms(lambda: fd.launch_union(d, k, cap, flag, res), 50),
            "plain_ms": cuda_ms(lambda: fd.dict_union_plain(d, k, cap), 3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lambda: torch.unique(torch.cat([d, k]) if d is not None
                                                       else k, sorted=True)[:cap], 10)}
    new, k, old = seen["dict_ids"]
    out["dict_ids"] = time_ids(fd, new, k, old, 50)
    return out


def time_ids(fd, new, k, old, iters: int) -> dict:
    """``dict_ids`` at the main path's inputs (the new dictionary, the
    keys, the old dictionary): ids and perm against its plain version on CPU
    copies (equal), the instance's attributes (no local bytes), its
    CUDA-event ms with the old dictionary and without it (the ids alone),
    the plain version's ms, the bound (each input read once, each output
    written once; a search step a key and a slot) and two yardsticks:
    ``torch.searchsorted`` of the keys (the ids alone) and of the keys and
    the old dictionary (the kernel's whole function)."""
    dev = k.device
    cap, n = new.numel(), k.numel()
    gids = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty(cap, dtype=torch.int32, device=dev)
    fd.launch_ids(new, k, gids, old, perm)
    want_ids, want_perm = fd.dict_ids_plain(new.cpu(), k.cpu(), old.cpu())
    if not (torch.equal(gids.cpu(), want_ids) and torch.equal(perm.cpu(), want_perm)):
        raise AssertionError(f"dict_ids at {cap} slots: differs from its plain version")
    attrs = fd.ids_attributes(cap)
    if attrs["localSizeBytes"] != 0:
        raise AssertionError(f"dict_ids spills: {attrs}")
    b_ms, b_by = bound(cap * 8 + n * 8 + n * 4 + cap * 12, (n + cap) * max(1, cap.bit_length()))
    return {
        "keys": n, "capacity": cap, "attributes": attrs,
        "ms": cuda_ms(lambda: fd.launch_ids(new, k, gids, old, perm), iters),
        "ms_without_old": cuda_ms(lambda: fd.launch_ids(new, k, gids), iters),
        "plain_ms": cuda_ms(lambda: fd.dict_ids_plain(new, k, old), 3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.searchsorted(new, k), iters),
        "library": "torch.searchsorted of the keys in the new dictionary",
        "library_with_perm_ms": cuda_ms(lambda: (torch.searchsorted(new, k),
                                                 torch.searchsorted(new, old)), iters)}


def phase_mesh_grouped(fx, card: str, device) -> dict:
    """Program #17 on ``make_mesh(["cuda:0"] * 8, groups)``: the main path
    (counted from 0) runs every case of :data:`MESH_GROUPED_CASES` twice
    over 10,000,000 lineitem rows (super-blocks of 8 x 131,072 rows, the
    last one partial) through ``ShardedGroupedEvaluator``; each answer
    against its numpy oracle, or its overflow flag; the two runs bit for
    bit; the first 1,048,576 rows against the same evaluator on eight CPU
    shards; then each dictionary kernel and ``mesh_fold`` with the carry
    remap at the path's inputs against its plain version (the fold also
    against the combines and ``mesh_merge`` it replaces), timed."""
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import fused_mesh as fme
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    n = MESH_GROUPED_ROWS
    a = fx.build_arrays(n, SEED)
    oracles = {keys: fx.grouped_oracle(a, keys) for keys in {c[1] for c in MESH_GROUPED_CASES}}
    meshes = {g: pm.make_mesh([device] * MESH_SHARDS, groups=g) for g in (1, 2)}
    evs, blocks = {}, {}
    for name, keys, cap, g, bits, _flag in MESH_GROUPED_CASES:
        ev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.grouped_dag(keys)), meshes[g],
                                        MESH_GROUPED_RPS, capacity=cap, key_bits=bits)
        total = ev.total_rows
        if total not in blocks:
            blocks[total] = [(fx.grouped_columns(a, s, min(s + total, n)), min(total, n - s))
                             for s in range(0, n, total)]
        evs[name] = ev
    t_setup = time.perf_counter() - t_phase

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # ---- the main path: counts from 0 here to its end ------------------------
    fa.reset_launches()
    results = {}
    for name, keys, cap, g, bits, want_flag in MESH_GROUPED_CASES:
        ev = evs[name]
        bl = blocks[ev.total_rows]
        runs, step_s, request_s, before = [], [], [], dict(fa.LAUNCHES)
        for _ in range(2):
            t0 = time.perf_counter()
            state, s = timed(lambda: ev.run_blocks(bl))
            runs.append(ev.unpack(state))
            fin = ev.finalize(state)
            request_s.append(time.perf_counter() - t0)
            step_s.append(s)
            word = int(state[2].item())
            if word != want_flag:
                raise AssertionError(f"mesh_grouped {name}: flag {word}, want {want_flag}")
            if not want_flag:
                want = oracles[keys]
                if not (np.array_equal(fin["keys"], want["keys"])
                        and np.array_equal(fin["first"], want["first"])
                        and all(np.array_equal(x, y) for ga_, wa in zip(fin["aggs"], want["aggs"])
                                for x, y in zip(ga_, wa))):
                    raise AssertionError(f"mesh_grouped {name}: differs from the oracle")
        if not same_unpacked(*runs):
            raise AssertionError(f"mesh_grouped {name}: two runs differ")
        results[name] = {
            "group_by": list(keys), "capacity": cap, "groups": g, "key_bits": bits,
            "flag": want_flag, "live_groups": int((runs[0][0] < fd.SENTINEL).sum()),
            "super_blocks": len(bl), "super_block_rows": ev.total_rows,
            "request_s": request_s, "step_s": step_s,
            "s_per_super_block": min(step_s) / len(bl),
            "launches_per_request": {k: (fa.LAUNCHES[k] - before[k]) / 2
                                     for k in MESH_GROUPED_COUNTED}}
    launches = dict(fa.LAUNCHES)
    # ---- end of the main path ----------------------------------------------------
    for k in MESH_GROUPED_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the mesh_grouped main path")
    for k in MESH_GROUPED_COUNTED[len(MESH_GROUPED_KERNELS):]:
        if launches[k] != 0:
            raise AssertionError(f"kernel {k} launched on the mesh_grouped main path")
    # the first 1,048,576 rows on the card against eight CPU shards
    cpu_err, t_cpu = {}, time.perf_counter()
    for name in ("q1_g1", "q1_g2", "qty_ls"):
        ev = evs[name]
        head = blocks[ev.total_rows][: MESH_GROUPED_CPU_ROWS // ev.total_rows]
        cpu = pm.ShardedGroupedEvaluator(
            dag_to_wire(fx.grouped_dag(results[name]["group_by"])),
            pm.make_mesh(["cpu"] * MESH_SHARDS, groups=results[name]["groups"]),
            MESH_GROUPED_RPS, capacity=ev.capacity, key_bits=ev.key_bits)
        cpu_err[name] = check_unpacked(ev.unpack(ev.run_blocks(head)),
                                       cpu.unpack(cpu.run_blocks(head)), f"mesh_grouped {name}")
    t_cpu = time.perf_counter() - t_cpu
    # dict_union at its edges (both routes, every tile), against its plain
    # version, twice bit for bit
    union_edges = {}
    for name in fx.UNION_EDGE_CASES:
        d, k, cap = fx.union_edge_case(name, SEED)
        union_edges[name] = fx.union_kernel_check(d, k, cap, device)
    # dict_keys at its edges (ragged tiles, every instance, NULL, NaN and
    # infinite keys, encoded columns, the range flag set and clear)
    key_edges = {}
    for name in fx.KEY_EDGE_CASES:
        key_edges[name] = fx.keys_kernel_check(*fx.key_edge_case(name, device, SEED))
    # dict_ids at its edges: in shared memory and past it (the grouped
    # mesh's 32,768 slots, the global union's 262,144), every old dictionary
    ids_edges = {}
    for cap in (64, 8193, 32768, 262_144):
        for kind in fx.IDS_OLD:
            ids_edges[f"{cap}_{kind}"] = fx.ids_kernel_check(
                *fx.ids_case(cap, 100_003, kind, SEED + cap, device))
    # the kernels at the path's own inputs: Q1 at G = 1, its second
    # super-block (a carried dictionary, a carry to move)
    q1 = evs["q1_g1"]
    two = blocks[q1.total_rows][:2]
    state = q1.step(*_block_args(q1, two[0]), q1.init_state())
    seen = capture_dict(fd, lambda: q1.step(*_block_args(q1, two[1]), state,
                                            block_base=q1.total_rows))
    t_dict = time_dict(fx, fd, seen)
    from tikv_tpu_torch.copr import fused_group_agg as ga

    state = q1.step(*_block_args(q1, two[0]), q1.init_state())
    fold_case = capture_fold(fme, pm, lambda: q1.step(*_block_args(q1, two[1]), state,
                                                      block_base=q1.total_rows), which=0)
    fold_err = check_fold(fx, fold_case)
    t_fold = time_fold(fme, ga, fold_case, 50)
    del fold_case
    # the grouped pair alone at a shard's shape (131,072 rows, Q1 at 64 slots)
    _res, calls = capture_calls(pm, "_shard_rows", lambda: q1.step(
        *_block_args(q1, two[1]), state, block_base=q1.total_rows))
    sprog, simages, scap, _lead = calls[0]
    t_pair = time_group_kernels(ga, sprog, simages[0], scap, 50)
    emit({"phase": "mesh_grouped", "card": card, "rows": n, "shards": MESH_SHARDS,
          "rows_per_shard": MESH_GROUPED_RPS, "matches_oracle": True,
          "bit_identical_reruns": True, "cases": results})
    emit({"phase": "mesh_grouped", "case": "kernels", "card": card,
          "cpu_rows": MESH_GROUPED_CPU_ROWS, "cpu_check_max_abs_err": cpu_err,
          "cpu_check_seconds": t_cpu, "int_words_equal": True, "f64_rel_tol": REL_TOL,
          "kernels": t_dict, "mesh_fold_remap": t_fold, "grouped_pair_shard": t_pair,
          "union_edges": union_edges, "ids_edges": ids_edges, "key_edges": key_edges,
          "launches": launches,
          "setup_seconds": t_setup, "phase_seconds": time.perf_counter() - t_phase})
    return {"launches": launches, "kernels": t_dict, "fold": t_fold, "pair": t_pair,
            "max_abs_err": max([fold_err, *cpu_err.values()])}


# ---------------------------------------------------------------------------
# phase high_capacity: group slots past the shared-memory rows
# ---------------------------------------------------------------------------

HC_COLD_ROWS = COLD_ROWS  # SF 1: 10,000 suppliers
HC_MESH_ROWS = MESH_GROUPED_ROWS  # SF 1.67: 16,664 suppliers
HC_MESH_CAP = 32768
WIDE_KERNELS = ("group_wide_partials", "group_wide_combine")
SORT_KERNELS = ("dict_merge", "dict_compact")
HC_KERNELS = WIDE_KERNELS + SORT_KERNELS + DICT_KERNELS + ("mesh_merge",) + BATCH_KERNELS


def check_rows_close(resp, want, what: str) -> None:
    """Response rows against oracle rows: every value equal, floats to
    REL_TOL."""
    got = resp.iter_rows()
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} rows, oracle {len(want)}")
    for g_row, w_row in zip(got, want):
        ok = len(g_row) == len(w_row) and all(
            (abs(x - y) <= REL_TOL * abs(y)) if isinstance(y, float) else x == y
            for x, y in zip(g_row, w_row))
        if not ok:
            raise AssertionError(f"{what}: {g_row} != oracle {w_row}")


def capture_calls(mod, name: str, run):
    """``run()``'s result and the arguments of every call of ``mod.name``
    that it makes, in order."""
    seen = []
    fn = getattr(mod, name)

    def record(*args, **kw):
        seen.append(args)
        return fn(*args, **kw)

    setattr(mod, name, record)
    try:
        res = run()
    finally:
        setattr(mod, name, fn)
    return res, seen


def time_wide_kernels(ga, fx, prog, img, cap: int, iters: int) -> dict:
    """The grouped pair's wide route at one image: held to its plain
    versions (``fx.wide_kernel_check``: the state word for word, the combine
    bit for bit, the pair to REL_TOL, two runs bit-identical), then
    CUDA-event ms per launch of both kernels and of the state's set-up
    (zeros and identities, torch ops), the plain versions' ms, the bounds
    (partials: the image's shipped bytes and host ids read once, ``L * C * 8``
    written; combine: the state read once, the packed state written once)
    and the yardsticks over the same rows (every row, no filter): an f64
    sum by ``index_add_``, min and max by ``scatter_reduce_``."""
    errs = fx.wide_kernel_check(prog, img, cap)
    state = ga.new_partials(prog, img, cap)
    out = ga.init_packed(prog, cap, img.device)
    p_ms = cuda_ms(lambda: ga.launch_partials(prog, img, cap, state), iters)
    c_ms = cuda_ms(lambda: ga.launch_combine(prog, img, cap, state, None, out), iters)
    init_ms = cuda_ms(lambda: ga.new_partials(prog, img, cap), iters)
    pp_ms = cuda_ms(lambda: ga.wide_partials_plain(prog, img, cap), 2, warmup=1)
    cp_ms = cuda_ms(lambda: ga.wide_combine_plain(prog, img, cap, state), 2, warmup=1)
    nv = img.n_valids
    rows = int(nv if isinstance(nv, int) else nv.sum())
    L = len(prog.leaves)
    read = image_bytes(img, rows) + (4 * rows if img.gids is not None else 0)
    p_bound, p_by = bound(read + 16 * img.n_blocks + L * cap * 8, rows * (len(prog.code) + L))
    c_bound, c_by = bound(state.numel() * 8 + (prog.n_int + prog.n_f64) * cap * 8, state.numel())
    lib = {}
    if img.gids is not None:
        gid = img.gids.reshape(-1).long()
        x = img.cols[0].reshape(-1).double()
        acc = torch.zeros(cap, dtype=torch.float64, device=img.device)
        lib["index_add_f64_sum_ms"] = cuda_ms(lambda: torch.zeros_like(acc).index_add_(0, gid, x),
                                              iters)
        for op in ("amin", "amax"):
            lib[f"scatter_reduce_{op}_ms"] = cuda_ms(
                lambda op=op: torch.zeros_like(acc).scatter_reduce_(0, gid, x, op), iters)
        del gid, x
    attrs = no_local_memory("group_wide_partials",
                            [ga.partials_attributes(ga.partials_slots(prog), wide=True)])[0]
    c_attrs = no_local_memory("group_wide_combine",
                              [ga.combine_attributes(ga.partials_slots(prog), wide=True)])[0]
    return {"rows": rows, "capacity": cap, "leaves": L, "c_max": prog.c_max,
            "x_leaves": len(prog.x_leaves), "state_words": state.numel(), "attributes": attrs,
            "combine_attributes": c_attrs,
            "partials_ms": p_ms, "partials_bound_ms": p_bound, "partials_bound_by": p_by,
            "partials_plain_ms": pp_ms, "combine_ms": c_ms, "combine_bound_ms": c_bound,
            "combine_bound_by": c_by, "combine_plain_ms": cp_ms, "state_init_ms": init_ms,
            "library": lib, "library_ms": lib.get("index_add_f64_sum_ms"),
            "max_abs_err": errs["pair"]}


def time_sort_union(fd, fx, d, k, cap: int) -> dict:
    """The dictionary union's sort route (past ``fd.CAP_MAX`` slots) at one
    input, kernel by kernel: the tile sort (``dict_union`` at ``T = cap =
    SORT_TILE``), the ``dict_merge`` stage (every level of ``merge_plan``,
    each held to its plain version by ``fx.sort_route_levels``) and
    ``dict_compact`` (one launch: the first cap distinct keys and the flag,
    0 local bytes); its output and flag against ``compact_plain``, two runs
    bit for bit, and the whole union against ``dict_union_plain``;
    CUDA-event ms, the plain versions' ms, bounds (each input read once,
    each output written once) and yardsticks: ``torch.sort`` of the tiles
    for the merge stage (it computes more: a full sort),
    ``torch.unique_consecutive`` for the compaction."""
    lib = fd.kernels()
    dev = k.device
    n_d = 0 if d is None else cap
    n = n_d + k.numel()
    sorted_n = fd.sorted_keys(n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    dp = None if d is None else d.data_ptr()

    def ok(rc):
        if rc != 0:
            raise RuntimeError(f"sort-route launch failed: cudaError {rc}")

    lv = fx.sort_route_levels(None if d is None else d.cpu(), k.cpu(), dev)
    runs, final, plan, live = lv["tiles"], lv["sorted"], lv["plan"], lv["live"]
    tile_ms = cuda_ms(lambda: ok(lib.du_launch(dp, n_d, k.data_ptr(), k.numel(), runs.data_ptr(),
                                               flag.data_ptr(), fd.SORT_TILE, fd.SORT_TILE,
                                               live.data_ptr(), stream)), 20)
    out = {"keys": n, "capacity": cap, "sorted_keys": sorted_n, "merge_levels": len(plan),
           "merge_plan": plan, "sort_tile": fd.SORT_TILE, "tile_sort_ms": tile_ms,
           "tile_sort_blocks": sorted_n // fd.SORT_TILE}
    if plan:
        bufs = [torch.empty_like(runs) for _ in range(2)]

        def stage():
            src = runs
            for i, (w, f) in enumerate(plan):
                ok(lib.dm_launch(src.data_ptr(), sorted_n, w, f, live.data_ptr(),
                                 bufs[i % 2].data_ptr(), stream))
                src = bufs[i % 2]

        def plain_stage():
            s = runs
            for w, f in plan:
                s = fd.merge_pass_plain(s, w, f)
            return s

        b_ms, b_by = bound(sorted_n * 16, sorted_n * len(plan))
        attrs = fd.merge_attributes()
        if attrs["localSizeBytes"] != 0:
            raise AssertionError(f"dict_merge spills to local memory: {attrs}")
        out["dict_merge"] = {
            "launches": len(plan), "plan": plan, "ms": cuda_ms(stage, 20),
            "levels_ms": [cuda_ms(lambda s=s, w=w, f=f: ok(lib.dm_launch(
                s.data_ptr(), sorted_n, w, f, live.data_ptr(), bufs[0].data_ptr(), stream)), 20)
                for w, f, s, _o in lv["levels"]],
            "plain_ms": cuda_ms(plain_stage, 2, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "attributes": attrs,
            "library_ms": cuda_ms(lambda: torch.sort(runs), 10)}
    res = torch.empty(cap, dtype=torch.int64, device=dev)
    scratch = fd.compact_scratch(dev, sorted_n)

    def compact():
        ok(lib.dc_launch_compact(final.data_ptr(), sorted_n, res.data_ptr(), flag.data_ptr(), cap,
                                 scratch.data_ptr(), stream))

    want_c, over_c = fd.compact_plain(final.cpu(), cap)
    got = []
    for _ in range(2):
        flag.zero_()
        compact()
        got.append((res.cpu(), int(flag.cpu())))
    if not (torch.equal(got[0][0], got[1][0]) and got[0][1] == got[1][1]):
        raise AssertionError("dict_compact: two runs differ")
    if not torch.equal(got[0][0], want_c) \
            or got[0][1] != (fd.FLAG_CAPACITY if over_c else 0):
        raise AssertionError("dict_compact: differs from its plain version")
    want, _over = fd.dict_union_plain(None if d is None else d.cpu(), k.cpu(), cap)
    if not torch.equal(got[0][0], want):
        raise AssertionError("sort-route union: differs from dict_union_plain")
    attrs = no_local_memory("dict_compact", [fd.compact_attributes()])[0]
    b_ms, b_by = bound(sorted_n * 8 + cap * 8, sorted_n)
    out["dict_compact"] = {
        "ms": cuda_ms(compact, 20), "blocks": fd.compact_tiles(sorted_n), "attributes": attrs,
        "plain_ms": cuda_ms(lambda: fd.compact_plain(final, cap), 2, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms(lambda: torch.unique_consecutive(final)[:cap], 10)}
    out["union_ms"] = cuda_ms(lambda: fd.launch_union(d, k, cap, flag, res), 10)
    out["union_library_ms"] = cuda_ms(
        lambda: torch.unique(torch.cat([d, k]) if d is not None else k, sorted=True)[:cap], 10)
    return out


def phase_high_capacity(fx, card: str, device, n_warm: int, want_batch: dict) -> dict:
    """Group slots past the grouped pair's shared-memory rows (its wide
    route, ``group_wide_partials`` + ``group_wide_combine``) and a device
    dictionary past 8,192 slots (the union's sort route), on the
    per-supplier statistics query (``fx.supp_dag``: TPC-H Q15's revenue
    window, GROUP BY l_suppkey, var_pop's f64 sum of squares).  The main
    path, counted from 0: cold over 1,000,000 KV rows (SF 1, host ids,
    10,000 suppliers: the capacity doubles past ``c_max`` block by block),
    twice; the DOUBLE price's first/min/max/sum/var_pop per supplier cold,
    twice; warm over the ``n_warm``-row image (about 166,000 suppliers at
    100M rows, host ids, 262,144 slots), the pinning run and one more; a
    same-region batch over that image with Q1 grouped by the four flag
    columns (480 coded slots, past a task's rows), integer and with f64
    leaves, beside batch A's eight riders, the wide riders against the same
    requests one by one; ``ShardedGroupedEvaluator`` on eight shards of the card over
    10,000,000 rows at 32,768 slots, twice.  Every answer against its numpy
    oracle, the reruns bit for bit (bytes).  Then the new kernels against
    their plain versions at the path's inputs and timed, beside the same
    image at ``c_max`` slots on the shared rows, the same ids on the wide
    route at ``c_max + 1`` and the library yardsticks; the wide route at a
    shard of the mesh's first super-block."""
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr import torch_eval as te
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.parallel import mesh as pm

    t_phase = time.perf_counter()
    kvs = fx.supp_kvs(HC_COLD_ROWS, SEED)
    a_cold = fx.supp_arrays(HC_COLD_ROWS, SEED)
    a = fx.supp_arrays(n_warm, SEED)
    br = 1 << 17
    cache = fx.supp_cache(n_warm, br, SEED, arrays=a)
    wants = oracles_at_once({"cold": lambda: fx.supp_oracle(a_cold),
                             "first": lambda: fx.supp_first_oracle(a_cold),
                             "warm": lambda: fx.supp_oracle(a),
                             "flags4": lambda: fx.flags4_oracle(a),
                             "flags4_f64": lambda: fx.flags4_oracle(a, True)})
    want_cold, want_first, want_warm = wants["cold"], wants["first"], wants["warm"]
    batch_dags = [("flags4", fx.flags4_dag(), None), ("flags4_f64", fx.flags4_dag(var_pop=True),
                                                       None)] + fx.batch_plans()
    # batch A's oracles over the same draws come from the batch phase
    wants_b = [wants["flags4"], wants["flags4_f64"]] + [
        want_batch[n] for n, _d, _o in batch_dags[2:]]
    del a
    a_mesh = fx.supp_arrays(HC_MESH_ROWS, SEED)
    want_mesh = fx.supp_mesh_oracle(a_mesh)
    mesh = pm.make_mesh([device] * MESH_SHARDS, groups=1)
    mev = pm.ShardedGroupedEvaluator(dag_to_wire(fx.supp_dag()), mesh, MESH_GROUPED_RPS,
                                     capacity=HC_MESH_CAP)
    total = mev.total_rows
    mblocks = [(fx.supp_columns(a_mesh, s, min(s + total, HC_MESH_ROWS), total),
                min(total, HC_MESH_ROWS - s)) for s in range(0, HC_MESH_ROWS, total)]
    supp_wire, first_wire = dag_to_wire(fx.supp_dag()), dag_to_wire(fx.supp_first_dag())
    t_setup = time.perf_counter() - t_phase

    # ---- the main path: counts from 0 here to its end ------------------------
    fa.reset_launches()
    cold = {}
    for name, wire, want in (("supp", supp_wire, want_cold), ("first_double", first_wire,
                                                               want_first)):
        ev = te.TorchDagEvaluator(wire, block_rows=1 << 16, device="cuda")
        secs, enc = [], []
        for _ in range(2):
            resp, sec = timed_run(ev, FixtureScanSource(kvs), None)
            check_rows_close(resp, want, f"high_capacity cold {name}")
            secs.append(sec)
            enc.append(resp.encode())
        if enc[0] != enc[1]:
            raise AssertionError(f"high_capacity cold {name}: two runs differ")
        cold[name] = {"rows": HC_COLD_ROWS, "suppliers": fx.suppliers(HC_COLD_ROWS),
                      "groups": len(want), "seconds": secs, "rows_per_s": HC_COLD_ROWS / min(secs),
                      "c_max": ev.plan.group_program.c_max}
    ev_w = te.TorchDagEvaluator(supp_wire, block_rows=br, device="cuda")
    ev_w.route_hint = "unary"
    warm_s, enc = [], []
    for run in range(2):  # host ids take seconds a query at 100M rows
        if run == 0:  # the grouped pair's inputs, kept for the checks below
            (resp, sec), wide_in = capture_calls(
                te, "fused_group_agg", lambda: timed_run(ev_w, None, cache))
        else:
            resp, sec = timed_run(ev_w, None, cache)
        check_rows_close(resp, want_warm, "high_capacity warm")
        warm_s.append(sec)
        enc.append(resp.encode())
    if len(set(enc)) != 1:
        raise AssertionError("high_capacity warm: runs differ")
    evs_b = [te.TorchDagEvaluator(dag_to_wire(d), block_rows=br, device="cuda")
             for _n, d, _o in batch_dags]
    for ev in evs_b:
        ev.route_hint = "unary"
    batch_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = te.run_batch_cached(evs_b, cache)
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
    for (name, _d, _o), resp, want in zip(batch_dags, got, wants_b):
        check_rows_close(resp, want, f"high_capacity batch {name}")
    mesh_s, mruns = [], []
    for _ in range(2):
        state, sec = timed_call(lambda: mev.run_blocks(mblocks))
        mesh_s.append(sec)
        mruns.append(mev.unpack(state))
        fin = mev.finalize(state)
    launches = dict(fa.LAUNCHES)
    # ---- end of the main path ----------------------------------------------------
    # the wide riders also alone, past the counts (batch A's eight ride their
    # alone runs in phase batch)
    alone_s = 0.0
    for (name, _d, _o), ev, resp in zip(batch_dags, evs_b, got):
        if name.startswith("flags4"):
            one, sec = timed_run(ev, None, cache)
            alone_s += sec
            if one.encode() != resp.encode():
                raise AssertionError(f"high_capacity batch {name}: differs from the request alone")
    for k in HC_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched on the high_capacity main path")
    if fin["overflow"] or not same_unpacked(*mruns):
        raise AssertionError("high_capacity mesh: overflow or two runs differ")
    mesh_err = check_unpacked((fin["keys"], fin["first"], fin["aggs"], fin["overflow"]),
                              (want_mesh["keys"], want_mesh["first"], want_mesh["aggs"], False),
                              "high_capacity mesh against the oracle")
    emit({"phase": "high_capacity", "card": card, "query": "supp (Q15 window, GROUP BY "
          "l_suppkey)", "cold": cold,
          "warm": {"rows": n_warm, "suppliers": fx.suppliers(n_warm), "groups": len(want_warm),
                   "capacity": 1 << (len(want_warm) - 1).bit_length(),
                   "c_max": ev_w.plan.group_program.c_max, "first_run_with_pin_s": warm_s[0],
                   "seconds": warm_s[1:]},
          "batch": {"riders": [n for n, _d, _o in batch_dags], "seconds": batch_s,
                    "wide_riders_alone_sum_s": alone_s},
          "mesh": {"rows": HC_MESH_ROWS, "capacity": HC_MESH_CAP, "shards": MESH_SHARDS,
                   "live_groups": len(want_mesh["keys"]), "seconds": mesh_s,
                   "max_abs_err": mesh_err},
          "matches_oracle": True, "bit_identical_reruns": True, "launches": launches})

    # ---- the new kernels at the path's inputs ------------------------------------
    prog, img, cap = wide_in[0]
    t_warm = time_wide_kernels(ga, fx, prog, img, cap, 10)
    shared_img = fa.Image(img.cols, img.nulls, img.n_valids, img.n_blocks, img.block_rows,
                          img.device, img.offsets, img.gids % prog.c_max)
    t_shared = time_group_kernels(ga, prog, shared_img, prog.c_max, 10)
    # D15's crossover: the same ids on the wide route, at c_max + 1 slots
    t_cross = time_wide_kernels(ga, fx, prog, shared_img, prog.c_max + 1, 10)
    del img, shared_img
    ev_c = te.TorchDagEvaluator(supp_wire, block_rows=1 << 16, device="cuda")
    _resp, calls = capture_calls(te, "fused_group_agg", lambda: ev_c.run(FixtureScanSource(kvs)))
    cap_c = max(c[2] for c in calls)  # the first block at the grown capacity
    prog_c, img_c = next(c[:2] for c in calls if c[2] == cap_c)
    t_cold = time_wide_kernels(ga, fx, prog_c, img_c, cap_c, 50)
    tasks = te.batch_tasks(evs_b, cache)[0]  # the batch the main path ran
    batch_err = fx.batch_kernel_check(tasks)
    # its riders past their rows (Q1 by the four flag columns, 480 slots)
    # on the wide route, at their own inputs
    t_riders = {batch_dags[i][0]: time_wide_kernels(ga, fx, tasks[i].prog, tasks[i].img,
                                                    tasks[i].capacity, 5)
                for i in fb.Batch(tasks).wide}
    del tasks
    # the second super-block's shard union, with the dictionary carried
    # the wide route at a shard of the first super-block (131,072 rows at
    # 32,768 slots: 80 launches a request)
    state, calls = capture_calls(pm, "_shard_states", lambda: mev.step(
        *_block_args(mev, mblocks[0]), mev.init_state()))
    sprog, simages, scap, _lead = calls[0]
    t_mesh_wide = time_wide_kernels(ga, fx, sprog, simages[0], scap, 50)
    del calls, simages
    seen = capture_dict(fd, lambda: mev.step(*_block_args(mev, mblocks[1]), state,
                                             block_base=total))
    d, k, ucap = seen["dict_union"]
    t_sort = time_sort_union(fd, fx, d, k, ucap)
    dg, kg, _ = seen["dict_union_global"]
    t_sort_global = time_sort_union(fd, fx, dg, kg, ucap)
    new, kk, old = seen["dict_ids"]
    ids_ms = time_ids(fd, new, kk, old, 20)
    emit({"phase": "high_capacity", "case": "kernels", "card": card,
          "int_words_equal": True, "f64_rel_tol": REL_TOL,
          "wide_warm": t_warm, "shared_rows_same_image": t_shared, "wide_cold_block": t_cold,
          "wide_same_ids_at_c_max_plus_1": t_cross, "wide_mesh_shard": t_mesh_wide,
          "wide_batch_riders": t_riders,
          "batch_check": batch_err, "sort_union_shard": t_sort,
          "sort_union_global": t_sort_global, "dict_ids_device_memory_ms": ids_ms,
          "setup_seconds": t_setup, "phase_seconds": time.perf_counter() - t_phase})
    return {"launches": launches, "warm": t_warm, "cold": t_cold, "shared": t_shared,
            "crossover": t_cross, "mesh_shard": t_mesh_wide, "riders": t_riders,
            "sort": t_sort, "sort_global": t_sort_global, "ids": ids_ms,
            "max_abs_err": max(t_warm["max_abs_err"], t_cold["max_abs_err"],
                               t_cross["max_abs_err"], t_mesh_wide["max_abs_err"],
                               *(t["max_abs_err"] for t in t_riders.values()),
                               batch_err["wide"], mesh_err)}


# ---------------------------------------------------------------------------
# phase write_path: the region write path (cache.scatter_update)
# ---------------------------------------------------------------------------

# one TiKV region at its documented size (coprocessor.region-split-size =
# 96 MiB, TiKV v5.1): 1,000,000 lineitem rows of about 75 bytes of CF_WRITE
# key and record each, loaded in date order so that zone maps prune
WRITE_ROWS = 1_000_000
WRITE_BLOCK_ROWS = 1 << 16
# (name, rows updated, of them moving into Q6's window, a new l_returnflag
# value, rows inserted, rows deleted, by write-through)
WRITE_BATCHES = (("update_0.1pct", 1_000, 100, True, 0, 0, False),
                 ("update_1pct", 10_000, 500, False, 0, 0, False),
                 ("update_1pct_write_through", 10_000, 500, False, 0, 0, True),
                 ("insert_delete", 0, 0, False, 5_000, 5_000, False))
WRITE_ROUTES = (("q6", None), ("q6", "unary"), ("q1", None), ("q1", "unary"), ("filter", None))
PATCH_ROWS = 10_000  # the 1% update's rows, patched into the 10M image too
PATCH_SRC = "tikv_tpu_torch/csrc/fused_patch.cu"


def stacked_sigs(cache) -> list:
    return [sig for sig in cache.blocks[0].device if sig[0] == "stacked"]


def check_pins_rebuilt(cache, ev) -> int:
    """Every stacked pin of ``cache`` equal (``torch.equal``) to the same
    signature pinned afresh from a copy of the updated host blocks; returns
    the lanes compared."""
    from tikv_tpu_torch.copr.cache import ColumnBlockCache

    copy = ColumnBlockCache.from_numpy_blocks(
        [([(c.eval_type.value, np.asarray(c.data), np.asarray(c.nulls), c.frac, c.dictionary)
           for c in blk.cols], blk.n_valid) for blk in cache.blocks])
    lanes = 0
    for sig in stacked_sigs(cache):
        data, nulls = cache.blocks[0].device[sig]
        fresh = ev._stacked_device(copy, ship_cols=sig[1], nullable=sig[2])
        for got, want in zip(list(data) + list(nulls), fresh.cols + fresh.nulls):
            if (got is None) != (want is None) or (got is not None
                                                   and not torch.equal(got, want)):
                raise AssertionError(f"write path: pin {sig[:3]} differs from a rebuilt pin")
            lanes += got is not None
    return lanes


def time_patch(fp, lanes, null_lanes, pos, vals, nls, iters: int) -> dict:
    """``patch_stacked``'s ms per launch (CUDA events; the update's tensors
    already on the card) beside its plain version, which is the library
    call too (``index_put_`` per lane), and its bound: the positions, each
    lane's words or null bytes read once and written once, over the HBM
    rate."""
    dev = (lanes or null_lanes)[0].device
    p, v, m = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (pos, vals, nls))
    b_ms, b_by = bound(8 * len(pos) + 16 * len(pos) * len(lanes) + 2 * len(pos) * len(null_lanes),
                       0)
    plain_ms = cuda_ms(lambda: fp.patch_stacked_plain(lanes, null_lanes, p, v, m), iters)
    return {"updates": len(pos), "data_lanes": len(lanes), "null_lanes": len(null_lanes),
            "ms": cuda_ms(lambda: fp.launch(lanes, null_lanes, p, v, m), iters),
            "plain_ms": plain_ms, "library_ms": plain_ms,
            "library": "index_put_ per lane (the plain version)",
            "bound_ms": b_ms, "bound_by": b_by}


def phase_write_path(fx, card: str, device, big_cache, big_ev) -> dict:
    """The region write path on its main path, counted from 0: a 96 MiB
    region (1,000,000 date-ordered lineitem rows) written as MVCC versions
    into the port's engine; its plain image built cold from those versions
    (``RegionColumnCache.serve``), then Q6 and Q1 on both warm routes and
    config 2's filter against the numpy oracles; then four committed
    batches, each followed by the same requests: 1,000 rows (0.1%) and
    10,000 rows (1%) updated in place through ``scan_delta`` (rows moving
    into Q6's window inside blocks whose zone maps excluded them, a new
    l_returnflag value), 10,000 rows by ``notify_region_write``, and 5,000
    inserts with 5,000 deletes (the structural repack).  After each: the
    outcome string and rows, every answer against its oracle, one
    ``patch_stacked`` launch per stacked pin, and every pin equal to a
    rebuilt pin.  Then the encoded image once (its pins dropped by a delta
    and pinned again), the kernel against its plain version bit for bit on
    the region's Q1 pin, and its times there and on ``big_cache`` (config
    2's 10M image): 10,000 scattered rows into Q1's shipped lanes, beside
    ``index_put_`` per lane and a full re-pin."""
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_patch as fp
    from tikv_tpu_torch.copr import region_cache as prc
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.table import record_range
    from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator
    from tikv_tpu_torch.storage.engine import CF_WRITE

    t_phase = time.perf_counter()
    a = fx.sort_by_shipdate(fx.build_arrays(WRITE_ROWS, SEED))
    eng, load_s = timed_call(lambda: fx.region_engine(a))
    cf_write_bytes = sum(len(k) + len(v) for k, v in eng.snapshot().scan_cf(CF_WRITE, b"", None))
    ranges = [record_range(fx.TABLE_ID)]
    plans = {"q6": fx.q6_dag(), "q1": fx.q1_dag(), "filter": fx.filter_dag("filter", SCAN_LIMIT)}
    evs = {}
    for name, hint in WRITE_ROUTES:
        evs[name, hint] = TorchDagEvaluator(dag_to_wire(plans[name]), block_rows=WRITE_BLOCK_ROWS,
                                            device=device)
        evs[name, hint].route_hint = hint
    oracles = {"q6": lambda x: [fx.q6_oracle(x)], "q1": fx.q1_oracle,
               "filter": lambda x: fx.filter_oracle(x, "filter", SCAN_LIMIT)}
    st = {"a": a, "ai": 3, "ts": 200}

    def serve_round(rc, what: str) -> dict:
        """Every route once; the first serve takes the write."""
        rec = {"outcomes": [], "serve_s": [], "query_s": {}}
        for name, hint in WRITE_ROUTES:
            (bc, out, n), s = timed_call(lambda: rc.serve(
                eng.snapshot(), fx.region_context(st["ai"]), fx.lineitem(), ranges, st["ts"]))
            rec["outcomes"].append([out, n])
            rec["serve_s"].append(s)
            resp, q_s = timed_run(evs[name, hint], None, bc)
            check_rows(resp, oracles[name](st["a"]), f"write path {what}: {name} {hint}")
            rec["query_s"][f"{name}_{hint or 'default'}"] = q_s
        rec["cache"] = bc
        rec["q6_unary_prune"] = list(evs["q6", "unary"].prune_stats)
        return rec

    def write(seed: int, n_upd, movers, new_flag, n_ins, n_del, wt) -> dict:
        b, puts, dels = fx.region_write(st["a"], seed, n_update=n_upd, q6_movers=movers,
                                        new_flag=new_flag, n_insert=n_ins, n_delete=n_del)
        ops = fx.region_write_ops(b, puts, dels, st["ts"] + 5, st["ts"] + 10)
        _r, apply_s = timed_call(lambda: fx.apply_region_ops(eng, ops))
        st["a"], st["ai"], st["ts"] = b, st["ai"] + 1, st["ts"] + 100
        if wt:
            prc.notify_region_write(fx.REGION_ID, ops, st["ai"])
        return {"rows": len(puts) + len(dels), "engine_apply_s": apply_s}

    # ---- the write main path: counts from 0 here to the last round ---------
    fa.reset_launches()
    rc = prc.RegionColumnCache(block_rows=WRITE_BLOCK_ROWS, encode_columns=False,
                               data_token=None)
    rounds = {"build": serve_round(rc, "build")}
    if rounds["build"]["outcomes"][0] != ["miss", 0]:
        raise AssertionError(f"write path: the first serve was {rounds['build']['outcomes'][0]}")
    cache = rounds["build"]["cache"]
    for i, (name, n_upd, movers, new_flag, n_ins, n_del, wt) in enumerate(WRITE_BATCHES):
        rec_w = write(SEED + 10 + i, n_upd, movers, new_flag, n_ins, n_del, wt)
        pins = len(stacked_sigs(cache))
        before = fa.LAUNCHES["patch_stacked"]
        rec = serve_round(rc, name)
        rec.update(rec_w, stacked_pins=pins, patch_launches=fa.LAUNCHES["patch_stacked"] - before)
        want = ["wt_delta" if wt else "delta", rec_w["rows"]]
        if rec["outcomes"][0] != want or any(o != ["hit", 0] for o in rec["outcomes"][1:]):
            raise AssertionError(f"write path {name}: outcomes {rec['outcomes']}, not {want}")
        structural = bool(n_ins or n_del)
        if rec["patch_launches"] != (0 if structural else pins) or (not structural and not pins):
            raise AssertionError(f"write path {name}: {rec['patch_launches']} patch launches "
                                 f"for {pins} stacked pins")
        if not structural:
            rec["pin_lanes_checked"] = check_pins_rebuilt(cache, evs["q1", "unary"])
        rounds[name] = rec
    launches = dict(fa.LAUNCHES)
    # ---- end of the write main path --------------------------------------------
    if fx.NEW_FLAG not in [bytes(v) for v in cache.blocks[0].cols[5].dictionary]:
        raise AssertionError("write path: the new l_returnflag value is not in the dictionary")

    # the encoded image once: a delta drops its encoded pins, the next
    # request pins them again
    rc_enc = prc.RegionColumnCache(block_rows=WRITE_BLOCK_ROWS, data_token=None)
    ev_enc = evs["q1", "unary"]

    def enc_serve(want: str):
        bc, out, _n = rc_enc.serve(eng.snapshot(), fx.region_context(st["ai"]), fx.lineitem(),
                                   ranges, st["ts"])
        if out != want:
            raise AssertionError(f"write path, encoded image: {out}, not {want}")
        pinned = [s[0] for s in bc.blocks[0].device]
        check_rows(ev_enc.run(None, bc), fx.q1_oracle(st["a"]), "write path: encoded Q1")
        return pinned, [s[0] for s in bc.blocks[0].device]

    _b, enc_pins = enc_serve("miss")
    write(SEED + 20, 1_000, 100, False, 0, 0, False)
    enc_after_delta, enc_repinned = enc_serve("delta")
    if "stackedenc" not in enc_pins or "stackedenc" in enc_after_delta \
            or "stackedenc" not in enc_repinned:
        raise AssertionError(f"write path, encoded image: pins {enc_pins} -> {enc_after_delta} "
                             f"-> {enc_repinned}")
    del rc_enc

    # the kernel against its plain version, bit for bit, on the region's Q1
    # pin (clones: the pin itself stays as the host blocks say), then timed
    rng = np.random.default_rng(SEED + 30)
    q1_sig = max(stacked_sigs(cache), key=lambda sig: len(sig[1]))  # Q1's six lanes
    data, nulls = cache.blocks[0].device[q1_sig]
    lanes, null_lanes = list(data), [m for m in nulls if m is not None]
    n_valid = cache.total_rows
    offsets = np.cumsum([0] + [b.n_valid for b in cache.blocks])
    rows = np.sort(rng.choice(n_valid, PATCH_ROWS, replace=False))
    bi = np.searchsorted(offsets, rows, side="right") - 1
    pos = bi * WRITE_BLOCK_ROWS + (rows - offsets[bi])
    vals = np.stack([rng.integers(0, 1 << 20, PATCH_ROWS) for _ in lanes]).astype(np.int64)
    nls = rng.random((len(null_lanes), PATCH_ROWS)) < 0.5
    if fx.patch_kernel_check(lanes, null_lanes, pos, vals, nls) != 1:
        raise AssertionError("write path: the kernel check made no launch")
    clones = [t.clone() for t in lanes], [t.clone() for t in null_lanes]
    t_region = time_patch(fp, *clones, pos, vals, nls, 50)
    del clones
    sig_ship, sig_null = q1_sig[1], q1_sig[2]
    cache.blocks[0].device.pop(q1_sig)
    _img, t_region["repin_s"] = timed_call(lambda: evs["q1", "unary"]._stacked_device(
        cache, ship_cols=sig_ship, nullable=sig_null))
    t_region["pin_sig"] = {"ship": list(sig_ship), "nullable": list(sig_null),
                           "n_blocks": len(cache.blocks)}

    # config 2's 10M image (not the 100M one, to keep the script within half
    # its limit): Q1's shipped lanes decoded and pinned (the full re-pin a
    # patch spares), then 10,000 scattered rows patched with the values they
    # hold (the image stays as the host blocks say)
    big_img, big_pin_s = timed_call(lambda: big_ev._stacked_device(
        big_cache, ship_cols=big_ev._ship_cols([5, 6]), decode=True))
    big_rows = big_cache.total_rows
    rows = np.sort(rng.choice(big_rows, PATCH_ROWS, replace=False))
    br_big = big_img.block_rows
    big_pos = (rows // br_big) * br_big + rows % br_big
    pos_t = torch.from_numpy(big_pos).to(device)
    big_vals = torch.stack([c.view(-1)[pos_t].view(torch.int64) for c in big_img.cols]).cpu().numpy()
    big_nulls = [m for m in big_img.nulls if m is not None]
    big_nls = torch.stack([m.view(-1)[pos_t] for m in big_nulls]).cpu().numpy() if big_nulls \
        else np.zeros((0, PATCH_ROWS), dtype=bool)
    t_big = time_patch(fp, list(big_img.cols), big_nulls, big_pos, big_vals, big_nls, 50)
    for c, want in zip(big_img.cols, big_vals):
        if not np.array_equal(c.view(-1)[pos_t].view(torch.int64).cpu().numpy(), want):
            raise AssertionError("write path: the 10M image's patched lanes changed")
    t_big.update(rows=big_rows, repin_s=big_pin_s,
                 image_bytes=sum(c.numel() * c.element_size() for c in big_img.cols))
    for sig in stacked_sigs(big_cache):
        big_cache.blocks[0].device.pop(sig)
    del big_img, pos_t
    torch.cuda.empty_cache()

    for rec in rounds.values():
        rec.pop("cache")
    out = {"phase": "write_path", "card": card, "rows": WRITE_ROWS,
           "block_rows": WRITE_BLOCK_ROWS, "cf_write_bytes": cf_write_bytes,
           "engine_load_s": load_s, "rounds": rounds, "launches": launches,
           "encoded_pins": {"built": enc_pins, "after_delta": enc_after_delta,
                            "next_request": enc_repinned},
           "region_patch": t_region, "big_patch": t_big,
           "outcome_counts": dict(prc.OUTCOME_COUNTS),
           "phase_seconds": time.perf_counter() - t_phase}
    emit(out)
    return {"launches": launches, "region": t_region, "big": t_big,
            "pins_per_delta": [r.get("stacked_pins") for r in rounds.values()]}


def oracles_at_once(jobs: dict) -> dict:
    """Each job's answer (``{name: fn}``), ``ORACLE_THREADS`` at a time: the
    numpy oracles only read their draws, and numpy releases the GIL in
    their loops, so they share the host's cores."""
    with ThreadPoolExecutor(ORACLE_THREADS) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


def timed_call(fn):
    """``fn()`` and its host seconds, the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _block_args(ev, block):
    """``ShardedGroupedEvaluator.step``'s leading arguments (data, nulls,
    n_valid) for one of the phase's super-blocks."""
    columns, n_valid = block
    return ([columns[i][0] for i in ev.ship_cols], [columns[i][1] for i in ev.nullable_cols],
            n_valid)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tikv_tpu_torch import _build
    from tikv_tpu_torch import fixtures as fx
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_batch as fb
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr import fused_mask as fm
    from tikv_tpu_torch.copr import fused_dict as fd
    from tikv_tpu_torch.copr import encoding
    from tikv_tpu_torch.copr import fused_topn as ft
    from tikv_tpu_torch.copr import fused_zone as fz
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.copr.groupby import GroupDict
    from tikv_tpu_torch.copr.torch_eval import (
        GROUP_CAPACITY_START,
        TorchDagEvaluator,
        _capacity_for,
        _pick,
    )

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "card": card, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    errs = phase_kernels(fa, fx, device)
    errs.update(phase_group_kernels(ga, fx, device))
    phase_scan_kernels(fm, ft, fx, device)

    # ---- the Q6 main path: counts from 0 here to the end of phase 5 -------
    fa.reset_launches()
    q6_wire = dag_to_wire(fx.q6_dag())
    n_cold = COLD_ROWS
    kvs = fx.build_kvs(n_cold, SEED)
    cold_arrays = fx.build_arrays(n_cold, SEED)
    oracle = fx.q6_oracle(cold_arrays)
    ev = TorchDagEvaluator(q6_wire, block_rows=1 << 16, device="cuda")
    cold_s = []
    for _ in range(2):
        resp, s = timed_run(ev, FixtureScanSource(kvs), None)
        check_rows(resp, [oracle], "cold Q6")
        cold_s.append(s)
    emit({"phase": "cold", "query": "q6", "rows": n_cold, "block_rows": 1 << 16,
          "answer": oracle, "matches_oracle": True, "seconds": cold_s,
          "rows_per_s": n_cold / min(cold_s), "card": card})

    n_warm, cut = warm_rows_that_fit(WARM_ROWS, WARM_ROWS_FLOOR)
    arrays = fx.build_arrays(n_warm, SEED)
    cache = fx.build_cache(n_warm, 1 << 17, SEED, arrays=arrays)
    want_q6 = [fx.q6_oracle(arrays)]
    want_g = [fx.q6_count_sum_min_max_oracle(arrays)]
    ev_w = stacked(TorchDagEvaluator(q6_wire, block_rows=1 << 17, device="cuda"))
    resp, pin_s = timed_run(ev_w, None, cache)  # first run pins the image
    check_rows(resp, want_q6, "warm Q6")
    warm_s = []
    for _ in range(5):
        resp, s = timed_run(ev_w, None, cache)
        check_rows(resp, want_q6, "warm Q6")
        warm_s.append(s)
    ev_g = stacked(TorchDagEvaluator(dag_to_wire(fx.q6_count_sum_min_max_dag()),
                                     block_rows=1 << 17, device="cuda"))
    resp_g, g_s = timed_run(ev_g, None, cache)
    check_rows(resp_g, want_g, "warm count/sum/min/max")
    q6_launches = dict(fa.LAUNCHES)
    # ---- end of the Q6 main path ---------------------------------------------
    emit({"phase": "warm", "query": "q6", "rows": n_warm, "block_rows": 1 << 17,
          "reduced": cut, "answer": want_q6[0], "matches_oracle": True,
          "first_run_with_pin_s": pin_s, "seconds": warm_s,
          "rows_per_s": n_warm / sorted(warm_s)[len(warm_s) // 2],
          "pinned_bytes": cache.device_nbytes(), "card": card})
    emit({"phase": "warm", "query": "q6_count_sum_min_max", "rows": n_warm,
          "answer": want_g[0], "matches_oracle": True, "seconds_with_pin": g_s,
          "launches": q6_launches, "card": card})

    # ---- the Q1 main path: counts from 0 here to the end of phase 7 -------
    jobs = {"q1_cold": lambda: fx.q1_oracle(cold_arrays), "q1": lambda: fx.q1_oracle(arrays),
            "qty": lambda: fx.qty_oracle(arrays), "topn": lambda: fx.topn_oracle(arrays, TOPN_K),
            "sel": lambda: fx.filter_oracle(arrays, "selective", None),
            "filter": lambda: fx.filter_oracle(arrays, "filter", SCAN_LIMIT)}
    for name, _dag, oracle in fx.batch_plans():
        if name not in ("q6", "q6_count_sum_min_max", "q1", "q1_topn"):
            jobs[name] = lambda oracle=oracle: oracle(arrays)
    wants_100m = oracles_at_once(jobs)
    want_q1_cold, want_q1, want_qty, want_topn, want_sel_warm, want_filter_warm = (
        wants_100m.pop(k) for k in ("q1_cold", "q1", "qty", "topn", "sel", "filter"))
    want_batch = {"q6": want_q6, "q6_count_sum_min_max": want_g, "q1": want_q1,
                  "q1_topn": fx.q1_topn_oracle(want_q1), **wants_100m}
    del arrays, jobs, wants_100m
    fa.reset_launches()
    q1_wire = dag_to_wire(fx.q1_dag())
    ev_c1 = TorchDagEvaluator(q1_wire, block_rows=1 << 16, device="cuda")
    cold1_s = []
    for _ in range(2):
        resp, s = timed_run(ev_c1, FixtureScanSource(kvs), None)
        check_rows(resp, want_q1_cold, "cold Q1")
        cold1_s.append(s)
    cold_q1_launches = dict(fa.LAUNCHES)
    ev_w1 = stacked(TorchDagEvaluator(q1_wire, block_rows=1 << 17, device="cuda"))
    if ev_w1._stable_dict_group_cols(cache.blocks) is None:
        raise AssertionError("warm Q1 would not take the coded path")
    before = fa.LAUNCHES["fused_group_agg_partials"]
    resp, pin1_s = timed_run(ev_w1, None, cache)
    check_rows(resp, want_q1, "warm Q1")
    warm1_s = []
    for _ in range(5):
        resp, s = timed_run(ev_w1, None, cache)
        check_rows(resp, want_q1, "warm Q1")
        warm1_s.append(s)
    per_query = (fa.LAUNCHES["fused_group_agg_partials"] - before) / 6
    if per_query != 1:
        raise AssertionError(f"warm Q1 launched {per_query} partials per query, not 1")
    ev_q = stacked(TorchDagEvaluator(dag_to_wire(fx.qty_dag()), block_rows=1 << 17,
                                     device="cuda"))
    qty_s = []
    for _ in range(2):
        resp, s = timed_run(ev_q, None, cache)
        check_rows(resp, want_qty, "warm GROUP BY l_quantity")
        qty_s.append(s)
    q1_launches = dict(fa.LAUNCHES)
    # ---- end of the Q1 main path ---------------------------------------------
    emit({"phase": "cold", "query": "q1", "rows": n_cold, "block_rows": 1 << 16,
          "groups": len(want_q1_cold), "matches_oracle": True, "seconds": cold1_s,
          "rows_per_s": n_cold / min(cold1_s), "launches": cold_q1_launches, "card": card})
    emit({"phase": "warm", "query": "q1", "path": "coded group ids", "rows": n_warm,
          "block_rows": 1 << 17, "reduced": cut, "groups": len(want_q1), "answer": want_q1,
          "matches_oracle": True, "first_run_with_pin_s": pin1_s, "seconds": warm1_s,
          "rows_per_s": n_warm / sorted(warm1_s)[len(warm1_s) // 2],
          "partials_launches_per_query": per_query, "card": card})
    emit({"phase": "warm", "query": "group_by_l_quantity", "path": "host group ids",
          "rows": n_warm, "groups": len(want_qty), "matches_oracle": True,
          "seconds_first_with_pin": qty_s[0], "seconds": qty_s[1:],
          "pinned_bytes": cache.device_nbytes(), "launches": q1_launches, "card": card})

    # ---- configs 1-2, the scan/filter main path: counts from 0 here to the
    # end of phase 8 -----------------------------------------------------------
    a10 = fx.build_arrays(FILTER_ROWS, SEED)
    cache10 = fx.build_cache(FILTER_ROWS, 1 << 17, SEED, arrays=a10)
    wants = {"cold_scan": fx.filter_oracle(cold_arrays, "scan", SCAN_LIMIT),
             "cold_filter": fx.filter_oracle(cold_arrays, "filter", SCAN_LIMIT),
             "warm_filter": fx.filter_oracle(a10, "filter", SCAN_LIMIT),
             "warm_selective": fx.filter_oracle(a10, "selective", None)}
    kept = {"cold_filter": int(fx.filter_mask(cold_arrays, "filter").sum()),
            "warm_filter": int(fx.filter_mask(a10, "filter").sum()),
            "warm_selective": int(fx.filter_mask(a10, "selective").sum())}
    del a10
    scan_evs = {
        "cold_scan": TorchDagEvaluator(dag_to_wire(fx.filter_dag("scan", SCAN_LIMIT)),
                                       block_rows=1 << 16, device="cuda"),
        "cold_filter": TorchDagEvaluator(dag_to_wire(fx.filter_dag("filter", SCAN_LIMIT)),
                                         block_rows=1 << 16, device="cuda"),
        "warm_filter": TorchDagEvaluator(dag_to_wire(fx.filter_dag("filter", SCAN_LIMIT)),
                                         block_rows=1 << 17, device="cuda"),
        "warm_selective": TorchDagEvaluator(dag_to_wire(fx.filter_dag("selective", None)),
                                            block_rows=1 << 17, device="cuda"),
    }
    fa.reset_launches()
    scan_s, scan_per_request = {}, {}
    for name, ev_x in scan_evs.items():
        before = fa.LAUNCHES["fused_mask"]
        runs = 2 if name.startswith("cold") else 4  # a warm path's first run pins the image
        scan_s[name] = []
        for _ in range(runs):
            resp, t = timed_run(ev_x, FixtureScanSource(kvs) if name.startswith("cold") else None,
                                None if name.startswith("cold") else cache10)
            check_rows(resp, wants[name], name.replace("_", " "))
            scan_s[name].append(t)
        scan_per_request[name] = (fa.LAUNCHES["fused_mask"] - before) / runs
    scan_launches = dict(fa.LAUNCHES)
    # ---- end of the scan/filter main path ------------------------------------
    for name, secs in scan_s.items():
        cold = name.startswith("cold")
        emit({"phase": "scan", "query": name, "rows": n_cold if cold else FILTER_ROWS,
              "block_rows": 1 << 16 if cold else 1 << 17, "rows_out": len(wants[name]),
              "rows_passing": kept.get(name), "matches_oracle": True, "seconds": secs,
              "best_s": min(secs) if cold else sorted(secs[1:])[1],
              "output_rows_per_s": len(wants[name]) / (min(secs) if cold else sorted(secs[1:])[1]),
              "mask_launches_per_request": scan_per_request[name], "card": card})
    del wants

    # ---- the raw TopN main path: counts from 0 here to its end ---------------
    want_topn_cold = fx.topn_oracle(cold_arrays, TOPN_K)
    topn_wire = dag_to_wire(fx.topn_dag(TOPN_K))
    ev_tc = TorchDagEvaluator(topn_wire, block_rows=1 << 16, device="cuda")
    ev_tw = TorchDagEvaluator(topn_wire, block_rows=1 << 17, device="cuda")
    fa.reset_launches()
    topn_cold_s = []
    for _ in range(2):
        resp, t = timed_run(ev_tc, FixtureScanSource(kvs), None)
        check_rows(resp, want_topn_cold, "cold raw TopN")
        topn_cold_s.append(t)
    topn_cold_launches = dict(fa.LAUNCHES)
    topn_warm_s = []
    for _ in range(4):  # the first pins the image
        resp, t = timed_run(ev_tw, None, cache)
        check_rows(resp, want_topn, "warm raw TopN")
        topn_warm_s.append(t)
    topn_launches = dict(fa.LAUNCHES)
    # ---- end of the raw TopN main path ---------------------------------------
    per_req = {k: (topn_launches[k] - topn_cold_launches[k]) / 4
               for k in ("topn_candidates", "topn_merge", "topn_pack")}
    emit({"phase": "topn", "query": "raw_topn_cold", "rows": n_cold, "block_rows": 1 << 16,
          "k": TOPN_K, "matches_oracle": True, "seconds": topn_cold_s,
          "rows_per_s": n_cold / min(topn_cold_s),
          "launches_per_request": {k: topn_cold_launches[k] / 2
                                   for k in ("topn_candidates", "topn_merge", "topn_pack")},
          "card": card})
    emit({"phase": "topn", "query": "raw_topn_warm", "rows": n_warm, "block_rows": 1 << 17,
          "reduced": cut, "k": TOPN_K, "matches_oracle": True,
          "first_run_with_pin_s": topn_warm_s[0], "seconds": topn_warm_s[1:],
          "rows_per_s": n_warm / sorted(topn_warm_s[1:])[1], "launches_per_request": per_req,
          "launches": topn_launches, "card": card})

    # ---- BASELINE config 4, Q1 + TopN (the grouped kernels, then the host
    # TopN over six groups) -------------------------------------------------
    q1t_wire = dag_to_wire(fx.q1_topn_dag())
    ev_q1t_c = TorchDagEvaluator(q1t_wire, block_rows=1 << 16, device="cuda")
    ev_q1t_w = stacked(TorchDagEvaluator(q1t_wire, block_rows=1 << 17, device="cuda"))
    keys_at = [ev_q1t_w.plan.agg_schema[c.index][0].value
               for c, _desc in ev_q1t_w.plan.topn.order_by]
    if keys_at != ["bytes", "bytes"] or len(ev_q1t_w.plan.agg_schema) != 9:
        raise AssertionError(f"Q1 + TopN keys are not the group keys: {keys_at}")
    fa.reset_launches()
    q1t_s = {"cold": [], "warm": []}
    for _ in range(2):
        resp, t = timed_run(ev_q1t_c, FixtureScanSource(kvs), None)
        check_rows(resp, fx.q1_topn_oracle(want_q1_cold), "cold Q1 + TopN")
        q1t_s["cold"].append(t)
    for _ in range(4):
        resp, t = timed_run(ev_q1t_w, None, cache)
        check_rows(resp, fx.q1_topn_oracle(want_q1), "warm Q1 + TopN")
        q1t_s["warm"].append(t)
    q1t_launches = dict(fa.LAUNCHES)
    emit({"phase": "topn", "query": "q1_topn", "rows_cold": n_cold, "rows_warm": n_warm,
          "groups": len(want_q1), "groups_out": len(fx.q1_topn_oracle(want_q1)),
          "matches_oracle": True, "cold_seconds": q1t_s["cold"], "warm_seconds": q1t_s["warm"],
          "warm_rows_per_s": n_warm / sorted(q1t_s["warm"])[2], "launches": q1t_launches,
          "card": card})

    # ---- timings of each kernel at its main-path launch --------------------
    img = ev_w._stacked_device(cache)
    prog = ev_w.program
    t_q6 = time_agg_partials(fa, prog, img, 20)
    p_ms, pp_ms, p_err = t_q6["ms"], t_q6["plain_ms"], t_q6["max_abs_err"]
    p_bound, p_by = t_q6["bound_ms"], t_q6["bound_by"]
    scratch = fa.new_scratch(prog, img)
    fa.launch_partials(prog, img, scratch)
    grid = scratch.shape[0]
    out = (torch.empty((prog.n_int, 1), dtype=torch.int64, device=device),
           torch.empty((prog.n_f64, 1), dtype=torch.float64, device=device))
    c_ms = cuda_ms(lambda: fa.launch_combine(prog, scratch, None, out), 200)
    c_err = compare_packed(prog, out, fa.combine_plain(prog, scratch), "q6 combine")
    cp_ms = cuda_ms(lambda: fa.combine_plain(prog, scratch), 20)
    rows = n_warm
    # the combine's bytes: the partials and the packed state; operations:
    # one per partial merged
    c_bound, c_by = bound(grid * len(prog.aggs) * 16 + (prog.n_int + prog.n_f64) * 8,
                          grid * len(prog.aggs) * 2)
    # the grouped pair on Q6's image at one slot: what the capacity-1 pair
    # is measured against on its own workload; both must give one state
    plan6 = ev_w.plan
    prog_g6 = ga.compile_group_program(plan6.sel_rpns, plan6.agg_rpns, plan6.device_cols,
                                       plan6.schema, (), track=False)
    compare_packed(prog, ga.fused_group_agg(prog_g6, img, 1), fa.fused_agg(prog, img),
                   "grouped vs capacity-1 pair on Q6")
    t_q6_grouped = time_group_kernels(ga, prog_g6, img, 1, 10)
    # the two pairs on Q6's image in ten alternating turns (ROADMAP D8)
    parts_g6 = ga.new_partials(prog_g6, img, 1)
    d8 = {"fused_agg_partials_ms": [], "fused_group_agg_partials_one_slot_ms": []}
    for _ in range(10):
        d8["fused_agg_partials_ms"].append(
            cuda_ms(lambda: fa.launch_partials(prog, img, scratch), 10))
        d8["fused_group_agg_partials_one_slot_ms"].append(
            cuda_ms(lambda: ga.launch_partials(prog_g6, img, 1, parts_g6), 10))
    d8["medians_ms"] = {k: sorted(v)[5] for k, v in d8.items()}
    del img, scratch, parts_g6
    # a cold Q6 block as the cold path launches it (65,536 rows, 16 a request)
    cols6, nv6 = next(ev._decode_blocks(FixtureScanSource(kvs[: 1 << 16])))
    t_cold_q6 = time_agg_partials(fa, ev.program, ev._block_image(cols6, nv6), 50)

    # grouped: warm Q1 (coded ids), a cold Q1 block (host ids), and warm
    # GROUP BY l_quantity (host ids)
    stable = ev_w1._stable_dict_group_cols(cache.blocks)
    group_cols, dicts = stable
    dict_lens = tuple(len(d) for d in dicts)
    prog1 = ev_w1._coded_program(group_cols, dict_lens)
    img1 = ev_w1._stacked_device(cache, ev_w1._ship_cols(group_cols))
    t_warm_q1 = time_group_kernels(ga, prog1, img1,
                                   _capacity_for(prog1, 1, (dict_lens[0] + 1) * (dict_lens[1] + 1)),
                                   10)
    del img1
    cols, nv = next(ev_c1._decode_blocks(FixtureScanSource(kvs[: 1 << 16])))
    gids, _n_groups = ev_c1._assign_gids(cols, nv, GroupDict())
    t_cold_q1 = time_group_kernels(ga, ev_c1.plan.group_program,
                                   ev_c1._block_image(cols, nv, gids, 0), GROUP_CAPACITY_START, 50)
    qty_groups = GroupDict()
    all_gids = torch.stack([torch.from_numpy(ev_q._assign_gids(b.cols, b.n_valid, qty_groups)[0])
                            for b in cache.blocks]).to(device)
    prog_q = ev_q.plan.group_program
    t_qty = time_group_kernels(ga, prog_q, ev_q._stacked_device(cache, gids=all_gids),
                               _capacity_for(prog_q, 1, len(qty_groups)), 10)
    del all_gids
    emit({"phase": "timings", "card": card, "warm_rows": rows,
          "cold_rows_per_s": n_cold / min(cold_s),
          "warm_rows_per_s": rows / sorted(warm_s)[len(warm_s) // 2],
          "cold_q1_rows_per_s": n_cold / min(cold1_s),
          "warm_q1_rows_per_s": rows / sorted(warm1_s)[len(warm1_s) // 2],
          "fused_agg_partials_ms": p_ms, "fused_agg_partials_bound_ms": p_bound,
          "fused_agg_partials_plain_ms": pp_ms, "fused_agg_partials_warm_q6": t_q6,
          "fused_agg_partials_cold_q6_block": t_cold_q6, "pairs_on_warm_q6": d8,
          "fused_agg_combine_pack_ms": c_ms, "fused_agg_combine_pack_bound_ms": c_bound,
          "fused_agg_combine_pack_plain_ms": cp_ms,
          "group_warm_q1": t_warm_q1, "group_cold_q1_block": t_cold_q1,
          "group_warm_l_quantity": t_qty, "group_on_warm_q6": t_q6_grouped,
          "hbm_bytes_per_s": HBM_BYTES_PER_S})

    # the mask and the top-K kernels at their main-path shapes, held to their
    # plain versions on the main path's own inputs
    ev_sel = scan_evs["warm_selective"]
    t_mask = time_mask(fm, ev_sel.plan.mask_program, ev_sel._stacked_device(cache10))
    payload = list(range(len(ev_tw.plan.schema)))
    pay_t = ev_tw._stacked_device(cache, payload)
    cand_t = _pick(pay_t, payload, ev_tw.plan.device_cols)
    check_topn_kernels(ft, fx, ev_tw.plan.topn_program, cand_t, pay_t, "warm raw TopN")
    t_topn = time_topn(ft, ev_tw.plan.topn_program, cand_t, pay_t)
    del pay_t, cand_t
    torch.cuda.empty_cache()
    emit({"phase": "timings", "card": card, "fused_mask_warm_selective": t_mask,
          "topn_warm": t_topn, "hbm_bytes_per_s": HBM_BYTES_PER_S})

    emit({"phase": "profile", "card": card,
          "cold": profile_runs(lambda: ev.run(FixtureScanSource(kvs)), 1),
          "warm": profile_runs(lambda: ev_w.run(None, cache), 3),
          "cold_q1": profile_runs(lambda: ev_c1.run(FixtureScanSource(kvs)), 1),
          "warm_q1": profile_runs(lambda: ev_w1.run(None, cache), 3),
          "warm_filter_limit": profile_runs(lambda: scan_evs["warm_filter"].run(None, cache10), 1),
          "warm_selective_filter": profile_runs(lambda: ev_sel.run(None, cache10), 3),
          "cold_topn": profile_runs(lambda: ev_tc.run(FixtureScanSource(kvs)), 1),
          "warm_topn": profile_runs(lambda: ev_tw.run(None, cache), 3)})

    # ---- phase zone: the zone rung over the 100M-row plain image -------------
    # the earlier pins released (the layouts share the per-block pin LRU);
    # the layouts' host build timed apart: it launches nothing
    t_zone = time.perf_counter()
    cache.drop_device()
    cache10.drop_device()
    torch.cuda.empty_cache()
    zone_evs = {name: TorchDagEvaluator(wire, block_rows=1 << 17, device="cuda")
                for name, wire in (("q6", q6_wire), ("q1", q1_wire), ("q1_topn", q1t_wire))}
    zone_wants = {"q6": want_q6, "q1": want_q1, "q1_topn": fx.q1_topn_oracle(want_q1)}
    zone_unary = {"q6": ev_w, "q1": ev_w1, "q1_topn": ev_q1t_w}
    layouts = {}
    for name in ("q6", "q1"):
        t0 = time.perf_counter()
        layout = zone_evs[name]._zone_rung().plan_tiles(cache)[0]
        torch.cuda.synchronize()
        layouts[name] = {"host_build_s": time.perf_counter() - t0, "rows": layout.n_rows,
                         "tiles": layout.n_tiles, "slots": layout.n_slots,
                         "sort_col": layout.sort_col,
                         "lanes": {str(i): str(t.dtype) for i, t in layout.cols.items()},
                         "pinned_bytes": sum(t.numel() * t.element_size()
                                             for t in layout.tensors())}
    # ---- the zone main path: counts from 0 here to its end -------------------
    fa.reset_launches()
    zone_s, zone_per_request = {}, {}
    for name, runs in (("q6", 6), ("q1", 6), ("q1_topn", 3)):
        ev_z = zone_evs[name]
        zone_s[name] = []
        before = dict(fa.LAUNCHES)
        for _ in range(runs):
            resp, t = timed_run(ev_z, None, cache)
            check_rows(resp, zone_wants[name], f"zone {name}")
            zone_s[name].append(t)
        if ev_z.zone_stats.served != runs:
            raise AssertionError(f"zone {name}: the rung served {ev_z.zone_stats.served} of "
                                 f"{runs} ({ev_z.zone_stats.last_decline})")
        zone_per_request[name] = {k: (fa.LAUNCHES[k] - before[k]) / runs for k in ZONE_KERNELS}
    zone_launches = dict(fa.LAUNCHES)
    # ---- end of the zone main path -------------------------------------------
    for name, secs in zone_s.items():
        ev_z = zone_evs[name]
        got = ev_z.run(None, cache).encode()
        unary_s = []
        for _ in range(3):
            resp, t = timed_run(zone_unary[name], None, cache)
            unary_s.append(t)
        if resp.encode() != got:
            raise AssertionError(f"zone {name}: not byte-identical to route_hint='unary'")
        st = ev_z.zone_stats
        emit({"phase": "zone", "query": name, "rows": n_warm, "block_rows": 1 << 17,
              "matches_oracle": True, "byte_identical_to_unary": True,
              "tiles": {"examined": st.examined, "full": st.full, "partial": st.partial,
                        "empty": st.empty},
              "seconds": secs, "median_s": sorted(secs)[len(secs) // 2],
              "unary_seconds": unary_s, "unary_median_s": sorted(unary_s)[1],
              "launches_per_request": zone_per_request[name],
              "card": card})
    # the kernels against their plain versions on the main-path layouts and
    # on a synthetic one (NULLs in the key and values, negative values,
    # var_pop/min/max, the null-safe ops, 256-row tiles)
    zone_errs = dict.fromkeys(ZONE_KERNELS, 0.0)
    zcache = fx.zone_cache(4_000_000, 1 << 17, SEED + 5)
    ev_zs = TorchDagEvaluator(dag_to_wire(fx.zone_dag()), block_rows=1 << 17, device="cuda")
    checked = {}
    for name, ev_z, c, tr in (("q6", zone_evs["q6"], cache, None),
                              ("q1", zone_evs["q1"], cache, None),
                              ("synthetic_256", ev_zs, zcache, 256),
                              ("synthetic_1001", ev_zs, zcache, 1001)):
        out, layout, n_full, n_partial = fx.zone_kernel_outputs(ev_z, c, tr)
        errs_z = check_zone_outputs(out, fx.zone_kernel_outputs(ev_z, c, tr)[0], f"zone {name}")
        for k, e in errs_z.items():
            zone_errs[k] = max(zone_errs[k], e)
        checked[name] = {"tile_rows": layout.tile_rows, "tiles": layout.n_tiles,
                         "full": n_full, "partial": n_partial, "max_abs_err": errs_z}
        del out
    # the fold at its edges: one slot and many, empty and unlisted slots,
    # 49 leaves, 79 segments a slot, no listed tile, row maps of stale words
    for name in fx.ZONE_FOLD_CASES:
        chk = fx.zone_fold_check(*fx.zone_fold_case(name, "cuda"))
        zone_errs["zone_fold"] = max(zone_errs["zone_fold"], chk["max_abs_err"])
        checked[f"fold_{name}"] = chk
    # the synthetic plan end to end at 256-row tiles, against the stacked kernels
    ev_su = stacked(TorchDagEvaluator(dag_to_wire(fx.zone_dag()), block_rows=1 << 17,
                                      device="cuda"))
    packed_s = ev_zs._zone_rung().try_run(zcache, 256)
    if ev_zs._finalize_agg(*packed_s).encode() != ev_su.run(None, zcache).encode():
        raise AssertionError("synthetic zone plan at 256-row tiles differs from the unary route")
    del zcache, packed_s
    t_zone_q1 = time_zone(fz, zone_evs["q1"], cache)
    t_zone_q6 = time_zone(fz, zone_evs["q6"], cache)
    emit({"phase": "zone", "case": "kernels", "card": card, "layouts": layouts,
          "checked": checked, "int_words_equal": True, "f64_rel_tol": REL_TOL,
          "bit_identical_reruns": True, "q1": t_zone_q1, "q6": t_zone_q6,
          "instances": no_local_memory("zone_full/zone_partial",
                                       [fz.tiles_attributes(*i) for i in fz.TILE_INSTANCES])
          + no_local_memory("zone_fold", [fz.fold_attributes()]),
          "host_split_ms": {q: zone_request_split(zone_evs[q], cache, q)
                            for q in ("q6", "q1")},
          "launches": zone_launches,
          "profile_q6": profile_runs(lambda: zone_evs["q6"].run(None, cache), 3),
          "profile_q1": profile_runs(lambda: zone_evs["q1"].run(None, cache), 3),
          "phase_seconds": time.perf_counter() - t_zone})

    # ---- phase batch: programs #10 and #11 (its own main path) ----------------
    bt = phase_batch(cache, want_batch, card)

    # ---- phase mesh: programs #16, #18, #19 and #20 (its own main path) --------
    mesh_out = phase_mesh(fx, card, device, kvs, cold_arrays, cache, want_batch, bt)
    del kvs
    for key in ("regions", "enc_regions", "x_wants"):  # the mesh phase was their last use
        bt.pop(key)
    cache.drop_device()
    torch.cuda.empty_cache()

    # ---- phase 12: encoded images --------------------------------------------
    # the plain image's kernel outputs and pinned bytes, then its pins
    # released and the same blocks encoded in place
    t_enc = time.perf_counter()
    br = 1 << 17
    ev_all = TorchDagEvaluator(dag_to_wire(fx.filter_dag("scan", SCAN_LIMIT)), block_rows=br,
                               device="cuda")
    pin_sets = {"all_7_columns": (ev_all, list(range(7))), "q6_4_columns": (ev_w, None)}
    plain_out = fx.warm_kernel_outputs(cache, br, device)
    pins_plain = pinned_bytes(cache, pin_sets)
    cache10.drop_device()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    changed = encoding.encode_blocks(cache)
    encoding.encode_blocks(cache10)
    encode_s = time.perf_counter() - t0
    pins_enc = pinned_bytes(cache, pin_sets)
    for name, plain_b in pins_plain.items():
        if pins_enc[name] > 0.3 * plain_b:
            raise AssertionError(f"encoded {name} pins {pins_enc[name]} B, over 30% of {plain_b}")
    check_encoded_outputs(fx.warm_kernel_outputs(cache, br, device), plain_out)
    del plain_out
    emit({"phase": "encoded", "case": "image", "rows": n_warm, "block_rows": br,
          "encodings": {str(k): v for k, v in changed.items()}, "encode_s": encode_s,
          "pinned_bytes_plain": pins_plain, "pinned_bytes_encoded": pins_enc,
          "kernels_equal_plain_versions_and_plain_image": True, "card": card})

    # ---- the encoded main path: counts from 0 here to the end of the
    # date-sorted queries --------------------------------------------------------
    enc_queries = (("q6", ev_w, want_q6, 6), ("q1", ev_w1, want_q1, 6),
                   ("selective_filter", ev_sel, want_sel_warm, 3),
                   ("config2_limit", scan_evs["warm_filter"], want_filter_warm, 3),
                   ("raw_topn", ev_tw, want_topn, 4),
                   ("q1_topn", ev_q1t_w, fx.q1_topn_oracle(want_q1), 4))
    fa.reset_launches()
    enc_s = {}
    for name, ev_x, want, runs in enc_queries:
        enc_s[name] = []
        for _ in range(runs):
            resp, t = timed_run(ev_x, None, cache)
            check_rows(resp, want, f"encoded warm {name}")
            enc_s[name].append(t)
    # the zone rung's Q1 layout, built anew over the encoded image (its
    # gathers decode the encoded columns on the host, then purge the decodes)
    zq1 = zone_evs["q1"]
    served = zq1.zone_stats.served
    enc_s["zone_q1"] = []
    for _ in range(3):
        resp, t = timed_run(zq1, None, cache)
        check_rows(resp, want_q1, "encoded warm zone q1")
        enc_s["zone_q1"].append(t)
    if zq1.zone_stats.served - served != 3:
        raise AssertionError(f"encoded zone q1 declined: {zq1.zone_stats.last_decline}")
    enc_cols = [c for b in cache.blocks for c in b.cols if isinstance(c, encoding.EncodedColumn)]
    if not enc_cols or any(c._data is not None for c in enc_cols):
        raise AssertionError("the layout's gathers left full decodes on the encoded image")
    del want_sel_warm, want_filter_warm
    n_sorted, cut_sorted = warm_rows_that_fit(n_warm, WARM_ROWS_FLOOR)
    s_arr = fx.sort_by_shipdate(fx.build_arrays(n_sorted, SEED))
    want_sorted = oracles_at_once({"q6": lambda: [fx.q6_oracle(s_arr)],
                                   "q1": lambda: fx.q1_oracle(s_arr),
                                   "raw_topn": lambda: fx.topn_oracle(s_arr, TOPN_K)})
    want_sorted["zone_q6"] = want_sorted["q6"]
    t0 = time.perf_counter()
    cache_s = fx.build_cache(n_sorted, br, SEED, arrays=s_arr, encode=True)
    sorted_build_s = time.perf_counter() - t0
    del s_arr
    sorted_runs = {}
    for name, ev_x in (("q6", ev_w), ("q1", ev_w1), ("raw_topn", ev_tw),
                       ("zone_q6", zone_evs["q6"])):
        secs = []
        for _ in range(4):
            resp, t = timed_run(ev_x, None, cache_s)
            check_rows(resp, want_sorted[name], f"date-sorted warm {name}")
            secs.append(t)
        sorted_runs[name] = {"first_run_with_pin_s": secs[0], "seconds": secs[1:],
                             "blocks_examined": ev_x.prune_stats[0],
                             "blocks_pruned": ev_x.prune_stats[1]}
    st = zone_evs["q6"].zone_stats
    if st.last_decline is not None or not st.empty:
        raise AssertionError(f"date-sorted zone q6: declined ({st.last_decline}) or no tile "
                             "proved empty")
    sorted_runs["zone_q6"]["tiles"] = {"examined": st.examined, "full": st.full,
                                       "partial": st.partial, "empty": st.empty}
    enc_launches = dict(fa.LAUNCHES)
    # ---- end of the encoded main path ------------------------------------------
    for name in MAIN_PATH_KERNELS + ZONE_KERNELS:
        if enc_launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the encoded main path")
    if sorted_runs["q6"]["blocks_pruned"] <= 0:
        raise AssertionError("the date-sorted Q6 pruned no block")
    for name, secs in enc_s.items():
        emit({"phase": "encoded", "query": name, "rows": n_warm, "block_rows": br,
              "matches_oracle": True, "first_run_with_pin_s": secs[0], "seconds": secs[1:],
              "median_s": sorted(secs[1:])[len(secs[1:]) // 2],
              "rows_per_s": n_warm / sorted(secs[1:])[len(secs[1:]) // 2], "card": card})
    s_kinds = {str(i): getattr(c, "kind", "plain") for i, c in enumerate(cache_s.blocks[0].cols)}
    emit({"phase": "encoded", "case": "date_sorted", "rows": n_sorted, "reduced": cut_sorted,
          "block_rows": br, "blocks": len(cache_s.blocks), "kinds": s_kinds,
          "build_and_encode_s": sorted_build_s, "shipdate_k_cap": cache_s.blocks[0].cols[4].k_cap,
          "queries": sorted_runs, "matches_oracle": True, "launches": enc_launches,
          "card": card})

    # ---- phase 12 timings: each kernel on the encoded image beside the plain
    # image's times of the timings phase above, in this same call -----------------
    img_e = ev_w._stacked_device(cache)
    t_q6_e = time_agg_partials(fa, prog, img_e, 20)
    p_ms_e, pp_ms_e = t_q6_e["ms"], t_q6_e["plain_ms"]
    p_bound_e = (t_q6_e["bound_ms"], t_q6_e["bound_by"])
    dec = {"bp_int8_l_quantity": time_decode(fm, img_e, 0),
           "bp_int32_l_extendedprice": time_decode(fm, img_e, 1),
           "bp_int16_l_shipdate": time_decode(fm, img_e, 3)}
    del img_e
    img1_e = ev_w1._stacked_device(cache, ev_w1._ship_cols(group_cols))
    t_warm_q1_e = time_group_kernels(
        ga, prog1, img1_e, _capacity_for(prog1, 1, (dict_lens[0] + 1) * (dict_lens[1] + 1)), 10)
    del img1_e
    t_mask_e = time_mask(fm, ev_sel.plan.mask_program, ev_sel._stacked_device(cache10))
    pay_e = ev_tw._stacked_device(cache, payload)
    cand_e = _pick(pay_e, payload, ev_tw.plan.device_cols)
    t_topn_e = time_topn(ft, ev_tw.plan.topn_program, cand_e, pay_e)
    del pay_e, cand_e
    img_s = ev_w._stacked_device(cache_s, keep=ev_w._prune_keep(cache_s))
    t_q6_s = time_agg_partials(fa, prog, img_s, 20)
    p_ms_s, rows_s = t_q6_s["ms"], t_q6_s["rows"]
    p_bound_s = (t_q6_s["bound_ms"], t_q6_s["bound_by"])
    dec["rle_int64_l_shipdate_date_sorted"] = time_decode(fm, img_s, 3)
    del img_s
    emit({"phase": "encoded", "case": "timings", "card": card,
          "fused_agg_partials": {"ms": p_ms_e, "plain_image_ms": p_ms, "plain_ms": pp_ms_e,
                                 "bound_ms": p_bound_e[0], "bound_by": p_bound_e[1],
                                 "plain_image_bound_ms": p_bound},
          "fused_agg_partials_date_sorted_pruned": {
              "ms": p_ms_s, "valid_rows": rows_s, "bound_ms": p_bound_s[0],
              "bound_by": p_bound_s[1]},
          "group_warm_q1": t_warm_q1_e, "group_warm_q1_plain_image": t_warm_q1,
          "fused_mask_warm_selective": t_mask_e, "fused_mask_plain_image": t_mask,
          "topn_warm": t_topn_e, "decode_column": dec,
          "profile_warm_q6": profile_runs(lambda: ev_w.run(None, cache), 3),
          "profile_date_sorted_q6": profile_runs(lambda: ev_w.run(None, cache_s), 3),
          "phase_seconds": time.perf_counter() - t_enc})
    del cache_s
    cache.drop_device()
    cache10.drop_device()
    torch.cuda.empty_cache()

    # ---- phase join: programs #14 and #15 (its own main path) -----------------
    jn = phase_join(fx, card, device)

    # ---- phase mesh_grouped: program #17 (its own main path) ------------------
    mg = phase_mesh_grouped(fx, card, device)

    # ---- phase high_capacity: group slots past the shared rows (its own main path)
    hc = phase_high_capacity(fx, card, device, n_warm, want_batch)

    # ---- phase write_path: the region write path (its own main path) ----------
    wp = phase_write_path(fx, card, device, cache10, ev_w1)

    main_path = {"fused_agg_partials": q6_launches, "fused_agg_combine_pack": q6_launches,
                 "fused_group_agg_partials": q1_launches,
                 "fused_group_agg_combine_pack": q1_launches, "fused_mask": scan_launches,
                 "topn_candidates": topn_launches, "topn_merge": topn_launches,
                 "topn_pack": topn_launches}
    main_path.update(dict.fromkeys(ZONE_KERNELS, zone_launches))
    main_path.update(dict.fromkeys(BATCH_KERNELS, bt["launches"]))
    main_path.update(dict.fromkeys(JOIN_KERNELS, jn["launches"]))
    main_path["mesh_merge"] = mesh_out["launches"]
    main_path["mesh_fold"] = mesh_out["launches"]
    main_path.update(dict.fromkeys(DICT_KERNELS, mg["launches"]))
    main_path.update(dict.fromkeys(WIDE_KERNELS + SORT_KERNELS, hc["launches"]))
    main_path["patch_stacked"] = wp["launches"]
    for name, counts in main_path.items():
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on its main path")
    src = "tikv_tpu_torch/csrc/fused_agg.cu"
    scan_src = "tikv_tpu_torch/csrc/fused_scan.cu"
    group_p_err = max(errs["fused_group_agg_partials"], t_warm_q1["max_abs_err_partials"],
                      t_cold_q1["max_abs_err_partials"], t_qty["max_abs_err_partials"])
    group_c_err = max(errs["fused_group_agg_combine_pack"], t_warm_q1["max_abs_err_combine"],
                      t_cold_q1["max_abs_err_combine"], t_qty["max_abs_err_combine"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    kernels = [
        {"name": "fused_agg_partials", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:855",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:883", "tikv_tpu/copr/rpn.py:216"],
         "launches": q6_launches["fused_agg_partials"],
         "max_abs_err": max(errs["fused_agg_partials"], p_err, t_cold_q6["max_abs_err"]),
         "ms": p_ms, "plain_ms": pp_ms, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None, "attributes": t_q6["attributes"],
         "cold_block": {k: t_cold_q6[k] for k in ("rows", "ms", "plain_ms", "bound_ms")},
         "date_sorted": {k: t_q6_s[k] for k in ("rows", "ms", "plain_ms", "bound_ms")},
         "pairs_on_warm_q6": d8["medians_ms"]},
        {"name": "fused_agg_combine_pack", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:737",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:1436"],
         "launches": q6_launches["fused_agg_combine_pack"],
         "max_abs_err": max(errs["fused_agg_combine_pack"], c_err),
         "ms": c_ms, "plain_ms": cp_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": None},
        {"name": "fused_group_agg_partials", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:921",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:855", "tikv_tpu/copr/jax_eval.py:883",
                           "tikv_tpu/copr/jax_eval.py:460"],
         "launches": q1_launches["fused_group_agg_partials"], "max_abs_err": group_p_err,
         "ms": t_warm_q1["partials_ms"], "plain_ms": t_warm_q1["partials_plain_ms"],
         "bound_ms": t_warm_q1["partials_bound_ms"],
         "bound_by": t_warm_q1["partials_bound_by"], "library_ms": None},
        {"name": "fused_group_agg_combine_pack", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:737",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:1436"],
         "launches": q1_launches["fused_group_agg_combine_pack"], "max_abs_err": group_c_err,
         "ms": t_warm_q1["combine_ms"], "plain_ms": t_warm_q1["combine_plain_ms"],
         "bound_ms": t_warm_q1["combine_bound_ms"],
         "bound_by": t_warm_q1["combine_bound_by"], "library_ms": None},
        {"name": "fused_mask", "route": "cuda", "source": scan_src,
         "replaces": "tikv_tpu/copr/jax_eval.py:831", "launches": scan_launches["fused_mask"],
         "max_abs_err": 0.0, "ms": t_mask["ms"], "plain_ms": t_mask["plain_ms"],
         "bound_ms": t_mask["bound_ms"], "bound_by": t_mask["bound_by"],
         "library_ms": t_mask["library_ms"]},
    ] + [
        {"name": name, "route": "cuda", "source": scan_src, "replaces": replaces,
         "replaces_also": also, "launches": topn_launches[name], "max_abs_err": 0.0,
         "ms": t_topn[name]["ms"], "plain_ms": t_topn[name]["plain_ms"],
         "bound_ms": t_topn[name]["bound_ms"], "bound_by": t_topn[name]["bound_by"],
         # torch.topk is the yardstick of the whole top-K step: it stands
         # beside the kernel that reads the rows
         "library_ms": t_topn["library_ms"] if name == "topn_candidates" else None,
         "attributes": t_topn[name].get("attributes")}
        for name, replaces, also in (
            ("topn_candidates", "tikv_tpu/copr/jax_eval.py:1537",
             ["tikv_tpu/copr/jax_eval.py:673", "tikv_tpu/copr/jax_eval.py:651"]),
            ("topn_merge", "tikv_tpu/copr/jax_eval.py:673", ["tikv_tpu/copr/jax_eval.py:1537"]),
            ("topn_pack", "tikv_tpu/copr/jax_eval.py:1632", ["tikv_tpu/copr/jax_eval.py:710"]))
    ]
    # each kernel over the encoded 100M image (phase 12), beside its numbers
    # above over the plain image, and its launches on the encoded main path
    on_encoded = {
        "fused_agg_partials": {"ms": p_ms_e, "plain_ms": pp_ms_e, "bound_ms": p_bound_e[0]},
        "fused_agg_combine_pack": {},
        "fused_group_agg_partials": {"ms": t_warm_q1_e["partials_ms"],
                                     "plain_ms": t_warm_q1_e["partials_plain_ms"],
                                     "bound_ms": t_warm_q1_e["partials_bound_ms"]},
        "fused_group_agg_combine_pack": {"ms": t_warm_q1_e["combine_ms"],
                                         "bound_ms": t_warm_q1_e["combine_bound_ms"]},
        "fused_mask": {k: t_mask_e[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
    }
    for name in ("topn_candidates", "topn_merge", "topn_pack"):
        on_encoded[name] = {k: t_topn_e[name][k] for k in ("ms", "plain_ms", "bound_ms")}
    for entry in kernels:
        entry["encoded"] = dict(on_encoded[entry["name"]],
                                launches=enc_launches[entry["name"]])
    # the zone-tile kernels at warm Q1's layout (Q6's, which has no full
    # tile, beside them), their launches on the zone main path; the encoded
    # image's layout is the plain image's (the layout narrows its own lanes)
    zone_src = "tikv_tpu_torch/csrc/fused_zone.cu"
    for name, replaces, also in (
            ("zone_full", "tikv_tpu/copr/jax_zone.py:496", ["tikv_tpu/copr/jax_zone.py:524"]),
            ("zone_partial", "tikv_tpu/copr/jax_zone.py:583",
             ["tikv_tpu/copr/rpn.py:216", "tikv_tpu/copr/jax_zone.py:614"]),
            ("zone_fold", "tikv_tpu/copr/jax_zone.py:774",
             ["tikv_tpu/copr/jax_zone.py:524", "tikv_tpu/copr/jax_zone.py:614"])):
        t = t_zone_q1[name]
        kernels.append({
            "name": name, "route": "cuda", "source": zone_src, "replaces": replaces,
            "replaces_also": also, "launches": zone_launches[name],
            "max_abs_err": zone_errs[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "library": t["library"], "q6": t_zone_q6[name],
            "encoded": {"launches": enc_launches[name]}})
    # program #1 runs inside every kernel above that reads the image
    # (fa_load); its export decode_column is launched by the checks alone, so
    # its launches on the main path are those of the kernels that inline it,
    # on the encoded path
    d = dec["bp_int32_l_extendedprice"]
    kernels.append({
        "name": "decode_column", "route": "cuda", "source": "tikv_tpu_torch/csrc/fa_walk.cuh",
        "replaces": "tikv_tpu/copr/kernels.py:1172",
        "replaces_also": ["tikv_tpu/copr/jax_eval.py:434"],
        "launches": sum(enc_launches[k] for k in IMAGE_READERS),
        "launches_standalone": enc_launches["decode_column"],
        "inlined_in": list(IMAGE_READERS), "max_abs_err": 0.0,
        "ms": d["ms"], "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": d["library_ms"], "shapes": dec})
    # the batch kernels at batch A's shape (eight riders over the 100M
    # image), the 64-region Q1 batch and the 8 encoded regions beside them;
    # their launches on the batch main path (the encoded entry: its encoded
    # regions' batches)
    for name, key, replaces, also in (
            ("batch_partials", "partials", "tikv_tpu/copr/jax_eval.py:1710",
             ["tikv_tpu/copr/jax_eval.py:1994", "tikv_tpu/copr/jax_eval.py:469",
              "tikv_tpu/copr/jax_eval.py:460"]),
            ("batch_combine_pack", "combine", "tikv_tpu/copr/jax_eval.py:1994",
             ["tikv_tpu/copr/jax_eval.py:1710", "tikv_tpu/copr/jax_eval.py:737"])):
        t = bt["same_region"]

        def at(tb, key=key):
            return {f: tb[f"{key}_{f}"] for f in ("ms", "plain_ms", "bound_ms", "bound_by")}

        kernels.append({
            "name": name, "route": "cuda", "source": "tikv_tpu_torch/csrc/fused_batch.cu",
            "replaces": replaces, "replaces_also": also, "launches": bt["launches"][name],
            "max_abs_err": bt["max_abs_err"][name], **at(t), "library_ms": None,
            "attributes": t["partials_attributes"] if key == "partials" else None,
            "xregion": at(bt["xregion"]),
            "encoded": dict(at(bt["xregion_encoded"]), launches=bt["encoded_launches"][name])})
    # the join probes at the join phase's shape (500K probe rows against 125K
    # build rows), the 32M-row synthetic lane beside them
    for name, replaces in (("join_rank_probe", "tikv_tpu/copr/jax_join.py:270"),
                           ("join_hash_probe", "tikv_tpu/copr/jax_join.py:279")):
        t = jn["phase_shape"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": JOIN_SRC, "replaces": replaces,
            "launches": jn["launches"][name],
            "max_abs_err": max(c[name] for c in jn["checks"].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "synthetic": jn["synthetic"][name]})
    # the cross-shard merge of packed states at Q1 over the 64 regions (a
    # region's states from the devices that hold its slabs), the 100M image
    # alone beside it
    t = mesh_out["merge"]["xregion_q1_64"]
    kernels.append({
        "name": "mesh_merge", "route": "cuda", "source": MESH_SRC,
        "replaces": "tikv_tpu/parallel/mesh.py:128",
        "replaces_also": ["tikv_tpu/parallel/mesh.py:148", "tikv_tpu/parallel/mesh.py:808"],
        "launches": mesh_out["launches"]["mesh_merge"], "max_abs_err": mesh_out["max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "shapes": mesh_out["merge"]})
    # the fold of the shards' raw rows at the cold mesh's shape (cold Q1, 8
    # shards of 1,024 rows into the carry), its other main-path shapes and
    # the launches it replaces (pair_ms) beside it
    t = mesh_out["fold"]["cold_q1_g1_rps1024"]
    kernels.append({
        "name": "mesh_fold", "route": "cuda", "source": MESH_SRC,
        "replaces": "tikv_tpu/parallel/mesh.py:128",
        "replaces_also": ["tikv_tpu/parallel/mesh.py:148", "tikv_tpu/parallel/mesh.py:183",
                          "tikv_tpu/parallel/mesh.py:329", "tikv_tpu/parallel/mesh.py:413"],
        "launches": mesh_out["launches"]["mesh_fold"],
        "max_abs_err": max(mesh_out["fold_err"], mg["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None, "pair_ms": t["pair_ms"],
        "shapes": mesh_out["fold"], "remap": mg["fold"],
        "attributes": mesh_out["fold_attributes"], "cold_super_block_split_ms": mesh_out["split"]})
    # the group dictionary's kernels at the path's inputs (Q1 at G = 1, a
    # shard's 131,072 rows; the shard union with the carried dictionary, the
    # global union of the gathered ones beside it)
    for name, replaces, also in (
            ("dict_keys", "tikv_tpu/parallel/mesh.py:366", ["tikv_tpu/copr/rpn.py:216"]),
            ("dict_union", "tikv_tpu/parallel/mesh.py:378", ["tikv_tpu/parallel/mesh.py:388"]),
            ("dict_ids", "tikv_tpu/parallel/mesh.py:407", ["tikv_tpu/parallel/mesh.py:413"])):
        t = mg["kernels"][name]
        entry = {"name": name, "route": "cuda", "source": DICT_SRC, "replaces": replaces,
                 "replaces_also": also, "launches": mg["launches"][name], "max_abs_err": 0.0,
                 "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t}
        if name == "dict_union":
            entry["global"] = mg["kernels"]["dict_union_global"]
        if name == "dict_ids":
            entry["past_8192_slots"] = hc["ids"]  # in device memory, beside the union's sort route
        kernels.append(entry)
    # the reused kernels' launches on the mesh main paths (the grouped
    # combine's and, on the grouped path, the packed merge's: 0)
    for entry in kernels:
        if entry["name"] in MESH_COUNTED:
            entry["mesh_launches"] = mesh_out["launches"][entry["name"]]
        if entry["name"] in MESH_GROUPED_COUNTED and entry["name"] not in DICT_KERNELS:
            entry["mesh_grouped_launches"] = mg["launches"][entry["name"]]
        if entry["name"] == "fused_group_agg_partials":
            entry["mesh_grouped_shard"] = mg["pair"]
        if entry["name"] in HC_KERNELS:
            entry["high_capacity_launches"] = hc["launches"][entry["name"]]
    # the wide route at the warm per-supplier query's image (262,144 slots at
    # 100M rows), the cold block's shape and the same image on the shared
    # rows at c_max slots beside it
    for name, key, replaces, also in (
            ("group_wide_partials", "partials", "tikv_tpu/copr/jax_eval.py:855",
             ["tikv_tpu/copr/jax_eval.py:883", "tikv_tpu/copr/jax_eval.py:921",
              "tikv_tpu/copr/jax_eval.py:349", "tikv_tpu/copr/jax_eval.py:387"]),
            ("group_wide_combine", "combine", "tikv_tpu/copr/jax_eval.py:737",
             ["tikv_tpu/copr/jax_eval.py:1436"])):
        t = hc["warm"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "replaces_also": also, "launches": hc["launches"][name],
            "max_abs_err": max(hc["max_abs_err"], errs[name]),
            "ms": t[f"{key}_ms"], "plain_ms": t[f"{key}_plain_ms"],
            "bound_ms": t[f"{key}_bound_ms"], "bound_by": t[f"{key}_bound_by"],
            "library_ms": t["library_ms"] if key == "partials" else None,
            "library": t["library"] if key == "partials" else None,
            "capacity": t["capacity"], "rows": t["rows"],
            "cold_block": {f: hc["cold"][f"{key}_{f}"] for f in ("ms", "plain_ms", "bound_ms")},
            "mesh_shard": {f: hc["mesh_shard"][f"{key}_{f}"] for f in ("ms", "plain_ms",
                                                                       "bound_ms")},
            "shared_rows_same_image_ms": hc["shared"][f"{key}_ms"],
            "batch_riders": {name: {f: r[f"{key}_{f}"] for f in ("ms", "plain_ms", "bound_ms")}
                             for name, r in hc["riders"].items()},
            "wide_same_ids_at_c_max_plus_1_ms": hc["crossover"][f"{key}_ms"],
            "attributes": t["attributes"] if key == "partials" else t["combine_attributes"]})
    # the dictionary union's sort route at the grouped mesh's shard union
    # (the carried 32,768-slot dictionary and a shard's 131,072 keys)
    for name in SORT_KERNELS:
        t = hc["sort"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": DICT_SRC,
            "replaces": "tikv_tpu/parallel/mesh.py:378",
            "replaces_also": ["tikv_tpu/parallel/mesh.py:388"],
            "launches": hc["launches"][name], "max_abs_err": 0.0, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "global": hc["sort_global"].get(name),
            **({"redesign": "one launch a union, in place of the pair dict_count + "
                            "dict_compact", "attributes": t["attributes"]}
               if name == "dict_compact" else {})})
    # the image patch at the write path's 1% update (10,000 rows into the
    # region's Q1 pin, six lanes of 16 blocks of 65,536 rows), the 10M
    # image's Q1 lanes beside it; the re-pin it spares as the yardstick
    t = wp["region"]
    kernels.append({
        "name": "patch_stacked", "route": "cuda", "source": PATCH_SRC,
        "replaces": "tikv_tpu/copr/cache.py:186",
        "replaces_also": ["tikv_tpu/copr/cache.py:241", "tikv_tpu/copr/region_cache.py:551"],
        "launches": wp["launches"]["patch_stacked"], "max_abs_err": 0.0,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "library": t["library"],
        "repin_s": t["repin_s"], "shape": {k: t[k] for k in ("updates", "data_lanes",
                                                             "null_lanes")},
        "pins_per_delta": wp["pins_per_delta"], "image_10m": wp["big"]})
    # the two kernels redesigned for Hopper: their resources, their times
    # beside their yardsticks and bounds, the unions' passes and launches
    def mask_times(t):
        return {k: t[k] for k in ("ms", "library_ms", "bound_ms", "plain_ms", "rows",
                                  "attributes")}

    def union_times(t):
        return {k: t.get(k) for k in ("keys", "capacity", "tile", "passes", "ms", "library_ms",
                                      "bound_ms", "launches")}

    def batch_times(t):
        return {k: t[f"partials_{k}"] for k in ("ms", "bound_ms", "plain_ms", "attributes")}

    def topn_times(t):
        return {k: t["topn_candidates"][k] for k in ("ms", "bound_ms", "plain_ms", "attributes",
                                                      "select_cap")}

    def group_times(t):
        return {k: t[f"partials_{k}"] for k in ("ms", "bound_ms", "plain_ms", "attributes")}

    def agg_times(t):
        return {k: t[k] for k in ("rows", "ms", "bound_ms", "plain_ms", "attributes")}

    def wide_times(t):
        return {k: t.get(f"partials_{k}", t.get(k)) for k in ("rows", "capacity", "ms",
                                                              "bound_ms", "plain_ms",
                                                              "attributes")}

    def ids_times(t):
        return {k: t[k] for k in ("keys", "capacity", "ms", "ms_without_old", "bound_ms",
                                  "library_ms", "library_with_perm_ms", "attributes")}

    emit({"phase": "redesign", "card": card,
          "batch_partials": {
              "rows_a_thread": fb.ROWS, "batch_a": batch_times(bt["same_region"]),
              "xregion_q1": batch_times(bt["xregion"]),
              "xregion_q1_encoded": batch_times(bt["xregion_encoded"]),
              "mesh_busiest_device": {k: batch_times(t)
                                      for k, t in mesh_out["per_device"].items()},
              "launches": bt["launches"]["batch_partials"]},
          "topn_candidates": {
              "step_rows": fm.TOPN_STEP_ROWS, "tile": t_topn["tile"],
              "plain_image": topn_times(t_topn), "encoded": topn_times(t_topn_e),
              "mesh_shard": topn_times(mesh_out["topn"]["step_shard"]),
              "launches": topn_launches["topn_candidates"]},
          "topn_merge": {
              "fan_max": fm.MERGE_FAN_MAX, "warm_100m": t_topn["topn_merge"],
              "warm_100m_encoded": t_topn_e["topn_merge"],
              "mesh_shard_step": mesh_out["topn"]["step_shard"]["topn_merge"],
              "mesh_finalize": mesh_out["topn"]["finalize"]["topn_merge"],
              "launches": topn_launches["topn_merge"]},
          "dict_merge": {
              "chunk": fd.MERGE_CHUNK, "fan_max": fd.MERGE_FAN_MAX,
              "shard_union": hc["sort"].get("dict_merge"),
              "global_union": hc["sort_global"].get("dict_merge"),
              "launches": hc["launches"]["dict_merge"]},
          "dict_keys": {
              "rows_a_thread": fd.KEY_ROWS,
              "mesh_grouped_shard": {k: mg["kernels"]["dict_keys"][k] for k in (
                  "rows", "stack_slots", "attributes", "ms", "bound_ms", "plain_ms")},
              "mesh_grouped_launches": mg["launches"]["dict_keys"]},
          "topn_pack": {
              "warm_100m": t_topn["topn_pack"], "warm_100m_encoded": t_topn_e["topn_pack"],
              "mesh_shard_step": mesh_out["topn"]["step_shard"]["topn_pack"],
              "mesh_finalize": mesh_out["topn"]["finalize"]["topn_pack"],
              "launches": topn_launches["topn_pack"]},
          "dict_compact": {
              "tile": fd.COMPACT_TILE, "shard_union": hc["sort"]["dict_compact"],
              "global_union": hc["sort_global"]["dict_compact"],
              "launches": hc["launches"]["dict_compact"]},
          "group_wide_combine": {
              k: {f: t[f"combine_{f}"] for f in ("ms", "bound_ms", "plain_ms", "attributes")}
              for k, t in (("per_supplier_warm", hc["warm"]), ("cold_block", hc["cold"]),
                           ("mesh_shard", hc["mesh_shard"]),
                           ("same_ids_at_c_max_plus_1", hc["crossover"]),
                           *(("rider_" + n, r) for n, r in hc["riders"].items()))},
          "fused_mask": {
              "rows_a_thread": fm.MASK_ROWS,
              "plain_image": mask_times(t_mask), "encoded": mask_times(t_mask_e),
              "launches": scan_launches["fused_mask"]},
          "fused_agg_partials": {
              "rows_a_thread": fa.ROWS, "warm_q6": agg_times(t_q6),
              "warm_q6_encoded": agg_times(t_q6_e), "date_sorted_q6": agg_times(t_q6_s),
              "cold_q6_block": agg_times(t_cold_q6), "pairs_on_warm_q6": d8,
              "launches": q6_launches["fused_agg_partials"]},
          "group_wide_partials": {
              "rows_a_thread": ga.ROWS, "per_supplier_warm": wide_times(hc["warm"]),
              "cold_block": wide_times(hc["cold"]), "mesh_shard": wide_times(hc["mesh_shard"]),
              "same_ids_at_c_max_plus_1": wide_times(hc["crossover"]),
              "batch_riders": {k: wide_times(t) for k, t in hc["riders"].items()},
              "shared_rows_at_c_max": group_times(hc["shared"]),
              "launches": hc["launches"]["group_wide_partials"]},
          "fused_group_agg_partials": {
              "rows_a_thread": ga.ROWS, "warm_q1": group_times(t_warm_q1),
              "warm_q1_encoded": group_times(t_warm_q1_e),
              "warm_l_quantity": group_times(t_qty), "cold_q1_block": group_times(t_cold_q1),
              "mesh_grouped_shard": group_times(mg["pair"]),
              "mesh_1024_row_shard": group_times(mesh_out["small_shard"]),
              "on_warm_q6": group_times(t_q6_grouped),
              "launches": q1_launches["fused_group_agg_partials"]},
          "mesh_fold": {
              "attributes": mesh_out["fold_attributes"], "cold_mesh": mesh_out["fold"],
              "grouped_mesh": mg["fold"], "cold_super_block_split_ms": mesh_out["split"],
              "launches": mesh_out["launches"]["mesh_fold"],
              "mesh_grouped_launches": mg["launches"]["mesh_fold"]},
          "dict_ids": {
              "mesh_grouped_shard": ids_times(mg["kernels"]["dict_ids"]),
              "past_8192_slots": ids_times(hc["ids"]),
              "mesh_grouped_launches": mg["launches"]["dict_ids"]},
          "dict_union": {
              "attributes": fd.union_attributes(), "keys_a_thread": fd.KEYS_A_THREAD,
              "tile_min": fd.TILE_MIN, "sort_tile": fd.SORT_TILE,
              "mesh_grouped_shard": union_times(mg["kernels"]["dict_union"]),
              "mesh_grouped_global": union_times(mg["kernels"]["dict_union_global"]),
              "mesh_grouped_launches": mg["launches"]["dict_union"],
              "high_capacity_shard": {k: hc["sort"].get(k) for k in (
                  "keys", "capacity", "sorted_keys", "tile_sort_blocks", "merge_levels",
                  "tile_sort_ms", "union_ms", "union_library_ms")},
              "high_capacity_global": {k: hc["sort_global"].get(k) for k in (
                  "keys", "merge_levels", "tile_sort_ms", "union_ms", "union_library_ms")},
              "high_capacity_launches": {k: hc["launches"][k] for k in
                                         ("dict_union",) + SORT_KERNELS}}})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
