#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device  — the card (nvidia-smi name and power limit); exits 1 without CUDA
2. build   — nvcc builds every kernel from ``tikv_tpu_torch/csrc``; ptxas report
3. kernels — each kernel against its plain PyTorch version on the same seeded
             inputs, at a cold block (65,536 rows) and at the warm stacked
             shape: int leaves equal, f64 leaves to rel 1e-12, two runs
             bit-identical; the grouped kernels with ids from two
             dictionary-code columns with NULLs, 60 host ids (all ten
             aggregates) and 300 host ids (integer leaves, atomic partials)
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
8. timings — cold/warm rows/s (host clock around synchronized work), each
             kernel's ms per launch (CUDA events), its bound, the plain
             version's time
9. profile — device time by kernel and the device's busy share of the
             wall time (torch.profiler), over one cold and three warm runs of
             Q6 and of Q1

Then the card's line, the kernels line and, last, the ok line.  The launch
counts in the kernels line are those of the main paths only: Q6 (phases 4-5)
for the capacity-1 kernels and Q1 (phases 6-7) for the grouped ones, each
counted from 0 just before its path and read just after.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def emit(obj) -> None:
    # group keys are bytes: print them as text
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


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """The least ms the card could take: the larger of bytes over the HBM
    rate and operations over the compute rate, and which of the two."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
    exact = got == want
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
    grid, threads = fa.kernel_grid()
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
        scratch = torch.empty((grid, len(prog.aggs), 2), dtype=torch.int64, device=device)
        fa.launch_partials(prog, img, scratch)
        err_p = check_partials(prog, scratch, fa.partials_plain(prog, img, grid, threads),
                               f"{name} partials")
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
    return errs


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
    grouped cases, at a cold block and at the warm stacked shape."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    errs = {"fused_group_agg_partials": 0.0, "fused_group_agg_combine_pack": 0.0}
    for n_blocks, block_rows, shape in ((1, 1 << 16, "cold_block"), (763, 1 << 17, "warm_stacked")):
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
            parts = ga.new_partials(prog, img, cap)
            ga.launch_partials(prog, img, cap, parts)
            if shared:
                err_p = check_group_partials(
                    prog, parts, ga.partials_plain(prog, img, cap, ga.launch_grid(img)),
                    f"{shape} {kind} partials")
            out = (torch.empty_like(got[0]), torch.empty_like(got[1]))
            ga.launch_combine(prog, img, cap, parts, None, out)
            err_c = compare_packed(prog, out, ga.combine_plain(prog, img, cap, parts),
                                   f"{shape} {kind} combine")
            errs["fused_group_agg_partials"] = max(errs["fused_group_agg_partials"], err_p, err_e2e)
            errs["fused_group_agg_combine_pack"] = max(errs["fused_group_agg_combine_pack"], err_c)
            nv = img.n_valids
            emit({"phase": "kernels", "case": f"group_{kind}_{shape}", "n_blocks": n_blocks,
                  "block_rows": block_rows, "rows": int(nv if isinstance(nv, int) else nv.sum()),
                  "capacity": cap, "leaves": len(prog.leaves), "c_max": prog.c_max,
                  "partials": "shared" if shared else "atomic",
                  "int_leaves_equal": True, "f64_rel_tol": REL_TOL, "bit_identical_reruns": True,
                  "max_abs_err_end_to_end": err_e2e, "max_abs_err_partials": err_p,
                  "max_abs_err_combine": err_c})
            del prog, img, got, want, carry, want2, parts, out
            torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phases 4-9
# ---------------------------------------------------------------------------

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
    share of the window's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops repeat their kernels' device time
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            device_ms[evt.key] = us / 1e3
    busy = sum(device_ms.values())
    return {"runs": n, "wall_ms": wall_ms, "device_ms": device_ms,
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
    if prog.shared_rows(cap):
        err_p = check_group_partials(prog, parts, ga.partials_plain(prog, img, cap, grid),
                                     "timed partials")
    err_c = compare_packed(prog, out, ga.combine_plain(prog, img, cap, parts), "timed combine")
    pp_ms = cuda_ms(lambda: ga.partials_plain(prog, img, cap, grid), 3, warmup=1)
    cp_ms = cuda_ms(lambda: ga.combine_plain(prog, img, cap, parts), 3, warmup=1)
    nv = img.n_valids
    rows = int(nv if isinstance(nv, int) else nv.sum())
    L = len(prog.leaves)
    row_bytes = 8 * len(prog.col_f64) + sum(1 for m in img.nulls if m is not None) \
        + (4 if img.gids is not None else 0)
    part_bytes = parts.numel() * 8
    p_bound, p_by = bound(rows * row_bytes + 16 * img.n_blocks + part_bytes,
                          rows * (len(prog.code) + L))
    c_bound, c_by = bound(part_bytes + (prog.n_int + prog.n_f64) * cap * 8, parts.numel())
    return {"rows": rows, "capacity": cap, "grid": grid, "partials_ms": p_ms,
            "partials_bound_ms": p_bound, "partials_bound_by": p_by, "partials_plain_ms": pp_ms,
            "combine_ms": c_ms, "combine_bound_ms": c_bound, "combine_bound_by": c_by,
            "combine_plain_ms": cp_ms, "max_abs_err_partials": err_p,
            "max_abs_err_combine": err_c}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tikv_tpu_torch import _build
    from tikv_tpu_torch import fixtures as fx
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr import fused_group_agg as ga
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.copr.groupby import GroupDict
    from tikv_tpu_torch.copr.torch_eval import GROUP_CAPACITY_START, TorchDagEvaluator, _capacity_for

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
    ev_w = TorchDagEvaluator(q6_wire, block_rows=1 << 17, device="cuda")
    resp, pin_s = timed_run(ev_w, None, cache)  # first run pins the image
    check_rows(resp, want_q6, "warm Q6")
    warm_s = []
    for _ in range(5):
        resp, s = timed_run(ev_w, None, cache)
        check_rows(resp, want_q6, "warm Q6")
        warm_s.append(s)
    ev_g = TorchDagEvaluator(dag_to_wire(fx.q6_count_sum_min_max_dag()), block_rows=1 << 17,
                             device="cuda")
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
    want_q1_cold = fx.q1_oracle(cold_arrays)
    want_q1 = fx.q1_oracle(arrays)
    want_qty = fx.qty_oracle(arrays)
    del arrays
    fa.reset_launches()
    q1_wire = dag_to_wire(fx.q1_dag())
    ev_c1 = TorchDagEvaluator(q1_wire, block_rows=1 << 16, device="cuda")
    cold1_s = []
    for _ in range(2):
        resp, s = timed_run(ev_c1, FixtureScanSource(kvs), None)
        check_rows(resp, want_q1_cold, "cold Q1")
        cold1_s.append(s)
    cold_q1_launches = dict(fa.LAUNCHES)
    ev_w1 = TorchDagEvaluator(q1_wire, block_rows=1 << 17, device="cuda")
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
    ev_q = TorchDagEvaluator(dag_to_wire(fx.qty_dag()), block_rows=1 << 17, device="cuda")
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

    # ---- timings of each kernel at its main-path launch --------------------
    img = ev_w._stacked_device(cache)
    prog = ev_w.program
    grid, threads = fa.kernel_grid()
    scratch = torch.empty((grid, len(prog.aggs), 2), dtype=torch.int64, device=device)
    out = (torch.empty((prog.n_int, 1), dtype=torch.int64, device=device),
           torch.empty((prog.n_f64, 1), dtype=torch.float64, device=device))
    p_ms = cuda_ms(lambda: fa.launch_partials(prog, img, scratch), 20)
    c_ms = cuda_ms(lambda: fa.launch_combine(prog, scratch, None, out), 200)
    want_scratch = fa.partials_plain(prog, img, grid, threads)
    p_err = check_partials(prog, scratch, want_scratch, "q6 partials")
    c_err = compare_packed(prog, out, fa.combine_plain(prog, scratch), "q6 combine")
    pp_ms = cuda_ms(lambda: fa.partials_plain(prog, img, grid, threads), 3, warmup=1)
    cp_ms = cuda_ms(lambda: fa.combine_plain(prog, scratch), 20)
    rows = n_warm
    # bytes: the valid rows of the shipped columns, n_valids, the partials;
    # operations: one per bytecode instruction per row (partials) and one
    # per partial merged (combine)
    p_bound, p_by = bound(rows * 8 * len(prog.col_f64) + img.n_blocks * 8
                          + grid * len(prog.aggs) * 16, rows * len(prog.code))
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
    del img, scratch, want_scratch

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
          "fused_agg_partials_plain_ms": pp_ms,
          "fused_agg_combine_pack_ms": c_ms, "fused_agg_combine_pack_bound_ms": c_bound,
          "fused_agg_combine_pack_plain_ms": cp_ms,
          "group_warm_q1": t_warm_q1, "group_cold_q1_block": t_cold_q1,
          "group_warm_l_quantity": t_qty, "group_on_warm_q6": t_q6_grouped,
          "hbm_bytes_per_s": HBM_BYTES_PER_S})

    emit({"phase": "profile", "card": card,
          "cold": profile_runs(lambda: ev.run(FixtureScanSource(kvs)), 1),
          "warm": profile_runs(lambda: ev_w.run(None, cache), 3),
          "cold_q1": profile_runs(lambda: ev_c1.run(FixtureScanSource(kvs)), 1),
          "warm_q1": profile_runs(lambda: ev_w1.run(None, cache), 3)})
    del kvs

    main_path = {"fused_agg_partials": q6_launches, "fused_agg_combine_pack": q6_launches,
                 "fused_group_agg_partials": q1_launches,
                 "fused_group_agg_combine_pack": q1_launches}
    for name, counts in main_path.items():
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on its main path")
    src = "tikv_tpu_torch/csrc/fused_agg.cu"
    group_p_err = max(errs["fused_group_agg_partials"], t_warm_q1["max_abs_err_partials"],
                      t_cold_q1["max_abs_err_partials"], t_qty["max_abs_err_partials"])
    group_c_err = max(errs["fused_group_agg_combine_pack"], t_warm_q1["max_abs_err_combine"],
                      t_cold_q1["max_abs_err_combine"], t_qty["max_abs_err_combine"])
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [
        {"name": "fused_agg_partials", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:855",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:883", "tikv_tpu/copr/rpn.py:216"],
         "launches": q6_launches["fused_agg_partials"],
         "max_abs_err": max(errs["fused_agg_partials"], p_err),
         "ms": p_ms, "plain_ms": pp_ms, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None},
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
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
