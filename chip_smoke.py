#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises and exits non-zero):

1. device  — the card (nvidia-smi name and power limit); exits 1 without CUDA
2. build   — nvcc builds every kernel from ``tikv_tpu_torch/csrc``; ptxas report
3. kernels — each kernel against its plain PyTorch version on the same seeded
             inputs, at a cold block (65,536 rows) and at the warm stacked
             shape: int leaves equal, f64 leaves to rel 1e-12, two runs
             bit-identical
4. cold    — TPC-H Q6 as a wire-dict request over 1,000,000 rows of lineitem
             KV bytes (block_rows 65,536), checked against a numpy oracle
5. warm    — the same request, and the count/sum/min/max shape, over a
             resident 100,000,000-row image (block_rows 131,072), checked the
             same way; steps down to no less than 10,000,000 rows if the
             host's or the card's memory cannot hold it, and says so
6. timings — cold/warm rows/s (host clock around synchronized work), each
             kernel's ms per launch (CUDA events), its bound, the plain
             version's time
7. profile — device time by kernel and the device's busy share of the
             wall time (torch.profiler), over one cold and three warm runs

Then the card's line, the kernels line and, last, the ok line.  The launch
counts in the kernels line are those of phases 4-5 (the main path) only.
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
    print(json.dumps(obj), flush=True)


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


# ---------------------------------------------------------------------------
# phases 4-6
# ---------------------------------------------------------------------------

def warm_rows_that_fit(want: int, floor: int) -> tuple[int, str | None]:
    """Rows of the warm image this machine can hold: the draws and the host
    stage take about 80 bytes a row on the host, the pinned image and the
    plain version's temporaries about 200 on the card."""
    host = mem_available_bytes()
    free_dev, _total = torch.cuda.mem_get_info()
    n = want
    while n > floor and (n * 80 > host * 0.8 or n * 200 > free_dev * 0.9):
        n //= 2
    n = max(n, floor)
    if n * 80 > host * 0.8 or n * 200 > free_dev * 0.9:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from tikv_tpu_torch import _build
    from tikv_tpu_torch import fixtures as fx
    from tikv_tpu_torch.copr import fused_agg as fa
    from tikv_tpu_torch.copr.dag_wire import dag_to_wire
    from tikv_tpu_torch.copr.executors import FixtureScanSource
    from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

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

    # ---- the main path: counts from here to the end of phase 5 ----------
    fa.reset_launches()
    q6_wire = dag_to_wire(fx.q6_dag())
    n_cold = COLD_ROWS
    kvs = fx.build_kvs(n_cold, SEED)
    oracle = fx.q6_oracle(fx.build_arrays(n_cold, SEED))
    ev = TorchDagEvaluator(q6_wire, block_rows=1 << 16, device="cuda")
    cold_s = []
    for _ in range(2):
        resp, s = timed_run(ev, FixtureScanSource(kvs), None)
        if resp.iter_rows() != [oracle]:
            raise AssertionError(f"cold Q6 {resp.iter_rows()} != oracle {[oracle]}")
        cold_s.append(s)
    emit({"phase": "cold", "query": "q6", "rows": n_cold, "block_rows": 1 << 16,
          "answer": oracle, "matches_oracle": True, "seconds": cold_s,
          "rows_per_s": n_cold / min(cold_s), "card": card})

    n_warm, cut = warm_rows_that_fit(WARM_ROWS, WARM_ROWS_FLOOR)
    arrays = fx.build_arrays(n_warm, SEED)
    cache = fx.build_cache(n_warm, 1 << 17, SEED, arrays=arrays)
    want_q6 = [fx.q6_oracle(arrays)]
    want_g = [fx.q6_count_sum_min_max_oracle(arrays)]
    del arrays
    ev_w = TorchDagEvaluator(q6_wire, block_rows=1 << 17, device="cuda")
    resp, pin_s = timed_run(ev_w, None, cache)  # first run pins the image
    if resp.iter_rows() != want_q6:
        raise AssertionError(f"warm Q6 {resp.iter_rows()} != oracle {want_q6}")
    warm_s = []
    for _ in range(5):
        resp, s = timed_run(ev_w, None, cache)
        if resp.iter_rows() != want_q6:
            raise AssertionError(f"warm Q6 {resp.iter_rows()} != oracle {want_q6}")
        warm_s.append(s)
    ev_g = TorchDagEvaluator(dag_to_wire(fx.q6_count_sum_min_max_dag()), block_rows=1 << 17,
                             device="cuda")
    resp_g, g_s = timed_run(ev_g, None, cache)
    if resp_g.iter_rows() != want_g:
        raise AssertionError(f"warm count/sum/min/max {resp_g.iter_rows()} != oracle {want_g}")
    launches = dict(fa.LAUNCHES)
    # ---- end of the main path ----------------------------------------------
    emit({"phase": "warm", "query": "q6", "rows": n_warm, "block_rows": 1 << 17,
          "reduced": cut, "answer": want_q6[0], "matches_oracle": True,
          "first_run_with_pin_s": pin_s, "seconds": warm_s,
          "rows_per_s": n_warm / sorted(warm_s)[len(warm_s) // 2],
          "pinned_bytes": cache.device_nbytes(), "card": card})
    emit({"phase": "warm", "query": "q6_count_sum_min_max", "rows": n_warm,
          "answer": want_g[0], "matches_oracle": True, "seconds_with_pin": g_s, "card": card})

    # ---- timings of each kernel at the warm Q6 launch ----------------------
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
    emit({"phase": "timings", "card": card, "warm_rows": rows,
          "cold_rows_per_s": n_cold / min(cold_s),
          "warm_rows_per_s": rows / sorted(warm_s)[len(warm_s) // 2],
          "fused_agg_partials_ms": p_ms, "fused_agg_partials_bound_ms": p_bound,
          "fused_agg_partials_plain_ms": pp_ms,
          "fused_agg_combine_pack_ms": c_ms, "fused_agg_combine_pack_bound_ms": c_bound,
          "fused_agg_combine_pack_plain_ms": cp_ms,
          "hbm_bytes_per_s": HBM_BYTES_PER_S})

    emit({"phase": "profile", "card": card,
          "cold": profile_runs(lambda: ev.run(FixtureScanSource(kvs)), 1),
          "warm": profile_runs(lambda: ev_w.run(None, cache), 3)})
    del kvs

    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    src = "tikv_tpu_torch/csrc/fused_agg.cu"
    print(card, flush=True)
    emit({"kernels": [
        {"name": "fused_agg_partials", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:855",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:883", "tikv_tpu/copr/rpn.py:216"],
         "launches": launches["fused_agg_partials"],
         "max_abs_err": max(errs["fused_agg_partials"], p_err),
         "ms": p_ms, "plain_ms": pp_ms, "bound_ms": p_bound, "bound_by": p_by,
         "library_ms": None},
        {"name": "fused_agg_combine_pack", "route": "cuda", "source": src,
         "replaces": "tikv_tpu/copr/jax_eval.py:737",
         "replaces_also": ["tikv_tpu/copr/jax_eval.py:1436"],
         "launches": launches["fused_agg_combine_pack"],
         "max_abs_err": max(errs["fused_agg_combine_pack"], c_err),
         "ms": c_ms, "plain_ms": cp_ms, "bound_ms": c_bound, "bound_by": c_by,
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
