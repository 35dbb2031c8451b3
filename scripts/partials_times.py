#!/usr/bin/env python3
"""Time the capacity-1 and wide partials kernels of one or more checkouts.

    python3 scripts/partials_times.py [CHECKOUT ...]

Each checkout (this one by default; for example copies of the package with
a kernel source changed, under a directory that ``.gitignore`` lists) runs
in a fresh process in the order given: its kernels are built, a 20,000,000
row supplier image (``fixtures.supp_cache``, lineitem's draws plus
l_suppkey) is made, and ``fused_agg_partials`` at Q6 and
``group_wide_partials`` at the per-supplier query (host ids), at the same
ids modulo ``c_max`` on ``c_max + 1`` slots, with every row in one slot
(``hot``), at Q1 grouped by the four flag columns and at the per-supplier
query's cold block (1,000,000 KV rows, 16,384 slots) are timed from CUDA
events, each against its plain version once (a checkout whose
capacity-1 grid is fixed takes scratch of that grid).  Prints one JSON
line per checkout with the card's name and power limit.  Needs one CUDA
device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
from tikv_tpu_torch import _build
_build.SOURCES = {"fused_agg": "csrc/fused_agg.cu"}
_build.build_all()
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr import fused_agg as fa, fused_group_agg as ga, torch_eval as te
from tikv_tpu_torch.copr.dag_wire import dag_to_wire
from tikv_tpu_torch.copr.executors import FixtureScanSource

def ms(fn, iters):
    for _ in range(3):
        fn()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters

def first_call(run):
    seen, fn = [], te.fused_group_agg
    def rec(*a, **k):
        seen.append(a)
        return fn(*a, **k)
    te.fused_group_agg = rec
    try:
        run()
    finally:
        te.fused_group_agg = fn
    return seen

def ev_of(dag, br=1 << 17):
    ev = te.TorchDagEvaluator(dag_to_wire(dag), block_rows=br, device="cuda")
    ev.route_hint = "unary"
    return ev

def wide(name, prog, img, cap, iters):
    st = ga.new_partials(prog, img, cap)
    ga.launch_partials(prog, img, cap, st)
    out[name + "_ok"] = bool(torch.equal(st, ga.wide_partials_plain(prog, img, cap)))
    out[name + "_ms"] = [ms(lambda: ga.launch_partials(prog, img, cap, st), iters) for _ in range(2)]

cache = fx.supp_cache(20_000_000, 1 << 17, 0)
out = {}
ev6 = ev_of(fx.q6_dag())
img6, prog6 = ev6._stacked_device(cache), ev6.program
if hasattr(fa, "new_scratch"):
    scr = fa.new_scratch(prog6, img6)
else:  # a checkout whose capacity-1 grid is fixed
    scr = torch.empty((fa.kernel_grid()[0], len(prog6.aggs), 2), dtype=torch.int64, device="cuda")
fa.launch_partials(prog6, img6, scr)
out["q6_ok"] = bool(torch.equal(fa.combine_plain(prog6, scr)[0], fa.fused_agg_plain(prog6, img6)[0]))
out["q6_ms"] = [ms(lambda: fa.launch_partials(prog6, img6, scr), 20) for _ in range(2)]
prog, img, cap = first_call(lambda: ev_of(fx.supp_dag()).run(None, cache))[0][:3]
wide("supp", prog, img, cap, 10)
same = fa.Image(img.cols, img.nulls, img.n_valids, img.n_blocks, img.block_rows, img.device,
                img.offsets, img.gids % prog.c_max)
wide("same_ids_c_max_plus_1", prog, same, prog.c_max + 1, 10)
hot = fa.Image(img.cols, img.nulls, img.n_valids, img.n_blocks, img.block_rows, img.device,
               img.offsets, torch.zeros_like(img.gids))
wide("hot", prog, hot, cap, 10)
del same, hot
wide("flags4", *first_call(lambda: ev_of(fx.flags4_dag(var_pop=True)).run(None, cache))[0][:3], 5)
calls = first_call(lambda: ev_of(fx.supp_dag(), 1 << 16).run(
    FixtureScanSource(fx.supp_kvs(1_000_000, 0))))
capc = max(c[2] for c in calls)
wide("cold_block", *next(c[:2] for c in calls if c[2] == capc), capc, 50)
if hasattr(fa, "partials_attributes"):
    out["registers"] = {
        "fused_agg_partials": [fa.partials_attributes(d)["numRegs"] for d in (2, 4, 8)],
        "group_wide_partials": [ga.partials_attributes(d, wide=True)["numRegs"]
                                for d in (2, 4, 8)]}
print(json.dumps(out))
"""


def main() -> int:
    dirs = [Path(d) for d in sys.argv[1:]] or [Path(__file__).resolve().parent.parent]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for d in dirs:
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=d, capture_output=True,
                              text=True, timeout=1800)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(json.dumps({"checkout": str(d), "card": card,
                          **json.loads(proc.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
