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
synchronized runs).  Each process builds its checkout's kernels first
(outside the phase's clock).  Prints one JSON line per run (the
checkout, the phase's request times by case, the phase's seconds) and a last
line with each case's median over the runs of each checkout.  Needs one
CUDA device.
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
        if "phase_wall_s" in obj:
            out["phase_wall_s"] = obj["phase_wall_s"]
    return out


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
        summary[phase] = {which: {case: statistics.median(t) for case, t in cases.items()}
                          for which, cases in per.items()}
    print(json.dumps({"median_request_s": summary,
                      "card": subprocess.run(
                          ["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
