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
of 20 launches each, reported in seconds a launch).  Each process builds its
checkout's kernels first
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
