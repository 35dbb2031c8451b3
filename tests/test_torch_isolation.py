"""The PyTorch port stands alone: no jax, no ``tikv_tpu``, no CPU fallback."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tikv_tpu_torch
from tikv_tpu_torch import fixtures as fx
from tikv_tpu_torch.copr.dag_wire import dag_to_wire
from tikv_tpu_torch.copr.torch_eval import TorchDagEvaluator

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "tikv_tpu_torch"


def _port_modules() -> list[str]:
    return sorted(m.name for m in pkgutil.walk_packages(tikv_tpu_torch.__path__, "tikv_tpu_torch."))


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "tikv_tpu" or name.startswith("tikv_tpu.")


def test_port_modules_listed():
    mods = _port_modules()
    for m in ("tikv_tpu_torch.copr.torch_eval", "tikv_tpu_torch.copr.fused_agg",
              "tikv_tpu_torch.copr.cache", "tikv_tpu_torch.util.codec", "tikv_tpu_torch._build",
              "tikv_tpu_torch.copr.fused_mask", "tikv_tpu_torch.copr.fused_topn",
              "tikv_tpu_torch.copr.encoding", "tikv_tpu_torch.copr.zone_maps",
              "tikv_tpu_torch.copr.zone", "tikv_tpu_torch.copr.fused_zone",
              "tikv_tpu_torch.copr.fused_batch", "tikv_tpu_torch.copr.torch_join",
              "tikv_tpu_torch.copr.fused_join", "tikv_tpu_torch.copr.fused_mesh",
              "tikv_tpu_torch.copr.fused_dict", "tikv_tpu_torch.copr.fused_patch",
              "tikv_tpu_torch.copr.mvcc_batch", "tikv_tpu_torch.copr.region_cache",
              "tikv_tpu_torch.storage", "tikv_tpu_torch.storage.engine",
              "tikv_tpu_torch.storage.btree_engine", "tikv_tpu_torch.storage.txn_types",
              "tikv_tpu_torch.storage.mvcc", "tikv_tpu_torch.storage.mvcc.reader",
              "tikv_tpu_torch.parallel", "tikv_tpu_torch.parallel.mesh"):
        assert m in mods


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tikv_tpu' or m.startswith('tikv_tpu.'))\n"
        "print('BAD', bad)\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(REPO).as_posix() for p in PACKAGE.rglob("*.py")] + ["chip_smoke.py"]))
def test_sources_import_neither_jax_nor_reference(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_cuda_evaluator_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDagEvaluator(dag_to_wire(fx.q6_dag()), block_rows=1024, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchDagEvaluator(dag_to_wire(fx.q6_dag()), block_rows=1024)


def _no_ok(out: subprocess.CompletedProcess) -> None:
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    _no_ok(out)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    _no_ok(out)
