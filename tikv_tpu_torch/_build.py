"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``csrc/`` compiles, at first use, into a shared library
with a plain C interface under ``build/kernels/`` at the checkout's root
(listed in ``.gitignore``).  The library's name carries a hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and a stale build is never loaded.
``build_all`` starts one nvcc per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

#: kernel library name -> source, relative to the package
SOURCES = {"fused_agg": "csrc/fused_agg.cu", "fused_scan": "csrc/fused_scan.cu",
           "fused_zone": "csrc/fused_zone.cu", "fused_batch": "csrc/fused_batch.cu",
           "fused_join": "csrc/fused_join.cu", "fused_mesh": "csrc/fused_mesh.cu",
           "fused_dict": "csrc/fused_dict.cu", "fused_patch": "csrc/fused_patch.cu"}

# -fmad=false: no fused multiply-add, so per-row f64 arithmetic rounds as
# numpy and torch round it; -Xptxas -v reports registers, spills and smem
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_ptxas_logs: dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, else ``/usr/local/cuda/bin``, else PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def library_path(name: str) -> Path:
    src = (PACKAGE_DIR / SOURCES[name]).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted((PACKAGE_DIR / "csrc").glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict[str, str]:
    """Compile every source that has no current library, in parallel.
    Returns the ptxas report (registers, spills, shared memory) of each
    library built by this process; raises with nvcc's output on failure."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(PACKAGE_DIR / SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
                continue
            os.replace(tmp, out)
            _ptxas_logs[name] = log
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return dict(_ptxas_logs)


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all()
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
