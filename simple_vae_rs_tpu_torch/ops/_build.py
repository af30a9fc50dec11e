"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with :mod:`ctypes`. The build runs on first
use, into ``build/svrs_torch_kernels/<hash>/`` under the repository root,
keyed by a hash of the source and the flags, so an edited source rebuilds
and an unchanged one loads in milliseconds. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "svrs_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
ptxas_logs: Dict[str, str] = {}  # source name -> nvcc's -Xptxas -v report


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA kernels cannot be built"
    )


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{source.stem}.so"


def _compile(source: Path) -> Path:
    out = _lib_path(source)
    log = out.with_suffix(".log")
    if out.exists():
        ptxas_logs[source.name] = log.read_text() if log.exists() else ""
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    ptxas_logs[source.name] = report
    return out


def build_all() -> Dict[str, Path]:
    """Compile every source (all ``nvcc`` processes started together)."""
    paths = sorted(CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(paths))) as pool:
        built = list(pool.map(_compile, paths))
    return {p.name: b for p, b in zip(paths, built)}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(CSRC / source)))
            _libs[source] = lib
        return lib
