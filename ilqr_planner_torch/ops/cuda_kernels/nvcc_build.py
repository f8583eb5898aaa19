"""Build a CUDA source of this package with nvcc and load it with ctypes.

Every kernel module keeps its `.cu` in `ilqr_planner_torch/csrc/`. At first
use the source is compiled for sm_90a into a shared library with a plain C
interface, named by the hash of its content, in `ilqr_planner_torch/build/`
(so an edited source builds anew and an unchanged one is built once); the
ptxas report (registers, spills, shared memory per kernel) is kept beside
it. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "build", "load", "ptxas_summary"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_loaded = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def build(source: Path):
    """Compile `source` for sm_90a (once per source content) -> (path of the
    shared library, ptxas report)."""
    source = Path(source)
    src = source.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log = BUILD_DIR / f"lib{source.stem}_{tag}.ptxas.txt"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


def ptxas_summary(report: str):
    """The lines of a ptxas report that name a kernel, its registers and its
    spills."""
    return [ln.strip() for ln in report.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def load(source: Path, entries: dict):
    """Build `source` if needed and load it; `entries` maps each exported C
    function to its ctypes argument types (each returns an int, the CUDA
    error code). The library is loaded once per process."""
    source = Path(source)
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build(source)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib
