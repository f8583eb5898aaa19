"""Build a CUDA source of this package with nvcc and load it with ctypes.

Every kernel module keeps its `.cu` in `ilqr_planner_torch/csrc/`. At first
use the source is compiled for sm_90a into a shared library with a plain C
interface, one library for each width the caller asks for (the width enters
as -D defines), named by the hash of the source's content and the defines,
in `ilqr_planner_torch/build/` (so an edited source builds anew and an
unchanged one is built once); the
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

__all__ = ["CSRC", "build", "load", "ptxas_summary", "resident_blocks",
           "launch_geometry", "kernel_geometry", "SMEM_PER_BLOCK_MAX"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_loaded = {}

# What one H100 SM offers a kernel (NVIDIA's Hopper tuning notes): 228 KB of
# shared memory, of which a block may take 227 KB and the system keeps 1 KB
# a resident block; 2048 threads; 32 blocks.
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_MAX = 232448
SMEM_RESERVED_PER_BLOCK = 1024
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def build(source: Path, defines=()):
    """Compile `source` for sm_90a (once per source content and set of
    `defines`, each a NAME=VALUE for -D: a design variant of a kernel whose
    source reads it) -> (path of the shared library, ptxas report)."""
    source = Path(source)
    src = source.read_bytes()
    tag = hashlib.sha1(src + " ".join(defines).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log = BUILD_DIR / f"lib{source.stem}_{tag}.ptxas.txt"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", *[f"-D{d}" for d in defines], "-o", str(tmp),
               str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""


def resident_blocks(threads: int, smem_bytes: int) -> int:
    """Blocks of `threads` threads and `smem_bytes` of dynamic shared memory
    that one SM holds at once, by shared memory and threads alone (a kernel
    above 65536 / (threads * blocks) registers a thread holds fewer: the
    CUDA occupancy calculator, asked on the card, has the last word)."""
    if smem_bytes > SMEM_PER_BLOCK_MAX:
        return 0
    return min(SMEM_PER_SM // (smem_bytes + SMEM_RESERVED_PER_BLOCK),
               THREADS_PER_SM // threads, BLOCKS_PER_SM)


def launch_geometry(B, lanes_per_block, threads_per_lane, smem_values, itemsize):
    """The launch of a kernel whose blocks own `lanes_per_block` lanes with
    `threads_per_lane` threads each and keep `smem_values` values a lane in
    dynamic shared memory, at batch B -> dict(blocks, threads (a block),
    lanes_per_block, smem_bytes (a block), lanes_per_sm (by shared memory
    and threads, see `resident_blocks`)). Threads are launched in whole
    warps. Needs no card."""
    threads = -(-threads_per_lane * lanes_per_block // 32) * 32
    smem = smem_values * lanes_per_block * itemsize
    return {"blocks": -(-B // lanes_per_block), "threads": threads,
            "lanes_per_block": lanes_per_block, "smem_bytes": smem,
            "lanes_per_sm": lanes_per_block * resident_blocks(threads, smem)}


def kernel_geometry(fn, *args):
    """Ask a built library's geometry entry `fn(*args, out[4])` what its
    kernel launches -> dict(blocks, threads, smem_bytes,
    resident_blocks_per_sm (the CUDA occupancy calculator's figure, which
    knows the kernel's registers)). Needs the card."""
    out = (ctypes.c_int * 4)()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    return dict(zip(("blocks", "threads", "smem_bytes",
                     "resident_blocks_per_sm"), out))


def ptxas_summary(report: str):
    """The lines of a ptxas report that name a kernel, its registers and its
    spills."""
    return [ln.strip() for ln in report.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def load(source: Path, entries: dict, defines=()):
    """Build `source` with `defines` (as `build`) if needed and load it;
    `entries` maps each exported C function to its ctypes argument types
    (each returns an int, the CUDA error code). Each (source, defines) is
    loaded once per process: a kernel's widths are one library each, built
    at first use."""
    key = (Path(source), tuple(defines))
    lib = _loaded.get(key)
    if lib is None:
        path, _ = build(*key)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _loaded[key] = lib
    return lib
