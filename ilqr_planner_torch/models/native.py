"""ctypes bridge to the native C++ URDF chain extractor.

The port's counterpart of the JAX package's `models/native.py`.
`parse_urdf_native` mirrors `models.urdf.parse_urdf` through
native/src/urdf_chain.cpp (built with `make -C native` into native/lib/):
it returns the joint dicts {name, type, R, p, axis} in base-to-tip order
that `chain_from_urdf` folds, the rotations built by the same `_rpy_mat`,
so both parsers feed the same chain code. `available()` tells whether the library is built;
`build()` compiles it with the system toolchain.
"""

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "build", "parse_urdf_native"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "lib" / "libilqr_native.so"
_lib: Optional[ctypes.CDLL] = None
_MAX_JOINTS = 256
_TYPE_NAMES = {0: "fixed", 1: "revolute", 2: "prismatic"}


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.ilqr_parse_urdf_chain.restype = ctypes.c_int
    lib.ilqr_parse_urdf_chain.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native C++ URDF extractor library is built/loadable."""
    return _load() is not None


def build() -> bool:
    """Compile the native library with `make -C native`; returns success."""
    global _lib
    try:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    _lib = None
    return _load() is not None


def parse_urdf_native(urdf: str, base_frame: str, tip_frame: str,
                      is_path: bool = True):
    """Native-path equivalent of models.urdf.parse_urdf: a list of joint
    dicts {name, type, R, p, axis} in base-to-tip order (a continuous joint
    reads as revolute). Raises ValueError on failure, with the Python
    parser's messages."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library not built (run make -C native)")
    from ilqr_planner_torch.models.urdf import _rpy_mat

    types = np.zeros(_MAX_JOINTS, np.int32)
    rpy = np.zeros(3 * _MAX_JOINTS)
    xyz = np.zeros(3 * _MAX_JOINTS)
    axis = np.zeros(3 * _MAX_JOINTS)
    n = lib.ilqr_parse_urdf_chain(
        str(urdf).encode(), int(is_path), base_frame.encode(),
        tip_frame.encode(), _MAX_JOINTS, types, rpy, xyz, axis)
    if n == -1:
        raise ValueError(f"Unable to read URDF {urdf!r}")
    if n == -2:
        raise ValueError(
            f"Unable to build kinematic chain from {base_frame} to {tip_frame}")
    if n < 0:
        raise ValueError(f"native URDF parse failed (code {n})")
    return [{"name": f"joint_{i}",
             "type": _TYPE_NAMES[int(types[i])],
             "R": _rpy_mat(*rpy[3 * i:3 * i + 3]),
             "p": xyz[3 * i:3 * i + 3].copy(),
             "axis": axis[3 * i:3 * i + 3].copy()} for i in range(n)]
