"""PyLQR.utils: S^3 math, primitive bases, callbacks (bindings.cpp:872-907).

The port's counterpart of the JAX package's `compat/utils.py`: numpy in,
numpy out, over the port's `ops/sd.py` (float64, on the CPU) and
`ops/primitives.py`.
"""

import types

import numpy as np
import torch

from ilqr_planner_torch.ops import primitives as _prim
from ilqr_planner_torch.ops import sd as _sd
from ilqr_planner_torch.utils.callbacks import CallBackMessage, PrintCallback

__all__ = ["Sd", "primitives", "CallBackMessage", "PythonCallbackMessage"]

# Prints solver progress, like the reference's py::print bridge
# (PythonCallbackMessage.cpp:14-17).
PythonCallbackMessage = PrintCallback


def _t(a):
    return torch.as_tensor(np.asarray(a, float))


# --- PyLQR.utils.Sd (bindings.cpp:891-899) --------------------------------
Sd = types.SimpleNamespace(
    logMap=lambda base, y: _sd.log_map(_t(base), _t(y)).numpy(),
    expMap=lambda base, u: _sd.exp_map(_t(base), _t(u)).numpy(),
    distance=lambda x, y: float(_sd.distance(_t(x), _t(y))),
    transport=lambda v, b1, b2: _sd.transport(_t(v), _t(b1), _t(b2)).numpy(),
    dquat_to_w_jac=lambda q: _sd.dquat_to_dx_jac(_t(q)).numpy(),
)

# --- PyLQR.utils.primitives (bindings.cpp:901-907) ------------------------
primitives = types.SimpleNamespace(
    # The reference binds the RBF basis with capital RBF (bindings.cpp:903);
    # the lowercase alias is kept for symmetry with the other bases.
    build_psi_RBF=_prim.build_psi_rbf,
    build_psi_rbf=_prim.build_psi_rbf,
    build_psi_bernstein=_prim.build_psi_bernstein,
    build_psi_unitstep=_prim.build_psi_unitstep,
    build_psi_sawtooth=_prim.build_psi_sawtooth,
    build_psi_linear=_prim.build_psi_linear,
)
