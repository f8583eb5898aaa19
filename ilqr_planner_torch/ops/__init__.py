"""Math ops: S^3 and SO(3), small-matrix linear algebra, control-primitive
bases, the parallel-prefix LQR machinery, and the hand-written CUDA
kernels (`ops.cuda_kernels`, built at first use)."""

from ilqr_planner_torch.ops import kinutils, primitives, sd, so3
from ilqr_planner_torch.ops.kinutils import jac_pseudo_inverse

__all__ = ["sd", "so3", "primitives", "kinutils", "jac_pseudo_inverse"]
