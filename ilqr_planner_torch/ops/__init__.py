"""Math ops: S^3 and SO(3), small-matrix linear algebra, control-primitive
bases, the parallel-prefix LQR machinery, and the hand-written CUDA
kernels."""
