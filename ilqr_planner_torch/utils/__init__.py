"""Utilities: progress callbacks, metrics and tracing, checkpoints,
record-and-replay serialization, device selection and parameter
conversion."""

from ilqr_planner_torch.utils.callbacks import CallBackMessage, PrintCallback
from ilqr_planner_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from ilqr_planner_torch.utils.metrics import MetricsCallback, trace
from ilqr_planner_torch.utils.serialize import (
    load_csv,
    load_matrix_list,
    save_csv,
    save_matrix_list,
)

__all__ = [
    "CallBackMessage",
    "MetricsCallback",
    "PrintCallback",
    "load_checkpoint",
    "load_csv",
    "load_matrix_list",
    "save_checkpoint",
    "save_csv",
    "save_matrix_list",
    "trace",
]
