"""Solver progress callbacks.

The port's copy of the JAX package's `utils/callbacks.py`, and the
reference's observer API (CallbackMessage.h:12-16,
PythonCallbackMessage.cpp:14-17): a solver given a callback calls its
`notify(msg)` once per executed iteration, on the caller's thread, with
"Iteration i, Cost: c, alpha= a". The solvers call the object directly, so
solves on two threads with their own callbacks never share one.
"""

import torch

__all__ = ["CallBackMessage", "PrintCallback", "progress_message",
           "emit_progress"]


class CallBackMessage:
    """Abstract observer; subclass and override notify(msg)."""

    def notify(self, msg: str) -> None:  # pragma: no cover - interface
        raise NotImplementedError


class PrintCallback(CallBackMessage):
    """Prints each message, like PythonCallbackMessage -> py::print."""

    def notify(self, msg: str) -> None:
        print(msg)


def progress_message(it, cost, alpha) -> str:
    """The message of one iteration, letter for letter the JAX package's
    (`solvers/ilqr.py::_emit_progress`): Python numbers formatted with %g."""
    return f"Iteration {int(it)}, Cost: {float(cost):g}, alpha= {float(alpha):g}"


def emit_progress(callback, active, it, cost, alpha) -> None:
    """Notify `callback` of lane 0's iteration it[0] + 1 with its cost and
    alpha ([B] tensors), if lane 0 ran it (active[0]): the batched solvers'
    bridge for a one-problem solve. One read from the device."""
    live, i, c, a = torch.stack([active[0].to(cost.dtype),
                                 it[0].to(cost.dtype) + 1, cost[0],
                                 alpha[0]]).tolist()
    if live:
        callback.notify(progress_message(i, c, a))
