"""Where the port's tensors live: on the card unless the caller names another
device. There is no silent fallback to the CPU."""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for and no card is
    present; pass `device="cpu"` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ilqr_planner_torch runs on CUDA by default, but no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev
