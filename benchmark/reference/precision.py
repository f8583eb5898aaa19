"""The arithmetic of a reference run: its dtype and its matrix products.

The reference runs in float64. Its control runs in float32 with every
matrix product's operands rounded to TF32 (10 explicit mantissa bits, to
nearest), as the H100's tensor cores take float32 products when TF32 is on:
the precision a later change would be tempted to use. The rounding is done
here, in plain tensor ops, so that the control is the same on the card and
on a CPU.
"""

import torch


def round_tf32(x):
    """float32 x with its mantissa rounded to 10 bits (ties away from zero;
    infinities and NaN kept)."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


class Precision:
    """dtype and device of a reference run; `tf32` rounds each product's
    operands (float32 only)."""

    def __init__(self, dtype, device, tf32=False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products take float32 operands")
        self.dtype, self.device, self.tf32 = dtype, torch.device(device), tf32

    @classmethod
    def reference(cls, device):
        return cls(torch.float64, device)

    @classmethod
    def control(cls, device):
        return cls(torch.float32, device, tf32=True)

    def tensor(self, a):
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def mm(self, a, b):
        """Batched matrix product a @ b."""
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return a @ b
