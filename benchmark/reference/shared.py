"""What every family's plain reference shares: float32 products with TF32
off, the float8 control's rounding of an operand, and AdamW.

``precision='fp8'`` is the control of the benchmark's comparison: every
matmul and convolution takes its operands rounded to float8 e4m3 (each
tensor scaled by its own absolute maximum, as fp8 training scales them),
the backward passing gradients straight through the rounding.

``adamw_step`` is AdamW (Loshchilov and Hutter, arXiv:1711.05101) with the
decay decoupled, as ``torch.optim.AdamW`` computes it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator

import torch

PRECISIONS = ("float32", "fp8")
FP8_MAX = 448.0  # the largest float8 e4m3 value


@contextlib.contextmanager
def fp32_matmuls() -> Iterator[None]:
    """float32 products and convolutions in float32 (TF32 off) inside the
    block; the earlier settings come back after it."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


class _RoundFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a scale of FP8_MAX / max|x|; the
    gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.detach().abs().amax().clamp_min(1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, grad):
        return grad


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product takes it at ``precision``: rounded to float8 for
    ``fp8``, itself otherwise."""
    return _RoundFP8.apply(x) if precision == "fp8" else x


def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: dict,
               lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8) -> None:
    """One AdamW step in place on ``params``; ``state`` holds the moments and
    the step count (empty before the first step)."""
    b1, b2 = betas
    state["step"] = state.get("step", 0) + 1
    bc1, bc2 = 1.0 - b1 ** state["step"], 1.0 - b2 ** state["step"]
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name]
            m = state.setdefault(("m", name), torch.zeros_like(p))
            v = state.setdefault(("v", name), torch.zeros_like(p))
            p.mul_(1.0 - lr * weight_decay)
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            p.addcdiv_(m, v.sqrt().div_(math.sqrt(bc2)).add_(eps), value=-lr / bc1)
