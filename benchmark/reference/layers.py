"""Plain building blocks of the references: convolutions, norms, the 8-bit
dropout, and the precision switch the control turns.

Everything computes in float32 with TF32 off (set by the caller). With
``precision="fp8"`` each convolution is computed as an fp8 training recipe
computes it, the step a faster path would be tempted to take: its input,
weight and output stored in float8 e4m3 and their gradients in float8
e5m2, each with one scale per tensor (its largest magnitude over the
format's), products accumulated in float32 (``"bfloat16"``, for a look
at the program's own gaps: bfloat16 for both, as its autocast stores
them). This module imports nothing of the program.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "fp8", "bfloat16")
# (dtype, largest finite value) of the formats; None: no scale
E4M3, E5M2 = (torch.float8_e4m3fn, 448.0), (torch.float8_e5m2, 57344.0)
BF16 = (torch.bfloat16, None)
# a precision's formats: (activations and weights, gradients)
FORMATS = {"fp8": (E4M3, E5M2), "bfloat16": (BF16, BF16)}


def _round(t: torch.Tensor, fmt) -> torch.Tensor:
    dtype, top = fmt
    if top is None:
        return t.to(dtype).to(t.dtype)
    scale = t.abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Round(torch.autograd.Function):
    """Forward: ``x`` rounded to ``fmt``; backward: the incoming gradient
    rounded to ``grad_fmt``."""

    @staticmethod
    def forward(ctx, x, fmt, grad_fmt):
        ctx.grad_fmt = grad_fmt
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.grad_fmt), None, None


def conv(x, weight, bias, precision: str, padding: int = 0):
    """A convolution in ``precision``: in float32; or with its input, its
    weight and its output stored in the precision's activation format and
    each of their gradients in its gradient format, products accumulated
    in float32."""
    fn = F.conv2d if x.ndim == 4 else F.conv3d
    if precision == "float32":
        return fn(x, weight, bias, padding=padding)
    if precision not in FORMATS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    act, grad = FORMATS[precision]
    y = fn(_Round.apply(x, act, grad), _Round.apply(weight, act, grad),
           bias, padding=padding)
    return _Round.apply(y, act, grad)


def batch_norm_train(x, weight, bias, eps: float = 1e-5):
    """Train-mode batch norm: the batch's mean and biased variance."""
    return F.batch_norm(x, None, None, weight, bias, True, 0.0, eps)


def instance_norm(x, eps: float = 1e-5):
    """Per-sample, per-channel normalisation over the spatial axes, no
    affine; a map of one site normalises to 0."""
    dims = tuple(range(2, x.ndim))
    mean = x.mean(dims, keepdim=True)
    d = x - mean
    var = (d * d).mean(dims, keepdim=True)
    return d * torch.rsqrt(var + eps)


def bits_dropout(x, rate: float, generator: Optional[torch.Generator]):
    """Dropout with one random byte per element: dropped where the byte is
    below round(rate * 256), survivors scaled by 256 / (256 - t), so the
    mean is kept exactly."""
    t = int(round(rate * 256.0))
    if t <= 0:
        return x
    draw = torch.randint(0, 256, tuple(x.shape), dtype=torch.uint8,
                         device=x.device, generator=generator)
    return torch.where(draw >= t, x * (256.0 / (256.0 - t)), 0.0)


def init_weights(specs, generator: torch.Generator, device,
                 base: Optional[dict] = None, spread: float = 1.0) -> dict:
    """Weights for ``specs`` [(name, shape, kind, fan_in)] from one uniform
    draw over all of them: a convolution's weight and bias U(-b, b) with b =
    1 / sqrt(fan_in) (PyTorch's default bound), a norm's weight 1 + 0.1 U
    and its bias 0.1 U (U uniform on [-1, 1)). With ``base`` the draw is a
    perturbation: base + ``spread`` times it. float32, on ``device``."""
    total = sum(_numel(shape) for _, shape, _, _ in specs)
    u = torch.rand(total, generator=generator, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, kind, fan_in in specs:
        n = _numel(shape)
        v = u[at:at + n].view(shape)
        at += n
        if kind == "conv":
            v = v * (1.0 / fan_in ** 0.5)
        elif kind == "norm_weight":
            v = (0.0 if base is not None else 1.0) + 0.1 * v
        elif kind == "norm_bias":
            v = 0.1 * v
        else:
            raise ValueError(f"{name}: kind {kind!r}")
        out[name] = v.clone() if base is None else base[name] + spread * v
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
