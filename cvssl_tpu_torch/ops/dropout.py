"""Element dropout with 8-bit random draws (port of
``cvssl_tpu/ops/dropout.py``).

The keep probability is quantised to 1/256: the effective drop rate is
round(p * 256) / 256, and survivors are scaled by the effective rate, so
E[output] == input exactly. This is the JAX package's documented deviation
from ``nn.Dropout``, kept so the two packages run the same function.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cvssl_tpu_torch.parallel import mesh as pmesh


def bits_threshold(rate: float) -> int:
    return int(round(rate * 256.0))


def bits_dropout(x: torch.Tensor, rate: float,
                 draw: torch.Tensor) -> torch.Tensor:
    """Drop where the uint8 ``draw`` (shape of ``x``) is below
    round(rate * 256); scale survivors by 256 / (256 - t)."""
    t = bits_threshold(rate)
    if t <= 0:
        return x
    if t >= 256:
        return torch.zeros_like(x)
    return torch.where(draw >= t, x * (256.0 / (256.0 - t)), 0.0)


class BitsDropout(nn.Module):
    """Drop-in for ``nn.Dropout(rate)``: one random byte per element from
    the caller's ``torch.Generator`` (on the tensor's device); inside a
    split call the bytes of the global batch are drawn and the rank's rows
    kept (``parallel.mesh.draw_rows``)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        t = bits_threshold(self.rate)
        if not self.training or t <= 0:
            return x
        if t >= 256:
            return torch.zeros_like(x)
        draw = pmesh.draw_rows(x.shape, lambda s: torch.randint(
            0, 256, s, dtype=torch.uint8, device=x.device,
            generator=generator))
        return bits_dropout(x, self.rate, draw)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
