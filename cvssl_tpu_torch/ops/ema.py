"""Mean-teacher EMA (port of ``cvssl_tpu/ops/ema.py``)."""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch


def ema_decay_schedule(step: int, alpha: float = 0.99) -> float:
    """Warm-up decay min(1 - 1/(t+1), alpha) in float32; ``step`` is the
    global iteration before its increment. JAX: ``ema_decay_schedule``."""
    t = np.float32(step)
    return float(min(np.float32(1.0) - np.float32(1.0) / (t + np.float32(1.0)),
                     np.float32(alpha)))


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor],
               decay: Union[float, torch.Tensor]) -> None:
    """ema <- decay * ema + (1 - decay) * new, in place over two matching
    lists of tensors, as JAX's three operations. ``decay`` is a float or a
    0-d float32 tensor on the tensors' device (the engine's step table, so
    that a CUDA graph of the step reads each replay's decay from the card;
    1 - decay is exact in float32 for every decay of the schedule). JAX:
    ``ema_update`` (which returns a new tree)."""
    ema = list(ema)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(list(new), 1.0 - decay))


def mean_teacher_update(ema: Sequence[torch.Tensor],
                        new: Sequence[torch.Tensor], step: int,
                        alpha: float = 0.99) -> None:
    """:func:`ema_update` at :func:`ema_decay_schedule`'s decay, in place.
    JAX: ``ema.mean_teacher_update``."""
    ema_update(ema, new, ema_decay_schedule(step, alpha))
