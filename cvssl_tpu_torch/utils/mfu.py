"""Model FLOPs utilisation (port of ``cvssl_tpu/utils/mfu.py``).

The FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over
one real call: matmuls and convolutions (forward and backward) as 2 x
MACs, as XLA's cost analysis counts them in JAX. Two differences in what
is counted: a kernel launched through ``ctypes`` (the fused CE+Dice) is
not seen, as XLA does not count a custom call; and a padded convolution
counts every tap, where XLA counts only the taps inside the input, so a
3 x 3 'same' convolution at side H counts (3H / (3H - 2))^2 as much here
(1.021 at 64^2, 1.089 at 16^2), while XLA also counts the elementwise work
(norms, activations) that is not counted here. A VALID convolution and a
matmul count the same on both sides.

``mfu`` divides by the card's dense bf16 peak whatever the compute dtype,
as JAX divides by the TPU's bf16 peak for every configuration.
"""
from __future__ import annotations

from typing import Optional

import torch

# per-card dense bf16 peak FLOP/s (no sparsity), NVIDIA data sheets, at the
# full power limit; keys match inside torch.cuda.get_device_name
PEAK_BF16_FLOPS = {
    "H100": 989e12,         # SXM, "NVIDIA H100 80GB HBM3"
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
}


def peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak of the card ``device`` (default: the current card)
    from :data:`PEAK_BF16_FLOPS`, the longest key found in its name; None
    for the CPU, without a card, or for a card not in the table (callers
    then report FLOPs without an MFU). JAX takes the first key found
    (``cvssl_tpu/utils/mfu.py:49``), which for these names would give
    every H100 the SXM part's peak."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    found = [k for k in PEAK_BF16_FLOPS if k.lower() in name]
    if not found:
        return None
    return PEAK_BF16_FLOPS[max(found, key=len)]


def count_flops(fn, *args, **kwargs) -> Optional[float]:
    """FLOPs of one call ``fn(*args, **kwargs)``, which really runs (its
    result is dropped), or None when nothing was counted. The counterpart
    of JAX's ``program_flops``, which reads the compiled program instead.
    """
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    total = counter.get_total_flops()
    return float(total) if total > 0 else None


def per_step_flops(step, *args) -> Optional[float]:
    """FLOPs of one train step ``step(*args)``. The step runs and moves
    what a step moves (the optimizer, the teachers, the generators), so
    give it a step whose result is thrown away, such as a warm-up step.
    JAX lowers the scanned step at two lengths, since XLA counts a loop
    body once; an eager step is counted as it runs, so one call is the
    step's count."""
    return count_flops(step, *args)


def mfu(flops_per_step: Optional[float], step_time_s: float,
        device=None) -> Optional[float]:
    """Model FLOPs utilisation in [0, 1]: ``flops_per_step / step_time_s /
    peak``; None where the count or the card's peak is missing. JAX:
    ``mfu.mfu``."""
    if not flops_per_step or step_time_s <= 0:
        return None
    peak = peak_flops(device)
    if not peak:
        return None
    return flops_per_step / step_time_s / peak
