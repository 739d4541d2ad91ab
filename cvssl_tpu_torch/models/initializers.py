"""Weight re-initialisation (port of ``cvssl_tpu/models/initializers.py``,
the reference's ``code/networks/networks_other.py:16-75``:
``weights_init_normal`` / ``_xavier`` / ``_kaiming`` / ``_orthogonal`` and
the ``init_weights`` dispatcher).

The reference mutates a built module through ``net.apply``; JAX maps a
params tree by leaf name. The port works in place on a module's
parameters, with JAX's semantics: each tensor that is a Flax ``kernel``
(the weight of a conv, transpose conv or linear layer) is re-sampled per
``init_type``; each 1-D Flax ``scale`` (the weight of a BatchNorm,
InstanceNorm, LayerNorm or GroupNorm) gets N(1, 0.02) whatever the type;
every ``bias`` is zeroed; everything else (PReLU slopes, position tables
and embeddings, BatchNorm's running statistics) is left as it is.

* normal     N(0, 0.02)
* xavier     N(0, 2 / (fan_in + fan_out))
* kaiming    N(0, 2 / fan_in) (He normal, a=0, mode 'fan_in')
* orthogonal the (prod(k) * in, out) matrix of the Flax kernel orthonormal
  along its shorter side (gain 1)

The fans are JAX's, taken on the Flax shape (*k, in, out): a transpose
conv's port weight is (in, out, *k), so its fan-in is in * prod(k), where
``nn.init.kaiming_normal_`` would take out. The draws come from the
caller's ``torch.Generator``; they are not ``jax.random``'s.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

_INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
_KERNELS = (nn.modules.conv._ConvNd, nn.Linear)
_SCALES = (nn.modules.batchnorm._NormBase, nn.LayerNorm, nn.GroupNorm)


def _flax_shape(module: nn.Module, w: torch.Tensor):
    """The shape of ``w`` as a Flax kernel: (in, out) for a linear layer,
    (*k, in, out) for a conv or a transpose conv."""
    if isinstance(module, nn.Linear):
        return (w.shape[1], w.shape[0])
    a, b, *k = w.shape
    return (*k, a, b) if module.transposed else (*k, b, a)


def _from_flax(module: nn.Module, v: torch.Tensor) -> torch.Tensor:
    """A kernel in Flax's layout in the port's (``models/convert.py``'s
    ``torch_kernel``: a transpose conv's flipped on its spatial axes)."""
    if isinstance(module, nn.Linear):
        return v.t()
    n = v.ndim - 2
    if module.transposed:
        return v.permute(n, n + 1, *range(n)).flip(tuple(range(2, n + 2)))
    return v.permute(n + 1, n, *range(n))


def _orthogonal(rows: int, cols: int, generator, device) -> torch.Tensor:
    """A (rows, cols) matrix orthonormal along its shorter side: the Q of
    a normal matrix's QR with the signs of R's diagonal, as
    ``jax.nn.initializers.orthogonal``."""
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=generator,
                    device=device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return q if rows >= cols else q.t()


def _kernel(module: nn.Module, w: torch.Tensor, init_type: str,
            generator) -> torch.Tensor:
    shape = _flax_shape(module, w)
    rf = math.prod(shape[:-2])
    fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    if init_type == "orthogonal":
        q = _orthogonal(math.prod(shape[:-1]), shape[-1], generator,
                        w.device)
        return _from_flax(module, q.reshape(shape))
    std = {"normal": 0.02,
           "xavier": math.sqrt(2.0 / (fan_in + fan_out)),
           "kaiming": math.sqrt(2.0 / fan_in)}[init_type]
    return std * torch.randn(w.shape, generator=generator, device=w.device)


@torch.no_grad()
def init_weights(module: nn.Module, init_type: str = "normal",
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Re-initialise ``module``'s parameters in place (the reference's
    ``init_weights(net, init_type)``; JAX: ``init_weights(params, rng,
    init_type)``) and return it. ``generator`` must be on the parameters'
    device."""
    if init_type not in _INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    for m in module.modules():
        for name, p in m.named_parameters(recurse=False):
            if name == "bias":
                p.zero_()
            elif name == "weight" and isinstance(m, _KERNELS):
                p.copy_(_kernel(m, p, init_type, generator))
            elif name == "weight" and isinstance(m, _SCALES) and p.ndim == 1:
                p.copy_(1.0 + 0.02 * torch.randn(
                    p.shape, generator=generator, device=p.device))
    return module
