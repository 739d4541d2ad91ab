"""Intermediate features of a forward pass (port of
``cvssl_tpu/utils/features.py``; the reference's
``code/networks/utils.py:380-453`` ``FeatureExtractor`` and
``HookBasedFeatureExtractor``).

A layer is named by the last component of its path in
``model.named_modules()`` (``"down2"`` matches ``encoder.down2``), as JAX
matches a Flax submodule's name; every module of that name is captured,
in ``named_modules`` order, each by its first call in the pass. The
forward hooks are removed when the pass ends, whether it raised or not.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _capture(model: torch.nn.Module, x, names, forward_kwargs):
    """(output, [(path, activation), ...]) of one forward of ``model`` on
    ``x`` with the modules whose name ends in one of ``names`` hooked."""
    found = {}
    handles = []

    def hook(path):
        def fn(module, args, output):
            found.setdefault(path, output)
        return fn

    paths = [p for p, _ in model.named_modules()
             if p and p.rsplit(".", 1)[-1] in names]
    try:
        for path in paths:
            handles.append(model.get_submodule(path).register_forward_hook(
                hook(path)))
        out = model(x, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    return out, [(p, found[p]) for p in paths if p in found]


def extract_features(model: torch.nn.Module, x: torch.Tensor,
                     layer_name: str, upscale: bool = False,
                     **forward_kwargs):
    """(output, [(path, activation), ...]) of the modules named
    ``layer_name`` in one forward of ``model`` on ``x`` (N, C, *spatial).
    With ``upscale``, each activation of ``x``'s rank (in a tuple or list
    too) is resized to ``x``'s spatial size, bilinear or trilinear (the
    reference's ``rescale_output_array``, ``utils.py:432-437``). JAX:
    ``features.extract_features``."""
    out, feats = _capture(model, x, {layer_name}, forward_kwargs)
    if upscale:
        spatial = tuple(x.shape[2:])
        mode = "trilinear" if len(spatial) == 3 else "bilinear"

        def up(a):
            if isinstance(a, (tuple, list)):
                return type(a)(up(v) for v in a)
            if isinstance(a, torch.Tensor) and a.ndim == x.ndim:
                return F.interpolate(a, size=spatial, mode=mode,
                                     align_corners=False)
            return a
        feats = [(p, up(a)) for p, a in feats]
    return out, feats


def extract_layers(model: torch.nn.Module, x: torch.Tensor,
                   layer_names: Sequence[str], **forward_kwargs):
    """(output, [(path, activation), ...]) of the modules named in
    ``layer_names`` in one forward (the reference's ``FeatureExtractor``).
    JAX: ``features.extract_layers``."""
    return _capture(model, x, set(layer_names), forward_kwargs)
