"""MONAI-format UNETR / SwinUNETR checkpoints for the port (port of
``cvssl_tpu/models/monai_checkpoint.py``).

The port's ``unetr`` and ``swinunetr`` keep MONAI's module names, so a
MONAI ``state_dict`` is already the port's, tensor for tensor: the
converters read the same keys as JAX's (the port-side names of
``models/convert.py``'s leaves), check each against the port model's
shape (a mismatch raises, as JAX's ``_set``) and return the port's
``state_dict`` with JAX's report: ``loaded`` (tensors the model takes),
``skipped`` (tensors it has no place for) and ``torch_keys``. Like JAX's,
a res block's ``conv3`` is read only where the checkpoint has one.

SwinUNETR's ``relative_position_index`` buffers are not weights: the port
builds the index itself (``swin_unetr.window_constants``). Each one in
the checkpoint must equal the configured window's index, and is counted
neither in ``loaded`` nor in ``torch_keys``, so the counts equal JAX's on
the checkpoint without them (which JAX's MONAI parity test feeds it).
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import torch
from torch import nn

from cvssl_tpu_torch.models import convert
from cvssl_tpu_torch.models.swin_unetr import (SwinTransformerBlock,
                                               relative_position_index_3d)

INDEX = "relative_position_index"


def _convert(net_type: str, torch_sd: Mapping, net: nn.Module,
             depths: Sequence[int]) -> Tuple[Dict[str, torch.Tensor], dict]:
    td = {k: torch.as_tensor(v).detach().cpu() for k, v in torch_sd.items()}
    own = net.state_dict()
    state: Dict[str, torch.Tensor] = {}
    loaded = skipped = 0
    for key, _, _, _ in convert.leaves(net_type, depths):
        if ".conv3.conv." in key and key not in td:
            continue
        value = td[key]
        if key not in own:
            skipped += 1
            continue
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(own[key].shape)} vs "
                             f"{tuple(value.shape)}")
        state[key] = value.to(own[key].dtype)
        loaded += 1
    return state, {"loaded": loaded, "skipped": skipped,
                   "torch_keys": len(td)}


def convert_unetr_checkpoint(torch_sd: Mapping, net: nn.Module
                             ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """MONAI UNETR ``state_dict`` -> the port ``UNETR`` ``net``'s
    ``state_dict`` (load it with ``net.load_state_dict``), and the
    report."""
    layers = len({k.split(".")[2] for k in torch_sd
                  if k.startswith("vit.blocks.")})
    return _convert("unetr", torch_sd, net, (layers,))


def convert_swin_unetr_checkpoint(torch_sd: Mapping, net: nn.Module,
                                  depths: Sequence[int] = (2, 2, 2, 2)
                                  ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """MONAI SwinUNETR ``state_dict`` -> the port ``SwinUNETR`` ``net``'s
    ``state_dict``, and the report; each ``relative_position_index``
    buffer is checked against the index of ``net``'s configured window and
    then dropped."""
    ws = next(m.full_ws for m in net.modules()
              if isinstance(m, SwinTransformerBlock))
    want = relative_position_index_3d(ws)
    rest = {}
    for key, value in torch_sd.items():
        if not key.endswith(f".attn.{INDEX}"):
            rest[key] = value
        elif not torch.equal(torch.as_tensor(value).long(), want):
            raise ValueError(f"{key}: not the relative-position index of "
                             f"the model's {ws} window")
    return _convert("swinunetr", rest, net, tuple(depths))
