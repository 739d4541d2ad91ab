"""Pretrained Swin weights into the port's SwinUnet (port of
``cvssl_tpu/models/swin_checkpoint.py::convert_swin_checkpoint``).

The reference's ``load_from`` (``vision_transformer.py:54-89``): an
ImageNet Swin-tiny ``state_dict`` fills the encoder under its own names, and
each encoder stage's blocks ``layers.{i}.blocks`` are copied into the
decoder stage ``layers_up.{n-1-i}.blocks`` (n stages; for n-1-i > 0, where
the decoder has blocks). Entries whose shape differs from the model's are
dropped, as are keys the model does not have. The port's model names are the
reference's, so the remap is one of keys, not of layouts.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch
from torch import nn

# the reference's constant buffers, which the port builds at run time
_BUFFERS = ("attn_mask", "relative_position_index")


def _strip(state_dict: Mapping[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """Drop the constant buffers and the ``ViT_seg`` wrapper's
    ``swin_unet.`` prefix."""
    out = {}
    for k, v in state_dict.items():
        if any(b in k for b in _BUFFERS):
            continue
        out[k[len("swin_unet."):] if k.startswith("swin_unet.") else k] = v
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's tensors (unwrapping ``{"model": ...}``), on the
    CPU, without the constant buffers."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return _strip({k: v for k, v in sd.items() if torch.is_tensor(v)})


def load_from(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
              ) -> Dict[str, int]:
    """Load a Swin ``state_dict`` into ``model`` (a ``SwinUnet``) as the
    reference's ``load_from`` does, in place. Returns {"loaded": entries
    copied, "skipped": entries the model has under another shape}."""
    full = _strip(state_dict)
    decoder_stages = len(model.layers_up)
    for k, v in list(full.items()):
        m = re.match(r"layers\.(\d+)\.(.*)$", k)
        if m:
            j = decoder_stages - 1 - int(m.group(1))
            full[f"layers_up.{j}.{m.group(2)}"] = v
    own = model.state_dict()
    loaded = {k: v for k, v in full.items()
              if k in own and tuple(v.shape) == tuple(own[k].shape)}
    skipped = sum(1 for k, v in full.items()
                  if k in own and tuple(v.shape) != tuple(own[k].shape))
    model.load_state_dict(loaded, strict=False)
    return {"loaded": len(loaded), "skipped": skipped}
