"""UNet3D's eval forward with the H axis split over the ranks (port of
``cvssl_tpu/parallel/halo.py``): a volume too large for one card runs as
slabs, and each 3^3 convolution receives one-plane halos from the
neighbouring ranks instead of the whole volume living anywhere.

NCDHW, split axis H (dim 3), every rank holding H / W planes:

* 3^3 conv: the edge planes of every rank are all-gathered (gloo's
  send/recv does not take CUDA tensors), each rank puts its neighbours'
  planes before and after its slab (zeros at the global edge: the SAME
  padding of the whole conv), then convolves VALID along H;
* InstanceNorm: per-(sample, channel) sums all-reduced, mean first and
  then the sum of squared deviations: the statistics of the whole volume;
* maxpool 2^3: local; the slab must stay even at every level, so H must
  divide by 16 * W;
* trilinear x2 (half-pixel centres, edges clamped): D and W resized
  locally, H by the closed form out[2i] = .25 x[i-1] + .75 x[i],
  out[2i+1] = .75 x[i] + .25 x[i+1] with edge-replicated halos.

The forward reads the unsharded ``models/unet3d.py::UNet3D``'s own weights,
in float32 (any trained checkpoint runs split).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cvssl_tpu_torch.parallel.mesh import Mesh


def _halos(x: torch.Tensor, mesh: Mesh, mode: str):
    """The planes before and after this rank's slab on dim 3: the
    neighbours' edge planes, and at the global edge zeros (``mode``
    "zero") or the slab's own edge plane ("edge")."""
    edges = torch.stack([x[:, :, :, :1], x[:, :, :, -1:]])
    every = _gather(edges, mesh)
    r = mesh.rank
    if r > 0:
        before = every[r - 1, 1]
    else:
        before = torch.zeros_like(edges[0]) if mode == "zero" else edges[0]
    if r < mesh.world - 1:
        after = every[r + 1, 0]
    else:
        after = torch.zeros_like(edges[1]) if mode == "zero" else edges[1]
    return before, after


def _gather(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` stacked on a new leading axis, in rank order."""
    if not mesh.distributed:
        return t[None]
    every = t.new_empty((mesh.world * t.shape[0],) + tuple(t.shape[1:]))
    dist.all_gather_into_tensor(every, t.contiguous(), group=mesh.group)
    return every.view((mesh.world,) + tuple(t.shape))


def _conv3(conv: torch.nn.Conv3d, x: torch.Tensor, mesh: Mesh):
    """The SAME 3^3 conv of the whole volume, on this rank's slab."""
    before, after = _halos(x, mesh, "zero")
    xh = torch.cat([before, x, after], dim=3)
    return F.conv3d(xh, conv.weight, conv.bias, padding=(1, 0, 1))


def _all_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.distributed:
        dist.all_reduce(t, group=mesh.group)
    return t


def _instance_norm(x: torch.Tensor, mesh: Mesh, eps: float = 1e-5):
    """Instance norm with the statistics of the whole volume."""
    dims = (2, 3, 4)
    n = x.shape[2] * x.shape[3] * x.shape[4] * mesh.world
    mean = _all_sum(x.sum(dims, keepdim=True), mesh) / n
    d = x - mean
    var = _all_sum((d * d).sum(dims, keepdim=True), mesh) / n
    return d * torch.rsqrt(var + eps)


def _up_x2(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Trilinear x2 (half-pixel centres, edges clamped) of the slab: D and
    W locally, H with edge-replicated halos."""
    b, c, d, h, w = x.shape
    y = F.interpolate(x.permute(0, 3, 1, 2, 4).reshape(b * h, c, d, w),
                      scale_factor=2, mode="bilinear", align_corners=False)
    y = y.reshape(b, h, c, 2 * d, 2 * w).permute(0, 2, 3, 1, 4)
    before, after = _halos(y, mesh, "edge")
    xm1 = torch.cat([before, y[:, :, :, :-1]], dim=3)
    xp1 = torch.cat([y[:, :, :, 1:], after], dim=3)
    even = 0.25 * xm1 + 0.75 * y
    odd = 0.75 * y + 0.25 * xp1
    return torch.stack([even, odd], dim=4).reshape(b, c, 2 * d, 2 * h, 2 * w)


def _block(block, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``UnetConv3``: two conv-InstanceNorm-ReLU."""
    x = torch.relu(_instance_norm(_conv3(block.conv1[0], x, mesh), mesh))
    return torch.relu(_instance_norm(_conv3(block.conv2[0], x, mesh), mesh))


def sharded_unet3d_forward(model, image, mesh: Mesh) -> torch.Tensor:
    """``model``'s (``UNet3D``) eval-mode logits of ``image`` (B, 1, D, H,
    W), whole on every rank, with H split over ``mesh``: each rank runs its
    slab of H / W planes, and the slabs' logits are gathered. Returns the
    (B, classes, D, H, W) float32 logits on the mesh's device, on every
    rank. H must divide by 16 * W, so that every maxpool level keeps an
    even slab."""
    world = mesh.world
    image = torch.as_tensor(image)
    b, _, d, h, w = image.shape
    if h % (16 * world):
        raise ValueError(f"H={h} must divide by 16 * world size = "
                         f"{16 * world}, so that every maxpool level keeps "
                         "an even slab")
    rows = slice(mesh.rank * (h // world), (mesh.rank + 1) * (h // world))
    x = image[:, :, :, rows].to(mesh.device, torch.float32)
    with torch.no_grad(), torch.autocast(mesh.device.type, enabled=False):
        conv1 = _block(model.conv1, x, mesh)
        conv2 = _block(model.conv2, F.max_pool3d(conv1, 2), mesh)
        conv3 = _block(model.conv3, F.max_pool3d(conv2, 2), mesh)
        conv4 = _block(model.conv4, F.max_pool3d(conv3, 2), mesh)
        center = _block(model.center, F.max_pool3d(conv4, 2), mesh)
        up = center
        for skip, level in ((conv4, model.up_concat4),
                            (conv3, model.up_concat3),
                            (conv2, model.up_concat2),
                            (conv1, model.up_concat1)):
            up = _block(level.conv, torch.cat([skip, _up_x2(up, mesh)], 1),
                        mesh)
        out = F.conv3d(up, model.final.weight, model.final.bias)
        return torch.cat(list(_gather(out, mesh)), dim=3)
