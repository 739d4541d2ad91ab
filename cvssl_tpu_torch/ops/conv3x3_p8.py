"""Pixel-packed SAME 3x3 convolution for C = Co = 16: CUDA kernels for
Hopper, with their plain PyTorch version beside them.

Replaces the three TPU kernels of ``cvssl_tpu/ops/pallas_conv.py``:
``conv3x3_p8`` (:215, ``pallas_call`` :238), ``conv3x3_p8_dma`` (:112,
:126) and ``conv3x3_p8_db`` (:182, :194). Each public function keeps the JAX
signature and layout: ``x`` (B, H, W, 16) NHWC in float32 or bfloat16,
``k`` (3, 3, 16, 16) HWIO, output always float32, with the JAX contract
W % 8 == 0 and H % tile_h == 0. They are forward-only, as the JAX functions
define no VJP: an input that requires a gradient raises.

No production path calls them (the JAX models use space-to-depth instead,
``pallas_conv.py:28-31``); they are ported as the JAX package uses them,
standalone, and held against a convolution.

On a CPU tensor each function computes :func:`conv3x3_p8_plain`, the
banded-matmul formulation of the TPU kernels (nine (128, 128) band matrices
from :func:`build_banded_mats`) in float32, float64 staying float64. On a
CUDA tensor it launches its kernel from ``cvssl_tpu_torch/csrc/
conv3x3_p8.cu`` or raises. The kernels are built with ``nvcc`` at the first
launch into ``build/kernels/`` at the repository root, keyed by a hash of
the source, and loaded through ``ctypes`` (``ops/_cuda_build.py``). All
three multiply on the tensor cores in split TF32 through one inner loop
and differ in where its input comes from: device memory, one halo tile in
shared memory, or a ring of two. The source's header says what bounds
them on the card and what each design does about it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cvssl_tpu_torch.ops import _cuda_build

P = 8   # pixels per 128-wide packed group
C = 16  # channels in and out

_VARIANTS = {"conv3x3_p8": 0, "conv3x3_p8_dma": 1, "conv3x3_p8_db": 2}

# launches of each kernel, for a run to show that it went through them
LAUNCHES = {name: 0 for name in _VARIANTS}
# the C interface of csrc/conv3x3_p8.cu: {function: (restype, argtypes)}
SIGNATURES = {
    "conv3x3_p8_launch": (ctypes.c_int, [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]),
    "conv3x3_p8_error_string": (ctypes.c_char_p, [ctypes.c_int]),
}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_banded_mats(k: torch.Tensor):
    """k (3, 3, C, Co) -> {(dh, G): (P*C, P*Co)} banded matrices, as the JAX
    function builds them: out pixel v of a group reads in pixel u of the
    group G away through k[dh, dw] iff v = u - dw + 1 + 8G."""
    c, co = k.shape[2], k.shape[3]
    mats = {}
    for dh in range(3):
        for g in (-1, 0, 1):
            m = k.new_zeros((P * c, P * co))
            for dw in range(3):
                for u in range(P):
                    v = u - (dw - 1) + 8 * g
                    if 0 <= v < P:
                        m[u * c:(u + 1) * c, v * co:(v + 1) * co] = k[dh, dw]
            mats[(dh, g)] = m
    return mats


def conv3x3_p8_plain(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The plain version: nine banded matmuls over pixel-packed rows, the
    TPU kernels' arithmetic over the whole image at once. float32 (bfloat16
    widened), or float64 for float64 inputs."""
    b, h, w, c = x.shape
    co = k.shape[3]
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    xp = F.pad(x.to(dt), (0, 0, P, P, 1, 1)).reshape(b, h + 2,
                                                     (w + 2 * P) * c)
    mats = build_banded_mats(k.to(dt))
    acc = x.new_zeros((b * h * (w // P), P * co), dtype=dt)
    for dh in range(3):
        for g in (-1, 0, 1):
            start = (1 + g) * P * c
            a = xp[:, dh:dh + h, start:start + w * c].reshape(-1, P * c)
            acc += a @ mats[(dh, g)]
    return acc.reshape(b, h, w, co)


def _check(x: torch.Tensor, k: torch.Tensor, tile_h: int):
    if x.dim() != 4 or x.shape[3] != C:
        raise ValueError(f"x must be (B, H, W, {C}), got {tuple(x.shape)}")
    if tuple(k.shape) != (3, 3, C, C):
        raise ValueError(f"k must be (3, 3, {C}, {C}), got {tuple(k.shape)}")
    b, h, w, _ = x.shape
    if w % P:
        raise ValueError(f"W = {w} is not a multiple of {P}")
    if tile_h <= 0 or h % tile_h:
        raise ValueError(f"H = {h} is not a multiple of tile_h = {tile_h}")
    if x.requires_grad or k.requires_grad:
        raise ValueError("conv3x3_p8 is forward-only (the JAX kernels "
                         "define no VJP): inputs must not require grad")
    if x.device != k.device:
        raise ValueError(f"x on {x.device}, k on {k.device}")


def _library():
    """Build (once per source hash) and load the kernels' shared library."""
    return _cuda_build.load("conv3x3_p8", SIGNATURES)


def _launch_cuda(name: str, x: torch.Tensor, k: torch.Tensor,
                 tile_h: int) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: x must be float32 or bfloat16 on CUDA, "
                         f"got {x.dtype}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError(f"{name}: the kernels are built for sm_90a "
                           "(Hopper)")
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()  # cp.async and vector loads need 16-byte alignment
    k32 = k.to(torch.float32).contiguous()
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, C), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_p8_launch(
            _VARIANTS[name], x.data_ptr(), int(x.dtype == torch.bfloat16),
            k32.data_ptr(), out.data_ptr(), b, h, w, tile_h, stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed: "
                           f"{lib.conv3x3_p8_error_string(err).decode()}")
    LAUNCHES[name] += 1
    return out


def _conv(name: str, x: torch.Tensor, k: torch.Tensor,
          tile_h: int) -> torch.Tensor:
    _check(x, k, tile_h)
    if x.is_cuda:
        return _launch_cuda(name, x, k, tile_h)
    return conv3x3_p8_plain(x, k)


def conv3x3_p8(x: torch.Tensor, k: torch.Tensor,
               tile_h: int = 32) -> torch.Tensor:
    """SAME 3x3 stride-1 conv, x (B, H, W, 16), k (3, 3, 16, 16) ->
    float32 (B, H, W, 16). On the card each block computes four row tiles
    of ``tile_h`` rows (fewer at the bottom of the image) of a 16-column
    strip on the tensor cores, each warp two output rows at a time as an
    implicit GEMM of ``mma.sync`` m16n8k8 TF32 products with float32 sums,
    its operands split into TF32 high and low parts (three products for
    float32 input, two for bfloat16, which TF32 holds exactly); the warps
    read their A operands straight from device memory (no shifted views,
    no shared-memory tile), zero outside the image. The float32 sums leave
    it within about 2e-6 of the largest output from float64."""
    return _conv("conv3x3_p8", x, k, tile_h)


def conv3x3_p8_dma(x: torch.Tensor, k: torch.Tensor,
                   tile_h: int = 32) -> torch.Tensor:
    """:func:`conv3x3_p8`; on the card each block copies one (tile_h + 2)
    x 18-pixel halo tile into shared memory once (``cp.async``) and the
    warps read their A operands from it."""
    return _conv("conv3x3_p8_dma", x, k, tile_h)


def conv3x3_p8_db(x: torch.Tensor, k: torch.Tensor,
                  tile_h: int = 32) -> torch.Tensor:
    """:func:`conv3x3_p8_dma`, with two row tiles a block through a
    two-stage ``cp.async`` ring: the second tile in flight while the first
    is computed."""
    return _conv("conv3x3_p8_db", x, k, tile_h)
