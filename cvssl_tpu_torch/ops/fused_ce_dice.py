"""Fused softmax cross-entropy + Dice over NCHW logits: CUDA kernels for
Hopper, with their plain PyTorch version beside them.

Replaces the TPU kernel ``cvssl_tpu/ops/pallas_kernels.py::fused_ce_dice_tpu``
(body ``_fused_reduction_kernel``, ``pallas_call`` at :84) and its
closed-form VJP ``_fused_bwd`` (:131).

What it computes, for logits (B, C, *spatial) and integer labels
(B, *spatial): per site the softmax p over C classes; summed over all n
sites, CE = sum -log p[y] and, per class, I = sum p*y, P = sum p^2,
L = sum y. The results are (CE / n, mean_c 1 - (2 I_c + s) / (P_c + L_c + s))
with s = 1e-5, as ``losses.cross_entropy`` and
``losses.dice_loss(softmax=True)``.
The backward is ``_fused_bwd``'s closed form with separate cotangents on CE
and Dice: g_ce (p - y) / n + g_dice p (gp - sum_k gp_k p_k), where
gp = (-2 y + 2 p (2I + s) / (P + L + s)) / (P + L + s) / C.

On the card both are one launch of a kernel in
``cvssl_tpu_torch/csrc/fused_ce_dice.cu``, whose header says what bounds
them (bytes) and what the design does about it: a persistent grid reads
the logits in place in NCHW with one 16-byte load per class plane, and the
forward's last block to finish sums the blocks' rows in block order, so
the result is deterministic. The wrapper decides which sites the vector
path takes (:func:`_geometry`) and keeps the forward's scratch: an int32
ticket and the blocks' rows, allocated once per device and stream.

On a CPU tensor :func:`fused_ce_dice` computes :func:`ce_dice_plain`; on a
CUDA tensor it launches the kernels or raises. The library is built with
``nvcc`` at the first launch (``ops/_cuda_build.py``, into
``build/kernels`` at the repository root) and loaded through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from cvssl_tpu_torch.ops import _cuda_build, losses

THREADS = 256      # threads per block, as in the kernels
MAX_CLASSES = 16   # the kernels exist for 2 <= C <= 16

LAUNCHES = {"ce_dice_fwd": 0, "ce_dice_bwd": 0}
"""Launches of each kernel, for a run to show that it went through them:
the wrapper adds one each time it launches its kernel from the host. A
CUDA graph capture of a step counts once, when the launch is recorded
(and nothing runs); its replays launch the kernel on the card with no
host call and count nothing here, so a graphed run counts its kernels in
a profile of the replays."""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interface of csrc/fused_ce_dice.cu: {function: (restype, argtypes)}
SIGNATURES = {
    "ce_dice_fwd_launch": (_I, [_P, _I, _P, _I, _I, _I, _I, _I, _I, _F,
                                _P, _P, _P, _I, _P]),
    "ce_dice_bwd_launch": (_I, [_P, _I, _P, _I, _I, _I, _I, _I, _I, _F,
                                _P, _P, _P, _P, _I, _P]),
    "ce_dice_blocks_per_sm": (_I, [_I, _I, _I, _I]),
    "ce_dice_noop_launch": (_I, [_P]),
    "ce_dice_error_string": (ctypes.c_char_p, [_I]),
}

_DEVICES: dict = {}    # device index -> (SMs, largest grid)
_OCCUPANCY: dict = {}  # (device, bwd, bf16, u8, C) -> blocks per SM
_SCRATCH: dict = {}    # (device, stream) -> (ticket, rows)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ce_dice_plain(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int):
    """The plain PyTorch version: (mean CE, mean Dice) through autograd.
    float64 logits stay float64, so it also serves as the reference."""
    return (losses.cross_entropy(logits, labels),
            losses.dice_loss(logits, labels, num_classes, softmax=True))


class Geometry(NamedTuple):
    """How the kernels walk the sites of each batch item: ``chunks``
    16-byte chunks of ``vec`` sites per class plane, then ``tail`` sites
    one by one."""
    batch: int
    classes: int
    sites: int
    vec: int
    vector: bool
    chunks: int
    tail: int


def _geometry(logits: torch.Tensor, labels: torch.Tensor) -> Geometry:
    """The vector path needs every class plane and every item's labels to
    start on a chunk boundary: logits at a 16-byte address with
    ``sites % vec == 0``, labels aligned to their chunk (16 bytes, or
    ``vec`` bytes of uint8). Otherwise every site takes the scalar loop."""
    if not logits.is_contiguous():
        raise ValueError(f"logits strides {logits.stride()} are not "
                         "NCHW-contiguous")
    b, c = logits.shape[:2]
    hw = math.prod(logits.shape[2:])
    vec = 16 // logits.element_size()
    label_align = min(16, vec * labels.element_size())
    vector = (hw % vec == 0 and logits.data_ptr() % 16 == 0
              and labels.data_ptr() % label_align == 0)
    chunks = hw // vec if vector else 0
    return Geometry(b, c, hw, vec, vector, chunks, hw - chunks * vec)


def _library():
    return _cuda_build.load("fused_ce_dice", SIGNATURES)


def _device(index: int):
    """(SMs, largest grid) of a Hopper card."""
    info = _DEVICES.get(index)
    if info is None:
        props = torch.cuda.get_device_properties(index)
        if (props.major, props.minor) != (9, 0):
            raise RuntimeError("fused CE+Dice: the kernels are built for "
                               f"sm_90a (Hopper), not {props.name}")
        sms = props.multi_processor_count
        info = _DEVICES[index] = (
            sms, sms * (props.max_threads_per_multi_processor // THREADS))
    return info


def _grid(lib, index: int, bwd: int, bf16: int, u8: int,
          geo: Geometry) -> int:
    """Blocks to launch: as many as the card holds at once (blocks per SM
    from the kernel's occupancy, times the SMs), no more than the work."""
    key = (index, bwd, bf16, u8, geo.classes)
    k = _OCCUPANCY.get(key)
    if k is None:
        k = lib.ce_dice_blocks_per_sm(bwd, bf16, u8, geo.classes)
        if k <= 0:
            raise RuntimeError(f"fused CE+Dice: no occupancy for {key}")
        _OCCUPANCY[key] = k
    work = geo.batch * max(geo.chunks, geo.tail)
    return max(1, min(-(-work // THREADS), k * _device(index)[0]))


def _scratch(device: torch.device, stream: int):
    """The forward's ticket (one int32, zero between launches) and rows
    (1 + 3C floats per block), allocated once per device and stream so that
    launches on one stream share them in order."""
    key = (device.index, stream)
    s = _SCRATCH.get(key)
    if s is None:
        largest = _device(device.index)[1]
        s = _SCRATCH[key] = (
            torch.zeros(1, dtype=torch.int32, device=device),
            torch.empty(largest * (1 + 3 * MAX_CLASSES), dtype=torch.float32,
                        device=device))
    return s


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"fused CE+Dice {what}: launch failed: "
                           f"{lib.ce_dice_error_string(err).decode()}")


def _outputs(out: torch.Tensor, c: int):
    """ce, dice and stats (3, C) as views of the forward's one buffer
    [ce, dice, I_0.., P_0.., L_0..]."""
    return out[0], out[1], out[2:].view(3, c)


def _check_cuda_inputs(logits: torch.Tensor, labels: torch.Tensor):
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be f32 or bf16, got {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.uint8):
        raise TypeError(f"labels must be int32 or uint8, got {labels.dtype}")
    if labels.device != logits.device:
        raise ValueError("logits and labels lie on different devices")
    if tuple(labels.shape) != tuple(logits.shape[:1] + logits.shape[2:]):
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits "
                         f"{tuple(logits.shape)} without the class axis")
    if not labels.is_contiguous():
        raise ValueError("labels must be contiguous")
    if not 2 <= logits.shape[1] <= MAX_CLASSES:
        raise ValueError(f"{logits.shape[1]} classes: the kernels take 2 to "
                         f"{MAX_CLASSES}")
    if logits.numel() == 0:
        raise ValueError("empty logits")
    if logits.numel() >= 2 ** 31:
        raise ValueError("logits of 2^31 elements or more")


def _forward_cuda(logits: torch.Tensor, labels: torch.Tensor):
    """The forward kernel, one launch: (ce, dice, stats (3, C)), views of
    one float32 buffer on the card."""
    geo = _geometry(logits, labels)
    dev = logits.device
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bf16 = int(logits.dtype == torch.bfloat16)
        u8 = int(labels.dtype == torch.uint8)
        grid = _grid(lib, dev.index, 0, bf16, u8, geo)
        ticket, rows = _scratch(dev, stream)
        out = torch.empty(2 + 3 * geo.classes, dtype=torch.float32,
                          device=dev)
        err = lib.ce_dice_fwd_launch(
            logits.data_ptr(), bf16, labels.data_ptr(), u8, geo.batch,
            geo.classes, geo.sites, geo.chunks, geo.tail,
            float(geo.batch * geo.sites), rows.data_ptr(), ticket.data_ptr(),
            out.data_ptr(), grid, stream)
    _raise_on(lib, err, "forward")
    LAUNCHES["ce_dice_fwd"] += 1
    return _outputs(out, geo.classes)


def _backward_cuda(logits, labels, stats, g_ce, g_dice):
    """The backward kernel, one launch: the gradient in the logits' dtype
    and layout, from the forward's stats and the two cotangents (float32
    scalars on the card)."""
    geo = _geometry(logits, labels)
    dev = logits.device
    lib = _library()
    grad = torch.empty_like(logits, memory_format=torch.contiguous_format)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        bf16 = int(logits.dtype == torch.bfloat16)
        u8 = int(labels.dtype == torch.uint8)
        grid = _grid(lib, dev.index, 1, bf16, u8, geo)
        err = lib.ce_dice_bwd_launch(
            logits.data_ptr(), bf16, labels.data_ptr(), u8, geo.batch,
            geo.classes, geo.sites, geo.chunks, geo.tail,
            float(geo.batch * geo.sites), stats.data_ptr(), g_ce.data_ptr(),
            g_dice.data_ptr(), grad.data_ptr(), grid, stream)
    _raise_on(lib, err, "backward")
    LAUNCHES["ce_dice_bwd"] += 1
    return grad


class _FusedCEDice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ce, dice, stats = _forward_cuda(logits, labels)
        ctx.save_for_backward(logits, labels, stats)
        return ce, dice

    @staticmethod
    def backward(ctx, g_ce, g_dice):
        logits, labels, stats = ctx.saved_tensors
        return _backward_cuda(logits, labels, stats,
                              g_ce.float().contiguous(),
                              g_dice.float().contiguous()), None


def fused_ce_dice(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int):
    """(ce, dice) for logits (B, C, *spatial) and labels (B, *spatial).

    CPU tensors take :func:`ce_dice_plain`; CUDA tensors take the CUDA
    kernels (forward and backward) or raise. JAX: ``fused_ce_dice``."""
    if logits.ndim < 2 or logits.shape[1] != num_classes:
        raise ValueError(f"logits {tuple(logits.shape)} do not have "
                         f"{num_classes} classes on axis 1")
    if logits.device.type == "cpu":
        return ce_dice_plain(logits, labels, num_classes)
    if logits.device.type != "cuda":
        raise ValueError(f"no fused CE+Dice for device {logits.device}")
    _check_cuda_inputs(logits, labels)
    return _FusedCEDice.apply(logits, labels)
