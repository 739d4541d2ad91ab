"""BatchNorm in train mode with a LeakyReLU fused after it (or none): CUDA
kernels for Hopper, with their plain PyTorch version beside them.

Replaces no TPU kernel: the JAX package's BatchNorm is flax's, left to XLA.
On the card the port's bf16 BatchNorm went to ATen's native NCHW kernels
(ATen keeps cuDNN for float32). Their statistics and backward reduction
run one block a channel: 16 blocks for the UNet's widest level on a
132-SM card, 54% of the graphed mean-teacher step.
``cvssl_tpu_torch/csrc/batch_norm_act.cu`` splits each channel's reduction
over many blocks and fuses the activation into the same passes; its header
says what bounds the kernels (bytes) and how the design meets them.

What it computes, for x (N, C, *spatial): the batch mean and BIASED
variance of each channel, y = act((x - mean) / sqrt(var + eps) * w + b)
with act LeakyReLU(slope) or, for ``slope=None``, the identity, and flax's
running-statistics update with the biased variance:
``r = (1 - momentum) * r + momentum * batch``. The backward gives dx, dw
and db, with the activation's derivative taken from the float32
pre-activation.

On a CPU tensor :func:`batch_norm_act` computes :func:`batch_norm_act_plain`
(``F.batch_norm`` on scratch statistics, then ``F.leaky_relu``: the lines
``models/unet.py::BatchNorm2d`` always ran); on a CUDA tensor it launches
the kernels or raises. Four launches a layer and step: statistics, then
apply (forward), and the backward's sums, then its apply. The grid,
C * splits blocks of ``THREADS``, is chosen from the shape alone
(:func:`_geometry`). The library is built with ``nvcc`` at the first launch
(``ops/_cuda_build.py``) and loaded through ``ctypes``.

Against the plain version on the card (bf16 in and out, float32 statistics,
as ATen): the fused output is rounded to bf16 once, where BatchNorm then
LeakyReLU rounded twice on negative values; the backward takes the
LeakyReLU's branch from the float32 pre-activation, not from the rounded
BatchNorm output.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from cvssl_tpu_torch.ops import _cuda_build

THREADS = 256        # threads a block, as in the kernels
BLOCKS_PER_SM = 8    # resident 256-thread blocks an SM holds (2048 threads)
WAVES = 2            # a layer's grid aims at this many waves of the card
MAX_CHANNELS = 16384  # the tickets' buffer, one uint32 a channel

LAUNCHES = {"bn_act_fwd": 0, "bn_act_bwd": 0}
"""Host calls of each direction (two kernels each), for a run to show that
it went through them: the wrapper adds one each time it launches. A CUDA
graph capture counts once, when the launch is recorded; its replays launch
on the card with no host call and count nothing here, so a graphed run
counts its kernels (names beginning ``bnact_``) in a profile of the
replays."""

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interface of csrc/batch_norm_act.cu: {function: (restype, argtypes)}
SIGNATURES = {
    "bnact_fwd_launch": (_I, [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                              _F, _F, _F, _P, _P, _P, _P, _P, _P]),
    "bnact_bwd_launch": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                              _P, _F, _P, _P, _P, _P, _P]),
    "bnact_error_string": (ctypes.c_char_p, [_I]),
}

_SMS: dict = {}      # device index -> SMs
_TICKETS: dict = {}  # (device, stream) -> MAX_CHANNELS zeroed uint32


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def batch_norm_act_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor],
                         running_mean: torch.Tensor,
                         running_var: torch.Tensor, momentum: float,
                         eps: float, slope: Optional[float] = None
                         ) -> torch.Tensor:
    """The plain PyTorch version: run with momentum 1 on scratch buffers,
    ``F.batch_norm`` leaves the batch mean and unbiased variance there, so
    the running update costs no second pass over the activations; then
    ``F.leaky_relu`` unless ``slope`` is None."""
    mean = torch.zeros_like(running_mean)
    var = torch.zeros_like(running_var)
    y = F.batch_norm(x, mean, var, weight, bias, True, 1.0, eps)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        m = momentum
        running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        running_var.mul_(1.0 - m).add_(var, alpha=m * (n - 1) / n)
    return y if slope is None else F.leaky_relu(y, slope)


class Geometry(NamedTuple):
    """How the kernels walk x (N, C, L): packs of ``vec`` values (16 bytes,
    or one value where ``vector`` is false), ``splits`` blocks a channel of
    ``per`` packs each."""
    n: int
    c: int
    l: int
    vec: int
    vector: bool
    splits: int
    per: int


def _geometry(x: torch.Tensor, sms: int) -> Geometry:
    """The launch geometry from the shape alone. The 16-byte path needs
    every plane to start on a 16-byte boundary (aligned ``data_ptr``,
    L % (16 / element size) == 0), else every value takes the scalar loop.
    Blocks a channel: as many as ``WAVES`` waves of resident blocks over
    the C channels, but no more than the channel's packs over the threads
    of a block (rounded up), and none empty."""
    n, c = x.shape[:2]
    l = math.prod(x.shape[2:])
    width = 16 // x.element_size()
    vector = l % width == 0 and x.data_ptr() % 16 == 0
    vec = width if vector else 1
    packs = n * (l // vec)
    splits = -(-WAVES * BLOCKS_PER_SM * sms // c)
    splits = max(1, min(splits, -(-packs // THREADS)))
    per = -(-packs // splits)
    return Geometry(n, c, l, vec, vector, -(-packs // per), per)


def check_inputs(x: torch.Tensor, weight: Optional[torch.Tensor],
                 bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                 running_var: torch.Tensor):
    """Raise on what the kernels do not take: x other than float32 or
    bfloat16, or not contiguous (N, C, *spatial); a channel of one value
    (as ``F.batch_norm`` in train mode); parameters and running statistics
    other than float32 vectors of C on x's device."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.ndim < 2:
        raise ValueError(f"x {tuple(x.shape)} has no channel axis")
    if not x.is_contiguous():
        raise ValueError(f"x strides {x.stride()} are not contiguous "
                         "(N, C, *spatial)")
    c = x.shape[1]
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"{c} channels: the kernels take 1 to "
                         f"{MAX_CHANNELS}")
    if x.numel() >= 2 ** 31:
        raise ValueError("x of 2^31 elements or more")
    if x.numel() // c <= 1:
        raise ValueError("Expected more than 1 value per channel when "
                         f"training, got input size {tuple(x.shape)}")
    for name, t in (("weight", weight), ("bias", bias),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if t is None and name in ("weight", "bias"):
            continue
        if t is None or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.device != x.device or tuple(t.shape) != (c,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) tensor on "
                             f"{x.device}")


def _library():
    return _cuda_build.load("batch_norm_act", SIGNATURES)


def _sms(index: int) -> int:
    """SMs of a Hopper card."""
    sms = _SMS.get(index)
    if sms is None:
        props = torch.cuda.get_device_properties(index)
        if (props.major, props.minor) != (9, 0):
            raise RuntimeError("fused BatchNorm: the kernels are built for "
                               f"sm_90a (Hopper), not {props.name}")
        sms = _SMS[index] = props.multi_processor_count
    return sms


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    """One uint32 a channel (as int32), zero between launches, allocated once
    per device and stream, so that launches on one stream share it in order
    and a CUDA graph's pointer to it stays valid."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(MAX_CHANNELS, dtype=torch.int32,
                                        device=device)
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"fused BatchNorm {what}: launch failed: "
                           f"{lib.bnact_error_string(err).decode()}")


def _forward_cuda(x, weight, bias, running_mean, running_var, momentum, eps,
                  slope):
    """Statistics and apply, two launches: (y, stats), stats = 3C floats
    (batch mean, biased variance, invstd). The running statistics are
    updated in place."""
    dev = x.device
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        geo = _geometry(x, _sms(dev.index))
        y = torch.empty_like(x)
        stats = torch.empty(3 * geo.c, dtype=torch.float32, device=dev)
        part = torch.empty(3 * geo.c * geo.splits, dtype=torch.float32,
                           device=dev)
        err = lib.bnact_fwd_launch(
            x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
            int(geo.vector), geo.n, geo.c, geo.l, geo.splits, geo.per,
            _ptr(weight), _ptr(bias), float(eps), float(slope),
            float(momentum), running_mean.data_ptr(),
            running_var.data_ptr(), part.data_ptr(),
            _tickets(dev, stream).data_ptr(), stats.data_ptr(), stream)
    _raise_on(lib, err, "forward")
    LAUNCHES["bn_act_fwd"] += 1
    return y, stats


def _backward_cuda(x, dy, weight, bias, stats, slope):
    """The backward's sums and apply, two launches: (dx in x's dtype,
    gsum = 2C floats (db, dw))."""
    dev = x.device
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        geo = _geometry(x, _sms(dev.index))
        if geo.vector and dy.data_ptr() % 16:
            dy = dy.clone()  # the 16-byte path reads dy as it reads x
        dx = torch.empty_like(x)
        gsum = torch.empty(2 * geo.c, dtype=torch.float32, device=dev)
        part = torch.empty(2 * geo.c * geo.splits, dtype=torch.float32,
                           device=dev)
        err = lib.bnact_bwd_launch(
            x.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            int(x.dtype == torch.bfloat16), int(geo.vector), geo.n, geo.c,
            geo.l, geo.splits, geo.per, _ptr(weight), _ptr(bias),
            float(slope), stats.data_ptr(), part.data_ptr(),
            _tickets(dev, stream).data_ptr(), gsum.data_ptr(), stream)
    _raise_on(lib, err, "backward")
    LAUNCHES["bn_act_bwd"] += 1
    return dx, gsum


class _BatchNormAct(torch.autograd.Function):
    """Saves x, the batch statistics, w and b: no activation output."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps, slope):
        y, stats = _forward_cuda(x, weight, bias, running_mean, running_var,
                                 momentum, eps, slope)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.slope = slope
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, stats = ctx.saved_tensors
        dx, gsum = _backward_cuda(x, dy.to(x.dtype).contiguous(), weight,
                                  bias, stats, ctx.slope)
        c = x.shape[1]
        dw = gsum[c:] if ctx.needs_input_grad[1] else None
        db = gsum[:c] if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None, None, None, None


def batch_norm_act(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], running_mean: torch.Tensor,
                   running_var: torch.Tensor, momentum: float, eps: float,
                   slope: Optional[float] = None) -> torch.Tensor:
    """Train-mode BatchNorm of x (N, C, *spatial) with the batch's
    statistics, flax's running update, then LeakyReLU(``slope``) or, for
    None, nothing. CPU tensors take :func:`batch_norm_act_plain`; CUDA
    tensors take the kernels (contiguous float32 or bfloat16 x) or
    raise."""
    if x.device.type == "cpu":
        return batch_norm_act_plain(x, weight, bias, running_mean,
                                    running_var, momentum, eps, slope)
    if x.device.type != "cuda":
        raise ValueError(f"no fused BatchNorm for device {x.device}")
    check_inputs(x, weight, bias, running_mean, running_var)
    return _BatchNormAct.apply(x, weight, bias, running_mean, running_var,
                               float(momentum), float(eps),
                               1.0 if slope is None else float(slope))
