"""Fused softmax cross-entropy + Dice over NCHW logits: Triton kernels for
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

Bound: bytes. Per site the forward does some 10 C flops on C logits and one
label, far below the ~20 flop per byte at which the H100's float32 units
(67 TFLOP/s) would take over from its memory (3.35 TB/s; SXM data sheet,
700 W). At the main-path shape (12, 4, 256, 256) the forward reads 12.6 MB
of f32 logits (6.3 MB in bf16) and 3.1 MB of int32 labels: 4.7 us at
3.35 TB/s (2.8 us in bf16). The backward reads the same and writes the
gradient in the logits' dtype: 8.5 us (4.7 us in bf16).

What the design does about it: every byte is touched once per pass.
* Logits are read in place in NCHW: each class plane is contiguous at
  stride H*W, so a program loads a (C, BLOCK) tile of C coalesced rows; there
  is no class-major transpose (the TPU's ``pallas_kernels.py:72``). The
  logits must be NCHW-contiguous, as the UNet's output convolution gives
  them.
* The ragged edge is masked in the kernel; no -1 label padding and no
  padded-site correction of P (those exist only for the TPU's 8192-site
  grid, ``pallas_kernels.py:76-81,111-114``).
* Logits (f32/bf16) and labels (int32/uint8) are cast in registers; the
  f32 contract of ``train/methods/base.py:118-122`` holds inside the kernel
  without a materialised f32 copy.
* The reduction is deterministic, with no atomics: stage 1 writes 1 + 3C
  partials per (batch, tile) program to a scratch buffer, stage 2 (one
  program) sums that buffer in a fixed order and computes the scalar
  epilogue too, so the forward is two launches and no torch ops.
* The backward recomputes the softmax per site from the logits and the 3C
  saved sums, and writes the gradient in one read and one write.

On a CPU tensor :func:`fused_ce_dice` computes :func:`ce_dice_plain`; on a
CUDA tensor it launches the kernels or raises. Triton is imported, and the
kernels built, at the first launch; its cache lives in ``build/triton`` at
the repository root.
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

from cvssl_tpu_torch.ops import losses

_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "triton"

# launches of each kernel pair, for a run to show that it went through them
LAUNCHES = {"ce_dice_fwd": 0, "ce_dice_bwd": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ce_dice_plain(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int):
    """The plain PyTorch version: (mean CE, mean Dice) through autograd.
    float64 logits stay float64, so it also serves as the reference."""
    return (losses.cross_entropy(logits, labels),
            losses.dice_loss(logits, labels, num_classes, softmax=True))


# ---------------------------------------------------------------------------
# Triton kernels. ``tl`` is bound at the first launch (``_kernels``); the
# ``tl.constexpr`` annotations stay strings until then (PEP 563), which is
# how Triton reads them.
# ---------------------------------------------------------------------------
tl = None


def _softmax_tile(logits_ptr, labels_ptr, HW, C: tl.constexpr,
                  CP: tl.constexpr, BLOCK: tl.constexpr):
    """Load one (CP, BLOCK) tile: batch item program_id(0), sites
    program_id(1)*BLOCK... (NCHW-contiguous logits, contiguous labels).
    Returns (log p, p, one-hot y, site_ok, cls, cls_ok, offsets into the
    logits)."""
    b = tl.program_id(0).to(tl.int64)
    offs = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    site_ok = offs < HW
    cls = tl.arange(0, CP)
    cls_ok = cls < C
    lab = tl.load(labels_ptr + b * HW + offs, mask=site_ok,
                  other=0).to(tl.int32)
    x_offs = b * C * HW + cls[:, None] * HW + offs[None, :]
    x = tl.load(logits_ptr + x_offs, mask=cls_ok[:, None] & site_ok[None, :],
                other=0.0).to(tl.float32)
    x = tl.where(cls_ok[:, None], x, float("-inf"))
    xm = x - tl.max(x, axis=0)[None, :]
    e = tl.exp(xm)
    s = tl.sum(e, axis=0)
    p = e / s[None, :]
    y = ((cls[:, None] == lab[None, :]) & site_ok[None, :]).to(tl.float32)
    logp = xm - tl.log(s)[None, :]
    return logp, p, y, site_ok, cls, cls_ok, x_offs


def _fwd_partials_kernel(logits_ptr, labels_ptr, part_ptr, HW,
                         C: tl.constexpr, CP: tl.constexpr,
                         BLOCK: tl.constexpr):
    """Stage 1: one program per (batch item, tile of BLOCK sites) writes the
    row [CE, I_0..I_C-1, P_0..P_C-1, L_0..L_C-1] of its tile's sums."""
    logp, p, y, site_ok, cls, cls_ok, _ = _softmax_tile(
        logits_ptr, labels_ptr, HW, C, CP, BLOCK)
    valid = site_ok.to(tl.float32)
    ce = -tl.sum(tl.sum(tl.where(y > 0, logp, 0.0), axis=1), axis=0)
    inter = tl.sum(p * y, axis=1)
    psq = tl.sum(p * p * valid[None, :], axis=1)
    cnt = tl.sum(y, axis=1)
    row = part_ptr + (tl.program_id(0) * tl.num_programs(1)
                      + tl.program_id(1)) * (1 + 3 * C)
    tl.store(row, ce)
    tl.store(row + 1 + cls, inter, mask=cls_ok)
    tl.store(row + 1 + C + cls, psq, mask=cls_ok)
    tl.store(row + 1 + 2 * C + cls, cnt, mask=cls_ok)


def _finish_kernel(part_ptr, ce_ptr, dice_ptr, stats_ptr, R, n,
                   C: tl.constexpr, CP: tl.constexpr, RBLOCK: tl.constexpr):
    """Stage 2, one program: sum the R partial rows in a fixed order, then
    the epilogue: ce = CE / n, dice = mean_c 1 - (2I + s) / (P + L + s);
    stats = (I, P, L) for the backward."""
    cls = tl.arange(0, CP)
    cls_ok = cls < C
    acc_ce = tl.zeros((RBLOCK,), tl.float32)
    acc_i = tl.zeros((RBLOCK, CP), tl.float32)
    acc_p = tl.zeros((RBLOCK, CP), tl.float32)
    acc_l = tl.zeros((RBLOCK, CP), tl.float32)
    for r0 in range(0, R, RBLOCK):
        rows = r0 + tl.arange(0, RBLOCK)
        row_ok = rows < R
        base = part_ptr + rows * (1 + 3 * C)
        m2 = row_ok[:, None] & cls_ok[None, :]
        col = base[:, None] + 1 + cls[None, :]
        acc_ce += tl.load(base, mask=row_ok, other=0.0)
        acc_i += tl.load(col, mask=m2, other=0.0)
        acc_p += tl.load(col + C, mask=m2, other=0.0)
        acc_l += tl.load(col + 2 * C, mask=m2, other=0.0)
    inter = tl.sum(acc_i, axis=0)
    psq = tl.sum(acc_p, axis=0)
    cnt = tl.sum(acc_l, axis=0)
    dice_c = 1.0 - (2.0 * inter + 1e-5) / (psq + cnt + 1e-5)
    tl.store(ce_ptr, tl.sum(acc_ce, axis=0) / n)
    tl.store(dice_ptr, tl.sum(tl.where(cls_ok, dice_c, 0.0), axis=0) / C)
    tl.store(stats_ptr + cls, inter, mask=cls_ok)
    tl.store(stats_ptr + C + cls, psq, mask=cls_ok)
    tl.store(stats_ptr + 2 * C + cls, cnt, mask=cls_ok)


def _bwd_kernel(logits_ptr, labels_ptr, stats_ptr, g_ce_ptr, g_dice_ptr,
                grad_ptr, HW, n, C: tl.constexpr,
                CP: tl.constexpr, BLOCK: tl.constexpr):
    """d(g_ce * CE + g_dice * Dice) / d logits for one tile, from the saved
    per-class I, P, L (``stats``, 3C floats); the gradient has the logits'
    layout and dtype."""
    _, p, y, site_ok, cls, cls_ok, x_offs = _softmax_tile(
        logits_ptr, labels_ptr, HW, C, CP, BLOCK)
    inter = tl.load(stats_ptr + cls, mask=cls_ok, other=0.0)
    psq = tl.load(stats_ptr + C + cls, mask=cls_ok, other=0.0)
    cnt = tl.load(stats_ptr + 2 * C + cls, mask=cls_ok, other=0.0)
    g_ce = tl.load(g_ce_ptr).to(tl.float32)
    g_dice = tl.load(g_dice_ptr).to(tl.float32)
    denom = psq + cnt + 1e-5
    ratio = (2.0 * inter + 1e-5) / denom
    gp = (-2.0 * y + 2.0 * p * ratio[:, None]) / denom[:, None]
    gp = gp / C
    dz_dice = p * (gp - tl.sum(gp * p, axis=0)[None, :])
    dz_ce = (p - y) / n
    grad = g_ce * dz_ce + g_dice * dz_dice
    tl.store(grad_ptr + x_offs, grad.to(grad_ptr.dtype.element_ty),
             mask=cls_ok[:, None] & site_ok[None, :])


_JIT_NAMES = ("_softmax_tile", "_fwd_partials_kernel", "_finish_kernel",
              "_bwd_kernel")


def _kernels():
    """Import Triton and wrap the kernels, once per process. The kernels
    call each other by their global names, so the wrapped functions take
    those names' places."""
    global tl
    if tl is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR))
        import triton
        import triton.language

        tl = triton.language
        g = globals()
        for name in _JIT_NAMES:
            g[name] = triton.jit(g[name])
    return _fwd_partials_kernel, _finish_kernel, _bwd_kernel


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _layout(logits: torch.Tensor):
    """(B, C, sites, CP, BLOCK, tiles) of NCHW-contiguous logits."""
    if not logits.is_contiguous():
        raise ValueError(f"logits strides {logits.stride()} are not "
                         "NCHW-contiguous")
    b, c = logits.shape[:2]
    hw = logits[0, 0].numel()
    cp = _next_pow2(c)
    block = max(128, 4096 // cp)
    return b, c, hw, cp, block, -(-hw // block)


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
    if logits.numel() == 0:
        raise ValueError("empty logits")


def _forward_cuda(logits: torch.Tensor, labels: torch.Tensor):
    """Both forward kernels; returns (ce, dice, stats (3, C)) on the card."""
    fwd, finish, _ = _kernels()
    b, c, hw, cp, block, tiles = _layout(logits)
    dev = logits.device
    parts = torch.empty((b * tiles, 1 + 3 * c), dtype=torch.float32,
                        device=dev)
    fwd[(b, tiles)](logits, labels, parts, hw, C=c, CP=cp, BLOCK=block,
                    num_warps=4)
    ce = torch.empty((), dtype=torch.float32, device=dev)
    dice = torch.empty((), dtype=torch.float32, device=dev)
    stats = torch.empty((3, c), dtype=torch.float32, device=dev)
    finish[(1,)](parts, ce, dice, stats, b * tiles, float(b * hw), C=c,
                 CP=cp, RBLOCK=64, num_warps=4)
    LAUNCHES["ce_dice_fwd"] += 1
    return ce, dice, stats


def _backward_cuda(logits, labels, stats, g_ce, g_dice):
    _, _, bwd = _kernels()
    b, c, hw, cp, block, tiles = _layout(logits)
    grad = torch.empty_like(logits)
    bwd[(b, tiles)](logits, labels, stats, g_ce, g_dice, grad, hw,
                    float(b * hw), C=c, CP=cp, BLOCK=block, num_warps=4)
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
        return _backward_cuda(logits, labels, stats, g_ce.contiguous(),
                              g_dice.contiguous()), None


def fused_ce_dice(logits: torch.Tensor, labels: torch.Tensor,
                  num_classes: int):
    """(ce, dice) for logits (B, C, *spatial) and labels (B, *spatial).

    CPU tensors take :func:`ce_dice_plain`; CUDA tensors take the Triton
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
