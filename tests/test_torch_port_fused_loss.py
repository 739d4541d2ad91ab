"""The port's fused CE+Dice (``cvssl_tpu_torch/ops/fused_ce_dice.py``) on
the CPU: its plain version against the Pallas kernel in interpret mode and
the stock losses, and its autograd backward against the closed-form
``_fused_bwd``. The Triton kernels themselves run only on the card
(``chip_smoke.py`` holds them against the plain version there)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.ops import losses as jlosses
from cvssl_tpu.ops.pallas_kernels import _fused_bwd, fused_ce_dice_tpu
from cvssl_tpu_torch.ops import fused_ce_dice as fcd

SHAPES = [(2, 32, 32, 4), (3, 37, 41, 4), (1, 16, 16, 2)]   # NHWC


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    return logits, labels


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_and_stock_losses(shape):
    logits, labels = _inputs(shape)
    c = shape[-1]
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    k_ce, k_dice = fused_ce_dice_tpu(jl, jy, c, interpret=True)
    s_ce = jlosses.cross_entropy(jl, jy)
    s_dice = jlosses.dice_loss(jl, jy, c, softmax=True)
    ce, dice = fcd.ce_dice_plain(_nchw(logits), torch.from_numpy(labels), c)
    for want in (k_ce, s_ce):
        assert float(ce) == pytest.approx(float(want), rel=1e-5)
    for want in (k_dice, s_dice):
        assert float(dice) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_closed_form_vjp(shape):
    """Asymmetric cotangents 0.3 (CE) / 1.7 (Dice), as the pair VJP must
    honour them separately."""
    logits, labels = _inputs(shape, seed=1)
    c = shape[-1]
    want, _ = _fused_bwd(c, (jnp.asarray(logits), jnp.asarray(labels)),
                         (jnp.float32(0.3), jnp.float32(1.7)))
    x = _nchw(logits).requires_grad_(True)
    ce, dice = fcd.fused_ce_dice(x, torch.from_numpy(labels), c)
    (0.3 * ce + 1.7 * dice).backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               np.moveaxis(np.asarray(want), -1, 1),
                               rtol=1e-4, atol=1e-9)


def test_uint8_labels_and_cpu_path_launches_nothing():
    logits, labels = _inputs((2, 9, 7, 4), seed=2)
    fcd.reset_launches()
    a = fcd.fused_ce_dice(_nchw(logits), torch.from_numpy(labels), 4)
    b = fcd.fused_ce_dice(_nchw(logits),
                          torch.from_numpy(labels.astype(np.uint8)), 4)
    assert [float(v) for v in a] == [float(v) for v in b]
    assert fcd.LAUNCHES == {"ce_dice_fwd": 0, "ce_dice_bwd": 0}


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    def boom(*_):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(fcd, "ce_dice_plain", boom)
    logits = torch.empty((1, 4, 8, 8), device="meta")
    labels = torch.empty((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        fcd.fused_ce_dice(logits, labels, 4)
    with pytest.raises(ValueError, match="classes"):
        fcd.fused_ce_dice(torch.zeros(1, 3, 4, 4), torch.zeros(1, 4, 4), 4)


def test_kernel_layout_takes_nchw_contiguous_logits_only():
    """The launch geometry the kernels get: (B, C, sites, CP, BLOCK,
    tiles); any other layout raises."""
    x = torch.empty(2, 4, 5, 6)
    assert fcd._layout(x) == (2, 4, 30, 4, 1024, 1)
    assert fcd._layout(torch.empty(3, 3, 37, 41)) == (3, 3, 1517, 4, 1024, 2)
    for other in (x.to(memory_format=torch.channels_last), x.transpose(2, 3)):
        with pytest.raises(ValueError, match="NCHW-contiguous"):
            fcd._layout(other)
