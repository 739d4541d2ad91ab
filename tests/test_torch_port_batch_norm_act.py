"""The port's train-mode BatchNorm with the LeakyReLU fused
(``cvssl_tpu_torch/ops/batch_norm_act.py``) on the CPU: its plain version
against a float64 BatchNorm + LeakyReLU and flax's running-statistics rule;
the modules' dispatch (train, eval, split calls; ``ConvBlock``'s fused
activation and unchanged ``state_dict``); the CUDA wrapper's input checks,
launch geometry, ``ctypes`` declarations and autograd wiring, the two
launches replaced by torch code of the kernels' formulas. The CUDA kernels
themselves run only on the card (``chip_smoke.py`` phase 17 holds them
against the plain version there)."""
import math
import re

import pytest
import torch
import torch.nn.functional as F

from cvssl_tpu_torch.models import unet, unet3d
from cvssl_tpu_torch.ops import _cuda_build
from cvssl_tpu_torch.ops import batch_norm_act as bna
from cvssl_tpu_torch.parallel import mesh as pmesh

SLOPES = [0.01, None]
SHAPES = [(4, 3, 5, 6), (2, 3, 4, 5, 3)]   # 4D and 5D, ragged sides
H100_SMS = 132
# config 2's 18 BatchNorm layers: (channels, side) of each ConvBlock, twice
UNET_LEVELS = [(16, 256), (32, 128), (64, 64), (128, 32), (256, 16),
               (128, 32), (64, 64), (32, 128), (16, 256)]


def _inputs(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (1.5 * torch.randn(shape, generator=g) + 0.7).to(dtype)
    w = (1.0 + 0.3 * torch.randn(c, generator=g)).to(dtype)
    b = (0.2 * torch.randn(c, generator=g)).to(dtype)
    return x, w, b


def _reference(x, w, b, eps, slope):
    """BatchNorm + LeakyReLU written out in x's dtype."""
    dims = [0] + list(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mean = x.mean(dims, keepdim=True)
    var = ((x - mean) ** 2).mean(dims, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps) * w.view(shape) + b.view(shape)
    return y if slope is None else torch.where(y > 0, y, slope * y)


@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_float64_batch_norm_and_leaky_relu(shape, slope):
    x, w, b = _inputs(shape, seed=1)
    cot = torch.randn(shape, generator=torch.Generator().manual_seed(2))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    c = shape[1]
    y = bna.batch_norm_act_plain(*leaves, torch.zeros(c), torch.ones(c),
                                 0.1, 1e-5, slope)
    (y * cot).sum().backward()
    ref = [t.double().requires_grad_(True) for t in (x, w, b)]
    y_ref = _reference(*ref, 1e-5, slope)
    (y_ref * cot.double()).sum().backward()
    torch.testing.assert_close(y.double(), y_ref.detach(), rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad.double(), want.grad, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("momentum", [0.1, 0.01])
def test_plain_running_statistics_follow_flax_rule(momentum):
    """r = (1 - m) r + m * batch, with the BIASED batch variance."""
    shape = (3, 4, 5, 7)
    x, w, b = _inputs(shape, seed=3)
    rm = torch.linspace(-1.0, 1.0, 4)
    rv = torch.linspace(0.5, 2.0, 4)
    want_m = (1 - momentum) * rm.double() + momentum * x.double().mean(
        (0, 2, 3))
    want_v = (1 - momentum) * rv.double() + momentum * x.double().var(
        (0, 2, 3), unbiased=False)
    bna.batch_norm_act_plain(x, w, b, rm, rv, momentum, 1e-5, 0.01)
    torch.testing.assert_close(rm.double(), want_m, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(rv.double(), want_v, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("momentum,eps", [(0.1, 1e-5), (0.01, 1e-3)])
def test_module_train_forward_is_the_plain_version_bit_for_bit(momentum,
                                                                eps):
    """On the CPU the module runs the plain version, as before: the same
    bits as ``F.batch_norm`` on scratch buffers, and the same running
    buffers; LAUNCHES stays 0."""
    bna.reset_launches()
    x, _, _ = _inputs((4, 6, 9, 9), seed=4)
    bn = unet.BatchNorm2d(6, eps=eps, momentum=momentum).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.2, 0.2)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    want = bna.batch_norm_act_plain(x, bn.weight, bn.bias, rm, rv, momentum,
                                    eps)
    got = bn(x)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, rm) and torch.equal(bn.running_var,
                                                            rv)
    assert bna.LAUNCHES == {"bn_act_fwd": 0, "bn_act_bwd": 0}


def _old_conv_block(block, x):
    """ConvBlock's forward before the fusion: every module in turn."""
    c = block.conv_conv
    x = c[2](c[1](c[0](x)))
    x = c[3](x, None)
    return c[6](c[5](c[4](x)))


@pytest.mark.parametrize("train", [True, False])
def test_conv_block_fused_forward_equals_the_module_sequence(train):
    torch.manual_seed(5)
    block = unet.ConvBlock(3, 8, 0.0).train(train)
    twin = unet.ConvBlock(3, 8, 0.0).train(train)
    twin.load_state_dict(block.state_dict())
    x = torch.randn(2, 3, 12, 12)
    got, want = block(x), _old_conv_block(twin, x)
    assert torch.equal(got, want)
    got.square().sum().backward()
    want.square().sum().backward()
    for (name, p), q in zip(block.named_parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for k, v in block.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k


def test_conv_block_state_dict_keys_unchanged():
    block = unet.ConvBlock(3, 8, 0.1)
    assert len(block.conv_conv) == 7
    stats = ("weight", "bias", "running_mean", "running_var",
             "num_batches_tracked")
    want = (["conv_conv.0.weight", "conv_conv.0.bias"]
            + [f"conv_conv.1.{k}" for k in stats]
            + ["conv_conv.4.weight", "conv_conv.4.bias"]
            + [f"conv_conv.5.{k}" for k in stats])
    assert list(block.state_dict()) == want
    assert isinstance(block.conv_conv[2], torch.nn.LeakyReLU)
    assert isinstance(block.conv_conv[6], torch.nn.LeakyReLU)


def test_conv_block_fuses_its_slope_and_a_lone_norm_takes_the_identity(
        monkeypatch):
    seen = []

    def spy(x, weight, bias, rm, rv, momentum, eps, slope=None):
        seen.append(slope)
        return bna.batch_norm_act_plain(x, weight, bias, rm, rv, momentum,
                                        eps, slope)

    monkeypatch.setattr(unet, "batch_norm_act", spy)
    block = unet.ConvBlock(2, 4, 0.0).train()
    block.conv_conv[2].negative_slope = 0.2
    block(torch.randn(2, 2, 6, 6))
    assert seen == [0.2, 0.01]
    seen.clear()
    unet.BatchNorm2d(3).train()(torch.randn(2, 3, 4, 4))
    unet3d.BatchNorm3d(3).train()(torch.randn(2, 3, 4, 4, 4))
    assert seen == [None, None]


def _boom(*_, **__):
    raise AssertionError("the train-mode kernels' path was taken")


@pytest.mark.parametrize("slope", SLOPES)
def test_eval_mode_takes_the_running_statistics(monkeypatch, slope):
    monkeypatch.setattr(unet, "batch_norm_act", _boom)
    bn = unet.BatchNorm2d(3).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn.running_var.copy_(torch.tensor([1.5, 0.5, 2.0]))
    x = torch.randn(2, 3, 5, 5)
    y = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                     False, 0.0, bn.eps)
    want = y if slope is None else F.leaky_relu(y, slope)
    assert torch.equal(bn.forward_act(x, slope), want)


@pytest.mark.parametrize("slope", SLOPES)
def test_split_call_takes_the_global_batch_norm(monkeypatch, slope):
    monkeypatch.setattr(unet, "batch_norm_act", _boom)

    class Split:
        mesh = object()

    calls = []

    def global_bn(bn, x, mesh):
        calls.append(mesh)
        return x * 2.0

    monkeypatch.setattr(pmesh, "current_split", lambda: Split)
    monkeypatch.setattr(unet, "_global_batch_norm", global_bn)
    x = torch.randn(2, 3, 4, 4)
    got = unet.BatchNorm2d(3).train().forward_act(x, slope)
    want = x * 2.0 if slope is None else F.leaky_relu(x * 2.0, slope)
    assert calls == [Split.mesh] and torch.equal(got, want)


def test_unet_train_step_on_the_cpu_launches_nothing():
    bna.reset_launches()
    torch.manual_seed(6)
    net = unet.UNet(1, 4, features=(4, 8, 8, 8, 8)).train()
    net(torch.randn(2, 1, 32, 32)).square().mean().backward()
    assert bna.LAUNCHES == {"bn_act_fwd": 0, "bn_act_bwd": 0}


def _good(shape=(2, 3, 4, 4), dtype=torch.float32):
    c = shape[1]
    return (torch.zeros(shape, dtype=dtype), torch.ones(c), torch.zeros(c),
            torch.zeros(c), torch.ones(c))


@pytest.mark.parametrize("bad", ["f16", "f64", "channels_last", "transposed",
                                 "one_value", "no_channels", "running_f64",
                                 "weight_shape", "running_strided"])
def test_cuda_inputs_checked_before_launch(bad):
    x, w, b, rm, rv = _good()
    if bad == "f16":
        x = x.half()
    elif bad == "f64":
        x = x.double()
    elif bad == "channels_last":
        x = torch.zeros(2, 3, 4, 5).to(memory_format=torch.channels_last)
    elif bad == "transposed":
        x = x.transpose(2, 3)[:, :, :3]
    elif bad == "one_value":
        x, w, b, rm, rv = _good((1, 3, 1, 1))
    elif bad == "no_channels":
        x = torch.zeros(5)
    elif bad == "running_f64":
        rv = rv.double()
    elif bad == "weight_shape":
        w = torch.ones(4)
    elif bad == "running_strided":
        rm = torch.zeros(6)[::2]
    with pytest.raises((TypeError, ValueError)):
        bna.check_inputs(x, w, b, rm, rv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_inputs_accepted(dtype):
    bna.check_inputs(*_good(dtype=dtype))
    x, _, _, rm, rv = _good((2, 3, 4, 4, 4), dtype)
    bna.check_inputs(x, None, None, rm, rv)


def test_non_cpu_tensor_never_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(bna, "batch_norm_act_plain", _boom)
    x = torch.empty((2, 3, 4, 4), device="meta")
    c = [torch.empty(3, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="device"):
        bna.batch_norm_act(x, *c, 0.1, 1e-5, 0.01)


def _packs(shape):
    return shape[0] * math.prod(shape[2:])


@pytest.mark.parametrize("batch", [24, 12])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_every_unet_layer_fills_the_card(batch, dtype):
    """Config 2's 18 layer shapes at the student's and the teacher's batch:
    the 16-byte path, at least one block an SM, no more blocks a channel
    than packs over threads (rounded up), no block empty, the packs
    covered once."""
    width = 16 // torch.empty(0, dtype=dtype).element_size()
    for c, side in UNET_LEVELS:
        x = torch.empty(batch, c, side, side, dtype=dtype)
        geo = bna._geometry(x, H100_SMS)
        packs = batch * side * side // width
        assert geo.vector and geo.vec == width
        assert (geo.n, geo.c, geo.l) == (batch, c, side * side)
        assert c * geo.splits >= H100_SMS, (c, side)
        assert geo.splits <= -(-packs // bna.THREADS)
        assert (geo.splits - 1) * geo.per < packs <= geo.splits * geo.per
        assert c * geo.splits <= 2 * bna.WAVES * bna.BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("shape", [(2, 3, 5, 6), (24, 16, 256, 256),
                                   (2, 16, 96, 96, 96), (8, 5, 7)])
def test_vector_path_needs_aligned_planes(shape, offset):
    n = math.prod(shape)
    buf = torch.empty(n + 1, dtype=torch.bfloat16)
    x = (buf[1:] if offset else buf[:n]).view(shape)
    geo = bna._geometry(x, H100_SMS)
    l = math.prod(shape[2:])
    assert geo.vector == (l % 8 == 0 and not offset)
    assert geo.vec == (8 if geo.vector else 1)
    assert geo.splits * geo.per >= shape[0] * l // geo.vec


def _stand_in_forward(seen):
    def forward(x, weight, bias, rm, rv, momentum, eps, slope):
        """The forward kernels' formulas in x's dtype (float64 here)."""
        seen["slope"] = slope
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = x.mean(dims)
        var = ((x - mean.view(shape)) ** 2).mean(dims)
        invstd = 1.0 / torch.sqrt(var + eps)
        rm.mul_(1 - momentum).add_(momentum * mean.to(rm.dtype))
        rv.mul_(1 - momentum).add_(momentum * var.to(rv.dtype))
        a = invstd * (1.0 if weight is None else weight)
        z = (x - mean.view(shape)) * a.view(shape) + (
            0.0 if bias is None else bias.view(shape))
        y = torch.where(z > 0, z, z * slope)
        return y, torch.cat([mean, var, invstd])
    return forward


def _stand_in_backward(seen):
    def backward(x, dy, weight, bias, stats, slope):
        """The backward kernels' formulas: db = sum g, dw = invstd sum g
        (x - mean), dx = a (g - db / M - (x - mean) invstd dw / M)."""
        assert dy.dtype == x.dtype and dy.is_contiguous()
        seen["backward"] = True
        c = x.shape[1]
        dims = [0] + list(range(2, x.ndim))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean, _, invstd = stats.view(3, c)
        a = invstd * (1.0 if weight is None else weight)
        d = x - mean.view(shape)
        z = d * a.view(shape) + (0.0 if bias is None else bias.view(shape))
        g = torch.where(z > 0, dy, dy * slope)
        db = g.sum(dims)
        dw = invstd * (g * d).sum(dims)
        m = x.numel() // c
        dx = a.view(shape) * (g - (db / m).view(shape)
                              - d * (invstd * dw / m).view(shape))
        return dx, torch.cat([db, dw])
    return backward


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("slope", SLOPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_autograd_function_with_stand_in_launches(monkeypatch, shape, slope,
                                                  affine):
    """The card path's autograd wiring and the kernels' closed-form
    backward, on the CPU in float64: the two launches replaced by torch
    code of their formulas, against autograd through the plain version."""
    seen = {}
    monkeypatch.setattr(bna, "_forward_cuda", _stand_in_forward(seen))
    monkeypatch.setattr(bna, "_backward_cuda", _stand_in_backward(seen))
    x, w, b = (t.double() for t in _inputs(shape, seed=7))
    cot = torch.randn(shape, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(8))
    c = shape[1]
    leaves = [x.clone().requires_grad_(True)] + (
        [w.clone().requires_grad_(True), b.clone().requires_grad_(True)]
        if affine else [None, None])
    rm, rv = torch.zeros(c, dtype=torch.float64), torch.ones(
        c, dtype=torch.float64)
    y = bna._BatchNormAct.apply(*leaves, rm, rv, 0.1, 1e-5,
                                1.0 if slope is None else slope)
    (y * cot).sum().backward()
    ref = [t.clone().requires_grad_(True) if t is not None else None
           for t in (x, w if affine else None, b if affine else None)]
    rm_r, rv_r = torch.zeros_like(rm), torch.ones_like(rv)
    y_r = bna.batch_norm_act_plain(*ref, rm_r, rv_r, 0.1, 1e-5, slope)
    (y_r * cot).sum().backward()
    assert seen == {"slope": 1.0 if slope is None else slope,
                    "backward": True}
    torch.testing.assert_close(y, y_r, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rm, rm_r, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(rv, rv_r, rtol=1e-12, atol=1e-14)
    for got, want in zip(leaves, ref):
        if want is not None:
            torch.testing.assert_close(got.grad, want.grad, rtol=1e-9,
                                       atol=1e-11)


def test_wrapper_constants_match_the_kernels():
    src = _cuda_build.source("batch_norm_act").read_text()
    assert f"constexpr int THREADS = {bna.THREADS};" in src
    # every kernel's name carries the prefix the benchmark's reader counts
    kernels = re.findall(r"^(\w+_kernel)\(", src, re.M)
    assert len(kernels) == 4 and all(k.startswith("bnact_")
                                     for k in kernels)
