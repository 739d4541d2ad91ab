"""The port's fused CE+Dice (``cvssl_tpu_torch/ops/fused_ce_dice.py``) on
the CPU: its plain version against the Pallas kernel in interpret mode and
the stock losses, and its autograd backward against the closed-form
``_fused_bwd``; the CUDA wrapper's launch geometry, input checks and
autograd wiring, and its ``ctypes`` declarations against the C source. The
CUDA kernels themselves run only on the card (``chip_smoke.py`` holds them
against the plain version there)."""
import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.ops import losses as jlosses
from cvssl_tpu.ops.pallas_kernels import _fused_bwd, fused_ce_dice_tpu
from cvssl_tpu_torch.ops import _cuda_build
from cvssl_tpu_torch.ops import batch_norm_act
from cvssl_tpu_torch.ops import conv3x3_p8
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


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4, 5, 6), (3, 4, 37, 41),
                                   (12, 4, 256, 256)])
def test_kernel_layout_takes_nchw_contiguous_logits_only(shape, dtype,
                                                         offset):
    """The launch geometry the kernels get: 16-byte chunks of 4 (f32) or 8
    (bf16) sites; the vector path only where every class plane starts on a
    16-byte boundary (aligned data_ptr, sites % chunk == 0), else every
    site on the scalar loop; any other layout than NCHW-contiguous
    raises."""
    n = math.prod(shape)
    buf = torch.empty(n + 1, dtype=dtype)
    x = (buf[1:] if offset else buf[:n]).view(shape)
    labels = torch.zeros(shape[:1] + shape[2:], dtype=torch.int32)
    geo = fcd._geometry(x, labels)
    hw = shape[2] * shape[3]
    assert (geo.batch, geo.classes, geo.sites) == (shape[0], 4, hw)
    assert geo.vec == (4 if dtype == torch.float32 else 8)
    assert geo.vector == (shape == (12, 4, 256, 256) and not offset)
    assert geo.tail == (0 if geo.vector else hw)
    assert geo.chunks * geo.vec + geo.tail == hw
    for other in (x.to(memory_format=torch.channels_last), x.transpose(2, 3)):
        with pytest.raises(ValueError, match="NCHW-contiguous"):
            fcd._geometry(other, labels)


@pytest.mark.parametrize("label_dtype", [torch.int32, torch.uint8])
def test_unaligned_labels_take_the_scalar_loop(label_dtype):
    x = torch.empty(2, 4, 16, 16, dtype=torch.bfloat16)
    buf = torch.zeros(2 * 256 + 1, dtype=label_dtype)
    assert fcd._geometry(x, buf[:-1].view(2, 16, 16)).vector
    geo = fcd._geometry(x, buf[1:].view(2, 16, 16))
    assert (geo.vector, geo.chunks, geo.tail) == (False, 0, 256)


@pytest.mark.parametrize("bad", ["f16", "int64_labels", "shape", "classes_1",
                                 "classes_17", "strided_labels"])
def test_cuda_inputs_checked_before_launch(bad):
    c = {"classes_1": 1, "classes_17": 17}.get(bad, 4)
    dtype = torch.float16 if bad == "f16" else torch.float32
    logits = torch.zeros(2, c, 8, 8, dtype=dtype)
    labels = torch.zeros(2, 8, 8, dtype=torch.int64 if bad == "int64_labels"
                         else torch.int32)
    if bad == "shape":
        labels = labels[:, :4]
    if bad == "strided_labels":
        labels = labels.transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        fcd._check_cuda_inputs(logits, labels)


def test_autograd_function_with_stand_in_launches(monkeypatch):
    """The card path's autograd wiring on the CPU, the two launches
    replaced by torch code of the same contract: the forward returns views
    of one [ce, dice, I, P, L] buffer; the backward gets the saved stats and
    the two cotangents as float32 scalars."""
    logits, labels = _inputs((2, 9, 7, 4), seed=3)
    y = torch.from_numpy(labels)
    seen = {}

    def forward(lg, lb):
        ce, dice = fcd.ce_dice_plain(lg, lb, 4)
        p = torch.softmax(lg, 1)
        oh = torch.nn.functional.one_hot(lb.long(), 4).permute(0, 3, 1, 2)
        stats = torch.stack([(p * oh).sum((0, 2, 3)),
                             (p * p).sum((0, 2, 3)), oh.sum((0, 2, 3))])
        return fcd._outputs(torch.cat([ce.reshape(1), dice.reshape(1),
                                       stats.reshape(-1)]), 4)

    def backward(lg, lb, stats, g_ce, g_dice):
        seen.update(stats=stats, g=(g_ce, g_dice))
        lg = lg.detach().requires_grad_(True)
        with torch.enable_grad():
            ce, dice = fcd.ce_dice_plain(lg, lb, 4)
            return torch.autograd.grad(g_ce * ce + g_dice * dice, lg)[0]

    monkeypatch.setattr(fcd, "_forward_cuda", forward)
    monkeypatch.setattr(fcd, "_backward_cuda", backward)
    x = _nchw(logits).requires_grad_(True)
    ce, dice = fcd._FusedCEDice.apply(x, y)
    (0.3 * ce + 1.7 * dice).backward()
    ref = _nchw(logits).requires_grad_(True)
    ce_r, dice_r = fcd.ce_dice_plain(ref, y, 4)
    (0.3 * ce_r + 1.7 * dice_r).backward()
    assert ([float(v.detach()) for v in (ce, dice)]
            == [float(v.detach()) for v in (ce_r, dice_r)])
    torch.testing.assert_close(x.grad, ref.grad)
    assert seen["stats"].shape == (3, 4)
    assert float(seen["stats"][2].sum()) == labels.size
    for g, want in zip(seen["g"], (0.3, 1.7)):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert float(g) == pytest.approx(want)


_C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def _c_interface(src: str):
    """{function: (restype, argtypes)} as ctypes would need them, parsed
    from the definitions in the source's ``extern "C"`` block."""
    block = src[src.index('extern "C" {'):]
    found = {}
    for ret, name, params in re.findall(
            r"^([A-Za-z_][\w ]*?\**)\s*(\w+)\(([^)]*)\)\s*\{", block,
            re.M):
        args = []
        for param in params.split(","):
            ctype = param.strip().rsplit(None, 1)[0]
            args.append(ctypes.c_void_p if "*" in ctype
                        else _C_TYPES[ctype.replace("const ", "")])
        restype = (ctypes.c_char_p if ret.strip() == "const char*"
                   else _C_TYPES[ret.strip()])
        found[name] = (restype, args)
    return found


@pytest.mark.parametrize("module", [fcd, conv3x3_p8, batch_norm_act],
                         ids=["fused_ce_dice", "conv3x3_p8",
                              "batch_norm_act"])
def test_ctypes_declarations_match_the_c_interface(module):
    """Each C function's argument count and pointer types against the
    ``argtypes`` the wrapper declares: an undeclared or int-declared
    pointer would be cut to 32 bits on the card, silently."""
    name = module.__name__.rsplit(".", 1)[1]
    want = _c_interface(_cuda_build.source(name).read_text())
    assert set(want) == set(module.SIGNATURES)
    for fn, (restype, argtypes) in module.SIGNATURES.items():
        assert restype is want[fn][0], fn
        assert list(argtypes) == want[fn][1], fn


def test_wrapper_constants_match_the_kernels():
    src = _cuda_build.source("fused_ce_dice").read_text()
    assert f"constexpr int THREADS = {fcd.THREADS};" in src
    cases = sorted(int(c) for c in re.findall(r"CASE\((\d+)\)", src))
    assert cases == list(range(2, fcd.MAX_CLASSES + 1))
