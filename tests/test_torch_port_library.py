"""The port's library functions that no training path calls, each against
its JAX counterpart on inputs from a seeded numpy generator (CPU): the
loss library's Dice, entropy, consistency, focal, boundary-weighted and
contrastive functions and the MoCo queue, the ramps, the LR schedules,
``mean_teacher_update``, ``compute_sdf``, the feature extractors and
``MetricsWriter.add_image``.

Tolerances: float32 functions rtol 1e-5 (with an absolute floor of 1e-7
for values that cancel near zero); gradients rtol 1e-4 with a floor of
1e-6 of the largest element (the two sides sum in another order);
``compute_sdf`` and the plateau controller's values exactly, the
schedules' within rtol 1e-6 (an ulp of float32); the UNet's features rtol 1e-4 with a floor of 1e-5 of the
largest element, as ``tests/test_torch_port_unet.py`` states for the
forward."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu.ops import ema as jema
from cvssl_tpu.ops import losses as jl
from cvssl_tpu.ops import ramps as jramps
from cvssl_tpu.ops import schedules as jsched
from cvssl_tpu.ops import sdf as jsdf
from cvssl_tpu.utils import features as jfeat
from cvssl_tpu.utils import logging as jlog
from cvssl_tpu_torch.models.convert import leaves, state_dict_from_flax
from cvssl_tpu_torch.models.unet import UNet as TUNet
from cvssl_tpu_torch.ops import ema as tema
from cvssl_tpu_torch.ops import losses as tl
from cvssl_tpu_torch.ops import ramps as tramps
from cvssl_tpu_torch.ops import schedules as tsched
from cvssl_tpu_torch.ops import sdf as tsdf
from cvssl_tpu_torch.utils import features as tfeat
from cvssl_tpu_torch.utils import logging as tlog

RTOL, ATOL = 1e-5, 1e-7
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-6
# the schedules' float32 values: 'step2' (gamma 0.1) at epoch 126 is 1 ulp
# apart (XLA's pow and numpy's), the others agree exactly
SCHED_RTOL = 1e-6
N, H, W, C = 2, 12, 10, 4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _nchw(a):
    """An NHWC numpy array as an NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _logits(seed=0, c=C):
    return _rng(seed).normal(0.0, 2.0, (N, H, W, c)).astype(np.float32)


def _probs(seed=0, c=C):
    e = np.exp(_logits(seed, c).astype(np.float64))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _labels(seed=0, c=C):
    return _rng(seed + 100).integers(0, c, (N, H, W)).astype(np.int32)


# ---------------------------------------------------------------------------
# losses: values
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dice_loss_binary", "dice_loss_binary1"])
def test_binary_dice(name):
    score = _rng(1).uniform(size=(N, H, W)).astype(np.float32)
    target = (_rng(2).uniform(size=(N, H, W)) > 0.5).astype(np.float32)
    want = getattr(jl, name)(jnp.asarray(score), jnp.asarray(target))
    got = getattr(tl, name)(torch.from_numpy(score), torch.from_numpy(target))
    _close(got, want)


# (JAX args, port args, keywords) of each case, over NHWC inputs; maps come back
# NHWC from JAX and NCHW from the port
def _value_cases():
    a, b = _logits(3), _logits(4)
    p = _probs(5)
    return {
        "softmax_dice_loss": ((a, b), (_nchw(a), _nchw(b)), {}),
        "entropy_loss": ((p,), (_nchw(p),), {"num_classes": C}),
        "entropy_loss_map": ((p,), (_nchw(p),), {"num_classes": C}),
        "entropy_minimization": ((p,), (_nchw(p),), {}),
        "entropy_map": ((p,), (_nchw(p),), {}),
        "softmax_kl_loss": ((a, b), (_nchw(a), _nchw(b)), {}),
        "softmax_kl_loss_sigmoid": ((a, b), (_nchw(a), _nchw(b)),
                                    {"sigmoid": True}),
        "symmetric_mse_loss": ((a, b), (_nchw(a), _nchw(b)), {}),
        "compute_kl_loss": ((a, b), (_nchw(a), _nchw(b)), {}),
    }


@pytest.mark.parametrize("case", sorted(_value_cases()))
def test_loss_values(case):
    jargs, targs, kw = _value_cases()[case]
    name = case.replace("_sigmoid", "")
    want = np.asarray(getattr(jl, name)(*map(jnp.asarray, jargs), **kw))
    got = getattr(tl, name)(*targs, **kw).numpy()
    if got.ndim == 4:
        got = np.moveaxis(got, 1, -1)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("alpha,classes", [(None, C), (0.25, 2),
                                           ((0.1, 0.2, 0.3, 0.4), C)])
@pytest.mark.parametrize("size_average", [True, False])
def test_focal_loss(alpha, classes, size_average):
    x, y = _logits(6, classes), _labels(6, classes)
    want = jl.focal_loss(jnp.asarray(x), jnp.asarray(y), gamma=2.0,
                         alpha=alpha, size_average=size_average)
    got = tl.focal_loss(_nchw(x), torch.from_numpy(y), gamma=2.0,
                        alpha=alpha, size_average=size_average)
    _close(got, want)


def _masks(seed):
    """(pred, mask) NHWC, one channel, at 32 x 32: a disc mask, so the
    boundary weights vary, and predictions in (0, 1)."""
    yy, xx = np.mgrid[:32, :32]
    r = _rng(seed)
    mask = np.stack([((yy - r.integers(8, 24)) ** 2
                      + (xx - r.integers(8, 24)) ** 2 < 60)
                     for _ in range(N)]).astype(np.float32)[..., None]
    pred = r.uniform(0.01, 0.99, mask.shape).astype(np.float32)
    return pred, mask


def test_weighted_losses():
    p1, m1 = _masks(7)
    p2, m2 = _masks(8)
    j = dict(zip("abcd", map(jnp.asarray, (p1, p2, m1, m2))))
    t = dict(zip("abcd", map(_nchw, (p1, p2, m1, m2))))
    _close(tl.weighted_loss(t["a"], t["c"]), jl.weighted_loss(j["a"], j["c"]))
    _close(tl.loss_sup(t["a"], t["b"], t["c"], t["d"]),
           jl.loss_sup(j["a"], j["b"], j["c"], j["d"]))
    pa = t["a"].clone().requires_grad_(True)
    diff = tl.loss_diff(pa, t["b"])
    assert not diff.requires_grad
    _close(diff, jl.loss_diff(j["a"], j["b"]))


def test_info_nce_loss():
    f1 = _rng(9).normal(size=(8, 16)).astype(np.float32)
    f2 = _rng(10).normal(size=(8, 16)).astype(np.float32)
    _close(tl.info_nce_loss(torch.from_numpy(f1), torch.from_numpy(f2)),
           jl.info_nce_loss(jnp.asarray(f1), jnp.asarray(f2)))


def test_moco_queue_over_three_updates_that_wrap():
    """Capacity 10, batches of 4: the first loss takes the batch's keys
    (queue empty), then the queue's; the third update wraps the ring."""
    jq = jl.moco_queue_init(10, 12)
    tq = tl.moco_queue_init(10, 12, device="cpu")
    for i in range(3):
        q = _rng(20 + i).normal(size=(4, 3, 2, 2)).astype(np.float32)
        k = _rng(30 + i).normal(size=(4, 3, 2, 2)).astype(np.float32)
        jloss, jq = jl.moco_loss(jnp.asarray(q), jnp.asarray(k), jq)
        tloss, tq = tl.moco_loss(torch.from_numpy(q), torch.from_numpy(k),
                                 tq)
        _close(tloss, jloss)
        np.testing.assert_array_equal(tq.keys.numpy(), np.asarray(jq.keys))
        np.testing.assert_array_equal(tq.valid.numpy(), np.asarray(jq.valid))
        assert int(tq.ptr) == int(jq.ptr)
    assert int(tq.ptr) == 2 and bool(tq.valid.all())


# ---------------------------------------------------------------------------
# losses: gradients (what flows, and where it stops)
# ---------------------------------------------------------------------------

def _grad_cases():
    a, b = _logits(11), _logits(12)
    y = _labels(11)
    f1 = _rng(13).normal(size=(8, 16)).astype(np.float32)
    f2 = _rng(14).normal(size=(8, 16)).astype(np.float32)
    return {
        # (JAX f of its first input, port f of its first input, x, layout)
        "softmax_dice_loss": (lambda x: jl.softmax_dice_loss(x, b),
                              lambda x: tl.softmax_dice_loss(x, _nchw(b)),
                              a, "nhwc"),
        "softmax_kl_loss": (lambda x: jl.softmax_kl_loss(x, b),
                            lambda x: tl.softmax_kl_loss(x, _nchw(b)),
                            a, "nhwc"),
        "compute_kl_loss": (lambda x: jl.compute_kl_loss(x, b),
                            lambda x: tl.compute_kl_loss(x, _nchw(b)),
                            a, "nhwc"),
        "entropy_loss": (lambda x: jl.entropy_loss(jax.nn.softmax(x), C),
                         lambda x: tl.entropy_loss(torch.softmax(x, 1), C),
                         a, "nhwc"),
        "focal_loss": (lambda x: jl.focal_loss(x, y),
                       lambda x: tl.focal_loss(x, torch.from_numpy(y)),
                       a, "nhwc"),
        "info_nce_loss": (lambda x: jl.info_nce_loss(x, f2),
                          lambda x: tl.info_nce_loss(x,
                                                     torch.from_numpy(f2)),
                          f1, "flat"),
    }


@pytest.mark.parametrize("case", sorted(_grad_cases()))
def test_loss_gradients(case):
    jf, tf, x, layout = _grad_cases()[case]
    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    tx = (_nchw(x) if layout == "nhwc" else torch.from_numpy(x)) \
        .requires_grad_(True)
    tf(tx).backward()
    got = tx.grad.numpy()
    if layout == "nhwc":
        got = np.moveaxis(got, 1, -1)
    _close(got, want, rtol=GRAD_RTOL,
           atol=GRAD_ATOL_OF_MAX * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# ramps, schedules, EMA
# ---------------------------------------------------------------------------

def test_cosine_rampdown():
    for current in (0, 1, 7, 50, 99, 100):
        _close(tramps.cosine_rampdown(current, 100),
               jramps.cosine_rampdown(current, 100))


@pytest.mark.parametrize("ramp", ["sigmoid", "linear", "temporal"])
def test_consistency_weight_ramps(ramp):
    for step in (0, 149, 150, 3000, 15000, 29999, 40000):
        _close(tramps.consistency_weight(step, 0.1, 200.0, ramp),
               jramps.consistency_weight(step, 0.1, 200.0, ramp))


def test_consistency_weight_unknown_ramp():
    with pytest.raises(ValueError, match="unknown ramp"):
        tramps.consistency_weight(10, ramp="cosine")


SCHEDULES = {
    "two_phase_lr": (lambda m: m.two_phase_lr(0.01, 1000), range(0, 1001,
                                                                  50)),
    "lambda_linear_lr": (lambda m: m.lambda_linear_lr(0.02, 100, 100),
                         range(0, 210, 7)),
    "step_lr": (lambda m: m.step_lr(0.01, 30), range(0, 200, 9)),
    "step2_lr": (lambda m: m.step_lr(0.01, 30, gamma=0.1), range(0, 200, 9)),
    "step_warmstart_lr": (lambda m: m.step_warmstart_lr(0.01),
                          range(0, 260, 3)),
    "step_warmstart2_lr": (lambda m: m.step_warmstart_lr(0.01, variant=2),
                           range(0, 260, 3)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules(name):
    make, steps = SCHEDULES[name]
    js, ts = make(jsched), make(tsched)
    for t in steps:
        got = ts(t)
        assert isinstance(got, float)
        _close(got, js(t), rtol=SCHED_RTOL, atol=0.0)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_reduce_lr_on_plateau(mode):
    metrics = [1.0, 0.9, 0.95, 0.93, 0.91, 0.92, 0.9, 0.89, 0.5, 0.6, 0.55,
               0.52, 0.51, 0.58, 0.6, 0.57, 0.56, 0.7]
    j = jsched.ReduceLROnPlateau(patience=2, mode=mode)
    t = tsched.ReduceLROnPlateau(patience=2, mode=mode)
    for m in metrics:
        assert t.update(m) == j.update(m)
        assert (t.best, t.bad_epochs) == (j.best, j.bad_epochs)
    assert t.scale < 1.0
    with pytest.raises(ValueError):
        tsched.ReduceLROnPlateau(mode="sideways")


@pytest.mark.parametrize("step", [0, 5, 1000])
def test_mean_teacher_update(step):
    r = _rng(40)
    ema = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    new = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    want = jema.mean_teacher_update([jnp.asarray(a) for a in ema],
                                    [jnp.asarray(a) for a in new], step)
    got = [torch.from_numpy(a.copy()) for a in ema]
    tema.mean_teacher_update(got, [torch.from_numpy(a) for a in new], step)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# signed distance fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 24, 20), (2, 12, 14, 10)])
def test_compute_sdf_bit_equal(shape):
    r = _rng(50)
    grid = np.indices(shape[1:])
    masks = np.zeros(shape, np.uint8)
    for b in range(1, shape[0]):       # element 0 empty: stays all zero
        centre = [r.integers(3, s - 3) for s in shape[1:]]
        dist = sum((g - c) ** 2 for g, c in zip(grid, centre))
        masks[b] = dist < r.integers(6, 20)
    want = jsdf.compute_sdf(masks, shape)
    got = tsdf.compute_sdf(masks, shape)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and got[1].any()


# ---------------------------------------------------------------------------
# feature extraction
# ---------------------------------------------------------------------------

FEATURES = (4, 8, 16, 32, 64)
FEAT_RTOL, FEAT_ATOL_OF_MAX = 1e-4, 1e-5


def _flax_name(port_module):
    """The Flax submodule path of a port module of the UNet, from
    ``models/convert.py``'s name map: the Flax paths of the port module's
    parameters, cut to the port path's depth (the UNet's blocks sit at
    the same depth on both sides), must agree."""
    depth = len(port_module.split("."))
    paths = {flax[:depth] for port, coll, flax, _ in leaves("unet")
             if coll == "params" and port.startswith(port_module + ".")}
    assert len(paths) == 1, paths
    return "/".join(paths.pop())


@pytest.fixture(scope="module")
def unets():
    jm = JUNet(in_chns=1, num_classes=C, features=FEATURES,
               dropout=(0.0,) * 5)
    x = _rng(60).normal(0.5, 0.25, (2, 32, 32, 1)).astype(np.float32)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    tm = TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5).eval()
    tm.load_state_dict(state_dict_from_flax(
        "unet", jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])))
    return jm, v, tm, x


def _feat_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.moveaxis(got.detach().numpy(), 1, -1), want, rtol=FEAT_RTOL,
        atol=FEAT_ATOL_OF_MAX * float(np.abs(want).max()))


@pytest.mark.parametrize("layer,upscale", [("down2", False),
                                           ("down4", True),
                                           ("up3", True)])
def test_extract_features(unets, layer, upscale):
    jm, v, tm, x = unets
    jpath = _flax_name(f"{'encoder' if 'down' in layer else 'decoder'}."
                       f"{layer}")
    jout, jfeats = jfeat.extract_features(jm, v, jnp.asarray(x),
                                          jpath.rsplit("/", 1)[-1],
                                          upscale=upscale)
    tout, tfeats = tfeat.extract_features(tm, _nchw(x), layer,
                                          upscale=upscale)
    assert [p for p, _ in jfeats] == [jpath]
    assert [_flax_name(p) for p, _ in tfeats] == [jpath]
    _feat_close(tfeats[0][1], jfeats[0][1])
    _feat_close(tout, jout)
    if upscale:
        assert tuple(tfeats[0][1].shape[2:]) == (32, 32)
    assert not tm._forward_hooks and all(
        not m._forward_hooks for m in tm.modules())


def test_extract_layers(unets):
    jm, v, tm, x = unets
    ports = ("encoder.down1", "decoder.up2")
    jpaths = [_flax_name(p) for p in ports]
    _, jfeats = jfeat.extract_layers(jm, v, jnp.asarray(x),
                                     [p.rsplit("/", 1)[-1] for p in jpaths])
    _, tfeats = tfeat.extract_layers(tm, _nchw(x),
                                     [p.rsplit(".", 1)[-1] for p in ports])
    assert [p for p, _ in tfeats] == list(ports)
    want = dict(jfeats)
    assert set(want) == set(jpaths)
    for (port, act), jpath in zip(tfeats, jpaths):
        _feat_close(act, want[jpath])


def test_hooks_removed_when_the_forward_raises(unets):
    _, _, tm, _ = unets
    with pytest.raises(RuntimeError):
        tfeat.extract_features(tm, torch.zeros(1, 3, 32, 32), "down2")
    assert all(not m._forward_hooks for m in tm.modules())


# ---------------------------------------------------------------------------
# MetricsWriter.add_image
# ---------------------------------------------------------------------------

class _Board:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step):
        self.images.append((tag, np.asarray(img), step))


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 3)])
def test_add_image(tmp_path, shape):
    img = _rng(70).uniform(size=shape).astype(np.float32)
    boards = []
    for mod, sub in ((jlog, "jax"), (tlog, "torch")):
        w = mod.MetricsWriter(os.path.join(str(tmp_path), sub))
        if w._tb is not None:
            w._tb.close()
        board = w._tb = _Board()
        w.add_image("train/Image", img, 7)
        w._tb = None
        w.add_image("train/Image", img, 8)      # no backend: a no-op
        w.close()
        boards.append(board.images)
    (jtag, jimg, jstep), = boards[0]
    (ttag, timg, tstep), = boards[1]
    assert (ttag, tstep) == (jtag, jstep) == ("train/Image", 7)
    assert timg.shape == (shape[2] if len(shape) == 3 else 1,) + shape[:2]
    np.testing.assert_array_equal(timg, jimg)
