"""The port's 3D CNN zoo against the JAX package on the CPU: VNet,
VoxResNet, AttentionUNet3D and nnUNet (3D and 2D), through
``models/convert.py``: the forward in eval mode and in train mode (VNet's
channel-dropout keep masks injected) with the BatchNorm statistics that
train mode leaves, the gradients of a random functional of the logits,
the converter's round trip, the registries and the full-width parameter
counts and the transpose conv's kernel flip; nnUNet's forwards are in
``test_torch_port_zoo3d_nnunet.py``, on this file's checks.

Draws are injected as ``test_torch_port_3d_models.py`` does: the port's
forward runs first with each keep mask of ``unet._keep`` replaced by numpy
values and recorded, then JAX's replays them through a patched
``jax.random.bernoulli``, in its NDHWC layout."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import attention_unet as jatt
from cvssl_tpu.models import factory as jfactory
from cvssl_tpu.models import nnunet as jnnunet
from cvssl_tpu.models import vnet as jvnet
from cvssl_tpu.models import voxresnet as jvox
from cvssl_tpu_torch.models import attention_unet as tatt
from cvssl_tpu_torch.models import net_factory, net_factory_3d
from cvssl_tpu_torch.models import nnunet as tnnunet
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models import vnet as tvnet
from cvssl_tpu_torch.models import voxresnet as tvox
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            flax_kernel, state_dict_from_flax,
                                            torch_kernel)

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_3d_models import Draws3D  # noqa: E402
from test_torch_port_methods import _patch_jax, _patch_port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, C = 2, 2
NN2D = dict(base_features=8, max_features=64, pool_kernels=((2, 2),) * 5,
            conv_kernels=((3, 3),) * 6)
# name -> (JAX module, port module, registry name, input NDHWC / NHWC)
NETS = {
    "vnet": (lambda: jvnet.VNet(num_classes=C, n_filters=8),
             lambda: tvnet.VNet(1, C, n_filters=8), "vnet",
             (B, 32, 32, 32, 1)),
    "voxresnet": (lambda: jvox.VoxResNet(num_classes=C, feature_chns=16),
                  lambda: tvox.VoxResNet(1, C, feature_chns=16),
                  "voxresnet", (B, 16, 16, 16, 1)),
    "attention_unet": (lambda: jatt.AttentionUNet3D(num_classes=C,
                                                    feature_scale=8),
                       lambda: tatt.AttentionUNet3D(1, C, feature_scale=8),
                       "attention_unet", (B, 16, 32, 16, 1)),
    "nnUNet_3d": (lambda: jnnunet.GenericUNet3D(num_classes=C,
                                                max_features=64),
                  lambda: tnnunet.GenericUNet3D(1, C, max_features=64),
                  "nnUNet", (B, 4, 64, 64, 1)),
    "nnUNet_2d": (lambda: jnnunet.GenericUNet(num_classes=4, **NN2D),
                  lambda: tnnunet.GenericUNet(1, 4, **NN2D), "nnUNet",
                  (B, 64, 64, 1)),
}
TOL = dict(rtol=1e-4, atol=1e-4)


def _nc(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _init(jm, x):
    v = jax.jit(lambda k, d, x: jm.init({"params": k, "dropout": d}, x,
                                        train=False))(
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    return v["params"], v.get("batch_stats", {})


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def zoo_pair(name):
    """Each net in both packages from JAX's initial weights (running
    statistics moved off (0, 1)): the eval forward in float32; the train
    forward and its gradients in float64 on both sides (JAX under
    ``jax.enable_x64``: Flax's float32 BatchNorm takes the variance as
    E[x^2] - E[x]^2 and drifts ~1e-4 from float64 through VNet's 18 norms,
    where torch's drifts ~3e-5), and the port's float32 train forward."""
    jf, tf, reg, shape = NETS[name]
    jm, tm = jf(), tf()
    x = np.random.default_rng(1).normal(0.5, 0.25, shape).astype(np.float32)
    params, stats = _init(jm, x)
    # norm scales and biases off their (1, 0) start: a one-site
    # InstanceNorm (nnUNet's bottleneck) gives its bias, and LeakyReLU's
    # slope at exactly 0 differs (1 in JAX, 0.01 in torch)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        if any("Norm" in str(k) or "_bn" in str(k) for k in path) else v,
        params)
    if stats:
        rng = np.random.default_rng(5)
        stats = jax.tree_util.tree_map(
            lambda v: v + np.abs(rng.normal(0, 0.2, v.shape)).astype(
                np.float32), stats)
    sd = state_dict_from_flax(reg, params, stats)
    tm.load_state_dict(sd, strict=True)
    t64 = tf().double()
    t64.load_state_dict(sd, strict=True)
    w = np.random.default_rng(9).normal(size=shape[:-1] + (
        4 if name == "nnUNet_2d" else C,))

    with torch.no_grad():
        got_eval = tm.eval()(_nc(x))
    variables = {"params": params, "batch_stats": stats} if stats else {
        "params": params}
    want_eval = jm.apply(variables, jnp.asarray(x), train=False)

    draws = Draws3D(3)
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    try:
        t64.train()
        got = t64(_nc(x.astype(np.float64)))
        (got * _nc(w)).sum().backward()
    finally:
        mp.undo()
    keeps = iter([torch.from_numpy(v) for _, v in draws.log])
    mp = pytest.MonkeyPatch()
    mp.setattr(tunet, "_keep", lambda shape, p, g, d: next(keeps))
    try:
        with torch.no_grad():
            got32 = tm.train()(_nc(x))
    finally:
        mp.undo()

    def jloss(p, v, xx):
        out, upd = jm.apply({**v, "params": p}, xx, train=True,
                            mutable=["batch_stats"],
                            rngs={"dropout": jax.random.PRNGKey(2)})
        return jnp.sum(out * w), (out, upd.get("batch_stats", {}))
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    try:
        draws.cursor = 0
        with jax.enable_x64(True):
            (_, (want, new_stats)), grads = jax.jit(jax.value_and_grad(
                jloss, has_aux=True))(_f64(params), _f64(variables),
                                      x.astype(np.float64))
            want, new_stats, grads = (jax.tree_util.tree_map(
                np.asarray, t) for t in (want, new_stats, grads))
    finally:
        mp.undo()
    assert draws.cursor == len(draws.log)
    tgrads = flax_from_state_dict(reg, {
        **{k: torch.zeros_like(b) for k, b in t64.named_buffers()},
        **{k: p.grad for k, p in t64.named_parameters()}})[0]
    return dict(name=name, reg=reg, params=params, stats=stats, tm=tm,
                t64=t64, eval=(got_eval, want_eval), train=(got, want),
                train32=(got32, want), new_stats=new_stats,
                grads=(tgrads, grads), draws=draws)


def check_forward(zoo):
    """Float32, NC-contiguous (kernel #1 takes the logits as they are):
    eval mode (running statistics) against JAX's float32 within 1e-4 abs /
    1e-4 rel; train mode (batch statistics, VNet's dropout) against JAX's
    float64 within 1e-4 rel and 1e-4 of the largest logit (torch's
    single-threaded CPU convs drift up to 6.5e-5 of it from float64
    through VNet's train-mode norms). Float64 train mode against JAX's
    float64 within 1e-5 of the largest logit (VoxResNet's: JAX builds its
    align-corners resize weights in float32)."""
    got, want = zoo["eval"]
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **TOL)
    got, want = zoo["train32"]
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    got, want = zoo["train"]
    np.testing.assert_allclose(_nhwc(got), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def check_draws_and_stats(zoo):
    """VNet draws one keep mask per (sample, channel) at the bottleneck and
    before the head; the other nets draw nothing. The BatchNorm statistics
    after the train-mode forward equal JAX's (momentum 0.9 in Flax's terms,
    the biased batch variance) within 1e-6 in float64 (AttentionUNet3D's
    InstanceNorms compute in float32 in both packages)."""
    kinds = [(k, v.shape) for k, v in zoo["draws"].log]
    if zoo["name"] == "vnet":
        assert kinds == [("keep", (B, 128, 1, 1, 1)),
                         ("keep", (B, 8, 1, 1, 1))]
    else:
        assert kinds == []
    got = flax_from_state_dict(zoo["reg"], zoo["t64"].state_dict())[1]
    if zoo["name"] in ("vnet", "attention_unet"):
        for a, b, s0 in zip(jax.tree_util.tree_leaves(got),
                            jax.tree_util.tree_leaves(zoo["new_stats"]),
                            jax.tree_util.tree_leaves(zoo["stats"])):
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(b).max()))
            assert np.abs(b - s0).max() > 0
    else:
        assert got == {} and zoo["stats"] == {}


def check_gradients(zoo):
    """Float64 gradients of a random functional of the train-mode logits
    at the repo's cross-framework bound (``_assert_tree_close``); for the
    nets without ``unet3d.instance_norm`` (which computes in float32 in
    both packages, so float64 inputs round there) within rtol 1e-4 (and
    1e-7 of the largest gradient, for the biases before a norm, whose
    gradients are 0 up to rounding)."""
    got, want = zoo["grads"]
    _assert_tree_close(got, want)
    if zoo["name"] in ("voxresnet", "attention_unet"):
        return
    scale = max(float(np.abs(b).max())
                for b in jax.tree_util.tree_leaves(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7 * scale)


def check_round_trip(zoo):
    """Flax -> port -> Flax gives the same trees bit for bit, BatchNorm
    statistics included, and every port tensor is covered."""
    sd = state_dict_from_flax(zoo["reg"], zoo["params"], zoo["stats"])
    assert set(sd) == set(zoo["tm"].state_dict())
    params, stats = flax_from_state_dict(zoo["reg"], sd)
    for a, b in ((params, zoo["params"]), (stats, zoo["stats"])):
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(b)
        for u, v in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            assert np.array_equal(u, v)


@pytest.fixture(scope="module", params=["vnet", "voxresnet",
                                        "attention_unet"])
def zoo(request):
    return zoo_pair(request.param)


def test_zoo_forward_matches_flax_eval_and_train(zoo):
    check_forward(zoo)


def test_zoo_draws_and_batch_statistics_match_flax(zoo):
    check_draws_and_stats(zoo)


def test_zoo_gradients_match_flax(zoo):
    check_gradients(zoo)


def test_zoo_convert_round_trip_is_exact(zoo):
    check_round_trip(zoo)


def test_transpose_conv_kernel_is_flipped():
    """A 2x2x2 stride-2 transpose conv: Flax's kernel, converted (the
    spatial flip and the (in, out) transpose), gives torch's output."""
    from flax import linen as nn
    x = np.random.default_rng(0).normal(size=(1, 3, 4, 5, 2)).astype(
        np.float32)
    m = nn.ConvTranspose(3, (2, 2, 2), strides=(2, 2, 2), use_bias=False)
    p = jax.tree_util.tree_map(np.asarray,
                               m.init(jax.random.PRNGKey(0), x)["params"])
    want = np.asarray(m.apply({"params": p}, x))
    t = torch.nn.ConvTranspose3d(2, 3, 2, stride=2, bias=False)
    weight = torch_kernel(p["kernel"], "tkernel")
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(weight))
        got = _nhwc(t(_nc(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(weight, np.transpose(p["kernel"], (3, 4, 0, 1, 2)))
    assert np.array_equal(flax_kernel(weight, "tkernel"), p["kernel"])


# full-width parameter counts (JAX's, counted by jax.eval_shape)
FULL = (("vnet", 3, 2, 9_448_866), ("voxresnet", 3, 2, 1_992_578),
        ("attention_unet", 3, 2, 6_469_328), ("nnUNet", 3, 2, 30_444_656),
        ("nnUNet", 2, 4, 7_388_496))


@pytest.mark.parametrize("name,dim,classes,count", FULL)
def test_zoo_registry_at_full_width(name, dim, classes, count):
    """The registries build each net at its full width with JAX's
    parameter count, and the converter covers every leaf of JAX's tree at
    that width."""
    tm = (net_factory_3d if dim == 3 else net_factory)(name, 1, classes)
    assert sum(p.numel() for p in tm.parameters()) == count
    jm = (jfactory.net_factory_3d if dim == 3 else jfactory.net_factory)(
        name, class_num=classes)
    shape = (1, 4, 64, 64, 1) if name == "nnUNet" and dim == 3 else (
        (1, 32, 32, 1) if dim == 2 else (1, 16, 16, 16, 1))
    v = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros(shape), train=False))
    leaves = jax.tree_util.tree_leaves(v["params"])
    assert sum(int(np.prod(a.shape)) for a in leaves) == count
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), v)
    sd = state_dict_from_flax(name, zeros["params"],
                              zeros.get("batch_stats", {}))
    assert {k: tuple(t.shape) for k, t in sd.items()} == {
        k: tuple(t.shape) for k, t in tm.state_dict().items()}


def test_grid_attention_blocks_2d_and_torr_match_flax():
    """The 2D grid-attention gate and the TORR gate (each normalisation)
    against JAX's, in eval mode, on converted weights."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    g = rng.normal(size=(2, 4, 4, 6)).astype(np.float32)
    cases = [(jatt.GridAttentionBlock2D(4, 3, mode=m),
              tatt.GridAttentionBlock2D(4, 6, 3, mode=m)) for m in tatt.MODES]
    cases += [(jatt.GridAttentionBlock2DTORR(4, 3, sub_sample=2, mode=m),
               tatt.GridAttentionBlock2DTORR(4, 6, 3, sub_sample=2, mode=m))
              for m in tatt.TORR_MODES]
    for jm, tm in cases:
        v = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(0), x, g))
        sd = {}
        for name, p in v["params"].items():
            port = {"W_bn": "W.1", "W": "W.0"}.get(name, name)
            if "kernel" in p:
                sd[f"{port}.weight"] = torch.from_numpy(np.ascontiguousarray(
                    np.transpose(p["kernel"], (3, 2, 0, 1))))
            else:
                sd[f"{port}.weight"] = torch.from_numpy(p["scale"])
            if "bias" in p:
                sd[f"{port}.bias"] = torch.from_numpy(p["bias"])
        for k, s in v["batch_stats"]["W_bn"].items():
            sd[f"W.1.running_{k}"] = torch.from_numpy(s)
        sd["W.1.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        tm.load_state_dict(sd, strict=True)
        want_w, want_att = jm.apply(v, x, g)
        with torch.no_grad():
            got_w, got_att = tm.eval()(_nc(x), _nc(g))
        np.testing.assert_allclose(_nhwc(got_w), np.asarray(want_w), **TOL)
        np.testing.assert_allclose(_nhwc(got_att), np.asarray(want_att),
                                   **TOL)
