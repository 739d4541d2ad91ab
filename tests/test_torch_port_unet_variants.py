"""The port's UNet variants (``unet_cct``, ``unet_ds``, ``unet_urpc``,
``unet_feature``) against their Flax versions with the same weights (CPU,
float32): train-mode forwards with the perturbation draws injected on both
sides, eval-mode forwards, BatchNorm running statistics, parameter counts,
the converter round trip, each perturbation function, and the nearest
upsample of the multi-scale heads."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvssl_tpu.models import factory as jfactory
from cvssl_tpu.models import unet as junet
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_methods import _Draws, _patch_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FEATURES = (4, 8, 16, 32, 64)
B, HW, C = 2, 32, 4
NO_DROPOUT = (0.0,) * 5   # the encoder's dropout bytes are not injected
VARIANTS = ("unet_cct", "unet_ds", "unet_urpc", "unet_feature")
# full-width parameter counts (default features), pinned
FULL_WIDTH = {"unet": 1_813_764, "unet_cct": 3_713_664,
              "unet_ds": 1_821_840, "unet_urpc": 1_821_840,
              "unet_feature": 1_813_764}
# same tolerance as the plain UNet's forward (test_torch_port_unet.py):
# float32 accumulation orders differ; bound 1e-4 of the largest logit
ATOL_OF_MAX = 1e-4


def _flax(net_type, seed=0):
    m = jfactory.net_factory(net_type, 1, C, features=FEATURES,
                             dropout=NO_DROPOUT)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 1)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), v["batch_stats"])
    return m, jax.tree_util.tree_map(np.asarray, v["params"]), stats


def _port(net_type, params, stats):
    t = net_factory(net_type, 1, C, features=FEATURES, dropout=NO_DROPOUT)
    t.load_state_dict(state_dict_from_flax(net_type, params, stats),
                      strict=True)
    return t


def _image(seed=1):
    return np.random.default_rng(seed).normal(
        0.5, 0.25, (B, HW, HW, 1)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _outputs_close(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.moveaxis(np.asarray(w), -1, 1)
        g = g.detach().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=ATOL_OF_MAX * float(np.abs(w).max()))


def _patch_port_draws(mp, draws):
    rng = draws.rng
    mp.setattr(tunet, "_uniform", lambda shape, lo, hi, g, d: draws.take(
        "uniform", rng.uniform(lo, hi, tuple(shape)).astype(np.float32)))
    mp.setattr(tunet, "_keep", lambda shape, p, g, d: draws.take(
        "keep", rng.random(tuple(shape)) < p))


@pytest.mark.parametrize("net_type", VARIANTS)
def test_train_forward_and_running_stats_match_flax(net_type, monkeypatch):
    m, params, stats = _flax(net_type)
    x = _image()
    t = _port(net_type, params, stats).train()
    draws = _Draws(7)
    with monkeypatch.context() as mp:
        _patch_port_draws(mp, draws)
        got = t(_nchw(x), torch.Generator().manual_seed(0))
    perturbed = net_type in ("unet_cct", "unet_urpc")
    assert bool(draws.log) == perturbed

    def apply(v, x):
        draws.cursor = 0
        return m.apply(v, x, train=True, mutable=["batch_stats"],
                       rngs={"dropout": jax.random.PRNGKey(1),
                             "perturb": jax.random.PRNGKey(2)})
    with monkeypatch.context() as mp:
        _patch_jax(mp, draws)
        want, mutated = jax.jit(apply)(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    assert draws.cursor == len(draws.log)
    _outputs_close(got, want)           # unet_feature: (logits, h) both
    new_stats = flax_from_state_dict(net_type, t.state_dict())[1]
    for a, b in zip(jax.tree_util.tree_leaves(mutated["batch_stats"]),
                    jax.tree_util.tree_leaves(new_stats)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("net_type", VARIANTS)
def test_eval_forward_matches_flax(net_type):
    """Eval mode: running statistics, no perturbation (CCT returns four
    unperturbed maps, URPC four heads)."""
    m, params, stats = _flax(net_type, seed=2)
    x = _image(seed=3)
    want = jax.jit(lambda v, x: m.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    t = _port(net_type, params, stats).eval()
    with torch.no_grad():
        got = t(_nchw(x))
    _outputs_close(got, want)
    if net_type == "unet_cct":           # the aux decoders see clean features
        assert not torch.equal(got[0], got[1])


@pytest.mark.parametrize("net_type", VARIANTS)
def test_conversion_round_trips_and_counts_match_flax(net_type):
    _, params, stats = _flax(net_type)
    t = _port(net_type, params, stats)
    p2, s2 = flax_from_state_dict(net_type, t.state_dict())
    for want, got in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    assert sum(p.numel() for p in t.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(params))


@pytest.mark.parametrize("net_type", sorted(FULL_WIDTH))
def test_full_width_parameter_counts_match_flax(net_type):
    model = net_factory(net_type, in_chns=1, class_num=4)
    n = sum(p.numel() for p in model.parameters())
    assert n == FULL_WIDTH[net_type]
    m = jfactory.net_factory(net_type, 1, 4)
    shapes = jax.eval_shape(lambda k: m.init(k, jnp.zeros((1, 32, 32, 1)),
                                             train=False),
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape)) for a in
                    jax.tree_util.tree_leaves(shapes["params"]))


def test_factory_names_match_jax():
    for name in FULL_WIDTH:
        jfactory.net_factory(name, 1, 4)
    # the zoo's ENet is registered too; a name neither package has is not
    net_factory("enet")
    with pytest.raises(ValueError, match="unknown 2D net"):
        net_factory("no_such_net")


@pytest.mark.parametrize("name,kwargs", [
    ("feature_noise", {}), ("feature_dropout", {}), ("dropout_perturb", {}),
    ("dropout_perturb", {"p": 0.5})])
def test_perturbation_matches_jax(name, kwargs, monkeypatch):
    """Each perturbation on injected draws, (B, C, H, W) here and
    (B, H, W, C) in JAX."""
    x = np.random.default_rng(4).normal(size=(3, 5, 8, 6)).astype(
        np.float32)
    draws = _Draws(11)
    with monkeypatch.context() as mp:
        _patch_port_draws(mp, draws)
        got = getattr(tunet, name)(torch.from_numpy(x), None, **kwargs)
    assert len(draws.log) == 1
    with monkeypatch.context() as mp:
        _patch_jax(mp, draws)
        want = getattr(junet, name)(jax.random.PRNGKey(0),
                                    jnp.asarray(np.moveaxis(x, 1, -1)),
                                    **kwargs)
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want),
                                                        -1, 1),
                               rtol=1e-6, atol=1e-6)
    assert not np.array_equal(got.numpy(), x)


def test_perturbation_draws_come_from_the_generator():
    """The same generator state gives the same perturbation; the global
    generator plays no part."""
    x = torch.randn(2, 3, 8, 8)
    for fn in (tunet.feature_noise, tunet.feature_dropout,
               tunet.dropout_perturb):
        a = fn(x, torch.Generator().manual_seed(5))
        torch.manual_seed(123)
        b = fn(x, torch.Generator().manual_seed(5))
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_nearest_upsample_matches_jax_image_resize(factor):
    """``F.interpolate(mode="nearest")`` is ``jax.image.resize(...,
    "nearest")`` at the heads' integer factors."""
    z = np.random.default_rng(factor).normal(
        size=(2, 3, 32 // factor, 32 // factor)).astype(np.float32)
    got = F.interpolate(torch.from_numpy(z), size=(32, 32), mode="nearest")
    want = jax.image.resize(jnp.asarray(np.moveaxis(z, 1, -1)),
                            (2, 32, 32, 3), "nearest")
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(np.asarray(want), -1, 1))
