"""The GAN scaffolding and ``SCSEModule`` against the JAX package on the
CPU (``cvssl_tpu_torch/models/gan.py``, ``models/attention.py`` and their
``models/convert.py`` leaves).

JAX's weights come from ``jax.eval_shape`` of its init filled from a numpy
seed (kernels at 1/sqrt(fan-in), biases and running means N(0, 0.1),
scales U(0.8, 1.2), running variances U(0.5, 1.5)) and reach the port
through ``models/convert.py``; the port's ``state_dict`` goes back to the
same Flax trees, bit for bit.

Tolerances: ``gan_loss`` rtol 1e-6 (JAX's inf and nan where a probability
saturates, exactly); float32 forwards within 1e-5 of the largest output;
train mode (dropout off) the outputs, the updated BatchNorm running
statistics and the gradients within 1e-4 of the largest element (sums in
another order, Flax's variance as E[x^2] - E[x]^2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import attention as jatt
from cvssl_tpu.models import gan as jgan
from cvssl_tpu_torch.models import attention as tatt
from cvssl_tpu_torch.models import gan as tgan
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            gan_layout, state_dict_from_flax)

FWD_TOL = 1e-5
TRAIN_TOL = 1e-4
# XLA's CPU compile without its costly optimisations: a quarter of the
# time on these nets, and the same operations
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def filled(jm, x, seed=0, **kw):
    """``jm``'s (params, batch_stats) from the shapes of its init, filled
    from ``seed``."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, **kw),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        fan = max(int(np.prod(a.shape[:-1])), 1)
        return (rng.normal(0, 1, a.shape) / np.sqrt(fan)).astype(np.float32)
    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def _image(shape, seed=1):
    return np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _close(want, got, tol):
    """``want`` (channels last) against the port's ``got`` (channels at 1)
    within ``tol`` of the largest element."""
    a = np.moveaxis(np.asarray(want, np.float64), -1, 1)
    b = got.detach().double().numpy()
    assert a.shape == b.shape
    scale = float(np.abs(a).max())
    assert float(np.abs(a - b).max()) <= tol * scale, (
        float(np.abs(a - b).max()) / scale)


def _same_trees(want, got):
    assert (jax.tree_util.tree_structure(want)
            == jax.tree_util.tree_structure(got))
    for a, c in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert a.shape == c.shape
        np.testing.assert_array_equal(a, c)


# ---------------------------------------------------------------------------
# gan_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lsgan", [True, False])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("saturated", [False, True])
def test_gan_loss_matches_jax(lsgan, real, saturated):
    """LSGAN on logits, vanilla on probabilities; with ``saturated`` the
    probabilities hold exact 0s and 1s, where JAX's float32 clip keeps 1
    (its upper end 1 - 1e-12 rounds to 1): inf for a fake target, nan for
    a real one, and the port gives the same."""
    rng = np.random.default_rng(2)
    pred = (rng.normal(size=(2, 6, 6, 1)) if lsgan
            else rng.uniform(0.01, 0.99, (2, 6, 6, 1))).astype(np.float32)
    if saturated:
        pred.reshape(-1)[:4] = [0.0, 1.0, 0.0, 1.0]
    kw = dict(use_lsgan=lsgan, real_label=0.9, fake_label=0.1) if not \
        saturated else dict(use_lsgan=lsgan)
    want = float(jgan.gan_loss(jnp.asarray(pred), real, **kw))
    got = tgan.gan_loss(_nchw(pred), real, **kw)
    assert got.dtype == torch.float32
    if saturated and not lsgan:
        assert not np.isfinite(want)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# the three nets
# ---------------------------------------------------------------------------

def _resnet(norm, pad, dropout=False):
    return (jgan.ResnetGenerator(2, 8, norm, dropout, n_blocks=2,
                                 padding_type=pad),
            tgan.ResnetGenerator(2, 8, norm, dropout, n_blocks=2,
                                 padding_type=pad, input_nc=3),
            "resnet_generator", (2, 16, 16, 3),
            (2, norm, pad != "zero", dropout))


def _unet(norm, downs=5, side=32, dropout=False):
    return (jgan.UnetGenerator(2, downs, 4, norm, dropout),
            tgan.UnetGenerator(2, downs, 4, norm, dropout, input_nc=3),
            "unet_generator", (2, side, side, 3), None)


def _nlayer(n, norm="batch"):
    return (jgan.NLayerDiscriminator(8, n, norm),
            tgan.NLayerDiscriminator(8, n, norm, input_nc=3),
            "nlayer_discriminator", (2, 32, 32, 3), None)


NETS = {
    **{f"nlayer{n}": (lambda n=n: _nlayer(n)) for n in (1, 2, 3)},
    "nlayer2_instance": lambda: _nlayer(2, "instance"),
    # every padding under BatchNorm (the pads move its indices), every
    # norm under two paddings
    **{f"resnet_{norm}_{pad}": (lambda norm=norm, pad=pad: _resnet(norm, pad))
       for norm, pad in (("batch", "reflect"), ("batch", "replicate"),
                         ("batch", "zero"), ("instance", "reflect"),
                         ("none", "zero"))},
    **{f"unet_{norm}": (lambda norm=norm: _unet(norm))
       for norm in ("batch", "instance", "none")},
}


def _jax_outputs(jm, params, stats, x, cot):
    """JAX's eval output, and in train mode its output, running statistics
    and the gradients of <output, cot>, in one jitted call."""
    def train(params, stats, x):
        y, new = jm.apply({"params": params, "batch_stats": stats}, x,
                          train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, new.get("batch_stats", {}))

    def both(params, stats, x):
        y = jm.apply({"params": params, "batch_stats": stats}, x,
                     train=False)
        (_, (yt, new)), grads = jax.value_and_grad(train, has_aux=True)(
            params, stats, x)
        return y, yt, new, grads
    x = jnp.asarray(x)
    return jax.jit(both).lower(params, stats, x).compile(QUICK)(
        params, stats, x)


@pytest.fixture(scope="module", params=sorted(NETS))
def built(request):
    jm, tm, net_type, shape, layout = NETS[request.param]()
    x = _image(shape)
    params, stats = filled(jm, x, train=False)
    sd = state_dict_from_flax(net_type, params, stats, layout)
    tm.load_state_dict(sd)
    with torch.no_grad():
        y = tm.eval()(_nchw(x))
    cot = _image(y.shape[:1] + y.shape[2:] + y.shape[1:2], seed=3)
    return dict(name=request.param, jm=jm, tm=tm, net_type=net_type, x=x,
                params=params, stats=stats, layout=layout, cot=cot,
                jax=_jax_outputs(jm, params, stats, x, cot))


def test_conversion_round_trips(built):
    """Flax -> the port's ``state_dict`` (every key, loaded strictly) ->
    Flax gives the same trees; the layout read off the ``state_dict`` is
    the one the net was built with."""
    b = built
    sd = b["tm"].state_dict()
    layout = gan_layout(b["net_type"], sd)
    if b["layout"] is not None:
        assert layout == b["layout"]
    params, stats = flax_from_state_dict(b["net_type"], sd)
    _same_trees(b["params"], params)
    _same_trees(b["stats"], stats)
    assert (sum(p.numel() for p in b["tm"].parameters())
            == sum(a.size for a in jax.tree_util.tree_leaves(b["params"])))


def test_eval_forward_matches_jax(built):
    b = built
    with torch.no_grad():
        got = b["tm"].eval()(_nchw(b["x"]))
    _close(b["jax"][0], got, FWD_TOL)


def test_train_step_matches_jax(built):
    """Train mode, no dropout: the output, the running statistics after
    the call and the gradients of <output, cotangent> with respect to
    every parameter."""
    b = built
    _, want, want_stats, want_grads = b["jax"]
    tm = b["tm"]
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()
    tm.zero_grad()
    got = tm(_nchw(b["x"]))
    (got * _nchw(b["cot"])).sum().backward()
    state = tm.state_dict()
    grads = {**state, **{n: p.grad for n, p in tm.named_parameters()}}
    _, got_stats = flax_from_state_dict(b["net_type"], state)
    got_grads, _ = flax_from_state_dict(b["net_type"], grads)
    tm.load_state_dict(saved)
    _close(want, got, TRAIN_TOL)
    leaves = jax.tree_util.tree_leaves
    for w_tree, g_tree in ((want_stats, got_stats),
                           (want_grads, got_grads)):
        big = max((float(np.abs(np.asarray(a)).max())
                   for a in leaves(w_tree)), default=0.0)
        assert len(leaves(w_tree)) == len(leaves(g_tree))
        for a, c in zip(leaves(w_tree), leaves(g_tree)):
            np.testing.assert_allclose(c, np.asarray(a), rtol=0,
                                       atol=TRAIN_TOL * big)
    if b["stats"]:
        assert not np.allclose(leaves(got_stats)[0], leaves(b["stats"])[0])


@pytest.mark.parametrize("net", ["resnet", "unet"])
def test_eval_forward_with_dropout_matches_jax(net):
    """Built with dropout (the U-Net's at 6 downs, 64^2: dropout sits
    below the 8 * ngf level), eval mode draws nothing and matches JAX."""
    jm, tm, net_type, shape, layout = (
        _resnet("batch", "reflect", True) if net == "resnet"
        else _unet("batch", 6, 64, True))
    x = _image(shape)
    params, stats = filled(jm, x, train=False)
    tm.load_state_dict(state_dict_from_flax(net_type, params, stats, layout))
    assert any(isinstance(m, tgan.Dropout) for m in tm.modules())
    v = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False)).lower(
        v, jnp.asarray(x)).compile(QUICK)(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_nchw(x), torch.Generator().manual_seed(0))
    _close(want, got, FWD_TOL)


def test_dropout_draws_from_the_generator():
    """Train mode: about half the activations zeroed, the rest doubled;
    the mask follows the caller's generator; eval mode is the identity."""
    d = tgan.Dropout(0.5).train()
    x = torch.rand(200, 500) + 0.5
    y = d(x, torch.Generator().manual_seed(4))
    zero = y == 0
    assert abs(float(zero.float().mean()) - 0.5) < 0.01
    torch.testing.assert_close(y[~zero], 2.0 * x[~zero], rtol=0, atol=0)
    assert torch.equal(y, d(x, torch.Generator().manual_seed(4)))
    assert not torch.equal(y, d(x, torch.Generator().manual_seed(5)))
    assert torch.equal(d.eval()(x), x)


def test_factories_build_jax_nets_and_raise_alike():
    """``define_g``/``define_d`` build JAX's choices (6 or 9 blocks, 7 or 8
    downs, 3 levels for "basic"), ``input_nc`` 1 by default, and raise
    ``NotImplementedError`` for an unknown name, norm or padding as JAX
    does."""
    cases = [("resnet_6blocks", tgan.ResnetGenerator, 6),
             ("resnet_9blocks", tgan.ResnetGenerator, 9),
             ("unet_128", tgan.UnetGenerator, 7),
             ("unet_256", tgan.UnetGenerator, 8)]
    for name, cls, depth in cases:
        g = tgan.define_g(1, 4, name)
        assert isinstance(g, cls)
        j = jgan.define_g(1, 4, name)
        assert (j.n_blocks if cls is tgan.ResnetGenerator
                else j.num_downs) == depth
        sd = g.state_dict()
        assert gan_layout("resnet_generator" if cls is tgan.ResnetGenerator
                          else "unet_generator", sd)[0] == depth
        first = next(v for k, v in sd.items() if k.endswith("weight"))
        assert first.shape[1] == 1
    d = tgan.define_d(4, "basic", input_nc=2)
    assert gan_layout("nlayer_discriminator", d.state_dict()) == (3, "batch")
    assert d.model[0].weight.shape[1] == 2
    d = tgan.define_d(4, "n_layers", n_layers_d=2, norm="instance",
                      use_sigmoid=True)
    assert gan_layout("nlayer_discriminator", d.state_dict()) == (
        2, "instance")
    assert isinstance(d.model[-1], torch.nn.Sigmoid)
    for bad in (lambda m: m.define_g(1, 4, "nope"),
                lambda m: m.define_d(4, "nope"),
                lambda m: m.define_d(4, "basic", norm="group"),
                lambda m: m.ResnetGenerator(1, 4, n_blocks=1,
                                            padding_type="bogus")):
        for m in (jgan, tgan):
            with pytest.raises(NotImplementedError):
                d = bad(m)
                if m is jgan:   # Flax raises when the module is built
                    d.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))


# ---------------------------------------------------------------------------
# SCSEModule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 9, 7), (2, 16, 5, 6, 4)],
                         ids=["4d", "5d"])
def test_scse_matches_jax(shape):
    """(N, C, H, W) and (N, C, D, H, W), reduction 4 (a 4-channel
    bottleneck), with smp's names both ways."""
    x_cl = _image(shape[:1] + shape[2:] + shape[1:2])
    jm = jatt.SCSEModule(reduction=4)
    params, _ = filled(jm, x_cl)
    tm = tatt.SCSEModule(shape[1], reduction=4)
    sd = state_dict_from_flax("scse", params, {})
    assert set(sd) == {"cSE.1.weight", "cSE.1.bias", "cSE.3.weight",
                       "cSE.3.bias", "sSE.0.weight", "sSE.0.bias"}
    tm.load_state_dict(sd)
    _same_trees(params, flax_from_state_dict("scse", tm.state_dict())[0])
    want = jax.jit(jm.apply).lower({"params": params}, x_cl).compile(QUICK)(
        {"params": params}, x_cl)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(x_cl, -1, 1))))
    _close(want, got, FWD_TOL)
