"""The port's 3D models and kernel #1 at 5D against the JAX package on the
CPU: ``UNet3D``, ``UNet3DDeepSup`` and ``FC3DDiscriminator`` at 16^3
(forward in eval and train mode, their random draws injected, and
gradients, all through ``models/convert.py``), ``trilinear_x2`` at the
edges, InstanceNorm under bfloat16, the 3D registry, and the fused CE+Dice
wrapper's geometry and plain version on NCDHW logits.

Draws are injected as ``test_torch_port_methods.py`` does: the port's
forward runs first with each draw (``BitsDropout``'s bytes, the keep masks
of ``unet._keep``) replaced by numpy values and recorded, then JAX's
forward replays them through patched ``jax.random.bits``/``bernoulli``, in
its NDHWC layout."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import discriminator as jdisc
from cvssl_tpu.models import factory as jfactory
from cvssl_tpu.models import unet3d as junet3d
from cvssl_tpu.ops import losses as jlosses
from cvssl_tpu_torch.models import discriminator as tdisc
from cvssl_tpu_torch.models import net_factory_3d
from cvssl_tpu_torch.models import unet3d as tunet3d
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import dropout as tdropout
from cvssl_tpu_torch.ops import fused_ce_dice as fcd

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_methods import (_Draws, _patch_jax,  # noqa: E402
                                     _patch_port)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


S, B, C = 16, 2, 3       # 16^3: four poolings leave a 1^3 centre
NDF = 8


class Draws3D(_Draws):
    """:class:`_Draws` that also replays 5D draws (NCDHW -> NDHWC) and the
    dropout bytes (``bits``)."""

    def replay(self, kind, shape):
        want, value = self.log[self.cursor]
        if value.ndim != 5:
            return super().replay(kind, shape)
        self.cursor += 1
        assert want == kind, (want, kind)
        value = np.moveaxis(value, 1, -1)
        if shape is not None:
            assert tuple(value.shape) == tuple(shape), (kind, value.shape,
                                                        shape)
        return jnp.asarray(value)


def patch_bits(mp, draws):
    """``BitsDropout`` on recorded bytes in the port, replayed in JAX."""
    def forward(self, x, generator=None):
        if not self.training or tdropout.bits_threshold(self.rate) <= 0:
            return x
        draw = draws.take("bits", draws.rng.integers(
            0, 256, tuple(x.shape)).astype(np.uint8))
        return tdropout.bits_dropout(x, self.rate, draw)
    mp.setattr(tdropout.BitsDropout, "forward", forward)


def patch_bits_jax(mp, draws):
    mp.setattr(jax.random, "bits", lambda key, shape=(), dtype=None:
               draws.replay("bits", shape))


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _ndhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


NETS = {
    "unet_3D": (lambda: junet3d.UNet3D(num_classes=C),
                lambda: tunet3d.UNet3D(1, C)),
    "unet_3D_dv_semi": (lambda: junet3d.UNet3DDeepSup(num_classes=C),
                        lambda: tunet3d.UNet3DDeepSup(1, C)),
}


def _init(jm, x, seed=0):
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _image(seed=1, shape=(B, S, S, S, 1)):
    return np.random.default_rng(seed).normal(0.5, 0.25, shape).astype(
        np.float32)


@pytest.fixture(scope="module", params=list(NETS))
def net_pair(request):
    """Each 3D UNet at full width in both packages with JAX's initial
    weights: eval and train forward (draws injected), and the gradients of
    a random linear functional of the outputs."""
    name = request.param
    jm, tm = (f() for f in NETS[name])
    x = _image()
    params = _init(jm, x)
    tm.load_state_dict(state_dict_from_flax(name, params, {}), strict=True)
    w = [np.random.default_rng(9 + i).normal(size=(B, S, S, S, C)).astype(
        np.float32) for i in range(4)]

    def jloss(p, train):
        out = jm.apply({"params": p}, jnp.asarray(x), train=train,
                       rngs={"dropout": jax.random.PRNGKey(0),
                             "perturb": jax.random.PRNGKey(1)})
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w)), outs

    draws = Draws3D(3)
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    patch_bits(mp, draws)
    try:
        tm.train()
        got = tm(_ncdhw(x))
        outs = got if isinstance(got, tuple) else (got,)
        loss = sum((o * _ncdhw(wi)).sum() for o, wi in zip(outs, w))
        loss.backward()
    finally:
        mp.undo()
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    patch_bits_jax(mp, draws)
    try:
        draws.cursor = 0
        (_, want), grads = jax.jit(jax.value_and_grad(
            lambda p: jloss(p, True), has_aux=True))(params)
    finally:
        mp.undo()
    assert draws.cursor == len(draws.log)
    with torch.no_grad():
        got_eval = tm.eval()(_ncdhw(x))
    want_eval = jm.apply({"params": params}, jnp.asarray(x), train=False)
    tgrads = flax_from_state_dict(name, {k: p.grad for k, p in
                                         tm.named_parameters()})[0]
    return dict(name=name, params=params, tm=tm, train=(outs, want),
                eval=(got_eval, want_eval), grads=(tgrads, grads),
                draws=draws)


def _close(got, want, rel=1e-4):
    """Each output within ``rel`` of its largest element (float32, other
    accumulation orders through 18 convs)."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert _ndhwc(g).shape == w.shape
        np.testing.assert_allclose(_ndhwc(g), w, rtol=0,
                                   atol=rel * float(np.abs(w).max()))


def test_unet3d_forward_matches_flax(net_pair):
    """Eval and train mode within 1e-4 of the largest logit; the logits are
    float32 in eval mode (the deep-supervision heads float32 in every
    mode)."""
    _close(*net_pair["eval"])
    _close(*net_pair["train"])
    got_eval = net_pair["eval"][0]
    for o in got_eval if isinstance(got_eval, tuple) else (got_eval,):
        assert o.dtype == torch.float32


def test_unet3d_draws_in_jax_order(net_pair):
    """UNet3D: the centre's dropout bytes, then the last level's (0.3 each,
    8-bit draws); UNet3DDeepSup: one keep mask per (sample, channel) on
    up4, up3, up2 and up1, at p = .5, .3, .2, .1."""
    log = net_pair["draws"].log
    if net_pair["name"] == "unet_3D":
        assert [(k, v.shape) for k, v in log] == [
            ("bits", (B, 256, 1, 1, 1)), ("bits", (B, 16, S, S, S))]
    else:
        assert [(k, v.shape) for k, v in log] == [
            ("keep", (B, 128, 1, 1, 1)), ("keep", (B, 64, 1, 1, 1)),
            ("keep", (B, 32, 1, 1, 1)), ("keep", (B, 16, 1, 1, 1))]


def test_unet3d_gradients_match_flax(net_pair):
    _assert_tree_close(*net_pair["grads"])


def test_unet3d_parameters_and_registry():
    """The registry's nets have JAX's parameter counts (2 classes: UNet3D
    5,884,050), an unknown name raises with the list, and the converter is
    its own inverse."""
    x = _image(shape=(1, S, S, S, 1))
    for name, want_kind in (("unet_3D", tunet3d.UNet3D),
                            ("unet_3D_dv_semi", tunet3d.UNet3DDeepSup),
                            ("discriminator", tdisc.FC3DDiscriminator)):
        t = net_factory_3d(name, 1, 2)
        assert isinstance(t, want_kind)
        j = jfactory.net_factory_3d(name, class_num=2)
        args = (x,) if name != "discriminator" else (
            np.zeros((1, S, S, S, 2), np.float32), x)
        shapes = jax.eval_shape(
            lambda k: j.init(k, *args, train=False), jax.random.PRNGKey(0))
        n = sum(int(np.prod(a.shape)) for a in
                jax.tree_util.tree_leaves(shapes["params"]))
        assert sum(p.numel() for p in t.parameters()) == n
    assert sum(p.numel() for p in net_factory_3d(
        "unet_3D", 1, 2).parameters()) == 5_884_050
    with pytest.raises(ValueError, match="available"):
        net_factory_3d("no_such_net")
    params = _init(junet3d.UNet3D(num_classes=2), x)
    back = flax_from_state_dict("unet_3D", state_dict_from_flax(
        "unet_3D", params, {}))[0]
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 3, 4, 5, 2), (2, 1, 1, 6, 3)])
def test_trilinear_x2_matches_jax_resize(shape):
    """``trilinear_x2`` is ``jax.image.resize(..., "trilinear")`` at scale
    2, edges included (a side of 1 is constant along its axis)."""
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    b, d, h, w, c = shape
    want = np.asarray(jax.image.resize(jnp.asarray(x), (b, 2 * d, 2 * h,
                                                        2 * w, c),
                                       "trilinear"))
    got = _ndhwc(tunet3d.trilinear_x2(_ncdhw(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_instance_norm_bf16_matches_jax():
    """InstanceNorm of a bfloat16 map: computed in float32 and rounded once
    to bfloat16, as JAX's ``instance_norm(dtype=bfloat16)``: bit-equal."""
    x = (np.random.default_rng(6).normal(3.0, 2.0, (2, 5, 6, 7, 4))
         .astype(np.float32))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(junet3d.instance_norm(xb, dtype=jnp.bfloat16)
                      .astype(jnp.float32))
    tb = _ncdhw(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = tunet3d.instance_norm(tb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_ndhwc(got.float()), want)
    # a map of one site per channel normalises to 0 (x - mean is float32
    # rounding, times rsqrt(eps))
    one = tunet3d.instance_norm(torch.randn(2, 3, 1, 1, 1))
    assert float(one.abs().max()) < 1e-4


def test_fc3d_discriminator_matches_flax(monkeypatch):
    """Train mode on injected channel-dropout masks (three, per (sample,
    channel)) and eval mode, at 32^3 (a 2^3 map before the global mean);
    the classifier is a plain Dense over the channel vector."""
    m = jdisc.FC3DDiscriminator(num_classes=2, ndf=NDF)
    rng = np.random.default_rng(2)
    soft = rng.dirichlet(np.ones(2), size=(3, 32, 32, 32)).astype(
        np.float32)
    image = rng.normal(0.5, 0.25, (3, 32, 32, 32, 1)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k, s, x: m.init(k, s, x, train=False))(
            jax.random.PRNGKey(0), soft, image)["params"])
    t = tdisc.FC3DDiscriminator(2, 1, ndf=NDF)
    t.load_state_dict(state_dict_from_flax("discriminator_3d", params, {}),
                      strict=True)
    draws = Draws3D(3)
    with monkeypatch.context() as mp:
        _patch_port(mp, draws)
        got = t.train()(_ncdhw(soft), _ncdhw(image))
    assert [v.shape for _, v in draws.log] == [
        (3, NDF, 1, 1, 1), (3, 2 * NDF, 1, 1, 1), (3, 4 * NDF, 1, 1, 1)]
    with monkeypatch.context() as mp:
        _patch_jax(mp, draws)
        want = jax.jit(lambda p, s, x: m.apply(
            {"params": p}, s, x, train=True,
            rngs={"dropout": jax.random.PRNGKey(0)}))(params, soft, image)
    assert draws.cursor == 3
    with torch.no_grad():
        got_eval = t.eval()(_ncdhw(soft), _ncdhw(image))
    want_eval = jax.jit(lambda p, s, x: m.apply({"params": p}, s, x,
                                                train=False))(params, soft,
                                                              image)
    for g, w in ((got, want), (got_eval, want_eval)):
        w = np.asarray(w)
        assert g.shape == w.shape == (3, 2)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()))
    assert sum(p.numel() for p in tdisc.FC3DDiscriminator(
        2).parameters()) == 11_024_386


# ---------------------------------------------------------------------------
# kernel #1 at 5D: the wrapper's geometry and its plain version
# ---------------------------------------------------------------------------

CE_DICE_5D = [((2, 2, 96, 96, 96), "float32", "int32"),
              ((2, 2, 96, 96, 96), "bfloat16", "uint8"),
              ((2, 2, 17, 19, 23), "float32", "uint8"),
              ((2, 2, 17, 19, 23), "bfloat16", "int32")]


@pytest.mark.parametrize("shape,dtype,label_dtype", CE_DICE_5D)
def test_ce_dice_geometry_at_5d(shape, dtype, label_dtype):
    """NCDHW logits: every axis after the class axis folds into the site
    count, each class plane contiguous. Config 5's (2, 2, 96, 96, 96) takes
    the vector path (884,736 sites an item, a whole number of 16-byte
    chunks); the ragged (2, 2, 17, 19, 23) the scalar loop."""
    logits = torch.zeros(shape, dtype=getattr(torch, dtype))
    labels = torch.zeros(shape[:1] + shape[2:], dtype=getattr(torch,
                                                              label_dtype))
    geo = fcd._geometry(logits, labels)
    sites = int(np.prod(shape[2:]))
    vec = 16 // logits.element_size()
    assert (geo.batch, geo.classes, geo.sites, geo.vec) == (
        shape[0], shape[1], sites, vec)
    if shape[2:] == (96, 96, 96):
        assert geo.vector and geo.tail == 0 and geo.chunks == sites // vec
        # the sums the kernel keeps per class stay exact counts in float32
        assert shape[0] * sites < 2 ** 24
    else:
        assert not geo.vector and geo.chunks == 0 and geo.tail == sites
    with pytest.raises(ValueError, match="contiguous"):
        fcd._geometry(logits.transpose(2, 3), labels)


@pytest.mark.parametrize("shape,dtype,label_dtype", CE_DICE_5D)
def test_ce_dice_plain_at_5d_matches_jax(shape, dtype, label_dtype):
    """The wrapper on CPU tensors (the plain version) against JAX's
    ``losses.ce_dice(fused=False)`` on the same NDHWC values, and against
    float64. The float32 sums over config 5's 1.77M sites lose precision
    in JAX's order (1.2e-5 relative on Dice, measured) and not in torch's
    (5e-8): CE and Dice within 1e-6 of float64 and 5e-5 of JAX; gradients
    within 1e-4 of their largest."""
    rng = np.random.default_rng(sum(shape))
    x = (2.0 * rng.normal(size=shape)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    y = rng.integers(0, shape[1], shape[:1] + shape[2:]).astype(label_dtype)
    xj = np.moveaxis(x, 1, -1)

    def jloss(v):
        ce, dice = jlosses.ce_dice(v, jnp.asarray(y), shape[1],
                                   fused=False)
        return 0.3 * ce + 1.7 * dice, (ce, dice)
    (_, (jce, jdice)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(xj))
    t = torch.from_numpy(x).requires_grad_(True)
    ce, dice = fcd.fused_ce_dice(t, torch.from_numpy(y), shape[1])
    (0.3 * ce + 1.7 * dice).backward()
    ce64, dice64 = fcd.ce_dice_plain(torch.from_numpy(x).double(),
                                     torch.from_numpy(y), shape[1])
    for got, want, want64 in ((ce, jce, ce64), (dice, jdice, dice64)):
        got = float(got.detach())
        assert got == pytest.approx(float(want64), rel=1e-6)
        assert got == pytest.approx(float(want), rel=5e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(_ndhwc(t.grad), jg, rtol=0,
                               atol=1e-4 * float(np.abs(jg).max()))
