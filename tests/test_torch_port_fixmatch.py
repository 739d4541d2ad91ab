"""FixMatch in the port against the JAX package on the CPU: the device
store's ``weak_strong`` mode (``gather_weak_strong`` on injected draws, for
every rot90/flip case and both jitter orders, from float32 and bfloat16
storage), ``normalize_softmax``, and one engine step of ``fixmatch``
against JAX's step body (loss and metrics, gradients, SGD, the EMA teacher,
the BatchNorm buffers), with its discrete decisions held away from their
thresholds."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data import device_store as jds
from cvssl_tpu.models import unet as junet
from cvssl_tpu.train.methods import fixmatch as jfixmatch
from cvssl_tpu_torch.data import device_store as tds
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import flax_from_state_dict
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.methods import fixmatch as tfixmatch

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_adversarial import run_step  # noqa: E402
from test_torch_port_methods import B, C, FEATURES, LB, MARGIN  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the store's weak_strong mode
# ---------------------------------------------------------------------------

class _Slices:
    """Slices of another size than the patch, so the store zooms; values
    in [0, 1], with a few outside, so that the jitter's clip acts."""

    def __init__(self, n=10, shape=(30, 32)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.3, self.shape).astype(np.float32),
                "label": r.integers(0, 4, self.shape).astype(np.uint8)}


# every (k, axis) pair, each jitter order four times; factors on both
# sides of 1
DRAWS = {"k": np.array([0, 1, 2, 3, 0, 1, 2, 3], np.int64),
         "axis": np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int64),
         "bf": np.array([0.2, 1.7, 0.9, 1.3, 1.79, 0.5, 1.1, 0.25],
                        np.float32),
         "cf": np.array([1.6, 0.3, 1.2, 0.8, 0.21, 1.75, 0.6, 1.4],
                        np.float32),
         "order": np.array([0.1, 0.9, 0.4, 0.6, 0.7, 0.2, 0.8, 0.3],
                           np.float32)}
INDICES = np.array([3, 0, 7, 7, 9, 1, 4, 2])


def _jax_weak_strong(images, labels, indices, d):
    """``jds.gather_weak_strong`` itself, its ``jax.random`` calls patched
    to return the draws ``d``: each key is (sample, tag), and ``split`` and
    the draws read both."""
    k, axis = jnp.asarray(d["k"], jnp.int32), jnp.asarray(d["axis"],
                                                         jnp.int32)
    order, bf, cf = (jnp.asarray(d[n]) for n in ("order", "bf", "cf"))
    root = 99

    def split(key, num=2):
        # root -> (i, 0); (i, 0) -> (i, 1..3); (i, 3) -> (i, 4..6)
        i = jnp.arange(num)
        first = jnp.where(key[1] == root, i, key[0])
        tag = jnp.where(key[1] == root, 0,
                        jnp.where(key[1] == 0, 1, 4) + i)
        return jnp.stack([first, tag], axis=-1)

    def randint(key, shape, minval, maxval, dtype=None):
        return jnp.where(key[1] == 1, k[key[0]], axis[key[0]])

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return jnp.select([key[1] == 4, key[1] == 5],
                          [order[key[0]], bf[key[0]]], cf[key[0]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "split", split)
        mp.setattr(jax.random, "randint", randint)
        mp.setattr(jax.random, "uniform", uniform)
        out = jax.jit(jds.gather_weak_strong)(
            images, labels, jnp.asarray(indices), jnp.array([0, root]))
    return {n: np.asarray(v) for n, v in out.items()}


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_gather_weak_strong_matches_jax(storage):
    """The un-augmented image, weak view and labels bit for bit; the strong
    view within float32 rounding (the contrast's per-sample mean sums in
    another order)."""
    ds = _Slices()
    js = jds.DeviceSliceStore(ds, (32, 32), image_dtype=getattr(jnp, storage),
                              mode="weak_strong")
    ts = tds.DeviceSliceStore(ds, (32, 32), image_dtype=getattr(torch,
                                                                storage),
                              device="cpu", mode="weak_strong")
    want = _jax_weak_strong(js.images, js.labels, INDICES, DRAWS)
    got = tds.gather_weak_strong(
        ts.images, ts.labels, torch.from_numpy(INDICES),
        {n: torch.from_numpy(v) for n, v in DRAWS.items()})
    assert set(got) == set(want) == {"image", "image_weak", "image_strong",
                                     "label_aug", "label", "idx"}
    for n in ("image", "image_weak", "image_strong"):
        assert got[n].shape == (8, 1, 32, 32) and got[n].dtype == torch.float32
        assert got[n].is_contiguous()
    for n in ("label_aug", "label"):
        assert got[n].dtype == torch.int32 and got[n].is_contiguous()
    for n in ("image", "image_weak"):
        np.testing.assert_array_equal(got[n][:, 0].numpy(), want[n][..., 0])
    for n in ("label_aug", "label", "idx"):
        np.testing.assert_array_equal(got[n].numpy(), want[n])
    strong = got["image_strong"][:, 0].numpy()
    np.testing.assert_allclose(strong, want["image_strong"][..., 0],
                               rtol=1e-6, atol=1e-6)
    # the jitter acted, the clip too, and the weak views differ per case
    assert not np.array_equal(strong, got["image_weak"][:, 0].numpy())
    assert strong.min() == 0.0 and strong.max() == 1.0
    assert np.array_equal(got["label_aug"].numpy(), got["label"].numpy())


def test_weak_strong_orders_and_factors():
    """contrast(brightness(x)) below 0.5, brightness(contrast(x)) above;
    the contrast mean is the sample's own."""
    x = torch.from_numpy(np.random.default_rng(1).random(
        (2, 8, 8)).astype(np.float32))
    d = {"bf": torch.tensor([1.5, 1.5]), "cf": torch.tensor([0.5, 0.5]),
         "order": torch.tensor([0.2, 0.8])}
    out = tds._color_jitter(x, d)

    def b(v):
        return torch.clamp(v * 1.5, 0, 1)

    def c(v):
        return torch.clamp(0.5 * v + 0.5 * v.mean(), 0, 1)
    torch.testing.assert_close(out[0], c(b(x[0])), rtol=0, atol=1e-7)
    torch.testing.assert_close(out[1], b(c(x[1])), rtol=0, atol=1e-7)


def test_weak_strong_store_draws_from_the_generator():
    """The batch function draws k, axis, bf, cf and the order from the
    step's generator, in their ranges; the same state, the same batch."""
    ts = tds.DeviceSliceStore(_Slices(), (32, 32), device="cpu",
                              mode="weak_strong")
    idx = torch.tensor([1, 2, 3, 4])
    a = ts.batch_fn(ts.arrays(), idx, torch.Generator().manual_seed(3))
    torch.manual_seed(5)
    b = ts.batch_fn(ts.arrays(), idx, torch.Generator().manual_seed(3))
    for n in a:
        assert torch.equal(a[n], b[n]), n
    d = tds.draw_weak_strong(4096, torch.Generator().manual_seed(3), "cpu")
    assert set(d["k"].tolist()) == {0, 1, 2, 3}
    assert set(d["axis"].tolist()) == {0, 1}
    for n, lo, hi in (("bf", 0.2, 1.8), ("cf", 0.2, 1.8),
                      ("order", 0.0, 1.0)):
        assert d[n].dtype == torch.float32
        assert lo <= float(d[n].min()) and float(d[n].max()) < hi
    c = tds.gather_weak_strong(
        ts.images, ts.labels, idx,
        tds.draw_weak_strong(4, torch.Generator().manual_seed(3), "cpu"))
    for n in a:
        assert torch.equal(a[n], c[n]), n


def test_store_mode_is_checked():
    with pytest.raises(ValueError, match="store mode"):
        tds.DeviceSliceStore(_Slices(), (32, 32), device="cpu", mode="cta")
    assert tds.DeviceSliceStore(_Slices(), (32, 32),
                                device="cpu").mode == "default"
    assert tds.DeviceSliceStore(_Slices(), (32, 32), device="cpu",
                                mode="weak").mode == "weak"


def test_normalize_softmax_matches_jax():
    soft = np.random.default_rng(2).dirichlet(np.ones(C), size=(2, 5, 6))
    soft = soft.astype(np.float32)
    got = tfixmatch.normalize_softmax(torch.from_numpy(
        np.moveaxis(soft, -1, 1).copy()))
    want = jfixmatch.normalize_softmax(jnp.asarray(soft))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want),
                                                        -1, 1),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# one engine step against JAX's step body
# ---------------------------------------------------------------------------

def _fixmatch_batch(seed):
    rng = np.random.default_rng(seed)
    image = rng.random((B, 32, 32, 1)).astype(np.float32)
    label = rng.integers(0, C, (B, 32, 32)).astype(np.int32)
    return {"image": image,
            "image_weak": rng.random((B, 32, 32, 1)).astype(np.float32),
            "image_strong": rng.random((B, 32, 32, 1)).astype(np.float32),
            "label_aug": label, "label": label}


@pytest.fixture(scope="module")
def fixmatch_step():
    jmods = {"model": junet.UNet(in_chns=1, num_classes=C,
                                 features=FEATURES, dropout=(0.0,) * 5)}
    seen = []
    normalize = tfixmatch.normalize_softmax
    mp = pytest.MonkeyPatch()
    mp.setattr(tfixmatch, "normalize_softmax", lambda soft: (
        seen.append(soft.detach().clone()), normalize(soft))[1])
    try:
        r = run_step("fixmatch", jmods, lambda slot: tunet.UNet(
            1, C, features=FEATURES, dropout=(0.0,) * 5),
            _fixmatch_batch(0), seed=1)
    finally:
        mp.undo()
    r["soft_weak"] = seen
    return r


def test_fixmatch_loss_and_metrics_match_jax_step(fixmatch_step):
    j, t = fixmatch_step["jmetrics"], fixmatch_step["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_weight"]) == 1.0
    assert float(j["as_weight"]) > 0.0


def test_fixmatch_gradients_and_updates_match_jax_step(fixmatch_step):
    """The gradients (``as_weight`` is not detached on either side), the
    parameters after SGD and the EMA teacher within 2e-2 of the largest
    delta from the initial weights plus float32 rounding, and the
    BatchNorm buffers after the two train-mode forwards."""
    r = fixmatch_step
    (g_phase,) = r["jgrads"]
    js, ts = r["jstate"], r["tstate"]
    model = ts.models["model"]
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads.update({k: torch.zeros_like(b) for k, b in model.named_buffers()})
    _assert_tree_close(flax_from_state_dict("unet", grads)[0],
                       g_phase["model"])
    leaves = jax.tree_util.tree_leaves
    for want, got in ((js.params["model"], model),
                      (js.teacher_params["model"], ts.teachers["model"])):
        got_p, got_bs = flax_from_state_dict("unet", {
            k: v.detach() for k, v in got.state_dict().items()})
        scale = max(float(np.abs(np.asarray(a) - b).max()) for a, b in
                    zip(leaves(want), leaves(r["p0"]["model"])))
        assert scale > 0.0
        for a, b in zip(leaves(want), leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
    for want, got in ((js.batch_stats["model"], model),
                      (js.teacher_batch_stats["model"],
                       ts.teachers["model"])):
        got_bs = flax_from_state_dict("unet", got.state_dict())[1]
        for a, b in zip(leaves(want), leaves(got_bs)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
    assert ts.optimizers["model"].count == 1
    assert r["draws"].log == []


def test_fixmatch_decisions_are_clear_of_their_thresholds(fixmatch_step):
    """No value that the confidence threshold, the complementary argmin or
    the pseudo-label argmax decides lies within MARGIN of its threshold or
    of a tie (the argmin and argmax on log-probabilities), so float32
    noise between the frameworks cannot flip one; the confidence mask
    passes some sites and not others."""
    (soft,) = fixmatch_step["soft_weak"]
    norm = tfixmatch.normalize_softmax(soft)
    thresh = TConfig().conf_thresh
    assert float((norm - thresh).abs().min()) > MARGIN
    mask = norm > thresh
    assert bool(mask.any()) and not bool(mask.all())
    low2 = torch.log(soft).topk(2, dim=1, largest=False).values
    assert float((low2[:, 1] - low2[:, 0]).min()) > MARGIN
    masked = (soft * mask)[LB:]
    top2 = masked.topk(2, dim=1).values
    kept = top2[:, 0] > 0
    assert bool(kept.any())
    assert float((top2[:, 0] - top2[:, 1])[kept].min()) > MARGIN


def test_comp_loss_and_its_gradient_match_jax():
    """``comp_loss`` on softmax maps whose spatial distributions are
    peaked (so ``as_weight`` is far from 0): the complementary term, the
    weight, and the gradient w.r.t. the strong logits, which flows through
    ``as_weight`` too (not detached on either side)."""
    rng = np.random.default_rng(4)
    weak = rng.normal(size=(2, 8, 8, C)).astype(np.float32)
    strong = (6.0 * rng.normal(size=(2, 8, 8, C))).astype(np.float32)
    jmethod = jfixmatch.FixMatch(None)

    def jfn(s):
        return jmethod.comp_loss(jax.nn.softmax(jnp.asarray(weak)),
                                 jax.nn.softmax(s))
    jcomp, jw = jfn(jnp.asarray(strong))
    jgrad = jax.grad(lambda s: jfn(s)[0])(jnp.asarray(strong))
    s = torch.from_numpy(np.moveaxis(strong, -1, 1).copy()).requires_grad_()
    tmethod = tfixmatch.FixMatch(None)
    comp, w = tmethod.comp_loss(
        torch.softmax(torch.from_numpy(np.moveaxis(weak, -1, 1).copy()), 1),
        torch.softmax(s, 1))
    comp.backward()
    assert float(jw) > 0.2
    assert float(w.detach()) == pytest.approx(float(jw), rel=1e-5)
    assert float(comp.detach()) == pytest.approx(float(jcomp), rel=1e-5)
    want = np.moveaxis(np.asarray(jgrad), -1, 1)
    np.testing.assert_allclose(s.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
