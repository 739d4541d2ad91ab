"""The port's contrastive path against the JAX package on the CPU: the
patch-NCE losses (values and gradients), ``ramp_up_function`` and the
two-phase poly LR with its SGD, the ``Projector`` and ``Classifier`` heads
(forward from converted weights, their leaves both ways and through JAX's
converters from the reference's names), the store's ``weak`` mode, and one
engine step of ``contrastive_cross`` (UNet + UNet and UNet + SwinUnet)
against JAX's step body at consistency weight 1, with every draw injected
(``test_torch_port_adversarial.py::run_step``); then ``fit`` and the CLI.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvssl_tpu.data import device_store as jds
from cvssl_tpu.models import projector as jproj
from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu.models import unet as junet
from cvssl_tpu.models.torch_convert import (convert_classifier_checkpoint,
                                            convert_projector_checkpoint)
from cvssl_tpu.ops import losses as jlosses
from cvssl_tpu.ops import ramps as jramps
from cvssl_tpu.ops import schedules as jschedules
from cvssl_tpu_torch.data import device_store as tds
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models import projector as tproj
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import losses as tlosses
from cvssl_tpu_torch.ops import ramps as tramps
from cvssl_tpu_torch.ops import schedules as tschedules
from cvssl_tpu_torch.train import cli as tcli
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import fit
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx
from cvssl_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_adversarial import _spy, run_step  # noqa: E402
from test_torch_port_methods import B, C, FEATURES, LB, MARGIN  # noqa: E402
from test_torch_port_vit_methods import VIT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HW = 32
HEADS = ("classifier1", "classifier2", "projector1", "projector2")
# full width: the heads on 4-class logits (ndf 8)
HEAD_PARAMS = {"projector": 1512, "classifier": 7272}


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------

def _feats(seed, shape=(3, 6, 4, 5)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


LOSSES = {
    "l1_normalize": (lambda m, q, k: m._l1_normalize(q, axis=1).sum()
                     + (m._l1_normalize(q, axis=1) ** 2).sum()),
    "patch_nce_zero_positive": (lambda m, q, k: m._patch_nce(
        q, k, 0.07, pos_from_dot=False)),
    "con_loss": lambda m, q, k: m.con_loss(q, k),
    "contrastive_loss_sup": lambda m, q, k: m.contrastive_loss_sup(q, k),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_contrastive_losses_match_jax(name):
    """Values and gradients within 1e-6 relative, the key side without
    gradient (JAX: under stop_gradient); (B, C, H, W) features with H != W,
    so a patch order other than H-major would show."""
    fn = LOSSES[name]
    q, k = _feats(0)
    want, (gq, gk) = jax.value_and_grad(
        lambda a, b: fn(jlosses, a, b), argnums=(0, 1))(jnp.asarray(q),
                                                        jnp.asarray(k))
    tq = torch.from_numpy(q).requires_grad_(True)
    tk = torch.from_numpy(k).requires_grad_(True)
    got = fn(tlosses, tq, tk)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), rtol=1e-6,
                               atol=1e-6 * float(np.abs(gq).max()))
    if name == "l1_normalize":
        return
    assert not np.asarray(gk).any()
    assert tk.grad is None or not tk.grad.any()


def test_patch_nce_flattens_the_sites_h_major():
    """A permutation of the sites that keeps H-major order of query and key
    together changes nothing; the loss of a transposed map (W-major) is
    another number for both packages alike."""
    q, k = _feats(1, (2, 3, 4, 6))
    a = tlosses.con_loss(torch.from_numpy(q), torch.from_numpy(k))
    qt, kt = (np.ascontiguousarray(x.transpose(0, 1, 3, 2)) for x in (q, k))
    b = tlosses.con_loss(torch.from_numpy(qt).transpose(2, 3),
                         torch.from_numpy(kt).transpose(2, 3))
    assert float(a) == float(b)
    assert float(tlosses.con_loss(torch.from_numpy(qt),
                                  torch.from_numpy(kt))) == pytest.approx(
        float(jlosses.con_loss(qt, kt)), rel=1e-6)


# ---------------------------------------------------------------------------
# ramp and learning rate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_epoch", [80, 200])
def test_ramp_up_function_matches_jax(max_epoch):
    """Every epoch up to past the maximum: 1 exactly from the maximum on,
    below 1 just before it."""
    for e in range(max_epoch + 5):
        want = float(jramps.ramp_up_function(e, max_epoch))
        got = tramps.ramp_up_function(e, max_epoch)
        assert got == pytest.approx(want, rel=1e-6), e
    assert tramps.ramp_up_function(max_epoch, max_epoch) == 1.0
    assert tramps.ramp_up_function(max_epoch - 1, max_epoch) < 1.0


def test_two_phase_lr_and_sgd_match_jax():
    """The schedule over steps that span the switch at half the
    iterations (the drop to 1e-4, then the half-rate poly), and eight
    updates of ``TwoPhaseReferenceSGD`` against the optax chain over the
    same switch."""
    want = jschedules.two_phase_poly_lr(0.01, 10)
    got = tschedules.two_phase_poly_lr(0.01, 10)
    for s in range(14):
        assert got(s) == pytest.approx(float(want(s)), rel=1e-6), s
    assert got(5) > 1e-3 and got(6) < 1e-4
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(5, 4)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(8)]
    tx = jschedules.two_phase_reference_sgd(0.01, 10)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tschedules.TwoPhaseReferenceSGD([w], 0.01, 10)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
        w.grad = torch.from_numpy(g)
        opt.step()
    assert opt.count == 8
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the heads
# ---------------------------------------------------------------------------

HEAD_CLASSES = {"projector": (jproj.Projector, tproj.Projector,
                              convert_projector_checkpoint),
                "classifier": (jproj.Classifier, tproj.Classifier,
                               convert_classifier_checkpoint)}


def _flax_head(kind, seed=0):
    m = HEAD_CLASSES[kind][0]()
    v = m.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, C)),
               train=False)
    # running statistics away from their initial values
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.normal(1.0, 0.3, a.shape)).astype(np.float32),
        v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return m, params, stats


# the heads' float32 outputs against Flax's, of the largest output:
# measured up to 2.3e-6 (train mode, three seeds), where XLA's own float32
# output is up to 3.5e-6 and the port's 2.8e-6 from a float64 evaluation
HEAD_ATOL = 5e-6


@pytest.mark.parametrize("kind", sorted(HEAD_CLASSES))
def test_head_forward_matches_flax(kind):
    """Eval and train mode from converted weights, within HEAD_ATOL of the
    largest output; train mode moves the running statistics as Flax's
    (momentum 0.9); the shape is NCHW of (ndf * 2, H/4, W/4) or
    (ndf * 4, H/8, W/8)."""
    m, params, stats = _flax_head(kind)
    t = HEAD_CLASSES[kind][1](in_channels=C)
    t.load_state_dict(state_dict_from_flax(kind, params, stats), strict=True)
    x = np.random.default_rng(1).normal(size=(3, HW, HW, C)).astype(
        np.float32)
    tx = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))
    want_eval = m.apply({"params": params, "batch_stats": stats}, x,
                        train=False)
    with torch.no_grad():
        got_eval = t.eval()(tx)
    want_train, mutated = m.apply({"params": params, "batch_stats": stats},
                                  x, train=True, mutable=["batch_stats"])
    got_train = t.train()(tx)
    side = HW // (4 if kind == "projector" else 8)
    for got, want in ((got_train, want_train), (got_eval, want_eval)):
        want = np.moveaxis(np.asarray(want), -1, 1)
        assert got.shape == want.shape == (3, 16 if kind == "projector"
                                           else 32, side, side)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=HEAD_ATOL * float(np.abs(want).max()))
    got_stats = flax_from_state_dict(kind, t.state_dict())[1]
    for a, b in zip(jax.tree_util.tree_leaves(mutated["batch_stats"]),
                    jax.tree_util.tree_leaves(got_stats)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", sorted(HEAD_CLASSES))
def test_head_leaves_both_ways_and_through_jax_converters(kind):
    """Flax -> port -> Flax is the identity; JAX's converter from the
    reference's names reads the port's ``state_dict`` as it is and gives
    Flax's trees; the factory's parameter count is Flax's (the
    projector's dead ``final`` conv is in neither)."""
    _, params, stats = _flax_head(kind, seed=2)
    sd = state_dict_from_flax(kind, params, stats)
    back_p, back_s = flax_from_state_dict(kind, sd)
    via_p, via_s = HEAD_CLASSES[kind][2](
        {k: v.numpy() for k, v in sd.items()})
    for a, b, c in ((params, back_p, via_p), (stats, back_s, via_s)):
        la, lb, lc = (jax.tree_util.tree_leaves(x) for x in (a, b, c))
        assert jax.tree_util.tree_structure(a) == \
            jax.tree_util.tree_structure(c)
        assert len(la) == len(lb) == len(lc)
        for x, y, z in zip(la, lb, lc):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
    t = net_factory(kind, 1, C)
    assert set(t.state_dict()) == set(sd)
    n = sum(p.numel() for p in t.parameters())
    shapes = jax.eval_shape(
        lambda k: HEAD_CLASSES[kind][0]().init(
            k, jnp.zeros((1, 64, 64, C)), train=False),
        jax.random.PRNGKey(0))
    assert n == HEAD_PARAMS[kind] == sum(
        int(np.prod(a.shape)) for a in
        jax.tree_util.tree_leaves(shapes["params"]))


def test_heads_cast_bf16_logits_and_compute_in_float32():
    """A bfloat16 logit map (a bf16 segmenter's output) goes into the
    float32 head as its float32 values, as Flax promotes it; the heads are
    float32 nets under any compute dtype."""
    t = tproj.Classifier(in_channels=C).eval()
    x = torch.randn(2, C, HW, HW).to(torch.bfloat16)
    with torch.no_grad():
        got, want = t(x), t(x.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    cfg = TConfig(dtype="bfloat16", method="contrastive_cross")
    assert {cfg.model_dtype(k, "cpu") for k in HEAD_PARAMS} == \
        {torch.float32}


# ---------------------------------------------------------------------------
# the store's weak mode
# ---------------------------------------------------------------------------

class _Slices:
    def __init__(self, n=10, shape=(30, 36)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, self.shape).astype(np.float32),
                "label": r.integers(0, C, self.shape).astype(np.uint8)}


def test_weak_store_batch_matches_jax():
    """``gather_weak`` against JAX's ``gather_augment(augment=False)``:
    the same batch, bit for bit, after NHWC -> NCHW; the store's
    ``batch_fn`` in the weak mode draws nothing from the generator."""
    ds = _Slices()
    js = jds.DeviceSliceStore(ds, (HW, HW), mode="weak")
    ts = tds.DeviceSliceStore(ds, (HW, HW), device="cpu", mode="weak")
    idx = np.array([3, 0, 7, 7, 9], np.int32)
    want = jds.gather_augment(js.images, js.labels, jnp.asarray(idx),
                              jax.random.PRNGKey(0), augment=False)
    g = torch.Generator().manual_seed(4)
    before = g.get_state()
    got = ts.batch_fn(ts.arrays(), torch.from_numpy(idx.astype(np.int64)),
                      g)
    assert torch.equal(g.get_state(), before)
    assert set(got) == set(want) == {"image", "label", "idx"}
    np.testing.assert_array_equal(got["image"].numpy(),
                                  np.moveaxis(np.asarray(want["image"]),
                                              -1, 1))
    for k in ("label", "idx"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["image"].dtype == torch.float32 and \
        got["image"].is_contiguous()


# ---------------------------------------------------------------------------
# one contrastive_cross step against JAX's step body
# ---------------------------------------------------------------------------

VARIANTS = {"cnn": {"model1": "unet", "model2": "unet"},
            "vit": {"model1": "unet", "model2": "swin_unet"}}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, C, (B, HW, HW)).astype(np.int32)}


def _jax_module(net):
    if net == "unet":
        return junet.UNet(in_chns=1, num_classes=C, features=FEATURES,
                          dropout=(0.0,) * 5)
    if net == "swin_unet":
        return jswin.SwinUnet(num_classes=C, **VIT)
    return {"classifier": jproj.Classifier, "projector": jproj.Projector}[
        net]()


def _port_module(net):
    if net == "unet":
        return tunet.UNet(1, C, features=FEATURES, dropout=(0.0,) * 5)
    if net == "swin_unet":
        return tswin.SwinUnet(num_classes=C, img_size=HW, **VIT)
    return net_factory(net, 1, C)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def cc_step(request):
    """One step at consistency weight 1 (step 30000 is far past the ramp's
    200 epochs). The port's student and head forwards are recorded, and
    kernel #1's calls (``sup_ce_dice``)."""
    slots = {**VARIANTS[request.param],
             "classifier1": "classifier", "classifier2": "classifier",
             "projector1": "projector", "projector2": "projector"}
    cls = type(get_method("contrastive_cross", TConfig()))
    outs, calls = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "forward", _spy(TStepCtx.forward, outs,
                                         lambda self, a: a[0]))
    mp.setattr(cls, "sup_ce_dice", _spy(
        cls.sup_ce_dice, calls,
        lambda self, a: (tuple(a[0].shape), a[0].is_contiguous())))
    try:
        r = run_step("contrastive_cross",
                     {n: _jax_module(t) for n, t in slots.items()},
                     lambda n: _port_module(slots[n]), _batch(4), seed=4,
                     nets=slots, s2d_loss="off",
                     model2=VARIANTS[request.param]["model2"])
    finally:
        mp.undo()
    r["outs"], r["sup_calls"], r["slots"] = outs, calls, slots
    return request.param, r


def test_contrastive_cross_loss_and_metrics_match_jax(cc_step):
    _, r = cc_step
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_weight"]) == 1.0
    assert float(t["contrast_l"]) > 0 and float(t["contrast_u"]) > 0


def test_contrastive_cross_gradients_match_jax(cc_step):
    """The two segmenters' gradients against JAX's; the heads get none
    (they are in no optimizer)."""
    _, r = cc_step
    (want,) = r["jgrads"]
    for n in ("model1", "model2"):
        model = r["tstate"].models[n]
        grads = {k: p.grad for k, p in model.named_parameters()}
        grads.update({k: torch.zeros_like(b)
                      for k, b in model.named_buffers()})
        _assert_tree_close(flax_from_state_dict(r["slots"][n], grads)[0],
                           want[n])
    for n in HEADS:
        assert all(p.grad is None for p in
                   r["tstate"].models[n].parameters())


def test_contrastive_cross_updates_and_heads_match_jax(cc_step):
    """After the step: each segmenter after the two-phase SGD within 2e-2
    of the largest delta plus float32 rounding; the heads' parameters
    unchanged (JAX: a zero optimizer) and their BatchNorm running
    statistics moved as JAX's; only the two segmenters have
    optimizers."""
    _, r = cc_step
    js, ts = r["jstate"], r["tstate"]
    for n in ("model1", "model2"):
        net = r["slots"][n]
        got_p = flax_from_state_dict(net, {k: v.detach() for k, v in
                                           ts.models[n].state_dict().items()
                                           })[0]
        deltas = [np.asarray(a) - np.asarray(b) for a, b in zip(
            jax.tree_util.tree_leaves(js.params[n]),
            jax.tree_util.tree_leaves(r["p0"][n]))]
        scale = max(float(np.abs(d).max()) for d in deltas)
        assert scale > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(js.params[n]),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
    for n in HEADS:
        kind = r["slots"][n]
        got_p, got_s = flax_from_state_dict(kind, ts.models[n].state_dict())
        for a, b in zip(jax.tree_util.tree_leaves(r["p0"][n]),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_array_equal(b, a)
        for a, b in zip(jax.tree_util.tree_leaves(js.params[n]),
                        jax.tree_util.tree_leaves(r["p0"][n])):
            np.testing.assert_array_equal(np.asarray(a), b)
        moved = False
        for a, b in zip(jax.tree_util.tree_leaves(js.batch_stats[n]),
                        jax.tree_util.tree_leaves(got_s)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
            moved |= not np.array_equal(b, np.ones_like(b)) and \
                not np.array_equal(b, np.zeros_like(b))
        assert moved, n
    assert {n: o.count for n, o in ts.optimizers.items()} == {"model1": 1,
                                                              "model2": 1}
    assert all(isinstance(o, tschedules.TwoPhaseReferenceSGD)
               for o in ts.optimizers.values())


def test_contrastive_cross_draws_margins_and_kernel_calls(cc_step):
    """The forwards in JAX's order, the heads fed the stride-2
    interleave (model1's even labeled logits, model2's odd) and the
    unlabeled logits; the SwinUnet's stochastic-depth masks are the only
    draws; every pseudo-label at least MARGIN from a tie; kernel #1 once
    for each segmenter's labeled logits, which are contiguous."""
    name, r = cc_step
    assert [slot for slot, _ in r["outs"]] == ["model1", "model2",
                                               "classifier1", "classifier2",
                                               "projector1", "projector2"]
    kinds = {k for k, _ in r["draws"].log}
    assert kinds == (set() if name == "cnn" else {"keep"})
    for _, out in r["outs"][:2]:
        soft = torch.softmax(out.detach()[LB:].float(), dim=1)
        top2 = soft.topk(2, dim=1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
    heads = dict(r["outs"][2:])
    assert heads["classifier1"].shape == (LB // 2, 32, HW // 8, HW // 8)
    assert heads["projector1"].shape == (B - LB, 16, HW // 4, HW // 4)
    assert [k for k, _ in r["sup_calls"]] == [((LB, C, HW, HW), True)] * 2


def test_contrastive_cross_epoch_and_weight():
    """The epoch index is step // (labeled_slices // labeled_bs), and the
    weight is consistency * ramp_up_function(epoch, rampup), as JAX's."""
    cfg = TConfig(method="contrastive_cross", labeled_slices_override=136,
                  labeled_bs=12, consistency=0.1, consistency_rampup=200.0)
    m = get_method("contrastive_cross", cfg)
    assert [m._epoch(s) for s in (0, 10, 11, 1000)] == [0, 0, 1, 90]
    assert m.transform == "weak"
    assert m.eval_model_names() == ("model1", "model2")
    assert m.net_types() == {
        "model1": "unet", "model2": "swin_unet", "classifier1": "classifier",
        "classifier2": "classifier", "projector1": "projector",
        "projector2": "projector"}


def test_contrastive_cross_step_at_bf16_feeds_float32_heads():
    """At ``dtype="bfloat16"`` (the card's "auto"), here on the CPU: the
    UNets' logits are bfloat16, the heads take them and compute in
    float32, and the step's losses are finite."""
    cfg = TConfig(method="contrastive_cross", model2="unet",
                  num_classes=C, batch_size=B, labeled_bs=LB,
                  patch_size=(HW, HW), labeled_slices_override=LB,
                  dtype="bfloat16")
    engine = TEngine(cfg, method=_NarrowCC(cfg), device="cpu")
    state = engine.init_state()
    seen = []
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "forward", _spy(TStepCtx.forward, seen,
                                         lambda self, a: a[0]))
    try:
        batch = {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy()
                                     if v.ndim == 4 else v)
                 for k, v in _batch(1).items()}
        _, metrics = engine.train_step(state, batch)
    finally:
        mp.undo()
    dtypes = {name: out.dtype for name, out in seen}
    assert dtypes == {"model1": torch.bfloat16, "model2": torch.bfloat16,
                      **{n: torch.float32 for n in HEADS}}
    assert all(np.isfinite(float(v)) for v in metrics.values())


# ---------------------------------------------------------------------------
# fit and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tsyn.make_synthetic_acdc(
        str(tmp_path_factory.mktemp("acdc") / "ACDC"), size=HW)


def _cfg(root, out, **kw):
    base = dict(root_path=root, exp="ACDC/cc", method="contrastive_cross",
                model="unet", model2="unet", num_classes=C, batch_size=4,
                labeled_bs=2, labeled_slices_override=8, patch_size=(HW, HW),
                dtype="float32", max_iterations=100, val_every=2,
                ckpt_every=2, log_every=1, snapshot_root=str(out))
    return TConfig(**{**base, **kw})


class _NarrowCC(type(get_method("contrastive_cross", TConfig()))):
    def _factory(self, net_type):
        if net_type == "unet":
            return net_factory(net_type, 1, C, features=FEATURES)
        return super()._factory(net_type)


@pytest.mark.parametrize("device_data", [True, False])
def test_fit_contrastive_cross_writes_and_resumes(tree, tmp_path,
                                                  device_data):
    """``fit`` validates both segmenters and writes the dual-model names
    (the heads only in the full state, with their BatchNorm statistics);
    from the weak store, or from the host pipeline's resize-only
    transform; stopped at 2 and resumed to 4 == 4 in one run, bit for
    bit."""
    def run(out, steps):
        cfg = _cfg(tree, out, device_data=device_data)
        engine = TEngine(cfg, method=_NarrowCC(cfg), device="cpu")
        return cfg, engine, fit(cfg, engine=engine, max_steps=steps)
    _, _, straight = run(tmp_path / "a", 4)
    run(tmp_path / "b", 2)
    cfg, engine, resumed = run(tmp_path / "b", 4)
    assert (engine.store.mode == "weak") if device_data else \
        engine.store is None
    files = set(os.listdir(cfg.snapshot_path()))
    for name in ("model1_iter_4.ckpt", "model2_iter_4.ckpt",
                 "model_iter_4.ckpt"):
        assert name in files, name
    assert not any("ema" in f or "classifier" in f or "projector" in f
                   for f in files), files
    assert set(resumed["best_dice"]) == {"model1", "model2"}
    full = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                          "model_iter_4.ckpt"))
    assert set(full["state"]["models"]) == {"model1", "model2", *HEADS}
    assert set(full["state"]["optimizers"]) == {"model1", "model2"}
    ta, tb = (ckpt.state_tree(r["state"]) for r in (straight, resumed))
    for n in ta["models"]:
        for k, v in ta["models"][n].items():
            assert torch.equal(v, tb["models"][n][k]), (n, k)
    assert tb["models"]["projector1"]["conv_1.bn.running_mean"].any()


@pytest.mark.parametrize("argv", [
    ["--method", "contrastive_cross", "--model2", "unet"],
    ["--method", "adversarial_consistency"]])
def test_cli_trains_the_new_methods_on_the_cpu(tree, tmp_path, argv):
    """Full-width UNets through the CLI (SwinUnet-tiny needs 224^2: the
    card's run): ``get_method``, ``fit`` and the CLI take both methods."""
    result = tcli.main(["--root_path", tree, "--exp", "cli", *argv,
                        "--max_iterations", "2", "--batch_size", "4",
                        "--labeled_bs", "2", "--labeled_slices", "8",
                        "--patch_size", str(HW), str(HW), "--val_every", "2",
                        "--ckpt_every", "2", "--device", "cpu",
                        "--dtype", "float32", "--snapshot_root",
                        str(tmp_path)])
    assert result["iterations"] == 2
    files = set(os.listdir(os.path.join(tmp_path, "cli_7_labeled", "unet")))
    if argv[1] == "contrastive_cross":
        assert {"model1_iter_2.ckpt", "model2_iter_2.ckpt"} <= files
    else:
        assert {"iter_2.ckpt", "ema_model_iter_2.ckpt"} <= files
        assert set(result["best_dice"]) == {"model"}
