"""North-star config 3 on the port (SwinUnet, 2 classes): one engine step
of ``uamt`` and of ``supervised`` on a thin 2-class SwinUnet at
224-style windows (window 7, token maps 14 and 7), held against JAX's step
body with the same weights, batch and draws (the teacher noise and every
stochastic-depth mask, recorded on the port's side and replayed into JAX).

uamt's Monte-Carlo teacher branches on whether the teacher holds batch
statistics (JAX ``uamt.py:45-76``): the SwinUnet normalises with
LayerNorm, so its T passes run as one T * u batch, and stochastic depth
draws one mask per block over those T * u samples; the UNet keeps its
scan of T / 2 passes of 2u (``test_torch_port_methods.py``).

The comparison runs through ``test_torch_port_adversarial.py::run_step``
at consistency weight 1 (step 30000, ``consistency=1.0``), with the
SwinUnet's 1x1 head scaled by 8 so that the MC teacher is sure at some
sites, and ``max_iterations`` such that the entropy threshold is below
ln 2: the masked consistency term is live, and masks some sites."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import flax_from_state_dict
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.methods import uamt as tuamt
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_adversarial import _spy, run_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# config 3: Prostate's 2 classes; SwinUnet-tiny's windows at 224^2 are 7
# on token maps 56, 28, 14, 7: here maps 14 (shifted windows, with the
# mask) and 7 (the window collapses, no shift)
C, HW, B, LB, T = 2, 56, 4, 2, 8
VIT = dict(embed_dim=24, depths=(2, 2), num_heads=(1, 2), window_size=7)
# stochastic-depth masks a SwinUnet forward draws: two a block, every
# block but the first of stage 0 (encoder and decoder), whose rate is 0
VIT_MASKS = 2 * (sum(VIT["depths"]) + sum(VIT["depths"][1:]) - 2)
METHODS = ("uamt", "supervised")
# uamt's entropy threshold ramps on step / max_iterations up to ln 2, the
# largest entropy of 2 classes, where every site would pass: at step 30000
# of 300000 it is 0.75 ln 2 + 0.4%, so the mask keeps some sites and not
# others
MAX_ITERATIONS = 300_000
# the entropy of a site is in [0, ln 2]: float32 rounding moves it by
# ~1e-7; every site must be 10x that from the threshold
UNC_MARGIN = 1e-6


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, C, (B, HW, HW)).astype(np.int32)}


def _run(method):
    """One step of ``method`` in both packages; the port's teacher passes
    (their kind, batch shape and output) and kernel #1's calls are
    recorded."""
    cls = type(get_method(method, TConfig()))
    passes, calls = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "forward_teacher", _spy(
        TStepCtx.forward_teacher, passes,
        lambda self, a: ("pass", tuple(a[1].shape))))
    mp.setattr(TStepCtx, "forward_teacher_scan", _spy(
        TStepCtx.forward_teacher_scan, passes,
        lambda self, a: ("scan", tuple(a[1].shape))))
    mp.setattr(cls, "sup_ce_dice", _spy(
        cls.sup_ce_dice, calls, lambda self, a: tuple(a[0].shape)))
    try:
        r = run_step(method, {"model": jswin.SwinUnet(num_classes=C, **VIT)},
                     lambda n: tswin.SwinUnet(num_classes=C, img_size=HW,
                                              **VIT),
                     _batch(3), seed=3, nets={"model": "swin_unet"},
                     num_classes=C, patch_size=(HW, HW), uncertainty_T=T,
                     max_iterations=MAX_ITERATIONS)
    finally:
        mp.undo()
    r["passes"], r["sup_calls"] = passes, calls
    return r


@pytest.fixture(scope="module", params=METHODS)
def swin_step(request):
    return request.param, _run(request.param)


def test_swin_method_loss_and_metrics_match_jax_step(swin_step):
    name, r = swin_step
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    if name == "uamt":
        assert float(j["consistency_weight"]) == 1.0
        # the mask keeps some sites and drops others: the term is live
        assert 0.0 < float(t["uncertainty_mask_frac"]) < 1.0
        assert float(t["consistency_loss"]) > 0.0


def test_swin_method_gradients_match_jax_step(swin_step):
    _, r = swin_step
    (want,) = r["jgrads"]
    model = r["tstate"].models["model"]
    grads = {k: p.grad for k, p in model.named_parameters()}
    grads.update({k: torch.zeros_like(b) for k, b in model.named_buffers()})
    _assert_tree_close(flax_from_state_dict("swin_unet", grads)[0],
                       want["model"])


def test_swin_method_update_and_ema_teacher_match_jax_step(swin_step):
    """The SwinUnet after SGD, and uamt's EMA teacher (decay 0.99 at step
    30000), each element within 2e-2 of the largest delta from the initial
    weights plus float32 rounding."""
    name, r = swin_step
    js, ts = r["jstate"], r["tstate"]
    pairs = [(js.params["model"], ts.models["model"])]
    if name == "uamt":
        pairs.append((js.teacher_params["model"], ts.teachers["model"]))
    assert set(ts.teachers) == set(js.teacher_params) == (
        {"model"} if name == "uamt" else set())
    for want, got in pairs:
        got_p = flax_from_state_dict("swin_unet", {
            k: v.detach() for k, v in got.state_dict().items()})[0]
        deltas = [np.asarray(a) - np.asarray(b) for a, b in zip(
            jax.tree_util.tree_leaves(want),
            jax.tree_util.tree_leaves(r["p0"]["model"]))]
        scale = max(float(np.abs(d).max()) for d in deltas)
        assert scale > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
    assert ts.optimizers["model"].count == 1


def test_swin_method_teacher_passes_and_draws(swin_step):
    """uamt's teacher on a stats-free SwinUnet: the consistency-target
    pass over u samples, then ONE pass over the T * u tiled batch (no
    scan), each drawing its own stochastic-depth masks over its batch;
    the draws in JAX's order: the teacher noise, the student's masks, the
    MC noise, the two teacher passes' masks. Kernel #1 once, on the
    labeled logits."""
    name, r = swin_step
    u = B - LB
    shapes = [(k, tuple(v.shape)) for k, v in r["draws"].log]
    student = [("keep", (B, 1, 1, 1))] * VIT_MASKS
    if name == "supervised":
        assert r["passes"] == []
        assert shapes == student
    else:
        assert [p for p, _ in r["passes"]] == [
            ("pass", (u, 1, HW, HW)), ("pass", (T * u, 1, HW, HW))]
        assert shapes == ([("normal", (u, 1, HW, HW))] + student
                          + [("normal", (T * u, 1, HW, HW))]
                          + [("keep", (u, 1, 1, 1))] * VIT_MASKS
                          + [("keep", (T * u, 1, 1, 1))] * VIT_MASKS)
    masks = r["draws"].of("keep")
    assert any(not k.all() for k in masks)
    # supervised trains on the whole batch, uamt on its labeled part
    labeled = B if name == "supervised" else LB
    assert [s for s, _ in r["sup_calls"]] == [(labeled, C, HW, HW)]


def test_uamt_swin_mask_decisions_match_jax(swin_step):
    """The consistency mask keeps as many sites as JAX's (the fraction
    times the site count, exactly), and the port's MC uncertainty at
    every unlabeled site is at least UNC_MARGIN from the entropy threshold
    (recomputed from the teacher's recorded MC logits), so no site sits
    where float32 rounding could flip it; supervised has no teacher."""
    name, r = swin_step
    if name == "supervised":
        assert r["tstate"].teachers == {}
        return
    u = B - LB
    sites = u * HW * HW
    kept = {k: float(m["uncertainty_mask_frac"]) * sites
            for k, m in (("port", r["tmetrics"]), ("jax", r["jmetrics"]))}
    assert round(kept["port"]) == round(kept["jax"])
    assert 0 < round(kept["port"]) < sites
    (mc_logits,) = [out for (_, shape), out in r["passes"]
                    if shape[0] == T * u]
    preds = torch.softmax(mc_logits.float(), dim=1)
    preds = preds.reshape((T, u) + preds.shape[1:]).mean(dim=0)
    unc = -torch.sum(preds * torch.log(preds + 1e-6), dim=1)
    method = get_method("uamt", TConfig(method="uamt", num_classes=C,
                                        max_iterations=MAX_ITERATIONS))
    gap = (unc - method.threshold(r["tstate"].step - 1)).abs()
    assert float(gap.min()) > UNC_MARGIN


@pytest.mark.parametrize("net,bn", [("swin_unet", False), ("unet", True)])
def test_has_batch_stats_decides_the_teacher_branch(net, bn):
    """The UNet's BatchNorm holds running statistics, SwinUnet's LayerNorm
    none: the port's counterpart of JAX's ``teacher_stats`` test."""
    model = (tswin.SwinUnet(num_classes=C, img_size=HW, **VIT)
             if net == "swin_unet" else tunet.UNet(1, C))
    assert tuamt.has_batch_stats(model) is bn
