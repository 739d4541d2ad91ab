"""The CNN+ViT methods of the port (cross_teaching, cnn_meet_vit,
tripleview) against the JAX package on the CPU: one engine step of each
against JAX's step body with the same weights, batch and draws (the
SwinUnet's stochastic-depth masks and cnn_meet_vit's teacher noise,
recorded on the port's side and replayed into JAX), then ``fit`` (both
slots validated, the dual- and three-model checkpoint names, cnn_meet_vit's
teacher file, a bit-equal resume) and the CLI's flags.

The step comparison runs through ``test_torch_port_adversarial.py::
run_step`` at consistency weight 1 (step 30000, ``consistency=1.0``), so
the pseudo-supervision and teacher terms weigh in the gradients as much as
the supervised ones; JAX runs with ``s2d_loss="off"`` (its plain logits),
and cross_teaching once more on JAX's default grouped-logits path for the
SwinUnet slot."""
import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu.models import unet as junet
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.eval import val2d as tval2d
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import flax_from_state_dict
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
from test_torch_port_methods import B, C, FEATURES, MARGIN  # noqa: E402


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
# a thin SwinUnet for 32^2: token maps 8 (shifted windows, with the mask)
# and 4 (the window collapses); stochastic depth at the default 0.1
VIT = dict(embed_dim=24, depths=(2, 2), num_heads=(1, 2), window_size=4)
SLOTS = {"cross_teaching": {"model1": "unet", "model2": "swin_unet"},
         "cnn_meet_vit": {"model1": "unet", "model2": "swin_unet"},
         "tripleview": {"model1": "unet", "model2": "unet",
                        "model3": "swin_unet"}}
# kernel #1's launches a step: each model's labeled logits, once
LAUNCHES = {"cross_teaching": 2, "cnn_meet_vit": 2, "tripleview": 3}
# stochastic-depth masks a SwinUnet forward draws: two a block, every
# block but the first of stage 0 (encoder and decoder), whose rate is 0
VIT_MASKS = 2 * (sum(VIT["depths"]) + sum(VIT["depths"][1:]) - 2)
# JAX's grouped-logits SwinUnet path folds the final LayerNorm into the
# head with E[x^2] - E[x]^2 statistics per 16-group: the same values in
# another float32 order. Measured: loss and metrics within rel 1.7e-7 of
# the port on both JAX paths; bound rel 1e-5 on both
GROUPED_REL = 1e-5


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32),
            "label": rng.integers(0, C, (B, HW, HW)).astype(np.int32)}


def _jax_module(net):
    if net == "unet":
        return junet.UNet(in_chns=1, num_classes=C, features=FEATURES,
                          dropout=(0.0,) * 5)
    return jswin.SwinUnet(num_classes=C, **VIT)


def _port_module(net):
    if net == "unet":
        return tunet.UNet(1, C, features=FEATURES, dropout=(0.0,) * 5)
    return tswin.SwinUnet(num_classes=C, img_size=HW, **VIT)


def _step(method, seed=0, **cfg_kw):
    """``run_step`` of ``method``, with the port's student forwards'
    outputs recorded (for the argmax margins) and kernel #1's launches
    counted."""
    slots = SLOTS[method]
    outs, calls = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "forward", _spy(TStepCtx.forward, outs,
                                         lambda self, a: a[0]))
    mp.setattr(get_method(method, TConfig()).__class__, "sup_ce_dice",
               _spy(get_method(method, TConfig()).__class__.sup_ce_dice,
                    calls, lambda self, a: tuple(a[0].shape)))
    try:
        r = run_step(method, {n: _jax_module(t) for n, t in slots.items()},
                     lambda n: _port_module(slots[n]), _batch(seed),
                     seed=seed, nets=slots, **cfg_kw)
    finally:
        mp.undo()
    r["outs"], r["sup_calls"] = outs, calls
    return r


@pytest.fixture(scope="module", params=sorted(SLOTS))
def vit_step(request):
    return request.param, _step(request.param, s2d_loss="off")


def test_vit_method_loss_and_metrics_match_jax_step(vit_step):
    name, r = vit_step
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_weight"]) == 1.0


def _assert_grads_match(name, r):
    """Each slot's gradients against JAX's, at the cross-framework
    tolerance of ``_assert_tree_close``."""
    (want,) = r["jgrads"]
    assert set(want) == set(SLOTS[name])
    for n, net in SLOTS[name].items():
        model = r["tstate"].models[n]
        grads = {k: p.grad for k, p in model.named_parameters()}
        grads.update({k: torch.zeros_like(b)
                      for k, b in model.named_buffers()})
        _assert_tree_close(flax_from_state_dict(net, grads)[0], want[n])


def test_vit_method_gradients_match_jax(vit_step):
    _assert_grads_match(*vit_step)


def test_vit_method_updates_match_jax(vit_step):
    """Every model after SGD, cnn_meet_vit's EMA teacher of model2, each
    element within 2e-2 of the largest delta from the initial weights plus
    float32 rounding; the UNets' BatchNorm buffers."""
    name, r = vit_step
    js, ts = r["jstate"], r["tstate"]
    pairs = [(js.params[n], ts.models[n], n) for n in SLOTS[name]]
    pairs += [(js.teacher_params[n], ts.teachers[n], n)
              for n in js.teacher_params]
    assert set(ts.teachers) == set(js.teacher_params) == (
        {"model2"} if name == "cnn_meet_vit" else set())
    for want, got, slot in pairs:
        net = SLOTS[name][slot]
        got_p = flax_from_state_dict(net, {k: v.detach() for k, v in
                                           got.state_dict().items()})[0]
        deltas = [np.asarray(a) - np.asarray(b) for a, b in zip(
            jax.tree_util.tree_leaves(want),
            jax.tree_util.tree_leaves(r["p0"][slot]))]
        scale = max(float(np.abs(d).max()) for d in deltas)
        assert scale > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
        if net == "unet":
            got_bs = flax_from_state_dict("unet", got.state_dict())[1]
            want_bs = (js.teacher_batch_stats if got is ts.teachers.get(slot)
                       else js.batch_stats)[slot]
            for a, b in zip(jax.tree_util.tree_leaves(want_bs),
                            jax.tree_util.tree_leaves(got_bs)):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                           atol=1e-5)
    assert {n: o.count for n, o in ts.optimizers.items()} == {
        n: 1 for n in SLOTS[name]}


def test_vit_method_draws_margins_and_kernel_calls(vit_step):
    """The draws: cnn_meet_vit's teacher noise, then the SwinUnet's
    stochastic-depth masks of each forward (the student's; cnn_meet_vit's
    teacher runs in train mode too, as in JAX, so it draws its own). Every
    pseudo-label is at least MARGIN from a tie in its softmax, so the argmax
    cannot flip between the frameworks. ``sup_ce_dice`` (kernel #1 on the
    card) once for each model's labeled logits."""
    name, r = vit_step
    kinds = [k for k, _ in r["draws"].log]
    vit_forwards = 2 if name == "cnn_meet_vit" else 1
    assert kinds == (["normal"] if name == "cnn_meet_vit" else []) + \
        ["keep"] * (VIT_MASKS * vit_forwards)
    masks = r["draws"].of("keep")
    assert any(not k.all() for k in masks)
    assert [slot for slot, _ in r["outs"]] == list(SLOTS[name])
    for _, out in r["outs"]:
        soft = torch.softmax(out.detach()[2:].float(), dim=1)
        top2 = soft.topk(2, dim=1).values
        assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
    assert [shape for shape, _ in r["sup_calls"]] == \
        [(2, C, HW, HW)] * LAUNCHES[name]


def test_cross_teaching_matches_jax_grouped_logits_path():
    """JAX's default for cross_teaching runs the SwinUnet slot on grouped
    (B, H/4, W/4, 16, C) logits with labels re-indexed: the same values in
    another float32 order: loss and metrics within GROUPED_REL, gradients
    at the cross-framework tolerance."""
    r = _step("cross_teaching", s2d_loss="auto")
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t)
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=GROUPED_REL), k
    _assert_grads_match("cross_teaching", r)


# ---------------------------------------------------------------------------
# fit and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic ACDC tree: 64^2 slices, 8 cases x 4 slices, 2 val
    volumes."""
    return tsyn.make_synthetic_acdc(str(tmp_path_factory.mktemp("acdc")
                                        / "ACDC"))


def _cfg(root, snapshot_root, **kw):
    base = dict(root_path=root, exp="ACDC/vit", method="cross_teaching",
                model="unet", model2="swin_unet", vit_kwargs=VIT,
                num_classes=C, batch_size=4, labeled_bs=2,
                labeled_slices_override=8, patch_size=(HW, HW),
                dtype="float32", max_iterations=100, val_every=2,
                ckpt_every=2, log_every=1, snapshot_root=str(snapshot_root))
    base.update(kw)
    return TConfig(**base)


def _fit(cfg, steps):
    """``cfg.method`` with narrow UNets and the ``vit_kwargs`` SwinUnet
    that the method's own factory builds."""
    cls = type(get_method(cfg.method, cfg))

    class Narrow(cls):
        def _factory(self, net_type):
            if net_type == "unet":
                return net_factory("unet", 1, C, features=FEATURES)
            return super()._factory(net_type)
    engine = TEngine(cfg, method=Narrow(cfg), device="cpu")
    return fit(cfg, engine=engine, max_steps=steps)


def test_fit_cross_teaching_validates_both_slots_and_writes_their_names(
        tree, tmp_path, monkeypatch):
    """Each validation runs model1 at the patch size and model2 at
    ``patch_size2`` (JAX ``Engine.validate``); the weights files carry the
    slot prefixes, ``{model}_best_{slot}`` is written for a slot whose Dice
    rose above 0, and there are no EMA files."""
    sizes = []
    evaluate = tval2d.evaluate

    def spy(dataset, predict, classes, size):
        sizes.append(tuple(size))
        return evaluate(dataset, predict, classes, size)
    monkeypatch.setattr(tval2d, "evaluate", spy)
    cfg = _cfg(tree, tmp_path, patch_size2=(64, 64), seed=1)
    result = _fit(cfg, 4)
    assert sizes == [(HW, HW), (64, 64)] * 2
    assert isinstance(result["state"].models["model2"], tswin.SwinUnet)
    files = set(os.listdir(cfg.snapshot_path()))
    for name in ("model1_iter_2.ckpt", "model2_iter_2.ckpt",
                 "model1_iter_4.ckpt", "model2_iter_4.ckpt",
                 "model_iter_2.ckpt", "model_iter_4.ckpt"):
        assert name in files, name
    assert not any("ema" in f for f in files), files
    assert not any(f.startswith("iter_") for f in files), files
    assert set(result["best_dice"]) == {"model1", "model2"}
    for slot, dice in result["best_dice"].items():
        assert (f"unet_best_{slot}.ckpt" in files) == (dice > 0.0)
    assert any(d > 0.0 for d in result["best_dice"].values())
    full = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                          "model_iter_4.ckpt"))
    assert set(full["state"]["optimizers"]) == {"model1", "model2"}


def test_fit_cnn_meet_vit_writes_its_teacher_and_tripleview_three_slots(
        tree, tmp_path):
    """cnn_meet_vit's EMA teacher of model2 as ``model2_ema_model_iter_{k}``
    (JAX ``engine.py:733-743``); tripleview's three slots, each validated
    and written under its prefix."""
    cfg = _cfg(tree, tmp_path / "mv", method="cnn_meet_vit")
    result = _fit(cfg, 2)
    files = set(os.listdir(cfg.snapshot_path()))
    assert {"model1_iter_2.ckpt", "model2_iter_2.ckpt",
            "model2_ema_model_iter_2.ckpt"} <= files
    assert sum("ema" in f for f in files) == 1
    teacher = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                             "model2_ema_model_iter_2.ckpt"))
    assert set(teacher) == set(result["state"].teachers["model2"]
                               .state_dict())

    cfg = _cfg(tree, tmp_path / "tv", method="tripleview")
    result = _fit(cfg, 2)
    files = set(os.listdir(cfg.snapshot_path()))
    assert {f"model{i}_iter_2.ckpt" for i in (1, 2, 3)} <= files
    assert set(result["best_dice"]) == {"model1", "model2", "model3"}
    assert isinstance(result["state"].models["model3"], tswin.SwinUnet)
    assert not any("ema" in f for f in files)


@pytest.mark.parametrize("method", ["cross_teaching", "cnn_meet_vit"])
def test_fit_resume_is_bit_equal_for_vit_methods(tree, tmp_path, method):
    """Stopped at 2 and resumed to 4 == 4 in one run, bit for bit: every
    model, cnn_meet_vit's teacher, each optimizer's state and count, and
    the generator (the stochastic depth and the teacher noise draw from
    it)."""
    straight = _fit(_cfg(tree, tmp_path / "a", method=method), 4)
    cfg = _cfg(tree, tmp_path / "b", method=method)
    _fit(cfg, 2)
    resumed = _fit(cfg, 4)
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        assert "resumed from iteration 2" in f.read()
    assert straight["best_dice"] == resumed["best_dice"]
    ta, tb = (ckpt.state_tree(r["state"]) for r in (straight, resumed))
    assert ta["step"] == tb["step"] == 4
    for group in ("models", "teachers"):
        assert set(ta[group]) == set(tb[group])
        for n in ta[group]:
            for k, v in ta[group][n].items():
                assert torch.equal(v, tb[group][n][k]), (group, n, k)
    for n, oa in ta["optimizers"].items():
        ob = tb["optimizers"][n]
        assert oa["count"] == ob["count"] == 4
        for i, st in oa["state"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, ob["state"]["state"][i][k]), (n, k)
    assert torch.equal(ta["generator"], tb["generator"])


def test_cli_takes_the_vit_methods(tree, tmp_path):
    """``--method cross_teaching --model2 swin_unet`` (and the other two)
    parse into the config that ``fit`` trains; the CLI has no ``vit_kwargs``
    flag (nor has JAX's), so the run itself goes through ``fit`` with a
    thin SwinUnet, as a full-width SwinUnet is a card run."""
    parser = tcli.build_parser()
    for method in SLOTS:
        assert method in parser.format_help()
    args = parser.parse_args(
        ["--root_path", tree, "--exp", "cli", "--method", "cross_teaching",
         "--model2", "swin_unet", "--max_iterations", "2",
         "--batch_size", "4", "--labeled_bs", "2", "--labeled_slices", "8",
         "--patch_size", str(HW), str(HW), "--val_every", "2",
         "--ckpt_every", "2", "--device", "cpu", "--dtype", "float32",
         "--snapshot_root", str(tmp_path)])
    cfg = tcli.config_from_args(args)
    assert (cfg.method, cfg.model, cfg.model2) == ("cross_teaching", "unet",
                                                   "swin_unet")
    result = fit(dataclasses.replace(cfg, vit_kwargs=VIT), device="cpu")
    assert result["iterations"] == 2
    files = set(os.listdir(os.path.join(tmp_path, "cli_7_labeled", "unet")))
    assert {"model1_iter_2.ckpt", "model2_iter_2.ckpt"} <= files
