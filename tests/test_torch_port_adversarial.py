"""The port's adversarial path against the JAX package on the CPU:
``FCDiscriminator`` (forward in train and eval mode, channel dropout on
injected masks, the classifier's flatten order, the converter, parameter
counts), the discriminator's Adam, one engine step of ``adversarial`` and
``exam_student_teacher`` against JAX's two-phase step body, and the
per-family compute dtype (``TrainConfig.model_dtype``).

The step comparison runs as ``test_torch_port_methods.py``'s: the port's
step first, with every draw (exam's teacher noise, the discriminator's
channel-dropout masks) replaced by recorded numpy values; then JAX's step
body on the same values through patched ``jax.random.*``. Each of JAX's two
``jax.value_and_grad`` calls (generator phase, discriminator phase) also
returns its gradients, so the port's segmenter gradients are held against
the first and the discriminator's against the second."""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvssl_tpu.models import discriminator as jdisc
from cvssl_tpu.models import unet as junet
from cvssl_tpu.models.torch_convert import convert_discriminator2d_checkpoint
from cvssl_tpu.ops import schedules as jschedules
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.models import discriminator as tdisc
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import schedules as tschedules
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_methods import (B, C, CFG, FEATURES,  # noqa: E402
                                     MARGIN, STEP, _Draws, _np_tree,
                                     _patch_jax, _patch_port,
                                     _scale_out_conv)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NDF = 8
# full width: ndf 64, 4 classes, one image channel, 256^2 (a 2 x 2 pooled
# map of 512 channels: the classifier takes 2048 inputs)
FULL_WIDTH_PARAMS = 2_762_754


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


# ---------------------------------------------------------------------------
# FCDiscriminator
# ---------------------------------------------------------------------------

def _flax_dan(hw, seed=0, drop=0.5):
    m = jdisc.FCDiscriminator(num_classes=C, ndf=NDF, drop=drop)
    v = jax.jit(lambda k, s, x: m.init(k, s, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, C)),
        jnp.zeros((1, hw, hw, 1)))
    return m, jax.tree_util.tree_map(np.asarray, v["params"])


def _port_dan(params, hw, drop=0.5):
    t = tdisc.FCDiscriminator(C, 1, ndf=NDF, drop=drop, patch_size=(hw, hw))
    t.load_state_dict(state_dict_from_flax("discriminator", params, {}),
                      strict=True)
    return t


def _dan_inputs(hw, seed=1, b=3):
    rng = np.random.default_rng(seed)
    soft = rng.dirichlet(np.ones(C), size=(b, hw, hw)).astype(np.float32)
    image = rng.normal(0.5, 0.25, (b, hw, hw, 1)).astype(np.float32)
    return soft, image


@pytest.mark.parametrize("hw,pooled", [(224, 2), (256, 2), (32, 1),
                                       (48, 1)])
def test_discriminator_forward_matches_flax(hw, pooled, monkeypatch):
    """Train mode on injected channel-dropout masks, and eval mode. At 224^2
    and 256^2 the pooled map is 2 x 2, so a classifier that read the
    flatten in another order than its rows would disagree; at 32^2 and 48^2
    the pool window is clamped to the 2^2 and 3^2 map."""
    assert tdisc.pooled_size((hw, hw)) == (pooled, pooled)
    m, params = _flax_dan(hw)
    soft, image = _dan_inputs(hw)
    t = _port_dan(params, hw)
    draws = _Draws(3)
    with monkeypatch.context() as mp:
        _patch_port(mp, draws)
        got_train = t.train()(_nchw(soft), _nchw(image))
    masks = draws.of("keep")
    assert [k.shape for k in masks] == [(3, 2 * NDF, 1, 1),
                                        (3, 4 * NDF, 1, 1)]
    assert all(k.any() and not k.all() for k in masks)

    def apply(p, s, x):
        draws.cursor = 0
        return m.apply({"params": p}, s, x, train=True,
                       rngs={"dropout": jax.random.PRNGKey(0)})
    with monkeypatch.context() as mp:
        _patch_jax(mp, draws)
        want_train = jax.jit(apply)(params, soft, image)
    assert draws.cursor == 2
    with torch.no_grad():
        got_eval = t.eval()(_nchw(soft), _nchw(image))
    want_eval = m.apply({"params": params}, soft, image, train=False)
    for got, want in ((got_train, want_train), (got_eval, want_eval)):
        want = np.asarray(want)
        assert got.shape == want.shape == (3, 2)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_classifier_reads_the_nchw_flatten():
    """The port's classifier is the reference's (NCHW flatten); its rows
    are JAX's Dense rows reordered, as JAX's own converter from the
    reference does: both directions, at a 2 x 2 pooled map."""
    _, params = _flax_dan(224)
    sd = state_dict_from_flax("discriminator", params, {})
    np_sd = {k: v.numpy() for k, v in sd.items()}
    want = convert_discriminator2d_checkpoint(np_sd, ndf=NDF)
    for name, leaf in params.items():
        for k in leaf:
            np.testing.assert_array_equal(want[name][k], leaf[k])
    back = flax_from_state_dict("discriminator", sd)[0]
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    # the reorder is not the identity at 2 x 2
    dense = params["Dense_0"]["kernel"]
    assert not np.array_equal(sd["classifier.weight"].numpy(), dense.T)
    with pytest.raises(ValueError, match="square"):
        flax_from_state_dict("discriminator", {
            **sd, "classifier.weight": torch.zeros(2, 8 * NDF * 2)})


def test_channel_dropout_is_flax_broadcast_dropout():
    x = np.random.default_rng(5).normal(size=(2, 6, 5, 4)).astype(np.float32)
    keep = np.random.default_rng(6).random((2, 6, 1, 1)) < 0.5
    got = tdisc.channel_dropout(torch.from_numpy(x), torch.from_numpy(keep),
                                0.5)
    want = np.where(keep, x / 0.5, 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_discriminator_full_width_and_factory():
    t = net_factory("discriminator", 1, 4, patch_size=(256, 256))
    assert t.classifier.in_features == 2048
    n = sum(p.numel() for p in t.parameters())
    assert n == FULL_WIDTH_PARAMS
    m = jdisc.FCDiscriminator(num_classes=4)
    shapes = jax.eval_shape(
        lambda k: m.init(k, jnp.zeros((1, 256, 256, 4)),
                         jnp.zeros((1, 256, 256, 1)), train=False),
        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape)) for a in
                    jax.tree_util.tree_leaves(shapes["params"]))


def test_discriminator_adam_matches_optax():
    """Five updates of random gradients: the port's Adam against
    ``discriminator_adam``'s optax chain, and its ``count``."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=p0.shape).astype(np.float32) for _ in range(5)]
    tx = jschedules.discriminator_adam(3e-3)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = tschedules.DiscriminatorAdam([w], 3e-3)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
        w.grad = torch.from_numpy(g)
        opt.step()
    assert opt.count == 5
    # float32 rounding of the weights (|w| < 4): the two take the same
    # step in another order of operations
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# one engine step against JAX's two-phase step body
# ---------------------------------------------------------------------------

ADV_METHODS = ("adversarial", "exam_student_teacher")
OUT_SCALE = 8.0    # segmenter output conv: the dan sees sure softmax maps
# the end of the consistency ramp (sigmoid_rampup(200, 200) = 1): with
# consistency 1 the weight w is 1, so a discriminator gradient left from
# the generator phase would be as large as the discriminator phase's
FULL_STEP = 30000


def _spy(method, log, key):
    """``method`` that also appends (key(self, args), output) to ``log``."""
    def spy(self, *a, **k):
        out = method(self, *a, **k)
        log.append((key(self, a), out))
        return out
    return spy


def _capture_each_grads(mp):
    """Every ``jax.value_and_grad`` of the step body also returns its
    gradients in its metrics, under ``_grads0``, ``_grads1``, ... in the
    order the body makes them (generator phase, discriminator phase)."""
    orig = jax.value_and_grad
    made = []

    def value_and_grad(fn, *a, has_aux=False, **k):
        inner = orig(fn, *a, has_aux=has_aux, **k)
        tag = f"_grads{len(made)}"
        made.append(tag)

        def call(*args, **kw):
            (loss, aux), grads = inner(*args, **kw)
            metrics, *rest = aux
            return (loss, ({**metrics, tag: grads}, *rest)), grads
        return call
    mp.setattr(jax, "value_and_grad", value_and_grad)
    return made


def _scale_head(net, params, factor):
    """``params`` of a ``net`` with its output layer scaled by ``factor``
    (a UNet's output conv, a SwinUnet's 1x1 head), else as they are."""
    if net == "unet":
        return _scale_out_conv(params, factor)
    if net == "swin_unet":
        p = jax.tree_util.tree_map(np.array, params)
        p["output"]["kernel"] *= factor
        return p
    return params


def run_step(method_name, jmodules, port_models, batch, seed=0,
             scale=OUT_SCALE, step=FULL_STEP, consistency=1.0, nets=None,
             **cfg_kw):
    """One step ``step`` of ``method_name`` in both packages from JAX's
    initial weights (each segmenter's output layer scaled by ``scale``):
    ``jmodules`` are the Flax modules by slot, ``port_models`` a function
    of the slot giving the port's module, ``batch`` NHWC numpy arrays,
    ``nets`` the net type of each slot (default: the segmenter ``model`` a
    UNet, ``dan`` the discriminator), ``cfg_kw`` more fields of both
    configs. Returns both states, metrics and gradients, and the port's
    draws. The defaults put the consistency weight at 1: the unsupervised
    terms weigh in the gradients as much as the supervised ones."""
    net = nets or {"model": "unet", "dan": "discriminator"}
    cfg = {**CFG, "consistency": consistency, **cfg_kw}
    jcfg = JConfig(method=method_name, **cfg)
    jeng = JEngine(jcfg)
    jeng.modules = jmodules
    state = jeng.init_state(jax.random.PRNGKey(seed), batch)
    state = state.replace(step=jnp.int32(step))
    params = {n: _scale_head(net[n], p, scale)
              for n, p in state.params.items()}
    state = state.replace(params=params, teacher_params={
        n: copy.deepcopy(params[n]) for n in state.teacher_params})
    p0 = _np_tree(state.params)
    bs0 = _np_tree(state.batch_stats)

    tcfg = TConfig(method=method_name, **cfg)

    class Narrow(type(get_method(method_name, tcfg))):
        def build_models(self):
            return {n: port_models(n) for n in jmodules}
    teng = TEngine(tcfg, method=Narrow(tcfg), device="cpu")
    tstate = teng.init_state()
    for n in jmodules:
        sd = state_dict_from_flax(net[n], p0[n], bs0.get(n, {}))
        tstate.models[n].load_state_dict(sd)
        if n in tstate.teachers:
            tstate.teachers[n].load_state_dict(sd)
    tstate.step = step
    draws = _Draws(seed)
    dan_out = []
    forward = tdisc.FCDiscriminator.forward
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    mp.setattr(tdisc.FCDiscriminator, "forward",
               _spy(forward, dan_out, lambda self, a: self.training))
    try:
        tbatch = {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy()
                                      if v.ndim == 4 else v)
                  for k, v in batch.items()}
        tstate, tmetrics = teng.train_step(tstate, tbatch)
    finally:
        mp.undo()

    body = jeng._build_train_step_body()

    def step(s, b):
        draws.cursor = 0
        return body(s, b)
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    tags = _capture_each_grads(mp)
    try:
        new_state, jmetrics = jax.jit(step)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        mp.undo()
    assert draws.cursor == len(draws.log)
    jgrads = [jmetrics.pop(t) for t in tags]
    return dict(p0=p0, jstate=new_state, jmetrics=jmetrics, jgrads=jgrads,
                tstate=tstate, tmetrics=tmetrics, draws=draws,
                dan_out=dan_out, nets=net)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0.5, 0.25, (B, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, C, (B, 32, 32)).astype(np.int32)}


@pytest.fixture(scope="module", params=ADV_METHODS)
def adv_pair(request):
    jmods = {"model": junet.UNet(in_chns=1, num_classes=C, features=FEATURES,
                                 dropout=(0.0,) * 5),
             "dan": jdisc.FCDiscriminator(num_classes=C, ndf=NDF)}

    def port(slot):
        if slot == "model":
            return tunet.UNet(1, C, features=FEATURES, dropout=(0.0,) * 5)
        return tdisc.FCDiscriminator(C, 1, ndf=NDF, patch_size=(32, 32))
    return request.param, run_step(request.param, jmods, port, _batch(0))


def test_adversarial_loss_and_metrics_match_jax_step(adv_pair):
    name, r = adv_pair
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_weight"]) == 1.0
    assert {"loss_d", "dan_acc"} <= set(t)


def test_adversarial_gradients_match_jax_phases(adv_pair):
    """The segmenter's gradients are the generator phase's; the
    discriminator's are the discriminator phase's alone (none kept from the
    generator phase, which JAX does not differentiate w.r.t. them)."""
    name, r = adv_pair
    g_phase, d_phase = r["jgrads"]
    assert set(g_phase) == {"model"} and set(d_phase) == {"dan"}
    for n, want in (("model", g_phase["model"]), ("dan", d_phase["dan"])):
        model = r["tstate"].models[n]
        grads = {k: p.grad for k, p in model.named_parameters()}
        grads.update({k: torch.zeros_like(b)
                      for k, b in model.named_buffers()})
        _assert_tree_close(flax_from_state_dict(r["nets"][n], grads)[0],
                           want)


def _adam_first_step_bound(g_port, g_jax, lr, eps=1e-8):
    """Per element, how far apart the first Adam steps lr g / (|g| + eps)
    of the two gradients can be: |g_port - g_jax| times the largest slope
    of g / (|g| + eps) between them, eps / (m + eps)^2, where m is the
    smaller magnitude if the two have one sign and 0 otherwise."""
    same = np.sign(g_port) == np.sign(g_jax)
    m = np.where(same, np.minimum(np.abs(g_port), np.abs(g_jax)), 0.0)
    return lr * np.abs(g_port - g_jax) * eps / (m + eps) ** 2


def test_adversarial_updates_match_jax_step(adv_pair):
    """The segmenter after SGD and exam's EMA teacher, each element within
    2e-2 of the largest delta from the initial weights plus float32
    rounding; the discriminator after Adam within the first Adam step's
    sensitivity to the gradients' cross-framework difference (the step is
    lr g / (|g| + eps): flat where |g| >> eps, steep where |g| ~ eps) plus
    1e-3 lr; and the BatchNorm buffers."""
    name, r = adv_pair
    js, ts = r["jstate"], r["tstate"]
    pairs = [(js.params["model"], ts.models["model"])]
    if name == "exam_student_teacher":
        pairs.append((js.teacher_params["model"], ts.teachers["model"]))
    for want, got in pairs:
        got_p = flax_from_state_dict("unet", {k: v.detach() for k, v in
                                              got.state_dict().items()})[0]
        deltas = [np.asarray(a) - np.asarray(b) for a, b in zip(
            jax.tree_util.tree_leaves(want),
            jax.tree_util.tree_leaves(r["p0"]["model"]))]
        scale = max(float(np.abs(d).max()) for d in deltas)
        assert scale > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
    dan = ts.models["dan"]
    lr = ts.optimizers["dan"].defaults["lr"]
    got_p = flax_from_state_dict("discriminator", {
        k: v.detach() for k, v in dan.state_dict().items()})[0]
    got_g = flax_from_state_dict("discriminator", {
        k: p.grad for k, p in dan.named_parameters()})[0]
    leaves = jax.tree_util.tree_leaves
    for want, got, p0, gp, gj in zip(
            leaves(js.params["dan"]), leaves(got_p), leaves(r["p0"]["dan"]),
            leaves(got_g), leaves(r["jgrads"][1]["dan"])):
        want, gj = np.asarray(want, np.float64), np.asarray(gj, np.float64)
        step = np.abs(want - p0)
        assert float(step.max()) == pytest.approx(lr, rel=1e-3)
        bound = (_adam_first_step_bound(gp.astype(np.float64), gj, lr)
                 + 1e-3 * lr + 1e-6 * np.abs(want))
        assert bool((np.abs(got - want) <= bound).all()), float(
            (np.abs(got - want) - bound).max())
    assert {n: o.count for n, o in ts.optimizers.items()} == {"model": 1,
                                                              "dan": 1}
    assert isinstance(ts.optimizers["dan"], tschedules.DiscriminatorAdam)
    assert set(ts.teachers) == set(js.teacher_params)
    want_bs = [(js.batch_stats["model"], ts.models["model"])]
    if ts.teachers:
        want_bs.append((js.teacher_batch_stats["model"],
                        ts.teachers["model"]))
    for want, got in want_bs:
        got_bs = flax_from_state_dict("unet", got.state_dict())[1]
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_bs)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                       atol=1e-5)


def test_adversarial_draws_and_dan_decisions(adv_pair):
    """The draws: exam's teacher noise, then the discriminator phase's two
    channel-dropout masks (the generator phase's discriminator runs in eval
    mode, without dropout). The discriminator's verdicts are each at least
    MARGIN from a tie, so ``dan_acc`` cannot flip between the frameworks."""
    name, r = adv_pair
    kinds = [k for k, _ in r["draws"].log]
    assert kinds == (["normal"] if name == "exam_student_teacher"
                     else []) + ["keep", "keep"]
    modes = [training for training, _ in r["dan_out"]]
    assert modes == [False, True]
    _, d_out = r["dan_out"][1]
    gap = (d_out[:, 0] - d_out[:, 1]).detach().abs()
    assert float(gap.min()) > MARGIN


# ---------------------------------------------------------------------------
# the compute dtype of each net (JAX TrainConfig.model_kwargs)
# ---------------------------------------------------------------------------

DTYPE_CASES = [("cct", "unet"), ("urpc", "unet"), ("supervised", "unet_ds"),
               ("supervised", "unet_feature"), ("adversarial", "unet"),
               ("supervised", "unet")]


def _dtype_step(method, model, dtype):
    cfg = TConfig(**{**CFG, "method": method, "model": model,
                     "dtype": dtype})

    class Narrow(type(get_method(method, cfg))):
        def _factory(self, net_type):
            return net_factory(net_type, 1, C, features=FEATURES)
    engine = TEngine(cfg, method=Narrow(cfg), device="cpu")
    state = engine.init_state()
    state.step = STEP
    seen = []
    forward = TStepCtx.forward
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "forward", _spy(forward, seen,
                                         lambda self, a: a[0]))
    try:
        batch = {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy()
                                     if v.ndim == 4 else v)
                 for k, v in _batch(3).items()}
        engine.train_step(state, batch)
        engine.predict_fn("model", state)(batch["image"])
    finally:
        mp.undo()
    return engine, seen


@pytest.mark.parametrize("method,model", DTYPE_CASES)
def test_compute_dtype_follows_the_net_as_in_jax(method, model):
    """At ``dtype="bfloat16"`` (here on the CPU) only the plain UNet
    computes in bfloat16; the UNet variants and the discriminator run in
    float32, as ``cvssl_tpu/train/config.py:152-153`` gives them no dtype:
    their step and predict outputs equal those of a float32 run within
    1e-5 of the largest, and are float32."""
    engine, low = _dtype_step(method, model, "bfloat16")
    _, full = _dtype_step(method, model, "float32")
    slots = engine.method.net_types()
    jcfg = JConfig(**{**CFG, "method": method, "model": model,
                      "dtype": "bfloat16"})
    for slot, net in slots.items():
        bf16 = jcfg.model_kwargs(net).get("dtype") == jnp.bfloat16
        assert engine.model_dtypes[slot] == (torch.bfloat16 if bf16
                                             else torch.float32)
    assert [n for n, _ in low] == [n for n, _ in full]
    assert {n for n, _ in low} == set(slots)
    # a float32 net fed by a bfloat16 one sees other inputs: values are
    # compared where every net of the method runs in float32
    all_f32 = all(d == torch.float32 for d in engine.model_dtypes.values())
    for (name, a), (_, b) in zip(low, full):
        a = a if isinstance(a, (tuple, list)) else (a,)
        b = b if isinstance(b, (tuple, list)) else (b,)
        for x, y in zip(a, b):
            assert x.dtype == engine.model_dtypes[name], (name, x.dtype)
            if all_f32:
                scale = float(y.detach().abs().max())
                torch.testing.assert_close(x.detach(), y.detach(), rtol=0,
                                           atol=1e-5 * scale)
    assert all_f32 == (slots["model"] != "unet")


# ---------------------------------------------------------------------------
# adversarial_consistency: SwinUnet + discriminator, ICT mixing, EMA teacher
# ---------------------------------------------------------------------------

AC_B, AC_LB = 8, 4       # lb >= 4: the discriminator's input quirk shows


@pytest.fixture(scope="module")
def ac_step():
    """One step of adversarial_consistency at consistency weight 1 on a
    two-stage SwinUnet at 32^2 (``test_torch_port_vit_methods.VIT``) and
    the discriminator, batch 8 = 4 labeled + 4 unlabeled."""
    from cvssl_tpu.models import swin_unet as jswin
    from cvssl_tpu_torch.models import swin_unet as tswin
    from test_torch_port_vit_methods import VIT
    jmods = {"model": jswin.SwinUnet(num_classes=C, **VIT),
             "dan": jdisc.FCDiscriminator(num_classes=C, ndf=NDF)}

    def port(slot):
        if slot == "model":
            return tswin.SwinUnet(num_classes=C, img_size=32, **VIT)
        return tdisc.FCDiscriminator(C, 1, ndf=NDF, patch_size=(32, 32))
    rng = np.random.default_rng(6)
    batch = {"image": rng.normal(0.5, 0.25, (AC_B, 32, 32, 1)).astype(
        np.float32),
        "label": rng.integers(0, C, (AC_B, 32, 32)).astype(np.int32)}
    return run_step("adversarial_consistency", jmods, port, batch, seed=6,
                    nets={"model": "swin_unet", "dan": "discriminator"},
                    model="swin_unet", batch_size=AC_B, labeled_bs=AC_LB,
                    labeled_slices_override=AC_LB, s2d_loss="off")


def test_adversarial_consistency_metrics_and_gradients_match_jax(ac_step):
    """Loss and metrics within 1e-5 relative (both phases'); the SwinUnet's
    gradients against the generator phase's, the discriminator's against
    the discriminator phase's."""
    r = ac_step
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_weight"]) == 1.0
    assert float(t["ict_loss"]) > 0.0
    g_phase, d_phase = r["jgrads"]
    assert set(g_phase) == {"model"} and set(d_phase) == {"dan"}
    for n, want in (("model", g_phase["model"]), ("dan", d_phase["dan"])):
        model = r["tstate"].models[n]
        grads = {k: p.grad for k, p in model.named_parameters()}
        grads.update({k: torch.zeros_like(b)
                      for k, b in model.named_buffers()})
        _assert_tree_close(flax_from_state_dict(r["nets"][n], grads)[0],
                           want)


def test_adversarial_consistency_updates_match_jax(ac_step):
    """The SwinUnet after SGD and its EMA teacher, each element within
    2e-2 of the largest delta from the initial weights plus float32
    rounding; one update of each optimizer."""
    r = ac_step
    js, ts = r["jstate"], r["tstate"]
    for want, got in ((js.params["model"], ts.models["model"]),
                      (js.teacher_params["model"], ts.teachers["model"])):
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
    assert {n: o.count for n, o in ts.optimizers.items()} == {"model": 1,
                                                              "dan": 1}
    assert set(ts.teachers) == set(js.teacher_params) == {"model"}


def test_adversarial_consistency_draws_and_dan_input(ac_step):
    """The draws in JAX's order: one Beta(alpha, alpha) of (half, 1, 1, 1)
    for the mixing, the student's stochastic-depth masks, then each
    teacher pass's own (u0, then u1: train mode), then the discriminator
    phase's two channel-dropout masks. The generator phase's discriminator
    runs in eval mode on the reference's rows: from lb // 2 on, so 2
    labeled rows and the 2 mixed ones."""
    from test_torch_port_vit_methods import VIT_MASKS
    r = ac_step
    kinds = [k for k, _ in r["draws"].log]
    assert kinds == ["beta"] + ["keep"] * (3 * VIT_MASKS) + ["keep", "keep"]
    assert r["draws"].of("beta")[0].shape == ((AC_B - AC_LB) // 2, 1, 1, 1)
    modes = [training for training, _ in r["dan_out"]]
    assert modes == [False, True]
    half = (AC_B - AC_LB) // 2
    assert r["dan_out"][0][1].shape == (AC_LB // 2 + half, 2)
    assert r["dan_out"][1][1].shape == (AC_B, 2)
    _, d_out = r["dan_out"][1]
    gap = (d_out[:, 0] - d_out[:, 1]).detach().abs()
    assert float(gap.min()) > MARGIN
