"""One engine step of each UNet-family SSL method of the port (uamt, ict,
deep_co_training, cps, cct, urpc) against the JAX engine's step body with
the same weights, batch and random draws (CPU, float32, dropout zeroed):
loss and metrics, gradients, parameters after SGD, EMA teachers and the
BatchNorm buffers of students and teachers.

Draws: the port's step runs first with every draw it makes (``StepCtx``'s
``normal``/``randint``/``beta`` and the models' perturbation draws
``unet._uniform``/``unet._keep``) replaced by numpy values from a seed and
recorded; the JAX step then gets the same values, in the same order and in
its NHWC layout, from patched ``jax.random.normal/uniform/bernoulli/beta/
randint``. Nothing in ``cvssl_tpu`` changes.

Discrete decisions that f32 noise could flip between the frameworks (uamt's
``uncertainty < threshold``, cps's argmax, ``feature_dropout``'s
``attention < threshold``) are held at least ``MARGIN`` away from their
thresholds at the chosen seeds, and the tests assert it."""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import unet as junet
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods import co_training
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, LB, HW, C = 4, 2, 32, 4
FEATURES = (4, 8, 16, 32, 64)
STEP = 1000          # consistency live: w = 0.1 * sigmoid_rampup(6, 200)
MARGIN = 1e-4
CFG = dict(model="unet", num_classes=C, batch_size=B, labeled_bs=LB,
           patch_size=(HW, HW), labeled_slices_override=LB, dtype="float32",
           s2d_levels=0, num_devices=1)

# method -> ({slot: net type}, seed of weights, batch and draws, scale of
# the UNets' output conv). uamt's teacher must be sure somewhere for its
# mask to mean anything, and cps's argmax margins grow with the logits: for
# those two the output conv is scaled up on both sides (the same weights
# either way).
METHODS = {
    "uamt": ({"model": "unet"}, 0, 8.0),
    "ict": ({"model": "unet"}, 0, 1.0),
    "deep_co_training": ({"model": "unet"}, 0, 1.0),
    "cps": ({"model1": "unet", "model2": "unet"}, 5, 8.0),
    "cct": ({"model": "unet_cct"}, 0, 1.0),
    "urpc": ({"model": "unet_urpc"}, 0, 1.0),
}
JAX_MODELS = {"unet": junet.UNet, "unet_cct": junet.UNetCCT,
              "unet_urpc": junet.UNetURPC}
PORT_MODELS = {"unet": tunet.UNet, "unet_cct": tunet.UNetCCT,
               "unet_urpc": tunet.UNetURPC}


class _Draws:
    """The port's draws, made from a numpy seed and recorded in call order;
    ``replay`` hands them to the JAX calls in the same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed + 100)
        self.log = []          # (kind, value in the port's layout)
        self.cursor = 0

    def take(self, kind, value):
        self.log.append((kind, value))
        return torch.from_numpy(np.ascontiguousarray(value))

    def of(self, kind):
        return [v for k, v in self.log if k == kind]

    def replay(self, kind, shape):
        """The next recorded draw, which must be of ``kind``, in NHWC."""
        want, value = self.log[self.cursor]
        self.cursor += 1
        assert want == kind, (want, kind)
        if value.ndim == 4:                    # NCHW -> NHWC
            value = np.moveaxis(value, 1, -1)
        elif value.ndim == 3:                  # feature noise (C, H, W)
            value = np.moveaxis(value, 0, -1)
        if shape is not None:
            assert tuple(value.shape) == tuple(shape), (kind, value.shape,
                                                        shape)
        return jnp.asarray(value)


def _patch_port(mp, draws):
    rng = draws.rng
    mp.setattr(TStepCtx, "normal", lambda self, shape, device: draws.take(
        "normal", rng.normal(size=tuple(shape)).astype(np.float32)))
    # k = 0 would skip the rotation: 1..3 only
    mp.setattr(TStepCtx, "randint", lambda self, high: draws.take(
        "randint", np.asarray(rng.integers(1, high), np.int64)))
    mp.setattr(TStepCtx, "beta", lambda self, alpha, shape: draws.take(
        "beta", rng.beta(alpha, alpha, tuple(shape)).astype(np.float32)))
    mp.setattr(tunet, "_uniform", lambda shape, lo, hi, g, d: draws.take(
        "uniform", rng.uniform(lo, hi, tuple(shape)).astype(np.float32)))
    mp.setattr(tunet, "_keep", lambda shape, p, g, d: draws.take(
        "keep", rng.random(tuple(shape)) < p))


def _patch_jax(mp, draws):
    mp.setattr(jax.random, "normal", lambda key, shape=(), dtype=None:
               draws.replay("normal", shape))
    mp.setattr(jax.random, "randint", lambda key, shape, minval, maxval,
               dtype=None: draws.replay("randint", shape).astype(jnp.int32))
    mp.setattr(jax.random, "beta", lambda key, a, b, shape=None, dtype=None:
               draws.replay("beta", shape))
    mp.setattr(jax.random, "uniform", lambda key, shape=(), dtype=None,
               minval=0.0, maxval=1.0: draws.replay("uniform", shape))
    mp.setattr(jax.random, "bernoulli", lambda key, p=0.5, shape=None:
               draws.replay("keep", shape))


def _capture_grads(mp):
    """The step body's ``jax.value_and_grad`` also returns the gradients
    in its metrics (key ``_grads``), so one compiled step gives both."""
    orig = jax.value_and_grad

    def value_and_grad(fn, *a, has_aux=False, **k):
        inner = orig(fn, *a, has_aux=has_aux, **k)

        def call(*args, **kw):
            (loss, aux), grads = inner(*args, **kw)
            metrics, *rest = aux
            return (loss, ({**metrics, "_grads": grads}, *rest)), grads
        return call
    mp.setattr(jax, "value_and_grad", value_and_grad)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _scale_out_conv(params, factor):
    p = jax.tree_util.tree_map(np.array, params)
    p["Decoder_0"]["Conv_0"]["kernel"] *= factor
    p["Decoder_0"]["Conv_0"]["bias"] *= factor
    return p


def _narrow(method_name, tcfg, slots):
    cls = type(get_method(method_name, tcfg))

    class Narrow(cls):
        def build_models(self):
            return {n: PORT_MODELS[t](1, C, features=FEATURES,
                                      dropout=(0.0,) * 5)
                    for n, t in slots.items()}
    return Narrow(tcfg)


def _run(method_name):
    slots, seed, scale = METHODS[method_name]
    rng = np.random.default_rng(seed)
    image = rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32)
    label = rng.integers(0, C, (B, HW, HW)).astype(np.int32)

    # -- JAX state: weights from its own init --------------------------
    jcfg = JConfig(method=method_name, **CFG)
    jeng = JEngine(jcfg)
    jeng.modules = {n: JAX_MODELS[t](in_chns=1, num_classes=C,
                                     features=FEATURES, dropout=(0.0,) * 5)
                    for n, t in slots.items()}
    state = jeng.init_state(jax.random.PRNGKey(seed),
                            {"image": image, "label": label})
    state = state.replace(step=jnp.int32(STEP))
    if scale != 1.0:
        params = {n: _scale_out_conv(p, scale)
                  for n, p in state.params.items()}
        state = state.replace(params=params, teacher_params={
            n: copy.deepcopy(params[n]) for n in state.teacher_params})
    p0 = _np_tree(state.params)
    bs0 = _np_tree(state.batch_stats)

    # -- the port: same weights, its draws recorded ---------------------
    draws = _Draws(seed)
    tcfg = TConfig(method=method_name, **CFG)
    method = _narrow(method_name, tcfg, slots)
    teng = TEngine(tcfg, method=method, device="cpu")
    tstate = teng.init_state()
    for n, t in slots.items():
        sd = state_dict_from_flax(t, p0[n], bs0[n])
        tstate.models[n].load_state_dict(sd)
        if n in tstate.teachers:
            tstate.teachers[n].load_state_dict(sd)
    teacher0 = {n: copy.deepcopy(m) for n, m in tstate.teachers.items()}
    tstate.step = STEP
    seen = {"pseudo_logits": [], "fdrop_inputs": []}
    fdrop = tunet.feature_dropout
    pseudo_ce = type(method)._pseudo_ce if method_name == "cps" else None
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    mp.setattr(tunet, "feature_dropout", lambda x, g: (
        seen["fdrop_inputs"].append(x.detach().clone()), fdrop(x, g))[1])
    if pseudo_ce is not None:
        mp.setattr(type(method), "_pseudo_ce", lambda self, lg, ps: (
            seen["pseudo_logits"].append(lg.detach().clone()),
            pseudo_ce(self, lg, ps))[1])
    try:
        tbatch = {"image": torch.from_numpy(np.moveaxis(image, -1, 1).copy()),
                  "label": torch.from_numpy(label)}
        tstate, tmetrics = teng.train_step(tstate, tbatch)
    finally:
        mp.undo()

    # -- JAX: the engine's step body on the recorded draws ---------------
    body = jeng._build_train_step_body()

    def step(s, b):
        draws.cursor = 0
        return body(s, b)
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    _capture_grads(mp)
    try:
        new_state, jmetrics = jax.jit(step)(
            state, {"image": jnp.asarray(image), "label": jnp.asarray(label)})
    finally:
        mp.undo()
    assert draws.cursor == len(draws.log)   # every draw replayed
    jgrads = jmetrics.pop("_grads")
    return dict(slots=slots, p0=p0, jstate=new_state, jmetrics=jmetrics,
                jgrads=jgrads, tstate=tstate, tmetrics=tmetrics, draws=draws,
                seen=seen, teacher0=teacher0, image=image, teng=teng)


@pytest.fixture(scope="module", params=list(METHODS))
def pair(request):
    return request.param, _run(request.param)


def _port_trees(module, net_type):
    sd = {k: v.detach() for k, v in module.state_dict().items()}
    return flax_from_state_dict(net_type, sd)


def test_loss_and_metrics_match_jax_step(pair):
    name, r = pair
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    if "consistency_loss" in j:
        assert float(j["consistency_loss"]) > 0.0
    assert float(j["consistency_weight"]) > 0.0


def test_gradients_match_jax_step(pair):
    name, r = pair
    for n, t in r["slots"].items():
        model = r["tstate"].models[n]
        grads = {k: p.grad for k, p in model.named_parameters()}
        grads.update({k: torch.zeros_like(b)
                      for k, b in model.named_buffers()})
        _assert_tree_close(flax_from_state_dict(t, grads)[0],
                           r["jgrads"][n])


def test_sgd_update_and_ema_teacher_match_jax_step(pair):
    """Parameters after SGD and the EMA teachers, each element within 2e-2
    of the largest delta from the initial weights (the gradients' per-element
    bound of ``_assert_tree_close``) plus float32 rounding."""
    name, r = pair
    js, ts = r["jstate"], r["tstate"]
    checked = []
    for n, t in r["slots"].items():
        pairs = [(js.params[n], ts.models[n])]
        if n in ts.teachers:
            pairs.append((js.teacher_params[n], ts.teachers[n]))
        for want, got in pairs:
            got_p = _port_trees(got, t)[0]
            deltas = jax.tree_util.tree_map(
                lambda a, b: np.asarray(a) - np.asarray(b), want, r["p0"][n])
            scale = max(float(np.abs(d).max())
                        for d in jax.tree_util.tree_leaves(deltas))
            assert scale > 0.0
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(got_p)):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                           atol=2e-2 * scale)
            checked.append(n)
        assert ts.optimizers[n].count == 1
    assert ts.step == STEP + 1
    assert set(ts.teachers) == set(js.teacher_params)
    assert len(checked) == len(r["slots"]) + len(ts.teachers)


def test_batchnorm_buffers_match_jax_step(pair):
    name, r = pair
    js, ts = r["jstate"], r["tstate"]
    for n, t in r["slots"].items():
        pairs = [(js.batch_stats[n], ts.models[n])]
        if n in ts.teachers:
            pairs.append((js.teacher_batch_stats[n], ts.teachers[n]))
        for want, got in pairs:
            got_bs = _port_trees(got, t)[1]
            assert (jax.tree_util.tree_structure(_np_tree(want))
                    == jax.tree_util.tree_structure(got_bs))
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(got_bs)):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                           atol=1e-5)


def test_draws_and_discrete_decisions(pair):
    """The draws each step made; and no value that a threshold or an argmax
    decides lies within MARGIN of it, so f32 noise between the frameworks
    cannot flip a decision, and each decision goes both ways somewhere."""
    name, r = pair
    kinds = [k for k, _ in r["draws"].log]
    want_kinds = {"uamt": ["normal", "normal"], "ict": ["beta"],
                  "deep_co_training": ["randint"], "cps": [],
                  "cct": ["uniform"] * 5 + ["keep"] * 5 + ["uniform"] * 5,
                  "urpc": ["keep", "uniform", "uniform"]}[name]
    assert kinds == want_kinds
    if name == "ict":
        assert r["draws"].of("beta")[0].shape == ((B - LB) // 2, 1, 1, 1)
    elif name == "uamt":
        # the MC teacher again on the same inputs: train-mode forwards
        # depend on the weights and the batch only
        cfg, teacher = r["teng"].cfg, r["teacher0"]["model"]
        T = cfg.uncertainty_T
        unl = torch.from_numpy(np.moveaxis(r["image"][LB:], -1, 1).copy())
        u = unl.shape[0]
        mc_in = unl.repeat(T, 1, 1, 1) + torch.clamp(
            0.1 * torch.from_numpy(r["draws"].of("normal")[1]), -0.2, 0.2)
        with torch.no_grad():
            mc = torch.cat([teacher(g) for g in mc_in.reshape(
                T // 2, 2 * u, 1, HW, HW)])
        preds = torch.softmax(mc, 1).reshape(T, u, C, HW, HW).mean(0)
        unc = -torch.sum(preds * torch.log(preds + 1e-6), dim=1)
        gap = (unc - r["teng"].method.threshold(STEP)).abs()
        assert float(gap.min()) > MARGIN
        frac = float(r["tmetrics"]["uncertainty_mask_frac"])
        assert 0.0 < frac < 1.0, frac
    elif name == "cps":
        assert len(r["seen"]["pseudo_logits"]) == 2
        for logits in r["seen"]["pseudo_logits"]:
            top2 = torch.softmax(logits, 1).topk(2, dim=1).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > MARGIN
    elif name in ("cct", "urpc"):
        inputs = r["seen"]["fdrop_inputs"]
        thresholds = [u for u in r["draws"].of("uniform") if u.ndim == 1]
        assert len(inputs) == len(thresholds) == (5 if name == "cct" else 1)
        for x, u in zip(inputs, thresholds):
            att = x.mean(dim=1)
            thresh = att.reshape(B, -1).amax(1) * torch.from_numpy(u)
            gap = (att - thresh[:, None, None]).abs()
            assert float(gap.min()) > MARGIN
            assert bool((att < thresh[:, None, None]).any())
            assert bool((att >= thresh[:, None, None]).any())


def test_deep_co_training_rotation_matches_jnp_rot90():
    """``rot90_select`` with k on the device is ``jnp.rot90(x, k, (1, 2))``
    on the NHWC array, for every k."""
    x = np.random.default_rng(3).normal(size=(2, 3, 5, 5)).astype(np.float32)
    for k in range(4):
        got = co_training.rot90_select(torch.from_numpy(x),
                                       torch.tensor(k)).numpy()
        want = np.asarray(jnp.rot90(jnp.asarray(np.moveaxis(x, 1, -1)), k,
                                    (1, 2)))
        np.testing.assert_array_equal(got, np.moveaxis(want, -1, 1))


# ---------------------------------------------------------------------------
# StepCtx: the draws and the MC teacher loop
# ---------------------------------------------------------------------------

def _ctx(seed=0, teachers=None):
    return TStepCtx(TConfig(**CFG), {}, teachers or {},
                    torch.Generator().manual_seed(seed), STEP)


def test_stepctx_draws_come_from_the_step_generator():
    """Same generator state, same draws, whatever the global generator
    does; the perturbations' uniform in [lo, hi), randint a 0-dim int64 in
    [0, high), Beta(a, a) in [0, 1] with its mean and variance."""
    def draw(ctx):
        return (tunet._uniform((3, 4), -0.3, 0.3, ctx.generator, None),
                ctx.randint(4), ctx.beta(0.2, (20000,)))
    a = draw(_ctx(3))
    torch.manual_seed(99)
    torch.rand(5)
    b = draw(_ctx(3))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    u, k, beta = a
    assert u.dtype == torch.float32 and u.shape == (3, 4)
    assert float(u.min()) >= -0.3 and float(u.max()) < 0.3
    assert k.shape == () and k.dtype == torch.int64 and 0 <= int(k) < 4
    assert {int(_ctx(s).randint(4)) for s in range(40)} == {0, 1, 2, 3}
    assert beta.dtype == torch.float32 and bool(torch.isfinite(beta).all())
    assert float(beta.min()) >= 0.0 and float(beta.max()) <= 1.0
    assert float(beta.mean()) == pytest.approx(0.5, abs=0.02)
    # Var Beta(a, a) = 1 / (4 (2a + 1))
    assert float(beta.var()) == pytest.approx(1 / (4 * 1.4), rel=0.05)


def test_forward_teacher_scan_is_sequential_passes():
    """One train-mode no_grad pass per group, the running statistics
    carried from pass to pass, logits stacked on the group axis."""
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 2, 1, HW, HW)).astype(np.float32))
    torch.manual_seed(0)
    teacher = tunet.UNet(1, C, features=FEATURES).train()
    ref = copy.deepcopy(teacher)
    out = _ctx(1, {"model": teacher}).forward_teacher_scan("model", x)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        want = torch.stack([ref(g, gen) for g in x])
    assert out.shape == (3, 2, C, HW, HW) and not out.requires_grad
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    for a, b in zip(teacher.buffers(), ref.buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method_name", list(METHODS))
def test_step_draws_only_from_the_step_generator(method_name):
    """A step (dropout kept) leaves the global generator as it found it,
    and the same generator state gives the same step, bit for bit."""
    slots = METHODS[method_name][0]
    tcfg = TConfig(method=method_name, **CFG)

    class Narrow(type(get_method(method_name, tcfg))):
        def build_models(self):
            return {n: PORT_MODELS[t](1, C, features=FEATURES)
                    for n, t in slots.items()}
    rng = np.random.default_rng(2)
    batch = {"image": torch.from_numpy(rng.normal(
        0.5, 0.25, (B, 1, HW, HW)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(0, C, (B, HW, HW)))}
    results = []
    for _ in range(2):
        eng = TEngine(tcfg, method=Narrow(tcfg), device="cpu")
        state = eng.init_state()
        state.step = STEP
        global_state = torch.random.get_rng_state()
        state, metrics = eng.train_step(state, batch)
        assert torch.equal(torch.random.get_rng_state(), global_state)
        torch.rand(3)                      # moves the global generator
        results.append((float(metrics["loss"]), state.generator.get_state(),
                        [p.detach().clone() for m in state.models.values()
                         for p in m.parameters()]))
    (la, ga, pa), (lb, gb, pb) = results
    assert la == lb and torch.equal(ga, gb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
