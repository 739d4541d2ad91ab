"""One mean-teacher step of the port against the JAX step body with the same
weights, batch and teacher noise (CPU, float32, dropout zeroed): loss,
gradients, parameters after SGD, the EMA teacher and the BatchNorm buffers.
Plus a CPU smoke of the port's engine on its device-store path."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models.torch_convert import convert_unet_checkpoint
from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu.train.methods.base import get_method as jget_method
from cvssl_tpu.train.state import StepCtx as JStepCtx
from cvssl_tpu_torch.data.device_store import DeviceSliceStore
from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.models.unet import UNet as TUNet
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods.mean_teacher import MeanTeacher
from cvssl_tpu_torch.train.methods.supervised import Supervised
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402

B, LB, HW, C = 4, 2, 32, 4
FEATURES = (4, 8, 16, 32, 64)
STEP = 1000   # consistency term live: w = 0.1 * sigmoid_rampup(6, 200)
CFG = dict(method="mean_teacher", model="unet", num_classes=C, batch_size=B,
           labeled_bs=LB, patch_size=(HW, HW), labeled_slices_override=LB,
           dtype="float32", s2d_levels=0, num_devices=1)


def _narrow(method_cls):
    class Narrow(method_cls):
        def build_models(self):
            return {"model": TUNet(1, C, features=FEATURES,
                                   dropout=(0.0,) * 5)}
    return Narrow


_NarrowMT = _narrow(MeanTeacher)


def _tree(sd):
    """Port state_dict-like mapping -> (params, batch_stats) flax trees."""
    return convert_unet_checkpoint({k: np.asarray(v) for k, v in sd.items()})


def _grads_tree(model):
    sd = {n: p.grad.numpy() for n, p in model.named_parameters()}
    sd.update({n: np.zeros(b.shape, np.float32)
               for n, b in model.named_buffers()})
    return _tree(sd)[0]


def _sub(a, b):
    return jax.tree_util.tree_map(lambda x, y: np.asarray(x) - np.asarray(y),
                                  a, b)


@pytest.fixture(scope="module")
def step_pair():
    rng = np.random.default_rng(0)
    image = rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32)
    label = rng.integers(0, C, (B, HW, HW)).astype(np.int32)
    noise = np.clip(0.1 * rng.normal(size=(B - LB, HW, HW, 1)),
                    -0.2, 0.2).astype(np.float32)

    # -- JAX: the engine's step body, teacher noise injected ------------
    jcfg = JConfig(**CFG)
    jeng = JEngine(jcfg)
    jeng.modules = {"model": JUNet(in_chns=1, num_classes=C,
                                   features=FEATURES, dropout=(0.0,) * 5)}
    state = jeng.init_state(jax.random.PRNGKey(0),
                            {"image": image, "label": label})
    state = state.replace(step=jnp.int32(STEP))
    jbatch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal",
               lambda key, shape, dtype=None: jnp.asarray(noise))
    try:
        new_state, metrics = jax.jit(jeng._build_train_step_body())(state,
                                                                   jbatch)
        method = jget_method("mean_teacher", jcfg)

        def loss_fn(p):
            ctx = JStepCtx(jcfg, jeng.modules, p, state.batch_stats,
                           state.teacher_params, state.teacher_batch_stats,
                           jax.random.PRNGKey(0), jnp.int32(STEP))
            return method.loss(ctx, jbatch)[0]

        jgrads = jax.jit(jax.grad(loss_fn))(state.params)["model"]
    finally:
        mp.undo()
    p0 = jax.tree_util.tree_map(np.asarray, state.params["model"])
    bs0 = jax.tree_util.tree_map(np.asarray, state.batch_stats["model"])

    # -- port: same weights, same batch, same noise ---------------------
    tcfg = TConfig(**CFG)
    teng = TEngine(tcfg, method=_NarrowMT(tcfg), device="cpu")
    tstate = teng.init_state()
    sd = state_dict_from_flax("unet", p0, bs0)
    tstate.models["model"].load_state_dict(sd)
    tstate.teachers["model"].load_state_dict(sd)
    tstate.step = STEP
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "normal", lambda self, shape, device:
               torch.from_numpy(np.moveaxis(noise, -1, 1).copy()))
    try:
        tbatch = {"image": torch.from_numpy(np.moveaxis(image, -1, 1).copy()),
                  "label": torch.from_numpy(label)}
        tstate, tmetrics = teng.train_step(tstate, tbatch)
    finally:
        mp.undo()
    return dict(p0=p0, bs0=bs0, jstate=new_state, jmetrics=metrics,
                jgrads=jgrads, tstate=tstate, tmetrics=tmetrics)


def test_loss_matches_jax_step(step_pair):
    j, t = step_pair["jmetrics"], step_pair["tmetrics"]
    for k in ("loss", "loss_ce", "loss_dice", "consistency_loss"):
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_loss"]) > 0.0
    assert t["consistency_weight"] == pytest.approx(
        float(j["consistency_weight"]), rel=1e-6)


def test_gradients_match_jax_step(step_pair):
    _assert_tree_close(_grads_tree(step_pair["tstate"].models["model"]),
                       step_pair["jgrads"])


def test_sgd_update_and_ema_teacher_match_jax_step(step_pair):
    """Parameters after SGD and the EMA teacher. Their deltas from the
    initial weights are -lr (g + wd p) and 0.01 of that, so they carry the
    gradients' cross-framework error: each element is held within 2e-2 of
    the largest delta (the per-element gradient bound of
    ``_assert_tree_close``) plus float32 rounding of the weights."""
    p0 = step_pair["p0"]
    js, ts = step_pair["jstate"], step_pair["tstate"]
    for want, got in ((js.params["model"], ts.models["model"]),
                      (js.teacher_params["model"], ts.teachers["model"])):
        got_p = _tree({k: v.detach() for k, v in got.state_dict().items()})[0]
        scale = max(float(np.abs(d).max())
                    for d in jax.tree_util.tree_leaves(_sub(want, p0)))
        assert scale > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
    assert ts.step == STEP + 1
    assert ts.optimizers["model"].count == 1


def test_batchnorm_buffers_match_jax_step(step_pair):
    js, ts = step_pair["jstate"], step_pair["tstate"]
    for want, got in ((js.batch_stats["model"], ts.models["model"]),
                      (js.teacher_batch_stats["model"], ts.teachers["model"])):
        got_bs = _tree({k: v.detach() for k, v in got.state_dict().items()})[1]
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_bs)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


def test_supervised_step_matches_jax():
    """The supervised baseline: loss and gradients of one step."""
    rng = np.random.default_rng(1)
    image = rng.normal(0.5, 0.25, (2, HW, HW, 1)).astype(np.float32)
    label = rng.integers(0, C, (2, HW, HW)).astype(np.int32)
    cfg = dict(CFG, method="supervised", batch_size=2)
    jcfg = JConfig(**cfg)
    module = JUNet(in_chns=1, num_classes=C, features=FEATURES,
                   dropout=(0.0,) * 5)
    v = jax.jit(lambda k, x: module.init(k, x, train=False))(
        jax.random.PRNGKey(1), jnp.asarray(image))
    method = jget_method("supervised", jcfg)
    jbatch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}

    def loss_fn(p):
        ctx = JStepCtx(jcfg, {"model": module}, p,
                       {"model": v["batch_stats"]}, {}, {},
                       jax.random.PRNGKey(0), jnp.int32(0))
        return method.loss(ctx, jbatch)[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        {"model": v["params"]})

    tcfg = TConfig(**cfg)
    eng = TEngine(tcfg, method=_narrow(Supervised)(tcfg), device="cpu")
    state = eng.init_state()
    state.models["model"].load_state_dict(state_dict_from_flax("unet",
        jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])))
    state, metrics = eng.train_step(state, {
        "image": torch.from_numpy(np.moveaxis(image, -1, 1).copy()),
        "label": torch.from_numpy(label)})
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
    _assert_tree_close(_grads_tree(state.models["model"]), grads["model"])
    assert state.teachers == {}


class _Slices:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, (28, HW)).astype(np.float32),
                "label": r.integers(0, C, (28, HW)).astype(np.uint8)}


def test_engine_cpu_smoke_store_path():
    cfg = TConfig(**CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine(cfg)        # this machine has no card: no quiet CPU run
    eng = TEngine(cfg, method=_NarrowMT(cfg), device="cpu")
    eng.attach_store(DeviceSliceStore(_Slices(), (HW, HW), device="cpu"))
    state = eng.init_state()
    before = [p.clone() for p in state.teachers["model"].parameters()]
    stream = TwoStreamBatchSampler(range(LB * 2), range(LB * 2, 12), B,
                                   B - LB, rng=np.random.default_rng(0))
    it = stream.epochs()
    state, metrics = eng.train_steps(state, [next(it) for _ in range(2)])
    assert state.step == 2
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, state.teachers["model"].parameters()))
    pred = eng.predict_fn("model", state)(torch.zeros(3, 1, HW, HW))
    assert pred.shape == (3, HW, HW) and pred.dtype == torch.uint8
    assert state.models["model"].training


def test_fused_loss_cannot_be_switched_off():
    """The port has one CE+Dice path on the card: the fused kernel."""
    assert TConfig(**CFG).fused_loss_on()
    assert TConfig(**CFG, fused_loss=True).fused_loss_on()
    with pytest.raises(ValueError, match="fused_loss"):
        TConfig(**CFG, fused_loss=False)
