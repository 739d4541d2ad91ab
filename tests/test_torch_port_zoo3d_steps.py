"""One engine step of the 3D CNN zoo against the JAX package on the CPU:
mean_teacher on VNet, VoxResNet and AttentionUNet3D here; mean_teacher on
nnUNet (3D, and 2D at 4 classes) and uamt on VNet (its BatchNorm teacher:
T / 2 sequential passes over 2u volumes) and on VoxResNet (stats-free:
one pass over the (T + 1) * u volumes) in
``test_torch_port_zoo3d_uamt.py``, on this file's checks. Loss and metrics, gradients, the SGD update, the EMA
teacher and both models' BatchNorm statistics, at consistency weight 1.

The steps run as ``test_torch_port_3d_methods.py``'s: the port's step
first with every draw (StepCtx's normals, VNet's keep masks) replaced by
recorded numpy values, then JAX's step body on the same values through
patched ``jax.random.*``, both in float64 (JAX under ``jax.enable_x64``):
in float32 VNet's train-mode BatchNorm over few sites a channel moves its
consistency loss 2e-5 between the packages and some gradient leaves by
5-7% (Flax takes the variance as E[x^2] - E[x]^2); the float32 forwards
are held against JAX in ``test_torch_port_zoo3d.py``. uamt's VNet runs without its dropout: JAX's
teacher passes are one ``lax.scan`` body, which draws once when traced."""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import attention_unet as jatt
from cvssl_tpu.models import nnunet as jnnunet
from cvssl_tpu.models import vnet as jvnet
from cvssl_tpu.models import voxresnet as jvox
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.models import attention_unet as tatt
from cvssl_tpu_torch.models import nnunet as tnnunet
from cvssl_tpu_torch.models import vnet as tvnet
from cvssl_tpu_torch.models import voxresnet as tvox
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import fused_ce_dice as fcd
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.methods.uamt import has_batch_stats
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_3d_models import Draws3D  # noqa: E402
from test_torch_port_adversarial import _capture_each_grads, _spy  # noqa
from test_torch_port_methods import _patch_jax, _patch_port  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, LB = 4, 2
STEP = 30000
NN2D = dict(base_features=8, max_features=32, pool_kernels=((2, 2),) * 5,
            conv_kernels=((3, 3),) * 6)
# net -> (JAX module, port module, registry name, patch, classes)
NETS = {
    "vnet": (lambda: jvnet.VNet(num_classes=2, n_filters=4),
             lambda: tvnet.VNet(1, 2, n_filters=4), "vnet", (16, 16, 16),
             2),
    "vnet_nodrop": (lambda: jvnet.VNet(num_classes=2, n_filters=4,
                                       has_dropout=False),
                    lambda: tvnet.VNet(1, 2, n_filters=4, has_dropout=False),
                    "vnet", (16, 16, 16), 2),
    "voxresnet": (lambda: jvox.VoxResNet(num_classes=2, feature_chns=8),
                  lambda: tvox.VoxResNet(1, 2, feature_chns=8), "voxresnet",
                  (16, 16, 16), 2),
    "attention_unet": (lambda: jatt.AttentionUNet3D(num_classes=2,
                                                    feature_scale=16),
                       lambda: tatt.AttentionUNet3D(1, 2, feature_scale=16),
                       "attention_unet", (16, 16, 16), 2),
    "nnUNet_3d": (lambda: jnnunet.GenericUNet3D(num_classes=2,
                                                max_features=32),
                  lambda: tnnunet.GenericUNet3D(1, 2, max_features=32),
                  "nnUNet", (4, 64, 64), 2),
    "nnUNet_2d": (lambda: jnnunet.GenericUNet(num_classes=4, **NN2D),
                  lambda: tnnunet.GenericUNet(1, 4, **NN2D), "nnUNet",
                  (64, 64), 4),
}
CASES = (("mean_teacher", "vnet"), ("mean_teacher", "voxresnet"),
         ("mean_teacher", "attention_unet"), ("mean_teacher", "nnUNet_3d"),
         ("mean_teacher", "nnUNet_2d"), ("uamt", "vnet_nodrop"),
         ("uamt", "voxresnet"))


def _batch(shape, classes, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0.5, 0.25, (B,) + shape + (1,)).astype(
        np.float32),
        "label": rng.integers(0, classes, (B,) + shape).astype(np.int32)}


def _nc(v):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(v, -1, 1) if v.ndim >= 4 and v.shape[-1] == 1 else v))


def run_step(method_name, net):
    jf, tf, reg, shape, classes = NETS[net]
    cfg = dict(model=reg, dim=len(shape), num_classes=classes,
               batch_size=B, labeled_bs=LB, patch_size=shape,
               labeled_num=LB, dtype="float32", s2d_levels=0,
               num_devices=1, max_iterations=1_000_000, consistency=1.0)
    batch = _batch(shape, classes)
    jeng = JEngine(JConfig(method=method_name, **cfg))
    jeng.modules = {"model": jf()}
    state = jeng.init_state(jax.random.PRNGKey(0), batch)
    # norm scales and biases off their (1, 0) start (nnUNet's one-site
    # bottleneck InstanceNorm gives its bias, and LeakyReLU's slope at
    # exactly 0 is 1 in JAX, 0.01 in torch)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
            np.float32)
        if any("Norm" in str(k) or "_bn" in str(k) for k in path) else v,
        state.params)
    state = state.replace(
        step=jnp.int32(STEP), params=params,
        teacher_params=copy.deepcopy(params),
        teacher_batch_stats=copy.deepcopy(state.batch_stats))
    p0 = jax.tree_util.tree_map(np.asarray, state.params)
    s0 = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    tcfg = TConfig(method=method_name, **cfg)

    class Narrow(type(get_method(method_name, tcfg))):
        def build_models(self):
            return {"model": tf()}
    teng = TEngine(tcfg, method=Narrow(tcfg), device="cpu")
    tstate = teng.init_state()
    sd = state_dict_from_flax(reg, p0["model"], s0.get("model", {}))
    for m in (tstate.models["model"], tstate.teachers["model"]):
        m.load_state_dict(sd)
        m.double()
    tstate.step = STEP
    draws = Draws3D(1)
    passes, launches = [], []
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    mp.setattr(TStepCtx, "forward_teacher", _spy(
        TStepCtx.forward_teacher, passes, lambda self, a: a[1].shape[0]))
    mp.setattr(TStepCtx, "forward_teacher_scan", _spy(
        TStepCtx.forward_teacher_scan, passes,
        lambda self, a: tuple(a[1].shape[:2])))
    wrapper = fcd.fused_ce_dice

    def counted(logits, labels, *a, **k):
        # float32 logits, the kernel's contract (JAX's sup_ce_dice casts
        # them so too); CE over 8192 float32 sites differs 1e-5 from
        # float64
        fcd._geometry(logits, labels)
        launches.append((tuple(logits.shape), logits.dtype))
        return wrapper(logits.float(), labels, *a, **k)
    mp.setattr(fcd, "fused_ce_dice", counted)
    try:
        tstate, tmetrics = teng.train_step(tstate, {
            "image": _nc(batch["image"]).double(),
            "label": _nc(batch["label"])})
    finally:
        mp.undo()

    body = jeng._build_train_step_body()

    def step(s, b):
        draws.cursor = 0
        return body(s, b)
    def f64(tree):
        return jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64)
            if np.asarray(v).dtype == np.float32 else v, tree)
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    tags = _capture_each_grads(mp)
    try:
        with jax.enable_x64(True):
            new_state, jmetrics = jax.jit(step)(
                state.replace(params=f64(state.params),
                              batch_stats=f64(state.batch_stats),
                              teacher_params=f64(state.teacher_params),
                              teacher_batch_stats=f64(
                                  state.teacher_batch_stats)),
                {k: jnp.asarray(v) for k, v in f64(batch).items()})
            new_state, jmetrics = (jax.tree_util.tree_map(np.asarray, t)
                                   for t in (new_state, jmetrics))
    finally:
        mp.undo()
    assert draws.cursor == len(draws.log)
    jgrads = [jmetrics.pop(t) for t in tags]
    return dict(reg=reg, p0=p0, s0=s0, jstate=new_state, jmetrics=jmetrics,
                jgrads=jgrads, tstate=tstate, tmetrics=tmetrics,
                draws=draws, passes=[k for k, _ in passes],
                launches=launches, teng=teng, shape=shape)


@pytest.fixture(scope="module", params=CASES[:3], ids=lambda c: "-".join(c))
def pair(request):
    return request.param, run_step(*request.param)


def check_loss_and_metrics(pair):
    """Every metric within 1e-5 relative (the CE within 2e-5), the
    consistency terms at weight 1;
    kernel #1's wrapper called once a step, on the labeled NC logits (its
    geometry takes them as they are)."""
    (method, net), r = pair
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        # JAX computes the 5D CE on its jnp path in float32 (log_softmax
        # and a mean over 8192 sites), 1.05e-5 from float64 at VNet; the
        # port's float32 CE is 1e-8 from its float64 one
        rel = 2e-5 if k == "loss_ce" else 1e-5
        assert float(t[k]) == pytest.approx(float(j[k]), rel=rel), k
    assert float(j["consistency_weight"]) == 1.0
    assert float(t["consistency_loss"]) > 0.0
    classes = NETS[net][4]
    assert r["launches"] == [((LB, classes) + r["shape"], torch.float64)]


def check_gradients(pair):
    """At the repo's cross-framework bound (``_assert_tree_close``); for
    the nets without ``unet3d.instance_norm`` (float32 inside in both
    packages) within rtol 1e-4 and 1e-7 of the largest gradient."""
    (_, net), r = pair
    model = r["tstate"].models["model"]
    got = flax_from_state_dict(r["reg"], {
        **{k: torch.zeros_like(b) for k, b in model.named_buffers()},
        **{k: p.grad for k, p in model.named_parameters()}})[0]
    want = r["jgrads"][0]["model"]
    _assert_tree_close(got, want)
    assert len(r["jgrads"]) == 1
    if net in ("voxresnet", "attention_unet"):
        return
    leaves = jax.tree_util.tree_leaves
    scale = max(float(np.abs(b).max()) for b in leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                   atol=1e-7 * scale)


def check_updates_and_statistics(pair):
    """Parameters after SGD and the EMA teacher within 2e-2 of the largest
    delta from the initial weights plus float32 rounding; the student's and
    the teacher's BatchNorm statistics (VNet, AttentionUNet3D) within 1e-4
    relative and 1e-6 of the largest statistic (a gate's running mean is 0
    up to rounding)."""
    _, r = pair
    js, ts = r["jstate"], r["tstate"]
    leaves = jax.tree_util.tree_leaves
    for want, got, want_stats in (
            (js.params["model"], ts.models["model"],
             js.batch_stats.get("model", {})),
            (js.teacher_params["model"], ts.teachers["model"],
             js.teacher_batch_stats.get("model", {}))):
        params, stats = flax_from_state_dict(r["reg"], got.state_dict())
        deltas = [np.asarray(a) - np.asarray(b) for a, b in
                  zip(leaves(want), leaves(r["p0"]["model"]))]
        scale = max(float(np.abs(d).max()) for d in deltas)
        assert scale > 0.0
        for a, b in zip(leaves(want), leaves(params)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
        assert has_batch_stats(got) == bool(want_stats)
        big = max([float(np.abs(a).max()) for a in leaves(want_stats)]
                  or [0.0])
        for a, b, s in zip(leaves(want_stats), leaves(stats),
                           leaves(r["s0"].get("model", {}))):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                       atol=1e-6 * big)
            assert not np.array_equal(np.asarray(a), s)
    assert ts.step == STEP + 1


def check_draws_and_passes(pair):
    """The draws in JAX's order and shapes; uamt's teacher passes by
    branch: VNet's BatchNorm teacher one pass over u then T / 2 passes of
    2u, VoxResNet's one pass over (T + 1) * u; mean_teacher's one pass over
    u."""
    (method, net), r = pair
    cfg = r["teng"].cfg
    u, T = B - LB, cfg.uncertainty_T
    sp = (1,) + r["shape"]
    kinds = [(k, v.shape) for k, v in r["draws"].log]
    keeps = [("keep", (B, 64, 1, 1, 1)), ("keep", (B, 4, 1, 1, 1)),
             ("keep", (u, 64, 1, 1, 1)), ("keep", (u, 4, 1, 1, 1))]
    if method == "mean_teacher":
        want = [("normal", (u,) + sp)] + (keeps if net == "vnet" else [])
        if net == "vnet":
            want = [want[0]] + keeps
        assert kinds == want
        assert r["passes"] == [u]
    elif net == "vnet_nodrop":
        assert kinds == [("normal", (u,) + sp), ("normal", (T * u,) + sp)]
        assert r["passes"] == [u, (T // 2, 2 * u)]
    else:
        assert kinds == [("normal", (u,) + sp), ("normal", (T * u,) + sp)]
        assert r["passes"] == [(T + 1) * u]


def test_zoo_loss_and_metrics_match_jax_step(pair):
    check_loss_and_metrics(pair)


def test_zoo_gradients_match_jax_step(pair):
    check_gradients(pair)


def test_zoo_updates_teachers_and_statistics_match_jax_step(pair):
    check_updates_and_statistics(pair)


def test_zoo_draws_and_teacher_passes(pair):
    check_draws_and_passes(pair)
