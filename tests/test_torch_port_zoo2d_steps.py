"""One mean_teacher engine step of ENet (here) and EffiUNet
(``test_torch_port_zoo2d_effi_step.py``, on this file's checks) against
the JAX package on the CPU, at batch 4 = 2 + 2 and 64^2, 4 classes,
consistency weight 1: the loss and its terms, the gradients, the SGD
update, the EMA teacher and both models' BatchNorm statistics.

As ``test_torch_port_zoo3d_steps.py``'s steps: the port's step first with
every draw (StepCtx's noise, ENet's channel-dropout keep masks, EffiUNet's
drop-connects) replaced by recorded numpy values, then JAX's step body on
the same values through patched ``jax.random.*``, both in float64 (JAX
under ``jax.enable_x64``: Flax's float32 BatchNorm variance drifts about
1e-4). JAX's weights are ``test_torch_port_zoo2d.filled``'s, given to its
engine through a module whose ``init`` returns them (a jitted Flax init
of EffiUNet compiles for seconds here)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import efficientunet as jeff
from cvssl_tpu.models import enet as jenet
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.models import efficientunet as teff
from cvssl_tpu_torch.models import enet as tenet
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import fused_ce_dice as fcd
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_adversarial import _capture_each_grads, _spy  # noqa
from test_torch_port_methods import _Draws, _patch_jax, _patch_port  # noqa
from test_torch_port_zoo2d import filled  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, LB, S, C = 4, 2, 64, 4
STEP = 30000
NETS = {"enet": (jenet.ENet, tenet.ENet),
        "efficient_unet": (jeff.EffiUNet, teff.EffiUNet)}
# the loss terms, gradients and running statistics agree within this
# relative error (and this share of the tree's largest element)
REL = 1e-6


class _Preset:
    """A Flax module whose ``init`` returns the given variables."""

    def __init__(self, module, params, stats):
        self.module, self.variables = module, {"params": params,
                                               "batch_stats": stats}

    def init(self, rngs, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


def _nc(v):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(v, -1, 1) if v.ndim == 4 else v))


def run_step(net):
    jf, tf = NETS[net]
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(0.5, 0.25, (B, S, S, 1)).astype(np.float32),
             "label": rng.integers(0, C, (B, S, S)).astype(np.int32)}
    cfg = dict(model=net, num_classes=C, batch_size=B, labeled_bs=LB,
               patch_size=(S, S), labeled_num=LB, dtype="float32",
               s2d_levels=0, num_devices=1, max_iterations=1_000_000,
               consistency=1.0)
    params, stats = filled(jf(), batch["image"])
    jeng = JEngine(JConfig(method="mean_teacher", **cfg))
    jeng.modules = {"model": _Preset(jf(), params, stats)}
    state = jeng.init_state(jax.random.PRNGKey(0), batch)
    state = state.replace(step=jnp.int32(STEP))
    p0 = jax.tree_util.tree_map(np.asarray, state.params)
    s0 = jax.tree_util.tree_map(np.asarray, state.batch_stats)

    tcfg = TConfig(method="mean_teacher", **cfg)
    teng = TEngine(tcfg, device="cpu")
    tstate = teng.init_state()
    sd = state_dict_from_flax(net, params, stats)
    for m in (tstate.models["model"], tstate.teachers["model"]):
        m.load_state_dict(sd)
        m.double()
    tstate.step = STEP
    draws = _Draws(1)
    passes, launches = [], []
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    mp.setattr(TStepCtx, "forward_teacher", _spy(
        TStepCtx.forward_teacher, passes, lambda self, a: a[1].shape[0]))
    wrapper = fcd.fused_ce_dice

    def counted(logits, labels, *a, **k):
        # the geometry the card's kernel takes (NCHW-contiguous logits)
        fcd._geometry(logits, labels)
        launches.append((tuple(logits.shape), logits.dtype))
        return wrapper(logits, labels, *a, **k)
    mp.setattr(fcd, "fused_ce_dice", counted)
    try:
        tstate, tmetrics = teng.train_step(tstate, {
            "image": _nc(batch["image"]).double(),
            "label": _nc(batch["label"])})
    finally:
        mp.undo()

    def f64(tree):
        return jax.tree_util.tree_map(
            lambda v: np.asarray(v, np.float64)
            if np.asarray(v).dtype == np.float32 else v, tree)
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    tags = _capture_each_grads(mp)
    try:
        with jax.enable_x64(True):
            new_state, jmetrics = jax.jit(jeng._build_train_step_body())(
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
    (tag,) = tags
    jgrads = jmetrics.pop(tag)["model"]
    return dict(net=net, p0=p0, s0=s0, jstate=new_state, jmetrics=jmetrics,
                jgrads=jgrads, tstate=tstate, tmetrics=tmetrics, draws=draws,
                passes=passes, launches=launches)


@pytest.fixture(scope="module")
def step():
    return run_step("enet")


def _leaves_close(want, got, rel=REL):
    """Leaf by leaf within ``rel`` relative and ``rel`` of the tree's
    largest element (a leaf that sums to near 0, such as a PReLU slope's
    gradient, carries the rounding of the float32 loss terms)."""
    leaves = jax.tree_util.tree_leaves
    scale = max(float(np.abs(np.asarray(a)).max()) for a in leaves(want))
    for a, b in zip(leaves(want), leaves(got)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=rel, atol=rel * scale)


def check_loss_and_draws(step):
    """Every metric within 1e-6 relative, the consistency term live at
    weight 1; kernel #1's wrapper once, on the labeled NCHW logits; one
    teacher pass over the 2 unlabeled; the draws in JAX's order (the
    teacher's input noise, the student's keeps over the batch of 4, then
    the teacher's over the 2 unlabeled)."""
    r = step
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=REL), k
    assert float(j["consistency_weight"]) == 1.0
    assert float(t["consistency_loss"]) > 0.0
    assert r["launches"] == [((LB, C, S, S), torch.float64)]
    assert [a for a, _ in r["passes"]] == [B - LB]
    kinds = [(k, v.shape[0]) for k, v in r["draws"].log]
    keeps = {"enet": 27, "efficient_unet": 19}[r["net"]]
    assert kinds == ([("normal", B - LB)] + [("keep", B)] * keeps
                     + [("keep", B - LB)] * keeps)


def check_gradients(step):
    """The student's gradients, leaf by leaf, within 1e-6 relative and 1e-6
    of the largest gradient."""
    r = step
    model = r["tstate"].models["model"]
    got = flax_from_state_dict(r["net"], {
        **{k: torch.zeros_like(b) for k, b in model.named_buffers()},
        **{k: p.grad for k, p in model.named_parameters()}})[0]
    _leaves_close(r["jgrads"], got)


def check_updates_teacher_and_statistics(step):
    """The parameters after SGD, the EMA teacher, and the running
    statistics of the student and of the teacher (each a train-mode
    forward's), within 1e-6 relative and 1e-6 of the tree's largest
    element; the statistics moved."""
    r = step
    js, ts = r["jstate"], r["tstate"]
    for want_p, want_s, got in (
            (js.params["model"], js.batch_stats["model"],
             ts.models["model"]),
            (js.teacher_params["model"], js.teacher_batch_stats["model"],
             ts.teachers["model"])):
        params, stats = flax_from_state_dict(r["net"], got.state_dict())
        _leaves_close(want_p, params)
        _leaves_close(want_s, stats)
        leaves = jax.tree_util.tree_leaves
        assert not all(np.array_equal(a, b) for a, b in
                       zip(leaves(stats), leaves(r["s0"]["model"])))
    assert ts.step == STEP + 1


def test_zoo2d_step_loss_and_draws(step):
    check_loss_and_draws(step)


def test_zoo2d_step_gradients(step):
    check_gradients(step)


def test_zoo2d_step_updates_teacher_and_statistics(step):
    check_updates_teacher_and_statistics(step)
