"""The port's 3D training path against the JAX package on the CPU: one
engine step of each of the seven 3D methods (supervised, mean_teacher,
uamt, cps, ict, adversarial and exam_student_teacher) on UNet3D at 16^3,
batch 4 = 2 + 2, 2 classes (loss and metrics, gradients, the SGD update,
the EMA teacher, the discriminator's Adam phase), uamt at T = 8 with its
ONE teacher pass over the (T + 1) * u batch; then ``fit`` at ``dim=3`` on
a synthetic BraTS tree (files, the val table against JAX's
``Engine.validate`` on the same weights, a bit-equal resume on the store
and on the host path) and the CLI's ``--dim 3``.

The steps run as ``test_torch_port_adversarial.py``'s ``run_step``: the
port's step first, with every draw (StepCtx's normal and beta, the
discriminator's keep masks) replaced by recorded numpy values, then JAX's
step body on the same values through patched ``jax.random.*`` (5D draws
moved to NDHWC). UNet3D's dropout is zeroed on both sides. The weight of
the consistency terms is 1 (step 30000, ``consistency=1``); the run is
long (``max_iterations`` 10^6), so that uamt's threshold stays low and
its mask goes both ways."""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data.datasets import VolumeDataset as JVolumes
from cvssl_tpu.models import discriminator as jdisc
from cvssl_tpu.models import unet3d as junet3d
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.data.device_store import DeviceVolumeStore
from cvssl_tpu_torch.models import discriminator as tdisc
from cvssl_tpu_torch.models import unet3d as tunet3d
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import schedules as tschedules
from cvssl_tpu_torch.train import cli as tcli
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import build_3d_data, fit
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_3d_models import Draws3D  # noqa: E402
from test_torch_port_adversarial import (_adam_first_step_bound,  # noqa
                                         _capture_each_grads, _spy)
from test_torch_port_methods import MARGIN, _patch_jax, _patch_port  # noqa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, LB, S, C = 4, 2, 16, 2
SCALE = 16          # feature_scale: widths (4, 8, 16, 32, 64)
NDF = 8
STEP = 30000
# uamt's entropies over 2 x 16^3 unlabeled voxels lie ~6e-5 apart near the
# threshold, closer than MARGIN; the two frameworks' MC-teacher entropies
# differ by at most 1.5e-5 here (measured: float32 logits within 2.1e-4 of
# 22.6), so the uamt decisions are held 3e-5 from the threshold
UAMT_MARGIN = 3e-5
CFG = dict(model="unet_3D", dim=3, num_classes=C, batch_size=B,
           labeled_bs=LB, patch_size=(S, S, S), labeled_num=LB,
           dtype="float32", s2d_levels=0, num_devices=1,
           max_iterations=1_000_000, consistency=1.0)

JAX_NETS = {"unet_3D": lambda: junet3d.UNet3D(num_classes=C,
                                              feature_scale=SCALE,
                                              dropout=0.0),
            "discriminator_3d": lambda: jdisc.FC3DDiscriminator(
                num_classes=C, ndf=NDF)}
PORT_NETS = {"unet_3D": lambda: tunet3d.UNet3D(1, C, feature_scale=SCALE,
                                               dropout=0.0),
             "discriminator_3d": lambda: tdisc.FC3DDiscriminator(C, 1,
                                                                 ndf=NDF)}
SEG = {"model": "unet_3D"}
ADV = {"model": "unet_3D", "dan": "discriminator_3d"}
# method -> (slots, seed, scale of the UNets' output conv, kernel #1's
# calls a step). uamt's teacher must be sure somewhere for its mask to mean
# anything, and cps's argmax margins grow with the logits.
METHODS = {"supervised": (SEG, 0, 1.0, 1), "mean_teacher": (SEG, 0, 1.0, 1),
           "uamt": (SEG, 0, 8.0, 1),
           "cps": ({"model1": "unet_3D", "model2": "unet_3D"}, 5, 8.0, 2),
           "ict": (SEG, 0, 1.0, 1), "adversarial": (ADV, 1, 8.0, 1),
           "exam_student_teacher": (ADV, 1, 8.0, 1)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(0.5, 0.25, (B, S, S, S, 1)).astype(
        np.float32),
        "label": rng.integers(0, C, (B, S, S, S)).astype(np.int32)}


def _ncdhw(v):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(v, -1, 1) if v.ndim == 5 else v))


def _scaled(net, params, factor):
    if net != "unet_3D" or factor == 1.0:
        return params
    p = jax.tree_util.tree_map(np.array, params)
    p["Conv_0"]["kernel"] *= factor
    p["Conv_0"]["bias"] *= factor
    return p


def run_step(method_name):
    """One step ``STEP`` of ``method_name`` in both packages from JAX's
    initial weights."""
    slots, seed, scale, _ = METHODS[method_name]
    batch = _batch(seed)
    jcfg = JConfig(method=method_name, **CFG)
    jeng = JEngine(jcfg)
    jeng.modules = {n: JAX_NETS[t]() for n, t in slots.items()}
    state = jeng.init_state(jax.random.PRNGKey(seed), batch)
    params = {n: _scaled(slots[n], p, scale)
              for n, p in state.params.items()}
    state = state.replace(step=jnp.int32(STEP), params=params,
                          teacher_params={n: copy.deepcopy(params[n])
                                          for n in state.teacher_params})
    p0 = jax.tree_util.tree_map(np.asarray, state.params)

    tcfg = TConfig(method=method_name, **CFG)

    class Narrow(type(get_method(method_name, tcfg))):
        def build_models(self):
            return {n: PORT_NETS[t]() for n, t in slots.items()}
    teng = TEngine(tcfg, method=Narrow(tcfg), device="cpu")
    tstate = teng.init_state()
    for n, t in slots.items():
        sd = state_dict_from_flax(t, p0[n], {})
        tstate.models[n].load_state_dict(sd)
        if n in tstate.teachers:
            tstate.teachers[n].load_state_dict(sd)
    tstate.step = STEP
    draws = Draws3D(seed)
    seen = {"teacher": [], "dan": [], "pseudo": []}
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    mp.setattr(TStepCtx, "forward_teacher", _spy(
        TStepCtx.forward_teacher, seen["teacher"],
        lambda self, a: a[1].shape[0]))
    mp.setattr(tdisc.FC3DDiscriminator, "forward", _spy(
        tdisc.FC3DDiscriminator.forward, seen["dan"],
        lambda self, a: self.training))
    if method_name == "cps":
        mp.setattr(type(teng.method), "_pseudo_ce", _spy(
            type(teng.method)._pseudo_ce, seen["pseudo"],
            lambda self, a: (a[0].detach().clone(), a[1].clone())))
    try:
        tstate, tmetrics = teng.train_step(
            tstate, {k: _ncdhw(v) for k, v in batch.items()})
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
    return dict(slots=slots, p0=p0, jstate=new_state, jmetrics=jmetrics,
                jgrads=jgrads, tstate=tstate, tmetrics=tmetrics, draws=draws,
                seen=seen, teng=teng)


@pytest.fixture(scope="module", params=list(METHODS))
def pair(request):
    return request.param, run_step(request.param)


def test_3d_loss_and_metrics_match_jax_step(pair):
    """Every metric within 1e-5 relative; the consistency terms live at
    weight 1."""
    name, r = pair
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    if name != "supervised":
        assert float(j["consistency_weight"]) == 1.0
        assert float(t.get("consistency_loss", 1.0)) > 0.0


def test_3d_gradients_match_jax_step(pair):
    """Each model's gradients against JAX's, the segmenters' from the
    generator phase, the discriminator's from its own phase alone."""
    name, r = pair
    phases = r["jgrads"]
    for n, t in r["slots"].items():
        want = phases[-1 if n == "dan" else 0][n]
        model = r["tstate"].models[n]
        _assert_tree_close(flax_from_state_dict(t, {
            k: p.grad for k, p in model.named_parameters()})[0], want)
    assert len(phases) == (2 if "dan" in r["slots"] else 1)


def _tree_of(module, net):
    return flax_from_state_dict(net, {k: v.detach() for k, v in
                                      module.state_dict().items()})[0]


def test_3d_updates_and_teachers_match_jax_step(pair):
    """Parameters after SGD and the EMA teachers, each element within 2e-2
    of the largest delta from the initial weights plus float32 rounding;
    the discriminator after Adam within its first step's sensitivity to
    the gradients' difference (``_adam_first_step_bound``) plus 1e-3 lr;
    one update of each optimizer."""
    name, r = pair
    js, ts = r["jstate"], r["tstate"]
    leaves = jax.tree_util.tree_leaves
    for n, t in r["slots"].items():
        if n == "dan":
            lr = ts.optimizers["dan"].defaults["lr"]
            got_g = flax_from_state_dict(t, {
                k: p.grad for k, p in ts.models[n].named_parameters()})[0]
            for want, got, g_p, g_j in zip(
                    leaves(js.params[n]), leaves(_tree_of(ts.models[n], t)),
                    leaves(got_g), leaves(r["jgrads"][1][n])):
                want = np.asarray(want, np.float64)
                bound = (_adam_first_step_bound(
                    g_p.astype(np.float64), np.asarray(g_j, np.float64), lr)
                    + 1e-3 * lr + 1e-6 * np.abs(want))
                assert bool((np.abs(got - want) <= bound).all())
            assert isinstance(ts.optimizers[n], tschedules.DiscriminatorAdam)
            continue
        pairs = [(js.params[n], ts.models[n])]
        if n in ts.teachers:
            pairs.append((js.teacher_params[n], ts.teachers[n]))
        for want, got in pairs:
            deltas = [np.asarray(a) - np.asarray(b) for a, b in
                      zip(leaves(want), leaves(r["p0"][n]))]
            scale = max(float(np.abs(d).max()) for d in deltas)
            assert scale > 0.0
            for a, b in zip(leaves(want), leaves(_tree_of(got, t))):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                           atol=2e-2 * scale)
    assert all(o.count == 1 for o in ts.optimizers.values())
    assert set(ts.teachers) == set(js.teacher_params)
    assert ts.step == STEP + 1


def test_3d_draws_passes_and_decisions(pair):
    """The draws in JAX's order and shapes; uamt's ONE teacher pass over
    the (T + 1) * u batch, its mask both ways and every entropy at least
    UAMT_MARGIN from the threshold; cps's pseudo-labels JAX's argmax; the
    discriminator's verdicts at least MARGIN from a tie."""
    name, r = pair
    cfg = r["teng"].cfg
    u = B - LB
    kinds = [(k, v.shape) for k, v in r["draws"].log]
    keeps = [("keep", (B, NDF * m, 1, 1, 1)) for m in (1, 2, 4)]
    want = {"supervised": [], "mean_teacher": [("normal", (u, 1, S, S, S))],
            "uamt": [("normal", (u, 1, S, S, S)),
                     ("normal", (cfg.uncertainty_T * u, 1, S, S, S))],
            "cps": [], "ict": [("beta", (u // 2, 1, 1, 1, 1))],
            "adversarial": keeps,
            "exam_student_teacher": [("normal", (u, 1, S, S, S))] + keeps}
    assert kinds == want[name]
    passes = [k for k, _ in r["seen"]["teacher"]]
    if name == "uamt":
        assert passes == [(cfg.uncertainty_T + 1) * u]
        logits = r["seen"]["teacher"][0][1][u:]
        preds = torch.softmax(logits, 1).reshape(
            (cfg.uncertainty_T, u, C) + (S,) * 3).mean(0)
        unc = -torch.sum(preds * torch.log(preds + 1e-6), dim=1)
        gap = (unc - r["teng"].method.threshold(STEP)).abs()
        assert float(gap.min()) > UAMT_MARGIN
        frac = float(r["tmetrics"]["uncertainty_mask_frac"])
        assert 0.0 < frac < 1.0, frac
    elif name in ("mean_teacher", "exam_student_teacher"):
        assert passes == [u]
    elif name == "ict":
        assert passes == [u // 2, u // 2]
    if name == "cps":
        # 2 x 16^3 sites a model put some softmax gaps near 0 (below 1e-4 at
        # every seed tried); a pseudo-label there weighs nothing in the CE
        # either way. So each pseudo-label map is held against JAX's own
        # argmax of the other model: equal, but at near ties (gap < 2e-4).
        ((l1, p2), _), ((l2, p1), _) = r["seen"]["pseudo"]
        unl = jnp.asarray(_batch(METHODS[name][1])["image"][LB:])
        for n, logits, pseudo in (("model2", l2, p2), ("model1", l1, p1)):
            jl = jax.jit(JAX_NETS["unet_3D"]().apply, static_argnames=(
                "train",))({"params": r["p0"][n]}, unl, train=True)
            want = torch.from_numpy(np.array(jnp.argmax(jl, -1)))
            top2 = torch.softmax(logits, 1).topk(2, dim=1).values
            differ = pseudo != want
            assert bool(((top2[:, 0] - top2[:, 1])[differ] < 2e-4).all())
            assert int(differ.sum()) <= 4
    if "dan" in r["slots"]:
        assert [m for m, _ in r["seen"]["dan"]] == [False, True]
        d_out = r["seen"]["dan"][1][1]
        assert float((d_out[:, 0] - d_out[:, 1]).detach().abs().min()) \
            > MARGIN


# ---------------------------------------------------------------------------
# fit at dim=3, the val table, resume and the CLI
# ---------------------------------------------------------------------------

class _NarrowUAMT(type(get_method("uamt", TConfig()))):
    def build_models(self):
        return {"model": PORT_NETS["unet_3D"]()}


def _fit_cfg(root, out, **kw):
    return TConfig(**{**CFG, "method": "uamt", "root_path": root,
                      "max_iterations": 6, "val_every": 3, "ckpt_every": 3,
                      "log_every": 3, "snapshot_root": out,
                      "exp": "BraTS/test", **kw})


def _fit(cfg, steps, **kw):
    engine = TEngine(cfg, method=_NarrowUAMT(cfg), device="cpu")
    return engine, fit(cfg, engine=engine, max_steps=steps, **kw)


@pytest.fixture(scope="module")
def brats(tmp_path_factory):
    """A synthetic BraTS tree at the patch size (6 train volumes, 2 val):
    one window a val volume."""
    return tsyn.make_synthetic_brats(
        str(tmp_path_factory.mktemp("brats") / "BraTS"), num_train=6,
        num_val=2, size=S, seed=3)


@pytest.mark.parametrize("device_data", [True, False])
def test_fit_3d_files_table_and_bit_equal_resume(brats, tmp_path,
                                                 device_data):
    """``fit`` at dim=3 from the store (under the 8 GiB rule) and from the
    host pipeline (RandomRotFlip3D + RandomCrop): the checkpoint naming
    contract, the val table of ``Engine.validate`` (sliding window), and a
    run stopped at 3 and resumed to 6 bit-equal to an uninterrupted run."""
    straight = _fit_cfg(brats, str(tmp_path / "a"), device_data=device_data)
    engine, res = _fit(straight, 6)
    assert res["iterations"] == 6
    assert (engine.store is not None) == device_data
    if device_data:
        assert isinstance(engine.store, DeviceVolumeStore)
    snap = straight.snapshot_path()
    files = set(os.listdir(snap))
    for name in ("iter_3.ckpt", "iter_6.ckpt", "ema_model_iter_6.ckpt",
                 "model_iter_6.ckpt"):
        assert name in files, sorted(files)
    if res["best_dice"]["model"] > 0:
        assert "unet_3D_best_model.ckpt" in files
    cut = _fit_cfg(brats, str(tmp_path / "b"), device_data=device_data)
    _fit(cut, 3)
    _, resumed = _fit(cut, 6)
    with open(os.path.join(cut.snapshot_path(), "log.txt")) as f:
        assert "resumed from iteration 3" in f.read()
    for a, b in zip(res["state"].models["model"].state_dict().values(),
                    resumed["state"].models["model"].state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(res["state"].teachers["model"].parameters(),
                    resumed["state"].teachers["model"].parameters()):
        assert torch.equal(a, b)


def test_validate_3d_matches_jax_engine(brats):
    """``Engine.validate`` at dim=3 (the sliding window at stride 64, dc
    and hd95 on the host) gives JAX's ``Engine.validate`` table on the same
    weights, within 1e-9; the val volumes need one window each, so JAX's
    filling of a short batch of windows does not enter."""
    cfg = _fit_cfg(brats, "/nonexistent")
    jeng = JEngine(JConfig(method="uamt", root_path=brats, **CFG))
    jeng.modules = {"model": JAX_NETS["unet_3D"]()}
    val = JVolumes(brats, "val")
    state = jeng.init_state(jax.random.PRNGKey(2), {
        "image": np.zeros((B, S, S, S, 1), np.float32),
        "label": np.zeros((B, S, S, S), np.int32)})
    p = _scaled("unet_3D", jax.tree_util.tree_map(np.asarray,
                                                  state.params["model"]), 4.0)
    state = state.replace(params={"model": p})
    want = jeng.validate(state, val)
    teng = TEngine(cfg, method=_NarrowUAMT(cfg), device="cpu")
    tstate = teng.init_state()
    tstate.models["model"].load_state_dict(state_dict_from_flax("unet_3D", p,
                                                                {}))
    _, _, tval = build_3d_data(cfg, False, raw=True)
    got = teng.validate(tstate, tval)
    assert got.shape == (C - 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert got[0, 0] > 0


def test_cli_dim_3_runs(brats, tmp_path, capsys):
    """``--dim 3`` through the CLI on the CPU: a supervised UNet3D at full
    width, 2 iterations with one validation; a BraTS root has no slice
    table, and nothing on the 3D path asks for one."""
    out = str(tmp_path / "cli")
    res = tcli.main(["--root_path", brats, "--exp", "BraTS/cli", "--dim",
                     "3", "--method", "supervised", "--model", "unet_3D",
                     "--num_classes", "2", "--patch_size", "16", "16", "16",
                     "--batch_size", "2", "--labeled_bs", "2",
                     "--labeled_num", "4", "--max_iterations", "2",
                     "--val_every", "2", "--ckpt_every", "2",
                     "--device", "cpu", "--dtype", "float32",
                     "--snapshot_root", out])
    assert res["iterations"] == 2
    snap = os.path.join(out, "BraTS/cli_4_labeled", "unet_3D")
    assert "model_iter_2.ckpt" in os.listdir(snap)
    with pytest.raises(ValueError, match="slice table"):
        TConfig(root_path=brats, dim=3).labeled_slices
