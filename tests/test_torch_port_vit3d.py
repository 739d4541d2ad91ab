"""The port's 3D ViTs, UNETR and SwinUNETR, against the JAX package and the
MONAI stand-in (``tests/monai_standin.py``) on the CPU, at small widths:
UNETR at 32^3 with hidden 48, MLP 96, 4 heads, 12 layers (the taps need
10) and feature size 4 (``test_monai_parity.py``'s narrow form);
SwinUNETR at 32^3 with feature size 12 (stage maps 16^3 padded to 21^3,
8^3 to 14^3, the shift masks, and the clamped-window bias at 4^3 and
2^3), and at 32 x 32 x 64 (anisotropic clamps; the stand-in's torch
InstanceNorm3d refuses the one-site bottleneck of a 32^3 input, which the
port and JAX normalise to 0).

Weights come from the stand-in's seeded ``state_dict`` through JAX's
``monai_checkpoint`` converters and the port's. Checked: the eval
forwards in float32 (port against JAX and against the stand-in within
5e-4 of the largest logit, ``test_monai_parity.py``'s bound); the
converters' reports and the exact Flax <-> port round trip of
``models/convert.py``; the window helpers and the merge order element for
element; one supervised engine step against JAX's (loss, gradients,
update); the errors; the registry, the config and the CLI path with
``eval/test_3d.load_net``."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import monai_checkpoint as jmonai
from cvssl_tpu.models import swin_unetr as jswin
from cvssl_tpu.models import unetr as junetr
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.eval import test_3d as ttest3d
from cvssl_tpu_torch.models import factory as tfactory
from cvssl_tpu_torch.models import monai_checkpoint as tmonai
from cvssl_tpu_torch.models import net_factory_3d
from cvssl_tpu_torch.models import swin_unetr as tswin
from cvssl_tpu_torch.models import unetr as tunetr
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax)
from cvssl_tpu_torch.ops import fused_ce_dice as fcd
from cvssl_tpu_torch.train import cli as tcli
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
import monai_standin  # noqa: E402
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_adversarial import _capture_each_grads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = 2
CUBE = (32, 32, 32)
SLAB = (32, 32, 64)
UNETR_KW = dict(feature_size=4, hidden_size=48, mlp_dim=96, num_heads=4,
                num_layers=12)
SWIN_FS = 12
# logits agree within this share of the largest |logit|
FWD_TOL = 5e-4


def unetr_nets(img):
    return (lambda: monai_standin.UNETR(1, C, img, **UNETR_KW),
            lambda: junetr.UNETR(in_chns=1, num_classes=C, img_size=img,
                                 **UNETR_KW),
            lambda: tunetr.UNETR(1, C, img_size=img, **UNETR_KW))


def swin_nets(img):
    return (lambda: monai_standin.SwinUNETR(img, 1, C, feature_size=SWIN_FS),
            lambda: jswin.SwinUNETR(in_chns=1, num_classes=C,
                                    feature_size=SWIN_FS),
            lambda: tswin.SwinUNETR(1, C, img_size=img,
                                    feature_size=SWIN_FS))


NETS = {"unetr": ("unetr", unetr_nets, jmonai.convert_unetr_checkpoint,
                  tmonai.convert_unetr_checkpoint),
        "swinunetr": ("swinunetr", swin_nets,
                      jmonai.convert_swin_unetr_checkpoint,
                      tmonai.convert_swin_unetr_checkpoint)}


def _nc(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _ncdhw(x):
    return np.moveaxis(np.asarray(x), -1, 1)


def build(net, img, seed=0):
    """The stand-in with seeded weights, JAX's module and its params from
    JAX's converter, the port's module loaded through its converter;
    the MONAI ``state_dict`` (with SwinUNETR's index buffers) and both
    reports."""
    reg, nets, jconv, tconv = NETS[net]
    fs, fj, ft = nets(img)
    torch.manual_seed(seed)
    standin = fs().eval()
    sd = {k: v.detach().clone() for k, v in standin.state_dict().items()}
    jm = fj()
    tm = ft().eval()
    # JAX's converter fills a template of its tree: zeros in the shapes of
    # JAX's init, traced and not run (a jitted init of either net compiles
    # for 16-18 s on a CPU)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x)["params"],
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, *img, 1), jnp.float32))
    template = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)
    weights = {k: v.numpy() for k, v in sd.items()
               if "relative_position_index" not in k}
    jparams, jreport = jconv(weights, template)
    state, treport = tconv(sd, tm)
    tm.load_state_dict(state)
    return dict(reg=reg, standin=standin, sd=sd, jm=jm, jparams=jparams,
                jreport=jreport, tm=tm, state=state, treport=treport)


@pytest.fixture(scope="module")
def unetr_built():
    return build("unetr", CUBE)


@pytest.fixture(scope="module")
def swin_built():
    return build("swinunetr", SLAB)


@pytest.fixture(scope="module")
def swin_cube():
    return build("swinunetr", CUBE)


def _built(request, net):
    return request.getfixturevalue({"unetr": "unetr_built",
                                    "swinunetr": "swin_built"}[net])


def _forward_jax(b, x):
    return _ncdhw(jax.jit(lambda p, x: b["jm"].apply({"params": p}, x))(
        b["jparams"], np.moveaxis(x, 1, -1)))


@pytest.mark.parametrize("case", ["unetr", "swinunetr", "swinunetr_cube"])
def test_forward_matches_jax_and_standin(case, request):
    """Eval forward, float32, one volume (the step below takes two): the
    port's logits within 5e-4 of the
    largest |logit| of JAX's (at 32^3) and of the stand-in's (where it
    runs: SwinUNETR at 32 x 32 x 64, since at 32^3 torch's InstanceNorm3d
    refuses its one-site bottleneck; JAX against the stand-in there is
    ``test_monai_parity.py``'s)."""
    b = request.getfixturevalue({"unetr": "unetr_built",
                                 "swinunetr": "swin_built",
                                 "swinunetr_cube": "swin_cube"}[case])
    img = CUBE if case != "swinunetr" else SLAB
    x = np.random.default_rng(1).normal(size=(1, 1, *img)).astype(
        np.float32)
    with torch.no_grad():
        got = b["tm"](torch.from_numpy(x)).numpy()
    assert got.shape == (1, C, *img) and got.dtype == np.float32
    refs = []
    if case != "swinunetr":
        refs.append(_forward_jax(b, x))
    if case != "swinunetr_cube":
        with torch.no_grad():
            refs.append(b["standin"](torch.from_numpy(x)).numpy())
    for want in refs:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=FWD_TOL * scale)


@pytest.mark.parametrize("net", ["unetr", "swinunetr"])
def test_converter_reports_and_round_trip(net, request):
    """The port's MONAI converter loads every weight (skipped 0, loaded ==
    torch_keys, the report equal to JAX's), leaves the MONAI tensors as
    they are, and ``models/convert.py`` maps JAX's converted params onto
    exactly those tensors and back."""
    b = _built(request, net)
    assert b["treport"] == b["jreport"]
    assert b["treport"]["skipped"] == 0
    assert b["treport"]["loaded"] == b["treport"]["torch_keys"]
    own = b["tm"].state_dict()
    assert set(b["state"]) == set(own)
    for k, v in b["state"].items():
        assert torch.equal(v, b["sd"][k]), k
    sd = state_dict_from_flax(b["reg"], b["jparams"], {})
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert torch.equal(v, b["sd"][k]), k
    params, stats = flax_from_state_dict(b["reg"], own)
    assert stats == {}
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(jax.tree_util.tree_map(np.asarray, b["jparams"])))
    got = dict(flat(params))
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and np.array_equal(v, want[k]), k


def test_swin_index_buffers_are_checked(swin_built):
    """MONAI's ``relative_position_index`` buffers load (checked, not
    counted); one that differs from the window's index raises."""
    sd = dict(swin_built["sd"])
    keys = [k for k in sd if k.endswith("relative_position_index")]
    assert len(keys) == 8
    bad = sd[keys[3]].clone()
    bad[0, 1] += 1
    with pytest.raises(ValueError, match="relative-position index"):
        tmonai.convert_swin_unetr_checkpoint({**sd, keys[3]: bad},
                                             swin_built["tm"])


@pytest.mark.parametrize("net", ["unetr", "swinunetr"])
def test_shape_mismatch_raises(net, request):
    b = _built(request, net)
    conv = NETS[net][3]
    key = "out.conv.conv.weight"
    sd = {**b["sd"], key: torch.zeros(C + 1, *b["sd"][key].shape[1:])}
    with pytest.raises(ValueError, match="shape mismatch at out.conv"):
        conv(sd, b["tm"])


@pytest.mark.parametrize("dims,ws,shift", [
    ((21, 21, 21), (7, 7, 7), (3, 3, 3)),
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((4, 4, 14), (4, 4, 7), (0, 0, 3))])
def test_window_helpers_match_jax(dims, ws, shift):
    """Window partition and reverse, the shift mask and the cached
    constants element for element against JAX's numpy."""
    x = np.random.default_rng(2).normal(size=(2, *dims, 3)).astype(
        np.float32)
    got = tswin.window_partition_3d(torch.from_numpy(x), ws)
    want = np.asarray(jswin.window_partition_3d(x, ws))
    assert np.array_equal(got.numpy(), want)
    back = tswin.window_reverse_3d(got, ws, *dims)
    assert np.array_equal(back.numpy(), x)
    mask = tswin.shifted_window_mask_3d(dims, ws, shift)
    jmask = jswin.shifted_window_mask_3d(dims, ws, shift)
    assert mask.dtype == torch.float32
    assert np.array_equal(mask.numpy(), jmask)
    index, cached = tswin.window_constants(dims, ws, shift, (7, 7, 7),
                                           torch.device("cpu"))
    assert torch.equal(cached, mask)
    n = int(np.prod(ws))
    full = jswin.relative_position_index_3d((7, 7, 7))
    assert np.array_equal(index.numpy(), full[:n, :n].reshape(-1))


@pytest.mark.parametrize("ws,n", [((7, 7, 7), 343), ((4, 4, 4), 64),
                                  ((2, 2, 2), 8), ((4, 4, 7), 112),
                                  ((3, 5, 2), 30)])
def test_relative_position_index_matches_jax(ws, n):
    """The index of each window, and the clamped window's rows: the first
    n of the full 7^3 window's (MONAI's quirk)."""
    assert np.array_equal(tswin.relative_position_index_3d(ws).numpy(),
                          jswin.relative_position_index_3d(ws))
    full = tswin.relative_position_index_3d((7, 7, 7))[:n, :n]
    assert np.array_equal(full.numpy(),
                          jswin.relative_position_index_3d((7, 7, 7))[:n,
                                                                      :n])


def test_patch_merging_matches_jax():
    """The 2x2x2 neighbours in ``itertools.product`` order, LayerNorm, the
    bias-free reduction: JAX's ``PatchMerging3D`` on the same weights."""
    x = np.random.default_rng(3).normal(size=(2, 4, 6, 8, 5)).astype(
        np.float32)
    jm = jswin.PatchMerging3D(5)
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.normal(0, 0.1, v.shape).astype(
            np.float32), params)
    tm = tswin.PatchMerging(5)
    tm.load_state_dict({
        "norm.weight": torch.from_numpy(params["norm"]["scale"]),
        "norm.bias": torch.from_numpy(params["norm"]["bias"]),
        "reduction.weight": torch.from_numpy(
            params["reduction"]["kernel"].T.copy())})
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 3, 4, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the order alone: with an identity reduction (no norm) the channels
    # are JAX's concatenation
    parts = [x[:, i::2, j::2, k::2] for i in range(2) for j in range(2)
             for k in range(2)]
    with torch.no_grad():
        tm.norm = torch.nn.Identity()
        tm.reduction = torch.nn.Identity()
        cat = tm(torch.from_numpy(x)).numpy()
    assert np.array_equal(cat, np.concatenate(parts, axis=-1))


class _Preset:
    """A Flax module whose ``init`` returns the given params: JAX's engine
    starts from the stand-in's weights, without the jitted init."""

    def __init__(self, module, params):
        self.module, self.params = module, params

    def init(self, rngs, *args, **kwargs):
        return {"params": self.params}

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


def run_supervised_step(b, img, batch_size=2):
    """One supervised engine step of the narrow net of ``b`` (:func:`build`)
    in both packages from the stand-in's weights, float32: JAX's step body,
    jitted (its gradients read through a wrapped ``jax.value_and_grad``),
    and the port's ``Engine.train_step``; kernel #1's launches counted."""
    reg = b["reg"]
    _, fj, ft = NETS[reg][1](img)
    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(0.5, 0.25, (batch_size, *img, 1)).astype(
        np.float32),
        "label": rng.integers(0, C, (batch_size, *img)).astype(np.int32)}
    cfg = dict(model=reg, dim=3, num_classes=C, batch_size=batch_size,
               labeled_bs=batch_size, patch_size=img, labeled_num=2,
               dtype="float32", s2d_levels=0, num_devices=1,
               max_iterations=1000)
    jeng = JEngine(JConfig(method="supervised", **cfg))
    jeng.modules = {"model": _Preset(fj(), b["jparams"])}
    state = jeng.init_state(jax.random.PRNGKey(0), batch)
    p0 = jax.tree_util.tree_map(np.asarray, state.params)

    tcfg = TConfig(method="supervised", **cfg)

    class Narrow(type(get_method("supervised", tcfg))):
        def build_models(self):
            return {"model": ft()}
    teng = TEngine(tcfg, method=Narrow(tcfg), device="cpu")
    tstate = teng.init_state()
    tstate.models["model"].load_state_dict(b["state"])
    launches = []
    wrapper = fcd.fused_ce_dice
    mp = pytest.MonkeyPatch()

    def counted(logits, labels, *a, **k):
        launches.append((tuple(logits.shape), logits.dtype))
        return wrapper(logits, labels, *a, **k)
    mp.setattr(fcd, "fused_ce_dice", counted)
    try:
        tstate, tmetrics = teng.train_step(tstate, {
            "image": _nc(batch["image"]), "label": torch.from_numpy(
                batch["label"])})
    finally:
        mp.undo()

    tags = _capture_each_grads(mp)
    try:
        new_state, jmetrics = jax.jit(jeng._build_train_step_body())(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    finally:
        mp.undo()
    (tag,) = tags
    jgrads = jax.tree_util.tree_map(np.asarray, jmetrics.pop(tag))["model"]
    return dict(reg=reg, p0=p0, tstate=tstate, tmetrics=tmetrics,
                jstate=new_state, jmetrics=jmetrics, jgrads=jgrads,
                launches=launches, img=img, batch_size=batch_size)


@pytest.fixture(scope="module", params=["unetr", "swinunetr"])
def step(request):
    b = request.getfixturevalue({"unetr": "unetr_built",
                                 "swinunetr": "swin_cube"}[request.param])
    return request.param, run_supervised_step(b, CUBE)


def test_supervised_step_loss_and_launches(step):
    """Loss, CE and Dice within 1e-5 relative of JAX's (the CE 2e-5: JAX's
    5D CE is a float32 mean over 65536 sites); kernel #1's wrapper once, on
    the whole batch's float32 NCDHW logits."""
    _, r = step
    j, t = r["jmetrics"], r["tmetrics"]
    for k in ("loss", "loss_ce", "loss_dice"):
        rel = 2e-5 if k == "loss_ce" else 1e-5
        assert float(t[k]) == pytest.approx(float(j[k]), rel=rel), k
    assert r["launches"] == [((r["batch_size"], C, *r["img"]),
                              torch.float32)]


def test_supervised_step_gradients(step):
    """The gradients at the repo's cross-framework bound
    (``_assert_tree_close``) and, leaf by leaf, within rtol 1e-3 and 1e-3
    of the largest gradient. The largest differences, 4.0e-4 (UNETR) and
    3.3e-4 (SwinUNETR) of the largest gradient, sit in the full-size convs'
    kernels and come from the InstanceNorms' float32 statistics, which both
    packages keep: with the norms in float64 on both sides (and the rest in
    float64) UNETR's gradients agree within 1.7e-9 of the largest."""
    net, r = step
    model = r["tstate"].models["model"]
    got = flax_from_state_dict(r["reg"], {
        k: p.grad for k, p in model.named_parameters()})[0]
    want = r["jgrads"]
    _assert_tree_close(got, want)
    leaves = jax.tree_util.tree_leaves
    scale = max(float(np.abs(b).max()) for b in leaves(want))
    for a, b in zip(leaves(got), leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * scale)


def test_supervised_step_update(step):
    """The parameters after SGD: the port's within 2e-2 of the largest
    delta from the initial weights (plus float32 rounding) of JAX's."""
    _, r = step
    got = flax_from_state_dict(r["reg"],
                               r["tstate"].models["model"].state_dict())[0]
    leaves = jax.tree_util.tree_leaves
    want = leaves(jax.tree_util.tree_map(np.asarray,
                                         r["jstate"].params["model"]))
    start = leaves(r["p0"]["model"])
    delta = max(float(np.abs(w - s).max()) for w, s in zip(want, start))
    assert delta > 0
    for g, w in zip(leaves(got), want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-2 * delta + 1e-6 * np.abs(w).max())


def test_bad_sizes_raise():
    """A side that 16 (UNETR) or 32 (SwinUNETR) does not divide, too few
    layers for the taps, and a forward at a size other than the built
    one."""
    with pytest.raises(ValueError, match="multiples of 16"):
        tunetr.UNETR(1, C, img_size=(40, 32, 32), **UNETR_KW)
    with pytest.raises(ValueError, match="num_layers"):
        tunetr.UNETR(1, C, img_size=CUBE, **{**UNETR_KW, "num_layers": 9})
    with pytest.raises(ValueError, match="multiples of 32"):
        tswin.SwinUNETR(1, C, img_size=(48, 64, 64), feature_size=SWIN_FS)
    u = tunetr.UNETR(1, C, img_size=CUBE, **UNETR_KW)
    s = tswin.SwinUNETR(1, C, img_size=CUBE, feature_size=SWIN_FS)
    x = torch.zeros(1, 1, 32, 32, 64)
    for m, what in ((u, "position table"), (s, "windows")):
        with pytest.raises(ValueError, match=what):
            m(x)


def test_registry_config_and_full_width():
    """Both nets in the 3D registry at the reference's widths (92,783,842
    and 62,186,708 parameters at 2 classes), built for the patch by
    ``TrainConfig.model_kwargs``, in float32 whatever ``dtype`` says, as
    JAX's ``model_kwargs`` gives them no dtype."""
    for net, patch, count in (("unetr", (96, 96, 96), 92_783_842),
                              ("swinunetr", (64, 64, 64), 62_186_708)):
        cfg = TConfig(model=net, dim=3, num_classes=C, patch_size=patch,
                      dtype="bfloat16")
        assert cfg.model_kwargs(net) == {"img_size": patch}
        assert cfg.model_dtype(net, "cpu") == torch.float32
        assert net not in TConfig.COMPUTE_DTYPE_NETS
        m = net_factory_3d(net, 1, C, **cfg.model_kwargs(net))
        assert m.img_size == patch
        assert sum(p.numel() for p in m.parameters()) == count


@pytest.fixture(scope="module")
def brats(tmp_path_factory):
    from cvssl_tpu.data import synthetic as jsyn
    root = str(tmp_path_factory.mktemp("brats") / "BraTS")
    jsyn.make_synthetic_brats(root, num_train=4, num_val=1, num_test=2,
                              size=32, seed=5)
    return root


@pytest.mark.parametrize("net", ["unetr", "swinunetr"])
def test_cli_trains_and_test_3d_loads(net, brats, tmp_path, monkeypatch):
    """``--dim 3 --model unetr|swinunetr`` through the training CLI on the
    CPU (supervised, a 32^3 patch, the registry's entry narrowed), then
    ``eval/test_3d``: ``load_net`` builds the net for ``--patch_size``
    (the constructor arguments ``fit`` used) and loads the checkpoint the
    CLI wrote, and ``inference`` writes ``metrics.txt``."""
    reg, nets, _, _ = NETS[net]
    built = []
    narrow = UNETR_KW if net == "unetr" else {"feature_size": SWIN_FS}
    full = tfactory._REGISTRY_3D[net]

    def entry(in_chns, class_num, **kw):
        built.append(kw)
        return full(in_chns, class_num, **{**narrow, **kw})
    monkeypatch.setitem(tfactory._REGISTRY_3D, net, entry)
    out = str(tmp_path / "cli")
    res = tcli.main(["--root_path", brats, "--exp", f"BraTS/{net}",
                     "--dim", "3", "--method", "supervised", "--model", net,
                     "--num_classes", "2", "--patch_size", "32", "32", "32",
                     "--batch_size", "2", "--labeled_bs", "2",
                     "--labeled_num", "2", "--max_iterations", "2",
                     "--val_every", "2", "--ckpt_every", "2",
                     "--device", "cpu", "--dtype", "bfloat16",
                     "--snapshot_root", out])
    assert res["iterations"] == 2
    assert built == [{"img_size": CUBE}]
    model = res["state"].models["model"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    snap = os.path.join(out, f"BraTS/{net}_2_labeled", net)
    assert "model_iter_2.ckpt" in os.listdir(snap)
    best = os.path.join(snap, f"{net}_best_model.ckpt")
    if not os.path.exists(best):
        torch.save(model.state_dict(), best)
    flags = ttest3d.build_parser().parse_args([
        "--root_path", brats, "--exp", f"BraTS/{net}", "--model", net,
        "--labeled_num", "2", "--patch_size", "32", "32", "32",
        "--snapshot_root", out, "--device", "cpu"])
    loaded = ttest3d.load_net(net_factory_3d, flags)
    assert built[-1] == {"img_size": CUBE}
    want = ckpt.load_weights(best)
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    mean = ttest3d.inference(flags)
    assert mean.shape == (1, 4) and np.isfinite(mean).all()
    assert os.path.exists(os.path.join(snap + "_predictions",
                                       "metrics.txt"))
