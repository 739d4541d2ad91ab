"""The rest of the 2D zoo against the JAX package on the CPU: ENet, PNet2D,
EffiUNet-B3 and PreUNet (``cvssl_tpu_torch/models/enet.py``, ``pnet.py``,
``efficientunet.py``, ``resunet.py``).

JAX's weights come from ``jax.eval_shape`` of its init filled from a numpy
seed (a jitted Flax init of EffiUNet or PreUNet compiles for seconds on a
CPU), norms off their (1, 0) start and running statistics off (0, 1), and
reach the port through ``models/convert.py``. Checked: the eval forwards
in float32 (PNet at ``num_filters`` 8, ENet and EffiUNet at 64^2, the
Res2Net encoder at ``layers=(1, 1, 2)``, the whole PreUNet at 64^2); the
train-mode forwards and BatchNorm statistics in float64 (Flax's float32
variance is E[x^2] - E[x]^2, 3e-5 off at the encoder's 4^2 maps) with
every channel dropout and drop-connect drawn by the port and replayed in
JAX; the converters' round trip and the full-width parameter counts;
ENet's mask unpool on tied windows, its transpose head at an odd side,
EffiUNet's static TF-SAME pads; the registry; and ``test_2d --model
pnet``. One mean_teacher step of ENet and of EffiUNet is in
``test_torch_port_zoo2d_steps.py`` and
``test_torch_port_zoo2d_effi_step.py``."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from cvssl_tpu.models import efficientunet as jeff
from cvssl_tpu.models import enet as jenet
from cvssl_tpu.models import factory as jfactory
from cvssl_tpu.models import pnet as jpnet
from cvssl_tpu.models import resunet as jres
from cvssl_tpu_torch.eval import test_2d as ttest2d
from cvssl_tpu_torch.eval import test_3d as ttest3d
from cvssl_tpu_torch.models import efficientunet as teff
from cvssl_tpu_torch.models import enet as tenet
from cvssl_tpu_torch.models import factory as tfactory
from cvssl_tpu_torch.models import pnet as tpnet
from cvssl_tpu_torch.models import resunet as tres
from cvssl_tpu_torch.models.convert import (flax_from_state_dict,
                                            state_dict_from_flax,
                                            torch_kernel)
from cvssl_tpu_torch.data import synthetic as tsyn

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_methods import _Draws, _patch_jax, _patch_port  # noqa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# net -> (JAX module, port module, converter name, input (B, H, W, C))
NETS = {
    "pnet": (lambda: jpnet.PNet2D(num_filters=8),
             lambda: tpnet.PNet2D(num_filters=8), "pnet", (2, 64, 64, 1)),
    "enet": (jenet.ENet, tenet.ENet, "enet", (2, 64, 64, 1)),
    "efficient_unet": (jeff.EffiUNet, teff.EffiUNet, "efficient_unet",
                       (2, 64, 64, 1)),
    "res2net": (lambda: jres.Res2NetEncoder(layers=(1, 1, 2)),
                lambda: tres.Res2NetEncoder((1, 1, 2)), "res2net_encoder",
                (2, 64, 64, 3)),
}
FULL_WIDTH = {"enet": 349_284, "pnet": 486_596,
              "efficient_unet": 12_566_060, "preunet": 55_581_692}
# float32 eval forwards agree within this share of the largest output
FWD_TOL = 1e-5
# float64 train forwards and statistics
F64_TOL = 1e-9


def filled(jm, x, seed=0):
    """``jm``'s (params, batch_stats) from the shapes of its init, filled
    from ``seed``: kernels at 1/sqrt(fan-in), biases and means N(0, 0.1),
    scales U(0.8, 1.2), variances U(0.5, 1.5), PReLU slopes U(0.1, 0.4)."""
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        if name == "prelu_alpha":
            return np.asarray(rng.uniform(0.1, 0.4), np.float32)
        fan = max(int(np.prod(a.shape[:-1])), 1)
        return (rng.normal(0, 1, a.shape) / np.sqrt(fan)).astype(np.float32)
    v = jax.tree_util.tree_map_with_path(fill, shapes)
    return v["params"], v.get("batch_stats", {})


def _image(shape, seed=1):
    return np.random.default_rng(seed).normal(0.5, 0.3, shape).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _outputs(out):
    """A net's outputs as a list (the Res2Net encoder's stem and layers)."""
    if isinstance(out, tuple) and len(out) == 2 and isinstance(out[1],
                                                               (list, tuple)):
        return [out[0], *out[1]]
    return [out]


def _close(want, got, tol):
    for a, b in zip(_outputs(want), _outputs(got)):
        a = np.moveaxis(np.asarray(a), -1, 1)
        b = b.detach().numpy()
        assert a.shape == b.shape
        scale = float(np.abs(a).max())
        assert float(np.abs(a - b).max()) <= tol * scale, (
            float(np.abs(a - b).max()) / scale)


@pytest.fixture(scope="module", params=list(NETS))
def built(request):
    jf, tf, reg, shape = NETS[request.param]
    jm, tm = jf(), tf()
    x = _image(shape)
    params, stats = filled(jm, x)
    tm.load_state_dict(state_dict_from_flax(reg, params, stats))
    return dict(net=request.param, reg=reg, jm=jm, tm=tm, x=x,
                params=params, stats=stats)


def test_eval_forward_matches_jax(built):
    """float32, eval mode (running statistics, no dropout), within 1e-5 of
    the largest output."""
    b = built
    want = jax.jit(lambda v, x: b["jm"].apply(v, x, train=False))(
        {"params": b["params"], "batch_stats": b["stats"]},
        jnp.asarray(b["x"]))
    with torch.no_grad():
        got = b["tm"].eval()(_nchw(b["x"]))
    _close(want, got, FWD_TOL)


def test_train_forward_and_statistics_match_jax(built):
    """float64, train mode: the outputs and the updated running statistics
    within 1e-9 of their largest element; the port draws every keep mask
    (PNet's two head dropouts, ENet's 27 bottleneck dropouts, EffiUNet's 19
    drop-connects where the rate is above 0, the stride 1 and the width
    kept) and JAX replays them in its call order."""
    b = built
    tm = b["tm"]
    sd = {k: v.clone() for k, v in tm.state_dict().items()}
    draws = _Draws(3)
    mp = pytest.MonkeyPatch()
    _patch_port(mp, draws)
    try:
        tm.double().train()
        got = tm(_nchw(b["x"]).double())
    finally:
        mp.undo()
    _, got_stats = flax_from_state_dict(b["reg"], tm.state_dict())
    tm.load_state_dict(sd)
    tm.float()

    def f64(t):
        return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), t)
    mp = pytest.MonkeyPatch()
    _patch_jax(mp, draws)
    try:
        with jax.enable_x64(True):
            # jitted (an eager Flax apply of EffiUNet takes 15 s here): the
            # draws are replayed once, at trace time
            want, new = jax.jit(lambda v, x: b["jm"].apply(
                v, x, train=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0)}))(
                {"params": f64(b["params"]), "batch_stats": f64(b["stats"])},
                jnp.asarray(b["x"], jnp.float64))
            want = jax.tree_util.tree_map(np.asarray, want)
            want_stats = jax.tree_util.tree_map(np.asarray,
                                                new["batch_stats"])
    finally:
        mp.undo()
    assert draws.cursor == len(draws.log)
    keeps = {"pnet": 2, "enet": 27, "efficient_unet": 19, "res2net": 0}
    assert len(draws.of("keep")) == keeps[b["net"]]
    _close(want, got, F64_TOL)
    leaves = jax.tree_util.tree_leaves
    big = max(float(np.abs(a).max()) for a in leaves(want_stats))
    for a, c, s in zip(leaves(want_stats), leaves(got_stats),
                       leaves(b["stats"])):
        np.testing.assert_allclose(c, a, rtol=0, atol=F64_TOL * big)
        assert not np.allclose(a, s)


@pytest.mark.parametrize("net", sorted(FULL_WIDTH))
def test_full_width_conversion_round_trips_and_counts(net):
    """At full width (1 -> 4 classes) the Flax tree goes into the port's
    module and back unchanged, and the parameter counts are JAX's."""
    jm = jfactory.net_factory(net, 1, 4)
    params, stats = filled(jm, np.zeros((1, 64, 64, 1), np.float32))
    tm = tfactory.net_factory(net, 1, 4)
    sd = state_dict_from_flax(net, params, stats)
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    p2, s2 = flax_from_state_dict(net, tm.state_dict())
    for want, got in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        for a, c in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            assert a.shape == c.shape
            np.testing.assert_array_equal(a, c)
    n = sum(p.numel() for p in tm.parameters())
    assert n == FULL_WIDTH[net] == sum(
        a.size for a in jax.tree_util.tree_leaves(params))


def test_full_preunet_eval_forward_matches_jax():
    """The whole PreUNet (Res2Net-101's layers 3, 4, 23 and the decoder)
    at 64^2, float32, eval mode, within 1e-5 of the largest logit."""
    jm = jres.PreUNet()
    x = _image((1, 64, 64, 1))
    params, stats = filled(jm, x)
    tm = tres.PreUNet()
    tm.load_state_dict(state_dict_from_flax("preunet", params, stats))
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    _close(want, got, FWD_TOL)


def test_registry_equals_jax():
    assert tfactory.available_2d() == jfactory.available_2d()
    for net in FULL_WIDTH:
        assert type(tfactory.net_factory(net, 1, 4)).__name__ == type(
            jfactory.net_factory(net, 1, 4)).__name__


def test_enet_mask_unpool_on_ties_matches_jax():
    """A map with tied windows (zeros after a ReLU, a plateau): the mask
    marks every tied position, as JAX's does, and the unpool places the
    value at each; ``nn.MaxUnpool2d`` (one index a window) differs."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.normal(0, 1, (2, 8, 6, 3)), 0).astype(np.float32)
    x[0, :2, :2, 0] = 0.7                       # a tied plateau
    x[1, 2:4, 2:4, 1] = 0.0                     # a window of zeros
    jp, jmask = jenet._max_pool_with_mask(jnp.asarray(x))
    v = rng.normal(0, 1, jp.shape).astype(np.float32)
    jun = jenet._unpool_with_mask(jnp.asarray(v), jmask)
    tp, tmask = tenet.max_pool_with_mask(_nchw(x))
    tun = tenet.unpool_with_mask(_nchw(v), tmask)
    np.testing.assert_array_equal(tp.numpy(), np.moveaxis(np.asarray(jp), -1,
                                                          1))
    np.testing.assert_array_equal(tmask.numpy(),
                                  np.moveaxis(np.asarray(jmask), -1, 1))
    np.testing.assert_array_equal(tun.numpy(),
                                  np.moveaxis(np.asarray(jun), -1, 1))
    assert tmask.numpy()[0, 0, :2, :2].sum() == 4
    _, idx = F.max_pool2d(_nchw(x), 2, return_indices=True)
    torch_un = F.max_unpool2d(_nchw(v), idx, 2, output_size=x.shape[1:3])
    assert not torch.equal(torch_un, tun)


@pytest.mark.parametrize("side", [(5, 6), (4, 7)])
def test_enet_transpose_head_at_odd_sides_matches_jax(side):
    """Flax's 3x3 stride-2 SAME ``ConvTranspose`` cropped to twice the
    input's sides is torch's ``conv_transpose2d`` with no padding and the
    flipped kernel, cropped the same; ``padding=1, output_padding=1`` is
    one pixel off."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (1, *side, 3)).astype(np.float32)
    k = rng.normal(0, 1, (3, 3, 3, 4)).astype(np.float32)
    h, w = 2 * side[0], 2 * side[1]
    want = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), use_bias=False).apply(
        {"params": {"kernel": k}}, jnp.asarray(x))[:, :h, :w]
    want = np.moveaxis(np.asarray(want), -1, 1)
    wt = torch.from_numpy(torch_kernel(k, "tkernel"))
    got = F.conv_transpose2d(_nchw(x), wt, stride=2)[:, :, :h, :w]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    off = F.conv_transpose2d(_nchw(x), wt, stride=2, padding=1,
                             output_padding=1)
    assert float((off - torch.tensor(want)).abs().max()) > 0.1


def test_effiunet_static_same_pads_match_jax():
    """Every depthwise conv's pads and the stem's are JAX's ``_same_pad``
    along the B3 ladder at 300 (150, 75, 38, 19, 10), whatever the input:
    (0, 1) on the stem and the first blocks of stages 2 and 4, (2, 2) on the
    5x5 stride-2 ones."""
    enc = teff.EffiUNet().encoder
    size = 300
    assert enc._conv_stem.pads == jeff._same_pad(size, 3, 2)[0] * 2 == (
        0, 1, 0, 1)
    size = -(-size // 2)
    asym = []
    blocks = iter(enc._blocks)
    for t, k, s, c, r in jeff._B0_STAGES:
        for j in range(jeff._round_repeats(r, 1.4)):
            stride = s if j == 0 else 1
            dw = next(blocks)._depthwise_conv
            assert dw.pads == jeff._same_pad(size, k, stride)[0] * 2
            assert dw.stride == (stride, stride)
            assert dw.groups == dw.in_channels
            if dw.pads[0] != dw.pads[1]:
                asym.append(size)
            if stride == 2:
                size = -(-size // 2)
    assert asym == [150, 38]
    assert size == 10
    with pytest.raises(StopIteration):
        next(blocks)


def test_test_2d_runs_pnet(tmp_path):
    """``test_2d --model pnet`` on a tiny ACDC tree with a saved PNet2D:
    the per-class Dice table and every case's three exports."""
    root = str(tmp_path / "ACDC")
    tsyn.make_synthetic_acdc(root, num_cases=4, num_val=2, size=40, seed=3)
    flags = ttest2d.build_parser().parse_args([
        "--root_path", root, "--exp", "ACDC/pnet", "--model", "pnet",
        "--labeled_num", "3", "--patch_size", "32", "32",
        "--list_name", "val.list", "--snapshot_root", str(tmp_path / "snap"),
        "--device", "cpu"])
    os.makedirs(ttest3d.snapshot_dir(flags))
    torch.manual_seed(0)
    torch.save(tpnet.PNet2D().state_dict(), os.path.join(
        ttest3d.snapshot_dir(flags), "pnet_best_model.ckpt"))
    avg = ttest2d.inference(flags)
    assert avg.shape == (3, 1) and np.isfinite(avg).all()
    out = os.listdir(ttest3d.snapshot_dir(flags) + "_predictions")
    with open(os.path.join(root, "val.list")) as f:
        cases = [ln.strip() for ln in f if ln.strip()]
    assert sorted(out) == sorted(f"{c}_{t}.nii.gz" for c in cases
                                 for t in ("pred", "img", "gt"))
