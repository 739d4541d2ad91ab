"""Pretrained weights from a local ``.pth`` (``models/cnn_checkpoint.py``
and ``Engine.init_state``) against the JAX package on the CPU.

The files are written here from a seed under the published schemas: the
EfficientNet-B3 ``state_dict`` of ``tests/effnet_standin.py`` (an
independent reconstruction of lukemelas' module), the Res2Net v1b schema
from the port's encoder (read by JAX's ``convert_res2net_encoder``, whose
key reads are the oracle), a whole reference ``Effi_UNet`` with a
1-channel stem, and Swin files (``tests/pth_fixtures.py::
make_swin_tiny_pth``'s Swin-tiny, and a thin one from the port's own
SwinUnet for the engine). Checked: the encoders' forwards after loading
against JAX's converters and forwards (float32, within 1e-5 of the largest
output); the family sniff, the wrappers, the missing-file and
shape-mismatch errors; the Swin route against JAX's; and the engine: the
teacher starts from the file's weights, a model of another family is
untouched, and a resumed ``fit`` is bit-equal to an uninterrupted one."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import cnn_checkpoint as jcc
from cvssl_tpu.models import efficientunet as jeff
from cvssl_tpu.models import resunet as jres
from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.models import cnn_checkpoint as tcc
from cvssl_tpu_torch.models import efficientunet as teff
from cvssl_tpu_torch.models import resunet as tres
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import fit
from cvssl_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
from effnet_standin import EfficientNet  # noqa: E402
from pth_fixtures import make_swin_tiny_pth  # noqa: E402
from test_torch_port_zoo2d import filled  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# float32 forwards agree within this share of the largest output
FWD_TOL = 1e-5
LAYERS = (1, 1, 2)
THIN_SWIN = dict(embed_dim=24, depths=(2, 2), num_heads=(1, 2),
                 window_size=4)


def _perturb_norms(module, seed):
    """BatchNorm statistics and affines off their (0, 1) start."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    return module


def _np(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _close(want, got, tol=FWD_TOL):
    a = np.moveaxis(np.asarray(want), -1, 1)
    b = got.detach().numpy()
    assert a.shape == b.shape
    assert float(np.abs(a - b).max()) <= tol * float(np.abs(a).max())


def _image(shape, seed=1):
    return np.random.default_rng(seed).normal(0.5, 0.3, shape).astype(
        np.float32)


def _short_preunet():
    """PreUNet with a Res2Net encoder of ``LAYERS`` blocks (its maps have
    the full one's widths, so the decoder is the full one's)."""
    tm = tres.PreUNet()
    tm.encoder = tres.Res2NetEncoder(LAYERS)
    return tm


@pytest.fixture(scope="module")
def effnet_sd():
    """The stand-in's EfficientNet-B3 ``state_dict`` (head included)."""
    torch.manual_seed(0)
    return {k: v.detach().clone() for k, v in _perturb_norms(
        EfficientNet.from_name("efficientnet-b3"), 1).state_dict().items()}


@pytest.fixture(scope="module")
def res2net_sd():
    """The Res2Net v1b schema at ``LAYERS``, written from the port's
    encoder, with a ``layer4`` block and ``fc`` that PreUNet does not
    build."""
    torch.manual_seed(0)
    sd = dict(_perturb_norms(tres.Res2NetEncoder(LAYERS), 2).state_dict())
    sd["layer4.0.conv1.weight"] = torch.randn(416, 1024, 1, 1)
    sd["fc.weight"] = torch.randn(1000, 2048)
    sd["fc.bias"] = torch.randn(1000)
    return sd


def test_efficientnet_encoder_matches_jax_converter(effnet_sd, tmp_path):
    """The B3 file through the port's loader and through JAX's
    ``convert_efficientnet_encoder``, under the same decoder: the eval
    forwards agree; the encoder is the file's, tensor for tensor."""
    path = str(tmp_path / "efficientnet-b3.pth")
    torch.save(effnet_sd, path)
    sd = tcc.load_torch_state_dict(path)
    assert tcc.checkpoint_family(sd) == "efficientnet"
    jm = jeff.EffiUNet()
    x = _image((2, 64, 64, 1))
    params, stats = filled(jm, x)
    # the port's decoder is JAX's; its encoder comes from the file
    tm = teff.EffiUNet()
    tm.load_state_dict(state_dict_from_flax("efficient_unet", params, stats))
    decoder = {k: v.clone() for k, v in tm.state_dict().items()
               if not k.startswith("encoder.")}
    assert tcc.maybe_load_encoder(tm, sd)
    for k, v in tm.state_dict().items():
        if k.startswith("encoder.") and "num_batches" not in k:
            assert torch.equal(v, sd[k[len("encoder."):]]), k
        elif not k.startswith("encoder."):
            assert torch.equal(v, decoder[k]), k
    enc_p, enc_s = jcc.convert_efficientnet_encoder(_np(effnet_sd))
    params = {**params, "EfficientNetEncoder_0": enc_p}
    stats = {**stats, "EfficientNetEncoder_0": enc_s}
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    _close(want, got)


def test_res2net_schema_is_read_as_jax_reads_it(res2net_sd, tmp_path):
    """The Res2Net file into the port's PreUNet (its encoder takes the
    file's tensors; ``layer4``, ``fc`` and the decoder are left) and through
    JAX's ``convert_res2net_encoder``: the same Flax tree as the port's
    converter makes of the encoder, and the same stem and layer maps."""
    path = str(tmp_path / "res2net101_v1b_26w_4s.pth")
    torch.save({"state_dict": res2net_sd}, path)
    sd = tcc.load_torch_state_dict(path)
    assert tcc.checkpoint_family(sd) == "res2net"
    torch.manual_seed(3)
    tm = _short_preunet()
    decoder = {k: v.clone() for k, v in tm.state_dict().items()
               if not k.startswith("encoder.")}
    assert tcc.maybe_load_encoder(tm, sd)
    for k, v in tm.encoder.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, res2net_sd[k]), k
    for k, v in decoder.items():
        assert torch.equal(v, tm.state_dict()[k]), k
    jp, js = jcc.convert_res2net_encoder(_np(res2net_sd), layers=LAYERS)
    ported = state_dict_from_flax("res2net_encoder", jp, js)
    for k, v in ported.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, res2net_sd[k]), k
    x = _image((2, 64, 64, 3))
    stem, feats = jax.jit(lambda v, x: jres.Res2NetEncoder(
        layers=LAYERS).apply(v, x, train=False))(
        {"params": jp, "batch_stats": js}, jnp.asarray(x))
    with torch.no_grad():
        tstem, tfeats = tm.encoder.eval()(_nchw(x))
    for want, got in zip([stem, *feats], [tstem, *tfeats]):
        _close(want, got)


def test_full_effiunet_with_one_channel_stem_matches_jax(tmp_path):
    """A whole reference ``Effi_UNet`` ``state_dict`` (its stem summed to
    one input channel, head keys the port ignores) through the port's
    ``convert_effiunet_full`` and JAX's: the eval forwards on 1-channel
    input agree."""
    torch.manual_seed(4)
    sd = dict(_perturb_norms(teff.EffiUNet(), 5).state_dict())
    sd["encoder._conv_stem.weight"] = sd["encoder._conv_stem.weight"].sum(
        dim=1, keepdim=True)
    sd["encoder._conv_head.weight"] = torch.randn(1536, 384, 1, 1)
    sd["encoder._fc.weight"] = torch.randn(1000, 1536)
    tm = teff.EffiUNet()
    tm.load_state_dict(tcc.convert_effiunet_full(sd, tm))
    params, stats = jcc.convert_effiunet_full(
        {k: v.numpy() for k, v in sd.items()
         if not k.endswith("num_batches_tracked")})
    x = _image((2, 64, 64, 1))
    want = jax.jit(lambda v, x: jeff.EffiUNet().apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(_nchw(x))
    _close(want, got)


def test_family_sniff_matches_jax(effnet_sd, res2net_sd, tmp_path):
    swin = make_swin_tiny_pth(str(tmp_path / "swin.pth"))
    unet = {"encoder.in_conv.conv_conv.0.weight": np.zeros((16, 1, 3, 3))}
    for sd, family in ((swin, "swin"), (_np(effnet_sd), "efficientnet"),
                       (_np(res2net_sd), "res2net"), (unet, "unknown")):
        assert jcc.checkpoint_family(sd) == family
        assert tcc.checkpoint_family(
            {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
        ) == family


def test_missing_file_and_shape_mismatch_raise(res2net_sd, effnet_sd,
                                               tmp_path):
    """A missing file raises ``FileNotFoundError`` in both packages; a
    file of the right family but another geometry, or missing a tensor,
    raises ``ValueError`` and loads nothing."""
    for load in (tcc.load_torch_state_dict, jcc.load_torch_state_dict):
        with pytest.raises(FileNotFoundError,
                           match="pretrained checkpoint not found"):
            load(str(tmp_path / "missing.pth"))
    tm = _short_preunet()
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    wrong = dict(res2net_sd)
    wrong["layer1.0.convs.0.weight"] = torch.zeros(26, 26, 5, 5)
    with pytest.raises(ValueError, match="layer1.0.convs.0.weight"):
        tcc.maybe_load_encoder(tm, wrong)
    short = {k: v for k, v in res2net_sd.items() if not k.startswith(
        "layer3.1.")}
    with pytest.raises(ValueError, match="layer3.1"):
        tcc.maybe_load_encoder(tm, short)
    # the full-depth PreUNet takes no file of three layers (1, 1, 2)
    with pytest.raises(ValueError, match="layer1.1"):
        tcc.maybe_load_encoder(tres.PreUNet(), res2net_sd)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k
    narrow = dict(effnet_sd)
    narrow["_bn0.weight"] = torch.ones(32)
    with pytest.raises(ValueError, match="_bn0.weight"):
        tcc.maybe_load_encoder(teff.EffiUNet(), narrow)
    # another family's model, or another family's file: untouched
    assert not tcc.maybe_load_encoder(teff.EffiUNet(), res2net_sd)
    assert not tcc.maybe_load_encoder(tm, effnet_sd)


def test_swin_route_matches_jax(tmp_path):
    """The Swin-tiny file into a SwinUnet-tiny at 224 in both packages
    (JAX's ``maybe_load_encoder`` on zeros, the port's through
    ``swin_checkpoint.load_from`` on a zeroed model): the same tensors
    land in the same places (the encoder, and ``layers.{i}.blocks`` in
    ``layers_up.{3-i}``), the rest stays 0; a file of no matching shape
    raises."""
    path = str(tmp_path / "swin_tiny_patch4_window7_224.pth")
    make_swin_tiny_pth(path)
    sd = tcc.load_torch_state_dict(path)
    assert tcc.checkpoint_family(sd) == "swin"
    jm = jswin.SwinUnet(num_classes=4, img_size=224, window_size=7)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False),
                            {"params": jax.random.PRNGKey(0),
                             "dropout": jax.random.PRNGKey(1)},
                            jnp.zeros((1, 224, 224, 1), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                   shapes["params"])
    jparams, _, loaded = jcc.maybe_load_encoder(
        jm, zeros, {}, jcc.load_torch_state_dict(path))
    assert loaded
    want = state_dict_from_flax("swin_unet", jax.tree_util.tree_map(
        np.asarray, jparams), {})
    tm = tswin.SwinUnet(num_classes=4, img_size=224)
    with torch.no_grad():
        for v in tm.state_dict().values():
            v.zero_()
    assert tcc.maybe_load_encoder(tm, sd)
    got = tm.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got["layers_up.2.blocks.1.mlp.fc1.weight"],
                       sd["layers.1.blocks.1.mlp.fc1.weight"])
    thin = tswin.SwinUnet(num_classes=4, img_size=32, **THIN_SWIN)
    with pytest.raises(ValueError, match="matched no SwinUnet tensors"):
        tcc.maybe_load_encoder(thin, {k: v for k, v in sd.items()
                                      if k.startswith("layers.")})


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tsyn.make_synthetic_acdc(str(tmp_path_factory.mktemp("acdc")
                                        / "ACDC"), num_cases=4, num_val=1,
                                    size=40)


def _cfg(root, snap, **kw):
    base = dict(root_path=root, exp="ACDC/pretrained", method="mean_teacher",
                model="efficient_unet", num_classes=4, batch_size=4,
                labeled_bs=2, labeled_slices_override=8, patch_size=(32, 32),
                dtype="float32", val_every=2, ckpt_every=2, log_every=1,
                snapshot_root=str(snap))
    return TConfig(**{**base, **kw})


def test_init_state_loads_the_student_and_its_teacher(effnet_sd, tmp_path):
    """mean_teacher on EffiUNet with the B3 file: the student's and the
    teacher's encoders are the file's, their decoders the seed's (as
    without the file)."""
    path = str(tmp_path / "b3.pth")
    torch.save(effnet_sd, path)
    state = TEngine(_cfg("", tmp_path, pretrained_ckpt=path),
                    device="cpu").init_state()
    plain = TEngine(_cfg("", tmp_path), device="cpu").init_state()
    for m in (state.models["model"], state.teachers["model"]):
        for k, v in m.state_dict().items():
            if k.startswith("encoder.") and "num_batches" not in k:
                assert torch.equal(v, effnet_sd[k[len("encoder."):]]), k
            elif not k.startswith("encoder."):
                assert torch.equal(v, plain.models["model"].state_dict()[k])


def test_init_state_loads_swin_into_its_slot_only(tmp_path):
    """cross_teaching (a UNet and a thin SwinUnet) with a Swin file made
    from a SwinUnet of that geometry: ``model2`` takes it (the encoder, and
    ``layers.0``'s blocks in ``layers_up.1``), ``model1`` is as without the
    file."""
    torch.manual_seed(7)
    src = tswin.SwinUnet(num_classes=4, img_size=32, **THIN_SWIN)
    sd = {k: v for k, v in src.state_dict().items()
          if not k.startswith(("layers_up.", "concat_back_dim", "norm_up",
                               "up.", "output."))}
    path = str(tmp_path / "swin_thin.pth")
    torch.save({"model": sd}, path)
    kw = dict(method="cross_teaching", model="unet", model2="swin_unet",
              vit_kwargs=THIN_SWIN)
    state = TEngine(_cfg("", tmp_path, pretrained_ckpt=path, **kw),
                    device="cpu").init_state()
    plain = TEngine(_cfg("", tmp_path, **kw), device="cpu").init_state()
    got = state.models["model2"].state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    for k, v in got.items():
        if k.startswith("layers_up.1.blocks."):
            assert torch.equal(v, sd["layers.0." + k[len("layers_up.1."):]])
    for k, v in state.models["model1"].state_dict().items():
        assert torch.equal(v, plain.models["model1"].state_dict()[k]), k


def test_fit_with_pretrained_ckpt_resumes_bit_equal(root, effnet_sd,
                                                    tmp_path):
    """``fit`` of mean_teacher on EffiUNet with the B3 file, stopped at the
    checkpoint at 2 and resumed to 4, equals 4 in one run bit for bit
    (weights, statistics, teacher, optimizer, generator); the log names
    the loaded slot."""
    path = str(tmp_path / "b3.pth")
    torch.save(effnet_sd, path)
    straight = fit(_cfg(root, tmp_path / "a", pretrained_ckpt=path),
                   max_steps=4, device="cpu")
    cfg = _cfg(root, tmp_path / "b", pretrained_ckpt=path)
    fit(cfg, max_steps=2, device="cpu")
    resumed = fit(cfg, max_steps=4, device="cpu")
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        log = f.read()
    assert "loaded pretrained encoder into model from" in log
    assert "resumed from iteration 2" in log
    ta, tb = (ckpt.state_tree(r["state"]) for r in (straight, resumed))
    assert ta["step"] == tb["step"] == 4
    for group in ("models", "teachers"):
        for k, v in ta[group]["model"].items():
            assert torch.equal(v, tb[group]["model"][k]), (group, k)
    oa, ob = ta["optimizers"]["model"], tb["optimizers"]["model"]
    assert oa["count"] == ob["count"] == 4
    for i, st in oa["state"]["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           ob["state"]["state"][i]["momentum_buffer"])
    assert torch.equal(ta["generator"], tb["generator"])
    assert straight["best_dice"] == resumed["best_dice"]
