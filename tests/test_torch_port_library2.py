"""The last library modules against the JAX package on the CPU:
``models/initializers.py::init_weights``, the strong host transforms of
``data/transforms.py`` (``rand_affine``, ``gaussian_blur``, ``grid_mask``,
``RandomGeneratorStrong``), ``ops/losses.py::con_loss_queue``,
``models/factory.py::register_2d``/``register_3d``,
``models/unet.py::bilinear_resize`` and ``models/swin_unet.py::DropPath``.

Tolerances: the transforms bit-equal, with the generators in the same
state after; ``init_weights``' draws are not ``jax.random``'s, so its
statistics are held to the bounds of JAX's own test
(``tests/test_gan_scaffolding.py::test_init_weights_semantics``: the
normal std within 0.005 of 0.02, the others within 10% of their std, the
scales' mean within 0.05 of 1) and orthogonality to 1e-4, and which
tensors it re-samples, sets about 1, zeroes or leaves is JAX's choice,
tensor for tensor; ``con_loss_queue`` rtol 1e-5; ``bilinear_resize``
within 1e-6 of the largest element (another float32 order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data import transforms as jtr
from cvssl_tpu.models import attention as jatt
from cvssl_tpu.models import discriminator as jdisc
from cvssl_tpu.models import enet as jenet
from cvssl_tpu.models import gan as jgan
from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu.models import unet as junet
from cvssl_tpu.models import unet3d as junet3d
from cvssl_tpu.models.initializers import init_weights as jinit
from cvssl_tpu.ops import losses as jl
from cvssl_tpu_torch.data import transforms as ttr
from cvssl_tpu_torch.models import attention as tatt
from cvssl_tpu_torch.models import discriminator as tdisc
from cvssl_tpu_torch.models import enet as tenet
from cvssl_tpu_torch.models import factory as tfactory
from cvssl_tpu_torch.models import gan as tgan
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models import unet3d as tunet3d
from cvssl_tpu_torch.models.convert import _leaves_of, flax_kernel
from cvssl_tpu_torch.models.initializers import init_weights
from cvssl_tpu_torch.ops import losses as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# init_weights: statistics
# ---------------------------------------------------------------------------

def _stats_net():
    """JAX's test's net (ndf 16, 3 levels), from ``define_d``."""
    return tgan.define_d(16, "basic", input_nc=3)


@pytest.mark.parametrize("init_type", ["normal", "xavier", "kaiming"])
def test_init_weights_statistics(init_type):
    """JAX's test's bounds: Conv_2's (``model.5``) std (its fans on the
    Flax shape: 4 * 4 * 32 in, 4 * 4 * 64 out), Conv_0's bias
    (``model.0``) exactly 0, _Norm_0's scale (``model.3``) about 1."""
    sd = init_weights(_stats_net(), init_type,
                      torch.Generator().manual_seed(1)).state_dict()
    fan_in, fan_out = 4 * 4 * 32, 4 * 4 * 64
    std = {"normal": 0.02, "xavier": (2.0 / (fan_in + fan_out)) ** 0.5,
           "kaiming": (2.0 / fan_in) ** 0.5}[init_type]
    bound = 0.005 if init_type == "normal" else 0.1 * std
    assert abs(float(sd["model.5.weight"].std()) - std) < bound
    assert float(sd["model.0.bias"].abs().max()) == 0.0
    assert abs(float(sd["model.3.weight"].mean()) - 1.0) < 0.05


def test_init_weights_transpose_conv_fan_is_jax():
    """A transpose conv's fan-in is in * prod(k) on the Flax shape
    (4, 4, 64, 8): 1024, where ``nn.init.kaiming_normal_`` on the port's
    (64, 8, 4, 4) would take 8 * 16; and every weight is re-sampled, the
    bias zeroed."""
    m = torch.nn.ConvTranspose2d(64, 8, 4, stride=2, padding=1)
    init_weights(m, "kaiming", torch.Generator().manual_seed(2))
    want = (2.0 / 1024) ** 0.5
    assert abs(float(m.weight.detach().std()) - want) / want < 0.1
    assert float(m.bias.detach().abs().max()) == 0.0


@pytest.mark.parametrize("layer", ["conv", "conv_wide", "tconv", "linear"])
def test_init_weights_orthogonal(layer):
    """The Flax matrix (prod(k) * in, out) orthonormal along its shorter
    side, to 1e-4: the columns of a conv's (72, 16) and a transpose
    conv's (256, 8), the rows of a 1x1 conv's (4, 64) and a linear
    layer's (8, 32)."""
    m = {"conv": lambda: torch.nn.Conv2d(8, 16, 3),
         "conv_wide": lambda: torch.nn.Conv2d(4, 64, 1),
         "tconv": lambda: torch.nn.ConvTranspose2d(16, 8, 4),
         "linear": lambda: torch.nn.Linear(8, 32)}[layer]()
    init_weights(m, "orthogonal", torch.Generator().manual_seed(3))
    w = m.weight.detach().numpy().astype(np.float64)
    if layer == "linear":
        flat = w.T
    else:
        k = flax_kernel(w, "tkernel" if layer == "tconv" else "kernel")
        flat = k.reshape(-1, k.shape[-1])
    gram = flat.T @ flat if flat.shape[0] >= flat.shape[1] else flat @ flat.T
    np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-4)


def test_init_weights_unknown_type_raises_as_jax():
    with pytest.raises(NotImplementedError):
        init_weights(_stats_net(), "bogus")
    with pytest.raises(NotImplementedError):
        jinit({}, jax.random.PRNGKey(5), "bogus")


# ---------------------------------------------------------------------------
# init_weights: which tensors, against JAX's leaf names
# ---------------------------------------------------------------------------

# net -> (JAX module, its init's inputs (NHWC), port module, converter name)
CLASSIFY = {
    "unet": (lambda: junet.UNet(in_chns=1, num_classes=4),
             [(1, 32, 32, 1)], lambda: tunet.UNet(1, 4), "unet"),
    "unet_3D": (lambda: junet3d.UNet3D(num_classes=2), [(1, 16, 16, 16, 1)],
                lambda: tunet3d.UNet3D(1, 2), "unet_3D"),
    "discriminator": (lambda: jdisc.FCDiscriminator(num_classes=4),
                      [(1, 64, 64, 4), (1, 64, 64, 1)],
                      lambda: tdisc.FCDiscriminator(4, 1,
                                                    patch_size=(64, 64)),
                      "discriminator"),
    "swin_unet": (lambda: jswin.SwinUnet(num_classes=4, embed_dim=24,
                                         depths=(2, 2), num_heads=(3, 6),
                                         window_size=7),
                  [(1, 56, 56, 1)],
                  lambda: tswin.SwinUnet(num_classes=4, img_size=56,
                                         embed_dim=24, depths=(2, 2),
                                         num_heads=(3, 6), window_size=7),
                  "swin_unet"),
    "enet": (jenet.ENet, [(1, 64, 64, 1)], tenet.ENet, "enet"),
    "resnet_generator": (lambda: jgan.ResnetGenerator(1, 8, n_blocks=2),
                         [(1, 16, 16, 1)],
                         lambda: tgan.ResnetGenerator(1, 8, n_blocks=2),
                         "resnet_generator"),
    "unet_generator": (lambda: jgan.UnetGenerator(1, 5, 4),
                       [(1, 32, 32, 1)], lambda: tgan.UnetGenerator(1, 5, 4),
                       "unet_generator"),
    "nlayer_discriminator": (lambda: jgan.NLayerDiscriminator(8, 3),
                             [(1, 32, 32, 1)],
                             lambda: tgan.NLayerDiscriminator(8, 3),
                             "nlayer_discriminator"),
    "scse": (lambda: jatt.SCSEModule(reduction=4), [(1, 8, 8, 16)],
             lambda: tatt.SCSEModule(16, reduction=4), "scse"),
}
FILL = 5.0


def _kind(v: np.ndarray, before: np.ndarray) -> str:
    """What ``init_weights`` (type "normal") did to a tensor that held
    ``before`` (every element FILL)."""
    if np.array_equal(v, before):
        return "untouched"
    if not v.any():
        return "zeroed"
    if np.abs(v - 1.0).max() < 0.2:
        return "scale"
    assert np.abs(v).max() < 0.2
    return "resampled"


def _jax_kinds(jm, shapes):
    """JAX's ``init_weights`` on the net's Flax tree, every leaf FILL at
    its own rank (two elements a side: which leaves it re-samples depends
    on their names and ranks only), as {path: kind}."""
    tree = jax.eval_shape(
        lambda k, *x: jm.init(k, *x, **({} if isinstance(
            jm, jatt.SCSEModule) else {"train": False})),
        jax.random.PRNGKey(0), *[jnp.zeros(s) for s in shapes])["params"]
    small = jax.tree_util.tree_map(
        lambda a: np.full((2,) * a.ndim, FILL, np.float32), tree)
    out = jinit(small, jax.random.PRNGKey(1), "normal")
    flat = jax.tree_util.tree_flatten_with_path(out)[0]
    return {tuple(str(p.key) for p in path):
            _kind(np.asarray(v), np.full(v.shape, FILL, np.float32))
            for path, v in flat}, tree


@pytest.mark.parametrize("net", sorted(CLASSIFY))
def test_init_weights_touches_what_jax_touches(net):
    """Every tensor of the port's ``state_dict`` (each set to FILL) comes
    out of ``init_weights`` re-sampled, about 1, zeroed or untouched
    exactly as its Flax leaf does out of JAX's (``models/convert.py``'s
    leaves pair them; BatchNorm's running statistics are outside JAX's
    params and untouched)."""
    jf, shapes, tf, conv = CLASSIFY[net]
    want_flax, tree = _jax_kinds(jf(), shapes)
    tm = tf()
    with torch.no_grad():
        for v in tm.state_dict().values():
            v.fill_(FILL)
    init_weights(tm, "normal", torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    got = {k: _kind(v.numpy(), np.full(v.shape, FILL, v.numpy().dtype))
           for k, v in sd.items()}
    want = {key: want_flax[path] if coll == "params" else "untouched"
            for key, coll, path, _ in _leaves_of(conv, tree)}
    assert set(want) == set(got)
    assert got == want
    assert set(want_flax) == {path for _, coll, path, _ in
                              _leaves_of(conv, tree) if coll == "params"}


# ---------------------------------------------------------------------------
# the strong host transforms
# ---------------------------------------------------------------------------

def _slice(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(
        np.float32)


TRANSFORMS = {
    "rand_affine": lambda m, rng, x: m.rand_affine(rng, x),
    "gaussian_blur": lambda m, rng, x: m.gaussian_blur(rng, x),
    "grid_mask": lambda m, rng, x: m.grid_mask(rng, x),
    "grid_mask_always": lambda m, rng, x: m.grid_mask(rng, x, prob=1.0),
}


@pytest.mark.parametrize("shape", [(37, 41), (64, 48)], ids=["odd", "even"])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_is_bit_equal_to_jax(name, shape):
    """Ten calls on one generator each side: equal arrays and dtypes, and
    the generators in the same state after."""
    fn = TRANSFORMS[name]
    a, b = np.random.default_rng(7), np.random.default_rng(7)
    for i in range(10):
        x = _slice(shape, i)
        want, got = fn(jtr, a, x.copy()), fn(ttr, b, x.copy())
        assert want.dtype == got.dtype
        np.testing.assert_array_equal(got, want)
    assert a.bit_generator.state == b.bit_generator.state


@pytest.mark.parametrize("shape", [(37, 41), (300, 211)], ids=["small",
                                                                "large"])
def test_random_generator_strong_is_bit_equal_to_jax(shape):
    """Odd-sized slices to a 64 x 48 patch, 12 samples, one generator
    each side: image and label bit-equal, the generators' states equal."""
    a = jtr.RandomGeneratorStrong((64, 48), np.random.default_rng(11))
    b = ttr.RandomGeneratorStrong((64, 48), np.random.default_rng(11))
    for i in range(12):
        sample = {"image": _slice(shape, i),
                  "label": np.random.default_rng(100 + i).integers(
                      0, 4, shape).astype(np.uint8)}
        want, got = a(dict(sample)), b(dict(sample))
        assert set(want) == set(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert a.rng.bit_generator.state == b.rng.bit_generator.state


# ---------------------------------------------------------------------------
# the stray names
# ---------------------------------------------------------------------------

def test_con_loss_queue_is_con_loss_as_in_jax():
    rng = np.random.default_rng(12)
    q, k = (rng.normal(size=(2, 8, 4, 4)).astype(np.float32)
            for _ in range(2))
    assert tl.con_loss_queue is tl.con_loss
    want = jl.con_loss_queue(jnp.asarray(q), jnp.asarray(k))
    got = tl.con_loss_queue(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_register_adds_to_the_registry(dim):
    """The decorator enters the constructor under its name and returns it
    unchanged; the factory then builds it (the entry is taken out
    after)."""
    reg = tfactory.register_2d if dim == 2 else tfactory.register_3d
    factory = (tfactory.net_factory if dim == 2
               else tfactory.net_factory_3d)
    table = tfactory._REGISTRY_2D if dim == 2 else tfactory._REGISTRY_3D

    def build(in_chns, class_num, **kw):
        return torch.nn.Conv2d(in_chns, class_num, 1, **kw)
    try:
        assert reg("test_only_net")(build) is build
        m = factory("test_only_net", in_chns=2, class_num=5, bias=False)
        assert m.weight.shape == (5, 2, 1, 1) and m.bias is None
        listed = (tfactory.available_2d() if dim == 2
                  else tfactory.available_3d())
        assert "test_only_net" in listed
    finally:
        table.pop("test_only_net", None)
    assert "test_only_net" not in table


@pytest.mark.parametrize("hw,align", [((14, 18), True), ((13, 5), True),
                                      ((1, 5), True), ((7, 9), True),
                                      ((14, 18), False), ((3, 4), False)])
def test_bilinear_resize_matches_jax(hw, align):
    """Up and down, align_corners or half-pixel (antialiased down, as
    ``jax.image.resize``), a side of 1 (JAX's half-pixel fallback), the
    same size (the input back)."""
    x = np.random.default_rng(13).normal(size=(2, 7, 9, 3)).astype(
        np.float32)
    want = np.asarray(junet.bilinear_resize(jnp.asarray(x), hw, align))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    got = tunet.bilinear_resize(xt, hw, align)
    if hw == (7, 9):
        assert got is xt
    got = got.numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_drop_path_module():
    """Eval mode and rate 0 pass the input; in train mode each sample is
    zeroed or scaled by 1 / keep, as JAX's ``DropPath``, with the mask of
    ``drop_path`` on the same generator."""
    x = torch.rand(64, 3, 4, 4) + 0.5
    m = tswin.DropPath(0.25)
    assert m.eval()(x) is x
    assert tswin.DropPath(0.0).train()(x) is x
    y = m.train()(x, torch.Generator().manual_seed(14))
    assert torch.equal(y, tswin.drop_path(
        x, 0.25, torch.Generator().manual_seed(14), True))
    kept = y.flatten(1).any(dim=1)
    assert 0 < int(kept.sum()) < 64
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert not y[~kept].any()
    j = jswin.DropPath(0.25).apply({}, jnp.asarray(x.numpy()), train=True,
                                   rngs={"dropout": jax.random.PRNGKey(0)})
    j = np.asarray(j).reshape(64, -1)
    jk = j.any(axis=1)
    np.testing.assert_allclose(j[jk], x.numpy().reshape(64, -1)[jk] / 0.75,
                               rtol=1e-6)
    assert not j[~jk].any()


# ---------------------------------------------------------------------------
# the public names: what the port does not have, and why
# ---------------------------------------------------------------------------

# module of ``cvssl_tpu`` -> its public names the port's module of the same
# path lacks; None: the port has no such module. ROADMAP.md lists each with
# its reason and the port's counterpart, where there is one.
NOT_PORTED = {
    # the port's ``load_from``, as the reference loads Swin weights
    "models/swin_checkpoint.py": {"convert_swin_checkpoint",
                                  "convert_swinunet_full"},
    # ``nn.init.trunc_normal_``
    "models/swin_unet.py": {"trunc_normal_init"},
    # under MONAI's names: PatchMerging, SwinTransformerBlock,
    # WindowAttention
    "models/swin_unetr.py": {"PatchMerging3D", "SwinBlock3D",
                             "WindowAttention3D"},
    # a reference ``.pth`` is the port's own ``state_dict``
    "models/torch_convert.py": None,
    # the s2d path (ROADMAP Queue A item 3)
    "models/unet.py": {"ConvW", "S2DBatchNorm", "upsample2x_to_s2d"},
    # ``channel_dropout_3d``; the other two are the s2d path's
    "models/unet3d.py": {"channel_dropout", "channel_dropout_s2d",
                         "instance_norm_s2d"},
    # the Pallas kernels: ``ops/conv3x3_p8.py`` and ``ops/fused_ce_dice.py``
    "ops/pallas_conv.py": None,
    "ops/pallas_kernels.py": None,
    "ops/s2d.py": None,
    # the optimizer classes ``DiscriminatorAdam``, ``ReferenceSGD``,
    # ``TwoPhaseReferenceSGD``
    "ops/schedules.py": {"discriminator_adam", "reference_sgd",
                         "two_phase_reference_sgd"},
    # JAX sharding objects; ``shard_batch`` and ``replicate_state``
    "parallel/mesh.py": {"batch_sharding", "replicated"},
    # JAX's A/B flag for a fusion the port always makes
    "train/methods/uamt.py": {"FUSE_TEACHER_3D"},
    "utils/compile_cache.py": None,
    # XLA cost analysis; ``count_flops`` counts a real call
    "utils/mfu.py": {"compiled_flops", "program_flops"},
    "utils/trace_census.py": None,
}


def _public_names(path):
    import ast
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                             ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_public_names_are_ported_or_listed():
    """Every public top-level name of every ``cvssl_tpu`` module is in the
    port's module of the same path, but for ``NOT_PORTED``'s."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    missing = {}
    for path in sorted((root / "cvssl_tpu").rglob("*.py")):
        rel = path.relative_to(root / "cvssl_tpu").as_posix()
        port = root / "cvssl_tpu_torch" / rel
        if not port.exists():
            missing[rel] = None
            continue
        lacks = _public_names(path) - _public_names(port)
        if lacks:
            missing[rel] = lacks
    assert missing == NOT_PORTED
