"""The port's SwinUnet against the Flax SwinUnet with the same weights (CPU,
float32): the window helpers, eval- and train-mode forwards (stochastic
depth off, and on with injected masks) with every parameter's gradient, the
converter both ways and against JAX's ``convert_swinunet_full``, the
``load_from`` remap against JAX's ``convert_swin_checkpoint``, the
full-width parameter count, the bf16 precision policy, and the config
plumbing (``model_kwargs``, ``model_dtype``, the factory)."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu.models.swin_checkpoint import (convert_swin_checkpoint,
                                              convert_swinunet_full)
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models import swin_checkpoint as tckpt
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models.convert import (flax_from_state_dict, leaves,
                                            state_dict_from_flax)
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.methods.base import get_method

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_methods import _Draws, _patch_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = 4
# (image side, SwinUnet arguments): window 4 at 64^2 (token maps 16, 8, 4,
# 2: the last two stages collapse the window), and window 7 at 56^2 (maps
# 14 and 7, the second collapsing), as tests/test_swin_unet.py
CONFIGS = {
    "w4_64": (64, dict(embed_dim=24, depths=(2, 2, 2, 2),
                       num_heads=(1, 2, 4, 8), window_size=4)),
    "w7_56": (56, dict(embed_dim=24, depths=(2, 2), num_heads=(3, 6),
                       window_size=7)),
}
B = 2
FULL_WIDTH_PARAMS = 27_168_420
FLAX_LEAVES = 218          # at depths (2, 2, 2, 2)
# Tolerances. Same math in another float32 order, and two LayerNorm
# variance formulas (flax's E[x^2] - E[x]^2, torch's two passes), through
# 14 blocks and 30 LayerNorms. Measured: logits within 9e-7 of the largest
# logit, gradients within 1.7e-6 of the largest gradient element. Bounds:
# logits rtol 1e-4 with an absolute floor of 1e-5 of the largest logit;
# each gradient element within 2e-5 of the model's largest (a leaf whose
# gradient is small carries the others' rounding).
RTOL, ATOL_OF_MAX, GRAD_OF_MAX = 1e-4, 1e-5, 2e-5


@functools.lru_cache(maxsize=None)
def _flax(config, drop_path_rate=0.0, seed=0):
    """Flax model and numpy params from its own init, with the LayerNorm
    scales and every bias moved off 1 and 0, so a leaf that landed in the
    wrong place or the wrong layout would show (cached: callers do not
    change them)."""
    side, kw = CONFIGS[config]
    m = jswin.SwinUnet(num_classes=C, drop_path_rate=drop_path_rate, **kw)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, side, side, 1)))
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "scale":
            return a + rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "bias":
            return a + rng.normal(0.0, 0.02, a.shape).astype(np.float32)
        return a
    return m, jax.tree_util.tree_map_with_path(move, v["params"])


def _port(config, params, drop_path_rate=0.0):
    side, kw = CONFIGS[config]
    t = tswin.SwinUnet(num_classes=C, img_size=side,
                       drop_path_rate=drop_path_rate, **kw)
    t.load_state_dict(state_dict_from_flax("swin_unet", params, {}),
                      strict=True)
    return t


def _image(side, seed=1):
    return np.random.default_rng(seed).normal(
        0.5, 0.25, (B, side, side, 1)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


def _assert_grads_close(got_tree, want_tree):
    got = jax.tree_util.tree_leaves(got_tree)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want_tree)]
    assert len(got) == len(want)
    scale = max(float(np.abs(w).max()) for w in want)
    assert scale > 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_OF_MAX * scale)


# ---------------------------------------------------------------------------
# the window helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [1, 2, 4, 7])
def test_relative_position_index_equals_jax(ws):
    got = tswin.relative_position_index(ws)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  jswin.relative_position_index(ws))


@pytest.mark.parametrize("h,w,ws,shift", [(8, 8, 4, 2), (16, 16, 4, 2),
                                          (14, 14, 7, 3), (56, 56, 7, 3),
                                          (16, 8, 4, 2)])
def test_shifted_window_mask_equals_jax(h, w, ws, shift):
    got = tswin.shifted_window_mask(h, w, ws, shift)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  jswin.shifted_window_mask(h, w, ws, shift))


def test_window_partition_and_reverse_equal_jax():
    x = np.random.default_rng(0).normal(size=(2, 16, 8, 5)).astype(
        np.float32)
    got = tswin.window_partition(torch.from_numpy(x), 4)
    want = np.asarray(jswin.window_partition(jnp.asarray(x), 4))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tswin.window_reverse(got, 4, 16, 8)
    np.testing.assert_array_equal(back.numpy(), x)


def test_window_constants_are_cached_outside_the_state_dict():
    cpu = torch.device("cpu")
    first = tswin.window_constants(8, 8, 4, 2, cpu)
    again = tswin.window_constants(8, 8, 4, 2, cpu)
    assert first[0] is again[0] and first[1] is again[1]
    assert tswin.window_constants(8, 8, 4, 0, cpu)[1] is None
    t = tswin.SwinUnet(num_classes=C, img_size=64, **CONFIGS["w4_64"][1])
    names = set(t.state_dict())
    assert not any("attn_mask" in k or "relative_position_index" in k
                   for k in names)
    assert len(names) == FLAX_LEAVES


# ---------------------------------------------------------------------------
# forwards and gradients against Flax
# ---------------------------------------------------------------------------

def _grads_jax(m, params, x, weights, train, rngs=None):
    def loss(p):
        out = m.apply({"params": p}, x, train=train, rngs=rngs)
        return jnp.sum(out * weights), out
    (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return np.asarray(out), g


def _grads_port(t, x, weights, generator=None):
    out = t(_nchw(x), generator)
    (out * _nchw(weights)).sum().backward()
    grads = {k: p.grad for k, p in t.named_parameters()}
    return (np.moveaxis(out.detach().numpy(), 1, -1),
            flax_from_state_dict("swin_unet", grads)[0])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_eval_forward_matches_flax(config):
    """Eval mode at the default ``drop_path_rate`` 0.1, which draws
    nothing there."""
    side = CONFIGS[config][0]
    m, params = _flax(config, 0.1)
    t = _port(config, params, 0.1).eval()
    x = _image(side)
    want = jax.jit(lambda p, x: m.apply({"params": p}, x, train=False))(
        params, x)
    with torch.no_grad():
        got = t(_nchw(x))
    assert got.shape == (B, C, side, side) and got.is_contiguous()
    _assert_close(np.moveaxis(got.numpy(), 1, -1), want)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_train_forward_and_gradients_match_flax(config):
    """Train mode with stochastic depth off (``drop_path_rate`` 0): logits
    and the gradient of a fixed random weighting of them, for every
    parameter."""
    side = CONFIGS[config][0]
    m, params = _flax(config)
    t = _port(config, params).train()
    x = _image(side)
    weights = np.random.default_rng(2).normal(
        size=(B, side, side, C)).astype(np.float32)
    want, want_g = _grads_jax(m, params, x, weights, True)
    got, got_g = _grads_port(t, x, weights)
    _assert_close(got, want)
    _assert_grads_close(got_g, want_g)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_stochastic_depth_matches_flax_on_injected_masks(config,
                                                         monkeypatch):
    """``drop_path_rate`` 0.5 in train mode: the port's keep masks, drawn
    through ``unet._keep`` and recorded, are replayed into Flax's
    ``DropPath`` through a patched ``jax.random.bernoulli``; two masks a
    block (attention and MLP branch), none where the rate is 0 (the first
    block of stage 0 in the encoder and in the decoder), some samples
    dropped."""
    side, kw = CONFIGS[config]
    m, params = _flax(config, 0.5)
    t = _port(config, params, 0.5).train()
    x = _image(side, seed=3)
    weights = np.random.default_rng(4).normal(
        size=(B, side, side, C)).astype(np.float32)
    draws = _Draws(7)
    with monkeypatch.context() as mp:
        mp.setattr(tswin.unet, "_keep", lambda shape, p, g, d: draws.take(
            "keep", draws.rng.random(tuple(shape)) < p))
        got, got_g = _grads_port(t, x, weights)
    masks = draws.of("keep")
    blocks = sum(kw["depths"]) + sum(kw["depths"][1:])
    assert len(masks) == 2 * (blocks - 2)
    assert all(k.shape == (B, 1, 1, 1) for k in masks)
    assert not all(k.all() for k in masks)
    draws.cursor = 0
    with monkeypatch.context() as mp:
        _patch_jax(mp, draws)
        want, want_g = _grads_jax(m, params, x, weights, True,
                                  {"dropout": jax.random.PRNGKey(0)})
    assert draws.cursor == len(masks)
    _assert_close(got, want)
    _assert_grads_close(got_g, want_g)


def test_a_map_of_another_window_raises():
    t = tswin.SwinUnet(num_classes=C, img_size=64, **CONFIGS["w4_64"][1])
    with pytest.raises(ValueError, match="img_size"):
        t(torch.zeros(1, 1, 32, 32))


# ---------------------------------------------------------------------------
# the converter and the checkpoint remap
# ---------------------------------------------------------------------------

def test_converter_round_trip_and_jax_full_converter():
    """Flax -> port -> Flax is exact; the port's ``state_dict`` through
    JAX's ``convert_swinunet_full`` (the reference checkpoint's names)
    gives the same tree, 218 leaves loaded and none skipped, with and
    without the ``ViT_seg`` wrapper's ``swin_unet.`` prefix."""
    _, params = _flax("w4_64")
    assert len(leaves("swin_unet")) == FLAX_LEAVES
    assert len(jax.tree_util.tree_leaves(params)) == FLAX_LEAVES
    sd = state_dict_from_flax("swin_unet", params, {})
    back = flax_from_state_dict("swin_unet", sd)[0]
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    for prefix in ("", "swin_unet."):
        got, report = convert_swinunet_full(
            {prefix + k: v for k, v in np_sd.items()}, zeros)
        assert report == {"loaded": FLAX_LEAVES, "skipped": 0}
        jax.tree_util.tree_map(np.testing.assert_array_equal, got, params)


def _synthetic_encoder_sd(embed=24, depths=(2, 2, 2, 2), heads=(1, 2, 4, 8),
                          window=4, seed=0):
    """An ImageNet-Swin-shaped encoder ``state_dict`` (numpy): stem,
    blocks with window-``window`` bias tables, downsamples, final norm, a
    classification head and the constant buffers the model drops."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32)
    sd = {"patch_embed.proj.weight": r(embed, 3, 4, 4),
          "patch_embed.proj.bias": r(embed),
          "patch_embed.norm.weight": r(embed),
          "patch_embed.norm.bias": r(embed)}
    for i, depth in enumerate(depths):
        dim = embed * 2 ** i
        for d in range(depth):
            p = f"layers.{i}.blocks.{d}"
            sd.update({
                f"{p}.norm1.weight": r(dim), f"{p}.norm1.bias": r(dim),
                f"{p}.attn.relative_position_bias_table":
                    r((2 * window - 1) ** 2, heads[i]),
                f"{p}.attn.relative_position_index":
                    np.zeros((window ** 2, window ** 2), np.int64),
                f"{p}.attn.qkv.weight": r(3 * dim, dim),
                f"{p}.attn.qkv.bias": r(3 * dim),
                f"{p}.attn.proj.weight": r(dim, dim),
                f"{p}.attn.proj.bias": r(dim),
                f"{p}.norm2.weight": r(dim), f"{p}.norm2.bias": r(dim),
                f"{p}.mlp.fc1.weight": r(4 * dim, dim),
                f"{p}.mlp.fc1.bias": r(4 * dim),
                f"{p}.mlp.fc2.weight": r(dim, 4 * dim),
                f"{p}.mlp.fc2.bias": r(dim)})
            if d % 2:
                sd[f"{p}.attn_mask"] = np.zeros((4, window ** 2,
                                                 window ** 2), np.float32)
        if i < len(depths) - 1:
            sd[f"layers.{i}.downsample.reduction.weight"] = r(2 * dim,
                                                              4 * dim)
            sd[f"layers.{i}.downsample.norm.weight"] = r(4 * dim)
            sd[f"layers.{i}.downsample.norm.bias"] = r(4 * dim)
    last = embed * 2 ** (len(depths) - 1)
    sd.update({"norm.weight": r(last), "norm.bias": r(last),
               "head.weight": r(1000, last), "head.bias": r(1000)})
    return sd


def test_load_from_matches_jax_convert_swin_checkpoint():
    """The reference's ``load_from`` in the port against JAX's
    ``convert_swin_checkpoint``: the same tensors land in the same places
    (the encoder, and encoder stage i's blocks in decoder stage 3 - i),
    with the same counts. At 64^2 with window 4 the last stage's window
    collapses to 2, so its two bias tables (window 4 in the file) are
    skipped by both; the head and the constant buffers are ignored."""
    _, params = _flax("w4_64")
    sd = _synthetic_encoder_sd()
    want, report = convert_swin_checkpoint(sd, params)
    t = _port("w4_64", params)
    got_report = tckpt.load_from(t, {k: torch.from_numpy(v)
                                     for k, v in sd.items()})
    assert got_report == report
    assert report["skipped"] == 2 and report["loaded"] > 100
    got = flax_from_state_dict("swin_unet", t.state_dict())[0]
    jax.tree_util.tree_map(np.testing.assert_array_equal, got, want)
    # the remap took: decoder stage 1 holds encoder stage 2's blocks
    np.testing.assert_array_equal(
        t.layers_up[1].blocks[0].attn.qkv.weight.detach().numpy(),
        sd["layers.2.blocks.0.attn.qkv.weight"])


def test_load_torch_state_dict_unwraps_and_drops_buffers(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in _synthetic_encoder_sd().items()}
    path = str(tmp_path / "swin_tiny.pth")
    torch.save({"model": sd}, path)
    got = tckpt.load_torch_state_dict(path)
    kept = {k for k in sd if "attn_mask" not in k
            and "relative_position_index" not in k}
    assert set(got) == kept
    for k in kept:
        assert torch.equal(got[k], sd[k])


def test_full_width_parameter_count_matches_jax():
    t = net_factory("swin_unet", 1, C)
    n = sum(p.numel() for p in t.parameters())
    assert n == FULL_WIDTH_PARAMS
    m = jswin.SwinUnet(num_classes=C)
    shapes = jax.eval_shape(lambda k: m.init(k, jnp.zeros((1, 224, 224, 1)),
                                             train=False),
                            jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(a.shape)) for a in
                    jax.tree_util.tree_leaves(shapes["params"]))
    assert len(t.state_dict()) == FLAX_LEAVES


# ---------------------------------------------------------------------------
# precision policy and configuration
# ---------------------------------------------------------------------------

def test_bf16_autocast_runs_the_dtype_less_modules_in_float32():
    """Under bfloat16 autocast (here on the CPU) ``concat_back_dim.*`` and
    ``layers_up.0`` compute in float32, as Flax does for the modules JAX
    builds without a dtype; every other Linear computes in bfloat16. The
    logits are bfloat16 and NCHW-contiguous."""
    t = tswin.SwinUnet(num_classes=C, img_size=64, **CONFIGS["w4_64"][1])
    seen = {}

    def hook(name):
        def fn(module, args, out):
            seen[name] = (args[0].dtype, out.dtype)
        return fn
    for name, mod in t.named_modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.LayerNorm)):
            mod.register_forward_hook(hook(name))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = t(torch.zeros(B, 1, 64, 64))
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    f32 = {n for n in seen if n.startswith("concat_back_dim.")
           or n.startswith("layers_up.0.")}
    assert f32 == {"concat_back_dim.1", "concat_back_dim.2",
                   "concat_back_dim.3", "layers_up.0.expand",
                   "layers_up.0.norm"}
    for name, (inp, res) in seen.items():
        linear = isinstance(t.get_submodule(name), torch.nn.Linear)
        if name in f32:
            assert (inp, res) == (torch.float32, torch.float32), name
        elif linear:
            assert res == torch.bfloat16, name
    assert sum(isinstance(t.get_submodule(n), torch.nn.Linear)
               for n in seen) == 4 * 14 + 3 + 3 + 3 + 1


@pytest.mark.parametrize("net", ["swin_unet", "ViT_Seg"])
def test_model_dtype_and_kwargs_follow_jax(net):
    """``dtype="auto"``: bfloat16 on the card, float32 on the CPU, as
    JAX's ``model_kwargs`` gives the ViT slot off and on the CPU;
    ``vit_kwargs`` reach the constructor after the patch's ``img_size``."""
    cfg = TConfig(patch_size=(64, 64), vit_kwargs={"embed_dim": 24})
    assert cfg.model_dtype(net, "cuda") == torch.bfloat16
    assert cfg.model_dtype(net, "cpu") == torch.float32
    assert TConfig(dtype="float32").model_dtype(net, "cuda") == \
        torch.float32
    assert TConfig(dtype="bfloat16").model_dtype(net, "cpu") == \
        torch.bfloat16
    assert cfg.model_kwargs(net) == {"img_size": (64, 64), "embed_dim": 24}
    jkw = JConfig(vit_kwargs={"embed_dim": 24},
                  dtype="bfloat16").model_kwargs(net)
    assert jkw == {"dtype": jnp.bfloat16, "embed_dim": 24}
    assert cfg.model_kwargs("unet") == {}


def test_vit_kwargs_reach_the_model():
    vit = dict(embed_dim=24, num_heads=(1, 2, 4, 8), window_size=4,
               drop_path_rate=0.2)
    cfg = TConfig(method="cross_teaching", patch_size=(64, 64),
                  vit_kwargs=vit)
    models = get_method("cross_teaching", cfg).build_models()
    vit_model = models["model2"]
    assert isinstance(vit_model, tswin.SwinUnet)
    assert vit_model.patch_embed.proj.out_channels == 24
    blocks = [b for layer in vit_model.layers for b in layer.blocks]
    assert [b.attn.num_heads for b in blocks] == [1, 1, 2, 2, 4, 4, 8, 8]
    assert [b.attn.window_size for b in blocks] == [4] * 6 + [2, 2]
    assert blocks[-1].drop_path == pytest.approx(0.2)
    assert type(models["model1"]).__name__ == "UNet"


@pytest.mark.parametrize("option", [{"attn_layout": "grid"},
                                    {"attn_layout": "fused"},
                                    {"s2d_logits": True},
                                    {"use_checkpoint": True},
                                    {"ape": True}])
def test_unported_options_raise(option):
    with pytest.raises(NotImplementedError, match=next(iter(option))):
        net_factory("ViT_Seg", 1, C, **option)
