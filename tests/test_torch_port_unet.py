"""The port's UNet against the Flax UNet with the same weights (CPU,
float32): weight conversion round trip, train- and eval-mode forwards, and
BatchNorm running statistics after one train forward."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cvssl_tpu.models.torch_convert import convert_unet_checkpoint
from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.models.unet import UNet as TUNet

FEATURES = (4, 8, 16, 32, 64)
B, HW, C = 2, 32, 4
# Tolerances: same math, different float32 accumulation orders through 19
# convolutions (XLA:CPU vs oneDNN) and two BatchNorm variance formulas
# (flax's E[x^2] - E[x]^2 vs torch's two-pass). Measured: logits within
# 4e-6 of their largest magnitude, running statistics within 6e-6
# relative. Bounds: rtol 1e-4 with an absolute floor of 1e-5 of the
# largest magnitude (for elements that cancel to near zero).
RTOL, ATOL_OF_MAX = 1e-4, 1e-5


def _assert_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(want).max()))


def _flax_unet(seed=0):
    m = JUNet(in_chns=1, num_classes=C, features=FEATURES, dropout=(0.0,) * 5)
    v = jax.jit(lambda k, x: m.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 1)))
    # non-trivial BatchNorm state, so eval mode reads real statistics
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
            np.float32), v["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    return m, params, stats


def _port(params, stats):
    t = TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5)
    t.load_state_dict(state_dict_from_flax("unet", params, stats), strict=True)
    return t


def _image(seed=1):
    return np.random.default_rng(seed).normal(
        0.5, 0.25, (B, HW, HW, 1)).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def test_conversion_round_trips_exactly():
    _, params, stats = _flax_unet()
    sd = {k: v.numpy() for k, v in state_dict_from_flax("unet",
        params, stats).items()}
    p2, s2 = convert_unet_checkpoint(sd)
    for want, got in ((params, p2), (stats, s2)):
        assert (jax.tree_util.tree_structure(want)
                == jax.tree_util.tree_structure(got))
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_train_forward_and_running_stats_match_flax():
    m, params, stats = _flax_unet()
    x = _image()
    want, mutated = jax.jit(lambda v, x: m.apply(
        v, x, train=True, mutable=["batch_stats"]))(
            {"params": params, "batch_stats": stats}, jnp.asarray(x))
    t = _port(params, stats).train()
    got = t(_to_nchw(x))
    _assert_close(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1))
    _, new_stats = convert_unet_checkpoint(
        {k: v.numpy() for k, v in t.state_dict().items()})
    for a, b in zip(jax.tree_util.tree_leaves(mutated["batch_stats"]),
                    jax.tree_util.tree_leaves(new_stats)):
        _assert_close(b, a)


def test_eval_forward_matches_flax():
    m, params, stats = _flax_unet(seed=2)
    x = _image(seed=3)
    want = jax.jit(lambda v, x: m.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    t = _port(params, stats).eval()
    with torch.no_grad():
        got = t(_to_nchw(x))
    _assert_close(got.numpy(), np.moveaxis(np.asarray(want), -1, 1))


def test_biased_running_variance_like_flax():
    """One train forward of a (2, 1, 3, 3) input: the running variance is
    0.9 + 0.1 * var_biased, not torch's unbiased update."""
    from cvssl_tpu_torch.models.unet import BatchNorm2d
    bn = BatchNorm2d(1).train()
    x = torch.arange(18, dtype=torch.float32).reshape(2, 1, 3, 3)
    bn(x)
    var_b = x.var(unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var_b[None],
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean()[None],
                               rtol=1e-6, atol=0)


def test_full_width_parameter_count():
    model = net_factory("unet", in_chns=1, class_num=4)
    assert sum(p.numel() for p in model.parameters()) == 1_813_764
