"""The PyTorch port's ops against the JAX package on the same numpy inputs:
losses, ramps, EMA, the poly-LR SGD and BitsDropout (CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvssl_tpu.ops import dropout as jdropout
from cvssl_tpu.ops import ema as jema
from cvssl_tpu.ops import losses as jlosses
from cvssl_tpu.ops import ramps as jramps
from cvssl_tpu.ops import schedules as jsched
from cvssl_tpu_torch.ops import dropout as tdropout
from cvssl_tpu_torch.ops import ema as tema
from cvssl_tpu_torch.ops import losses as tlosses
from cvssl_tpu_torch.ops import ramps as tramps
from cvssl_tpu_torch.ops import schedules as tsched

C = 4


def _logits_labels(seed, shape=(2, 12, 10)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape + (C,)).astype(np.float32)   # NHWC
    labels = rng.integers(0, C, shape).astype(np.int32)
    return logits, labels


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("name", ["cross_entropy", "dice_softmax",
                                  "dice_probs_weighted", "dice_ce_loss"])
def test_losses_match_jax(name):
    logits, labels = _logits_labels(0)
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    tl, ty = _nchw(logits), torch.from_numpy(labels)
    if name == "cross_entropy":
        want = jlosses.cross_entropy(jl, jy)
        got = tlosses.cross_entropy(tl, ty)
    elif name == "dice_softmax":
        want = jlosses.dice_loss(jl, jy, C, softmax=True)
        got = tlosses.dice_loss(tl, ty, C, softmax=True)
    elif name == "dice_probs_weighted":
        probs = jax.nn.softmax(jl, axis=-1)
        w = [0.5, 1.0, 2.0, 0.0]
        want = jlosses.dice_loss(probs, jy, C, weight=w)
        got = tlosses.dice_loss(torch.softmax(tl, 1), ty, C, weight=w)
    else:
        want = jlosses.dice_ce_loss(jl, jy, C)
        got = tlosses.dice_ce_loss(tl, ty, C)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_ce_dice_pair_and_softmax_mse_match_jax():
    logits, labels = _logits_labels(1)
    other, _ = _logits_labels(2)
    ce_j, dice_j = jlosses.ce_dice(jnp.asarray(logits), jnp.asarray(labels),
                                   C)
    ce_t, dice_t = tlosses.ce_dice(_nchw(logits), torch.from_numpy(labels), C)
    assert float(ce_t) == pytest.approx(float(ce_j), rel=1e-6)
    assert float(dice_t) == pytest.approx(float(dice_j), rel=1e-6)
    mse_j = jlosses.softmax_mse_loss(jnp.asarray(logits), jnp.asarray(other))
    mse_t = tlosses.softmax_mse_loss(_nchw(logits), _nchw(other))
    # element-wise: squares of differences of f32 softmaxes, whose last-bit
    # rounding differs between frameworks; atol sits at ~1e-7 of the
    # largest element
    np.testing.assert_allclose(mse_t.numpy(),
                               np.moveaxis(np.asarray(mse_j), -1, 1),
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("current", [0, 3, 57.5, 199, 200, 250])
def test_sigmoid_rampup_matches_jax(current):
    want = float(jramps.sigmoid_rampup(current, 200.0))
    assert tramps.sigmoid_rampup(current, 200.0) == pytest.approx(want,
                                                                  rel=1e-6)


@pytest.mark.parametrize("step", [0, 149, 150, 999, 1000, 4567, 30000])
def test_consistency_weight_staircase_matches_jax(step):
    want = float(jramps.consistency_weight(step, 0.1, 200.0))
    got = tramps.consistency_weight(step, 0.1, 200.0)
    assert got == pytest.approx(want, rel=1e-6)


def test_ema_schedule_and_update_match_jax():
    for step in (0, 1, 5, 98, 99, 100, 1000):
        want = float(jema.ema_decay_schedule(step, 0.99))
        assert tema.ema_decay_schedule(step, 0.99) == pytest.approx(
            want, rel=1e-6)
    rng = np.random.default_rng(3)
    ema = [rng.normal(size=(3, 4)).astype(np.float32),
           rng.normal(size=(5,)).astype(np.float32)]
    new = [rng.normal(size=(3, 4)).astype(np.float32),
           rng.normal(size=(5,)).astype(np.float32)]
    decay = tema.ema_decay_schedule(7, 0.99)
    want = jema.mean_teacher_update([jnp.asarray(e) for e in ema],
                                    [jnp.asarray(n) for n in new], 7, 0.99)
    got = [torch.from_numpy(e.copy()) for e in ema]
    tema.ema_update(got, [torch.from_numpy(n) for n in new], decay)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_poly_lr_matches_jax():
    want = jsched.poly_lr(0.01, 300, 0.9)
    got = tsched.poly_lr(0.01, 300, 0.9)
    for step in (0, 1, 17, 150, 299, 300, 400):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6,
                                          abs=1e-12)


def test_reference_sgd_three_steps_match_optax():
    """Poly LR from the update count, weight decay before momentum."""
    rng = np.random.default_rng(4)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]

    tx = jsched.reference_sgd(0.01, 10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = tsched.ReferenceSGD(tp.values(), 0.01, 10)

    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v)
                                        for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
    assert opt.count == 3


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.3, 0.5, 1.0])
def test_bits_dropout_matches_jax_on_injected_bytes(rate, monkeypatch):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)     # NHWC
    draw = rng.integers(0, 256, x.shape).astype(np.uint8)
    monkeypatch.setattr(jax.random, "bits",
                        lambda key, shape, dtype=None: jnp.asarray(draw))
    want = jdropout.BitsDropout(rate).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)})
    got = tdropout.bits_dropout(_nchw(x), rate, _nchw(draw))
    np.testing.assert_array_equal(got.numpy(),
                                  np.moveaxis(np.asarray(want), -1, 1))


def test_bits_dropout_module_draws_from_its_generator():
    x = torch.randn(2, 3, 8, 8)
    mod = tdropout.BitsDropout(0.3).train()
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    draw = torch.randint(0, 256, x.shape, dtype=torch.uint8, generator=g2)
    torch.testing.assert_close(mod(x, g1), tdropout.bits_dropout(x, 0.3, draw),
                               rtol=0, atol=0)
    assert torch.equal(mod.eval()(x, g1), x)
