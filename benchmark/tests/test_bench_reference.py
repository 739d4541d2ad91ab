"""The plain references against hand-made tiny cases, and against the
program's own steps at a small size on the CPU, where both compute in
float32 from the same draws."""
import math

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.reference import augment, layers, methods, unet2d, unet3d
from benchmark.reference import window


def test_ce_dice_by_hand():
    # two sites, two classes: logits (0, 0) and (ln 3, 0); labels 0 and 1
    logits = torch.tensor([[[0.0, math.log(3.0)], [0.0, 0.0]]])
    labels = torch.tensor([[0, 1]])
    ce, dice = methods.ce_dice(logits, labels, 2)
    # p = (0.5, 0.5) and (0.75, 0.25); CE = -(ln .5 + ln .25) / 2
    assert float(ce) == pytest.approx(-(math.log(0.5) + math.log(0.25)) / 2)
    s = 1e-5
    d0 = 1 - (2 * 0.5 + s) / (0.25 + 0.5625 + 1 + s)
    d1 = 1 - (2 * 0.25 + s) / (0.25 + 0.0625 + 1 + s)
    assert float(dice) == pytest.approx((d0 + d1) / 2)


def test_rot90_flip_matches_numpy():
    x = torch.arange(2 * 3 * 3).reshape(2, 3, 3)
    k, axis = torch.tensor([1, 3]), torch.tensor([0, 1])
    out = augment._rot90_flip(x, k, axis).numpy()
    for i in range(2):
        want = np.flip(np.rot90(x[i].numpy(), int(k[i])), int(axis[i]))
        assert np.array_equal(out[i], want)


def test_zero_angle_rotation_is_identity():
    x = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(2, 8, 8)
    aidx = torch.tensor([augment.MAX_ANGLE, augment.MAX_ANGLE])
    assert torch.equal(augment._rotate(x, aidx), x)


def test_rotation_keeps_values_and_fills_zero():
    x = torch.arange(1, 1 + 16 * 16, dtype=torch.float32).reshape(1, 16, 16)
    out = augment._rotate(x, torch.tensor([0]))      # -20 degrees
    kept = out[out != 0]
    assert set(kept.tolist()) <= set(x.flatten().tolist())
    assert len(set(kept.tolist())) == kept.numel()   # no site twice
    assert (out == 0).any()


def test_bits_dropout_keeps_the_mean():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = layers.bits_dropout(x, 0.3, g)
    t = round(0.3 * 256)
    kept = torch.unique(y)
    assert kept[0] == 0.0 and len(kept) == 2
    assert float(kept[1]) == pytest.approx(256 / (256 - t))
    assert float(y.mean()) == pytest.approx(1.0, abs=0.01)


def test_instance_norm():
    x = torch.randn(2, 3, 4, 5, 6) * 3 + 1
    y = layers.instance_norm(x)
    assert torch.allclose(y.mean((2, 3, 4)), torch.zeros(2, 3), atol=1e-5)
    assert torch.allclose(y.var((2, 3, 4), unbiased=False),
                          torch.ones(2, 3), atol=1e-3)
    assert torch.equal(layers.instance_norm(torch.ones(1, 2, 1, 1, 1)),
                       torch.zeros(1, 2, 1, 1, 1))


def test_fp8_rounding():
    x = torch.linspace(-3.0, 3.0, 101)
    q = layers._round(x, layers.E4M3)
    assert float((q - x).abs().max()) <= 3.0 / 448 * 16
    assert float(q.abs().max()) == pytest.approx(3.0)
    assert torch.equal(layers._round(x, layers.BF16),
                       x.bfloat16().float())


def test_window_corners():
    # 140 with patch 96 and stride 64: 0 and 44; 180: 0, 64 and 84
    assert window.corners_1d(140, 96, 64) == [0, 44]
    assert window.corners_1d(180, 96, 64) == [0, 64, 84]
    assert window.corners_1d(96, 96, 64) == [0]
    assert len(window.windows((140, 180, 180), (96, 96, 96), 64, 64)) == 18


def test_window_of_a_constant_net_is_its_softmax():
    """With every weight zero but the output bias, each window predicts the
    bias's softmax everywhere; the mean over windows is that softmax."""
    specs = unet3d.param_specs(1, 2)
    p = {n: torch.zeros(sh) for n, sh, _, _ in specs}
    p["final.bias"] = torch.tensor([0.0, 1.0])
    probs = window.probabilities(p, torch.rand(20, 18, 22), (16, 16, 16),
                                 2, 8, 8, 4)
    want = torch.softmax(torch.tensor([0.0, 1.0]), 0)
    assert probs.shape == (2, 20, 18, 22)
    assert torch.allclose(probs, want[:, None, None, None].expand_as(probs))


def test_param_counts():
    n2 = sum(math.prod(s) for _, s, _, _ in unet2d.param_specs(1, 4))
    n3 = sum(math.prod(s) for _, s, _, _ in unet3d.param_specs(1, 2))
    assert (n2, n3) == (1_813_764, 5_884_050)


def test_index_rows_two_streams():
    rows = data.index_rows(50, 10, 30, 6, 3, seed=2 ** 31 + 5)
    assert rows.shape == (50, 6)
    assert (rows[:, :3] < 10).all() and (rows[:, 3:] >= 10).all()
    assert (rows < 30).all()
    assert np.array_equal(rows, data.index_rows(50, 10, 30, 6, 3,
                                                seed=2 ** 31 + 5))


def test_blobs_are_bfloat16_values():
    g = torch.Generator().manual_seed(1)
    img, lab = data.blobs(3, (20, 24), 4, g, "cpu")
    assert torch.equal(img, img.bfloat16().float())
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
    assert set(torch.unique(lab).tolist()) <= {0, 1, 2, 3}


@pytest.mark.parametrize("model", ["unet", "unet_3D"])
def test_reference_steps_follow_the_program(model):
    """On the CPU, in float32, the program's steps and the reference's agree
    to float32 rounding: the same draws in the same order."""
    from cvssl_tpu_torch.data.device_store import (DeviceSliceStore,
                                                   DeviceVolumeStore)
    from cvssl_tpu_torch.train.config import TrainConfig
    from cvssl_tpu_torch.train.engine import Engine
    two = model == "unet"
    cfg = dict(model=model, method="mean_teacher" if two else "uamt",
               dim=2 if two else 3, in_channels=1,
               num_classes=4 if two else 2, batch_size=4, labeled_bs=2,
               patch_size=[32, 32] if two else [16, 16, 16], base_lr=0.01,
               max_iterations=30000, ema_decay=0.99, consistency=0.1,
               consistency_rampup=200.0, weight_decay=1e-4, uncertainty_T=8)
    g = torch.Generator().manual_seed(5)
    n = 10
    shape = (32, 32) if two else (20, 24, 22)
    imgs = torch.rand((n,) + shape, generator=g).bfloat16().float()
    labs = torch.randint(0, cfg["num_classes"], (n,) + shape,
                         generator=g).to(torch.uint8)
    samples = [{"image": imgs[i].numpy() if two else imgs[i],
                "label": labs[i].numpy() if two else labs[i]}
               for i in range(n)]
    store = (DeviceSliceStore if two else DeviceVolumeStore)(
        samples, tuple(cfg["patch_size"]), device="cpu")
    raw = {"images": imgs, "labels": labs.long(),
           "extents": torch.tensor([list(shape)] * n)}
    engine = Engine(TrainConfig(
        model=model, method=cfg["method"], dim=cfg["dim"],
        num_classes=cfg["num_classes"], batch_size=4, labeled_bs=2,
        patch_size=tuple(cfg["patch_size"]), dtype="float32"), device="cpu")
    engine.attach_store(store)
    seed = 2 ** 31 + 77
    state = engine.init_state(seed=seed)
    w, t = data.weights(methods.MODELS[model], cfg, seed, "cpu")
    from benchmark.generators.train_scan import load_weights
    load_weights(state.models["model"], w)
    load_weights(state.teachers["model"], t)
    state.step = 1000
    rows = torch.tensor([[0, 1, 4, 5], [2, 3, 6, 7], [1, 0, 8, 9]])
    losses = []
    for r in range(3):
        state, m = engine.train_steps_scan(state, rows[r:r + 1].tolist())
        losses.append(float(m["loss"]))
    ref = methods.train(cfg, w, t, raw, rows, seed, 1000)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    # 1e-4: the first 3D convolution's gradient cancels behind its
    # InstanceNorm, so float32 sums taken in another order move it by up
    # to ~3e-5 in three steps (2D: ~1e-8); a draw out of order moves
    # weights by ~1e-2
    for group, after in (("models", ref["student"]),
                         ("teachers", ref["teacher"])):
        for k, p in getattr(state, group)["model"].named_parameters():
            assert torch.allclose(p, after[k], atol=1e-4), (group, k)
