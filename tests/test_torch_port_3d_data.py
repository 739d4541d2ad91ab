"""The port's 3D data and evaluation path against the JAX package on the
CPU: the synthetic BraTS tree and ``VolumeDataset``, the 3D host transforms
(the same draws from the same generator), ``DeviceVolumeStore`` and
``gather_crop_rotflip`` (the draws replayed into JAX's per-sample crop),
and ``eval/val3d.py``: the corner grid, the sliding window's label maps
(a net that thresholds each voxel, stride above the patch, volumes under
the patch, 3 classes, Gaussian weights, mirroring, and a conv net), the 2D
tiling and ``test_all_case``."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data import datasets as jdata
from cvssl_tpu.data import device_store as jstore
from cvssl_tpu.data import synthetic as jsyn
from cvssl_tpu.data import transforms as jT
from cvssl_tpu.eval import val3d as jval3d
from cvssl_tpu_torch.data import datasets as tdata
from cvssl_tpu_torch.data import device_store as tstore
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.data import transforms as tT
from cvssl_tpu_torch.eval import val3d as tval3d


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the synthetic tree, the dataset and the host transforms
# ---------------------------------------------------------------------------

def test_synthetic_brats_tree_and_dataset_equal_jax(tmp_path):
    """The same seed gives the same lists and volumes; ``VolumeDataset``
    reads them as JAX's does (the test split, ``num``), and
    ``blob_volumes`` draws the tree's volumes in its order."""
    kw = dict(num_train=3, num_val=2, size=12, seed=4, num_test=1)
    jroot = jsyn.make_synthetic_brats(str(tmp_path / "jax"), **kw)
    troot = tsyn.make_synthetic_brats(str(tmp_path / "torch"), **kw)
    for name in ("train.txt", "val.txt", "test.txt"):
        with open(os.path.join(jroot, name)) as a, \
                open(os.path.join(troot, name)) as b:
            assert a.read() == b.read()
    drawn = tsyn.blob_volumes([(12, 12, 12)] * 6, seed=4)
    for split, num, first in (("train", 2, 0), ("val", None, 3),
                              ("test", None, 5)):
        jd = jdata.VolumeDataset(jroot, split, num=num)
        td = tdata.VolumeDataset(troot, split, num=num)
        assert len(jd) == len(td) == (num or len(jd))
        for i in range(len(td)):
            a, b = jd[i], td[i]
            assert a["case"] == b["case"] and b["idx"] == i
            assert b["image"].dtype == np.float32
            assert b["label"].dtype == np.uint8
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
            np.testing.assert_array_equal(b["image"],
                                          drawn[first + i]["image"])


SHAPES = [(20, 22, 18), (7, 12, 9), (12, 12, 12)]   # above, under, equal
PATCH = (10, 10, 8)


def _volume(shape, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=shape).astype(np.float32),
            "label": rng.integers(0, 3, shape).astype(np.uint8)}


@pytest.mark.parametrize("shape", SHAPES)
def test_3d_host_transforms_match_jax(shape):
    """The reference pad rule, CenterCrop, RandomCrop, RandomRotFlip3D,
    RandomNoise3D, CreateOnehotLabel (class axis first here, last in JAX)
    and Compose: the same arrays from generators of the same seed."""
    s = _volume(shape, 1)
    np.testing.assert_array_equal(tT.pad_to_size(s["image"], PATCH),
                                  jT._pad_to_size(s["image"], PATCH))
    pairs = [
        (tT.CenterCrop(PATCH), jT.CenterCrop(PATCH), None),
        (tT.RandomCrop(PATCH, rng=np.random.default_rng(3)),
         jT.RandomCrop(PATCH, rng=np.random.default_rng(3)), None),
        (tT.RandomRotFlip3D(np.random.default_rng(5)),
         jT.RandomRotFlip3D(np.random.default_rng(5)), None),
        (tT.RandomNoise3D(rng=np.random.default_rng(6)),
         jT.RandomNoise3D(rng=np.random.default_rng(6)), None),
        (tT.CreateOnehotLabel(3), jT.CreateOnehotLabel(3), "onehot"),
    ]
    rt, rj = np.random.default_rng(8), np.random.default_rng(8)
    pairs.append((tT.Compose([tT.RandomRotFlip3D(rt),
                              tT.RandomCrop(PATCH, rng=rt)]),
                  jT.Compose([jT.RandomRotFlip3D(rj),
                              jT.RandomCrop(PATCH, rng=rj)]), None))
    for t, j, kind in pairs:
        for _ in range(3):      # the generators move alike
            a, b = t(dict(s)), j(dict(s))
            for key in b:
                want = b[key]
                if key == "onehot_label":
                    want = np.moveaxis(want, -1, 0)
                np.testing.assert_array_equal(a[key], want, err_msg=key)
            if kind is None:
                assert set(a) == set(b)


# ---------------------------------------------------------------------------
# the device store
# ---------------------------------------------------------------------------

STORE_SHAPES = [(20, 22, 18), (7, 12, 9), (14, 9, 30)]


@pytest.fixture(scope="module")
def stores():
    vols = [_volume(s, 10 + i) for i, s in enumerate(STORE_SHAPES)]
    t = tstore.DeviceVolumeStore(vols, PATCH, device="cpu")
    j = jstore.DeviceVolumeStore(vols, PATCH)
    return vols, t, j


def test_volume_store_matches_jax(stores):
    """Padded by the reference rule and placed at the origin of a common
    shape: images in bfloat16, labels uint8, each volume's extent; the
    estimate of JAX's 8 GiB rule."""
    vols, t, j = stores
    assert t.images.dtype == torch.bfloat16 and t.labels.dtype == torch.uint8
    np.testing.assert_array_equal(
        t.images.float().numpy(), np.asarray(j.images.astype(jnp.float32)))
    np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
    np.testing.assert_array_equal(t.shapes.numpy(), np.asarray(j.shapes))
    assert (tstore.DeviceVolumeStore.estimated_bytes(vols, PATCH)
            == jstore.DeviceVolumeStore.estimated_bytes(vols, PATCH))
    # tensors on any device go in alike
    t2 = tstore.DeviceVolumeStore(
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in vols],
        PATCH, device="cpu")
    assert torch.equal(t2.images, t.images) and torch.equal(t2.labels,
                                                            t.labels)


def test_gather_crop_rotflip_matches_jax_on_replayed_draws(stores,
                                                           monkeypatch):
    """Each sample's corner, k and axis replayed into JAX's per-sample
    ``_crop_rotflip_one`` (whose batched form maps it over the samples):
    every k and both axes, volumes above and under the patch, the corner
    at both ends of its range. Exact."""
    _, t, j = stores
    patch = (10, 10, 8)
    idx = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    ext = t.shapes[idx]
    room = ext - torch.tensor(patch)
    zero = torch.zeros(3, dtype=torch.int64)
    corner = torch.stack([zero, room[1], room[2] // 2, room[3], zero,
                          room[5] // 3, room[6], room[7] // 2])
    draws = {"corner": corner, "k": torch.tensor([0, 1, 2, 3, 0, 1, 2, 3]),
             "axis": torch.tensor([0, 0, 0, 0, 1, 1, 1, 1])}
    got = tstore.gather_crop_rotflip(t.images, t.labels, idx, draws, patch)
    assert got["image"].shape == (8, 1) + patch
    assert got["image"].dtype == torch.float32
    assert got["label"].dtype == torch.int32
    for i in range(8):
        vals = list(corner[i].tolist()) + [int(draws["k"][i]),
                                           int(draws["axis"][i])]
        monkeypatch.setattr(jax.random, "randint",
                            lambda key, shape, lo, hi, dtype=None:
                            jnp.asarray(vals.pop(0), jnp.int32))
        img, lab = jstore._crop_rotflip_one(
            j.images[int(idx[i])].astype(jnp.float32),
            j.labels[int(idx[i])].astype(jnp.int32), j.shapes[int(idx[i])],
            jax.random.PRNGKey(0), patch)
        assert not vals
        np.testing.assert_array_equal(got["image"][i, 0].numpy(),
                                      np.asarray(img))
        np.testing.assert_array_equal(got["label"][i].numpy(),
                                      np.asarray(lab))
    monkeypatch.undo()
    # the store's own draws: corners inside [0, extent - patch], from the
    # step's generator only
    drawn = [tstore.draw_crop_rotflip(t.shapes[idx], patch,
                                      torch.Generator().manual_seed(3))
             for _ in range(2)]
    for key in drawn[0]:
        assert torch.equal(drawn[0][key], drawn[1][key])
    c = drawn[0]["corner"]
    assert bool((c >= 0).all()) and bool((c <= room).all())
    many = tstore.draw_crop_rotflip(t.shapes[torch.zeros(4000,
                                                         dtype=torch.long)],
                                    patch, torch.Generator().manual_seed(4))
    assert set(many["corner"][:, 0].tolist()) == set(range(int(room[0, 0])
                                                           + 1))
    assert set(many["k"].tolist()) == {0, 1, 2, 3}
    batch = t.batch_fn(t.arrays(), idx, torch.Generator().manual_seed(5))
    assert batch["image"].shape == (8, 1) + patch
    with pytest.raises(ValueError, match="equal"):
        tstore.gather_crop_rotflip(t.images, t.labels, idx, draws,
                                   (10, 9, 8))


# ---------------------------------------------------------------------------
# the sliding window
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,patch,sxy,sz", [
    ((144, 144, 96), (96, 96, 96), 64, 64), ((140, 180, 180), (96,) * 3,
                                             64, 64),
    ((40, 33, 64), (32, 32, 32), 64, 64), ((9, 30, 17), (8, 8, 8), 3, 5),
    ((8, 8, 8), (8, 8, 8), 4, 4)])
def test_compute_corners_matches_jax(shape, patch, sxy, sz):
    got = tval3d.compute_corners(shape, patch, sxy, sz)
    np.testing.assert_array_equal(got, jval3d.compute_corners(shape, patch,
                                                              sxy, sz))
    if shape == (140, 180, 180):
        assert len(got) == 18


def _threshold_jax(classes):
    def predict(p):
        v = p[..., 0]
        if classes == 2:
            fg = (v > 0.5).astype(jnp.float32)
            return jnp.stack([1 - fg, fg], -1)
        a = (v > 0.66).astype(jnp.float32)
        b = ((v > 0.33) & (v <= 0.66)).astype(jnp.float32)
        return jnp.stack([1 - a - b, b, a], -1)
    return predict


def _threshold_torch(classes):
    def predict(x):
        v = x[:, 0]
        if classes == 2:
            fg = (v > 0.5).float()
            return torch.stack([1 - fg, fg], 1)
        a = (v > 0.66).float()
        b = ((v > 0.33) & (v <= 0.66)).float()
        return torch.stack([1 - a - b, b, a], 1)
    return predict


@pytest.mark.parametrize("classes,patch,stride,shapes,extra", [
    (2, (16, 16, 16), 8, [(24, 20, 16), (8, 8, 8), (13, 9, 21)], {}),
    (2, (32, 32, 32), 64, [(40, 40, 40), (40, 33, 64), (20, 40, 60)], {}),
    (3, (16, 16, 16), 8, [(21, 26, 17)], {}),
    (2, (16, 16, 16), 8, [(24, 20, 18)], {"gaussian": True}),
    (3, (16, 16, 16), 8, [(20, 17, 16)], {"mirror_axes": (0, 1, 2)}),
])
def test_sliding_window_label_maps_equal_jax(classes, patch, stride,
                                             shapes, extra):
    """A net that thresholds each voxel: the port's label maps equal
    JAX's (and the thresholded volume) for volumes above and under the
    patch, a stride above the patch, 3 classes, Gaussian weights and
    mirroring."""
    rng = np.random.default_rng(classes + stride)
    tev = tval3d.SlidingWindowEvaluator(_threshold_torch(classes), patch,
                                        classes, stride, stride,
                                        device="cpu", **extra)
    jev = jval3d.SlidingWindowEvaluator(_threshold_jax(classes), patch,
                                        classes, stride, stride, **extra)
    for shape in shapes:
        vol = rng.uniform(0, 1, shape).astype(np.float32)
        got = tev.predict_volume(vol)
        assert got.shape == shape and got.dtype == np.int32
        np.testing.assert_array_equal(got, jev.predict_volume(vol))
        want = (vol > 0.5).astype(np.int32) if classes == 2 else np.where(
            vol > 0.66, 2, np.where(vol > 0.33, 1, 0))
        np.testing.assert_array_equal(got, want)
    assert len(tev._cnt_cache) == len(shapes)


def test_sliding_window_conv_net_matches_jax():
    """A random 3^3 conv net (its zero padding makes each window's
    prediction depend on where the window lies): the same label maps as
    JAX's at a window count that fills its last batch (JAX fills a short
    last batch with copies of the last window, which then counts more than
    once), score margins held above 1e-4 so that float32 noise cannot flip
    a voxel."""
    k = np.random.default_rng(7).normal(size=(3, 3, 3, 1, 2)).astype(
        np.float32)
    kt = torch.from_numpy(np.ascontiguousarray(np.transpose(k,
                                                            (4, 3, 0, 1, 2))))

    def jnet(p):
        y = jax.lax.conv_general_dilated(
            p, jnp.asarray(k), (1, 1, 1), "SAME",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
        return jax.nn.softmax(y, axis=-1)

    def tnet(x):
        return torch.softmax(torch.nn.functional.conv3d(x, kt, padding=1),
                             dim=1)
    patch, shape = (8, 8, 8), (20, 16, 14)
    tev = tval3d.SlidingWindowEvaluator(tnet, patch, 2, 4, 3, patch_batch=4,
                                        device="cpu")
    jev = jval3d.SlidingWindowEvaluator(jnet, patch, 2, 4, 3, patch_batch=4)
    extent, offset, corners = tev.plan(shape)
    assert len(corners) % 4 == 0
    vol = np.random.default_rng(8).uniform(0, 1, shape).astype(np.float32)
    got = tev.predict_volume(vol)
    np.testing.assert_array_equal(got, jev.predict_volume(vol))
    assert 0 < got.mean() < 1
    # the margins: the mean of the two classes' probabilities per voxel
    score = torch.zeros((2,) + extent)
    cnt = torch.zeros((1,) + extent)
    t = torch.from_numpy(vol)[None]
    for win in tev._windows(corners):
        sl = (slice(None),) + win
        score[sl] += tnet(t[sl][None])[0]
        cnt[sl] += 1
    avg = score / cnt
    assert float((avg[1] - avg[0]).abs().min()) > 1e-4


def test_gaussian_map_mirror_and_tiled_2d_match_jax():
    """``gaussian_importance_map`` equals JAX's; ``mirror_tta`` of a
    position-dependent function equals JAX's; ``tiled_predict_2d`` gives
    JAX's map."""
    np.testing.assert_array_equal(tval3d.gaussian_importance_map((6, 9, 7)),
                                  jval3d.gaussian_importance_map((6, 9, 7)))
    ramp = np.linspace(0, 1, 4 * 5 * 6).reshape(4, 5, 6).astype(np.float32)

    def jf(x):
        y = x[..., 0] * jnp.asarray(ramp)
        return jnp.stack([y, 1 - y], -1)

    def tf(x):
        y = x[:, 0] * torch.from_numpy(ramp)
        return torch.stack([y, 1 - y], 1)
    x = np.random.default_rng(3).uniform(size=(2, 4, 5, 6, 1)).astype(
        np.float32)
    want = np.asarray(jval3d.mirror_tta(jf, (0, 2))(jnp.asarray(x)))
    got = tval3d.mirror_tta(tf, (0, 2))(torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want,
                               rtol=1e-6, atol=1e-7)
    img = np.random.default_rng(4).uniform(size=(30, 26)).astype(np.float32)

    def j2(p):
        fg = (p[..., 0] > 0.5).astype(jnp.float32)
        return jnp.stack([1 - fg, fg], -1)

    def t2(p):
        fg = (p[:, 0] > 0.5).float()
        return torch.stack([1 - fg, fg], 1)
    got = tval3d.tiled_predict_2d(t2, img, (16, 16), 2, 8, mirror=True,
                                  device="cpu")
    np.testing.assert_array_equal(got, jval3d.tiled_predict_2d(
        j2, img, (16, 16), 2, 8, mirror=True))
    np.testing.assert_array_equal(got, (img > 0.5).astype(np.int32))


def test_test_all_case_matches_jax():
    """``test_all_case`` and ``test_all_case_full_metrics`` (without the
    export) on blob volumes with a net that thresholds each voxel: JAX's
    tables within 1e-9; a class absent from a case adds nothing."""
    vols = tsyn.blob_volumes([(20, 18, 22), (12, 20, 16), (16, 16, 16)],
                             seed=2, num_classes=3)
    vols[2]["label"] = np.where(vols[2]["label"] == 2, 0, vols[2]["label"])
    ds = [{"image": v["image"], "label": v["label"]} for v in vols]
    args = ((16, 16, 16), 8, 8)
    got = tval3d.test_all_case(_threshold_torch(3), ds, 3, *args,
                               device="cpu")
    want = jval3d.test_all_case(_threshold_jax(3), ds, 3, *args)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    assert got[0, 0] > 0
    rows, mean = tval3d.test_all_case_full_metrics(_threshold_torch(3), ds,
                                                   3, *args, device="cpu")
    jrows, jmean = jval3d.test_all_case_full_metrics(_threshold_jax(3), ds,
                                                     3, *args)
    np.testing.assert_allclose(rows, jrows, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(mean, jmean, rtol=1e-9, atol=1e-9)
