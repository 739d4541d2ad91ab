"""The port's held-out test path against the JAX package on the CPU: the
NIfTI-1 writer and reader (byte-identical files, each package reading the
other's), the post-processing helpers, the ACDC and BraTS preprocessing
(equal h5 contents), and both test CLIs (``eval/test_2d.py``,
``eval/test_3d.py``) on the same tiny synthetic trees and weights: the
per-class results, ``metrics.txt``, and the exported files.

The exported label maps may differ only where JAX's own prediction is a
near tie: the top-2 margin of its logits (2D) or probabilities (3D) under
1e-4, the margin rule of the methods' tests."""
import gzip
import os
import struct

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data import postprocess as jpost
from cvssl_tpu.data import preprocessing as jpre
from cvssl_tpu.data import synthetic as jsyn
from cvssl_tpu.eval import test_2d as jtest2d
from cvssl_tpu.eval import test_3d as jtest3d
from cvssl_tpu.models import factory as jfactory
from cvssl_tpu.utils import checkpoint as jckpt
from cvssl_tpu.utils import nifti as jnifti
from cvssl_tpu_torch.data import postprocess as tpost
from cvssl_tpu_torch.data import preprocessing as tpre
from cvssl_tpu_torch.eval import test_2d as ttest2d
from cvssl_tpu_torch.eval import test_3d as ttest3d
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.train import cli as tcli
from cvssl_tpu_torch.utils import nifti as tnifti

MARGIN = 1e-4
DTYPES = (np.uint8, np.int16, np.int32, np.float32, np.float64, np.int64)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_save_nifti_is_byte_identical_and_cross_reads(tmp_path, ndim,
                                                      suffix):
    """Every dtype (int64 is written as float32 by both) at 2D and 3D, gzip
    and plain: the same bytes as JAX's writer under the same file name
    (gzip keeps the name in its header), and each package's reader gives
    the other's array and spacing (a 2D file's third spacing reads 1)."""
    rng = np.random.default_rng(ndim)
    shape = (5, 6, 7)[-ndim:]
    spacing = (0.5, 0.75, 2.0)
    for k in ("j", "t"):
        (tmp_path / k).mkdir()
    for dt in DTYPES:
        a = (rng.normal(size=shape) * 50).astype(dt)
        pj, pt = (str(tmp_path / k / f"{np.dtype(dt).name}{suffix}")
                  for k in ("j", "t"))
        jnifti.save_nifti(pj, a, spacing)
        tnifti.save_nifti(pt, a, spacing)
        with open(pj, "rb") as f, open(pt, "rb") as g:
            assert f.read() == g.read()
        for reader, path in ((jnifti.load_nifti, pt),
                             (tnifti.load_nifti, pj)):
            back, sp = reader(path)
            want = a if dt is not np.int64 else a.astype(np.float32)
            assert back.dtype == want.dtype and np.array_equal(back, want)
            assert np.allclose(sp, spacing[:ndim] + (1.0,) * (3 - ndim))


def test_load_nifti_applies_scl_slope_in_both_packages(tmp_path):
    """A file with scl_slope 2.5 and scl_inter -1 reads as the same
    rescaled float32 array in both packages."""
    a = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    path = str(tmp_path / "scaled.nii.gz")
    tnifti.save_nifti(path, a)
    with gzip.open(path, "rb") as f:
        raw = bytearray(f.read())
    struct.pack_into("<ff", raw, 112, 2.5, -1.0)
    with gzip.GzipFile(path, "wb", mtime=0) as f:
        f.write(bytes(raw))
    got, _ = tnifti.load_nifti(path)
    want, _ = jnifti.load_nifti(path)
    assert got.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got, a.astype(np.float32) * 2.5 - 1.0)


def test_postprocess_helpers_match_jax():
    """The connected-component filter on random binary maps (fractions
    0.05-0.5), ``lr_poly``, ``iou_binary`` and the colour map."""
    rng = np.random.default_rng(0)
    for i in range(6):
        m = (rng.random((4, 20, 20)) < 0.3 + 0.05 * i).astype(np.uint8)
        for frac in (0.05, 0.1, 0.5):
            assert np.array_equal(tpost.post_processing(m, frac),
                                  jpost.post_processing(m, frac))
        g = (rng.random(m.shape) < 0.4).astype(np.uint8)
        assert tpost.iou_binary(m, g) == jpost.iou_binary(m, g)
    empty = np.zeros((3, 4), np.uint8)
    assert np.array_equal(tpost.post_processing(empty), empty)
    assert tpost.iou_binary(empty, empty) == 0.0
    assert tpost.lr_poly(0.01, 123, 1000, 0.9) == jpost.lr_poly(
        0.01, 123, 1000, 0.9)
    assert np.array_equal(tpost.pascal_color_map(), jpost.pascal_color_map())


def _h5_contents(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with h5py.File(os.path.join(directory, name), "r") as f:
            out[name] = {k: f[k][:] for k in f}
    return out


def test_preprocessing_matches_jax(tmp_path):
    """``process_acdc`` (min-max, one h5 a slice) and ``process_brats``
    (bbox, 99.9% clip, nonzero z-score, binary labels) on small NIfTI trees
    written with ``save_nifti`` give the same h5 contents in both
    packages."""
    rng = np.random.default_rng(1)
    img_dir, lab_dir = tmp_path / "image", tmp_path / "label"
    brats = tmp_path / "brats"
    for d in (img_dir, lab_dir, brats):
        d.mkdir()
    for i in range(2):
        tnifti.save_nifti(str(img_dir / f"patient{i}.nii.gz"),
                          rng.normal(size=(3, 12, 10)).astype(np.float32))
        tnifti.save_nifti(str(lab_dir / f"patient{i}_gt.nii.gz"),
                          rng.integers(0, 4, (3, 12, 10)).astype(np.uint8))
        vol = np.zeros((10, 12, 14), np.float32)
        vol[2:8, 3:10, 1:12] = rng.gamma(2.0, 50.0, (6, 7, 11))
        tnifti.save_nifti(str(brats / f"case{i}_flair.nii.gz"), vol)
        tnifti.save_nifti(str(brats / f"case{i}_seg.nii.gz"),
                          rng.integers(0, 3, vol.shape).astype(np.uint8))
    for pkg, out in ((tpre, "t"), (jpre, "j")):
        assert pkg.process_acdc(str(img_dir), str(tmp_path / out / "a")) == 6
        assert pkg.process_brats(str(brats), str(tmp_path / out / "b")) == 2
    for sub in ("a", "b"):
        got = _h5_contents(tmp_path / "t" / sub)
        want = _h5_contents(tmp_path / "j" / sub)
        assert got.keys() == want.keys() and len(got) > 0
        for name in got:
            for k in ("image", "label"):
                assert got[name][k].dtype == want[name][k].dtype
                assert np.array_equal(got[name][k], want[name][k])
    img, lab = tpre.process_brats_volume(vol, np.ones_like(vol, np.uint8))
    assert img.shape == (6, 7, 11) and lab.dtype == np.uint8


# ---------------------------------------------------------------------------
# the test CLIs
# ---------------------------------------------------------------------------

class Flags:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _init(net, shape, seed):
    v = jax.jit(lambda k, d: net.init({"params": k, "dropout": d},
                                      jnp.zeros(shape), train=False))(
        jax.random.PRNGKey(seed), jax.random.PRNGKey(1))
    return jax.tree_util.tree_map(np.asarray, v)


def _write_weights(flags_j, flags_t, reg, variables):
    """The same weights as each package's ``{model}_best_model.ckpt``."""
    for flags in (flags_j, flags_t):
        os.makedirs(ttest3d.snapshot_dir(flags), exist_ok=True)
    name = f"{flags_j.model}_best_model.ckpt"
    jckpt.save_weights(os.path.join(ttest3d.snapshot_dir(flags_j), name),
                       variables["params"])
    torch.save(state_dict_from_flax(reg, variables["params"],
                                    variables.get("batch_stats", {})),
               os.path.join(ttest3d.snapshot_dir(flags_t), name))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def acdc(tmp_path_factory):
    """8 ACDC-shaped cases of 4 slices at 40^2 (zoomed to the 32^2 patch
    and back), all listed as the test split."""
    root = str(tmp_path_factory.mktemp("acdc") / "ACDC")
    jsyn.make_synthetic_acdc(root, num_cases=8, num_val=8, size=40, seed=2)
    return root


@pytest.mark.parametrize("full_metrics", [False, True])
def test_test_2d_matches_jax(acdc, tmp_path, full_metrics):
    """``inference`` of both packages on the same tree and weights (a full
    width UNet, 4 classes, patch 32^2): per-class results within 1e-6, the
    image and label exports byte-identical, the prediction exports equal
    but at JAX's near ties."""
    common = dict(root_path=acdc, exp="ACDC/test", model="unet",
                  num_classes=4, labeled_num=3, patch_size=[32, 32],
                  list_name="val.list", full_metrics=full_metrics,
                  ckpt=None)
    fj = Flags(snapshot_root=str(tmp_path / "j"), **common)
    ft = Flags(snapshot_root=str(tmp_path / "t"), device="cpu", **common)
    net = jfactory.net_factory("unet", in_chns=1, class_num=4)
    variables = _init(net, (1, 32, 32, 1), seed=4)
    _write_weights(fj, ft, "unet", variables)
    want = jtest2d.inference(fj)
    got = ttest2d.inference(ft)
    assert got.shape == want.shape == ((3, 3) if full_metrics else (3, 1))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[:, 0].max() > 0.05

    out_j = ttest3d.snapshot_dir(fj) + "_predictions"
    out_t = ttest3d.snapshot_dir(ft) + "_predictions"
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    apply = jax.jit(lambda x: net.apply(variables, x, train=False))
    for case in sorted(os.listdir(out_j)):
        if not case.endswith("_pred.nii.gz"):
            assert _read(os.path.join(out_j, case)) == _read(
                os.path.join(out_t, case))
            continue
        pj, _ = tnifti.load_nifti(os.path.join(out_j, case))
        pt, _ = tnifti.load_nifti(os.path.join(out_t, case))
        differ = pj != pt
        if differ.any():
            image, _ = ttest2d.read_volume(acdc, case[:-len("_pred.nii.gz")])
            s, x, y = image.shape
            z = ttest2d.zoom(image, (1, 32 / x, 32 / y), order=0)
            top2 = jnp.sort(apply(z[..., None]), axis=-1)[..., -2:]
            margin = np.asarray(top2[..., 1] - top2[..., 0])
            margin = ttest2d.zoom(margin, (1, x / 32, y / 32), order=0)
            assert (margin[differ] < MARGIN).all()


@pytest.fixture(scope="module")
def brats(tmp_path_factory):
    """4 BraTS-shaped train and 4 test volumes of 14^3: padded to the 16^3
    patch, one
    window each (so JAX's filling of a batch of windows with copies of the
    last one weighs nothing)."""
    root = str(tmp_path_factory.mktemp("brats") / "BraTS")
    jsyn.make_synthetic_brats(root, num_train=4, num_val=1, num_test=4,
                              size=14, seed=5)
    return root


def test_test_3d_matches_jax(brats, tmp_path):
    """``inference`` of both packages (UNet3D at full width, patch 16^3):
    the per-class (dice, ravd, hd95, asd) means within 1e-6, ``metrics.txt``
    parsed equal within 1e-6, the image and label exports byte-identical,
    the prediction exports equal but at JAX's near ties."""
    common = dict(root_path=brats, exp="BraTS/test", model="unet_3D",
                  num_classes=2, labeled_num=2, patch_size=[16, 16, 16],
                  stride_xy=8, stride_z=8, split="test")
    fj = Flags(snapshot_root=str(tmp_path / "j"), **common)
    ft = Flags(snapshot_root=str(tmp_path / "t"), device="cpu", **common)
    net = jfactory.net_factory_3d("unet_3D", in_chns=1, class_num=2)
    variables = _init(net, (1, 16, 16, 16, 1), seed=3)
    _write_weights(fj, ft, "unet_3D", variables)
    want = jtest3d.inference(fj)
    times = {}
    got = ttest3d.inference(ft, times=times)
    assert got.shape == want.shape == (1, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert set(times) == {"predict", "metrics", "export"}

    out_j = ttest3d.snapshot_dir(fj) + "_predictions"
    out_t = ttest3d.snapshot_dir(ft) + "_predictions"
    names = sorted(os.listdir(out_j))
    assert names == sorted(os.listdir(out_t)) and len(names) == 13

    def rows(path):
        with open(path) as f:
            return [ln.strip().split(",") for ln in f]
    rj, rt = rows(os.path.join(out_j, "metrics.txt")), rows(
        os.path.join(out_t, "metrics.txt"))
    assert [r[0] for r in rj] == [r[0] for r in rt] == [
        "0", "1", "2", "3", "mean"]
    np.testing.assert_allclose(np.asarray([r[1:] for r in rt], float),
                               np.asarray([r[1:] for r in rj], float),
                               rtol=1e-6, atol=1e-6)
    predict = jax.jit(lambda x: net.apply(variables, x, train=False))
    for name in names:
        if name == "metrics.txt":
            continue
        if not name.endswith("_pred.nii.gz"):
            assert _read(os.path.join(out_j, name)) == _read(
                os.path.join(out_t, name))
            continue
        pj, _ = tnifti.load_nifti(os.path.join(out_j, name))
        pt, _ = tnifti.load_nifti(os.path.join(out_t, name))
        assert pj.dtype == pt.dtype == np.uint8
        differ = pj != pt
        if differ.any():
            img, _ = tnifti.load_nifti(os.path.join(
                out_j, name.replace("_pred", "_img")))
            padded = np.pad(img, 1)[None, ..., None]
            p = np.asarray(jax.nn.softmax(predict(padded), -1))[0, 1:-1,
                                                                1:-1, 1:-1]
            assert (np.abs(p[..., 1] - p[..., 0])[differ] < MARGIN).all()


def test_test_clis_raise_without_cuda(acdc, brats, tmp_path):
    """Without ``--device cpu`` both CLIs ask for the card, and on a machine
    without CUDA they raise before reading anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    a = ttest2d.build_parser().parse_args(
        ["--root_path", acdc, "--snapshot_root", str(tmp_path)])
    b = ttest3d.build_parser().parse_args(
        ["--root_path", brats, "--snapshot_root", str(tmp_path)])
    assert a.device == b.device == "cuda"
    for mod, flags in ((ttest2d, a), (ttest3d, b)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.inference(flags)
    assert not os.listdir(tmp_path)


def test_cli_dim_3_trains_and_tests_vnet(brats, tmp_path):
    """``--dim 3 --model vnet`` through the training CLI on the CPU (mean
    teacher, full width, 16^3, float32 whatever ``--dtype`` says), then its
    best checkpoint through the 3D test CLI's parser and ``inference``."""
    out = str(tmp_path / "cli")
    res = tcli.main(["--root_path", brats, "--exp", "BraTS/vnet", "--dim",
                     "3", "--method", "mean_teacher", "--model", "vnet",
                     "--num_classes", "2", "--patch_size", "16", "16", "16",
                     "--batch_size", "4", "--labeled_bs", "2",
                     "--labeled_num", "2", "--max_iterations", "2",
                     "--val_every", "2", "--ckpt_every", "2",
                     "--device", "cpu", "--dtype", "bfloat16",
                     "--snapshot_root", out])
    assert res["iterations"] == 2
    model = res["state"].models["model"]
    assert all(p.dtype == torch.float32 for p in model.parameters())
    snap = os.path.join(out, "BraTS/vnet_2_labeled", "vnet")
    files = os.listdir(snap)
    assert "model_iter_2.ckpt" in files and "ema_model_iter_2.ckpt" in files
    if "vnet_best_model.ckpt" not in files:
        torch.save(model.state_dict(),
                   os.path.join(snap, "vnet_best_model.ckpt"))
    flags = ttest3d.build_parser().parse_args([
        "--root_path", brats, "--exp", "BraTS/vnet", "--model", "vnet",
        "--labeled_num", "2", "--patch_size", "16", "16", "16",
        "--snapshot_root", out, "--device", "cpu"])
    mean = ttest3d.inference(flags)
    assert mean.shape == (1, 4) and np.isfinite(mean).all()
    assert os.path.exists(os.path.join(snap + "_predictions",
                                       "metrics.txt"))


def test_cli_dim_3_nnunet_takes_the_host_path(brats, tmp_path):
    """nnUNet at a patch whose first two sides differ (4 x 64 x 64, its
    pools' smallest) trains through the CLI: the device store's rot90
    comes after the crop and needs them equal (JAX's store fails to trace
    such a patch), so ``fit`` takes the host pipeline (the reference's
    RandomRotFlip3D, then RandomCrop)."""
    from cvssl_tpu_torch.data.device_store import DeviceVolumeStore
    assert not DeviceVolumeStore.takes_patch((4, 64, 64))
    assert DeviceVolumeStore.takes_patch((96, 96, 64))
    out = str(tmp_path / "nn")
    res = tcli.main(["--root_path", brats, "--exp", "BraTS/nn", "--dim",
                     "3", "--method", "supervised", "--model", "nnUNet",
                     "--num_classes", "2", "--patch_size", "4", "64", "64",
                     "--batch_size", "2", "--labeled_bs", "2",
                     "--labeled_num", "2", "--max_iterations", "1",
                     "--val_every", "1", "--ckpt_every", "1",
                     "--device", "cpu", "--snapshot_root", out])
    assert res["iterations"] == 1
    with open(os.path.join(out, "BraTS/nn_2_labeled", "nnUNet",
                           "log.txt")) as f:
        assert "host data pipeline" in f.read()
