"""The port's fit path against the JAX package on the CPU: datasets and the
synthetic tree, ``TrainConfig.labeled_slices``/``snapshot_path``, the EDT
surface metrics and the host metrics, ``val2d.evaluate``, ``Engine.validate``
on the same weights, the checkpoint writer, ``fit`` (files, resume) and the
CLI. Each comparison states its tolerance."""
import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data import datasets as jdata
from cvssl_tpu.data import synthetic as jsyn
from cvssl_tpu.eval import val2d as jval2d
from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu.ops import edt as jedt
from cvssl_tpu.ops import metrics as jmetrics
from cvssl_tpu.train import cli as jcli
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.data import datasets as tdata
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.eval import val2d as tval2d
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.models.unet import UNet as TUNet
from cvssl_tpu_torch.ops import edt as tedt
from cvssl_tpu_torch.ops import metrics as tmetrics
from cvssl_tpu_torch.train import cli as tcli
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import fit
from cvssl_tpu_torch.train.methods.mean_teacher import MeanTeacher
from cvssl_tpu_torch.utils import checkpoint as ckpt


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
FEATURES = (4, 8, 16, 32, 64)


class _NarrowMT(MeanTeacher):
    def build_models(self):
        return {"model": TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5)}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic ACDC tree from each package, same seed; 64^2 slices,
    8 cases x 4 slices, 2 val volumes."""
    base = tmp_path_factory.mktemp("acdc")
    return (jsyn.make_synthetic_acdc(str(base / "jax" / "ACDC")),
            tsyn.make_synthetic_acdc(str(base / "torch" / "ACDC")))


# ---------------------------------------------------------------------------
# data and config
# ---------------------------------------------------------------------------

def test_synthetic_tree_equals_jax(trees):
    """The same seed gives the same lists and arrays, exactly."""
    jroot, troot = trees
    for name in ("train_slices.list", "val.list"):
        with open(os.path.join(jroot, name)) as a, \
                open(os.path.join(troot, name)) as b:
            assert a.read() == b.read()
    for split in ("train", "val"):
        jds = jdata.SliceDataset(jroot, split)
        tds = tdata.SliceDataset(troot, split)
        assert len(jds) == len(tds) > 0
        for i in range(len(jds)):
            a, b = jds[i], tds[i]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
            assert a["case"] == b["case"] and a["idx"] == b["idx"] == i


@pytest.mark.parametrize("split,num", [("train", None), ("train", 5),
                                       ("val", None), ("val", 1)])
def test_slice_dataset_matches_jax(trees, split, num):
    jroot, _ = trees
    jds = jdata.SliceDataset(jroot, split, num=num)
    tds = tdata.SliceDataset(jroot, split, num=num)
    assert tds.sample_list == jds.sample_list
    assert tds.case_path(tds.sample_list[0]) == jds.case_path(
        jds.sample_list[0])
    for i in (0, len(jds) - 1):
        a, b = jds[i], tds[i]
        assert a["image"].dtype == b["image"].dtype == np.float32
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("root,patients", [("../data/ACDC", 7),
                                           ("/x/ACDC", 140),
                                           ("/x/Prostate", 8),
                                           ("/x/Prostate", 42)])
def test_patients_to_slices_and_config_match_jax(root, patients):
    assert tdata.patients_to_slices(root, patients) == \
        jdata.patients_to_slices(root, patients)
    kw = dict(root_path=root, labeled_num=patients, exp="ACDC/MT",
              snapshot_root="/tmp/m", model="unet")
    tcfg, jcfg = TConfig(**kw), JConfig(**kw)
    assert tcfg.labeled_slices == jcfg.labeled_slices
    assert tcfg.snapshot_path() == jcfg.snapshot_path()
    kw["labeled_slices_override"] = 11
    assert TConfig(**kw).labeled_slices == JConfig(**kw).labeled_slices == 11


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="no slice table"):
        tdata.patients_to_slices("/x/BraTS", 7)
    with pytest.raises(ValueError):
        TConfig(root_path="/x/Other").labeled_slices


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _blob_volume(rng, shape=(4, 40, 44), skip=None):
    lab = np.zeros(shape, np.uint8)
    yy, xx = np.mgrid[: shape[1], : shape[2]]
    for s in range(shape[0]):
        for c in (1, 2, 3):
            if c == skip:
                continue
            cy, cx = rng.integers(6, shape[1] - 6, 2)
            r = rng.integers(3, 10)
            lab[s][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = c
    return lab


@pytest.mark.parametrize("case", ["blobs", "random", "empty_pred",
                                  "empty_gt", "both_empty"])
def test_surface_metrics_batch_matches_jax(case):
    """Dice exactly, HD95 within 1e-4 (float32 interpolation)."""
    rng = np.random.default_rng(5)
    gt = _blob_volume(rng)[None].repeat(2, 0) == 2
    pred = np.roll(gt, (1, 2), axis=(2, 3))
    if case == "random":
        gt = rng.random((3, 4, 20, 24)) < 0.1
        pred = rng.random((3, 4, 20, 24)) < 0.1
    elif case == "empty_pred":
        pred[0] = False
    elif case == "empty_gt":
        gt[1] = False
    elif case == "both_empty":
        pred[:], gt[:] = False, False
    jd, jh = jedt.surface_metrics_batch(jnp.asarray(pred), jnp.asarray(gt))
    td, th = tedt.surface_metrics_batch(torch.from_numpy(pred),
                                        torch.from_numpy(gt))
    assert td.dtype == th.dtype == torch.float32
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)


def test_edt_chunking_is_exact():
    """The min-plus pass gives the same values whatever its chunk size."""
    rng = np.random.default_rng(6)
    f = torch.where(torch.from_numpy(rng.random((3, 9, 20)) < 0.1), 0.0,
                    1e12).float()
    whole = tedt._minplus_pass(f, -1)
    for chunk in (1, 400, 1234):
        torch.testing.assert_close(tedt._minplus_pass(f, -1, chunk), whole,
                                   rtol=0, atol=0)
    want = np.asarray(jedt.squared_edt(jnp.asarray(f.numpy() == 0)))
    np.testing.assert_array_equal(tedt.squared_edt(f == 0).numpy(), want)


@pytest.mark.parametrize("skip", [None, 2])
def test_host_metrics_equal_jax(skip):
    rng = np.random.default_rng(7)
    lab = _blob_volume(rng, skip=skip)
    pred = np.roll(lab, 1, axis=1)
    pred[rng.random(pred.shape) < 0.02] = 0
    for c in (1, 2, 3):
        assert tmetrics.calculate_metric_percase_val(pred == c, lab == c) \
            == jmetrics.calculate_metric_percase_val(pred == c, lab == c)
    if skip is None:
        for fn in ("calculate_metric_percase_test",
                   "calculate_metric_percase_3d"):
            assert getattr(tmetrics, fn)(pred == 1, lab == 1) == \
                getattr(jmetrics, fn)(pred == 1, lab == 1)
    np.testing.assert_array_equal(tmetrics.cal_dice(pred, lab, 4),
                                  jmetrics.cal_dice(pred, lab, 4))
    got = tmetrics.dice_per_class(torch.from_numpy(pred),
                                  torch.from_numpy(lab), 4)
    want = jmetrics.dice_per_class(jnp.asarray(pred), jnp.asarray(lab), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _val_volumes(seed, shape):
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(3):
        lab = _blob_volume(rng, shape=shape)
        img = lab.astype(np.float32) + rng.normal(0, .1, lab.shape)
        data.append({"image": img.astype(np.float32), "label": lab})
    return data


@pytest.mark.parametrize("shape", [(4, 48, 48), (3, 40, 56)])
@pytest.mark.parametrize("device_metrics", [False, True])
def test_val2d_evaluate_matches_jax(shape, device_metrics):
    """The same fixed predictor (rounded image intensity) through both
    packages; (48, 48) volumes take the uniform path, (40, 56) the zoom
    path. Within 1e-4 (the JAX device path sums float32 in another
    order)."""
    data = _val_volumes(9, shape)

    def jpredict(batch):  # (B, H, W, 1) -> int map
        return np.clip(np.round(batch[..., 0]), 0, 3).astype(np.uint8)

    def tpredict(batch):  # (B, 1, H, W) -> int map
        return torch.clamp(torch.round(batch[:, 0]), 0, 3).to(torch.uint8)

    want = jval2d.evaluate(data, jpredict, 4, (48, 48),
                           device_metrics=device_metrics)
    got = tval2d.evaluate(data, tpredict, 4, (48, 48),
                          device_metrics=device_metrics)
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Engine.validate on the same weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def validated(trees):
    """JAX ``Engine.validate`` and the port's, narrow UNet, float32, the
    port's weights carried across from the flax ones."""
    jroot, _ = trees
    val_ds = jdata.SliceDataset(jroot, "val")
    kw = dict(method="mean_teacher", model="unet", num_classes=C,
              batch_size=4, labeled_bs=2, patch_size=(64, 64),
              labeled_slices_override=4, dtype="float32", s2d_levels=0,
              num_devices=1)
    jeng = JEngine(JConfig(**kw))
    jeng.modules = {"model": JUNet(in_chns=1, num_classes=C,
                                   features=FEATURES, dropout=(0.0,) * 5)}
    sample = {"image": np.zeros((4, 64, 64, 1), np.float32),
              "label": np.zeros((4, 64, 64), np.int32)}
    jstate = jeng.init_state(jax.random.PRNGKey(3), sample)
    want = jeng.validate(jstate, val_ds)
    tcfg = TConfig(**kw)
    teng = TEngine(tcfg, method=_NarrowMT(tcfg), device="cpu")
    tstate = teng.init_state()
    tstate.models["model"].load_state_dict(state_dict_from_flax("unet",
        jax.tree_util.tree_map(np.asarray, jstate.params["model"]),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats["model"])))
    return dict(want=want, teng=teng, tstate=tstate, val_ds=val_ds)


def test_engine_validate_matches_jax(validated):
    """Per-class (dice, hd95) of the same weights on the same val set, within
    1e-4 (the forwards agree to float32 rounding, so the argmax maps do)."""
    v = validated
    got = v["teng"].validate(v["tstate"], v["val_ds"])
    assert got.shape == (C - 1, 2)
    np.testing.assert_allclose(got, v["want"], rtol=0, atol=1e-4)
    assert v["tstate"].models["model"].training


def test_resident_validation_matches_host_path(validated):
    """The card's path (val set uploaded once, forward + argmax + EDT
    metrics on the device), here on the CPU, against ``validate``'s host
    path: within 1e-4 (EDT HD95 vs scipy, float32)."""
    v = validated
    eng, state, val_ds = v["teng"], v["tstate"], v["val_ds"]
    store = eng._val_resident_store(val_ds, (64, 64))
    assert store is not None and store["images"].shape == (8, 64, 64)
    assert eng._val_resident_store(val_ds, (64, 64)) is store  # once
    assert eng._val_resident_store(val_ds, (32, 32)) is None   # needs zoom
    out = eng._val_fused_fn("model", store["shape"], store["n"])(
        state, store["images"], store["labels"])
    np.testing.assert_allclose(out.numpy() / store["n"],
                               eng.validate(state, val_ds), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_async_writer_order_backpressure_and_errors():
    writer = ckpt.AsyncWriter()
    done, gate = [], threading.Event()
    writer.submit(lambda: (gate.wait(10), done.append(0)))
    writer.submit(lambda: done.append(1))
    writer.submit(lambda: done.append(2))   # queue full: job 0 still runs
    blocked = threading.Thread(target=writer.submit,
                               args=(lambda: done.append(3),))
    blocked.start()
    blocked.join(0.3)
    assert blocked.is_alive()               # backpressure: submit waits
    gate.set()
    blocked.join(10)
    assert not blocked.is_alive()
    writer.flush()
    assert done == [0, 1, 2, 3]

    def fail():
        raise OSError("disk full")
    writer.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        writer.flush()
    writer.submit(fail)
    with pytest.raises(OSError, match="disk full"):
        writer.close()


def test_snapshot_is_independent_and_files_are_atomic(tmp_path):
    live = {"w": torch.ones(3), "n": 7, "nested": [torch.zeros(2)]}
    snap = ckpt.device_snapshot(live)
    live["w"].add_(1.0)
    live["nested"][0].add_(5.0)
    host = ckpt.to_host(snap)
    assert torch.equal(host["w"], torch.ones(3)) and host["n"] == 7
    assert torch.equal(host["nested"][0], torch.zeros(2))
    for k in (3, 10, 7, 2):
        ckpt.save_train_state(str(tmp_path), host, k, meta={"k": k})
    tree, it, meta = ckpt.restore_latest(str(tmp_path))
    assert it == 10 and meta == {"k": 10} and tree["n"] == 7
    ckpt.prune_old(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["model_iter_10.ckpt",
                                            "model_iter_7.ckpt"]
    assert ckpt.restore_latest(str(tmp_path / "none")) == (None, 0, {})


# ---------------------------------------------------------------------------
# fit and the CLI
# ---------------------------------------------------------------------------

def _fit_cfg(root, snapshot_root, **kw):
    base = dict(root_path=root, exp="ACDC/port", method="mean_teacher",
                model="unet", num_classes=C, batch_size=4, labeled_bs=2,
                labeled_slices_override=8, patch_size=(64, 64),
                dtype="float32", max_iterations=100, val_every=2,
                ckpt_every=2, log_every=1, snapshot_root=str(snapshot_root))
    base.update(kw)
    return TConfig(**base)


def _fit(cfg, steps):
    engine = TEngine(cfg, method=_NarrowMT(cfg), device="cpu")
    return fit(cfg, engine=engine, max_steps=steps)


def test_fit_writes_the_contract_files(trees, tmp_path):
    _, troot = trees
    cfg = _fit_cfg(troot, tmp_path)
    result = _fit(cfg, 4)
    assert result["iterations"] == 4 and result["state"].step == 4
    assert len(result["val_seconds"]) == 2
    assert set(result["step_ms"]) == {"gather", "forward", "teacher",
                                      "backward", "update"}
    snap = cfg.snapshot_path()
    with open(os.path.join(snap, "log.txt")) as f:
        assert "last step's phases (ms) gather" in f.read()
    files = set(os.listdir(snap))
    for name in ("unet_best_model.ckpt", "iter_2.ckpt", "iter_4.ckpt",
                 "ema_model_iter_2.ckpt", "ema_model_iter_4.ckpt",
                 "model_iter_2.ckpt", "model_iter_4.ckpt", "log.txt"):
        assert name in files, name
    assert any(f.startswith("iter_2_dice_") for f in files)
    assert os.path.exists(os.path.join(snap, "log", "metrics.jsonl"))
    best = ckpt.load_weights(os.path.join(snap, "unet_best_model.ckpt"))
    assert set(best) == set(result["state"].models["model"].state_dict())
    full = ckpt.load_weights(os.path.join(snap, "model_iter_4.ckpt"))
    assert full["meta"]["best_dice"] == result["best_dice"]
    assert full["state"]["optimizers"]["model"]["count"] == 4
    assert 0.0 <= result["best_dice"]["model"] <= 1.0


def test_fit_resume_is_bit_equal(trees, tmp_path):
    """Stopped at the checkpoint at 2 and resumed to 4 == 4 in one run:
    step, weights, BatchNorm buffers, teacher, optimizer state and count,
    generator and best_dice, bit for bit on the CPU."""
    _, troot = trees
    straight = _fit(_fit_cfg(troot, tmp_path / "a"), 4)
    cfg = _fit_cfg(troot, tmp_path / "b")
    _fit(cfg, 2)
    resumed = _fit(cfg, 4)
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        assert "resumed from iteration 2" in f.read()
    a, b = straight["state"], resumed["state"]
    assert a.step == b.step == 4
    assert straight["best_dice"] == resumed["best_dice"]
    ta, tb = ckpt.state_tree(a), ckpt.state_tree(b)
    for group in ("models", "teachers"):
        for k, v in ta[group]["model"].items():
            assert torch.equal(v, tb[group]["model"][k]), (group, k)
    oa, ob = ta["optimizers"]["model"], tb["optimizers"]["model"]
    assert oa["count"] == ob["count"] == 4
    for i, st in oa["state"]["state"].items():
        assert torch.equal(st["momentum_buffer"],
                           ob["state"]["state"][i]["momentum_buffer"])
    assert torch.equal(ta["generator"], tb["generator"])


def test_fit_scan_steps_chunks_match_single_steps(trees, tmp_path):
    """scan_steps=3 with val/ckpt every 2 runs chunks of 2 (never across a
    boundary) through ``train_steps``: the same state as one step at a
    time, bit for bit, and the same files."""
    _, troot = trees
    single = _fit(_fit_cfg(troot, tmp_path / "a", log_every=100), 4)
    cfg = _fit_cfg(troot, tmp_path / "b", log_every=100, scan_steps=3)
    chunked = _fit(cfg, 4)
    assert chunked["iterations"] == 4 and len(chunked["val_seconds"]) == 2
    for k, v in single["state"].models["model"].state_dict().items():
        assert torch.equal(v, chunked["state"].models["model"].state_dict()[k])
    assert {f for f in os.listdir(cfg.snapshot_path()) if "iter" in f} == \
        {f for f in os.listdir(_fit_cfg(troot, tmp_path / "a")
                               .snapshot_path()) if "iter" in f}


def test_fit_entropy_seed_when_not_deterministic(trees, tmp_path):
    _, troot = trees
    cfg = _fit_cfg(troot, tmp_path, deterministic=False, val_every=50,
                   ckpt_every=50)
    assert _fit(cfg, 1)["iterations"] == 1
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        assert "--deterministic 0: entropy seed" in f.read()


@pytest.mark.parametrize("change", ["dim3", "transform", "host_data",
                                    "profile", "pretrained"])
def test_fit_raises_for_what_is_not_ported(trees, tmp_path, change):
    _, troot = trees
    kw = {"dim3": dict(dim=3), "host_data": dict(dim=3, device_data=False),
          "profile": dict(profile_dir=str(tmp_path / "prof")),
          "pretrained": dict(pretrained_ckpt=str(tmp_path / "missing.pth"))
          }.get(change, {})
    cfg = _fit_cfg(troot, tmp_path, **kw)
    if change in ("dim3", "host_data"):
        # the 3D path is ported, on the store and on the host pipeline;
        # CTAugment, a 2D transform, has no 3D data path on either
        method = _NarrowMT(cfg)
        method.transform = "cta"
        engine = TEngine(cfg, method=method, device="cpu")
        with pytest.raises(NotImplementedError, match="no 3D data path"):
            fit(cfg, engine=engine, max_steps=1)
        assert not os.path.exists(cfg.snapshot_path())
        return
    if change == "profile":
        # the step-window profiler is ported: fit no longer raises for
        # profile_dir (tests/test_torch_port_profiler.py traces a window)
        result = fit(cfg, engine=TEngine(cfg, method=_NarrowMT(cfg),
                                         device="cpu"), max_steps=1)
        assert result["iterations"] == 1
        return
    if change == "pretrained":
        # the loader is ported (cnn_checkpoint): a missing file raises, as
        # in JAX, before anything is written
        with pytest.raises(FileNotFoundError,
                           match="pretrained checkpoint not found"):
            fit(cfg, engine=TEngine(cfg, method=_NarrowMT(cfg),
                                    device="cpu"), max_steps=1)
        assert not os.path.exists(cfg.snapshot_path())
        return
    method = _NarrowMT(cfg)
    if change == "transform":
        # the host CTAugment path, on a method without its hooks
        method.transform = "cta"
    engine = TEngine(cfg, method=method, device="cpu")
    with pytest.raises(NotImplementedError):
        fit(cfg, engine=engine, max_steps=1)
    assert not os.path.exists(cfg.snapshot_path())


def test_cli_has_the_jax_flags():
    """The port's parser has every flag of the JAX parser, with the same
    defaults, plus ``--device``."""
    def flags(parser):
        return {a.option_strings[0]: a.default for a in parser._actions
                if a.option_strings and a.option_strings[0] != "-h"}
    jflags, tflags = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert set(tflags) - set(jflags) == {"--device"}
    assert set(jflags) <= set(tflags)
    assert {k: tflags[k] for k in jflags} == jflags
    assert tflags["--device"] == "cuda"
    args = tcli.build_parser().parse_args([])
    jargs = jcli.build_parser().parse_args([])
    assert dataclasses.asdict(tcli.config_from_args(args)) == {
        k: v for k, v in dataclasses.asdict(
            jcli.config_from_args(jargs)).items()
        if k in {f.name for f in dataclasses.fields(TConfig)}}


def test_cli_pretrained_ckpt_raises_before_any_step(trees, tmp_path,
                                                   monkeypatch):
    """``--pretrained_ckpt`` naming a missing file raises, as in JAX,
    rather than train from a random init: before any step, with nothing
    written under the snapshot root (the loading itself is
    ``tests/test_torch_port_pretrained.py``'s)."""
    _, troot = trees
    steps = []
    monkeypatch.setattr(TEngine, "train_steps",
                        lambda self, *a, **k: steps.append(1))
    with pytest.raises(FileNotFoundError,
                       match="pretrained checkpoint not found"):
        tcli.main(["--root_path", troot, "--exp", "cli", "--method",
                   "supervised", "--max_iterations", "2", "--batch_size",
                   "2", "--labeled_slices", "8", "--patch_size", "32", "32",
                   "--device", "cpu", "--dtype", "float32",
                   "--pretrained_ckpt", str(tmp_path / "missing.pth"),
                   "--snapshot_root", str(tmp_path / "snap")])
    assert steps == []
    assert not os.path.exists(tmp_path / "snap")


@pytest.mark.parametrize("argv", [["--distributed", "--device", "cpu"],
                                  ["--dcn_slices", "2"]])
def test_cli_multi_host_flags_raise(argv, monkeypatch):
    """``--dcn_slices`` (TPU mesh folding) raises; ``--distributed`` joins
    torchrun's process group, so outside torchrun it raises naming it (the
    multi-rank runs are ``tests/test_torch_port_parallel.py``'s)."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    if "--distributed" in argv:
        with pytest.raises(RuntimeError, match="torchrun"):
            tcli.config_from_args(tcli.build_parser().parse_args(argv))
    else:
        with pytest.raises(NotImplementedError):
            tcli.config_from_args(tcli.build_parser().parse_args(argv))


def test_cli_trains_on_the_cpu(trees, tmp_path):
    _, troot = trees
    result = tcli.main(["--root_path", troot, "--exp", "cli",
                        "--method", "supervised", "--max_iterations", "2",
                        "--batch_size", "2", "--labeled_slices", "8",
                        "--patch_size", "32", "32", "--val_every", "2",
                        "--ckpt_every", "2", "--device", "cpu",
                        "--dtype", "float32", "--snapshot_root",
                        str(tmp_path)])
    assert result["iterations"] == 2
    snap = os.path.join(tmp_path, "cli_7_labeled", "unet")
    assert os.path.exists(os.path.join(snap, "model_iter_2.ckpt"))
    assert not os.path.exists(os.path.join(snap, "ema_model_iter_2.ckpt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--root_path", troot, "--snapshot_root", str(tmp_path)])


# ---------------------------------------------------------------------------
# the other 2D methods through fit and the CLI
# ---------------------------------------------------------------------------

def _narrow_method(cfg):
    """``cfg.method`` on narrow models (dropout kept: more draws from the
    step's generator for the resume to restore)."""
    from cvssl_tpu_torch.models import net_factory
    from cvssl_tpu_torch.train.methods.base import get_method

    class Narrow(type(get_method(cfg.method, cfg))):
        def _factory(self, net_type):
            return net_factory(net_type, 1, C, features=FEATURES)
    return Narrow(cfg)


def _fit_method(cfg, steps):
    engine = TEngine(cfg, method=_narrow_method(cfg), device="cpu")
    return fit(cfg, engine=engine, max_steps=steps)


@pytest.mark.parametrize("method", ["uamt", "ict", "deep_co_training",
                                    "cps", "cct", "urpc"])
def test_fit_and_get_method_accept_the_2d_methods(trees, tmp_path, method):
    _, troot = trees
    cfg = _fit_cfg(troot, tmp_path, method=method, val_every=50,
                   ckpt_every=50, patch_size=(32, 32))
    result = _fit_method(cfg, 1)
    assert result["iterations"] == 1
    assert set(result["best_dice"]) == set(result["state"].models)


def test_fit_cps_writes_the_dual_model_names(trees, tmp_path):
    """JAX ``engine.py:693-707``: the slot prefix on every weights file,
    ``{model}_best_{slot}``, no EMA files (cps has no teacher). Seed 1:
    both models reach a Dice above 0, so both write their best files."""
    _, troot = trees
    cfg = _fit_cfg(troot, tmp_path, method="cps", seed=1)
    result = _fit_method(cfg, 4)
    files = set(os.listdir(cfg.snapshot_path()))
    for name in ("model1_iter_2.ckpt", "model2_iter_2.ckpt",
                 "model1_iter_4.ckpt", "model2_iter_4.ckpt",
                 "model_iter_2.ckpt", "model_iter_4.ckpt"):
        assert name in files, name
    assert not any("ema" in f for f in files), files
    assert not any(f.startswith("iter_") for f in files), files
    for slot in ("model1", "model2"):
        assert result["best_dice"][slot] > 0.0
        assert f"unet_best_{slot}.ckpt" in files
        assert any(f.startswith(f"{slot}_iter_") and "_dice_" in f
                   for f in files)
        best = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                              f"unet_best_{slot}.ckpt"))
        assert set(best) == set(result["state"].models[slot].state_dict())
    full = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                          "model_iter_4.ckpt"))
    assert set(full["state"]["optimizers"]) == {"model1", "model2"}
    assert full["state"]["teachers"] == {}


@pytest.mark.parametrize("method", ["uamt", "cps", "adversarial",
                                    "fixmatch"])
def test_fit_resume_is_bit_equal_for(trees, tmp_path, method):
    """uamt (the most draws from the step's generator: noise, dropout bytes
    of five passes), cps (two models, two optimizers), adversarial (the
    discriminator, its channel dropout and its Adam) and fixmatch (the
    weak_strong store's draws): stopped at 2 and resumed to 4 == 4 in one
    run, bit for bit, every optimizer's state and count included."""
    _, troot = trees
    straight = _fit_method(_fit_cfg(troot, tmp_path / "a", method=method), 4)
    cfg = _fit_cfg(troot, tmp_path / "b", method=method)
    _fit_method(cfg, 2)
    resumed = _fit_method(cfg, 4)
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        assert "resumed from iteration 2" in f.read()
    assert straight["best_dice"] == resumed["best_dice"]
    ta, tb = (ckpt.state_tree(r["state"]) for r in (straight, resumed))
    assert ta["step"] == tb["step"] == 4
    for group in ("models", "teachers"):
        assert set(ta[group]) == set(tb[group])
        for n in ta[group]:
            for k, v in ta[group][n].items():
                assert torch.equal(v, tb[group][n][k]), (group, n, k)
    assert set(ta["optimizers"]) == set(resumed["state"].models)
    for n, oa in ta["optimizers"].items():
        ob = tb["optimizers"][n]
        assert oa["count"] == ob["count"] == 4
        assert oa["state"]["state"]
        for i, st in oa["state"]["state"].items():
            assert set(st) == set(ob["state"]["state"][i])
            for k, v in st.items():       # SGD momentum; Adam's moments
                assert torch.equal(v, ob["state"]["state"][i][k]), (n, k)
    assert torch.equal(ta["generator"], tb["generator"])


@pytest.mark.parametrize("method", ["cps", "uamt", "adversarial",
                                    "exam_student_teacher", "fixmatch"])
def test_cli_trains_the_2d_methods_on_the_cpu(trees, tmp_path, method):
    """Full-width models through the CLI: the method runs, and the
    periodic files carry its slots' names; the discriminator of the
    adversarial methods is in the full state only (JAX validates and
    best-checkpoints ``model`` alone)."""
    _, troot = trees
    result = tcli.main(["--root_path", troot, "--exp", "cli",
                        "--method", method, "--max_iterations", "2",
                        "--batch_size", "4", "--labeled_bs", "2",
                        "--labeled_slices", "8", "--patch_size", "32", "32",
                        "--val_every", "2", "--ckpt_every", "2",
                        "--device", "cpu", "--dtype", "float32",
                        "--snapshot_root", str(tmp_path)])
    assert result["iterations"] == 2
    snap = os.path.join(tmp_path, "cli_7_labeled", "unet")
    files = set(os.listdir(snap))
    assert "model_iter_2.ckpt" in files
    if method == "cps":
        assert {"model1_iter_2.ckpt", "model2_iter_2.ckpt"} <= files
        assert not any("ema" in f for f in files)
    elif method == "adversarial":
        assert "iter_2.ckpt" in files
        assert not any("ema" in f for f in files)
    else:
        assert {"iter_2.ckpt", "ema_model_iter_2.ckpt"} <= files
    if method in ("adversarial", "exam_student_teacher"):
        assert not any("dan" in f for f in files), files
        assert set(result["best_dice"]) == {"model"}
        full = ckpt.load_weights(os.path.join(snap, "model_iter_2.ckpt"))
        assert set(full["state"]["models"]) == {"model", "dan"}
        assert full["state"]["optimizers"]["dan"]["count"] == 2


def test_fit_fixmatch_trains_from_the_weak_strong_store(trees, tmp_path):
    """fit builds the store in the method's mode, and fixmatch's batches
    carry the weak and strong views; the EMA teacher's files are written
    as for the mean teacher."""
    _, troot = trees
    cfg = _fit_cfg(troot, tmp_path, method="fixmatch", patch_size=(32, 32))
    engine = TEngine(cfg, method=_narrow_method(cfg), device="cpu")
    keys = []
    loss = engine.method.loss

    def spy(ctx, batch):
        keys.append(set(batch))
        return loss(ctx, batch)
    engine.method.loss = spy
    result = fit(cfg, engine=engine, max_steps=2)
    assert result["iterations"] == 2
    assert engine.store.mode == "weak_strong"
    assert keys == [{"image", "image_weak", "image_strong", "label_aug",
                     "label", "idx"}] * 2
    files = set(os.listdir(cfg.snapshot_path()))
    assert {"iter_2.ckpt", "ema_model_iter_2.ckpt",
            "model_iter_2.ckpt"} <= files
