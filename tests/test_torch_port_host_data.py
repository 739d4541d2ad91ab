"""The port's host data path against the JAX package on the CPU: each 2D
host transform bit for bit over 32 samples from one seed (with the
generator left in the same state), ``collate`` (NCHW), the samplers' saved
place in the stream, the first ``DataPipeline.stream()`` batches of
``build_2d_data``'s datasets for each transform, a ``fit`` with
``device_data=False`` that writes its files and resumes bit-equal, and
``fit`` of ``contrastive_consistency`` on the host CTA path whatever
``device_data`` says."""
import os

import numpy as np
import pytest
import torch

from cvssl_tpu.data import pipeline as jpipe
from cvssl_tpu.data import sampler as jsampler
from cvssl_tpu.data import synthetic as jsyn
from cvssl_tpu.data import transforms as jT
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import build_2d_data as jbuild
from cvssl_tpu_torch.data import pipeline as tpipe
from cvssl_tpu_torch.data import sampler as tsampler
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.data import transforms as tT
from cvssl_tpu_torch.data.sampler import (ShuffleBatchSampler,
                                          TwoStreamBatchSampler)
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import build_2d_data as tbuild
from cvssl_tpu_torch.train.engine import fit
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.utils import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


C = 4
FEATURES = (4, 8, 16, 32, 64)
SAMPLES = 32
PATCH = (24, 28)


def _samples(seed=0, n=SAMPLES):
    """Slices of several shapes (not the patch), float32 images in [0, 1)
    and integer labels."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shape = (30 + i % 3, 34 - i % 2)
        out.append({"image": rng.random(shape).astype(np.float32),
                    "label": rng.integers(0, C, shape).astype(np.uint8)})
    return out


TRANSFORMS = {
    "random_rot_flip": lambda T, rng, s: T.random_rot_flip(
        rng, s["image"], s["label"]),
    "random_rotate": lambda T, rng, s: T.random_rotate(
        rng, s["image"], s["label"]),
    "zoom_to": lambda T, rng, s: (T.zoom_to(s["image"], PATCH),
                                  T.zoom_to(s["label"], PATCH)),
    "color_jitter": lambda T, rng, s: T.color_jitter(rng, s["image"]),
    "RandomGenerator": lambda T, rng, s: T.RandomGenerator(PATCH, rng)(s),
    "RandomGeneratorWeak": lambda T, rng, s: T.RandomGeneratorWeak(
        PATCH, rng)(s),
    "WeakStrongAugment": lambda T, rng, s: T.WeakStrongAugment(
        PATCH, rng)(s),
}


def _leaves(out):
    if isinstance(out, dict):
        return [(k, out[k]) for k in sorted(out)]
    if isinstance(out, tuple):
        return list(enumerate(out))
    return [(0, out)]


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_host_transform_is_jax_bit_for_bit(name):
    """32 samples through one generator each side: every output array
    equal to JAX's in value, dtype and shape, and the generators in the
    same state after each sample (the same draws in the same order)."""
    fn = TRANSFORMS[name]
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for s in _samples():
        want = fn(jT, jrng, dict(s))
        got = fn(tT, trng, dict(s))
        assert [k for k, _ in _leaves(got)] == [k for k, _ in _leaves(want)]
        for (_, g), (_, w) in zip(_leaves(got), _leaves(want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        assert trng.bit_generator.state == jrng.bit_generator.state


def test_collate_is_jax_collate_in_nchw():
    rng = np.random.default_rng(1)
    samples = [dict(tT.WeakStrongAugment(PATCH, rng)(s), idx=i, case="c")
               for i, s in enumerate(_samples(n=3))]
    want = jpipe.collate(samples)
    got = tpipe.collate(samples)
    assert set(got) == set(want) and "case" not in got
    for k, w in want.items():
        g = got[k]
        if w.ndim == 4:
            w = np.moveaxis(w, -1, 1)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got["image"].shape == (3, 1) + PATCH
    assert got["label"].dtype == np.int32


@pytest.mark.parametrize("kind", ["two_stream", "shuffle"])
def test_sampler_epoch_and_stream_match_jax(kind):
    """One epoch (``iter``, what ``DataPipeline.__iter__`` loads) and then
    the endless stream, from one generator each side, with a draw between
    the batches: the same indices and the same generator state."""
    def make(mod, rng):
        if kind == "two_stream":
            return mod.TwoStreamBatchSampler(range(7), range(7, 16), 5, 3,
                                             rng)
        return mod.ShuffleBatchSampler(11, 3, rng)
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    j, t = make(jsampler, jrng), make(tsampler, trng)
    assert [[int(i) for i in b] for b in j] == \
        [[int(i) for i in b] for b in t]
    js, ts = j.epochs(), t.epochs()
    for _ in range(12):
        assert [int(i) for i in next(js)] == [int(i) for i in next(ts)]
        assert jrng.random() == trng.random()


@pytest.mark.parametrize("kind", ["two_stream", "shuffle"])
def test_sampler_continues_from_its_saved_state(kind):
    """A stream saved mid-epoch (with a transform's draws between the
    batches, on the shared generator) and continued by another sampler
    gives the same batches and draws as the uninterrupted stream, across
    epoch boundaries."""
    def make(seed):
        rng = np.random.default_rng(seed)
        if kind == "two_stream":
            return TwoStreamBatchSampler(range(7), range(7, 16), 5, 3, rng)
        return ShuffleBatchSampler(11, 3, rng)

    def take(sampler, stream, n):
        out = []
        for _ in range(n):
            out.append([int(i) for i in next(stream)])
            out.append(float(sampler.rng.random()))
        return out
    a = make(0)
    sa = a.epochs()
    take(a, sa, 5)
    saved = a.state_dict()
    want = take(a, sa, 12)
    b = make(99)
    got = take(b, b.epochs(saved), 12)
    assert got == want


# ---------------------------------------------------------------------------
# DataPipeline on build_2d_data's datasets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One synthetic ACDC tree from each package, same seed: 48^2 slices
    of 8 cases x 4 slices, 2 val volumes."""
    base = tmp_path_factory.mktemp("acdc")
    return (jsyn.make_synthetic_acdc(str(base / "jax" / "ACDC"), size=48),
            tsyn.make_synthetic_acdc(str(base / "torch" / "ACDC"), size=48))


def _cfgs(roots, **kw):
    base = dict(num_classes=C, batch_size=4, labeled_bs=2,
                labeled_slices_override=8, patch_size=(32, 32))
    base.update(kw)
    return (JConfig(root_path=roots[0], **base),
            TConfig(root_path=roots[1], **base))


@pytest.mark.parametrize("transform", ["default", "weak", "weak_strong"])
def test_stream_batches_equal_jax(trees, transform):
    """The first 5 prefetched batches of ``build_2d_data``'s datasets and
    sampler (the transform sharing the sampler's generator), equal to
    JAX's after NHWC -> NCHW, bit for bit."""
    jcfg, tcfg = _cfgs(trees)
    jds, jsampler, _ = jbuild(jcfg, False, transform)
    tds, tsampler, _ = tbuild(tcfg, False, transform)
    jstream = jpipe.DataPipeline(jds, jsampler).stream()
    tstream = tpipe.DataPipeline(tds, tsampler).stream()
    try:
        for _ in range(5):
            want, got = next(jstream), next(tstream)
            assert set(got) == set(want)
            for k, w in want.items():
                if w.ndim == 4:
                    w = np.moveaxis(w, -1, 1)
                assert got[k].dtype == w.dtype, k
                np.testing.assert_array_equal(got[k], w)
    finally:
        jstream.close()
        tstream.close()


def test_stream_continues_from_the_consumed_state(trees):
    """The prefetch thread runs ahead; ``consumed_state`` is the sampler's
    state after the batches handed over, and a new stream from it gives
    the batches that came next. An error in the prefetch thread is raised
    in the consumer."""
    _, tcfg = _cfgs(trees, batch_size=6, labeled_bs=3)
    pipe = tpipe.DataPipeline(*tbuild(tcfg, False)[:2])
    stream = pipe.stream()
    for _ in range(3):
        next(stream)
    saved = pipe.consumed_state
    want = [next(stream) for _ in range(4)]
    stream.close()
    other = tpipe.DataPipeline(*tbuild(tcfg, False)[:2])
    resumed = other.stream(saved)
    for w in want:
        g = next(resumed)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    resumed.close()

    class Broken:
        def __getitem__(self, i):
            raise KeyError(f"no sample {i}")
    broken = tpipe.DataPipeline(Broken(), tbuild(tcfg, False)[1]).stream()
    with pytest.raises(KeyError, match="no sample"):
        next(broken)


# ---------------------------------------------------------------------------
# fit with device_data=False
# ---------------------------------------------------------------------------

def _fit_cfg(root, out, **kw):
    base = dict(root_path=root, exp="ACDC/host", method="mean_teacher",
                model="unet", num_classes=C, batch_size=4, labeled_bs=2,
                labeled_slices_override=8, patch_size=(32, 32),
                dtype="float32", max_iterations=100, val_every=2,
                ckpt_every=2, log_every=1, snapshot_root=str(out),
                device_data=False)
    base.update(kw)
    return TConfig(**base)


def _fit(cfg, steps, batches=None):
    class Narrow(type(get_method(cfg.method, cfg))):
        def _factory(self, net_type):
            return net_factory(net_type, 1, C, features=FEATURES)
    engine = TEngine(cfg, method=Narrow(cfg), device="cpu")
    if batches is not None:
        step = engine.train_step

        def spy(state, batch):
            batches.append({k: v.clone() for k, v in batch.items()})
            return step(state, batch)
        engine.train_step = spy
    return engine, fit(cfg, engine=engine, max_steps=steps)


@pytest.mark.parametrize("method", ["mean_teacher", "fixmatch"])
def test_fit_host_path_writes_and_resumes_bit_equal(trees, tmp_path,
                                                    method):
    """``fit`` with ``device_data=False`` trains from the host pipeline (no
    store; fixmatch on the host's WeakStrongAugment), writes the contract
    files, and stopped at 2 and resumed to 4 it sees the same batches and
    ends where one run of 4 does, bit for bit: models, teachers, every
    optimizer's state and the step's generator."""
    _, troot = trees
    seen_a, seen_b = [], []
    engine, straight = _fit(_fit_cfg(troot, tmp_path / "a", method=method),
                            4, seen_a)
    assert engine.store is None
    cfg = _fit_cfg(troot, tmp_path / "b", method=method)
    _fit(cfg, 2, seen_b)
    _, resumed = _fit(cfg, 4, seen_b)
    assert len(seen_a) == len(seen_b) == 4
    for a, b in zip(seen_a, seen_b):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert seen_a[0]["image"].shape == (4, 1, 32, 32)
    assert seen_a[0]["label"].dtype == torch.int32
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        log = f.read()
    assert "resumed from iteration 2" in log
    assert "host data pipeline" in log
    files = set(os.listdir(cfg.snapshot_path()))
    assert {"iter_2.ckpt", "iter_4.ckpt", "ema_model_iter_4.ckpt",
            "model_iter_2.ckpt", "model_iter_4.ckpt"} <= files
    # the sampler's place after the 4 batches taken (2 labeled each of
    # the 8 labeled slices: the epoch's end), not the prefetch thread's
    full = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                          "model_iter_4.ckpt"))
    data = full["meta"]["data"]
    assert set(data) == {"sampler", "loader", "requests"}
    assert set(data["sampler"]) == {"rng", "primary", "p_pos",
                                    "secondary", "s_pos"}
    assert data["sampler"]["p_pos"] == 8
    assert data["loader"] is None and data["requests"] == [[]] * 4
    ta, tb = (ckpt.state_tree(r["state"]) for r in (straight, resumed))
    assert ta["step"] == tb["step"] == 4
    for group in ("models", "teachers"):
        for n in ta[group]:
            for k, v in ta[group][n].items():
                assert torch.equal(v, tb[group][n][k]), (group, n, k)
    for n, oa in ta["optimizers"].items():
        assert oa["count"] == tb["optimizers"][n]["count"] == 4
        for i, st in oa["state"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, tb["optimizers"][n]["state"]["state"]
                                   [i][k]), (n, k)
    assert torch.equal(ta["generator"], tb["generator"])


def test_fit_host_path_batches_are_jax_pipeline_batches(trees, tmp_path):
    """The batches ``fit`` trains on with ``device_data=False`` are JAX's
    host pipeline's, in order (its ``fit`` streams the same
    ``build_2d_data`` datasets and sampler)."""
    jroot, troot = trees
    seen = []
    _fit(_fit_cfg(troot, tmp_path, val_every=50, ckpt_every=50), 3, seen)
    jcfg = JConfig(root_path=jroot, num_classes=C, batch_size=4,
                   labeled_bs=2, labeled_slices_override=8,
                   patch_size=(32, 32))
    stream = jpipe.DataPipeline(*jbuild(jcfg, False)[:2]).stream()
    try:
        for got in seen:
            want = next(stream)
            np.testing.assert_array_equal(
                got["image"].numpy(), np.moveaxis(want["image"], -1, 1))
            np.testing.assert_array_equal(got["label"].numpy(),
                                          want["label"])
    finally:
        stream.close()


def test_fit_refuses_contrastive_consistency(trees, tmp_path):
    """CTAugment is ported: ``get_method`` builds contrastive_consistency
    and ``fit`` runs one step of it on the host CTA path for both
    ``device_data`` values (``True`` too takes the host path, by JAX's
    rule, ``engine.py:555-557``: no store), writing its files."""
    _, troot = trees
    for device_data in (False, True):
        cfg = _fit_cfg(troot, tmp_path / str(device_data),
                       method="contrastive_consistency", model2="unet",
                       device_data=device_data, val_every=1, ckpt_every=1)

        class Narrow(type(get_method(cfg.method, cfg))):
            def _factory(self, net_type):
                if net_type == "unet":
                    return net_factory(net_type, 1, C, features=FEATURES)
                return super()._factory(net_type)
        engine = TEngine(cfg, method=Narrow(cfg), device="cpu")
        result = fit(cfg, engine=engine, max_steps=1)
        assert result["iterations"] == 1
        assert engine.store is None
        assert set(result["best_dice"]) == {"model1", "model2"}
        with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
            assert "host CTAugment pipeline" in f.read()
        full = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                              "model_iter_1.ckpt"))
        assert {"data", "cta"} <= set(full["meta"])
