"""The port's CTAugment path against the JAX package on the CPU: each of the
16 ops bit for bit on uint8 PIL images (cutout with JAX's global
``np.random`` and the port's generator seeded alike), ``rate_to_p``, the
policies (weak and strong, probe or not) with JAX's global ``random`` and
``np.random`` seeded as the port's ``CTAugment`` generators,
``update_rates``, the state round trip, ``CTATransform``, the
``contrastive_consistency`` hooks (the re-draw when an op repeats 3 times,
the depth schedule, the unfavorable-crop rule, the rate update from the
epoch's mean loss) against JAX's, the policy pipeline's request rule, one
``contrastive_consistency`` step against JAX's step body (UNet + UNet and
UNet + thin SwinUnet, float32, consistency weights 1, every draw
injected through ``test_torch_port_adversarial.py::run_step``) with the
engine's ``param_ema_map``, then ``fit`` on the host CTA path (the same
batches in two runs, a bit-equal resume across a mid-epoch checkpoint)
and the CLI."""
import contextlib
import copy
import io
import os
import random
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cvssl_tpu.data import ctaugment as jcta
from cvssl_tpu.models import projector as jproj
from cvssl_tpu.models import swin_unet as jswin
from cvssl_tpu.models import unet as junet
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.methods.base import get_method as jget_method
from cvssl_tpu_torch.data import ctaugment as tcta
from cvssl_tpu_torch.data import pipeline as tpipe
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models import swin_unet as tswin
from cvssl_tpu_torch.models import unet as tunet
from cvssl_tpu_torch.models.convert import flax_from_state_dict
from cvssl_tpu_torch.ops import schedules as tschedules
from cvssl_tpu_torch.train import cli as tcli
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import cta_iteration, fit
from cvssl_tpu_torch.train.methods import contrastive_consistency as tcc
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx
from cvssl_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
from test_grad_parity import _assert_tree_close  # noqa: E402
from test_torch_port_adversarial import _spy, run_step  # noqa: E402
from test_torch_port_methods import B, C, FEATURES, LB  # noqa: E402
from test_torch_port_vit_methods import VIT  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEED = 20231
HW = 32
OP_NAMES = list(jcta.OPS)
LEVELS = (0.0, 0.13, 0.5, 0.77, 0.999)
HEADS = ("projector1", "projector2", "projector3", "projector4")


@contextlib.contextmanager
def jax_globals(seed):
    """JAX's CTAugment draws from the global ``random`` and ``np.random``:
    seed both, and put them back afterwards."""
    py, npy = random.getstate(), np.random.get_state()
    random.seed(seed)
    np.random.seed(seed)
    try:
        yield
    finally:
        random.setstate(py)
        np.random.set_state(npy)


def _pil(seed=0, shape=(40, 48)):
    """A uint8 'L' image with structure (a ramp and a disc) and noise, so
    the histogram ops and the filters have something to do; not square,
    so the ops' width/height order shows."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w]
    arr = 60 + 80 * xx / w + 40 * ((yy - h / 3) ** 2 + (xx - w / 2) ** 2
                                   < (h / 4) ** 2)
    arr = arr + rng.normal(0, 12, shape)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8), mode="L")


def _args(name, level):
    bins = jcta.OPS[name].bins
    return [level if i == 0 else (level * 7 % 1.0) for i in range(len(bins))]


# ---------------------------------------------------------------------------
# the ops, the policies, the rates
# ---------------------------------------------------------------------------

def test_registry_is_jax_registry():
    assert list(tcta.OPS) == list(jcta.OPS)
    assert len(tcta.OPS) == 16
    assert tcta.NUM_STRONG_OPS == jcta.NUM_STRONG_OPS == 9
    for name, op in jcta.OPS.items():
        assert tcta.OPS[name].bins == op.bins, name


@pytest.mark.parametrize("name", OP_NAMES)
def test_op_is_jax_op_bit_for_bit(name):
    """Each op at five levels (a second magnitude for rescale's method),
    on an image and on a label-like map of small integers; cutout draws
    its location from the generator it is given, JAX's from the global
    ``np.random``: seeded alike, the same square. Cutout runs on square
    images: JAX's, as the reference's, indexes past the edge of a wide one
    (``CTATransform`` hands it the square patch)."""
    for img in (_pil(1), Image.fromarray(
            np.random.default_rng(2).integers(0, 4, (36, 44)).astype(
                np.uint8), mode="L")):
        if name == "cutout":
            side = min(img.size)
            img = img.crop((0, 0, side, side))
        for i, level in enumerate(LEVELS):
            args = _args(name, level)
            if name == "cutout":
                with jax_globals(SEED + i):
                    want = jcta.OPS[name].f(img, *args)
                got = tcta.OPS[name].f(img, *args,
                                       rng=np.random.RandomState(SEED + i))
            else:
                want = jcta.OPS[name].f(img, *args)
                got = tcta.OPS[name].f(img, *args)
            assert got.size == want.size and got.mode == want.mode
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=f"{name} {args}")


def test_rate_to_p_matches_jax():
    jc, tc = jcta.CTAugment(), tcta.CTAugment(seed=SEED)
    rng = np.random.default_rng(3)
    for _ in range(5):
        rate = rng.random(17).astype("f")
        np.testing.assert_array_equal(tc.rate_to_p(rate), jc.rate_to_p(rate))
    p = tc.rate_to_p(np.array([1.0, 0.5, 0.1], "f"))
    assert p[0] > 0 and p[2] == 0


def _learned(cta, seed=4):
    """``cta`` after some rate updates (the same in both packages), so the
    bins' probabilities differ and ``rate_to_p`` zeroes some."""
    rng = np.random.default_rng(seed)
    for _ in range(60):
        k = list(jcta.OPS)[int(rng.integers(0, 16))]
        bins = [float(v) for v in rng.random(len(jcta.OPS[k].bins))]
        cta.update_rates([(k, bins)], float(rng.random()))
    return cta


@pytest.mark.parametrize("probe", [False, True])
@pytest.mark.parametrize("weak", [True, False])
def test_policy_draws_are_jax_draws(probe, weak):
    """With JAX's globals seeded as the port's generators, the same
    policies, bit for bit, at depths 2 to 4, from learned rates."""
    jc, tc = _learned(jcta.CTAugment()), _learned(tcta.CTAugment(seed=SEED))
    want, got = [], []
    with jax_globals(SEED):
        for depth in (2, 3, 4):
            jc.random_depth_weak = jc.random_depth_strong = depth
            want += [jc.policy(probe=probe, weak=weak) for _ in range(4)]
    for depth in (2, 3, 4):
        tc.random_depth_weak = tc.random_depth_strong = depth
        got += [tc.policy(probe=probe, weak=weak) for _ in range(4)]
    assert got == want
    pool = set(list(jcta.OPS)[9:] if weak else list(jcta.OPS)[:9])
    assert all(op.f in pool for pol in got for op in pol)


def test_update_rates_matches_jax():
    jc, tc = _learned(jcta.CTAugment()), _learned(tcta.CTAugment(seed=SEED))
    for k in jcta.OPS:
        for a, b in zip(tc.rates[k], jc.rates[k]):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    before = tc.rates["brightness"][0].copy()
    tc.update_rates([tcta.OP("brightness", [0.5])], proximity=0.0)
    idx = int(0.5 * 17 * 0.999)
    assert tc.rates["brightness"][0][idx] < before[idx]


def test_state_round_trip_restores_rates_depths_and_generators():
    """Through ``torch.save`` and ``torch.load(weights_only=True)`` (the
    checkpoint's meta): the restored instance draws what the original
    draws next."""
    tc = _learned(tcta.CTAugment(seed=SEED))
    tc.random_depth_weak, tc.random_depth_strong = 4, 3
    [tc.policy(False, w) for w in (True, False)]
    buf = io.BytesIO()
    torch.save(tc.state_dict(), buf)
    buf.seek(0)
    other = tcta.CTAugment(seed=0)
    other.load_state_dict(torch.load(buf, weights_only=True))
    assert (other.random_depth_weak, other.random_depth_strong) == (4, 3)
    for k in tcta.OPS:
        for a, b in zip(other.rates[k], tc.rates[k]):
            np.testing.assert_array_equal(a, b)
    assert [other.policy(False, w) for w in (True, False, True)] == \
        [tc.policy(False, w) for w in (True, False, True)]


def test_cta_transform_is_jax_transform():
    """The same sample and policies (rescale, rotate and shear on the
    image AND the label; cutout, equalize and blur on the weak image):
    every output equal to JAX's, cutout drawn from the transform's
    generator seeded as JAX's global ``np.random``."""
    rng = np.random.default_rng(5)
    sample = {"image": rng.random((48, 40)).astype(np.float32),
              "label": rng.integers(0, C, (48, 40)).astype(np.uint8)}
    weak = [jcta.OP("rescale", [0.4, 0.9]), jcta.OP("rotate", [0.8]),
            jcta.OP("shear_y", [0.2])]
    strong = [jcta.OP("cutout", [0.6]), jcta.OP("equalize", [0.7]),
              jcta.OP("blur", [0.5])]
    jt = jcta.CTATransform((HW, HW), jcta.CTAugment())
    tt = tcta.CTATransform((HW, HW), tcta.CTAugment(seed=SEED),
                           rng=np.random.RandomState(SEED))
    for _ in range(3):          # the generator advances alike
        with jax_globals(SEED):
            want = jt(dict(sample), weak, strong)
        got = tt(dict(sample), [tcta.OP(*o) for o in weak],
                 [tcta.OP(*o) for o in strong])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        tt.rng = np.random.RandomState(SEED)
    assert not np.array_equal(got["image_weak"], got["image_strong"])


# ---------------------------------------------------------------------------
# the method's hooks against JAX's
# ---------------------------------------------------------------------------

class _DS:
    ops_weak = None
    ops_strong = None


def _hook_pair(**kw):
    jm = jget_method("contrastive_consistency",
                     JConfig(method="contrastive_consistency", **kw))
    tm = get_method("contrastive_consistency",
                    TConfig(method="contrastive_consistency", seed=SEED,
                            **kw))
    return jm, tm


def test_epoch_start_depths_and_redraws_match_jax(monkeypatch):
    """The depth schedule (weak 3-4 and strong 2-4 up to iteration 10000,
    2-4 each up to 20000, then 2 and 2) and the re-draw when an op repeats
    3 times in a policy: the same depths, policies and number of re-draws
    as JAX's hooks."""
    jm, tm = _hook_pair()
    calls = {"jax": 0, "port": 0}
    for key, m in (("jax", jm), ("port", tm)):
        inner = type(m).refresh_policies

        def counted(self, *a, key=key, inner=inner):
            calls[key] += 1
            return inner(self, *a)
        monkeypatch.setattr(type(m), "refresh_policies", counted)
    jds, tds = _DS(), _DS()
    iters = [0, 136, 9999, 10000, 10001, 15000, 19999, 20000, 25000] * 4
    depths = []
    with jax_globals(SEED):
        for it in iters:
            jm.on_epoch_start(jds, it)
            tm.on_epoch_start(tds, it)
            depths.append((tm.cta.random_depth_weak,
                           tm.cta.random_depth_strong))
            assert depths[-1] == (jm.cta.random_depth_weak,
                                  jm.cta.random_depth_strong)
            assert tds.ops_weak == jds.ops_weak
            assert tds.ops_strong == jds.ops_strong
            for ops in (tds.ops_weak, tds.ops_strong):
                assert max(sum(o.f == k for o in ops) for k, _ in ops) < 3
    assert calls["port"] == calls["jax"] > len(iters)   # some re-draws
    by_it = dict(zip(iters, depths))
    assert by_it[25000] == by_it[20000] == (2, 2)
    early = {d for it, d in zip(iters, depths) if it <= 10000}
    assert all(3 <= w <= 4 and 2 <= s <= 4 for w, s in early)


def test_on_batch_refreshes_after_an_unfavorable_crop():
    """Foreground in the raw labels and under 0.5% of it left in the
    augmented ones: new policies, at the same depths, as JAX's; otherwise
    nothing changes. The batch may be numpy or (pinned) CPU tensors."""
    jm, tm = _hook_pair()
    jds, tds = _DS(), _DS()
    lab = np.zeros((4, HW, HW), np.int32)
    lab[:, 8:20, 8:20] = 1
    aug_kept, aug_lost = lab.copy(), np.zeros_like(lab)
    aug_lost[0, 0, :5] = 2               # 5 of 4096 sites: 0.12%
    with jax_globals(SEED):
        jm.on_epoch_start(jds, 0)
        tm.on_epoch_start(tds, 0)
        before = (list(tds.ops_weak), list(tds.ops_strong))
        for aug, refreshed in ((aug_kept, False), (aug_lost, True)):
            jm.on_batch({"label": lab, "label_aug": aug}, jds)
            tm.on_batch({"label": torch.from_numpy(lab),
                         "label_aug": torch.from_numpy(aug)}, tds)
            assert (tds.ops_weak, tds.ops_strong) == (jds.ops_weak,
                                                      jds.ops_strong)
            assert ((list(tds.ops_weak), list(tds.ops_strong)) != before) \
                is refreshed
        # no foreground in the raw labels: never unfavorable
        tm.on_batch({"label": np.zeros_like(lab), "label_aug": aug_lost},
                    tds)
        assert (tds.ops_weak, tds.ops_strong) == (jds.ops_weak,
                                                  jds.ops_strong)


def test_on_epoch_end_moves_the_rates_by_the_mean_loss():
    """The epoch's losses summed on the device (no host read a step), then
    the rates of the epoch's policies moved toward 1 - 0.5 * mean(0.5 *
    loss), as JAX's from its per-step floats; nothing without a step;
    ``hook_state`` carries the sum, and a method loaded from it ends the
    epoch as the original does."""
    jm, tm = _hook_pair()
    jds, tds = _DS(), _DS()
    with jax_globals(SEED):
        jm.on_epoch_start(jds, 0)
        tm.on_epoch_start(tds, 0)
    tm.on_epoch_end(tds)                  # no step yet: no update
    for k in tcta.OPS:
        assert all((r == 1).all() for r in tm.cta.rates[k])
    losses = np.random.default_rng(6).uniform(0.2, 1.4, 7).astype(np.float32)
    for x in losses[:4]:
        jm.on_step_metrics({"loss": x})
        tm.on_step_metrics({"loss": torch.tensor(x)})
    assert torch.is_tensor(tm._loss_sum)
    other = get_method("contrastive_consistency",
                       TConfig(method="contrastive_consistency"))
    ods = _DS()
    buf = io.BytesIO()
    torch.save(tm.hook_state(tds), buf)
    buf.seek(0)
    other.load_hook_state(torch.load(buf, weights_only=True), ods)
    for x in losses[4:]:
        jm.on_step_metrics({"loss": x})
        for m in (tm, other):
            m.on_step_metrics({"loss": torch.tensor(x)})
    jm.on_epoch_end(jds)
    tm.on_epoch_end(tds)
    other.on_epoch_end(ods)
    moved = 0
    for k in tcta.OPS:
        for a, b, o in zip(tm.cta.rates[k], jm.cta.rates[k],
                           other.cta.rates[k]):
            np.testing.assert_array_equal(o, a)
            np.testing.assert_allclose(a, b, rtol=1e-7)
            moved += int((a != 1).sum())
    assert moved > 0
    assert tm.cta.state_dict()["np_rng"] == other.cta.state_dict()["np_rng"]


# ---------------------------------------------------------------------------
# the policy pipeline's request rule
# ---------------------------------------------------------------------------

class _Recorded:
    """A dataset whose ``load`` records the policies it was given and
    never lets the loader read ``ops_*`` (they raise)."""

    def __init__(self, n=16):
        self.n = n
        self.transform = type("T", (), {"rng": np.random.RandomState(0)})()
        self._ops = ([tcta.OP("identity", [])], [tcta.OP("blur", [0.1])])

    def __len__(self):
        return self.n

    def load(self, i, ops_weak, ops_strong):
        return {"image": np.full((4, 4), i, np.float32),
                "label": np.zeros((4, 4), np.int32),
                "seen": np.float32(ops_strong[0].bins[0]),
                "cut": np.float32(self.transform.rng.randint(0, 100)),
                "idx": i}


def test_policy_pipeline_loads_each_batch_with_its_request_policy():
    """The first ``prefetch`` batches take the policies in force when the
    stream starts; after each batch handed over, a request carries the
    policies in force then, so a change made after batch k reaches batch
    k + prefetch and no earlier one, whatever the threads' timing; the
    consumed state holds the requests in flight, and a stream from it
    gives the batches that came next."""
    ds = _Recorded()
    current = {"level": 0.0}

    def policy():
        return ([tcta.OP("identity", [])],
                [tcta.OP("blur", [current["level"]])])

    def sampler():
        return TwoStreamBatchSampler(range(8), range(8, 16), 4, 2,
                                     np.random.default_rng(7))
    pipe = tpipe.DataPipeline(ds, sampler(), prefetch=3, policy=policy,
                              loader_rng=ds.transform.rng)
    stream = pipe.stream()
    got = []
    for k in range(8):
        got.append(next(stream))
        current["level"] = float(k + 1)     # a refresh after batch k
        pipe.request()
        if k == 3:
            saved = copy.deepcopy(pipe.consumed_state)
    stream.close()
    assert [float(b["seen"][0]) for b in got] == [0, 0, 0, 1, 2, 3, 4, 5]
    assert [p[1][0][1][0] for p in saved["requests"]] == [2.0, 3.0, 4.0]
    other = _Recorded()
    again = tpipe.DataPipeline(other, sampler(), prefetch=3, policy=policy,
                               loader_rng=other.transform.rng)
    resumed = again.stream(saved)
    for k in range(4, 8):
        g = next(resumed)
        for key in got[k]:
            np.testing.assert_array_equal(g[key], got[k][key])
        current["level"] = float(k + 1)
        again.request()
    resumed.close()


class _HookLog:
    """An engine and a method that log ``cta_iteration``'s calls; the
    method's hooks move the strong policy's level: ``on_batch`` to the
    batch's first index on the batches ``crop_at``, ``on_epoch_start`` to
    -it."""

    def __init__(self, crop_at=()):
        self.method, self.log, self.batches = self, [], 0
        self.crop_at, self.level = crop_at, 0.0

    def policy(self):
        return ([tcta.OP("identity", [])], [tcta.OP("blur", [self.level])])

    def on_batch(self, batch, dataset):
        self.log.append("on_batch")
        if self.batches in self.crop_at:
            self.level = float(batch["idx"][0])
        self.batches += 1

    def host_batch(self, batch):
        return batch

    def train_step(self, state, batch):
        self.log.append("step")
        return type("S", (), {"step": state.step + 1})(), {}

    def on_step_metrics(self, metrics):
        self.log.append("on_step_metrics")

    def on_epoch_end(self, dataset):
        self.log.append("on_epoch_end")

    def on_epoch_start(self, dataset, it):
        self.log.append("on_epoch_start")
        self.level = float(-it)


def test_cta_iteration_requests_after_the_hooks():
    """``fit``'s CTA iteration runs ``on_batch``, the step,
    ``on_step_metrics`` and at an epoch's end ``on_epoch_end`` +
    ``on_epoch_start``, then requests the batch ``prefetch`` ahead: a
    refresh in batch k's iteration, by the crop rule or at the epoch's
    end, reaches batch k + prefetch and no earlier one."""
    ds = _Recorded()
    hooks = _HookLog(crop_at=(1,))
    sampler = TwoStreamBatchSampler(range(8), range(8, 16), 4, 2,
                                    np.random.default_rng(7))
    pipe = tpipe.DataPipeline(ds, sampler, prefetch=3, policy=hooks.policy,
                              loader_rng=ds.transform.rng)
    stream = pipe.stream()
    request = pipe.request
    pipe.request = lambda: (hooks.log.append("request"), request())
    state = type("S", (), {"step": 0})()
    got = []
    for k in range(8):
        hooks.log.append(k)
        got.append(next(stream))
        state, _ = cta_iteration(hooks, state, got[-1], pipe, ds,
                                 iters_per_epoch=4)
    stream.close()
    epoch_end = ["on_epoch_end", "on_epoch_start"]
    want = []
    for k in range(8):
        want += [k, "on_batch", "step", "on_step_metrics",
                 *(epoch_end if k % 4 == 3 else []), "request"]
    assert hooks.log == want
    crop = float(got[1]["idx"][0])
    # batch 1's crop refresh reaches batch 4; the epoch refresh after
    # batch 3 (it = 4) reaches batch 6
    assert [float(b["seen"][0]) for b in got] == [0, 0, 0, 0, crop, crop,
                                                  -4, -4]


# ---------------------------------------------------------------------------
# one contrastive_consistency step against JAX's step body
# ---------------------------------------------------------------------------

VARIANTS = {"cnn": {"model1": "unet", "model2": "unet"},
            "vit": {"model1": "unet", "model2": "swin_unet"}}
# the step's parity test runs at step 30000: weight 1 on every term, and
# the projectors' EMA decay 0.99
STEP_KW = dict(consistency1=1.0, consistency2=1.0)
# the segmenters' output layers scaled by 2: the normalised softmax
# passes the 0.8 threshold at some sites and not others. The confidence
# masks decide 2 x 2048 x 4 values and the ensemble argmax 2048 sites:
# the other step tests' 1e-4 cannot hold over that many. The frameworks'
# logits differ by ~1e-6 (relative); every decision is kept 1e-5 clear,
# and the loss terms, equal within rel 1e-5, would show one flipped
# pseudo-label
STEP_SCALE, DECISION_MARGIN = 2.0, 1e-5


def _cc_batch(seed):
    rng = np.random.default_rng(seed)
    label = rng.integers(0, C, (B, HW, HW)).astype(np.int32)
    return {"image": rng.random((B, HW, HW, 1)).astype(np.float32),
            "image_weak": rng.random((B, HW, HW, 1)).astype(np.float32),
            "image_strong": rng.random((B, HW, HW, 1)).astype(np.float32),
            "label_aug": label, "label": label}


def _jax_module(net):
    if net == "unet":
        return junet.UNet(in_chns=1, num_classes=C, features=FEATURES,
                          dropout=(0.0,) * 5)
    if net == "swin_unet":
        return jswin.SwinUnet(num_classes=C, **VIT)
    return jproj.Projector()


def _port_module(net):
    if net == "unet":
        return tunet.UNet(1, C, features=FEATURES, dropout=(0.0,) * 5)
    if net == "swin_unet":
        return tswin.SwinUnet(num_classes=C, img_size=HW, **VIT)
    return net_factory(net, 1, C)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def ccons_step(request):
    """One step at weight 1 (step 30000); the port's forwards, kernel #1's
    calls (``sup_ce_dice``) and the weak softmax maps that the confidence
    masks read are recorded."""
    slots = {**VARIANTS[request.param],
             **{n: "projector" for n in HEADS}}
    cls = type(get_method("contrastive_consistency", TConfig()))
    outs, calls, softs = [], [], []
    normalize = tcc.normalize_softmax
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "forward", _spy(TStepCtx.forward, outs,
                                         lambda self, a: a[0]))
    mp.setattr(cls, "sup_ce_dice", _spy(
        cls.sup_ce_dice, calls,
        lambda self, a: (tuple(a[0].shape), a[0].is_contiguous())))
    mp.setattr(tcc, "normalize_softmax", lambda soft: (
        softs.append(soft.detach().clone()), normalize(soft))[1])
    try:
        r = run_step("contrastive_consistency",
                     {n: _jax_module(t) for n, t in slots.items()},
                     lambda n: _port_module(slots[n]), _cc_batch(15), seed=15,
                     scale=STEP_SCALE, nets=slots, s2d_loss="off",
                     model2=VARIANTS[request.param]["model2"], **STEP_KW)
    finally:
        mp.undo()
    r["outs"], r["sup_calls"], r["slots"], r["softs"] = (outs, calls, slots,
                                                         softs)
    return request.param, r


def test_contrastive_consistency_loss_and_metrics_match_jax(ccons_step):
    _, r = ccons_step
    j, t = r["jmetrics"], r["tmetrics"]
    assert set(j) == set(t), (sorted(j), sorted(t))
    for k in j:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert float(j["consistency_weight1"]) == 1.0
    assert float(j["consistency_weight2"]) == 1.0
    for k in ("contrast_l", "contrast_u", "unsup_loss"):
        assert float(t[k]) > 0, k


def test_contrastive_consistency_gradients_match_jax(ccons_step):
    """The two segmenters' gradients against JAX's; the heads get none
    (they are in no optimizer; JAX's are zeroed by its optimizer)."""
    _, r = ccons_step
    (want,) = r["jgrads"]
    for n in ("model1", "model2"):
        model = r["tstate"].models[n]
        grads = {k: p.grad for k, p in model.named_parameters()}
        grads.update({k: torch.zeros_like(b)
                      for k, b in model.named_buffers()})
        _assert_tree_close(flax_from_state_dict(r["slots"][n], grads)[0],
                           want[n])
    for n in HEADS:
        assert all(p.grad is None for p in
                   r["tstate"].models[n].parameters())


def test_contrastive_consistency_updates_and_param_ema_match_jax(ccons_step):
    """After the step: each segmenter after SGD within 2e-2 of the largest
    delta plus float32 rounding; projector3/4's weights unchanged (JAX: a
    zero optimizer); projector1/2's weights the EMA of projector3/4 at
    decay 0.99, as JAX's (rel 1e-6); every head's BatchNorm running
    statistics moved by its own forwards only, as JAX's ``batch_stats``
    (rel 1e-4, abs 1e-5): projector1's are not projector3's."""
    _, r = ccons_step
    js, ts = r["jstate"], r["tstate"]
    leaves = jax.tree_util.tree_leaves
    for n in ("model1", "model2"):
        net = r["slots"][n]
        got_p = flax_from_state_dict(net, {k: v.detach() for k, v in
                                           ts.models[n].state_dict().items()
                                           })[0]
        scale = max(float(np.abs(np.asarray(a) - b).max()) for a, b in
                    zip(leaves(js.params[n]), leaves(r["p0"][n])))
        assert scale > 0.0
        for a, b in zip(leaves(js.params[n]), leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)
    stats = {}
    for n in HEADS:
        got_p, got_s = flax_from_state_dict("projector",
                                            ts.models[n].state_dict())
        stats[n] = got_s
        if n in ("projector3", "projector4"):
            for a, b in zip(leaves(r["p0"][n]), leaves(got_p)):
                np.testing.assert_array_equal(b, a)
            for a, b in zip(leaves(js.params[n]), leaves(r["p0"][n])):
                np.testing.assert_array_equal(np.asarray(a), b)
        else:
            src = {"projector1": "projector3", "projector2": "projector4"}[n]
            moved = False
            for a, b, p0, s0 in zip(leaves(js.params[n]), leaves(got_p),
                                    leaves(r["p0"][n]),
                                    leaves(r["p0"][src])):
                want = 0.99 * p0.astype(np.float64) + 0.01 * s0
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                           atol=1e-7)
                np.testing.assert_allclose(b, want, rtol=1e-6, atol=1e-7)
                moved |= not np.array_equal(b, p0)
            assert moved, n
        for a, b in zip(leaves(js.batch_stats[n]), leaves(got_s)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                       atol=1e-5)
    for a, b in zip(leaves(stats["projector1"]), leaves(stats["projector3"])):
        assert not np.array_equal(a, b)
    assert {n: o.count for n, o in ts.optimizers.items()} == {"model1": 1,
                                                              "model2": 1}
    assert all(type(o) is tschedules.ReferenceSGD
               for o in ts.optimizers.values())


def test_contrastive_consistency_forwards_decisions_and_kernel_calls(
        ccons_step):
    """The forwards in JAX's order (each model on the weak then the strong
    view, then the heads: the labeled pair, then the two cross pairs); the
    SwinUnet's stochastic-depth masks the only draws; no unlabeled
    confidence value within DECISION_MARGIN of the threshold and every
    kept ensemble argmax at least DECISION_MARGIN from a tie, so no
    decision can flip between the frameworks;
    kernel #1 once for each segmenter's labeled weak logits, which are
    contiguous."""
    name, r = ccons_step
    assert [slot for slot, _ in r["outs"]] == [
        "model1", "model1", "model2", "model2", "projector3", "projector4",
        "projector1", "projector4", "projector2", "projector3"]
    kinds = {k for k, _ in r["draws"].log}
    assert kinds == (set() if name == "cnn" else {"keep"})
    thresh = TConfig().conf_thresh
    # the pseudo-labels read the unlabeled sites only
    norms = [tcc.normalize_softmax(s)[LB:] for s in r["softs"]]
    assert len(norms) == 2
    for norm in norms:
        assert float((norm - thresh).abs().min()) > DECISION_MARGIN
        mask = norm > thresh
        assert bool(mask.any()) and not bool(mask.all())
    masked = sum(n * (n > thresh) for n in norms) / 2.0
    top2 = masked.topk(2, dim=1).values
    kept = top2[:, 0] > 0
    assert bool(kept.any())
    assert float((top2[:, 0] - top2[:, 1])[kept].min()) > DECISION_MARGIN
    heads = dict(r["outs"][4:])
    assert heads["projector1"].shape == (B - LB, 16, HW // 4, HW // 4)
    assert [k for k, _ in r["sup_calls"]] == [((LB, C, HW, HW), True)] * 2


class _NarrowCC(type(get_method("contrastive_consistency", TConfig()))):
    def _factory(self, net_type):
        if net_type == "unet":
            return net_factory(net_type, 1, C, features=FEATURES)
        return super()._factory(net_type)


def test_param_ema_map_follows_the_decay_schedule():
    """From the same initial weights: after a step at step 0 (decay 0)
    projector1/2 equal projector3/4; after a step at step 1 (decay 0.5)
    they are halfway; their BatchNorm running statistics are their own
    forwards', never copied."""
    cfg = TConfig(method="contrastive_consistency", model2="unet",
                  num_classes=C, batch_size=B, labeled_bs=LB,
                  patch_size=(HW, HW), labeled_slices_override=LB,
                  dtype="float32")
    batch = {k: torch.from_numpy(np.moveaxis(v, -1, 1).copy()
                                 if v.ndim == 4 else v)
             for k, v in _cc_batch(9).items()}
    for step, decay in ((0, 0.0), (1, 0.5)):
        engine = TEngine(cfg, method=_NarrowCC(cfg), device="cpu")
        state = engine.init_state()
        p0 = {n: [p.detach().clone() for p in state.models[n].parameters()]
              for n in HEADS}
        state.step = step
        engine.train_step(state, batch)
        for dst, src in (("projector1", "projector3"),
                         ("projector2", "projector4")):
            got = list(state.models[dst].parameters())
            for g, a, b in zip(got, p0[dst], p0[src]):
                if step == 0:
                    assert torch.equal(g, b)
                else:
                    torch.testing.assert_close(g, decay * a +
                                               (1 - decay) * b)
            bd = dict(state.models[dst].named_buffers())
            bs = dict(state.models[src].named_buffers())
            assert not torch.equal(bd["conv_1.bn.running_mean"],
                                   bs["conv_1.bn.running_mean"])
            assert bd["conv_1.bn.running_mean"].any()
        for n in ("projector3", "projector4"):
            for g, a in zip(state.models[n].parameters(), p0[n]):
                assert torch.equal(g, a)


def test_method_slots_config_and_hooks():
    m = get_method("contrastive_consistency",
                   TConfig(method="contrastive_consistency", seed=3))
    assert m.transform == "cta"
    assert m.eval_model_names() == ("model1", "model2")
    assert m.net_types() == {"model1": "unet", "model2": "swin_unet",
                             **{n: "projector" for n in HEADS}}
    assert m.param_ema_map == {"projector1": "projector3",
                               "projector2": "projector4"}
    transform, weak, strong = m.create_transform(
        TConfig(method="contrastive_consistency", seed=3,
                patch_size=(HW, HW)))
    assert isinstance(transform, tcta.CTATransform)
    assert transform.cta is m.cta
    with jax_globals(3):
        jm = jget_method("contrastive_consistency",
                         JConfig(method="contrastive_consistency"))
        _, jweak, jstrong = jm.create_transform(JConfig(), None)
    assert (weak, strong) == (jweak, jstrong)


# ---------------------------------------------------------------------------
# fit on the host CTA path, and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic ACDC tree at 32^2: 32 train slices (8 labeled), 2 val
    volumes; batch 4 = 2 + 2 makes an epoch of 4 iterations."""
    return tsyn.make_synthetic_acdc(
        str(tmp_path_factory.mktemp("acdc") / "ACDC"), size=HW)


def _cfg(root, out, **kw):
    base = dict(root_path=root, exp="ACDC/ccons",
                method="contrastive_consistency", model="unet",
                model2="unet", num_classes=C, batch_size=4, labeled_bs=2,
                labeled_slices_override=8, patch_size=(HW, HW),
                dtype="float32", max_iterations=100, val_every=3,
                ckpt_every=3, log_every=1, snapshot_root=str(out),
                device_data=False)
    return TConfig(**{**base, **kw})


def _fit(cfg, steps, batches):
    engine = TEngine(cfg, method=_NarrowCC(cfg), device="cpu")
    step = engine.train_step

    def spy(state, batch):
        batches.append({k: v.clone() for k, v in batch.items()})
        return step(state, batch)
    engine.train_step = spy
    return engine, fit(cfg, engine=engine, max_steps=steps)


def test_fit_cta_batches_repeat_and_resume_bit_equal(tree, tmp_path):
    """Two runs of 6 iterations with one seed train on the same batches
    (an epoch ends at 4: rate update, new policies); stopped at 3 (mid
    epoch, a checkpoint) and resumed to 6, the run sees those batches and
    ends where one run does, bit for bit: models, heads, optimizers, the
    step's generator, the CTAugment rates, generators and policies."""
    seen = {k: [] for k in ("a", "b", "c")}
    ea, ra = _fit(_cfg(tree, tmp_path / "a"), 6, seen["a"])
    _, rb = _fit(_cfg(tree, tmp_path / "b"), 6, seen["b"])
    cfg = _cfg(tree, tmp_path / "c")
    _fit(cfg, 3, seen["c"])
    ec, rc = _fit(cfg, 6, seen["c"])
    assert ea.store is None and ec.store is None
    for other in ("b", "c"):
        assert len(seen[other]) == 6
        for x, y in zip(seen["a"], seen[other]):
            assert set(x) == {"image", "image_weak", "image_strong",
                              "label", "label_aug", "idx"}
            for k in x:
                assert torch.equal(x[k], y[k]), (other, k)
    assert not torch.equal(seen["a"][0]["image_weak"],
                           seen["a"][0]["image_strong"])
    with open(os.path.join(cfg.snapshot_path(), "log.txt")) as f:
        log = f.read()
    assert "resumed from iteration 3" in log
    assert "host CTAugment pipeline" in log
    for r in (rb, rc):
        ta, tb = (ckpt.state_tree(x["state"]) for x in (ra, r))
        for group in ("models", "teachers"):
            for n in ta[group]:
                for k, v in ta[group][n].items():
                    assert torch.equal(v, tb[group][n][k]), (group, n, k)
        for n, oa in ta["optimizers"].items():
            assert oa["count"] == tb["optimizers"][n]["count"] == 6
        assert torch.equal(ta["generator"], tb["generator"])
    ma, mc = ea.method, ec.method
    assert ma.cta.state_dict() == mc.cta.state_dict()
    assert (ma._loss_count, float(ma._loss_sum)) == (mc._loss_count,
                                                     float(mc._loss_sum))
    moved = sum(int((r != 1).sum()) for rates in ma.cta.rates.values()
                for r in rates)
    assert moved > 0
    full = ckpt.load_weights(os.path.join(cfg.snapshot_path(),
                                          "model_iter_3.ckpt"))
    meta = full["meta"]
    assert set(meta["data"]) == {"sampler", "loader", "requests"}
    assert len(meta["data"]["requests"]) == 4
    assert set(meta["cta"]) == {"cta", "ops_weak", "ops_strong", "loss_sum",
                                "loss_count"}
    assert meta["cta"]["loss_count"] == 3
    files = set(os.listdir(cfg.snapshot_path()))
    assert {"model1_iter_6.ckpt", "model2_iter_6.ckpt",
            "model_iter_6.ckpt"} <= files
    assert not any("ema" in f or "projector" in f for f in files), files
    assert set(full["state"]["optimizers"]) == {"model1", "model2"}
    assert set(full["state"]["models"]) == {"model1", "model2", *HEADS}


def test_fit_cta_raises_on_a_method_without_the_hooks(tree, tmp_path):
    class NoHooks(type(get_method("mean_teacher", TConfig()))):
        transform = "cta"
    cfg = _cfg(tree, tmp_path, method="mean_teacher")
    engine = TEngine(cfg, method=NoHooks(cfg), device="cpu")
    with pytest.raises(NotImplementedError, match="hooks"):
        fit(cfg, engine=engine, max_steps=1)
    assert not os.path.exists(cfg.snapshot_path())


def test_cli_trains_contrastive_consistency_on_the_cpu(tree, tmp_path):
    """Full-width UNets and the four heads through the CLI (the
    reference's dual SwinUnet-tiny needs 224^2: the card's run)."""
    result = tcli.main(["--root_path", tree, "--exp", "cli",
                        "--method", "contrastive_consistency",
                        "--model2", "unet", "--max_iterations", "2",
                        "--batch_size", "4", "--labeled_bs", "2",
                        "--labeled_slices", "8", "--patch_size", str(HW),
                        str(HW), "--val_every", "2", "--ckpt_every", "2",
                        "--device", "cpu", "--dtype", "float32",
                        "--snapshot_root", str(tmp_path)])
    assert result["iterations"] == 2
    assert set(result["best_dice"]) == {"model1", "model2"}
    files = set(os.listdir(os.path.join(tmp_path, "cli_7_labeled", "unet")))
    assert {"model1_iter_2.ckpt", "model2_iter_2.ckpt",
            "model_iter_2.ckpt"} <= files
