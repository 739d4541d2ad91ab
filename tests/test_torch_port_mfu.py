"""The port's FLOP count and MFU against the JAX package's on the CPU:
``count_flops`` against XLA's ``program_flops`` (exactly on a matmul and a
VALID convolution; within the padded taps' excess on the narrow UNet),
``peak_flops``' table lookup, ``mfu``, ``per_step_flops`` on a train step
from the store (which the count must leave bit-equal), and
``SlidingWindowEvaluator.last_flops``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu.utils.mfu import program_flops
from cvssl_tpu_torch.data.device_store import DeviceSliceStore
from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
from cvssl_tpu_torch.eval.val3d import SlidingWindowEvaluator
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.models.unet import UNet as TUNet
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods.mean_teacher import MeanTeacher
from cvssl_tpu_torch.utils import mfu as M

C = 4
FEATURES = (4, 8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the count against XLA's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (7, 9, 5)])
def test_matmul_count_equals_xla(m, k, n):
    want = program_flops(jax.jit(jnp.matmul), jnp.zeros((m, k)),
                         jnp.zeros((k, n)))
    got = M.count_flops(torch.matmul, torch.zeros(m, k), torch.zeros(k, n))
    assert got == want == 2 * m * k * n


@pytest.mark.parametrize("b,h,w,ci,co", [(2, 32, 32, 8, 16),
                                         (1, 17, 23, 3, 5)])
def test_valid_conv_count_equals_xla(b, h, w, ci, co):
    def jconv(x, k):
        return jax.lax.conv_general_dilated(
            x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    want = program_flops(jax.jit(jconv), jnp.zeros((b, h, w, ci)),
                         jnp.zeros((3, 3, ci, co)))
    got = M.count_flops(F.conv2d, torch.zeros(b, ci, h, w),
                        torch.zeros(co, ci, 3, 3))
    assert got == want == 2 * b * (h - 2) * (w - 2) * co * ci * 9


def test_nothing_counted_is_none():
    assert M.count_flops(torch.relu, torch.zeros(4)) is None


# The ratio port / XLA on the narrow UNet at side 32, measured here (both
# counts exact integers): forward 1.0989, forward + backward 1.0499. The
# port counts more because XLA counts only the taps of a padded 3 x 3
# convolution that fall inside the input ((3H / (3H - 2))^2 fewer at side
# H, most at the deepest, narrowest levels), less because XLA also counts
# the elementwise work (norms, activations) that FlopCounterMode skips.
# Bound: [1, (H / (H - 2))^2] = [1, 1.1378] at H = 32.
UNET_SIDE = 32


@pytest.mark.parametrize("part", ["forward", "forward_backward"])
def test_unet_count_within_the_padded_taps_of_xla(part):
    jm = JUNet(in_chns=1, num_classes=C, features=FEATURES,
               dropout=(0.0,) * 5)
    x = np.random.default_rng(0).normal(
        size=(2, UNET_SIDE, UNET_SIDE, 1)).astype(np.float32)
    v = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x))
    tm = TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5).eval()
    tm.load_state_dict(state_dict_from_flax(
        "unet", jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])))
    tx = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    if part == "forward":
        want = program_flops(jax.jit(lambda v, x: jm.apply(v, x)), v,
                             jnp.asarray(x))
        with torch.no_grad():
            got = M.count_flops(tm, tx)
    else:
        def jloss(p, x):
            out = jm.apply({**v, "params": p}, x)
            return jnp.mean(out.astype(jnp.float32) ** 2)
        want = program_flops(jax.jit(jax.grad(jloss)), v["params"],
                             jnp.asarray(x))

        def tstep():
            torch.mean(tm(tx) ** 2).backward()
        got = M.count_flops(tstep)
    ratio = got / want
    assert 1.0 <= ratio <= (UNET_SIDE / (UNET_SIDE - 2)) ** 2, ratio


# ---------------------------------------------------------------------------
# the peak and the MFU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12), ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA H100 NVL", 835e12), ("NVIDIA A100-SXM4-80GB", None)])
def test_peak_takes_the_longest_match(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert M.peak_flops("cuda:0") == peak
    flops, seconds = 5.0e11, 0.04
    got = M.mfu(flops, seconds, "cuda:0")
    assert got == (None if peak is None else flops / seconds / peak)


def test_no_peak_on_the_cpu():
    assert M.peak_flops("cpu") is None
    assert M.peak_flops() is None           # no card on this machine
    assert M.mfu(1e9, 0.001, "cpu") is None
    assert M.mfu(None, 0.001, "cuda:0") is None
    assert M.mfu(1e9, 0.0, "cuda:0") is None


class _NarrowMT(MeanTeacher):
    def build_models(self):
        return {"model": TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5)}


class _Slices:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, (28, 32)).astype(np.float32),
                "label": r.integers(0, C, (28, 32)).astype(np.uint8)}


def _store_step():
    """A narrow mean-teacher engine on a CPU store, its state and the
    batch indices of its first step."""
    cfg = TConfig(num_classes=C, batch_size=4, labeled_bs=2,
                  patch_size=(32, 32), dtype="float32", max_iterations=100)
    eng = TEngine(cfg, method=_NarrowMT(cfg), device="cpu")
    eng.attach_store(DeviceSliceStore(_Slices(), (32, 32), device="cpu"))
    stream = TwoStreamBatchSampler(range(4), range(4, 12), 4, 2,
                                   rng=np.random.default_rng(0)).epochs()
    state = eng.init_state(seed=0)
    state.step = 3000       # the consistency term, and its noise, live
    return eng, state, [next(stream)]


def test_counted_step_equals_the_plain_step():
    """The count runs the step as it is: the store's gather and the
    generators' draws give the same losses and weights, bit for bit."""
    eng_a, state_a, idx = _store_step()
    eng_b, state_b, _ = _store_step()
    box = {}

    def step():
        box["out"] = eng_a.train_steps(state_a, idx)
    flops = M.per_step_flops(step)
    state_a, metrics_a = box["out"]
    state_b, metrics_b = eng_b.train_steps(state_b, idx)
    assert flops is not None and flops > 0
    assert float(metrics_a["consistency_loss"]) > 0.0
    for k in metrics_b:
        assert torch.equal(torch.as_tensor(metrics_a[k]),
                           torch.as_tensor(metrics_b[k])), k
    for slot in ("models", "teachers"):
        a = getattr(state_a, slot)["model"].state_dict()
        b = getattr(state_b, slot)["model"].state_dict()
        for k, v in a.items():
            assert torch.equal(v, b[k]), (slot, k)


# ---------------------------------------------------------------------------
# SlidingWindowEvaluator.last_flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patch_batch", [9, 6])
def test_last_flops_counts_every_window_batch(patch_batch):
    """27 windows of 8^3 over a 20^3 volume: 3 full batches of 9, or 4 of
    6 and one of 3."""
    torch.manual_seed(0)
    net = torch.nn.Conv3d(1, 2, 3, padding=1)

    def predict(x):
        return torch.softmax(net(x), dim=1)
    ev = SlidingWindowEvaluator(predict, (8, 8, 8), 2, stride_xy=6,
                                stride_z=6, patch_batch=patch_batch,
                                device="cpu")
    assert ev.last_flops() is None
    ev.predict_volume(np.zeros((20, 20, 20), np.float32))

    def per_batch(b):
        with torch.no_grad():
            return M.count_flops(predict, torch.zeros(b, 1, 8, 8, 8))
    full, rest = divmod(27, patch_batch)
    want = full * per_batch(patch_batch) + (per_batch(rest) if rest else 0)
    assert ev.last_flops() == want == 27 * per_batch(1)
