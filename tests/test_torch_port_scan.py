"""K steps a call on the CPU: ``Engine.train_steps_fixed`` against JAX's
across mean_teacher's step-1000 branch (float32, narrow UNet, dropout
zeroed, the teacher noise injected as ``test_torch_port_step.py`` injects
it); the step table of every store-path method against the floats the
port computed on the host before the table existed; and
``train_steps_scan`` against the same rows through
``train_step_indices``, both as the CPU's eager loop and through the
graph runner with a stand-in for the card's capture (a replay reruns the
step body on the static inputs and moves no host state, as a CUDA graph's
does)."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.data.device_store import DeviceSliceStore
from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.models.convert import state_dict_from_flax
from cvssl_tpu_torch.models.unet import UNet as TUNet
from cvssl_tpu_torch.ops import ramps
from cvssl_tpu_torch.ops.ema import ema_decay_schedule
from cvssl_tpu_torch.parallel.mesh import Mesh
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.methods.base import available_methods, get_method
from cvssl_tpu_torch.train.state import StepCtx as TStepCtx
from cvssl_tpu_torch.utils import checkpoint as ckpt

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_step import _tree  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch on one intra-op thread: parallel pytest workers share the
    cores, and oversubscribed OpenMP pools run these tests many times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, LB, HW, C = 4, 2, 32, 4
FEATURES = (4, 8, 16, 32, 64)
K, START = 4, 998          # rows 998, 999 before the branch, 1000, 1001 after
CFG = dict(model="unet", num_classes=C, batch_size=B, labeled_bs=LB,
           patch_size=(HW, HW), labeled_slices_override=LB, dtype="float32",
           s2d_levels=0, num_devices=1)
CNN_KW = {"cross_teaching": {"model2": "unet"},
          "cnn_meet_vit": {"model2": "unet"},
          "tripleview": {"model2": "unet"},
          "contrastive_cross": {"model2": "unet"}}
STORE_METHODS = [m for m in available_methods()
                 if get_method(m, TConfig(method=m, **CFG)).transform != "cta"]
TABLE_STEPS = (0, 149, 150, 999, 1000)


def test_the_store_path_methods():
    assert len(STORE_METHODS) == 16
    assert "contrastive_consistency" not in STORE_METHODS


# ---------------------------------------------------------------------------
# train_steps_fixed against JAX's, across step 1000
# ---------------------------------------------------------------------------

class _Preset:
    """A Flax module whose ``init`` returns the given variables: JAX's
    engine starts from them without compiling the UNet's init."""

    def __init__(self, module, variables):
        self.module, self.variables = module, variables

    def init(self, rngs, *args, **kwargs):
        return self.variables

    def apply(self, *args, **kwargs):
        return self.module.apply(*args, **kwargs)


@pytest.fixture(scope="module")
def jax_unet():
    """The narrow JAX UNet (dropout zeroed) and its variables from the
    shapes of its init, filled from a seed: kernels at 1/sqrt(fan-in),
    biases and means N(0, 0.1), scales U(0.8, 1.2), variances
    U(0.5, 1.5)."""
    jm = JUNet(in_chns=1, num_classes=C, features=FEATURES,
               dropout=(0.0,) * 5)
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((B, HW, HW, 1)))
    rng = np.random.default_rng(3)

    def fill(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        fan = max(int(np.prod(a.shape[:-1])), 1)
        return (rng.normal(0, 1, a.shape) / np.sqrt(fan)).astype(np.float32)
    return jm, jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=["supervised", "mean_teacher"])
def fixed_pair(request, jax_unet):
    method = request.param
    rng = np.random.default_rng(0)
    image = rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32)
    label = rng.integers(0, C, (B, HW, HW)).astype(np.int32)
    noise = np.clip(0.1 * rng.normal(size=(B - LB, HW, HW, 1)),
                    -0.2, 0.2).astype(np.float32)
    cfg = dict(CFG, method=method)

    jcfg = JConfig(**cfg)
    jeng = JEngine(jcfg)
    jeng.modules = {"model": _Preset(*jax_unet)}
    state = jeng.init_state(jax.random.PRNGKey(0),
                            {"image": image, "label": label})
    state = state.replace(step=jnp.int32(START))
    p0 = jax.tree_util.tree_map(np.asarray, state.params["model"])
    bs0 = jax.tree_util.tree_map(np.asarray, state.batch_stats["model"])
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "normal",
               lambda key, shape, dtype=None: jnp.asarray(noise))
    try:
        jstate, jmetrics = jeng.train_steps_fixed(
            state, {"image": image, "label": label}, K)
    finally:
        mp.undo()

    tcfg = TConfig(**cfg)

    class Narrow(type(get_method(method, tcfg))):
        def build_models(self):
            return {"model": TUNet(1, C, features=FEATURES,
                                   dropout=(0.0,) * 5)}
    teng = TEngine(tcfg, method=Narrow(tcfg), device="cpu")
    tstate = teng.init_state()
    sd = state_dict_from_flax("unet", p0, bs0)
    tstate.models["model"].load_state_dict(sd)
    for teacher in tstate.teachers.values():
        teacher.load_state_dict(sd)
    tstate.step = START
    mp = pytest.MonkeyPatch()
    mp.setattr(TStepCtx, "normal", lambda self, shape, device:
               torch.from_numpy(np.moveaxis(noise, -1, 1).copy()))
    try:
        tstate, tmetrics = teng.train_steps_fixed(tstate, {
            "image": np.moveaxis(image, -1, 1).copy(), "label": label}, K)
    finally:
        mp.undo()
    return dict(method=method, p0=p0, jstate=jstate, jmetrics=jmetrics,
                tstate=tstate, tmetrics=tmetrics)


def test_fixed_steps_loss_matches_jax(fixed_pair):
    j, t = fixed_pair["jmetrics"], fixed_pair["tmetrics"]
    keys = ["loss", "loss_ce", "loss_dice"]
    if fixed_pair["method"] == "mean_teacher":
        keys.append("consistency_loss")
        # the last step is past the branch: the term is live
        assert float(j["consistency_loss"]) > 0.0
        assert float(t["consistency_weight"]) == float(
            j["consistency_weight"])
    for k in keys:
        assert float(t[k]) == pytest.approx(float(j[k]), rel=1e-5), k
    assert fixed_pair["tstate"].step == START + K
    assert fixed_pair["tstate"].optimizers["model"].count == K


def test_fixed_steps_parameters_and_teacher_match_jax(fixed_pair):
    """Parameters after K updates (and the EMA teacher): each element
    within 2e-2 of the largest move from the initial weights plus float32
    rounding, ``test_torch_port_step.py``'s tolerance of one step."""
    p0, js, ts = (fixed_pair[k] for k in ("p0", "jstate", "tstate"))
    pairs = [(js.params["model"], ts.models["model"])]
    if fixed_pair["method"] == "mean_teacher":
        pairs.append((js.teacher_params["model"], ts.teachers["model"]))
    for want, got in pairs:
        got_p = _tree({k: v.detach() for k, v in got.state_dict().items()})[0]
        scale = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                    for a, b in zip(jax.tree_util.tree_leaves(want),
                                    jax.tree_util.tree_leaves(p0)))
        assert scale > 0.0
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_p)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                       atol=2e-2 * scale)


def test_fixed_steps_batchnorm_buffers_match_jax(fixed_pair):
    js, ts = fixed_pair["jstate"], fixed_pair["tstate"]
    pairs = [(js.batch_stats["model"], ts.models["model"])]
    if fixed_pair["method"] == "mean_teacher":
        pairs.append((js.teacher_batch_stats["model"], ts.teachers["model"]))
    for want, got in pairs:
        got_bs = _tree({k: v.detach() for k, v in got.state_dict().items()})[1]
        for a, b in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got_bs)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the step table: the host's floats, bit for bit
# ---------------------------------------------------------------------------

def _host_floats(method, cfg, step, lrs):
    """What the port's step read on the host before the table: the ramps
    in the methods' own expressions, the EMA decay, each optimizer's rate."""
    def sigmoid_w(s):
        return ramps.consistency_weight(s, cfg.consistency,
                                        cfg.consistency_rampup)
    if method == "cnn_meet_vit":
        w = float(np.float32(cfg.consistency) * np.float32(
            ramps.linear_rampup(step // 150, cfg.consistency_rampup)))
    elif method == "contrastive_cross":
        epoch = step // max(cfg.labeled_slices // cfg.labeled_bs, 1)
        w = float(np.float32(cfg.consistency) * np.float32(
            ramps.ramp_up_function(epoch, int(cfg.consistency_rampup))))
    else:
        w = sigmoid_w(step)
    out = {"consistency_weight": w,
           "ema_decay": ema_decay_schedule(step, cfg.ema_decay)}
    if method == "uamt":
        ramp = np.float32(ramps.sigmoid_rampup(step, cfg.max_iterations))
        out["threshold"] = float((np.float32(0.75) + np.float32(0.25) * ramp)
                                 * np.float32(np.log(2.0)))
    out.update({f"lr_{n}": f(step) for n, f in lrs.items()})
    return out


@pytest.mark.parametrize("method", STORE_METHODS)
def test_step_table_is_the_host_floats(method):
    cfg = TConfig(method=method, max_iterations=30000,
                  **{**CFG, "labeled_slices_override": 136})
    engine = TEngine(cfg, method=_narrow(cfg), device="cpu")
    state = engine.init_state()
    lrs = {n: o.schedule for n, o in state.optimizers.items()
           if hasattr(o, "schedule")}
    for step in TABLE_STEPS + (cfg.max_iterations // 2,
                               cfg.max_iterations - 1):
        state.step = step
        for o in state.optimizers.values():
            o.count = step
        names, table = engine.step_table(state, 1)
        want = _host_floats(method, cfg, step, lrs)
        assert set(names) == set(want), (names, want)
        assert table.dtype == np.float32
        for n, v in zip(names, table[0]):
            assert np.float32(want[n]).tobytes() == v.tobytes(), (step, n)
    # consecutive rows are the host floats of consecutive steps and counts
    state.step = 148
    for o in state.optimizers.values():
        o.count = 148
    names, table = engine.step_table(state, 3)
    for r in range(3):
        want = _host_floats(method, cfg, 148 + r, lrs)
        assert [np.float32(want[n]) for n in names] == list(table[r])


def test_graph_keys_split_at_the_branch():
    for method in ("mean_teacher", "cnn_meet_vit"):
        m = get_method(method, TConfig(method=method, **CFG))
        assert m.graph_key(999) != m.graph_key(1000)
        assert m.graph_key(0) == m.graph_key(999)
        assert m.graph_key(1000) == m.graph_key(29999)
    m = get_method("uamt", TConfig(method="uamt", **CFG))
    assert m.graph_key(0) == m.graph_key(1000) == ()


# ---------------------------------------------------------------------------
# train_steps_scan: the eager loop, and the graph runner
# ---------------------------------------------------------------------------

def _narrow(cfg):
    """``cfg.method`` on narrow models (the UNet family at FEATURES; the
    discriminator and the contrastive heads as built)."""
    class Narrow(type(get_method(cfg.method, cfg))):
        def _factory(self, net_type):
            kw = self.cfg.model_kwargs(net_type)
            if net_type in ("unet", "unet_cct", "unet_urpc"):
                kw["features"] = FEATURES
            return net_factory(net_type, 1, C, **kw)
    return Narrow(cfg)


class _Slices:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, (28, HW)).astype(np.float32),
                "label": r.integers(0, C, (28, HW)).astype(np.uint8)}


class _Replay:
    """A stand-in for a captured CUDA graph on the CPU: ``replay`` runs the
    step body on the static inputs, puts the host counters back (a graph's
    replay moves no host state; the engine advances them) and writes the
    outputs into the static ones, which the runner reads."""

    def __init__(self, state, run, static):
        self.state, self.run, self.static = state, run, static

    def replay(self):
        s = self.state
        counters = (s.step, {n: o.count for n, o in s.optimizers.items()})
        out = self.run()
        s.step = counters[0]
        for n, o in s.optimizers.items():
            o.count = counters[1][n]
        for k, v in out.items():
            if torch.is_tensor(v):
                self.static[k].copy_(v)


def _graph_runner(engine):
    """Send the engine's K-step calls through its graph runner on the CPU,
    with :class:`_Replay` for the capture; returns the list of captures."""
    captures = []

    def capture(state, run):
        metrics = run()                      # the warm-up: a real step
        static = {k: v.clone() for k, v in metrics.items()}
        captures.append(state.step)
        return metrics, _Replay(state, run, static), static
    engine.graphed = True
    engine._capture_step = capture
    return captures


def _engine(method, graphed=False):
    cfg = TConfig(method=method, **{**CFG, **CNN_KW.get(method, {})})
    engine = TEngine(cfg, method=_narrow(cfg), device="cpu")
    mode = engine.method.transform
    engine.attach_store(DeviceSliceStore(_Slices(), (HW, HW), device="cpu",
                                         mode=mode))
    captures = _graph_runner(engine) if graphed else None
    state = engine.init_state()
    state.step = START
    return engine, state, captures


def _rows(n):
    it = TwoStreamBatchSampler(range(LB * 2), range(LB * 2, 12), B, B - LB,
                               rng=np.random.default_rng(0)).epochs()
    return [next(it) for _ in range(n)]


def _assert_states_equal(a, b):
    ta, tb = ckpt.state_tree(a), ckpt.state_tree(b)
    assert ta["step"] == tb["step"]
    assert torch.equal(ta["generator"], tb["generator"])
    for group in ("models", "teachers"):
        for n in ta[group]:
            for k, v in ta[group][n].items():
                assert torch.equal(v, tb[group][n][k]), (group, n, k)
    for n, oa in ta["optimizers"].items():
        ob = tb["optimizers"][n]
        assert oa["count"] == ob["count"]
        for i, st in oa["state"]["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    assert torch.equal(v, ob["state"]["state"][i][k]), (n, k)


def _assert_metrics_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


@pytest.mark.parametrize("method", STORE_METHODS)
def test_train_steps_scan_equals_train_step_indices(method):
    """Rows 998-1001 as single steps, as one ``train_steps_scan`` call (the
    CPU's eager loop), and through the graph runner in two chunks of 2 (a
    capture at 998 and, for the methods that branch at 1000, another
    there; the rest replays): the same state, counts, generator and last
    metrics, bit for bit."""
    rows = _rows(4)
    eng, single, _ = _engine(method)
    for r in rows:
        single, m_single = eng.train_step_indices(single, r)
    eng, scanned, _ = _engine(method)
    scanned, m_scan = eng.train_steps_scan(scanned, rows)
    eng, graphed, captures = _engine(method, graphed=True)
    graphed, _ = eng.train_steps_scan(graphed, rows[:2])
    graphed, m_graph = eng.train_steps_scan(graphed, rows[2:])
    assert captures == ([START + 1, 1001]
                        if eng.method.graph_key(999) != eng.method.graph_key(
                            1000) else [START + 1])
    for state, m in ((scanned, m_scan), (graphed, m_graph)):
        _assert_states_equal(single, state)
        _assert_metrics_equal(m_single, m)


def test_graphs_are_dropped_for_a_new_state_or_a_resume():
    """The graphs hold the state's tensors: a new ``init_state`` and a
    resume that loads optimizer state (new momentum buffers) capture anew,
    and each run equals the eager steps from its state."""
    rows = _rows(4)
    eng, state, captures = _engine("supervised", graphed=True)
    state, _ = eng.train_steps_scan(state, rows[:2])
    state, _ = eng.train_steps_scan(state, rows[2:])
    assert captures == [START + 1]
    tree = ckpt.device_snapshot(ckpt.state_tree(state)).tree
    fresh = eng.init_state()
    fresh.step = START
    eng._pool = object()        # the pool of the graphs about to go
    fresh, _ = eng.train_steps_scan(fresh, rows[:2])
    assert captures == [START + 1, START + 1]
    assert eng._pool is None    # not handed to the next capture
    resumed = ckpt.load_state_tree(eng.init_state(), tree)
    resumed, m = eng.train_steps_scan(resumed, rows[:2])
    assert captures == [START + 1, START + 1, START + 5]

    ref_eng, ref, _ = _engine("supervised")
    ref, _ = ref_eng.train_steps(ref, rows)
    ref, m_ref = ref_eng.train_steps(ref, rows[:2])
    _assert_states_equal(ref, resumed)
    _assert_metrics_equal(m_ref, m)


def test_fixed_steps_through_the_graph_runner_equal_eager():
    eng, s, _ = _engine("uamt")
    batch = eng._store_batch(s, eng._indices(_rows(1)[0]))
    eng, a, _ = _engine("uamt")
    a, m_a = eng.train_steps_fixed(a, batch, 3)
    eng, b, captures = _engine("uamt", graphed=True)
    b, m_b = eng.train_steps_fixed(b, batch, 3)
    assert captures == [START + 1]
    _assert_states_equal(a, b)
    _assert_metrics_equal(m_a, m_b)


def test_process_group_runs_the_eager_body_and_says_so_once(caplog):
    eng, _, _ = _engine("mean_teacher")
    eng.mesh = Mesh(0, 2, torch.device("cpu"), group=object())
    with caplog.at_level("INFO"):
        assert eng._eager_only() and eng._eager_only()
    said = [r for r in caplog.records if "process group" in r.getMessage()]
    assert len(said) == 1
    assert "eager step body" in said[0].getMessage()
