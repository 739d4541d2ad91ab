"""The port's step-window profiler against the JAX package's on the CPU:
the iterations where the trace starts and stops on the same tick
sequences, the trace files, ``measure_fp_bp_time``, and ``fit`` with
``profile_dir`` (a trace of the window, the run bit-equal to one without
it, the profiler stopped when a step fails)."""
import glob
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from cvssl_tpu.utils import profiler as jprof
from cvssl_tpu_torch.data import synthetic as tsyn
from cvssl_tpu_torch.models.unet import UNet as TUNet
from cvssl_tpu_torch.train.config import TrainConfig as TConfig
from cvssl_tpu_torch.train.engine import Engine as TEngine
from cvssl_tpu_torch.train.engine import fit
from cvssl_tpu_torch.train.methods.mean_teacher import MeanTeacher
from cvssl_tpu_torch.utils import profiler as tprof

C = 4
FEATURES = (4, 8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (ticks, close at the end): every step; chunks of 3 (scan_steps); a run
# resumed at step 15; a run that ends inside the window
SEQUENCES = {"every_step": (list(range(1, 31)), False),
             "chunks_of_3": (list(range(3, 31, 3)), False),
             "resume_at_15": (list(range(16, 31)), False),
             "close_before_stop": (list(range(1, 16)), True)}


def _window(profiler_cls, patch, ticks, close, metrics):
    """The ticks at which the trace started and stopped."""
    events, now = [], [None]
    patch(lambda: events.append(("start", now[0])),
          lambda: events.append(("stop", now[0])))
    p = profiler_cls("logdir")
    for it in ticks:
        now[0] = it
        p.tick(it, metrics)
    if close:
        now[0] = "close"
        p.close()
    p.close()       # closing twice does nothing
    p.tick(99, metrics)
    return events


class _FakeProfile:
    def __init__(self, on_start, on_stop):
        self.start, self.stop = on_start, on_stop


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_window_equals_jax(monkeypatch, case):
    ticks, close = SEQUENCES[case]

    def jax_patch(on_start, on_stop):
        monkeypatch.setattr(jax.profiler, "start_trace",
                            lambda log_dir: on_start())
        monkeypatch.setattr(jax.profiler, "stop_trace", on_stop)

    def port_patch(on_start, on_stop):
        monkeypatch.setattr(tprof, "_profile",
                            lambda log_dir: _FakeProfile(on_start, on_stop))

    want = _window(jprof.StepWindowProfiler, jax_patch, ticks, close,
                   {"loss": jnp.float32(1.0)})
    got = _window(tprof.StepWindowProfiler, port_patch, ticks, close,
                  {"loss": torch.tensor(1.0)})
    assert got == want
    assert [e for e, _ in got] == ["start", "stop"]


def test_empty_log_dir_never_traces(monkeypatch):
    monkeypatch.setattr(tprof, "_profile", lambda d: pytest.fail("traced"))
    p = tprof.StepWindowProfiler("")
    for it in range(1, 30):
        p.tick(it)
    p.close()
    assert not p.active


def _traces(log_dir):
    return glob.glob(os.path.join(str(log_dir), "*.pt.trace.json"))


def test_trace_and_window_write_trace_files(tmp_path):
    with tprof.trace(str(tmp_path / "block")):
        torch.ones(8, 8).sum()
    assert len(_traces(tmp_path / "block")) == 1
    p = tprof.StepWindowProfiler(str(tmp_path / "window"), start=2, stop=4)
    for it in range(1, 4):
        p.tick(it, {"loss": torch.ones(4, 4).sum()})
    assert p.active and not _traces(tmp_path / "window")
    p.tick(4, {"loss": torch.ones(())})
    assert not p.active
    paths = _traces(tmp_path / "window")
    assert len(paths) == 1
    with open(paths[0]) as f:
        assert json.load(f)["traceEvents"]


def test_measure_fp_bp_time_restores_the_mode():
    model = TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5).train()
    x = torch.zeros(2, 1, 32, 32)
    fp, bp = tprof.measure_fp_bp_time(model, x, steps=2, warmup=1)
    assert 0.0 < fp and 0.0 < bp
    assert model.training
    assert all(p.grad is None for p in model.parameters())


# ---------------------------------------------------------------------------
# fit with profile_dir
# ---------------------------------------------------------------------------

class _NarrowMT(MeanTeacher):
    def build_models(self):
        return {"model": TUNet(1, C, features=FEATURES, dropout=(0.0,) * 5)}


@pytest.fixture(scope="module")
def troot(tmp_path_factory):
    return tsyn.make_synthetic_acdc(
        str(tmp_path_factory.mktemp("acdc") / "ACDC"))


def _cfg(root, snapshot_root, **kw):
    base = dict(root_path=root, exp="ACDC/profile", method="mean_teacher",
                model="unet", num_classes=C, batch_size=4, labeled_bs=2,
                labeled_slices_override=8, patch_size=(32, 32),
                dtype="float32", max_iterations=21, val_every=100,
                ckpt_every=100, log_every=1,
                snapshot_root=str(snapshot_root))
    base.update(kw)
    return TConfig(**base)


def _run(cfg):
    return fit(cfg, engine=TEngine(cfg, method=_NarrowMT(cfg),
                                   device="cpu"))


def _logged(cfg):
    """The logged metrics (step, tag, value), without the wall times."""
    with open(os.path.join(cfg.snapshot_path(), "log", "metrics.jsonl")) \
            as f:
        return [(r["step"], r["tag"], r["value"])
                for r in map(json.loads, f)]


def test_profiled_fit_writes_the_window_and_equals_the_plain_fit(
        troot, tmp_path):
    prof_dir = tmp_path / "prof"
    plain_cfg = _cfg(troot, tmp_path / "plain")
    prof_cfg = _cfg(troot, tmp_path / "profiled",
                    profile_dir=str(prof_dir))
    plain = _run(plain_cfg)
    profiled = _run(prof_cfg)
    assert profiled["iterations"] == plain["iterations"] == 21
    paths = _traces(prof_dir)
    assert len(paths) == 1
    with open(paths[0]) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("conv" in n for n in names)      # the steps' ops
    with open(os.path.join(prof_cfg.snapshot_path(), "log.txt")) as f:
        assert "profiling steps 10-20" in f.read()
    assert _logged(prof_cfg) == _logged(plain_cfg)
    for slot in ("models", "teachers"):
        a = getattr(plain["state"], slot)["model"].state_dict()
        b = getattr(profiled["state"], slot)["model"].state_dict()
        for k, v in a.items():
            assert torch.equal(v, b[k]), (slot, k)


def test_failed_step_inside_the_window_stops_the_profiler(troot, tmp_path):
    prof_dir = tmp_path / "prof"
    cfg = _cfg(troot, tmp_path / "snap", profile_dir=str(prof_dir))
    engine = TEngine(cfg, method=_NarrowMT(cfg), device="cpu")
    real = engine.train_steps

    def failing(state, indices):
        if state.step == 12:
            raise RuntimeError("step failed")
        return real(state, indices)
    engine.train_steps = failing
    with pytest.raises(RuntimeError, match="step failed"):
        fit(cfg, engine=engine)
    assert len(_traces(prof_dir)) == 1
    assert not torch.autograd._profiler_enabled()
