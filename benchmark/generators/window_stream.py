"""Closed-loop sliding-window inference: a stream of resident volumes
handed one after another to the program's ``SlidingWindowEvaluator``
(through ``Engine.eval_probs``, as ``Engine.validate`` builds it), each
collected as a label map on the host, with at most ``depth`` volumes in
flight (volume i + 1 queued before volume i is collected, as a validation
pass runs). A volume's latency runs from the host's hand-over to its label
map on the host.

Set-up draws the volumes and the weights from the seed, loads the weights
into the program's model by name, and runs ``warmup_volumes`` volumes.
While the window runs, ``check_samples`` delivered label maps are kept,
drawn from the seed (a reservoir over all deliveries); the reference
judges them after the window. The mix's parameters:

``volumes`` (distinct volumes, cycled), ``shape``, ``depth``,
``stride_xy``, ``stride_z``, ``patch_batch``, ``warmup_volumes``,
``trace_volumes``, ``check_samples``.
"""
from __future__ import annotations

import collections
import functools
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import check, data, trace
from benchmark.generators.train_scan import load_weights, train_config
from benchmark.harness import sync
from benchmark.reference import methods, window


class Session:
    def __init__(self, run):
        from cvssl_tpu_torch.eval import val3d
        from cvssl_tpu_torch.train.engine import Engine

        self.run = run
        cfg, tr, dev = run.config, run.traffic, run.device
        self.cfg, self.tr, self.dev = cfg, tr, dev
        self.model = methods.MODELS[cfg["model"]]
        t = run.phase("imports", run.t0)
        engine = Engine(train_config(cfg, dev), device=dev)
        t = run.phase("engine", t)
        n, shape = tr["volumes"], tuple(tr["shape"])
        self.volumes = data.VolumeSet(n, shape, cfg["num_classes"], run.seed,
                                      dev, stream="window").gather(range(n))
        self.volumes = list(self.volumes["images"])
        t = run.phase("data", t)
        state = engine.init_state(seed=run.seed)
        sync(dev)
        t = run.phase("init_state", t)
        self.w0, _ = data.weights(self.model, cfg, run.seed, dev)
        load_weights(state.models["model"], self.w0)
        t = run.phase("weights", t)
        self.evaluator = val3d.SlidingWindowEvaluator(
            functools.partial(engine.eval_probs, "model"),
            tuple(cfg["patch_size"]), cfg["num_classes"], tr["stride_xy"],
            tr["stride_z"], patch_batch=tr["patch_batch"],
            predict_takes_args=True, device=dev)
        self.engine, self.state = engine, state
        self.next = 0
        self.rng = np.random.default_rng(data.stream_seed(run.seed,
                                                          "window"))
        self.samples, self.seen = [], 0
        self.attempted = self.failed = 0
        self._stream(volumes=tr["warmup_volumes"], keep=False)
        run.phase("warm_up", t)

    def _stream(self, volumes: int = None, seconds: float = None,
                keep: bool = True):
        """Hand volumes over until ``volumes`` were handed or ``seconds``
        have passed, then collect the rest; returns (the window's seconds,
        the latencies, the host seconds of each hand-over)."""
        depth, shape = self.tr["depth"], tuple(self.tr["shape"])
        model = self.state.models["model"]
        pending = collections.deque()
        latencies, enqueue = [], []
        handed = 0
        start = time.perf_counter()

        def collect():
            t_in, v, done = pending.popleft()
            with record_function("bench.collect"):
                label = done()
            latencies.append(time.perf_counter() - t_in)
            if label.shape != shape:
                self.failed += keep
            if keep:
                self._keep(v, label)

        while True:
            if volumes is not None and handed >= volumes:
                break
            if seconds is not None and time.perf_counter() - start >= \
                    seconds:
                break
            v = self.next % len(self.volumes)
            self.next += 1
            t_in = time.perf_counter()
            with record_function("bench.enqueue"):
                done = self.evaluator.predict_volume_async(self.volumes[v],
                                                           model)
            enqueue.append(time.perf_counter() - t_in)
            pending.append((t_in, v, done))
            handed += 1
            if len(pending) >= depth:
                collect()
        while pending:
            collect()
        elapsed = time.perf_counter() - start
        if keep:
            self.attempted += handed
        return elapsed, latencies, enqueue

    def _keep(self, v: int, label: np.ndarray):
        """A reservoir of ``check_samples`` deliveries, drawn from the
        seed."""
        k = self.tr["check_samples"]
        self.seen += 1
        if len(self.samples) < k:
            self.samples.append((v, label))
        else:
            j = int(self.rng.integers(self.seen))
            if j < k:
                self.samples[j] = (v, label)

    def measure(self, seconds: float) -> dict:
        sync(self.dev)
        elapsed, latencies, _ = self._stream(seconds=seconds)
        return {"seconds": elapsed, "delivered": len(latencies),
                "latencies": latencies}

    def trace(self):
        n = self.tr["trace_volumes"]
        tr = trace.profile(lambda: self._stream(volumes=n))
        return tr, n

    def layer_timings(self):
        """``enqueue_ms``: the hand-overs of ``trace_volumes`` volumes
        streamed as the window streams them, without the profiler."""
        n = self.tr["trace_volumes"]
        self.run.enqueue_s = self._stream(volumes=n)[2]

    def counts(self):
        return self.attempted, self.failed

    def flops_per_unit(self) -> float:
        corners = window.windows(tuple(self.tr["shape"]),
                                 self.cfg["patch_size"],
                                 self.tr["stride_xy"], self.tr["stride_z"])
        return methods.window_flop_count(self.cfg, len(corners),
                                         self.tr["patch_batch"])

    def ce_dice_bytes(self):
        return None

    # -- the comparison ----------------------------------------------------
    def check(self, wanted=None) -> dict:
        """Free the program's state, then judge each kept label map by the
        reference's probabilities of its volume (float32, TF32 off); the
        worst sample's numbers named in ``wanted`` (all where None)."""
        del self.engine, self.state, self.evaluator
        if self.dev != "cpu":
            torch.cuda.empty_cache()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        control = self.run.control
        probs = {}
        worst = {k: 0.0 for k in check.WINDOW_NUMBERS
                 if wanted is None or k in wanted}
        if not self.samples:
            return {k: 1.0 for k in worst}
        for v, label in self.samples:
            if v not in probs:
                probs[v] = self._probabilities(v, "float32")
            if control is not None:
                label = self._control_label(v, control)
            nums = check.window_numbers(label, probs[v], wanted)
            worst = {k: max(worst[k], nums[k]) for k in worst}
        return worst

    def _probabilities(self, v: int, precision: str):
        return window.probabilities(
            self.w0, self.volumes[v], self.cfg["patch_size"],
            self.cfg["num_classes"], self.tr["stride_xy"],
            self.tr["stride_z"], self.tr["patch_batch"], precision)

    def _control_label(self, v: int, control: dict) -> np.ndarray:
        """The reference in the program's place: its label map at the
        control's precision."""
        p = self._probabilities(v, control.get("precision", "float32"))
        return p.argmax(0).cpu().numpy().astype(np.int32)
