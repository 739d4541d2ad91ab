"""The training engine (port of ``cvssl_tpu/train/engine.py``: state
construction, the step body, the device-store path, K steps a call
(``train_steps_scan``, ``train_steps_fixed``), the host pipeline's
batches, the eval-mode predictors, 2D validation and 3D sliding-window
validation, and the ``fit`` loop with its validation and checkpoint
cadence, in 2D and 3D).

One step: zero the gradients, run the method's loss through a ``StepCtx``
(student and teacher forwards in train mode, each model under bfloat16
autocast when its compute dtype is bfloat16), backward, SGD with the poly
LR of the optimizer's own update count, then the EMA of the teacher's
parameters with the decay of the step before its increment
(``engine.py:236``), and the same EMA along the method's
``param_ema_map`` (a model's parameters toward another's, JAX
``engine.py:240-246``). Adversarial methods run a second phase before any
optimizer steps (JAX ``engine.py:146-229``). The step's host values (the
methods' ramps, the EMA decay, the learning rates) reach it as 0-d float32
tensors on the device (``Engine.step_table``).

K steps a call, JAX's one XLA program of a ``lax.scan``, are on the card
replays of a CUDA graph of the whole step, one graph per branch of the
method's Python code (``Method.graph_key``), with the same body as the
eager step; on the CPU and in a process group they are eager steps.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``; on a
machine without CUDA, ``Engine(cfg)`` raises.

Inside a process group (``parallel/mesh.py::distributed_init``, one process
per card, as torchrun starts them) the engine is data-parallel: every rank
holds the global batch, each model call runs on the rank's rows and is
gathered (``StepCtx`` with the mesh), ``init_state`` broadcasts rank 0's
weights, and ``train_step`` averages the gradients over the ranks before
any optimizer step; ``fit`` validates and writes on rank 0. The numbers are
those of one process on the global batch (JAX's GSPMD program).

Numerics on the card: float32 matmuls and convolutions run in full float32
(TF32 off for both cuBLAS and cuDNN, set explicitly, since cuDNN's default is
TF32); under ``dtype="auto"`` the plain UNet's convolutions and SwinUnet's
matmuls run in bfloat16 through autocast, with float32 parameters,
BatchNorm statistics and losses; the UNet variants and the discriminator
run in float32, as in JAX (``TrainConfig.model_dtype``); the 3D UNets
compute in bfloat16 as the plain UNet does, and their discriminator and
the 3D zoo (VNet, VoxResNet, AttentionUNet3D, nnUNet) in float32.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import logging
import os
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from cvssl_tpu_torch.data import transforms as T
from cvssl_tpu_torch.data.datasets import SliceDataset, VolumeDataset
from cvssl_tpu_torch.data.device_store import (STORE_LIMIT_BYTES,
                                               STORE_MODES, DeviceSliceStore,
                                               DeviceVolumeStore)
from cvssl_tpu_torch.data.pipeline import DataPipeline
from cvssl_tpu_torch.data.sampler import (ShuffleBatchSampler,
                                          TwoStreamBatchSampler)
from cvssl_tpu_torch.eval import val2d, val3d
from cvssl_tpu_torch.ops import edt
from cvssl_tpu_torch.ops.ema import ema_decay_schedule, ema_update
from cvssl_tpu_torch.parallel import mesh as pmesh
from cvssl_tpu_torch.train.config import TrainConfig
from cvssl_tpu_torch.train.methods.base import Method, get_method
from cvssl_tpu_torch.train.state import StepCtx, TrainState
from cvssl_tpu_torch.utils import checkpoint as ckpt
from cvssl_tpu_torch.utils.logging import MetricsWriter, setup_logging
from cvssl_tpu_torch.utils.profiler import StepWindowProfiler


class Engine:
    def __init__(self, cfg: TrainConfig, method: Optional[Method] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Engine: no CUDA device; pass "
                                   "device='cpu' to run on the CPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        # the process group's ranks (one process and no group outside one);
        # in a group a bare "cuda" is the rank's card
        self.mesh = pmesh.make_mesh(cfg.num_devices, device=self.device)
        self.device = self.mesh.device
        self.cfg = cfg
        self.method = method or get_method(cfg.method, cfg)
        # the compute dtype of each model slot (teachers share their
        # student's)
        self.model_dtypes = {n: cfg.model_dtype(t, self.device)
                             for n, t in self.method.net_types().items()}
        self.store = None  # optional device-resident data store
        # on the card the val set is uploaded once (key: id of the dataset,
        # patch size; the entry holds the dataset, so the id stays its own)
        self._val_store: Dict[tuple, Optional[dict]] = {}
        # 3D: one sliding-window evaluator per (model slot, patch), which
        # keeps its count maps across validations
        self._evaluators: Dict[tuple, val3d.SlidingWindowEvaluator] = {}
        # K steps a call (``train_steps_scan``/``_fixed``): CUDA graphs of
        # the step on the card in one process, by (inputs, graph key), their
        # static inputs, the state they hold (``_check_graphs``), one
        # memory pool and the capture stream
        self.graphed = self.device.type == "cuda" and not \
            self.mesh.distributed
        self._logged_eager = False
        self._graphs: Dict[tuple, tuple] = {}
        self._static: Dict[tuple, dict] = {}
        self._graph_state = None
        self._pool = None
        self._capture_stream = None

    # ------------------------------------------------------------------
    # state construction
    # ------------------------------------------------------------------
    def init_state(self, seed: Optional[int] = None) -> TrainState:
        """Models with random weights from ``seed`` (default ``cfg.seed``),
        then ``cfg.pretrained_ckpt``'s where it fits
        (:meth:`_load_pretrained`), rank 0's on every rank of a process
        group (JAX ``replicate_state``), their teachers as copies,
        optimizers, and the step's generator (the same seed on every
        rank, so that the ranks draw in lockstep)."""
        seed = self.cfg.seed if seed is None else seed
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            models = self.method.build_models()
        models = {n: m.to(self.device).train() for n, m in models.items()}
        if self.cfg.pretrained_ckpt:
            self._load_pretrained(models)
        pmesh.replicate_state(self.mesh, models.values())
        teachers = {}
        for name in self.method.teacher_names:
            teachers[name] = copy.deepcopy(models[name]).requires_grad_(False)
        optimizers = self.method.optimizers(models)
        # a model in no optimizer (the contrastive heads) keeps its initial
        # weights: no gradient is kept for it
        for name, model in models.items():
            if name not in optimizers:
                model.requires_grad_(False)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return TrainState(step=0, models=models,
                          optimizers=optimizers,
                          teachers=teachers, generator=generator,
                          extra=self.method.init_extra())

    def _load_pretrained(self, models: Dict[str, torch.nn.Module]):
        """``cfg.pretrained_ckpt`` into each model it belongs to (JAX
        ``engine.py:103-116``): before the teachers are copied and the
        optimizers built, so a teacher starts from the same weights."""
        from cvssl_tpu_torch.models import cnn_checkpoint as cc
        path = self.cfg.pretrained_ckpt
        sd = cc.load_torch_state_dict(path)
        for name, model in models.items():
            if cc.maybe_load_encoder(model, sd):
                logging.getLogger(__name__).info(
                    "loaded pretrained encoder into %s from %s", name, path)

    # ------------------------------------------------------------------
    # the step
    # ------------------------------------------------------------------
    def step_table(self, state: TrainState, k: int):
        """The host values of the next ``k`` steps: (names, (k, n) float32
        array). Row r holds the method's ``step_scalars`` of step
        ``state.step + r``, the EMA decay of that step (``ema_decay``) and
        the learning rate of each scheduled optimizer after ``count + r``
        updates (``lr_<slot>``): today's numpy values, bit for bit."""
        scheduled = {n: o for n, o in state.optimizers.items()
                     if hasattr(o, "lr_at")}
        rows = []
        for r in range(k):
            t = state.step + r
            row = dict(self.method.step_scalars(t))
            row["ema_decay"] = ema_decay_schedule(t, self.cfg.ema_decay)
            for n, o in scheduled.items():
                row[f"lr_{n}"] = o.lr_at(o.count + r)
            rows.append(row)
        names = tuple(rows[0])
        return names, np.array([[row[n] for n in names] for row in rows],
                               np.float32)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; on the card from pinned
        memory without blocking the host (a fresh pinned buffer per call,
        which the copy keeps until it is done)."""
        t = torch.from_numpy(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _step(self, state: TrainState, batch: dict, names,
              scalars: torch.Tensor):
        """The step body, one for every entry point and for the CUDA
        graphs: ``scalars`` (n,) float32 on the device is the step's row
        of :meth:`step_table` with ``names``."""
        scal = dict(zip(names, scalars.unbind()))
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        ctx = StepCtx(self.cfg, state.models, state.teachers,
                      state.generator, state.step, self.model_dtypes,
                      mesh=self.mesh, scalars=scal)
        adversarial = [state.models[n]
                       for n in self.method.adversarial_models]
        for m in adversarial:
            m.requires_grad_(False)
        try:
            loss, metrics = self.method.loss(ctx, batch)
            loss.backward()
        finally:
            for m in adversarial:
                m.requires_grad_(True)
        if adversarial:
            d_loss, d_metrics = self.method.loss_d(ctx, batch)
            d_loss.backward()
            metrics = {**metrics, **d_metrics, "loss_d": d_loss}
        pmesh.all_reduce_grads(self.mesh, [
            p for m in state.models.values() for p in m.parameters()])
        for name, opt in state.optimizers.items():
            opt.step(lr=scal.get(f"lr_{name}"))
        decay = scal["ema_decay"]
        for name in self.method.teacher_names:
            ema_update(state.teachers[name].parameters(),
                       state.models[name].parameters(), decay)
        # parameters only (BatchNorm's weight and bias among them): the
        # running statistics move by each model's own forward, as Flax's
        # ``params`` and ``batch_stats`` split them
        for dst, src in self.method.param_ema_map.items():
            ema_update(state.models[dst].parameters(),
                       state.models[src].parameters(), decay)
        state.step += 1
        return state, {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in metrics.items()}

    def train_step(self, state: TrainState, batch: dict):
        """One step on a batch already on the device: {"image": (B, 1, H, W)
        float32, "label": (B, H, W) int} (and the ``weak_strong`` store's
        keys). Updates ``state`` in place and returns (state, metrics);
        metrics are device tensors (no sync).

        One step: zero the gradients, run the method's loss through a
        ``StepCtx`` with the step's host values (:meth:`step_table`, one
        row copied to the device without blocking), backward, each
        optimizer at its rate of the table, then the EMAs at the table's
        decay.

        With ``adversarial_models``, two phases before any optimizer step,
        as JAX's step: the generator phase (``loss``) with those models
        frozen, so gradients flow through them into the segmenter but none
        is kept for their own parameters (JAX differentiates the main
        parameters only); then the discriminator phase (``loss_d``), which
        sees the segmenter's weights before the update and its BatchNorm
        running statistics after the generator phase's forwards.

        In a process group each model call is split over the ranks, and
        the gradients of both phases are averaged over the ranks before
        any optimizer step (``parallel/mesh.py``: each rank holds W times
        its rows' share of the gradient of the same loss)."""
        names, table = self.step_table(state, 1)
        return self._step(state, batch, names, self._upload(table[0]))

    # -- device-store path: only indices cross the host boundary ----------
    def attach_store(self, store):
        self.store = store
        self._drop_graphs()

    def _indices(self, indices: Sequence[int]) -> torch.Tensor:
        return self._upload(np.asarray(indices, np.int64))

    def _store_batch(self, state: TrainState, indices: torch.Tensor):
        return self.store.batch_fn(self.store.arrays(), indices,
                                   state.generator)

    def train_step_indices(self, state: TrainState, indices):
        """One step from the attached store: gather + augmentation on the
        device, then the step body. In a process group every rank gathers
        and augments the whole global batch from its own store and
        generator."""
        if self.store is None:
            raise RuntimeError("attach_store() first")
        return self.train_step(state, self._store_batch(
            state, self._indices(indices)))

    def host_batch(self, batch: dict) -> dict:
        """A batch of the host pipeline (numpy arrays, or tensors in pinned
        memory) on the engine's device; copies from pinned memory do not
        block the host."""
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def train_steps(self, state: TrainState, indices_matrix):
        """K eager steps, one :meth:`train_step_indices` per row of
        ``indices_matrix`` (K, B); returns (state, last step's metrics).
        The plain counterpart of :meth:`train_steps_scan`, which it
        equals on the CPU."""
        metrics = None
        for indices in indices_matrix:
            state, metrics = self.train_step_indices(state, indices)
        return state, metrics

    # -- K steps a call: CUDA graphs of the step ---------------------------
    def _eager_only(self) -> bool:
        """Whether the K-step calls run the eager body: on the CPU, and in
        a process group, whose gloo collectives a CUDA graph cannot hold
        (logged once)."""
        if self.mesh.distributed and not self._logged_eager:
            self._logged_eager = True
            logging.getLogger(__name__).info(
                "process group of %d ranks: train_steps_scan and "
                "train_steps_fixed run the eager step body (no CUDA graph "
                "of the gloo collectives)", self.mesh.world)
        return not self.graphed

    def train_steps_scan(self, state: TrainState, indices_matrix):
        """K steps from the attached store, one per row of
        ``indices_matrix`` (K, B); returns (state, last step's metrics).
        JAX's ``train_steps_scan`` (``lax.scan`` of the step in one XLA
        program). On the card, in one process, each row is one replay of
        a CUDA graph of the whole step (the store's gather and
        augmentation from a static index buffer, both phases of an
        adversarial method, every optimizer, the EMAs): see
        :meth:`_graphed_steps`. On the CPU and in a process group it is
        :meth:`train_steps`."""
        if self.store is None:
            raise RuntimeError("attach_store() first")
        if self._eager_only():
            return self.train_steps(state, indices_matrix)
        return self._graphed_steps(
            state, len(indices_matrix),
            indices=np.asarray(indices_matrix, np.int64))

    def train_steps_fixed(self, state: TrainState, batch: dict, k: int):
        """K steps over one batch (numpy arrays or tensors; JAX's
        ``train_steps_fixed``, a benchmark's and a probe's call); returns
        (state, last step's metrics). On the card, in one process, each
        step is one replay of a CUDA graph of the step on a static copy
        of the batch; elsewhere :meth:`train_step` ``k`` times."""
        batch = self.host_batch(batch)
        if self._eager_only():
            metrics = None
            for _ in range(k):
                state, metrics = self.train_step(state, batch)
            return state, metrics
        return self._graphed_steps(state, k, batch=batch)

    def _drop_graphs(self):
        """Forget the captured graphs, their static inputs and their memory
        pool (after the card is done with any replay in flight): the
        allocator may release a pool whose last graph is gone, so the next
        capture starts a new one."""
        if self._graphs and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._graphs.clear()
        self._static.clear()
        self._graph_state = None
        self._pool = None

    def _state_tensors(self, state: TrainState) -> list:
        """Every tensor whose address a graph of the step holds, and the
        generator: parameters and buffers of the models and teachers, the
        optimizers' state, the store's arrays."""
        out = [state.generator]
        for group in (state.models, state.teachers):
            for m in group.values():
                out += list(m.parameters()) + list(m.buffers())
        for opt in state.optimizers.values():
            for st in opt.state.values():
                out += [v for v in st.values() if torch.is_tensor(v)]
        if self.store is not None:
            out += [t for t in self.store.arrays() if torch.is_tensor(t)]
        return out

    def _check_graphs(self, state: TrainState):
        """Drop the graphs unless the state's and store's tensors are the
        ones they were captured on (a new ``init_state``, a resume that
        loads optimizer state, a new store). The tensors are held, so a
        new one cannot take an old one's address unseen."""
        if self._graph_state is None:
            return
        held, prints = self._graph_state
        now = self._state_tensors(state)
        if len(now) != len(held) or any(
                a is not b for a, b in zip(now, held)) or prints != [
                    t.data_ptr() for t in now[1:]]:
            self._drop_graphs()

    def _graphed_steps(self, state: TrainState, k: int,
                       indices: Optional[np.ndarray] = None,
                       batch: Optional[dict] = None):
        """K steps as replays of CUDA graphs of the step, one graph per
        (inputs' shapes, ``method.graph_key``). The step's inputs are
        static buffers: before each replay the row's indices (or, once a
        call, the batch) and the row of :meth:`step_table` are copied
        into them on the card, from tables copied there once a call. A key
        without a graph yet runs its first row as a real eager step on the
        capture stream (the warm-up: momentum buffers, caches and scratch
        made outside the capture), then is captured
        (:meth:`_capture_step`), which runs nothing and moves no state. The
        host advances ``state.step`` and every optimizer's ``count`` once
        a replay, as the eager step does; the generator is registered with
        each graph, so a replay draws the eager stream and advances it as
        far. The last step's metrics are cloned out of the graph's static
        outputs. A failed capture or replay raises."""
        self._check_graphs(state)
        names, table = self.step_table(state, k)
        scal = self._upload(table)
        if indices is not None:
            rows = self._upload(indices)
            sig = ("scan", indices.shape[1], names)
        else:
            sig = ("fixed", names) + tuple(
                (n, tuple(v.shape), v.dtype) for n, v in batch.items())
        st = self._static.get(sig)
        if st is None:
            st = self._static[sig] = {
                "scalars": torch.empty(len(names), dtype=torch.float32,
                                       device=self.device)}
            if indices is not None:
                st["indices"] = torch.empty(indices.shape[1],
                                            dtype=torch.int64,
                                            device=self.device)
            else:
                st["batch"] = {n: torch.empty_like(v)
                               for n, v in batch.items()}
        if batch is not None:
            for n, v in batch.items():
                st["batch"][n].copy_(v)

        def run():
            b = (self._store_batch(state, st["indices"])
                 if indices is not None else st["batch"])
            return self._step(state, b, names, st["scalars"])[1]

        metrics = None
        for r in range(k):
            st["scalars"].copy_(scal[r])
            if indices is not None:
                st["indices"].copy_(rows[r])
            key = sig + (self.method.graph_key(state.step),)
            entry = self._graphs.get(key)
            if entry is None:
                metrics, graph, static = self._capture_step(state, run)
                self._graphs[key] = (graph, static)
                held = self._state_tensors(state)
                self._graph_state = (held, [t.data_ptr() for t in held[1:]])
                continue
            graph, metrics = entry
            graph.replay()
            state.step += 1
            for opt in state.optimizers.values():
                opt.count += 1
        # the static outputs and inputs change with the next replay or call
        return state, {n: v.clone() if torch.is_tensor(v) else v
                       for n, v in metrics.items()}

    def _capture_step(self, state: TrainState, run: Callable):
        """The warm-up and capture of one step (``run()``, which reads the
        static inputs and returns the metrics): on a side stream, ``run()``
        once as a real step, then a ``torch.cuda.CUDAGraph`` of it in the
        engine's one memory pool, with ``state.generator`` registered;
        ``state.step`` and the counts are put back after the capture.
        Returns (the warm-up's metrics, the graph, its static metrics)."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        stream = self._capture_stream
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            metrics = run()
            counters = (state.step, {n: o.count for n, o in
                                     state.optimizers.items()})
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(state.generator)
            pool = () if self._pool is None else (self._pool,)
            # not ``torch.cuda.graph``, which synchronises the device first
            graph.capture_begin(*pool, capture_error_mode="thread_local")
            try:
                static = run()
            finally:
                graph.capture_end()
                state.step = counters[0]
                for n, o in state.optimizers.items():
                    o.count = counters[1][n]
            if self._pool is None:
                self._pool = graph.pool()
        main.wait_stream(stream)
        return metrics, graph, static

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------
    def eval_logits(self, name: str, model, x: torch.Tensor) -> torch.Tensor:
        """``model``'s (in slot ``name``) main logits of x, float32:
        eval-mode forward (running BatchNorm statistics, no dropout) in the
        slot's compute dtype, no gradient."""
        ctx = StepCtx(self.cfg, {name: model}, {}, None, 0,
                      self.model_dtypes)
        with torch.no_grad():
            out = self.method.primary_logits(
                ctx.forward(name, x.to(self.device), train=False))
        return out.float()

    def eval_probs(self, name: str, model, x: torch.Tensor) -> torch.Tensor:
        """The softmax of :meth:`eval_logits` over the classes."""
        return torch.softmax(self.eval_logits(name, model, x), dim=1)

    def predict_fn(self, name: str, state: TrainState,
                   teacher: bool = False):
        """Batched argmax predictor: x (B, C_in, *spatial) -> uint8 (B,
        *spatial)."""
        model = (state.teachers if teacher else state.models)[name]
        return lambda x: self.eval_logits(name, model, x).argmax(
            dim=1).to(torch.uint8)

    def predict_probs_fn(self, name: str, state: TrainState,
                         teacher: bool = False):
        """Batched softmax predictor (the 3D sliding window): x (B, C_in,
        *spatial) -> float32 (B, classes, *spatial)."""
        model = (state.teachers if teacher else state.models)[name]
        return lambda x: self.eval_probs(name, model, x)

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def validate(self, state: TrainState, val_dataset, name: str = None):
        """Per-class (dice, hd95) means over a val set of volumes,
        (classes-1, 2). In 3D the sliding window at the patch, stride 64
        on every axis (JAX ``engine.py:393-408``), through one cached
        evaluator per slot that predicts with the model it is given
        (:func:`val3d.test_all_case`). In 2D, on the card a uniform val set
        at patch resolution is uploaded once and the forward, argmax and
        EDT metrics all run there, so only the (classes-1, 2) table comes
        back; otherwise ``val2d.evaluate``."""
        name = name or self.method.eval_model_names()[0]
        size = self.cfg.patch_size
        if self.cfg.patch_size2 and name == "model2":
            size = self.cfg.patch_size2
        if self.cfg.dim == 3:
            key = (name, tuple(size))
            if key not in self._evaluators:
                self._evaluators[key] = val3d.SlidingWindowEvaluator(
                    functools.partial(self.eval_probs, name), size,
                    self.cfg.num_classes, 64, 64, predict_takes_args=True,
                    device=self.device)
            return val3d.test_all_case(
                None, val_dataset, self.cfg.num_classes, size,
                evaluator=self._evaluators[key],
                predict_args=state.models[name])
        if self.device.type == "cuda":
            store = self._val_resident_store(val_dataset, tuple(size))
            if store is not None:
                fn = self._val_fused_fn(name, store["shape"], store["n"])
                out = fn(state, store["images"], store["labels"])
                return out.cpu().numpy().astype(np.float64) / store["n"]
        return val2d.evaluate(val_dataset, self.predict_fn(name, state),
                              self.cfg.num_classes, size)

    def _val_resident_store(self, val_dataset, size):
        """Upload the (uniform-shape, patch-resolution) val set once; None
        if the set needs per-volume zoom (then ``val2d.evaluate``)."""
        key = (id(val_dataset), size)
        if key not in self._val_store:
            samples = [val_dataset[i] for i in range(len(val_dataset))]
            shapes = {tuple(s["image"].shape) for s in samples}
            if len(shapes) != 1 or next(iter(shapes))[1:] != size:
                self._val_store[key] = None
            else:
                n = len(samples)
                sv, xv, yv = next(iter(shapes))
                images = np.stack([s["image"] for s in samples]).reshape(
                    n * sv, xv, yv).astype(np.float32)
                labels = np.stack([np.asarray(s["label"])
                                   for s in samples]).astype(np.uint8)
                self._val_store[key] = {
                    "dataset": val_dataset,
                    "images": torch.from_numpy(images).to(self.device),
                    "labels": torch.from_numpy(labels).to(self.device),
                    "n": n, "shape": (sv, xv, yv)}
        return self._val_store[key]

    def _val_fused_fn(self, name: str, vol_shape, n: int):
        """forward + argmax + per-class EDT Dice/HD95 on the device; the
        returned function gives the SUMMED (classes-1, 2) table (divide by
        n on the host)."""
        classes = self.cfg.num_classes

        def run(state, images, labels):
            pred = val2d.predict_slices(self.predict_fn(name, state), images)
            pred = pred.reshape((n,) + tuple(vol_shape))
            return edt.val_metrics(pred, labels, classes).sum(dim=0)
        return run


# ---------------------------------------------------------------------------
# The full training loop (reference ``train()`` parity)
# ---------------------------------------------------------------------------

def build_3d_data(cfg: TrainConfig, supervised_only: bool,
                  raw: bool = False):
    """The BraTS recipe (``train_mean_teacher_3D.py:98-113``): the host
    transform RandomRotFlip3D then RandomCrop(patch), sharing the sampler's
    generator (none with ``raw=True``: the store crops and rotates in the
    step); ``labeled_num`` counts labeled volumes, and the unlabeled pool
    ends at ``total_num`` (the reference's 250; default: every train
    volume). JAX: ``engine.build_3d_data``."""
    rng = np.random.default_rng(cfg.seed)
    transform = None if raw else T.Compose(
        [T.RandomRotFlip3D(rng), T.RandomCrop(cfg.patch_size, rng=rng)])
    if supervised_only:
        train_ds = VolumeDataset(cfg.root_path, "train", num=cfg.labeled_num,
                                 transform=transform)
        sampler = ShuffleBatchSampler(len(train_ds), cfg.batch_size, rng)
    else:
        train_ds = VolumeDataset(cfg.root_path, "train", transform=transform)
        total = cfg.total_num or len(train_ds)
        sampler = TwoStreamBatchSampler(
            list(range(cfg.labeled_num)), list(range(cfg.labeled_num, total)),
            cfg.batch_size, cfg.batch_size - cfg.labeled_bs, rng)
    return train_ds, sampler, VolumeDataset(cfg.root_path, "val")


def build_2d_data(cfg: TrainConfig, supervised_only: bool,
                  transform_name: str = "default", raw: bool = False):
    """Datasets + sampler per the reference recipe. ``raw=True`` leaves the
    host transform out (the device-store path: augmentation runs in the
    step); otherwise the host transform of ``transform_name`` shares the
    sampler's generator. JAX: ``engine.build_2d_data``."""
    rng = np.random.default_rng(cfg.seed)
    if raw:
        transform = None
    elif transform_name == "weak_strong":
        transform = T.WeakStrongAugment(cfg.patch_size, rng)
    elif transform_name == "weak":
        transform = T.RandomGeneratorWeak(cfg.patch_size, rng)
    else:
        transform = T.RandomGenerator(cfg.patch_size, rng)
    if supervised_only:
        train_ds = SliceDataset(cfg.root_path, "train",
                                num=cfg.labeled_slices, transform=transform)
        sampler = ShuffleBatchSampler(len(train_ds), cfg.batch_size, rng)
    else:
        train_ds = SliceDataset(cfg.root_path, "train", transform=transform)
        labeled = list(range(cfg.labeled_slices))
        unlabeled = list(range(cfg.labeled_slices, len(train_ds)))
        sampler = TwoStreamBatchSampler(labeled, unlabeled, cfg.batch_size,
                                        cfg.batch_size - cfg.labeled_bs, rng)
    val_ds = SliceDataset(cfg.root_path, "val")
    return train_ds, sampler, val_ds


def cta_train_data(cfg: TrainConfig, method: Method,
                   make_dataset: Callable):
    """The CTAugment path's train set + sampler (JAX ``engine.py:566-578``):
    ``make_dataset(transform, ops_weak, ops_strong)`` with the method's
    ``CTATransform`` and initial policies, and the two-stream sampler on
    its own generator."""
    rng = np.random.default_rng(cfg.seed)
    train_ds = make_dataset(*method.create_transform(cfg))
    labeled = list(range(cfg.labeled_slices))
    unlabeled = list(range(cfg.labeled_slices, len(train_ds)))
    sampler = TwoStreamBatchSampler(labeled, unlabeled, cfg.batch_size,
                                    cfg.batch_size - cfg.labeled_bs, rng)
    return train_ds, sampler


def build_cta_data(cfg: TrainConfig, method: Method):
    """:func:`cta_train_data` on the slices under ``cfg.root_path``, and
    the val set."""
    train_ds, sampler = cta_train_data(
        cfg, method, lambda transform, ops_weak, ops_strong: SliceDataset(
            cfg.root_path, "train", transform=transform, ops_weak=ops_weak,
            ops_strong=ops_strong))
    return train_ds, sampler, SliceDataset(cfg.root_path, "val")


def cta_iteration(engine: Engine, state: TrainState, batch: dict,
                  pipe: DataPipeline, train_ds,
                  iters_per_epoch: int) -> tuple:
    """One iteration of the CTAugment host path, the method's hooks in
    JAX's order (``engine.py:640-677``): ``on_batch`` on the host batch,
    the step, ``on_step_metrics``, and after an epoch's last step
    ``on_epoch_end`` + ``on_epoch_start``; then the request for the batch
    ``pipe.prefetch`` ahead, with the policies in force after all of them,
    so a refresh after batch k reaches batch k + ``pipe.prefetch``.
    Returns (state, metrics)."""
    method = engine.method
    method.on_batch(batch, train_ds)
    state, metrics = engine.train_step(state, engine.host_batch(batch))
    method.on_step_metrics(metrics)
    if state.step % iters_per_epoch == 0:
        method.on_epoch_end(train_ds)
        method.on_epoch_start(train_ds, state.step)
    pipe.request()
    return state, metrics


# the hooks a method on the ``cta`` transform gives ``fit``
CTA_HOOKS = ("create_transform", "on_epoch_start", "on_batch",
             "on_step_metrics", "on_epoch_end", "hook_state",
             "load_hook_state")


def _check_ported(cfg: TrainConfig, method: Method):
    """``fit`` raises for what this port does not run yet, rather than
    running something else, and for a missing ``pretrained_ckpt``."""
    if cfg.dim not in (2, 3):
        raise ValueError(f"dim={cfg.dim}: 2 or 3")
    if cfg.dim == 3 and method.transform == "cta":
        raise NotImplementedError(
            f"method {cfg.method!r} trains on CTAugment, a 2D transform; "
            "it has no 3D data path")
    if method.transform == "cta":
        missing = [h for h in CTA_HOOKS if not hasattr(method, h)]
        if missing:
            raise NotImplementedError(
                f"method {cfg.method!r} trains on CTAugment ('cta') "
                f"without the hooks {missing}")
    elif method.transform not in STORE_MODES:
        raise NotImplementedError(
            f"method {cfg.method!r} needs the {method.transform!r} "
            "augmentation, which is not ported yet")
    if cfg.pretrained_ckpt:
        # before anything is written; the engine loads it at init
        from cvssl_tpu_torch.models.cnn_checkpoint import require_file
        require_file(cfg.pretrained_ckpt)


class _NoWriter:
    """The metrics writer of a rank other than 0: it writes nothing."""

    def add_scalar(self, tag, value, step):
        pass

    def add_scalars(self, scalars, step):
        pass

    def close(self):
        pass


def _on_lead(mesh: pmesh.Mesh, fn: Callable, n: int) -> list:
    """``fn()``'s ``n`` floats, computed on rank 0 alone and broadcast to
    every rank (float64, exact); outside a group, ``fn()``. An exception on
    rank 0 is raised there and, through the broadcast, as a RuntimeError
    on the other ranks, which would otherwise wait in it."""
    if not mesh.distributed:
        return fn()
    buf = torch.zeros(n + 1, dtype=torch.float64, device=mesh.device)
    error = None
    if mesh.rank == 0:
        try:
            buf[1:] = torch.tensor(fn(), dtype=torch.float64)
        except BaseException as e:  # re-raised below, after the broadcast
            error = e
            buf[0] = 1.0
    torch.distributed.broadcast(buf, 0, group=mesh.group)
    if error is not None:
        raise error
    values = buf.tolist()
    if values[0]:
        raise RuntimeError("rank 0 failed in the work it runs alone for "
                           "every rank (its traceback is in its output)")
    return values[1:]


def fit(cfg: TrainConfig, engine: Optional[Engine] = None,
        max_steps: Optional[int] = None, data=None,
        device="cuda") -> dict:
    """Train per the reference protocol: validation every ``val_every``
    iterations, best checkpoint on mean Dice, periodic full-state
    checkpoints, resume from the newest full-state checkpoint.

    ``data`` is the (train_ds, sampler, val_ds) triple of
    :func:`build_2d_data`, :func:`build_3d_data` or :func:`build_cta_data`
    (for the host path, with the transform on ``train_ds``); None builds it
    from ``cfg.root_path``. The engine defaults to ``Engine(cfg,
    device=device)``.

    The batches come from the device store, or with ``device_data=False``
    from the host pipeline (``DataPipeline.stream()``, one step a batch,
    pinned and copied to the card without blocking), as JAX's rule picks.
    At ``dim=3`` the store is ``DeviceVolumeStore`` (crop, rot90 and flip
    in the step) while its estimate stays under 8 GiB (JAX
    ``engine.py:558-563``) and the patch's first two sides are equal
    (nnUNet's 96 x 128 x 128 is not; JAX's store fails to trace it), else
    the host pipeline with RandomRotFlip3D + RandomCrop; a given ``data``
    then has its train set raw where the store takes it, and with the
    host transform where it does not (``DeviceVolumeStore.takes_patch``
    and ``estimated_bytes`` decide). Validation is the
    sliding window (:meth:`Engine.validate`).
    With ``profile_dir``, steps 10-20 are traced there
    (:class:`~cvssl_tpu_torch.utils.profiler.StepWindowProfiler`, ticked
    after each call of the step loop, so a chunk of ``scan_steps`` moves
    the window's ends to the chunk's end, as in JAX).
    A method on CTAugment (``transform == "cta"``) always takes the host
    path, the pipeline with the method's policies
    (``DataPipeline(policy=...)``), and ``fit`` drives its hooks in JAX's
    order: ``on_epoch_start`` before the loop, then
    :func:`cta_iteration` for each batch.

    One difference from the JAX loop: a resumed run sees the batches the
    uninterrupted run would have and ends bit-equal to it. The store path
    skips the first ``step`` batches of the index stream; the host path
    continues the stream from the sampler state saved with the checkpoint
    (the state after the batches taken, not the prefetch thread's); on
    the CTA path also the loader's generator, the policies of the requests
    in flight and the method's hook state (``hook_state``: the CTAugment
    rates, generators and policies, the epoch's losses so far), and the
    resumed run does not start an epoch anew.

    In a process group every rank trains (the engine splits each model
    call over the ranks); rank 0 alone writes the log, the metrics, the
    checkpoints and the best models, and validates, and its validation
    scores are broadcast, so every rank keeps the same best Dice. Every
    rank resumes from the same files, after a barrier. A failed step or
    validation on any rank fails the run: a validation error on rank 0
    reaches the other ranks through that broadcast, and torchrun ends the
    other ranks of a process that exits."""
    engine = engine or Engine(cfg, device=device)
    _check_ported(cfg, engine.method)
    mesh = engine.mesh
    lead = mesh.rank == 0
    snapshot = cfg.snapshot_path()
    if lead:
        logger = setup_logging(snapshot)
        writer = MetricsWriter(os.path.join(snapshot, "log"))
    else:
        logger = logging.getLogger(f"cvssl_tpu_torch_rank{mesh.rank}")
        writer = _NoWriter()
    if not cfg.deterministic:
        # the reference's --deterministic 0 trades reproducibility away;
        # here that is an entropy-drawn seed for the RNG and the sampling,
        # rank 0's on every rank
        entropy_seed = int(_on_lead(
            mesh, lambda: [int.from_bytes(os.urandom(4), "little")], 1)[0])
        cfg = dataclasses.replace(cfg, seed=entropy_seed)
        logger.info("--deterministic 0: entropy seed %d", entropy_seed)
    logger.info("config: %s", cfg)

    method = engine.method
    # JAX's rule (``engine.py:555-557``): the ``cta`` transform always
    # takes the host path
    cta = method.transform == "cta"
    use_store = cfg.device_data and not cta
    if cfg.dim == 3:
        if use_store:
            probe = data[0] if data is not None else VolumeDataset(
                cfg.root_path, "train")
            use_store = DeviceVolumeStore.takes_patch(cfg.patch_size) and \
                DeviceVolumeStore.estimated_bytes(
                    probe, cfg.patch_size) < STORE_LIMIT_BYTES
        if data is None:
            data = build_3d_data(cfg, method.supervised_only, raw=use_store)
    elif data is None:
        data = build_cta_data(cfg, method) if cta else build_2d_data(
            cfg, method.supervised_only, method.transform, raw=use_store)
    train_ds, sampler, val_ds = data
    if use_store:
        engine.attach_store(
            DeviceVolumeStore(train_ds, cfg.patch_size, device=engine.device)
            if cfg.dim == 3 else
            DeviceSliceStore(train_ds, cfg.patch_size, device=engine.device,
                             mode=engine.method.transform))
        index_stream = sampler.epochs()
        logger.info("device-resident dataset: %d samples on %s",
                    len(train_ds), engine.device)
    elif cta:
        pipe = DataPipeline(
            train_ds, sampler, num_workers=cfg.num_workers,
            pin_memory=engine.device.type == "cuda",
            policy=lambda: (train_ds.ops_weak, train_ds.ops_strong),
            loader_rng=train_ds.transform.rng)
        logger.info("host CTAugment pipeline: %d samples, one prefetch "
                    "thread", len(train_ds))
    else:
        pipe = DataPipeline(train_ds, sampler, num_workers=cfg.num_workers,
                            pin_memory=engine.device.type == "cuda")
        logger.info("host data pipeline: %d samples, one prefetch thread",
                    len(train_ds))
    state = engine.init_state(seed=cfg.seed)

    # resume if a full-state checkpoint exists (with best_dice, so the
    # best-checkpoint contract survives restarts)
    best_dice = {n: 0.0 for n in engine.method.eval_model_names()}
    pmesh.barrier(mesh)
    tree, start_it, meta = ckpt.restore_latest(snapshot)
    if tree is not None:
        state = ckpt.load_state_tree(state, tree)
        best_dice.update(meta.get("best_dice", {}))
        if use_store:
            for _ in range(state.step):
                next(index_stream)
        logger.info("resumed from iteration %d (best_dice %s)", start_it,
                    best_dice)
    # the host stream continues from the sampler state saved with the
    # checkpoint: the state after the batches the saved steps took
    if cta and tree is not None:
        method.load_hook_state(meta["cta"], train_ds)
    stream = None if use_store else pipe.stream(
        meta.get("data") if tree is not None else None)
    if cta and tree is None:
        method.on_epoch_start(train_ds, state.step)
    iters_per_epoch = max(len(sampler), 1)

    max_iterations = max_steps or cfg.max_iterations
    saver = ckpt.AsyncWriter()
    t0 = time.time()
    images_seen = 0
    val_seconds = []

    # profile_dir: a trace of steps 10-20, after the warm-up
    profiler = None
    if cfg.profile_dir and lead:
        profiler = StepWindowProfiler(cfg.profile_dir)
        logger.info("profiling steps %d-%d into %s", profiler.start,
                    profiler.stop, cfg.profile_dir)

    it = state.step
    try:
        while it < max_iterations:
            if stream is not None:
                n = 1
                batch = next(stream)
                if cta:
                    state, metrics = cta_iteration(engine, state, batch,
                                                   pipe, train_ds,
                                                   iters_per_epoch)
                else:
                    state, metrics = engine.train_step(
                        state, engine.host_batch(batch))
            else:
                # K steps per call, never across a log, val or ckpt
                # boundary
                n = min(cfg.scan_steps, cfg.log_every - it % cfg.log_every,
                        cfg.val_every - it % cfg.val_every,
                        cfg.ckpt_every - it % cfg.ckpt_every,
                        max_iterations - it)
                # K > 1: JAX's scan, CUDA graphs of the step on the card
                steps = (engine.train_steps_scan if cfg.scan_steps > 1
                         else engine.train_steps)
                state, metrics = steps(
                    state, [next(index_stream) for _ in range(n)])
            it += n
            images_seen += n * cfg.batch_size

            if profiler is not None:
                profiler.tick(it, metrics)

            if lead and (it % cfg.log_every == 0 or it == 1):
                host = {k: float(v) for k, v in metrics.items()}
                writer.add_scalars({f"info/{k}": v for k, v in host.items()},
                                   it)
                logger.info("iteration %d : %s", it, " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(host.items())))

            if it % cfg.val_every == 0:
                names = list(engine.method.eval_model_names())

                def _validate(it=it):
                    dices = []
                    for name in names:
                        tv = time.perf_counter()
                        perf = engine.validate(state, val_ds, name)
                        val_seconds.append(time.perf_counter() - tv)
                        mean_dice = float(perf[:, 0].mean())
                        mean_hd95 = float(perf[:, 1].mean())
                        writer.add_scalar(f"info/{name}_val_mean_dice",
                                          mean_dice, it)
                        writer.add_scalar(f"info/{name}_val_mean_hd95",
                                          mean_hd95, it)
                        logger.info("iteration %d : %s mean_dice %.4f "
                                    "mean_hd95 %.4f", it, name, mean_dice,
                                    mean_hd95)
                        dices.append(mean_dice)
                    return dices
                for name, mean_dice in zip(
                        names, _on_lead(mesh, _validate, len(names))):
                    if mean_dice > best_dice[name]:
                        best_dice[name] = mean_dice
                        if not lead:
                            continue
                        snap = ckpt.device_snapshot(
                            state.models[name].state_dict())
                        # reference naming: iter_{k}_dice_{d} +
                        # {model}_best_model (dual-model runs prefix the
                        # slot name)
                        prefix = "" if name == "model" else f"{name}_"
                        dice_path = os.path.join(
                            snapshot,
                            f"{prefix}iter_{it}_dice_{mean_dice:.4f}.ckpt")
                        best_name = (f"{cfg.model}_best_model.ckpt"
                                     if name == "model"
                                     else f"{cfg.model}_best_{name}.ckpt")
                        best_path = os.path.join(snapshot, best_name)

                        def _save_best(s=snap, a=dice_path, b=best_path):
                            host_sd = ckpt.to_host(s)
                            ckpt.save_weights(a, host_sd)
                            ckpt.save_weights(b, host_sd)
                        saver.submit(_save_best)

            if lead and it % cfg.ckpt_every == 0:
                snap = ckpt.device_snapshot(ckpt.state_tree(state))
                eval_names = list(engine.method.eval_model_names())
                teacher_names = list(engine.method.teacher_names)
                meta = {"best_dice": dict(best_dice)}
                if stream is not None:
                    meta["data"] = pipe.consumed_state
                if cta:
                    meta["cta"] = method.hook_state(train_ds)

                def _save_state(s=snap, k=it, m=meta):
                    host = ckpt.to_host(s)
                    ckpt.save_train_state(snapshot, host, k, meta=m)
                    # the reference's weights files beside the full state
                    # (train_mean_teacher_2D.py:295-304): each student, and
                    # each EMA teacher as ema_model_iter_{k}
                    for name in eval_names:
                        prefix = "" if name == "model" else f"{name}_"
                        ckpt.save_weights(
                            os.path.join(snapshot, f"{prefix}iter_{k}.ckpt"),
                            host["models"][name])
                    for name in teacher_names:
                        prefix = "" if name == "model" else f"{name}_"
                        ckpt.save_weights(
                            os.path.join(snapshot,
                                         f"{prefix}ema_model_iter_{k}.ckpt"),
                            host["teachers"][name])
                    ckpt.prune_old(snapshot)
                saver.submit(_save_state)
    except BaseException:
        # a failed step or validation must not strand queued checkpoint
        # jobs; drain the writer but never mask the original error. The
        # profiler stops too (JAX leaves it running), so that its hooks
        # stay off later launches.
        if profiler is not None:
            try:
                profiler.close()
            except Exception:
                logger.exception("profiler also failed during abort")
        if stream is not None:
            stream.close()
        try:
            saver.close()
        except Exception:
            logger.exception("async checkpoint writer also failed during "
                             "abort")
        writer.close()
        raise

    if stream is not None:
        stream.close()      # stops the prefetch thread
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    elapsed = time.time() - t0
    throughput = images_seen / elapsed if elapsed > 0 else 0.0
    saver.close()  # join outstanding checkpoint writes before returning
    pmesh.barrier(mesh)    # every rank returns with rank 0's files written
    if profiler is not None:
        profiler.close()
    writer.close()
    logger.info("training finished: %.2f %s/sec, best dice %s",
                throughput, "volumes" if cfg.dim == 3 else "slices",
                best_dice)
    return {"best_dice": best_dice, "iterations": it,
            "slices_per_sec": throughput, "val_seconds": val_seconds,
            "state": state}
