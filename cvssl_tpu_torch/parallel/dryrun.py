"""The multi-rank dry run (the port's counterpart of JAX's
``__graft_entry__.py::dryrun_multichip``): the same six checks at the same
small sizes, each rank of a process group running its share.

    from cvssl_tpu_torch.parallel.mesh import distributed_init
    from cvssl_tpu_torch.parallel.dryrun import dryrun_multichip
    distributed_init(...)            # or torchrun + distributed_init()
    dryrun_multichip(2, "cuda")

It runs inside a process group that the caller has set up, of ``n``
ranks.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _one_step(method, n, patch, device, num_classes=4, model="unet",
              model2=None, vit_kwargs=None, dim=2):
    """One full train step of ``method`` (batch 2 n = n labeled + n
    unlabeled, random data from seed 0) on the group's ranks; returns
    (engine, host metrics)."""
    from cvssl_tpu_torch.train.config import TrainConfig
    from cvssl_tpu_torch.train.engine import Engine

    batch_size = 2 * n
    kw = {"model2": model2} if model2 else {}
    cfg = TrainConfig(
        method=method, model=model, num_classes=num_classes,
        batch_size=batch_size, labeled_bs=batch_size // 2,
        patch_size=patch, max_iterations=10, dim=dim,
        labeled_slices_override=batch_size // 2, num_devices=n,
        vit_kwargs=vit_kwargs, **kw)
    engine = Engine(cfg, device=device)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.normal(
            size=(batch_size, 1) + tuple(patch)).astype(np.float32)),
        "label": torch.from_numpy(rng.integers(
            0, num_classes, (batch_size,) + tuple(patch)).astype(np.int32))}
    batch = {k: v.to(engine.device) for k, v in batch.items()}
    state = engine.init_state(seed=0)
    state, metrics = engine.train_step(state, batch)
    host = {k: float(v) for k, v in metrics.items()}
    if state.step != 1 or not math.isfinite(host["loss"]):
        raise RuntimeError(f"{method}: step {state.step}, metrics {host}")
    return engine, host


def dryrun_multichip(n: int, device="cuda") -> None:
    """Run the checks of JAX's ``dryrun_multichip`` on the ``n`` ranks of
    the current process group: a data-parallel mean-teacher step, the
    dual-optimizer cross_teaching step (UNet + a thin SwinUnet at 224^2),
    the adversarial step with its discriminator phase, the sliding window
    with its windows split over the ranks, a UAMT-3D step at 16^3, and
    UNet3D's forward with its H axis split over the ranks."""
    from cvssl_tpu_torch.models import net_factory_3d
    from cvssl_tpu_torch.parallel.halo import sharded_unet3d_forward
    from cvssl_tpu_torch.parallel.mesh import make_mesh
    from cvssl_tpu_torch.parallel.spatial import ShardedSlidingWindowEvaluator

    mesh = make_mesh(n, device=device)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    engine, m = _one_step("mean_teacher", n, (32, 32), device)
    say(f"dryrun_multichip({n}): mean_teacher ok, loss={m['loss']:.4f}, "
        f"mesh={engine.mesh.world} ranks on {engine.device}")

    # JAX's thin SwinUnet also asks for ``use_checkpoint`` (remat: the same
    # values for less memory), which the port's SwinUnet does not take
    _, m = _one_step("cross_teaching", n, (224, 224), device,
                     model2="ViT_Seg",
                     vit_kwargs=dict(embed_dim=24, num_heads=(1, 2, 4, 8)))
    say(f"dryrun_multichip({n}): cross_teaching(cnn+swin) ok, "
        f"loss={m['loss']:.4f}")

    _, m = _one_step("adversarial", n, (64, 64), device)
    if "loss_d" not in m:
        raise RuntimeError(f"adversarial: no loss_d in {m}")
    say(f"dryrun_multichip({n}): adversarial ok, loss={m['loss']:.4f}, "
        f"loss_d={m['loss_d']:.4f}")

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = net_factory_3d("unet_3D", in_chns=1, class_num=2)
    net = net.to(mesh.device).eval()

    def predict(x):
        with torch.no_grad():
            return torch.softmax(net(x).float(), dim=1)

    ev = ShardedSlidingWindowEvaluator(predict, (16, 16, 16), 2, 8, 8,
                                       mesh=mesh)
    vol = np.random.default_rng(0).normal(size=(24, 28, 28)).astype(
        np.float32)
    pred = ev.predict_volume(vol)
    if pred.shape != vol.shape:
        raise RuntimeError(f"sliding window: {pred.shape} != {vol.shape}")
    say(f"dryrun_multichip({n}): sharded_sliding_window ok, "
        f"pred classes={sorted(np.unique(pred).tolist())}")

    _, m = _one_step("uamt", n, (16, 16, 16), device, num_classes=2,
                     model="unet_3D", dim=3)
    say(f"dryrun_multichip({n}): uamt_3d ok, loss={m['loss']:.4f}")

    hvol = np.random.default_rng(1).normal(
        size=(1, 1, 16, 16 * n, 16)).astype(np.float32)
    out = sharded_unet3d_forward(net, hvol, mesh)
    if tuple(out.shape) != (1, 2, 16, 16 * n, 16):
        raise RuntimeError(f"halo forward: shape {tuple(out.shape)}")
    say(f"dryrun_multichip({n}): halo_sharded_unet3d ok, "
        f"out={tuple(out.shape)}")
