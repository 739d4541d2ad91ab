"""The port's data-parallel cases, run the same way by one process and by
each rank of a gloo group of CPU processes (``tests/test_torch_port_
parallel*.py``). Imports no JAX: the ranks are spawned processes, and this
module is all they import of the tests.

Each case returns a dict of numpy arrays: every step's metrics, and the
parameters and buffers of every model and teacher after the steps.
"""
import os

import numpy as np
import torch

C = 4
FEATURES = (4, 8, 16, 32, 64)
HW = 32
START_STEP = 1000     # consistency weight live: sigmoid_rampup(5, 200) > 0
FEATURE_SCALE_3D = 16  # UNet3D filters (4, 8, 16, 32, 64)


class Slices:
    """``n`` raw slices of (28, 32) from seeds, for the device store."""

    def __init__(self, n=12, classes=C):
        self.n, self.classes = n, classes

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, (28, HW)).astype(np.float32),
                "label": r.integers(0, self.classes,
                                    (28, HW)).astype(np.uint8)}


def val_volumes(n=2):
    """Uniform val volumes of 3 slices at the patch size."""
    r = np.random.default_rng(100)
    return [{"image": r.normal(0.5, 0.2, (3, HW, HW)).astype(np.float32),
             "label": r.integers(0, C, (3, HW, HW)).astype(np.uint8)}
            for _ in range(n)]


def config(**kw):
    from cvssl_tpu_torch.train.config import TrainConfig
    base = dict(method="mean_teacher", model="unet", num_classes=C,
                batch_size=4, labeled_bs=2, patch_size=(HW, HW),
                labeled_slices_override=4, dtype="float32", s2d_levels=0)
    base.update(kw)
    return TrainConfig(**base)


def narrow(cfg):
    """``cfg.method`` on narrow nets, dropout kept at its defaults (the
    draws are part of what the ranks must reproduce)."""
    from cvssl_tpu_torch.models import net_factory, net_factory_3d
    from cvssl_tpu_torch.train.methods.base import get_method

    class Narrow(type(get_method(cfg.method, cfg))):
        def _factory(self, net_type):
            if self.cfg.dim == 3:
                return net_factory_3d(net_type, 1, self.cfg.num_classes,
                                      feature_scale=FEATURE_SCALE_3D)
            return net_factory(net_type, 1, self.cfg.num_classes,
                               features=FEATURES)
    return Narrow(cfg)


def snapshot(state, metrics_per_step) -> dict:
    out = {}
    for i, m in enumerate(metrics_per_step):
        for k, v in m.items():
            out[f"metric/{i}/{k}"] = np.float64(float(v))
    for kind, models in (("model", state.models),
                         ("teacher", state.teachers)):
        for name, model in models.items():
            for k, v in model.state_dict().items():
                out[f"{kind}/{name}/{k}"] = v.detach().cpu().numpy()
    return out


def batches(cfg, n, seed):
    """``n`` batches of random images and labels at the config's shape."""
    r = np.random.default_rng(seed)
    shape = (cfg.batch_size, 1) + tuple(cfg.patch_size)
    return [{"image": torch.from_numpy(
                 r.normal(0.5, 0.25, shape).astype(np.float32)),
             "label": torch.from_numpy(r.integers(
                 0, cfg.num_classes, (cfg.batch_size,)
                 + tuple(cfg.patch_size)).astype(np.int64))}
            for _ in range(n)]


def case_mean_teacher():
    """3 mean-teacher steps from the device store (augmentation and
    dropout drawn from the step's generator), batch 4 = 2 + 2."""
    from cvssl_tpu_torch.data.device_store import DeviceSliceStore
    from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
    from cvssl_tpu_torch.train.engine import Engine

    cfg = config()
    eng = Engine(cfg, method=narrow(cfg), device="cpu")
    eng.attach_store(DeviceSliceStore(Slices(), (HW, HW), device="cpu"))
    state = eng.init_state()
    state.step = START_STEP
    stream = TwoStreamBatchSampler(range(4), range(4, 12), 4, 2,
                                   rng=np.random.default_rng(0)).epochs()
    metrics = []
    for _ in range(3):
        state, m = eng.train_steps(state, [next(stream)])
        metrics.append(m)
    return snapshot(state, metrics)


def case_uneven():
    """2 mean-teacher steps at batch 6 = 3 + 3: the student's 6 rows split
    over 2 ranks, the teacher's 3 run whole on each."""
    from cvssl_tpu_torch.train.engine import Engine

    cfg = config(batch_size=6, labeled_bs=3, labeled_slices_override=3)
    eng = Engine(cfg, method=narrow(cfg), device="cpu")
    state = eng.init_state()
    state.step = START_STEP
    metrics = []
    for b in batches(cfg, 2, seed=1):
        state, m = eng.train_step(state, b)
        metrics.append(m)
    return snapshot(state, metrics)


def case_adversarial():
    """1 adversarial step with its discriminator phase (``loss_d``)."""
    from cvssl_tpu_torch.train.engine import Engine

    cfg = config(method="adversarial")
    eng = Engine(cfg, method=narrow(cfg), device="cpu")
    state = eng.init_state()
    state.step = START_STEP
    state, m = eng.train_step(state, batches(cfg, 1, seed=2)[0])
    return snapshot(state, [m])


def case_uamt2d():
    """1 UAMT step at 32^2 (the BatchNorm teacher's Monte-Carlo passes:
    T / 2 = 4 groups of 2 * 2, each split 2 + 2). The output conv of
    student and teacher is scaled by 8, so that the teacher is sure at some
    sites and the masked consistency term is live."""
    from cvssl_tpu_torch.train.engine import Engine

    cfg = config(method="uamt")
    eng = Engine(cfg, method=narrow(cfg), device="cpu")
    state = eng.init_state()
    state.step = START_STEP
    with torch.no_grad():
        for m in (state.models["model"], state.teachers["model"]):
            for p in m.decoder.out_conv.parameters():
                p.mul_(8.0)
    state, m = eng.train_step(state, batches(cfg, 1, seed=5)[0])
    return snapshot(state, [m])


def case_uamt3d():
    """1 UAMT-3D step at 16^3 on a narrow UNet3D, batch 4 = 2 + 2 (the MC
    teacher's one pass over (T + 1) * 2 = 18 volumes split 9 + 9)."""
    from cvssl_tpu_torch.train.engine import Engine

    cfg = config(method="uamt", model="unet_3D", dim=3, num_classes=2,
                 patch_size=(16, 16, 16), labeled_slices_override=None)
    eng = Engine(cfg, method=narrow(cfg), device="cpu")
    state = eng.init_state()
    state.step = START_STEP
    state, m = eng.train_step(state, batches(cfg, 1, seed=3)[0])
    return snapshot(state, [m])


STEP_CASES = {"mean_teacher": case_mean_teacher, "uneven": case_uneven,
              "adversarial": case_adversarial, "uamt2d": case_uamt2d,
              "uamt3d": case_uamt3d}

# the sliding window at JAX's test shapes (tests/test_spatial_parallel.py),
# and one of 3 corners, which 2 ranks do not divide
WINDOW_VOLUMES = {"jax_a": ((24, 24, 16), 0), "jax_b": ((16, 16, 24), 1),
                  "odd_corners": ((32, 16, 16), 2)}


def window_volume(name):
    shape, seed = WINDOW_VOLUMES[name]
    r = np.random.default_rng(seed)
    return (r.uniform(0, 1, shape) > 0.5).astype(np.float32)


def threshold_predict(x):
    """Class 1 where the voxel is above 0.5 (JAX's test predictor)."""
    fg = (x[:, 0] > 0.5).float()
    return torch.stack([1 - fg, fg], dim=1)


HALO_SHAPE = (1, 1, 16, 32, 16)


def halo_net():
    from cvssl_tpu_torch.models import net_factory_3d
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = net_factory_3d("unet_3D", 1, 2, feature_scale=FEATURE_SCALE_3D)
    return net.eval()


def halo_input():
    return np.random.default_rng(4).normal(size=HALO_SHAPE).astype(
        np.float32)


def cli_argv(snapshot_root):
    """A 4-iteration mean-teacher fit of the CLI, validated and
    checkpointed at 2 and 4."""
    return ["--exp", "par", "--method", "mean_teacher", "--max_iterations",
            "4", "--batch_size", "4", "--labeled_bs", "2",
            "--labeled_slices", "4", "--patch_size", str(HW), str(HW),
            "--val_every", "2", "--ckpt_every", "2", "--device", "cpu",
            "--dtype", "float32", "--snapshot_root", snapshot_root]


def cli_data():
    from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
    sampler = TwoStreamBatchSampler(list(range(4)), list(range(4, 12)), 4, 2,
                                    np.random.default_rng(1337))
    return Slices(), sampler, val_volumes()


def rank_main(rank, world, init_file, port, out_dir):
    """One rank: the CLI's --distributed fit from a torchrun environment
    (its own group, destroyed when the fit ends), then a gloo group on
    ``init_file`` for the step cases, the sliding window, the halo forward,
    the config's batch check and the work ``fit`` runs on rank 0 alone.
    Results go to ``out_dir/rank{r}_*.npz``."""
    torch.set_num_threads(1)
    from cvssl_tpu_torch.parallel.halo import sharded_unet3d_forward
    from cvssl_tpu_torch.parallel.mesh import distributed_init
    from cvssl_tpu_torch.parallel.spatial import ShardedSlidingWindowEvaluator
    from cvssl_tpu_torch.train import cli
    from cvssl_tpu_torch.train.engine import _on_lead

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    result = cli.main(cli_argv(os.path.join(out_dir, "cli_snap")) +
                      ["--distributed"], data=cli_data())
    np.savez(os.path.join(out_dir, f"rank{rank}_cli.npz"),
             best_dice=np.float64(result["best_dice"]["model"]),
             **{k: v.detach().numpy() for k, v in
                result["state"].models["model"].state_dict().items()})

    mesh = distributed_init(init_method=f"file://{init_file}",
                            world_size=world, rank=rank, device="cpu")
    for name, case in STEP_CASES.items():
        np.savez(os.path.join(out_dir, f"rank{rank}_{name}.npz"), **case())
    windows = {}
    for name in WINDOW_VOLUMES:
        ev = ShardedSlidingWindowEvaluator(threshold_predict, (16, 16, 16),
                                           2, 8, 8, mesh)
        windows[name] = ev.predict_volume(window_volume(name))
    np.savez(os.path.join(out_dir, f"rank{rank}_windows.npz"), **windows)
    out = sharded_unet3d_forward(halo_net(), halo_input(), mesh)
    try:
        config(batch_size=3, labeled_bs=1)
        batch_error = ""
    except ValueError as e:
        batch_error = str(e)
    # fit's work on rank 0 alone (validation, the entropy seed): its value
    # reaches every rank, and its failure fails every rank
    lead_value = _on_lead(mesh, lambda: [float(rank + 7)], 1)[0]
    try:
        _on_lead(mesh, lambda: [1 / 0], 1)
        lead_error = ""
    except (ZeroDivisionError, RuntimeError) as e:
        lead_error = type(e).__name__
    np.savez(os.path.join(out_dir, f"rank{rank}_misc.npz"),
             halo=out.numpy(), batch_error=np.str_(batch_error),
             num_devices=np.int64(config(num_devices=2).num_devices),
             lead_value=np.float64(lead_value),
             lead_error=np.str_(lead_error))
    torch.distributed.destroy_process_group()


def rank_main_jax(rank, world, init_file, in_npz, out_dir):
    """One rank of the JAX comparison: one mean-teacher step (narrow UNet,
    dropout zeroed) from the weights and the teacher noise in ``in_npz``,
    at the step and batch there, on a gloo group of ``world``."""
    torch.set_num_threads(1)
    from cvssl_tpu_torch.models.unet import UNet
    from cvssl_tpu_torch.parallel.mesh import distributed_init
    from cvssl_tpu_torch.train.engine import Engine
    from cvssl_tpu_torch.train.methods.mean_teacher import MeanTeacher
    from cvssl_tpu_torch.train.state import StepCtx

    distributed_init(init_method=f"file://{init_file}", world_size=world,
                     rank=rank, device="cpu")
    with np.load(in_npz) as f:
        inp = dict(f)

    class NarrowMT(MeanTeacher):
        def build_models(self):
            return {"model": UNet(1, C, features=FEATURES,
                                  dropout=(0.0,) * 5)}

    cfg = config(batch_size=int(inp["batch_size"]),
                 labeled_bs=int(inp["labeled_bs"]),
                 labeled_slices_override=int(inp["labeled_bs"]),
                 num_devices=world)
    eng = Engine(cfg, method=NarrowMT(cfg), device="cpu")
    state = eng.init_state()
    sd = {k[3:]: torch.from_numpy(v) for k, v in inp.items()
          if k.startswith("sd/")}
    state.models["model"].load_state_dict(sd)
    state.teachers["model"].load_state_dict(sd)
    state.step = int(inp["step"])
    noise = torch.from_numpy(inp["noise"])
    StepCtx.normal = lambda self, shape, device: noise
    state, m = eng.train_step(state, {
        "image": torch.from_numpy(inp["image"]),
        "label": torch.from_numpy(inp["label"])})
    np.savez(os.path.join(out_dir, f"rank{rank}_jax_step.npz"),
             **snapshot(state, [m]))
    torch.distributed.destroy_process_group()
