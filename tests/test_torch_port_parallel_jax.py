"""JAX's data-parallel mean-teacher step on a 2-device mesh (2 of
conftest's 8 virtual CPU devices, ``Engine(num_devices=2)``) against the
port's step on a gloo group of 2 processes, from the same weights
(``models/convert.py``), batch and teacher noise, dropout zeroed (the two
packages draw from different generators). Tolerances are
``tests/test_torch_port_step.py``'s: the loss within rel 1e-5; parameters
and the EMA teacher within 2e-2 of the largest update, rtol 1e-6; the
BatchNorm buffers rtol 1e-4, atol 1e-5."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from cvssl_tpu.models.unet import UNet as JUNet
from cvssl_tpu.train.config import TrainConfig as JConfig
from cvssl_tpu.train.engine import Engine as JEngine
from cvssl_tpu_torch.models.convert import state_dict_from_flax

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as R  # noqa: E402
from test_torch_port_step import _sub, _tree  # noqa: E402

WORLD = 2
B, LB, HW, C = 4, 2, 32, 4
STEP = 1000   # consistency term live


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_jax")
    rng = np.random.default_rng(0)
    image = rng.normal(0.5, 0.25, (B, HW, HW, 1)).astype(np.float32)
    label = rng.integers(0, C, (B, HW, HW)).astype(np.int32)
    noise = np.clip(0.1 * rng.normal(size=(B - LB, HW, HW, 1)),
                    -0.2, 0.2).astype(np.float32)

    jcfg = JConfig(method="mean_teacher", model="unet", num_classes=C,
                   batch_size=B, labeled_bs=LB, patch_size=(HW, HW),
                   labeled_slices_override=LB, dtype="float32",
                   s2d_levels=0, num_devices=WORLD)
    jeng = JEngine(jcfg)
    assert jeng.mesh.devices.size == WORLD
    jeng.modules = {"model": JUNet(in_chns=1, num_classes=C,
                                   features=R.FEATURES, dropout=(0.0,) * 5)}
    state = jeng.init_state(jax.random.PRNGKey(0),
                            {"image": image, "label": label})
    state = state.replace(step=jnp.int32(STEP))
    p0 = jax.tree_util.tree_map(np.asarray, state.params["model"])
    bs0 = jax.tree_util.tree_map(np.asarray, state.batch_stats["model"])
    sd = state_dict_from_flax("unet", p0, bs0)
    np.savez(out / "in.npz", image=np.moveaxis(image, -1, 1).copy(),
             label=label.astype(np.int64),
             noise=np.moveaxis(noise, -1, 1).copy(), step=np.int64(STEP),
             batch_size=np.int64(B), labeled_bs=np.int64(LB),
             **{f"sd/{k}": v.numpy() for k, v in sd.items()})

    procs = tmp.start_processes(
        R.rank_main_jax, args=(WORLD, str(out / "init"), str(out / "in.npz"),
                               str(out)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        mp = pytest.MonkeyPatch()
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=None: jnp.asarray(noise))
        try:
            jstate, jmetrics = jeng.train_step(
                state, {"image": image, "label": label})
            jmetrics = {k: float(v) for k, v in jmetrics.items()}
        finally:
            mp.undo()
    finally:
        while not procs.join(timeout=300):
            pass
    ranks = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}_jax_step.npz") as f:
            ranks.append(dict(f))
    return dict(p0=p0, jstate=jstate, jmetrics=jmetrics, ranks=ranks)


def _port_tree(snap, kind):
    prefix = f"{kind}/model/"
    return _tree({k[len(prefix):]: v for k, v in snap.items()
                  if k.startswith(prefix)})


def test_loss_matches_jax_mesh_step(pair):
    j = pair["jmetrics"]
    assert j["consistency_loss"] > 0.0
    for snap in pair["ranks"]:
        for k in ("loss", "loss_ce", "loss_dice", "consistency_loss"):
            assert float(snap[f"metric/0/{k}"]) == pytest.approx(
                j[k], rel=1e-5), k


def test_sgd_update_and_ema_teacher_match_jax_mesh_step(pair):
    js, p0 = pair["jstate"], pair["p0"]
    for snap in pair["ranks"]:
        for want, kind in ((js.params["model"], "model"),
                           (js.teacher_params["model"], "teacher")):
            got = _port_tree(snap, kind)[0]
            scale = max(float(np.abs(d).max())
                        for d in jax.tree_util.tree_leaves(_sub(want, p0)))
            assert scale > 0.0
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(got)):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                           atol=2e-2 * scale)


def test_batchnorm_buffers_match_jax_mesh_step(pair):
    js = pair["jstate"]
    for snap in pair["ranks"]:
        for want, kind in ((js.batch_stats["model"], "model"),
                           (js.teacher_batch_stats["model"], "teacher")):
            got = _port_tree(snap, kind)[1]
            for a, b in zip(jax.tree_util.tree_leaves(want),
                            jax.tree_util.tree_leaves(got)):
                np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                           atol=1e-5)
