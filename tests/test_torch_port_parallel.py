"""The port's data parallelism on the CPU: a gloo group of 2 spawned
processes against one process on the global batch (``tests/
torch_parallel_ranks.py`` runs the same cases in both).

One module fixture spawns the group; while it runs, this process computes
the single-process results. The ranks run the CLI's ``--distributed`` fit
(4 iterations, validated and checkpointed at 2 and 4), mean_teacher from
the device store (3 steps, dropout on), mean_teacher at a batch whose
teacher half 2 does not divide, adversarial with ``loss_d``, UAMT in 2D
(the teacher's Monte-Carlo groups) and in 3D at 16^3, the sharded sliding
window and the halo forward. Tolerances: the
metrics within rel 1e-5, every parameter, buffer and EMA teacher leaf
within atol 1e-5 (float32 sums split over two ranks and gathered), the
sliding window's label maps equal, the halo forward within atol 1e-5.
"""
import glob
import os
import socket
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as R  # noqa: E402

from cvssl_tpu_torch.eval.val3d import SlidingWindowEvaluator  # noqa: E402
from cvssl_tpu_torch.parallel.halo import sharded_unet3d_forward  # noqa: E402
from cvssl_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from cvssl_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: E402
from cvssl_tpu_torch.parallel.spatial import (  # noqa: E402
    ShardedSlidingWindowEvaluator)
from cvssl_tpu_torch.train import cli  # noqa: E402
from cvssl_tpu_torch.train.config import TrainConfig  # noqa: E402

WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(ranks' results per case and rank, this process's results)."""
    out = tmp_path_factory.mktemp("parallel")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    procs = tmp.start_processes(
        R.rank_main, args=(WORLD, str(out / "init"), _free_port(), str(out)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        single = {name: case() for name, case in R.STEP_CASES.items()}
        single["cli"] = cli.main(R.cli_argv(str(out / "single_snap")),
                                 data=R.cli_data())
        single["windows"] = {}
        for name in R.WINDOW_VOLUMES:
            ev = SlidingWindowEvaluator(R.threshold_predict, (16, 16, 16), 2,
                                        8, 8, patch_batch=2, device="cpu")
            single["windows"][name] = ev.predict_volume(R.window_volume(name))
        net = R.halo_net()
        with torch.no_grad():
            single["halo"] = net(torch.from_numpy(R.halo_input())).numpy()
            single["halo_split1"] = sharded_unet3d_forward(
                net, R.halo_input(), make_mesh(device="cpu")).numpy()
    finally:
        torch.set_num_threads(threads)
        while not procs.join(timeout=300):
            pass
    ranks = {}
    for path in glob.glob(str(out / "rank*_*.npz")):
        rank, name = os.path.basename(path)[4:-4].split("_", 1)
        with np.load(path) as f:
            ranks.setdefault(name, {})[int(rank)] = dict(f)
    return ranks, single, out


@pytest.mark.parametrize("case", list(R.STEP_CASES))
def test_two_ranks_equal_one_process(runs, case):
    """Every rank ends where one process on the global batch ends: the
    metrics of every step, the parameters and BatchNorm buffers of every
    model, the EMA teachers."""
    ranks, single, _ = runs
    want = single[case]
    for rank in range(WORLD):
        got = ranks[case][rank]
        assert set(got) == set(want)
        for k, v in want.items():
            if k.startswith("metric/"):
                assert float(got[k]) == pytest.approx(float(v), rel=1e-5,
                                                      abs=1e-12), (rank, k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5,
                                           err_msg=f"rank {rank} {k}")
    steps = {k.split("/")[1] for k in want if k.startswith("metric/")}
    assert len(steps) == {"mean_teacher": 3, "uneven": 2}.get(case, 1)
    if case == "adversarial":
        assert "metric/0/loss_d" in want
    if case in ("mean_teacher", "uneven", "uamt2d", "uamt3d"):
        assert float(want["metric/0/consistency_loss"]) > 0.0


def test_distributed_cli_fit_equals_one_process(runs):
    """``--distributed`` on 2 ranks: rank 0 wrote the checkpoint files that
    one process writes, its weights equal one process's, and every rank
    ends with the same weights and best Dice."""
    ranks, single, out = runs
    snap = os.path.join("par_7_labeled", "unet")
    names = sorted(os.listdir(out / "single_snap" / snap))
    assert sorted(os.listdir(out / "cli_snap" / snap)) == names
    assert "model_iter_4.ckpt" in names and "log" in names
    want = single["cli"]["state"].models["model"].state_dict()
    for rank in range(WORLD):
        got = ranks["cli"][rank]
        assert float(got["best_dice"]) == pytest.approx(
            single["cli"]["best_dice"]["model"], abs=1e-6)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v.numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"rank {rank} {k}")
    with open(out / "cli_snap" / snap / "log.txt") as f:
        assert "iteration 4" in f.read()


@pytest.mark.parametrize("name", list(R.WINDOW_VOLUMES))
def test_sharded_sliding_window_equals_single_rank(runs, name):
    """The label maps of the windows split over 2 ranks equal the
    single-rank evaluator's (3 corners: one sentinel pad)."""
    ranks, single, _ = runs
    want = single["windows"][name]
    assert want.shape == R.WINDOW_VOLUMES[name][0]
    for rank in range(WORLD):
        np.testing.assert_array_equal(ranks["windows"][rank][name], want)
    if name != "odd_corners":
        np.testing.assert_array_equal(
            want, R.window_volume(name).astype(np.int32))


def test_sharded_corners_pad_to_the_world():
    """3 corners over 2 ranks: one ``-1`` sentinel pads the count to 4,
    rank 0 takes the first 2, rank 1 the third."""
    shares = [ShardedSlidingWindowEvaluator(
        R.threshold_predict, (16, 16, 16), 2, 8, 8,
        Mesh(r, WORLD, torch.device("cpu"))).corners((32, 16, 16))
        for r in range(WORLD)]
    assert [len(s) for s in shares] == [2, 1]
    np.testing.assert_array_equal(np.concatenate(shares)[:, 0], [0, 8, 16])


def test_halo_forward_equals_unsharded(runs):
    ranks, single, _ = runs
    want = single["halo"]
    assert want.shape == (1, 2) + R.HALO_SHAPE[2:]
    np.testing.assert_allclose(single["halo_split1"], want, rtol=0,
                               atol=1e-5)
    for rank in range(WORLD):
        np.testing.assert_allclose(ranks["misc"][rank]["halo"], want,
                                   rtol=0, atol=1e-5)


def test_mesh_rows_and_shard_batch():
    """JAX's ``shard_batch``: rank r of W takes the r-th block of rows; a
    batch W does not divide raises."""
    mesh = Mesh(1, WORLD, torch.device("cpu"))
    assert mesh.rows(6) == slice(3, 6)
    got = pmesh.shard_batch(mesh, {"image": torch.arange(6),
                                   "label": torch.arange(12).view(6, 2)})
    assert got["image"].tolist() == [3, 4, 5]
    assert got["label"].tolist() == [[6, 7], [8, 9], [10, 11]]
    with pytest.raises(ValueError, match="does not split"):
        mesh.rows(5)


def test_draw_rows_cuts_the_global_draw():
    """Inside a split call a draw over the batch is made at the global
    batch and cut to the rank's rows, so the generator moves as one
    process's; a shared draw stays whole; a draw whose first axis is not
    the rank's rows raises."""
    one = torch.Generator().manual_seed(0)
    whole = torch.rand((4, 3), generator=one)
    g = torch.Generator().manual_seed(0)
    split = pmesh.Split(Mesh(1, WORLD, torch.device("cpu")), 4, 2, 4)
    with pmesh._set_split(split):
        got = pmesh.draw_rows((2, 3), lambda s: torch.rand(s, generator=g))
        with pmesh.shared_draws():
            assert pmesh.current_split() is None
        with pytest.raises(ValueError, match="not the batch"):
            pmesh.draw_rows((3,), lambda s: torch.rand(s, generator=g))
    assert torch.equal(got, whole[2:])
    assert pmesh.current_split() is None
    g = torch.Generator().manual_seed(0)
    with pmesh._set_split(split):
        pmesh.draw_rows((2, 3), lambda s: torch.rand(s, generator=g))
    assert torch.equal(g.get_state(), one.get_state())


def test_halo_forward_needs_h_divisible_by_16_world():
    with pytest.raises(ValueError, match="16"):
        sharded_unet3d_forward(R.halo_net(), np.zeros((1, 1, 16, 16, 16),
                                                      np.float32),
                               Mesh(0, WORLD, torch.device("cpu")))


def test_config_in_a_group(runs):
    """Inside the group ``num_devices`` is the world size, and a batch that
    2 ranks do not split raises."""
    ranks, _, _ = runs
    for rank in range(WORLD):
        misc = ranks["misc"][rank]
        assert int(misc["num_devices"]) == WORLD
        assert "does not split over 2 ranks" in str(misc["batch_error"])


def test_rank_zero_work_reaches_every_rank(runs):
    """``fit``'s work on rank 0 alone (validation, the entropy seed): its
    value is rank 0's on every rank, and when it raises on rank 0 the other
    rank raises too instead of waiting."""
    ranks, _, _ = runs
    for rank in range(WORLD):
        misc = ranks["misc"][rank]
        assert float(misc["lead_value"]) == 7.0
        assert str(misc["lead_error"]) == ("ZeroDivisionError" if rank == 0
                                           else "RuntimeError")


def test_config_errors_outside_a_group():
    with pytest.raises(ValueError, match="torchrun"):
        TrainConfig(num_devices=2)
    assert TrainConfig(num_devices=1).num_devices == 1
    with pytest.raises(NotImplementedError, match="dcn"):
        TrainConfig(dcn_slices=2)
    with pytest.raises(NotImplementedError, match="dcn"):
        cli.config_from_args(cli.build_parser().parse_args(
            ["--dcn_slices", "2"]))
    with pytest.raises(NotImplementedError, match="dcn"):
        make_mesh(dcn=2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, device="cpu")
