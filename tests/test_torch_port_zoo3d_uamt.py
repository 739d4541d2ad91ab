"""One engine step against the JAX package on the CPU, through
``test_torch_port_zoo3d_steps.py``'s checks: mean_teacher on nnUNet (3D at
(4, 64, 64), 2D at 64^2 and 4 classes), and uamt on VNet (its BatchNorm
teacher: one pass over u, then T / 2 passes over 2u volumes, without its
dropout) and on VoxResNet (stats-free: one pass over the (T + 1) * u
volumes)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_zoo3d_steps import (CASES,  # noqa: E402
                                         check_draws_and_passes,
                                         check_gradients,
                                         check_loss_and_metrics,
                                         check_updates_and_statistics,
                                         run_step)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=CASES[3:], ids=lambda c: "-".join(c))
def pair(request):
    return request.param, run_step(*request.param)


def test_zoo_loss_and_metrics_match_jax_step(pair):
    check_loss_and_metrics(pair)


def test_zoo_gradients_match_jax_step(pair):
    check_gradients(pair)


def test_zoo_updates_teachers_and_statistics_match_jax_step(pair):
    check_updates_and_statistics(pair)


def test_zoo_draws_and_teacher_passes(pair):
    check_draws_and_passes(pair)
