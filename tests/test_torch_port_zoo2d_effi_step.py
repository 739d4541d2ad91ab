"""One mean_teacher engine step of EffiUNet-B3 against the JAX package on
the CPU, on ``test_torch_port_zoo2d_steps.py``'s harness and checks
(batch 4 = 2 + 2 at 64^2, 4 classes, float64, every draw injected: the
teacher's noise and the 19 drop-connects of each forward)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_port_zoo2d_steps as zs  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def step():
    return zs.run_step("efficient_unet")


def test_effiunet_step_loss_and_draws(step):
    zs.check_loss_and_draws(step)


def test_effiunet_step_gradients(step):
    zs.check_gradients(step)


def test_effiunet_step_updates_teacher_and_statistics(step):
    zs.check_updates_teacher_and_statistics(step)
