"""nnUNet (3D at (4, 64, 64), and the 2D configuration at 64^2) against the
JAX package on the CPU, through ``test_torch_port_zoo3d.py``'s checks: the
eval and train forwards, gradients and the converter's round trip; and its
rule that the patch be a multiple of the pools' product."""
import os
import sys

import pytest
import torch

from cvssl_tpu_torch.models import nnunet as tnnunet

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_port_zoo3d import (check_draws_and_stats,  # noqa: E402
                                   check_forward, check_gradients,
                                   check_round_trip, zoo_pair)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["nnUNet_3d", "nnUNet_2d"])
def zoo(request):
    return zoo_pair(request.param)


def test_zoo_forward_matches_flax_eval_and_train(zoo):
    check_forward(zoo)


def test_zoo_draws_and_batch_statistics_match_flax(zoo):
    check_draws_and_stats(zoo)


def test_zoo_gradients_match_flax(zoo):
    check_gradients(zoo)


def test_zoo_convert_round_trip_is_exact(zoo):
    check_round_trip(zoo)


def test_nnunet_raises_on_a_patch_the_pools_do_not_divide():
    """3D default pools: depth % 4, plane % 64. JAX fails at a concatenate
    at 96^3; the port raises first, with the rule."""
    net = tnnunet.GenericUNet3D(1, 2, max_features=32)
    assert net.divisor() == (4, 64, 64)
    with pytest.raises(ValueError, match="multiple of the pools"):
        net(torch.zeros(1, 1, 4, 96, 96))
    assert net(torch.zeros(1, 1, 4, 64, 128)).shape == (1, 2, 4, 64, 128)
