"""The control, the plain reference put in the program's place and
computed in fp8 (the nearest precision below the configurations'
bfloat16), comes out as not correct. At the cells' own sizes on the card
it does so on every seed read (PERF.md); here at the small sizes on
seeds 1-3."""
import pytest

CONTROL = {"precision": "fp8"}


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("name", ["acdc2d-mt-graphed",
                                  "brats3d-uamt-graphed", "brats3d-window"])
def test_control_is_not_correct(name, seed, small):
    result, checks = small(name, seed=seed, control=CONTROL)
    assert not result["correct"], checks
