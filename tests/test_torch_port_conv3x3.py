"""The port's pixel-packed conv (``cvssl_tpu_torch/ops/conv3x3_p8.py``) on
the CPU, where each public function computes its plain version: against
the JAX kernels in interpret mode and against ``F.conv2d``, on the shapes
of ``tests/test_pallas_conv.py`` with tile_h = H/2, at rtol = atol = 1e-4
(the JAX test's own tolerance: float32 sums of 144 products in another
order). The CUDA kernels run only on the card (``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvssl_tpu.ops import pallas_conv as J
from cvssl_tpu_torch.ops import _cuda_build
from cvssl_tpu_torch.ops import conv3x3_p8 as T

NAMES = ["conv3x3_p8", "conv3x3_p8_dma", "conv3x3_p8_db"]
SHAPES = [(2, 32, 32, 16), (1, 64, 48, 16)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(3, 3, 16, 16)).astype(np.float32))


def test_banded_mats_equal_jax():
    _, k = _inputs((1, 8, 8, 16))
    want = J.build_banded_mats(jnp.asarray(k))
    got = T.build_banded_mats(torch.from_numpy(k))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_jax_interpret_and_conv2d(name, shape):
    x, k = _inputs(shape)
    tile_h = shape[1] // 2
    got = getattr(T, name)(torch.from_numpy(x), torch.from_numpy(k),
                           tile_h=tile_h)
    assert got.dtype == torch.float32 and got.shape == shape
    want = getattr(J, name)(jnp.asarray(x), jnp.asarray(k), interpret=True,
                            tile_h=tile_h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    ref = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(k).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bf16_input_widens_to_float32():
    """bf16 inputs are widened, not computed in bf16: the result equals the
    float32 conv of the bf16-rounded input exactly, and is float32."""
    x, k = _inputs(SHAPES[0], seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = T.conv3x3_p8(xb, torch.from_numpy(k), tile_h=16)
    want = T.conv3x3_p8(xb.float(), torch.from_numpy(k), tile_h=16)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_float64_plain_version_is_the_reference():
    x, k = _inputs(SHAPES[1], seed=2)
    got = T.conv3x3_p8_plain(torch.from_numpy(x).double(),
                             torch.from_numpy(k).double())
    ref = F.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                   torch.from_numpy(k).double().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("bad", ["channels", "width", "height", "kernel",
                                 "grad_x", "grad_k"])
def test_contract_raises(name, bad):
    shape, kshape, tile_h = [2, 32, 32, 16], (3, 3, 16, 16), 16
    if bad == "channels":
        shape[3] = 8
    elif bad == "width":
        shape[2] = 36           # not a multiple of the 8-pixel group
    elif bad == "height":
        tile_h = 24             # 32 % 24 != 0
    elif bad == "kernel":
        kshape = (3, 3, 16, 8)
    x, k = torch.zeros(shape), torch.zeros(kshape)
    if bad == "grad_x":
        x.requires_grad_(True)
    if bad == "grad_k":
        k.requires_grad_(True)
    with pytest.raises(ValueError):
        getattr(T, name)(x, k, tile_h=tile_h)


def test_launch_counts_untouched_on_cpu():
    """On a CPU tensor the wrappers compute the plain version and count no
    kernel launch; the CUDA source and its build path exist."""
    T.reset_launches()
    x, k = _inputs(SHAPES[0])
    for name in NAMES:
        getattr(T, name)(torch.from_numpy(x), torch.from_numpy(k),
                         tile_h=16)
    assert T.LAUNCHES == {name: 0 for name in NAMES}
    src = _cuda_build.source("conv3x3_p8").read_text()
    assert "extern \"C\"" in src and "conv3x3_p8_launch" in src
    assert _cuda_build.BUILD_DIR.parts[-2:] == ("build", "kernels")
