"""The port's pixel-packed conv (``cvssl_tpu_torch/ops/conv3x3_p8.py``) on
the CPU, where each public function computes its plain version: against
the JAX kernels in interpret mode and against ``F.conv2d``, on the shapes
of ``tests/test_pallas_conv.py`` with tile_h = H/2, at rtol = atol = 1e-4
(the JAX test's own tolerance: float32 sums of 144 products in another
order), and on a ragged width (W % 16 = 8, half of the tensor-core
kernel's last 16-pixel strip outside the image). The CUDA kernels run only
on the card (``chip_smoke.py``); the split-TF32 arithmetic of
``conv3x3_p8_db``'s kernel is emulated here in numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_conv_variants as CV
from cvssl_tpu.ops import pallas_conv as J
from cvssl_tpu_torch.ops import _cuda_build
from cvssl_tpu_torch.ops import conv3x3_p8 as T

NAMES = ["conv3x3_p8", "conv3x3_p8_dma", "conv3x3_p8_db"]
SHAPES = [(2, 32, 32, 16), (1, 64, 48, 16), (2, 32, 40, 16)]
CONV_REL_TOL = 1e-5  # chip_smoke.py's gate, of the largest output element


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


def _tf32_rna(a):
    """cvt.rna.tf32.f32 on the int32 view: round to nearest, ties away from
    zero, to 10 mantissa bits (the kernel's ``tf32_rna``)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_cut(a):
    """A float32 operand as the tensor cores read it for TF32: its top 19
    bits (the kernel hands them x's lo part unrounded)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_conv(x, k, passes):
    """The kernel's products: each pass a conv of TF32 operands, whose
    products are exact in float64, summed in float64 (the tensor cores'
    float32 sums add the rest of the kernel's error, not emulated here).
    hi(v) = tf32_rna(v); lo(k) = tf32_rna(k - hi(k)); lo(x) = x - hi(x),
    cut to TF32 by the tensor cores."""
    xh, kh = _tf32_rna(x), _tf32_rna(k)
    xl, kl = _tf32_cut(x - xh), _tf32_rna(k - kh)
    terms = [(xh, kh), (xh, kl), (xl, kh)][:passes]
    return sum(T.conv3x3_p8_plain(torch.from_numpy(a).double(),
                                  torch.from_numpy(b).double())
               for a, b in terms)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's spacing at 1
    got = _tf32_rna(np.array([1 + ulp / 4, 1 + ulp / 2, 1 + 3 * ulp / 4,
                              -(1 + ulp / 2), 3.0], np.float32))
    np.testing.assert_array_equal(
        got, np.array([one, one + ulp, one + ulp, -(one + ulp), 3.0],
                      np.float32))
    x = np.random.default_rng(5).normal(size=1000).astype(np.float32)
    hi = _tf32_rna(x)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    lo = _tf32_cut(x - hi)
    np.testing.assert_allclose(hi + lo, x, rtol=2.0 ** -21, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype,passes,meets", [
    ("float32", 3, True),    # the kernel, f32 input
    ("bfloat16", 2, True),   # the kernel, bf16 input
    ("float32", 1, False),   # one TF32 pass: why the split is there
    ("float32", 2, False),   # f32 input needs lo(x) hi(k) too
    ("bfloat16", 1, False),  # bf16 input needs lo(k)
])
def test_split_tf32_meets_the_gate(shape, dtype, passes, meets):
    x, k = _inputs(shape, seed=3)
    k = 0.1 * k
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(_tf32_rna(x), x)  # exact in TF32
    want = T.conv3x3_p8_plain(torch.from_numpy(x).double(),
                              torch.from_numpy(k).double())
    got = _tf32_conv(x, k, passes)
    rel = float((got - want).abs().max() / want.abs().max())
    if meets:
        assert rel <= 1e-6, rel
    else:
        assert rel > CONV_REL_TOL, rel


def test_db_kernel_is_split_tf32_mma():
    """Variant 2's kernel computes on the tensor cores only: mma.sync .tf32
    in three passes for f32 input and two for bf16, no CUDA-core path."""
    src = _cuda_build.source("conv3x3_p8").read_text()
    body = src[src.index("conv_halo_db("):src.index("cudaError_t launch(")]
    assert "mma_rows<T, R_DB>" in body and "compute_tile" not in body
    rows = src[src.index("void mma_rows("):src.index("conv_halo_db(")]
    assert rows.count("mma_tf32(") == 3 and "if (SPLIT_A)" in rows
    assert "fmaf" not in rows
    assert ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
            in src)


@pytest.mark.parametrize("name", sorted(CV.VARIANTS))
def test_design_variants_apply_to_the_source(name):
    """Each design experiment of ``chip_conv_variants.py`` still finds the
    text it replaces in the kernel source."""
    src = _cuda_build.source("conv3x3_p8").read_text()
    for old, _ in CV.VARIANTS[name][1]:
        assert old in src, old
