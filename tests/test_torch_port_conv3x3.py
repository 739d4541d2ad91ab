"""The port's pixel-packed conv (``cvssl_tpu_torch/ops/conv3x3_p8.py``) on
the CPU, where each public function computes its plain version: against
the JAX kernels in interpret mode and against ``F.conv2d``, on the shapes
of ``tests/test_pallas_conv.py`` with tile_h = H/2, at rtol = atol = 1e-4
(the JAX test's own tolerance: float32 sums of 144 products in another
order), and on a ragged width (W % 16 = 8, half of the tensor-core
kernels' last 16-pixel strip outside the image). The CUDA kernels run only
on the card (``chip_smoke.py``); their split-TF32 arithmetic, and the
device-memory addressing of ``conv3x3_p8``'s kernel, are emulated here in
numpy."""
import re

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


def _between(src, start, end):
    i = src.index(start)
    return src[i:src.index(end, i)]


def test_db_kernel_is_split_tf32_mma():
    """Variant 2's kernel computes on the tensor cores only: mma.sync .tf32
    in three passes for f32 input and two for bf16, no CUDA-core path."""
    src = _cuda_build.source("conv3x3_p8").read_text()
    launch = _between(src, "cudaError_t launch(", "}  // namespace")
    assert "if (variant == 2)\n    return launch_halo<T, TILES_DB>" in launch
    body = _between(src, "conv_halo(const T*", "template <typename T>")
    assert "mma_rows<T, R_DB>(TileA<T>" in body and "compute_tile" not in body
    rows = _between(src, "__device__ __forceinline__ void mma_rows(",
                    "conv_halo(const T*")
    assert rows.count("mma_tf32(") == 3 and "if (SPLIT_A)" in rows
    assert "fmaf" not in src
    assert ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32"
            in src)


@pytest.mark.parametrize("name,dispatch,kernel,operand", [
    ("conv3x3_p8", "conv_direct<T><<<", "conv_direct(const T*", "GlobalA<T>"),
    ("conv3x3_p8_dma", "if (variant == 1) return launch_halo<T, 1>",
     "conv_halo(const T*", "TileA<T>")])
def test_direct_and_dma_kernels_are_split_tf32_mma(name, dispatch, kernel,
                                                   operand):
    """Variants 0 and 1 run the split-TF32 ``mma.sync`` loop too: the
    launch sends them to a kernel whose rows go through ``mma_rows``, with
    A from device memory (variant 0, read-only path, zero outside the
    image) or from one halo tile (variant 1); the CUDA-core code is gone."""
    src = _cuda_build.source("conv3x3_p8").read_text()
    assert dispatch in _between(src, "cudaError_t launch(", "}  // namespace")
    body = _between(src, kernel, "\n}\n")
    assert f"mma_rows<T, R_DB>({operand}" in body
    assert f"mma_rows<T, 1>({operand}" in body  # the short last group
    assert "load_weights_tf32(k, wfrag);" in body
    for gone in ("compute_tile", "fmaf", "widen16", "TW_DMA"):
        assert gone not in src, gone
    if name == "conv3x3_p8":
        operand_src = _between(src, "struct GlobalA {", "\n};")
        assert "__ldg(" in operand_src
        assert "h >= 0 && h < H && w >= 0 && w < W" in operand_src
        assert "__shared__ float4 wfrag[KFRAG];" in body  # no halo tile
        assert "issue_tile" not in body


def _src_const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _b_fragments(k):
    """B (8 x 8, rows k, columns n) of each (tap, k-step s, n-tile n), as
    ``load_weights_tf32`` lays them out: b0 = (t, g) is k[tap, 4t + 2s,
    8n + g], b1 = (t + 4, g) is k[tap, 4t + 2s + 1, 8n + g]."""
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    frags = np.zeros((9, 2, 2, 8, 8))
    kt = k.reshape(9, 16, 16)
    for s in range(2):
        for n in range(2):
            frags[:, s, n, t, g] = kt[:, 4 * t + 2 * s, 8 * n + g]
            frags[:, s, n, t + 4, g] = kt[:, 4 * t + 2 * s + 1, 8 * n + g]
    return frags


def _emulate_direct(x, k, tile_h):
    """``conv_direct`` (variant 0) in float64 from its own indices: the
    grid of TW-column strips and TILES_DIRECT row tiles a block, R_DB rows
    a warp with a short last group of single rows, each lane's A vectors
    read from NHWC memory at image row h0 + i, column w0 + dw + 8 half,
    channels 4t .. 4t+3, zero outside the image; the A fragments of the
    permuted K order against ``load_weights_tf32``'s B fragments; the
    float2 stores of d, columns past W not stored. Returns the output and
    how many times each output element was stored."""
    src = _cuda_build.source("conv3x3_p8").read_text()
    tw, rdb, tiles = (_src_const(src, n)
                      for n in ("TW", "R_DB", "TILES_DIRECT"))
    nb, h, w, c = x.shape
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    mem = x.reshape(nb, -1).astype(np.float64)  # each image's NHWC memory
    bfrag = _b_fragments(k.astype(np.float64))
    out, count = np.zeros_like(mem), np.zeros(mem.shape[1], int)

    def load(hh, ww):  # one vector per lane: (nb, 32, 4)
        ok = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
        addr = (np.where(ok, hh * w + ww, 0) * c + 4 * t)[:, None]
        return np.where(ok[None, :, None], mem[:, addr + np.arange(4)], 0.0)

    def mma_rows(h0, w0, orow, col0, nr):
        acc = np.zeros((nb, nr, 2, 32, 4))
        for dw in range(3):
            for i in range(nr + 2):
                hh = np.full(32, h0 + i)
                v0, v8 = load(hh, w0 + dw), load(hh, w0 + dw + 8)
                for dh in range(3):
                    r = i - dh
                    if not 0 <= r < nr:
                        continue
                    for s in range(2):
                        a = np.zeros((nb, 16, 8))
                        a[:, g, t], a[:, g + 8, t] = v0[..., 2 * s], \
                            v8[..., 2 * s]
                        a[:, g, t + 4], a[:, g + 8, t + 4] = \
                            v0[..., 2 * s + 1], v8[..., 2 * s + 1]
                        for n in range(2):
                            d = a @ bfrag[dh * 3 + dw, s, n]
                            acc[:, r, n] += np.stack(
                                [d[:, g, 2 * t], d[:, g, 2 * t + 1],
                                 d[:, g + 8, 2 * t], d[:, g + 8, 2 * t + 1]],
                                -1)
        for r in range(nr):
            for half in range(2):
                gw = col0 + g + 8 * half
                keep = gw < w
                for n in range(2):
                    for e in range(2):
                        addr = (((orow + r) * w + gw[keep]) * c + 8 * n
                                + 2 * t[keep] + e)
                        out[:, addr] = acc[:, r, n, keep, 2 * half + e]
                        count[addr] += 1

    for col0 in range(0, w, tw):
        w0 = col0 + g - 1
        for z in range(-(-(h // tile_h) // tiles)):
            row0 = z * tiles * tile_h
            rows = min(tiles * tile_h, h - row0)
            for q in range(-(-rows // rdb)):
                o, nr = row0 + q * rdb, min(rdb, rows - q * rdb)
                if nr == rdb:
                    mma_rows(o - 1, w0, o, col0, rdb)
                else:
                    for r in range(nr):
                        mma_rows(o + r - 1, w0, o + r, col0, 1)
    return out.reshape(x.shape), count.reshape(x.shape[1:])


@pytest.mark.parametrize("shape,tile_h", [(s, s[1] // 2) for s in SHAPES]
                         + [((1, 45, 40, 16), 3)])
def test_direct_kernel_addressing_emulated(shape, tile_h):
    """The device-memory A addressing of ``conv3x3_p8``'s kernel, emulated
    in float64, is the convolution: every output element stored once, and
    equal to the float64 plain version (SAME padding from the zero
    predicate at rows -1/H and columns -1/>=W, the ragged strip's columns
    past W computed and not stored)."""
    x, k = _inputs(shape, seed=4)
    got, count = _emulate_direct(x, k, tile_h)
    assert (count == 1).all()
    want = T.conv3x3_p8_plain(torch.from_numpy(x).double(),
                              torch.from_numpy(k).double()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_design_variants_name_their_kernels():
    """Every design experiment of ``chip_conv_variants.py`` names kernels
    that exist, and each kernel has the source as it is and the
    skeletons."""
    for name, (_, _, kernels) in CV.VARIANTS.items():
        assert kernels and set(kernels) <= set(CV.KERNELS), name
    assert CV.KERNELS == {n: i for i, n in enumerate(NAMES)}
    for kernel in NAMES:
        have = {n for n, v in CV.VARIANTS.items() if kernel in v[2]}
        assert {"final", "no_mma", "no_loads", "no_stores"} <= have, kernel


@pytest.mark.parametrize("name", sorted(CV.VARIANTS))
def test_design_variants_apply_to_the_source(name):
    """Each design experiment of ``chip_conv_variants.py`` still finds the
    text it replaces in the kernel source."""
    src = _cuda_build.source("conv3x3_p8").read_text()
    for old, _ in CV.VARIANTS[name][1]:
        assert old in src, old
