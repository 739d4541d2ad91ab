#!/usr/bin/env python3
"""Design experiments for the tensor-core conv kernels (variants 0-2 of
``cvssl_tpu_torch/csrc/conv3x3_p8.cu``) on one CUDA card.

    python3 chip_conv_variants.py [--kernel NAME] [--variants NAME ...]
                                  [--mma-rate]

Builds each named variant of the source (the source with a few lines
replaced: table ``VARIANTS``) with ``nvcc``, all at once, into
``build/conv_variants``; prints each one's ptxas registers and spills;
checks the chosen kernel (``--kernel``, default ``conv3x3_p8_db``) of each
against the float64 plain version at (24, 256, 256, 16), tile_h 32, and
times it with ``chip_smoke.py``'s timer (CUDA events, a 1 GiB write before
each call, median of 50) for float32 and bfloat16 input, in turns: the
list, then the list reversed. Without ``--variants`` it runs the variants
that the table names for that kernel.

The ``no_*`` variants are skeletons, not convolutions: the kernel without
its tensor-core products, its input loads or its output stores, to show
what each part costs; their errors mean nothing. ``--mma-rate`` times a
kernel of independent ``mma.sync`` m16n8k8 TF32 products and nothing else,
the rate that bounds the kernels' products.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import threading

import chip_smoke as cs

SHAPE, TILE_H = (24, 256, 256, 16), 32
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "conv_variants")
# kernel name: its variant index in conv3x3_p8_launch
KERNELS = {"conv3x3_p8": 0, "conv3x3_p8_dma": 1, "conv3x3_p8_db": 2}
ALL = tuple(KERNELS)
DIRECT, DMA, DB = ALL
STORE = "*reinterpret_cast<float2*>(row + gw * C + 8 * n + 2 * t) ="
MMA_PTX = ('asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 '
           '{%0, %1, %2, %3}, "')
NO_MMA = (MMA_PTX, 'asm("// %0 %1 %2 %3 "')
NO_MMA_LIVE = (MMA_PTX, 'asm("{.reg .b32 q; lop3.b32 q, %4, %5, %6, 0x96; '
               'lop3.b32 q, q, %7, %8, 0x96; lop3.b32 %0, q, %9, %0, 0x96;} '
               '// %0 %1 %2 %3 "')
NO_TILE_COPIES = ("issue_tile<T>(x, ring", "if (0) issue_tile<T>(x, ring")
NO_GLOBAL_LOADS = (
    "v = __ldg(reinterpret_cast<const V*>(img + (h * W + w) * C));",
    "v = V{};")
TILE_COPY = ("  issue_tile<T>(x, ring, b, t0 * th, col0, th, H, W);\n"
             "  cp_async_commit();\n")
LAST_WAIT = "    } else {\n      cp_async_wait<0>();\n    }"
TILE_PASS = ("for (int q = warp; q < groups; q += WARPS) {\n"
             "      const int o0 = q * R_DB, nr = min(R_DB, th - o0);")


def ROWS(n):
    return "constexpr int R_DB = 2;", f"constexpr int R_DB = {n};"


def DTILES(n):
    return ("constexpr int TILES_DIRECT = 4;",
            f"constexpr int TILES_DIRECT = {n};")


DIRECT_LAUNCH = "conv_direct<T><<<grid, THREADS, 0, stream>>>"
# name: (what it changes, [(text in the source, replacement)], the kernels
# it is an experiment on)
VARIANTS = {
    "final": ("the source as it is", [], ALL),
    "rows4": ("four output rows per warp (R_DB = 4)", [ROWS(4)], ALL),
    "rows3": ("three output rows per warp (R_DB = 3)", [ROWS(3)], ALL),
    "lo_rounded": ("lo(x) rounded to TF32 in registers", [
        ("lo[i] = __float_as_uint(f[i] - __uint_as_float(hi[i]));",
         "lo[i] = tf32_rna(f[i] - __uint_as_float(hi[i]));")], (DB,)),
    "cvt_rna": ("tf32_rna through the cvt.rna.tf32.f32 instruction", [
        ("return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;",
         'uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : '
         '"f"(v));\n  return r;')], (DB,)),
    "tiles1": ("one row tile per block: the ring idle", [
        ("constexpr int TILES_DB = 2;", "constexpr int TILES_DB = 1;")],
        (DB,)),
    "tiles4": ("four row tiles per block", [
        ("constexpr int TILES_DB = 2;", "constexpr int TILES_DB = 4;")],
        (DB,)),
    "tiles8": ("eight row tiles per block (a whole strip at the main "
               "shape)", [
        ("constexpr int TILES_DB = 2;", "constexpr int TILES_DB = 8;")],
        (DB,)),
    "copy_split": ("a one-tile block copies the rows of the warps' first "
                   "pass in a cp.async group of their own and starts on "
                   "them while the rest is in flight", [
        # rows 0 .. first-1 of the halo tile, then the rest, each as the
        # halo tile of fewer output rows
        (TILE_COPY,
         "  const int first = per == 1 ? min(th, WARPS * R_DB) + 2 : th + 2;"
         "\n  issue_tile<T>(x, ring, b, t0 * th, col0, first - 2, H, W);\n"
         "  cp_async_commit();\n"
         "  if (first < th + 2)\n"
         "    issue_tile<T>(x, ring + first * (TW + 2) * C, b,\n"
         "                  t0 * th + first, col0, th - first, H, W);\n"
         "  cp_async_commit();\n"),
        (LAST_WAIT,
         "    } else if (first < th + 2) {\n      cp_async_wait<1>();\n"
         "    } else {\n      cp_async_wait<0>();\n    }"),
        (TILE_PASS,
         "for (int q0 = 0; q0 < groups; q0 += WARPS) {\n"
         "      if (q0 == WARPS && first < th + 2) {\n"
         "        cp_async_wait<0>();\n        __syncthreads();\n      }\n"
         "      const int q = q0 + warp;\n"
         "      if (q >= groups) continue;\n"
         "      const int o0 = q * R_DB, nr = min(R_DB, th - o0);")],
        (DMA,)),
    "no_ahead": ("each global A load issued where it is used, not a step "
                 "ahead", [("static constexpr bool AHEAD = true;",
                            "static constexpr bool AHEAD = false;")],
                 (DIRECT,)),
    "direct_tiles1": ("one row tile (32 rows) per block", [DTILES(1)],
                      (DIRECT,)),
    "direct_tiles2": ("two row tiles (64 rows) per block", [DTILES(2)],
                      (DIRECT,)),
    "direct_tiles8": ("eight row tiles (a whole strip) per block",
                      [DTILES(8)], (DIRECT,)),
    "carveout": ("a 25% shared-memory carveout hint (the rest L1)", [
        (DIRECT_LAUNCH,
         "cudaFuncSetAttribute(conv_direct<T>, "
         "cudaFuncAttributePreferredSharedMemoryCarveout, 25);\n  "
         + DIRECT_LAUNCH)], (DIRECT,)),
    "no_mma": ("skeleton: the mma.sync replaced by an empty asm (ptxas "
               "then drops the loads whose values only it used)", [NO_MMA],
               ALL),
    "no_mma_live": ("skeleton: the mma.sync replaced by three lop3 on its "
                    "operands, which keeps the A loads and splits alive",
                    [NO_MMA_LIVE], ALL),
    "no_loads": ("skeleton: no input tile copies or global A loads",
                 [NO_TILE_COPIES, NO_GLOBAL_LOADS], ALL),
    "no_mma_no_loads": ("skeleton: neither",
                        [NO_MMA, NO_TILE_COPIES, NO_GLOBAL_LOADS], ALL),
    "no_stores": ("skeleton: the output stores under a false condition", [
        (STORE, "if (acc[r][n][0] == 1.2345e30f) " + STORE)], ALL),
}

MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// each warp: iters rounds of 8 independent m16n8k8 TF32 products
__global__ void mma_rate(long long* cycles, float* sink, int iters) {
  float d[8][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = 3u * threadIdx.x, b0 = 5u;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < 8; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %4, %5}, {%6, %6}, "
          "{%0, %1, %2, %3};\n"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a0), "r"(a1), "r"(b0));
  }
  long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < 8; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if ((threadIdx.x & 31) == 0)
    cycles[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] = t1 - t0;
}
extern "C" int mma_rate_launch(int blocks, int threads, int iters,
                               long long* cycles, float* sink) {
  mma_rate<<<blocks, threads>>>(cycles, sink, iters);
  return (int)cudaGetLastError();
}
"""


def nvcc(src_path: str, so_path: str):
    from cvssl_tpu_torch.ops import _cuda_build
    res = subprocess.run([_cuda_build._nvcc(), *_cuda_build.NVCC_FLAGS, "-o",
                          so_path, src_path], capture_output=True, text=True)
    return res.returncode, res.stdout + res.stderr


def build_variants(names):
    """{name: (library or None, nvcc log)}, built in parallel threads."""
    from cvssl_tpu_torch.ops import _cuda_build
    from cvssl_tpu_torch.ops import conv3x3_p8 as cv
    base = _cuda_build.source("conv3x3_p8").read_text()
    os.makedirs(OUT_DIR, exist_ok=True)
    built = {}

    def one(name):
        src = base
        for old, new in VARIANTS[name][1]:
            if old not in src:
                built[name] = (None, f"text not in the source: {old!r}")
                return
            src = src.replace(old, new)
        path = os.path.join(OUT_DIR, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(OUT_DIR, f"{name}.so")
        rc, log = nvcc(path, so)
        lib = None
        if rc == 0:
            lib = ctypes.CDLL(so)
            for fn, (restype, argtypes) in cv.SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = list(argtypes)
        built[name] = (lib, log)

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return built


def mma_rate(torch, tf32_rate):
    """Dense mma.sync m16n8k8 TF32 rate with 4 warps on each SM partition
    (16 per SM, 8 independent products each), on every SM at once."""
    src = os.path.join(OUT_DIR, "mma_rate.cu")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(src, "w") as f:
        f.write(MMA_RATE_SRC)
    so = os.path.join(OUT_DIR, "mma_rate.so")
    rc, log = nvcc(src, so)
    if rc != 0:
        raise SystemExit(f"mma_rate: nvcc failed:\n{log}")
    lib = ctypes.CDLL(so)
    lib.mma_rate_launch.restype = ctypes.c_int
    lib.mma_rate_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, iters = 512, 4096
    cycles = torch.zeros(sms * threads // 32, dtype=torch.int64,
                         device="cuda")
    sink = torch.zeros(sms * threads, device="cuda")
    for _ in range(2):  # the first launch warms up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if lib.mma_rate_launch(sms, threads, iters, cycles.data_ptr(),
                               sink.data_ptr()) != 0:
            raise SystemExit("mma_rate: launch failed")
        end.record()
        end.synchronize()
    ms = start.elapsed_time(end)
    flop = 2 * 16 * 8 * 8 * 8 * iters * sms * threads // 32
    per_partition = threads // 32 // 4 * 8 * iters
    clk = float(cycles.double().mean()) / per_partition
    print(f"mma.sync m16n8k8 tf32 alone: {flop / ms / 1e9:.1f} TFLOP/s "
          f"({flop / ms / 1e9 / (tf32_rate / 1e12):.3f} of the dense TF32 "
          f"rate), {clk:.2f} clock cycles per product per SM partition")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", nargs="+", default=[DB], choices=ALL,
                        help="the kernel(s) to time in each variant")
    parser.add_argument("--variants", nargs="*", choices=list(VARIANTS),
                        help="default: every variant that names one of the "
                        "kernels")
    parser.add_argument("--mma-rate", action="store_true")
    args = parser.parse_args(argv)
    variants = args.variants or [n for n, v in VARIANTS.items()
                                 if set(v[2]) & set(args.kernel)]
    import torch
    if not torch.cuda.is_available():
        print("chip_conv_variants: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    from cvssl_tpu_torch.ops import conv3x3_p8 as cv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    _, _, tf32_rate = cs.card_rates(torch.cuda.get_device_name(0))
    if args.mma_rate:
        mma_rate(torch, tf32_rate)
    built = build_variants(variants)
    for name in variants:
        lib, log = built[name]
        state = "; ".join(l for l in cs.ptxas_summary(log) if "conv_" in l)
        print(f"{name} ({VARIANTS[name][0]}): "
              f"{state if lib else 'NOT BUILT: ' + log[-2000:]}")
    # (variant, kernel) pairs: a named variant runs on every chosen kernel
    runs = [(n, kn) for n in variants if built[n][0] is not None
            for kn in args.kernel if args.variants or kn in VARIANTS[n][2]]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(SHAPE, generator=gen, device=dev)
    k = 0.1 * torch.randn((3, 3, 16, 16), generator=gen, device=dev)
    inputs = {"f32": x, "bf16": x.to(torch.bfloat16)}
    want = {dt: cv.conv3x3_p8_plain(v.double(), k.double())
            for dt, v in inputs.items()}
    flush = torch.empty(2 ** 28, dtype=torch.int32, device=dev)
    b, h, w, _ = SHAPE

    def call(lib, kernel, xin):
        out = torch.empty(SHAPE, dtype=torch.float32, device=dev)
        err = lib.conv3x3_p8_launch(
            KERNELS[kernel], xin.data_ptr(), int(xin.dtype == torch.bfloat16),
            k.data_ptr(), out.data_ptr(), b, h, w, TILE_H,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise SystemExit(lib.conv3x3_p8_error_string(err).decode())
        return out

    times = {run: {dt: [] for dt in inputs} for run in runs}
    errs = {run: {} for run in runs}
    for run in runs + runs[::-1]:
        lib = built[run[0]][0]
        for dt, xin in inputs.items():
            got = call(lib, run[1], xin)
            torch.cuda.synchronize()
            errs[run][dt] = float((got.double() - want[dt]).abs().max()
                                  / want[dt].abs().max())
            times[run][dt].append(cs.median_ms(
                lambda: call(lib, run[1], xin), flush))
    print(f"variants at {SHAPE}, tile_h {TILE_H}, ms (two turns) and max "
          "error / max |out| (skeletons: meaningless):")
    for run in runs:
        print(f"  {run[1]:14s} {run[0]:17s} f32 "
              + " ".join(f"{t:.6f}" for t in times[run]["f32"])
              + f" (err {errs[run]['f32']:.2e})  bf16 "
              + " ".join(f"{t:.6f}" for t in times[run]["bf16"])
              + f" (err {errs[run]['bf16']:.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
