"""Run one cell of the benchmark of ``cvssl_tpu_torch`` on this machine's
cards, once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It makes its inputs and weights from ``--seed``, sets up and warms up the
cell (``setup_s``), measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or traces a fixed piece of the work (``--trace 1``: its
per-layer metrics), checks what the timed path produced against the plain
reference under ``benchmark/reference/``, and prints one JSON line last on
standard output, with the numbers compared and their limits last on
standard error too. Without as many CUDA cards as the cell asks for it
exits 2 and prints no result; it also fails if JAX or the JAX package was
loaded. Build and kernel caches stay in ``build/`` inside the checkout.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
# imports start at the checkout, not in this folder, whose module names
# (trace, data) would shadow others
sys.path[0] = str(CHECKOUT)
# Python's compiled bytecode of every module imported, the program's
# libraries too, in a fixed folder of the checkout: later runs load it
sys.dont_write_bytecode = False
sys.pycache_prefix = str(CHECKOUT / "build" / "pycache")

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "cvssl_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")

    from benchmark import harness, spec
    cell = spec.cell(args.workload)
    import torch
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"run.py: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}", file=sys.stderr)
        return 2

    result, checks, _ = harness.execute(args.workload, args.seed, args.seconds,
                                     bool(args.trace), t0=T0)
    print(f"card: {power_limit()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded {bad}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
