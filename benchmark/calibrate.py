"""Readings of the comparison that decides ``correct``, seed after seed in
one process, from which the limits in ``workloads/<cell>.json`` are set:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,half_batch,... [--seconds 2]

``program``: the program's sound runs; ``control``: the plain reference
in the program's place, computed in fp8, the nearest precision below the
configuration's bfloat16 (its convolutions store activations, weights and
outputs in e4m3 and their gradients in e5m2); the others: the reference
in the program's place with that fault planted (training cells; see
``reference/methods.py::train``). Each reading is one run of
``harness.execute`` whose window lasts ``--seconds``, with every number
the cell's comparison has. One JSON line a run on standard output.
"""
import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])
sys.dont_write_bytecode = False
sys.pycache_prefix = str(Path(sys.path[0]) / "build" / "pycache")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

FAULTS = ("half_batch", "unlabeled_half", "unlabeled_out", "mc_one",
          "no_teacher", "alter")
CONTROLS = {"program": None, "control": {"precision": "fp8"},
            **{f: {"precision": "float32", "fault": f} for f in FAULTS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch
    from benchmark import harness
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            result, _, numbers = harness.execute(
                args.workload, seed, args.seconds, False,
                control=CONTROLS[mode], t0=t0, every_number=True)
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, **numbers,
                              "failed": result["failed"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            del result
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
