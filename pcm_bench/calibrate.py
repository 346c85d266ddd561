"""Readings that the limits of ``correct`` are set from (CUDA only).

    python3 -m pcm_bench.calibrate --workload <cell> --seeds <n,n,...> \\
        [--mode program|control_fused|half_batch] [--out <file.jsonl>]

Runs the cell's set-up, its compared steps and its reference once for each
seed in one process (the readings need no measured window), and prints
each seed's compared numbers
as a JSON line. ``program`` is the cell as it runs; ``control_fused`` puts
the program's int8 frozen weights in place of bf16 and takes their products
in int8 (K6, the workload keys ``frozen_dtype`` and ``int8_matmul``): the
nearest precision below the configuration's; ``half_batch`` is the fault of
a step that takes the mean over half of its rows. The limits in the workload files lie between the largest
``program`` reading and the smallest reading of the others (`PERF.md`
gives the readings).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time

from pcm_bench import harness

# mode -> (workload keys set over the cell's file, the run's options)
MODES = {"program": ({}, {}),
         "control_fused": ({"frozen_dtype": "int8", "int8_matmul": "fused"}, {}),
         "half_batch": ({}, {"fault": "half_batch"})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m pcm_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program", choices=sorted(MODES))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    keys, options = MODES[args.mode]
    spec = dict(harness.load_cell(args.workload), **keys)
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = tempfile.mkdtemp(prefix="pcm_bench_cal_")
        t = time.perf_counter()
        try:
            run = harness.run_cell(args.workload, seed, 0.0, False, torch.device("cuda"), tmp,
                                   spec=spec, options=options)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        line = json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                           "gaps": run.record["gaps"],
                           "seconds": time.perf_counter() - t})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
