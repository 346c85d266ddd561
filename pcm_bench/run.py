"""Run one cell of the benchmark once and print its result line.

    python3 -m pcm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA cards the cell asks for: without them it exits with code 2
and prints no result. Kernel builds and caches go to fixed directories under
``build/`` in the checkout; the run's inputs go to a directory under
``TMPDIR`` that it removes. The last lines of standard error give each
number compared for ``correct`` beside its limit; the last line of standard
output is the result, a JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from pcm_bench import harness

T0 = time.perf_counter() - harness.process_age_s()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m pcm_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)

    build = harness.REPO / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    import torch

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r} (one of {sorted(cells)})", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="pcm_bench_")
    try:
        run = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               torch.device("cuda"), tmp, t0=T0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    found = harness.loaded_forbidden()
    if found:
        print(f"the run loaded {found}: the benchmark measures pcm_tpu_torch alone",
              file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line = harness.result_line(bench, args.workload, run, bool(args.trace), info)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
