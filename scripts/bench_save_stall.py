#!/usr/bin/env python
"""Time the training step after a checkpoint save against the steady step.

Runs ``python -m pcm_tpu_torch.train --recipe sd15_4phase`` on a latent
cache in each tree given (``--root``, default this checkout; another
checkout, e.g. the parent commit unpacked with ``git archive``, compares
the two on one card), ``--steps`` steps at ``--batch-size`` with a save
every ``--every`` steps and a log row every step, and prints one JSON line
a run: each step's ``step_ms``, the steps after a save, the median of the
others (the first step left out), and the step thread's ``save_s`` /
``save_wait_s`` and the writer's ``write_s`` where the tree logs them.

  python scripts/bench_save_stall.py --cache build/chip_smoke/cache \\
      --root build/parent --tag parent --root . --tag change
  python scripts/bench_save_stall.py --cache tiny_cache --tiny --device cpu   # a rehearsal
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys


def run(root: str, tag: str, args) -> dict:
    out = os.path.abspath(os.path.join(args.out, tag))
    shutil.rmtree(out, ignore_errors=True)
    argv = [sys.executable, "-m", "pcm_tpu_torch.train", "--recipe", "sd15_4phase",
            "--cached-latents-dir", os.path.abspath(args.cache), "--output-dir", out,
            "--batch-size", str(args.batch_size), "--max-train-steps", str(args.steps),
            "--checkpointing-steps", str(args.every), "--log-every", "1", "--no-resume",
            "--seed", "0", "--validation-steps", "0", "--device", args.device]
    if args.tiny:
        argv.append("--tiny")
    res = subprocess.run(argv, cwd=root, capture_output=True, text=True, timeout=args.timeout)
    if res.returncode != 0:
        raise SystemExit(f"{tag}: exit {res.returncode}\n{res.stderr[-3000:]}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rows = [r for r in rows if "step_ms" in r]
    ms = {r["step"]: r["step_ms"] for r in rows}
    after = [s + 1 for s in range(args.every, args.steps, args.every)]
    steady = [v for s, v in ms.items() if s > 1 and s not in after]
    line = {"tag": tag, "root": root, "step_ms": ms, "after_save_ms": [ms[s] for s in after],
            "steady_median_ms": statistics.median(steady)}
    for k in ("save_s", "save_wait_s", "write_s"):
        if k in rows[0]:
            line[k] = [r[k] for r in rows]
    return line


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cache", required=True, help="dir of shard_*.npz (sd15 latents)")
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout to run (repeatable; default: this one)")
    ap.add_argument("--tag", action="append", default=None, help="a name for each --root")
    ap.add_argument("--out", default="build/save_stall")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--every", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args()
    roots = args.root or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    tags = args.tag or [f"run{i}" for i in range(len(roots))]
    if len(tags) != len(roots):
        ap.error("one --tag per --root")
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    for root, tag in zip(roots, tags):
        print(json.dumps(run(root, tag, args)), flush=True)


if __name__ == "__main__":
    main()
