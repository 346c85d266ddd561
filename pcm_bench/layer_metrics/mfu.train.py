"""The training step's share of the card's bf16 peak: the configuration's
operations a sample (``flops_per_sample.train``: the CFG teacher forward,
the target forward, the student forward and backward, no recompute,
counted by `pcm_bench/flops.py` over the reference) times the samples of
the window's steps, over the window's seconds and 989 TFLOP/s."""

from pcm_bench.roofline import PEAK_OPS_S


def read(record):
    if record.get("kind") != "train" or not record["steps"]:
        return None
    ops = record["config"]["flops_per_sample"]["train"] * record["samples"]
    return 100.0 * ops / record["window_s"] / PEAK_OPS_S["bf16"]
