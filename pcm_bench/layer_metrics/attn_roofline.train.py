"""Attention's share of its roofline in the traced training steps: the
least time of the steps' attention work on the card over the device time of
the kernels under the benchmark's attention spans (`pcm_bench/trace.py`:
the program's attention entry and the autograd backward of each call).

The work is counted from the configuration, not from the calls: a sample's
attention forward (``attention.fwd_flops_per_sample`` / ``fwd_bytes_per_sample``:
QKᵀ and PV of every attention layer) runs in the CFG teacher (twice), the
target and the student, and the student's backward counts 2.5 forwards."""

from pcm_bench.roofline import bound

PASSES = 2 + 1 + 1 + 2.5


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or not trace.get("steps"):
        return None
    seconds = trace["span_device_s"].get("pcm_bench.attention", 0.0)
    if seconds <= 0:
        return None
    attn = record["config"]["attention"]
    samples = trace["steps"] * record["batch"] * PASSES
    least = bound(attn["fwd_flops_per_sample"] * samples, "bf16",
                  attn["fwd_bytes_per_sample"] * samples)["bound_ms"] / 1000.0
    return 100.0 * least / seconds
