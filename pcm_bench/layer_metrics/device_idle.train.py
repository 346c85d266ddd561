"""Share of the traced training steps in which no operation ran on the
card: one minus the union of the device's operation intervals on the
profiler's timeline over the traced window."""


def read(record):
    trace = record.get("trace")
    if record.get("kind") != "train" or not trace or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
