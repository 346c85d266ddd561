"""Milliseconds of host time in a training step's call: the Trainer's own
``host_dispatch_s`` (the step thread inside the step function: the draws,
the forwards, the backward and the optimizer's launches) summed over the
window's steps, over the number of steps."""


def read(record):
    if record.get("kind") != "train" or not record["steps"]:
        return None
    return 1000.0 * sum(r["host_dispatch_s"] for r in record["rows"]) / record["steps"]
