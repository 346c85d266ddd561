"""Milliseconds a training step waited for its batch: the Trainer's own
``host_data_s`` (the step thread blocked on the feeder, `train/loop.py`)
summed over the window's steps, over the number of steps."""


def read(record):
    if record.get("kind") != "train" or not record["steps"]:
        return None
    return 1000.0 * sum(r["host_data_s"] for r in record["rows"]) / record["steps"]
