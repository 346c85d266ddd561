"""Milliseconds a training step's host spent blocked until the card drained
its queue: the Trainer's ``host_wait_s`` (the program's ``wait.<site>``
spans, `train/loop.py`) summed over the window's steps, over the number of
steps. None where the rows lack it."""

KEYS = ("host_wait_s",)


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    rows = record["rows"]
    if not rows or any(k not in r for r in rows for k in KEYS):
        return None
    return 1000.0 * sum(r[k] for r in rows for k in KEYS) / record["steps"]
