"""Milliseconds of the card a training step spent in its optimizer: the
device seconds of the program's ``optimizer`` spans (`train/distill.py`:
the microbatches' mean, the all-reduce, clipping, the gradient norm, AdamW
and the update; idle included) summed over the window's steps, over the
number of steps. None where the rows lack them."""

KEYS = ("optimizer_device_s",)


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    rows = record["rows"]
    if not rows or any(k not in r for r in rows for k in KEYS):
        return None
    return 1000.0 * sum(r[k] for r in rows for k in KEYS) / record["steps"]
