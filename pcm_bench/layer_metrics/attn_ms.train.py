"""Milliseconds of the card a training step spent in attention, as the
program times it: the device seconds of its ``attention`` spans
(`ops/flash_attention.py`: each forward's K1, recomputed ones included, and
each backward's delta, K2 and K3) summed over the window's steps, over the
number of steps. None where the rows lack them."""

KEYS = ("attn_device_s",)


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    rows = record["rows"]
    if not rows or any(k not in r for r in rows for k in KEYS):
        return None
    return 1000.0 * sum(r[k] for r in rows for k in KEYS) / record["steps"]
