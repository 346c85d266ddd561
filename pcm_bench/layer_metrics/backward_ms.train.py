"""Milliseconds of the card a training step spent in the student's
backward: the device seconds of the program's ``student.backward`` span
(`train/distill.py`: ``autograd.grad`` of the loss; idle included) summed
over the window's steps, over the number of steps. None where the rows lack
it."""

KEYS = ("student_backward_device_s",)


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    rows = record["rows"]
    if not rows or any(k not in r for r in rows for k in KEYS):
        return None
    return 1000.0 * sum(r[k] for r in rows for k in KEYS) / record["steps"]
