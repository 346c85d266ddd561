"""Milliseconds of the card a training step spent in its forwards: the
device seconds of the program's ``teacher``, ``target`` and
``student.forward`` spans (`train/distill.py`: the CFG teacher forward and
its solver step, the target forward and its jump, the student forward
through the loss; the card's time from reaching each span to leaving it,
idle included) summed over the window's steps, over the number of steps.
None where the rows lack them."""

KEYS = ("teacher_device_s", "target_device_s", "student_forward_device_s")


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    rows = record["rows"]
    if not rows or any(k not in r for r in rows for k in KEYS):
        return None
    return 1000.0 * sum(r[k] for r in rows for k in KEYS) / record["steps"]
