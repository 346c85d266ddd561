"""Background production of an iterator's items (the image loader's
producer, the trainer's feeder)."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, TypeVar

T = TypeVar("T")


class _Raised:
    def __init__(self, error: BaseException):
        self.error = error


def prefetch_thread(items: Iterator[T], size: int, name: str) -> Iterator[T]:
    """The items of ``items``, computed on a daemon thread up to ``size``
    ahead of the consumer. An exception the thread meets is raised here, in
    order. Closing this generator stops the thread at its next item and
    waits for it, and the thread closes ``items``: no thread is left running
    code of a C++ library when the interpreter exits, which aborts it."""
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop, end = threading.Event(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run() -> None:
        try:
            for item in items:
                if not put(item):
                    return
            put(end)
        except BaseException as e:  # raised again on the consumer's side
            put(_Raised(e))
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=run, daemon=True, name=name)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, _Raised):
                raise item.error
            yield item
    finally:
        stop.set()
        thread.join()
