"""Items built on worker threads and yielded in order: the batch builders'
prefetch (``data/dataset.py::Loader.epoch``, ``pseudo/pipeline.py::
irn_train_batches``).

A worker that raises hands its exception to the consumer, which re-raises
it, instead of dying silently and leaving the consumer blocked for ever.
Every hand-over to the bounded queue waits a short while at a time and
gives up once the consumer has stopped (early, or by an exception), so no
worker stays blocked either.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

_POLL_S = 0.05  # how long a blocked hand-over waits before it checks for a stop
WORKER_NAME = "threaded_in_order"  # each worker thread's name, before "-<worker index>"


def threaded_in_order(make: Callable[[int], T], n: int, num_threads: int) -> Iterator[T]:
    """``make(i)`` for ``i`` in ``range(n)``, worker ``t`` of ``num_threads``
    building ``i = t, t + num_threads, ...``; yields them in order of
    ``i`` and re-raises the first exception a worker hands over."""
    q: "queue.Queue" = queue.Queue(maxsize=num_threads)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def worker(tid: int) -> None:
        for i in range(tid, n, num_threads):
            if stop.is_set():
                return
            try:
                item = (i, make(i), None)
            except BaseException as e:  # noqa: BLE001 - handed to the consumer
                put((i, None, e))
                return
            if not put(item):
                return

    threads = [threading.Thread(target=worker, args=(t,), daemon=True, name=f"{WORKER_NAME}-{t}")
               for t in range(num_threads)]
    for t in threads:
        t.start()
    try:
        pending, nxt = {}, 0
        for _ in range(n):
            i, value, err = q.get()
            if err is not None:
                raise err
            pending[i] = value
            while nxt in pending:
                yield pending.pop(nxt)
                nxt += 1
    finally:
        stop.set()
