"""Background prefetch (counterpart of ``repro.data.prefetch``): overlaps
host-side reads with device compute -- ``stream.FileSource``'s read-ahead
runs the next chunk's disk read while the current one is sent and
accumulated."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

__all__ = ["PrefetchIterator"]


class PrefetchIterator:
    """Wraps an iterator with a daemon thread + bounded queue.

    ``close()`` shuts the worker down promptly even when it is blocked
    on a full queue (the abandoned-iterator leak: without it, a consumer
    that stops early strands the thread in ``Queue.put`` for the life of
    the process, pinning the source iterator and everything it holds).
    Also usable as a context manager; closing is idempotent, and a
    closed iterator raises ``StopIteration``."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._closed = False

        def worker():
            try:
                for item in it:
                    # Bounded put that re-checks stop: close() drains the
                    # queue, so a blocked put wakes within one timeout.
                    while not self._stop.is_set():
                        try:
                            self._q.put(item, timeout=0.05)
                            break
                        except queue.Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:          # surfaced on next()
                self._err = e
            finally:
                try:
                    self._q.put_nowait(self._done)
                except queue.Full:
                    pass                        # close() is draining anyway

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the worker and release its references; safe to call
        twice, safe while the worker is mid-put."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get_nowait()            # unblock a pending put
            except queue.Empty:
                pass
            self._t.join(timeout=0.05)
        self._t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
