"""Host-parallel input pipeline: batch prefetching and the per-process
corpus split (the port's copies of ``PrefetchIterator`` and
``shard_for_host`` from the JAX package's ``data/prefetch.py``).

The reference's only input concurrency is a ThreadPoolExecutor around window
extraction (app/abstract_inference_app.py:62-64). :class:`PrefetchIterator`
runs a background thread that assembles the next batches (index gather and
any host-side work) while the card executes the current step, so host
latency hides behind device time. :func:`shard_for_host` splits a corpus
over the processes of a ``torch.distributed`` group.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence, TypeVar

T = TypeVar("T")


class PrefetchIterator:
    """Wraps a batch iterator with a bounded background prefetch queue.

    A consumer that leaves before the end calls :meth:`close` (or uses the
    iterator as a context manager): the worker then stops at its next
    ``put`` and lets go of the iterator and the arrays it holds."""

    _SENTINEL = object()
    _POLL_S = 0.1  # how often a worker blocked on a full queue looks for close()

    def __init__(self, batch_iterable: Iterator, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(batch_iterable,), name="PrefetchIterator", daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item``; False once :meth:`close` was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self, batch_iterable) -> None:
        try:
            for batch in batch_iterable:
                if not self._put(batch):
                    return
        except BaseException as exc:  # propagate into the consumer
            self._error = exc
        finally:
            self._put(self._SENTINEL)

    def close(self) -> None:
        """Stop the worker, wait for it and drop the batches it queued."""
        self._stop.set()
        self._thread.join()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def shard_for_host(
    items: Sequence[T],
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List[T]:
    """Deterministic per-process partition (strided). Rank and world size
    default to the ``torch.distributed`` group's when one is initialised,
    else 0 and 1. Shuffle the corpus before sharding: a strided split can
    alias periodic label patterns."""
    if process_index is None or process_count is None:
        import torch.distributed as dist

        grouped = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if grouped else 0
        process_count = dist.get_world_size() if grouped else 1
    return list(items[process_index::process_count])
