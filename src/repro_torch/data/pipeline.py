"""Batching / host-sharding pipeline (the JAX package's
``data/pipeline.py``; host code, copied so the port stands alone).

``host_shard`` carves the global batch for this process (each host feeds
its slice). ``BatchIterator`` adds background prefetch (double buffering)
and a deterministic cursor so checkpoint/restart resumes mid-epoch
exactly.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator

import numpy as np


def host_shard(global_batch: int, process_index: int, n_processes: int
               ) -> slice:
    per = global_batch // n_processes
    return slice(process_index * per, (process_index + 1) * per)


class BatchIterator:
    """Wraps a cursor->batch function with prefetching.

    make_batch(step) must be deterministic in step (restart safety)."""

    def __init__(self, make_batch: Callable[[int], Dict[str, np.ndarray]],
                 start_step: int = 0, prefetch: int = 2):
        self.make_batch = make_batch
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.make_batch(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self.q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
