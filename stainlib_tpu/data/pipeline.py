"""Multi-buffered host -> device feeding.

The reference hides host latency behind torch DataLoader workers
(``train_img_horo.py:292-302``); in JAX the equivalent is a prefetch
ring: background threads pull host batches (from any iterator, e.g.
:class:`stainlib_tpu.data.wsi.WsiSampler`), optionally transform them on the
host, and ``jax.device_put`` them ahead of the consumer so the device never
waits on the host (SURVEY.md section 7 step 7).

With ``workers > 1`` several host batches are sampled/transferred
concurrently (each `device_put` is an independent in-flight DMA), which
amortizes per-transfer round-trip latency; delivery order is preserved, so
training streams stay deterministic for a fixed host iterator.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import jax
import numpy as np


class DevicePrefetcher:
    """Wraps a host batch iterator with an N-deep device-side buffer."""

    _DONE = object()

    def __init__(self, host_iter: Iterator, depth: int = 4,
                 transform: Optional[Callable] = None,
                 sharding=None, workers: int = 1):
        """``transform(batch) -> array(s)`` runs on a host thread;
        ``sharding`` is an optional NamedSharding for multi-device
        placement; ``workers`` host threads overlap sampling + transfer."""
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._iter = iter(host_iter)
        self._iter_lock = threading.Lock()
        self._seq = 0
        self._emit = threading.Condition()
        self._next_emit = 0
        self._stopped = False
        self._err_seq = float("inf")  # first failing sequence number
        self._active = workers

        def put_to_device(batch):
            if transform is not None:
                batch = transform(batch)
            return jax.tree.map(
                lambda a: jax.device_put(np.asarray(a), sharding), batch
            )

        def worker():
            seq = None
            try:
                while True:
                    seq = None  # reset: an iterator error has no seq of its own
                    with self._iter_lock:
                        if self._stopped:
                            return
                        # Record the slot this next() fills BEFORE calling
                        # it: an iterator raise is then pinned to this
                        # position even if the shared iterator yields again
                        # to another worker afterwards (keeps the
                        # same-prefix-as-single-worker guarantee).
                        seq = self._seq
                        try:
                            batch = next(self._iter)
                        except StopIteration:
                            return
                        except BaseException:
                            self._seq += 1  # the error consumes the slot
                            raise
                        self._seq += 1
                    batch = put_to_device(batch)
                    with self._emit:
                        # Batches sequenced BEFORE the first failure still
                        # emit (the consumer sees the same prefix as a
                        # single-worker run); only later ones are dropped.
                        while (self._next_emit != seq
                               and not (self._stopped
                                        and seq > self._err_seq)):
                            self._emit.wait()
                        if self._stopped and seq > self._err_seq:
                            return
                        self._q.put(batch)
                        self._next_emit += 1
                        self._emit.notify_all()
            except BaseException as e:  # surfaced on the consumer side
                with self._emit:
                    if self._err is None:
                        self._err = e
                    fail_at = seq if seq is not None else self._seq
                    self._err_seq = min(self._err_seq, fail_at)
                    self._stopped = True
                    self._emit.notify_all()
            finally:
                finish = False
                with self._emit:
                    self._active -= 1
                    finish = self._active == 0
                if finish:
                    self._q.put(self._DONE)

        self._threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(workers, 1))
        ]
        for t in self._threads:
            t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
