"""Prefetching batch loader: overlap decode IO with device compute.

The reference's CLI loads, processes, and encodes strictly serially
(cli.rs:155-216), so the device idles while the host decodes the next
PNG; this loader decodes ahead on a thread pool (zlib and Pillow release
the GIL inside their C decoders) and hands the batch runner images in order, a
bounded number of files ahead of consumption.
"""

from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np


def prefetch_images(paths: Iterable, load: Optional[Callable] = None,
                    depth: int = 4, workers: int = 4) -> Iterator[Tuple[object, object]]:
    """Yield (path, image-or-exception) in input order, decoding up to
    `depth` files ahead on `workers` threads.  Exceptions are delivered
    in-slot so the consumer keeps the CLI's keep-going semantics."""
    if load is None:
        from paintfe_tpu.io import codecs

        load = codecs.load_image
    paths = list(paths)

    def safe_load(p):
        try:
            return load(p)
        except Exception as e:  # delivered to the consumer, not raised here
            return e

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as pool:
        pending = {}
        for i in range(min(depth, len(paths))):
            pending[i] = pool.submit(safe_load, paths[i])
        submitted = min(depth, len(paths))
        for i in range(len(paths)):
            result = pending.pop(i).result()
            if submitted < len(paths):
                pending[submitted] = pool.submit(safe_load, paths[submitted])
                submitted += 1
            yield paths[i], result


class DoubleBuffer:
    """Two-slot pipeline: while the device crunches batch N, the host
    stages batch N+1 (the AsyncReadback ping-pong analogue,
    renderer.rs:33-197, pointed the other direction)."""

    def __init__(self, produce: Callable[[int], object], n: int):
        self._produce = produce
        self._n = n
        self._next = None
        self._next_exc: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def __iter__(self):
        for i in range(self._n):
            if self._thread is not None:
                self._thread.join()
                if self._next_exc is not None:
                    # a produce() failure on the staging thread must reach
                    # the consumer, not silently yield the stale previous
                    # slot
                    raise self._next_exc
                item = self._next
            else:
                item = self._produce(i)
            if i + 1 < self._n:
                def stage(j=i + 1):
                    with self._lock:
                        try:
                            self._next = self._produce(j)
                            self._next_exc = None
                        except BaseException as e:  # re-raised on the consumer
                            self._next_exc = e

                self._thread = threading.Thread(target=stage, daemon=True)
                self._thread.start()
            yield item
