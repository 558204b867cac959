"""Async IO manager — background asset loading.

The port's copy of the JAX package's ``utils/io.py``.  Counterpart of
reference include/madrona/io.hpp + src/common/io.cpp (an async file-read
job skeleton on the legacy job system).  Here: a small thread pool (file
reads release the GIL) with future handles, to overlap .obj and asset
loading with kernel builds at startup.
"""

from __future__ import annotations

import concurrent.futures

from gpu_ecs_madrona_tpu_torch.utils import importer


class IOManager:
    """reference IOManager (io.hpp:21-35): load() returns a promise."""

    def __init__(self, num_workers: int = 4):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="gem-io")

    def load(self, path: str) -> "concurrent.futures.Future[bytes]":
        """Async whole-file read (reference IOPromise/load)."""

        def read():
            with open(path, "rb") as f:
                return f.read()

        return self._pool.submit(read)

    def load_obj(self, path: str) -> "concurrent.futures.Future[importer.SourceMesh]":
        """Async .obj parse through the port's importer (utils/importer.py
        load_obj)."""
        return self._pool.submit(importer.load_obj, path)

    def shutdown(self):
        self._pool.shutdown(wait=True)
