"""Disk-backed page store: the stream + phrase sums live in files.

A copy of ``repro/store/mmap_store.py`` (numpy) for the port.  Layout on
disk, written once at build time:

* ``syms.i32`` — ``(num_pages, page_size)`` int32 dense symbol pages,
* ``sums.i32`` — ``(num_pages, page_size)`` int32 phrase-sum pages,

both zero-padded past ``n_syms`` exactly like the device arrays, so a
page read here is bit-identical to the fully-resident page.  Everything
the paper keeps in RAM (grammar, span directory, buckets) is NOT here —
it travels in ``meta`` / the engine.  The paper's I/O-optimality bound
is :meth:`PageStore.page_accesses` (unit-tested in
``tests/test_torch_store.py``).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import weakref

import numpy as np

from .base import PageStore


def _rmtree(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


class MmapPageStore(PageStore):
    """``np.memmap``-backed page store.

    Every store writes into its own fresh directory (unique names, so
    concurrent stores never clobber each other's open mappings), removed
    when the store is garbage-collected or ``close()``d.  ``path`` (or
    ``REPRO_STORE_DIR``) only relocates where that directory is created —
    e.g. a big scratch disk.
    """

    kind = "mmap"

    def __init__(self, syms_pg: np.ndarray, sums_pg: np.ndarray,
                 n_syms: int, meta: dict, path: str | None = None):
        syms_pg = np.ascontiguousarray(syms_pg, np.int32)
        sums_pg = np.ascontiguousarray(sums_pg, np.int32)
        if syms_pg.shape != sums_pg.shape or syms_pg.ndim != 2:
            raise ValueError("syms/sums page arrays must share a 2-D shape")
        if path is not None:
            os.makedirs(path, exist_ok=True)
        path = tempfile.mkdtemp(prefix="repro-store-", dir=path)
        self.path = path
        shape = syms_pg.shape
        for name, arr in (("syms.i32", syms_pg), ("sums.i32", sums_pg)):
            mm = np.memmap(os.path.join(path, name), dtype=np.int32,
                           mode="w+", shape=shape)
            mm[:] = arr
            mm.flush()
            del mm                      # drop the writable mapping
        syms_mm = np.memmap(os.path.join(path, "syms.i32"), dtype=np.int32,
                            mode="r", shape=shape)
        sums_mm = np.memmap(os.path.join(path, "sums.i32"), dtype=np.int32,
                            mode="r", shape=shape)
        super().__init__(syms_mm, sums_mm, shape[1], n_syms, meta)
        self._finalizer = weakref.finalize(self, _rmtree, path)

    @property
    def disk_bytes(self) -> int:
        return 2 * self.num_pages * self.page_size * 4

    def _teardown(self) -> None:
        # runs only once every pinned reader has released (PageStore.close
        # defers otherwise): dropping the memmap references closes the
        # mappings, then the directory goes away
        self._syms_pg = self._sums_pg = None
        self._finalizer()
