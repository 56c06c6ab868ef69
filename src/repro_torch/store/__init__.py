"""Out-of-core tiered storage (DESIGN.md §11), copied from ``repro/store``.

``PageStore`` (memory / mmap) holds the compressed stream in fixed pages;
``ResidentSet`` is the bounded admission cache the engines dispatch
against.  ``build_page_store`` is the one factory; ``resolve_store_kind``
maps the ``store=`` argument / ``REPRO_STORE`` env to a backend name.
"""

from __future__ import annotations

import os

import numpy as np

from .base import (PageStore, StoreResView, meta_from_parts,
                   normalize_page_size, paged_stream_arrays, pages_in_spans)
from .memory import MemoryPageStore
from .mmap_store import MmapPageStore
from .resident import RESIDENT_ENV, ResidentSet, resident_budget

STORE_ENV = "REPRO_STORE"
STORE_DIR_ENV = "REPRO_STORE_DIR"

_KINDS = {"memory": MemoryPageStore, "mmap": MmapPageStore}


def resolve_store_kind(store) -> str | None:
    """Normalize a ``store=`` request: ``None`` defers to the
    ``REPRO_STORE`` env; empty/none/off disables the seam; otherwise one
    of ``memory`` / ``mmap``.  A prebuilt :class:`PageStore` passes
    through as-is."""
    if isinstance(store, PageStore):
        return store
    if store is None:
        store = os.environ.get(STORE_ENV, "")
    s = str(store).strip().lower()
    if s in ("", "none", "off", "0"):
        return None
    if s in ("mem", "ram"):
        s = "memory"
    if s not in _KINDS:
        raise ValueError(f"unknown page store kind {store!r} "
                         f"(expected one of {sorted(_KINDS)})")
    return s


def build_page_store(res, kind: str = "memory",
                     page_size: int | None = None, pi=None,
                     store_dir: str | None = None) -> PageStore:
    """Build a page store for one compressed index.

    When the caller already paged the stream (``pi=`` a ``PagedIndex``
    with real tensors), host copies of its pages are reused — zero recompute and
    guaranteed bit-identity with the device arrays.  Otherwise the stream
    is paged here with the same canonical dense re-encoding."""
    kind = resolve_store_kind(kind if kind is not None else "memory")
    if isinstance(kind, PageStore):
        return kind
    if kind is None:
        kind = "memory"
    if pi is not None:
        host = lambda t: t.cpu().numpy()
        syms_pg = host(pi.c_syms_pg).astype(np.int32)
        sums_pg = host(pi.c_sums_pg).astype(np.int32)
        fl = pi.flat
        T = int(fl.num_terminals)
        starts = host(fl.starts).astype(np.int64)
        meta = meta_from_parts(
            starts, host(fl.sym_sum).astype(np.int64)[:T],
            None if res is None else int(res.grammar.num_terminals))
        n_syms = int(starts[-1])
    else:
        P = normalize_page_size(page_size)
        syms_pg, sums_pg, meta = paged_stream_arrays(res, P)
        n_syms = int(meta["starts"][-1])
    if kind == "memory":
        return MemoryPageStore(syms_pg, sums_pg, n_syms, meta)
    if store_dir is None:
        store_dir = os.environ.get(STORE_DIR_ENV, "").strip() or None
    return MmapPageStore(syms_pg, sums_pg, n_syms, meta, path=store_dir)


__all__ = [
    "PageStore", "MemoryPageStore", "MmapPageStore", "ResidentSet",
    "StoreResView", "build_page_store", "resolve_store_kind",
    "resident_budget", "normalize_page_size", "paged_stream_arrays",
    "pages_in_spans", "meta_from_parts", "STORE_ENV", "STORE_DIR_ENV",
    "RESIDENT_ENV",
]
