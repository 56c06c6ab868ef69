"""Device-resident form of the Re-Pair compressed inverted index, in torch.

The counterpart of ``repro/core/jax_index.py``.  The host construction
artifacts are flattened into fixed-width int32 tensors on one device:

* the grammar becomes four symbol-indexed tables (``sym_left``,
  ``sym_right``, ``sym_sum``, ``sym_len``);
* the compressed sequence ``C`` stays one int32 stream with per-list spans;
* the (b)-sampling becomes flattened bucket tables with a static scan
  bound (max symbols overlapping one bucket) and a static descent bound
  (max rule depth), so every probe runs a bounded instruction sequence.

Symbols are re-encoded densely: ids ``0..T-1`` are the distinct terminal
gap values that occur (value table ``sym_sum[:T]``), ids ``T..T+R-1`` are
rules.

Every table is built on the host with numpy and moved to ``device`` once;
the four static bounds stay plain ints.  ``flat_index_from_arrays`` /
``paged_index_from_arrays`` rebuild an index from numpy arrays, so the
tests can hand the JAX package's index state to this package and both
compute over the same state.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .repair import RePairResult
from .sampling import BSampling, build_b_sampling, _phrase_sums_for

INT_INF = np.int32(2**31 - 1)

#: Default stream page size (symbols per page), a multiple of 128;
#: overridable via REPRO_PAGE_SIZE so tests can force multi-page lists on
#: tiny corpora.
DEFAULT_PAGE = int(os.environ.get("REPRO_PAGE_SIZE", "2048"))

#: BM25 parameters.  The postings are binary (tf == 1 for every posting),
#: so the tf saturation term collapses to a per-document weight; k1/b keep
#: their standard roles through that weight.
BM25_K1 = 0.9
BM25_B = 0.4

_FLAT_ARRAYS = ("sym_left", "sym_right", "sym_sum", "sym_len", "c", "starts",
                "firsts", "lengths", "lasts", "kbits", "bucket_offsets",
                "bck_c_pos", "bck_abs")
_FLAT_STATICS = ("num_terminals", "max_depth", "max_scan", "universe")
_PAGED_ARRAYS = ("c_syms_pg", "c_sums_pg", "page_dir", "bck_page", "bck_off")


@dataclasses.dataclass
class FlatIndex:
    """All tensors are int32 on one device.  L lists, S symbols (dense
    re-encoding), R rules, total C length N."""

    # grammar tables (size S = num_dense_terminals + R)
    sym_left: torch.Tensor     # child symbol id, -1 for terminals
    sym_right: torch.Tensor
    sym_sum: torch.Tensor      # phrase sum (terminal -> its gap value)
    sym_len: torch.Tensor      # expanded length (terminal -> 1)

    # compressed stream
    c: torch.Tensor            # (N,) dense symbol ids
    starts: torch.Tensor       # (L+1,)
    firsts: torch.Tensor       # (L,)
    lengths: torch.Tensor      # (L,) uncompressed lengths
    lasts: torch.Tensor        # (L,) last element of each list

    # (b)-sampling, flattened
    kbits: torch.Tensor        # (L,) per-list bucket shift
    bucket_offsets: torch.Tensor  # (L+1,) into the two tensors below
    bck_c_pos: torch.Tensor    # per-bucket symbol offset within the list span
    bck_abs: torch.Tensor      # per-bucket absolute value before that symbol

    # static bounds
    num_terminals: int
    max_depth: int
    max_scan: int
    universe: int

    @property
    def device(self) -> torch.device:
        return self.c.device


def _dense_remap(syms: np.ndarray, term_values: np.ndarray,
                 nt: int) -> np.ndarray:
    """Old symbol ids -> dense ids: terminals map through ``term_values``
    (searchsorted — exact because every used terminal is in the table),
    rules shift down to ``T + rule_index``."""
    syms = np.asarray(syms, dtype=np.int64)
    T = term_values.size
    is_rule = syms >= nt
    out = np.empty(syms.shape, dtype=np.int32)
    out[~is_rule] = np.searchsorted(term_values, syms[~is_rule])
    out[is_rule] = (T + (syms[is_rule] - nt)).astype(np.int32)
    return out


def flat_index_arrays(res: RePairResult, B: int = 8,
                      bsamp: BSampling | None = None
                      ) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """The flat index of ``res`` as numpy int32 arrays plus its static
    bounds — the same values ``repro.core.jax_index.build_flat_index``
    computes (numpy index arithmetic, no per-rule Python loops)."""
    g = res.grammar
    nt = g.num_terminals
    R = g.num_rules
    L = res.num_lists

    # Dense terminal re-encoding: distinct terminal values used in C or as
    # rule children.
    pools = [np.unique(res.seq)]
    if R:
        pools.append(np.unique(g.rules.reshape(-1)))
    used = np.unique(np.concatenate(pools))
    term_values = used[used < nt].astype(np.int64)
    # every list a single posting (a segment flushed from one document)
    # leaves the stream empty; the device programs gather from the stream
    # and the tables, so both get one terminal that no list span reads
    empty = res.seq.size == 0
    if empty:
        term_values = np.zeros(1, np.int64)
    T = term_values.size
    S = T + R

    sym_left = np.full(S, -1, dtype=np.int32)
    sym_right = np.full(S, -1, dtype=np.int32)
    sym_sum = np.zeros(S, dtype=np.int32)
    sym_len = np.ones(S, dtype=np.int32)
    sym_sum[:T] = term_values
    if R:
        sym_left[T:] = _dense_remap(g.rules[:, 0], term_values, nt)
        sym_right[T:] = _dense_remap(g.rules[:, 1], term_values, nt)
        sym_sum[T:] = g.sums.astype(np.int32)
        sym_len[T:] = g.lengths.astype(np.int32)

    c_dense = (np.zeros(1, np.int32) if empty else
               _dense_remap(res.seq, term_values, nt))

    bs = bsamp or build_b_sampling(res, B)
    kbits = np.asarray(bs.kbits, dtype=np.int32)
    bucket_counts = np.asarray([cp.size for cp in bs.c_pos], dtype=np.int64)
    bucket_offsets = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(bucket_counts, out=bucket_offsets[1:])
    bck_c_pos = (np.concatenate(bs.c_pos) if L else
                 np.zeros(0)).astype(np.int32)
    bck_abs = (np.concatenate(bs.abs_before) if L else
               np.zeros(0)).astype(np.int32)

    # static scan bound: max symbols between consecutive bucket anchors,
    # plus the tail from the final anchor to the end of the list span.
    starts = res.starts.astype(np.int64)
    spans = starts[1:] - starts[:-1]
    max_scan = 1
    if bck_c_pos.size:
        diffs = np.diff(bck_c_pos.astype(np.int64))
        # mask out differences that straddle a list boundary
        keep = np.ones(diffs.size, dtype=bool)
        inner = bucket_offsets[1:-1].astype(np.int64) - 1
        keep[inner[(inner >= 0) & (inner < diffs.size)]] = False
        if keep.any():
            max_scan = max(max_scan, int(diffs[keep].max()) + 1)
    # tail per list: span - last anchor (0 when the list has no buckets)
    last_anchor = np.zeros(L, dtype=np.int64)
    has_b = bucket_counts > 0
    last_anchor[has_b] = bck_c_pos[bucket_offsets[1:][has_b] - 1]
    if L:
        max_scan = max(max_scan, int((spans - last_anchor).max()) + 1)

    sums = _phrase_sums_for(res.seq, g)
    csum = np.concatenate([[0], np.cumsum(sums)])
    lasts = (res.first_values.astype(np.int64)
             + (csum[starts[1:]] - csum[starts[:-1]])).astype(np.int32)

    arrays = dict(
        sym_left=sym_left, sym_right=sym_right, sym_sum=sym_sum,
        sym_len=sym_len, c=c_dense,
        starts=res.starts.astype(np.int32),
        firsts=res.first_values.astype(np.int32),
        lengths=res.orig_lengths.astype(np.int32), lasts=lasts,
        kbits=kbits, bucket_offsets=bucket_offsets, bck_c_pos=bck_c_pos,
        bck_abs=bck_abs)
    statics = dict(num_terminals=T, max_depth=max(1, int(g.max_depth())),
                   max_scan=max_scan, universe=int(res.universe))
    return arrays, statics


def _on(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` as an int32 tensor on ``device``."""
    return torch.tensor(np.asarray(a, dtype=np.int32), device=device)


def flat_index_from_arrays(arrays: dict[str, np.ndarray], statics: dict,
                           device) -> FlatIndex:
    """A :class:`FlatIndex` on ``device`` from numpy arrays named like its
    fields (extra keys are ignored) and its four static bounds."""
    return FlatIndex(**{k: _on(arrays[k], device) for k in _FLAT_ARRAYS},
                     **{k: int(statics[k]) for k in _FLAT_STATICS})


def build_flat_index(res: RePairResult, B: int = 8,
                     bsamp: BSampling | None = None,
                     device="cuda") -> FlatIndex:
    """Flatten a :class:`RePairResult` (+ its (b)-sampling) onto
    ``device``."""
    arrays, statics = flat_index_arrays(res, B, bsamp)
    return flat_index_from_arrays(arrays, statics, device)


@dataclasses.dataclass
class PagedIndex:
    """Paged view of a :class:`FlatIndex`: the compressed stream reshaped
    into fixed-size pages, so consumers address ``(page, offset)``.  Two
    paged copies of C are kept: dense symbol ids and pre-gathered phrase
    sums ``sym_sum[c]``.

    * ``c_syms_pg, c_sums_pg`` — ``(num_pages, page_size)``, zero-padded
      past N (padding is never selected: every read is masked by the list
      span);
    * ``page_dir`` — ``(L+1,)`` page of each list's span start; entry L is
      the page one past the final list;
    * ``bck_page, bck_off`` — the (b)-sampling bucket tables re-addressed
      as (page, offset) of the anchor symbol.

    Out of core (DESIGN.md §11): when ``store`` is set, the stream pages
    live behind that :class:`repro_torch.store.PageStore` and
    ``c_syms_pg`` / ``c_sums_pg`` shrink to a ``(1, page_size)``
    placeholder — consumers dispatch against a resident pool instead, and
    ``num_pages`` reports the store's geometry.  The directory and bucket
    tensors stay real (they are the RAM tier, per the paper).
    """

    flat: FlatIndex
    c_syms_pg: torch.Tensor    # (num_pages, page_size) dense symbol ids
    c_sums_pg: torch.Tensor    # (num_pages, page_size) phrase sums sym_sum[c]
    page_dir: torch.Tensor     # (L+1,) first page of each list span
    bck_page: torch.Tensor     # per-bucket anchor page
    bck_off: torch.Tensor      # per-bucket offset within the page

    page_size: int
    #: optional PageStore that owns the stream pages
    store: object = None

    @property
    def num_pages(self) -> int:
        if self.store is not None:
            return int(self.store.num_pages)
        return int(self.c_syms_pg.shape[0])


def as_store_backed(pi: PagedIndex, store) -> PagedIndex:
    """Swap a paged index's stream tensors for a placeholder and attach
    the page store that now owns them — after this, a consumer that still
    reads ``c_syms_pg`` / ``c_sums_pg`` directly sees shapes it cannot
    miss."""
    z = torch.zeros((1, pi.page_size), dtype=torch.int32,
                    device=pi.c_syms_pg.device)
    return dataclasses.replace(pi, c_syms_pg=z, c_sums_pg=z, store=store)


def paged_index_arrays(arrays: dict[str, np.ndarray], page_size: int
                       ) -> tuple[dict[str, np.ndarray], int]:
    """The paged tables of a flat index given as numpy arrays, and the
    page size rounded up to a multiple of 128.  Pure reshaping — values
    are untouched, so paged and flat consumers agree bit-exactly."""
    page_size = max(128, -(-page_size // 128) * 128)
    c = np.asarray(arrays["c"], dtype=np.int32)
    sums = np.asarray(arrays["sym_sum"], dtype=np.int32)[c]
    N = c.size
    num_pages = max(1, -(-N // page_size))
    pad = num_pages * page_size - N
    starts = np.asarray(arrays["starts"], dtype=np.int64)
    boffs = np.asarray(arrays["bucket_offsets"], dtype=np.int64)
    bpos = np.asarray(arrays["bck_c_pos"], dtype=np.int64)
    # absolute anchor position of every bucket: span start + in-span offset
    owner = np.repeat(np.arange(starts.size - 1), np.diff(boffs))
    abs_pos = starts[owner] + bpos
    paged = dict(
        c_syms_pg=np.pad(c, (0, pad)).reshape(num_pages, page_size),
        c_sums_pg=np.pad(sums, (0, pad)).reshape(num_pages, page_size),
        page_dir=(starts // page_size).astype(np.int32),
        bck_page=(abs_pos // page_size).astype(np.int32),
        bck_off=(abs_pos % page_size).astype(np.int32))
    return paged, page_size


def paged_index_from_arrays(arrays: dict[str, np.ndarray], statics: dict,
                            device) -> PagedIndex:
    """A :class:`PagedIndex` on ``device`` from numpy arrays: the flat
    fields plus the five paged ones, and the flat statics plus
    ``page_size``."""
    return PagedIndex(flat=flat_index_from_arrays(arrays, statics, device),
                      **{k: _on(arrays[k], device) for k in _PAGED_ARRAYS},
                      page_size=int(statics["page_size"]))


def index_to_arrays(index: FlatIndex | PagedIndex
                    ) -> tuple[dict[str, np.ndarray], dict[str, int]]:
    """Inverse of the ``*_from_arrays`` builders: numpy arrays and
    statics of a flat or paged index."""
    fi = index.flat if isinstance(index, PagedIndex) else index
    arrays = {k: getattr(fi, k).cpu().numpy() for k in _FLAT_ARRAYS}
    statics = {k: getattr(fi, k) for k in _FLAT_STATICS}
    if isinstance(index, PagedIndex):
        arrays.update({k: getattr(index, k).cpu().numpy()
                       for k in _PAGED_ARRAYS})
        statics["page_size"] = index.page_size
    return arrays, statics


def build_paged_index(fi: FlatIndex, page_size: int = DEFAULT_PAGE,
                      store: "str | object | None" = None,
                      store_dir: str | None = None) -> PagedIndex:
    """Reshape a flat index's stream into ``(num_pages, page_size)`` pages
    on the flat index's device and re-address the bucket tables as
    (page, offset).

    ``store`` (explicit only — the engines resolve ``REPRO_STORE``)
    additionally builds a page store from the freshly paged tensors and,
    for disk-backed kinds, swaps the stream tensors for placeholders via
    :func:`as_store_backed`."""
    arrays, statics = index_to_arrays(fi)
    paged, statics["page_size"] = paged_index_arrays(arrays, page_size)
    pi = PagedIndex(flat=fi,
                    **{k: _on(v, fi.device) for k, v in paged.items()},
                    page_size=statics["page_size"])
    if store is not None:
        from ..store import PageStore, build_page_store
        if not isinstance(store, PageStore):
            store = build_page_store(None, kind=store, pi=pi,
                                     store_dir=store_dir)
        if store.kind != "memory":
            pi = as_store_backed(pi, store)
        else:
            pi = dataclasses.replace(pi, store=store)
    return pi


# -- ranked scoring: BM25 tables + block-max page directory ------------------

def bm25_idf(df: np.ndarray, ndocs: int) -> np.ndarray:
    """Per-term idf, float64 math rounded ONCE to float32 — the one shared
    rounding point that keeps engine scoring and the brute-force oracle
    bit-identical.  ``log(1 + (N - df + 0.5) / (df + 0.5))`` is the
    non-negative BM25+ variant (df can approach N on Zipf heads)."""
    df = np.asarray(df, np.float64)
    return np.log1p((float(ndocs) - df + 0.5) / (df + 0.5)).astype(np.float32)


def bm25_doc_weights(dl: np.ndarray, avgdl: float, k1: float = BM25_K1,
                     b: float = BM25_B) -> np.ndarray:
    """Per-document BM25 weight under binary postings: with tf == 1 the
    score factorizes as ``score(d) = doc_w[d] * sum(idf[t] : d in list t)``
    where ``doc_w = (k1+1) / (1 + k1*(1 - b + b*dl/avgdl))``.  float64
    math, one float32 rounding; 0 for documents in no list."""
    dl = np.asarray(dl, np.float64)
    w = (k1 + 1.0) / (1.0 + k1 * (1.0 - b + b * dl / max(avgdl, 1e-12)))
    return np.where(dl > 0, w, 0.0).astype(np.float32)


def accumulate_scores(si: "ScoreIndex", terms: np.ndarray,
                      member: np.ndarray, docs: np.ndarray) -> np.ndarray:
    """The ONE scoring reduction: float32 sum of idf over the member terms
    in ASCENDING term-id order, then one float32 multiply by the doc
    weight.  Every backend and the oracle run this exact operation
    sequence, so ranked scores are bit-comparable — float32 addition is
    not associative, the fixed order is what buys equality.

    ``terms`` (K,) ascending ids, ``member`` (K, D) bool, ``docs`` (D,)."""
    acc = np.zeros(docs.size, np.float32)
    for j in range(int(terms.size)):
        acc = acc + np.where(member[j], si.idf[int(terms[j])],
                             np.float32(0.0))
    return (si.doc_w[docs] * acc).astype(np.float32)


@dataclasses.dataclass
class ScoreIndex:
    """BM25 scoring tables + the block-max page directory.

    Every posting list is cut at the SAME page boundaries as the paged
    stream, and each (list, page) intersection becomes one *page entry*
    carrying everything a device decode of just that page needs (symbol
    range, running base value, head flag) plus the float32 upper bound of
    any single-term contribution ``idf[t] * doc_w[d]`` inside it — the
    WAND block max.  ``idf`` and ``doc_w`` are rounded to float32 first
    and the per-page max is taken over the rounded products, so it is a
    true upper bound of the float32 scores the engines produce.

    The tables stay numpy on the host: the ranked step machine
    (``query/topk.py``) reads them there, and an engine moves the
    per-entry metadata of each ScoreRound to its device.
    """

    # global tables
    idf: np.ndarray         # (L,) f32 per-term idf
    doc_w: np.ndarray       # (U,) f32 per-doc BM25 weight (0: in no list)
    list_max: np.ndarray    # (L,) f32 max single-term contribution per list

    # block-max page directory: one entry per (list, stream page)
    page_off: np.ndarray    # (L+1,) entry span of each list
    pg_list: np.ndarray     # (E,) owning list id
    pg_page: np.ndarray     # (E,) global stream page id
    pg_sym_lo: np.ndarray   # (E,) absolute symbol range within the page
    pg_sym_hi: np.ndarray   # (E,)
    pg_base: np.ndarray     # (E,) absolute value before the first element
    pg_last: np.ndarray     # (E,) last element — [base, last] is the doc-id
                            #      range the Block-Max rest aligns on
    pg_head: np.ndarray     # (E,) 1 iff the entry emits the list head
    pg_elem_lo: np.ndarray  # (E,) first decoded-element index (host slicing)
    pg_count: np.ndarray    # (E,) elements the entry decodes to
    pg_ub: np.ndarray       # (E,) f32 block max of idf*doc_w in the entry
    pg_wmax: np.ndarray     # (E,) f32 block max of doc_w alone — the
                            #      second admission bound (wmax * sum idf)

    # static configuration
    page_size: int
    max_page_elems: int
    ndocs: int
    k1: float
    b: float
    avgdl: float


def build_score_index(res: RePairResult, page_size: int | None = None,
                      k1: float = BM25_K1, b: float = BM25_B) -> ScoreIndex:
    """Precompute the scoring tier for one compressed index (host numpy,
    once per index build).

    ``page_size`` must match the layout of the engine that will decode the
    page entries (``None`` = ``DEFAULT_PAGE``); document length here is
    the number of lists containing the document (binary postings)."""
    P = DEFAULT_PAGE if page_size is None else \
        max(128, -(-int(page_size) // 128) * 128)
    g = res.grammar
    nt = g.num_terminals
    L = res.num_lists
    starts = np.asarray(res.starts, np.int64)
    N = int(starts[-1])
    num_pages = max(1, -(-N // P))

    decoded = [res.decode_list(i) for i in range(L)]
    dl = np.zeros(max(1, int(res.universe)), np.int64)
    for d in decoded:
        dl[d] += 1
    ndocs = int((dl > 0).sum())
    avgdl = float(dl.sum() / max(ndocs, 1))
    idf = bm25_idf(np.asarray(res.orig_lengths, np.int64), ndocs)
    doc_w = bm25_doc_weights(dl, avgdl, k1, b)

    # expansion length of every stream symbol (gaps it decodes to)
    seq = np.asarray(res.seq, np.int64)
    sym_lens = np.ones(N, np.int64)
    if g.num_rules:
        is_rule = seq >= nt
        sym_lens[is_rule] = np.asarray(g.lengths,
                                       np.int64)[seq[is_rule] - nt]

    page_off = np.zeros(L + 1, np.int64)
    cols: dict[str, list] = {k: [] for k in
                             ("list", "page", "sym_lo", "sym_hi", "base",
                              "last", "head", "elem_lo", "count", "ub",
                              "wmax")}
    list_max = np.zeros(L, np.float32)
    for i in range(L):
        docs = decoded[i]
        n = docs.size
        if n == 0:
            page_off[i + 1] = len(cols["page"])
            continue
        lo, hi = int(starts[i]), int(starts[i + 1])
        # gaps decoded before each span-symbol boundary (element j of the
        # list is the head for j == 0, else the (j-1)-th gap)
        gcb = np.concatenate([[0], np.cumsum(sym_lens[lo:hi])])
        contrib = (np.float32(idf[i]) * doc_w[docs]).astype(np.float32)
        list_max[i] = contrib.max()
        p0 = min(lo // P, num_pages - 1)
        p1 = (hi - 1) // P if hi > lo else p0
        for p in range(p0, p1 + 1):
            slo, shi = max(lo, p * P), min(hi, (p + 1) * P)
            head = 1 if p == p0 else 0
            glo = int(gcb[slo - lo]) if shi > slo else 0
            ghi = int(gcb[shi - lo]) if shi > slo else 0
            elem_lo = 0 if head else 1 + glo
            count = head + (ghi - glo)
            cols["list"].append(i)
            cols["page"].append(p)
            cols["sym_lo"].append(slo)
            cols["sym_hi"].append(shi)
            cols["base"].append(int(docs[0]) if head else int(docs[glo]))
            cols["last"].append(int(docs[elem_lo + count - 1]))
            cols["head"].append(head)
            cols["elem_lo"].append(elem_lo)
            cols["count"].append(count)
            cols["ub"].append(contrib[elem_lo:elem_lo + count].max())
            cols["wmax"].append(doc_w[docs[elem_lo:elem_lo + count]].max())
        page_off[i + 1] = len(cols["page"])

    counts = np.asarray(cols["count"], np.int64)
    return ScoreIndex(
        idf=idf, doc_w=doc_w, list_max=list_max,
        page_off=page_off.astype(np.int32),
        pg_list=np.asarray(cols["list"], np.int32),
        pg_page=np.asarray(cols["page"], np.int32),
        pg_sym_lo=np.asarray(cols["sym_lo"], np.int32),
        pg_sym_hi=np.asarray(cols["sym_hi"], np.int32),
        pg_base=np.asarray(cols["base"], np.int32),
        pg_last=np.asarray(cols["last"], np.int32),
        pg_head=np.asarray(cols["head"], np.int32),
        pg_elem_lo=np.asarray(cols["elem_lo"], np.int32),
        pg_count=counts.astype(np.int32),
        pg_ub=np.asarray(cols["ub"], np.float32),
        pg_wmax=np.asarray(cols["wmax"], np.float32),
        page_size=P,
        max_page_elems=int(counts.max(initial=1)),
        ndocs=ndocs, k1=float(k1), b=float(b), avgdl=avgdl,
    )
