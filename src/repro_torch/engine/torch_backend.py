"""Plain PyTorch programs of the engine operations.

The counterpart of ``repro/engine/jnp_backend.py``: every function takes
the :class:`FlatIndex` (or :class:`PagedIndex`) and int32 tensors on the
index's device and returns tensors there.  The loops keep the jnp
programs' fixed trip counts (``max_scan`` skip steps, ``max_depth``
descent steps, 32 bisection steps) and int32 arithmetic, so the values
are bit-identical to the JAX package's; they run eagerly, on the CPU or
on the card.  Stored tables stay int32; only gather indices are cast to
int64, the index type torch wants.

Semantics mirror ``core/intersect.py::LookupList.next_geq``:
  * bucket lookup gives a start state (stream position, absolute value),
  * phrase-sum skipping advances while s + sum < x,
  * a fixed-depth descent resolves the answer inside the phrase.

``skip_descend`` — everything after the bucket lookup — is also the plain
version of kernel K1 (``kernels/list_intersect/ops.py``), which starts
from the host router's start state.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.index import FlatIndex, PagedIndex, INT_INF

_INF = int(INT_INF)


def _i64(t: torch.Tensor) -> torch.Tensor:
    """Index form of an int32 tensor (torch gathers want int64)."""
    return t.long()


def _arange(n: int, like: torch.Tensor, start: int = 0) -> torch.Tensor:
    return torch.arange(start, start + n, dtype=torch.int32,
                        device=like.device)


def descend_value(sleft, sright, ssum, T: int, max_depth: int,
                  sym: torch.Tensor, s: torch.Tensor, x: torch.Tensor):
    """Fixed-depth value descent: inside the halting phrase ``sym``
    (absolute value ``s`` before it) go left while ``s + sum(left) >= x``,
    else consume the left child.  Returns the final terminal and ``s``."""
    for _ in range(max_depth):
        is_rule = sym >= T
        si = _i64(sym)
        left = torch.where(is_rule, sleft[si], sym)
        right = torch.where(is_rule, sright[si], sym)
        ls = ssum[_i64(left)]
        go_left = s + ls >= x
        sym = torch.where(is_rule, torch.where(go_left, left, right), sym)
        s = torch.where(is_rule & ~go_left, s + ls, s)
    return sym, s


def descend_position(sleft, sright, ssum, slen, T: int, max_depth: int,
                     sym: torch.Tensor, s: torch.Tensor, w: torch.Tensor):
    """Fixed-depth positional descent: the ``w``-th (1-based) gap element
    of phrase ``sym``, walking the grammar by per-node lengths.  Returns
    the final terminal and the absolute value before it."""
    for _ in range(max_depth):
        is_rule = sym >= T
        si = _i64(sym)
        left = torch.where(is_rule, sleft[si], sym)
        right = torch.where(is_rule, sright[si], sym)
        li = _i64(left)
        ll = slen[li]
        go_left = w <= ll
        step = is_rule & ~go_left
        sym = torch.where(is_rule, torch.where(go_left, left, right), sym)
        s = torch.where(step, s + ssum[li], s)
        w = torch.where(step, w - ll, w)
    return sym, s


def skip_descend(tables, *, T: int, max_scan: int, max_depth: int,
                 read_sym, read_sum, list_ids: torch.Tensor,
                 xs: torch.Tensor, pos: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """next_geq from a start state ``(pos, s)``: ``max_scan`` masked
    phrase-sum skips, ``max_depth`` descent steps, then the three selects
    (answered early, ran past the span, ``x`` beyond the list).
    ``tables`` maps ``starts``, ``lasts`` and the grammar tables
    (``sym_left``, ``sym_right``, ``sym_sum``) to tensors;
    ``read_sym``/``read_sum`` read the stream at absolute positions —
    reads outside a lane's span are clamped and their values discarded.

    A lane whose value the final selects decide (``s >= x`` from the
    start, past the span, ``x`` beyond the list) neither skips nor
    descends from what it read: on a real stream a read phrase sum is
    positive and ``s + sum`` stays a list value, so these guards change
    no answer, and through a resident pool they make the answer
    independent of the rows outside the probes' working set, whatever
    those hold."""
    lid = _i64(list_ids)
    end = tables["starts"][lid + 1]
    last = tables["lasts"][lid]
    ssum = tables["sym_sum"]
    for _ in range(max_scan):
        in_range = pos < end
        ps = torch.where(in_range, read_sum(pos), 0)
        take = in_range & (s < xs) & (s + ps < xs)
        pos = pos + take.to(torch.int32)
        s = torch.where(take, s + ps, s)
    done_early = s >= xs
    past_end = pos >= end
    live = ~done_early & ~past_end & (xs <= last)
    sym0 = torch.where(live, read_sym(pos), 0)
    sym_f, s_f = descend_value(tables["sym_left"], tables["sym_right"], ssum,
                               T, max_depth, sym0, s, xs)
    answer = s_f + ssum[_i64(sym_f)]
    out = torch.where(done_early, s, answer)
    out = torch.where(past_end & ~done_early, _INF, out)
    return torch.where(xs > last, _INF, out)


def _statics(fl: FlatIndex) -> dict:
    return dict(T=fl.num_terminals, max_scan=fl.max_scan,
                max_depth=fl.max_depth)


def _bucket_start(fl: FlatIndex, anchor, list_ids, xs):
    """(b)-sampling lookup: the bucket's anchor (``anchor(idx, start)``
    gives its absolute stream position) and the value before it; the
    head answers ``x <= first``.  ``>>`` is arithmetic on int32 where
    jnp's ``shift_right_logical`` is not; probes are non-negative doc ids
    or INT_INF, so the two agree here."""
    lid = _i64(list_ids)
    start = fl.starts[lid]
    first = fl.firsts[lid]
    b = xs >> fl.kbits[lid]
    boff = fl.bucket_offsets[lid]
    bnum = fl.bucket_offsets[lid + 1] - boff
    idx = _i64(boff + torch.minimum(b, bnum - 1))
    head = xs <= first
    return (torch.where(head, start, anchor(idx, start)),
            torch.where(head, first, fl.bck_abs[idx]))


def _clamped(table: torch.Tensor):
    last = max(int(table.shape[0]) - 1, 0)
    return lambda p: table[_i64(p.clamp(0, last))]


def _flat_readers(fi: FlatIndex):
    """Stream readers over the flat stream ``fi.c``: the symbol, and its
    phrase sum from the grammar."""
    read_sym = _clamped(fi.c)
    return read_sym, lambda p: fi.sym_sum[_i64(read_sym(p))]


def paged_readers(c_syms_pg: torch.Tensor, c_sums_pg: torch.Tensor):
    """Stream readers over the paged tables: position ``p`` is row
    ``p // PAGE``, column ``p % PAGE`` — the flattened table at ``p``."""
    return (_clamped(c_syms_pg.reshape(-1)),
            _clamped(c_sums_pg.reshape(-1)))


def next_geq_batch(fi: FlatIndex, list_ids: torch.Tensor,
                   xs: torch.Tensor) -> torch.Tensor:
    """(Q,) list ids × (Q,) probes -> (Q,) smallest element >= x (INT_INF)."""
    pos, s = _bucket_start(fi, lambda idx, start: start + fi.bck_c_pos[idx],
                           list_ids, xs)
    read_sym, read_sum = _flat_readers(fi)
    return skip_descend(vars(fi), **_statics(fi), read_sym=read_sym,
                        read_sum=read_sum, list_ids=list_ids, xs=xs, pos=pos,
                        s=s)


def resident_readers(pool_syms: torch.Tensor, pool_sums: torch.Tensor,
                     slot_tab: torch.Tensor, page: int):
    """Stream readers through a resident pool: position ``p`` lies in page
    ``p // page``, which ``slot_tab`` (``(num_pages,)``, -1 = absent) maps
    to a pool row; an absent page is clamped to row 0, as in the JAX
    package's ``_pool_read``."""
    last = int(slot_tab.shape[0]) * page - 1
    syms, sums = pool_syms.reshape(-1), pool_sums.reshape(-1)

    def at(p):
        p = _i64(p.clamp(0, last))
        return _i64(slot_tab[p // page].clamp(min=0)) * page + p % page

    return (lambda p: syms[at(p)]), (lambda p: sums[at(p)])


def _paged_start(pi: PagedIndex, list_ids, xs):
    return _bucket_start(
        pi.flat, lambda idx, start: pi.bck_page[idx] * pi.page_size
        + pi.bck_off[idx], list_ids, xs)


def next_geq_batch_paged(pi: PagedIndex, list_ids: torch.Tensor,
                         xs: torch.Tensor) -> torch.Tensor:
    """Paged twin of :func:`next_geq_batch`: anchors come as (page,
    offset), stream reads go through the paged tables."""
    pos, s = _paged_start(pi, list_ids, xs)
    read_sym, read_sum = paged_readers(pi.c_syms_pg, pi.c_sums_pg)
    return skip_descend(vars(pi.flat), **_statics(pi.flat),
                        read_sym=read_sym, read_sum=read_sum,
                        list_ids=list_ids, xs=xs, pos=pos, s=s)


def next_geq_batch_resident(pi: PagedIndex, pool_syms: torch.Tensor,
                            pool_sums: torch.Tensor, slot_tab: torch.Tensor,
                            list_ids: torch.Tensor,
                            xs: torch.Tensor) -> torch.Tensor:
    """Out-of-core twin of :func:`next_geq_batch_paged`: the stream is read
    through the resident pool.  Exact when the probes' working set is
    resident (the engine faults it in first)."""
    pos, s = _paged_start(pi, list_ids, xs)
    read_sym, read_sum = resident_readers(pool_syms, pool_sums, slot_tab,
                                          pi.page_size)
    return skip_descend(vars(pi.flat), **_statics(pi.flat),
                        read_sym=read_sym, read_sum=read_sum,
                        list_ids=list_ids, xs=xs, pos=pos, s=s)


def member_batch(fi: FlatIndex, list_ids, xs) -> torch.Tensor:
    return next_geq_batch(fi, list_ids, xs) == xs


def member_batch_paged(pi: PagedIndex, list_ids, xs) -> torch.Tensor:
    return next_geq_batch_paged(pi, list_ids, xs) == xs


def probe_batch(fi: FlatIndex, long_ids: torch.Tensor,
                xs: torch.Tensor) -> torch.Tensor:
    """Row-wise next_geq: (B,) list ids × (B, M) probes -> (B, M) values."""
    B, M = xs.shape
    return next_geq_batch(fi, long_ids.repeat_interleave(M),
                          xs.reshape(-1)).reshape(B, M)


def probe_batch_paged(pi: PagedIndex, long_ids: torch.Tensor,
                      xs: torch.Tensor) -> torch.Tensor:
    B, M = xs.shape
    return next_geq_batch_paged(pi, long_ids.repeat_interleave(M),
                                xs.reshape(-1)).reshape(B, M)


def build_bys_table(fi: FlatIndex) -> torch.Tensor:
    """Phrase-sum prefix table for the batched binary-search path:
    ``incl[pos]`` = absolute value of the LAST element expanded by the
    stream symbol at ``pos`` (strictly increasing within each list span,
    because gaps are positive).  One (N,) int32 tensor aligned with
    ``fi.c``, built once per index on the host."""
    c = fi.c.cpu().numpy()
    starts = fi.starts.cpu().numpy().astype(np.int64)
    firsts = fi.firsts.cpu().numpy().astype(np.int64)
    cs = np.cumsum(fi.sym_sum.cpu().numpy().astype(np.int64)[c])
    span_lens = np.diff(starts)
    # per-position offset so each span's cumsum restarts at its first value
    before = np.where(starts[:-1] > 0, cs[np.maximum(starts[:-1] - 1, 0)], 0)
    offset = np.repeat(firsts - before, span_lens)
    # an empty stream is padded with one symbol that no span covers
    # (``core.index.flat_index_arrays``)
    offset = np.pad(offset, (0, cs.size - offset.size))
    return torch.from_numpy((cs + offset).astype(np.int32)).to(fi.device)


def next_geq_bys_batch(fi: FlatIndex, incl: torch.Tensor,
                       list_ids: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """Binary-search next_geq ([BY04], the planner's "bys"): lower-bound
    the span's phrase-sum prefix table in 32 fixed bisection steps, then
    one fixed-depth descent inside the halting phrase."""
    lid = _i64(list_ids)
    start = fi.starts[lid]
    end = fi.starts[lid + 1]
    first = fi.firsts[lid]
    last = fi.lasts[lid]
    at = _clamped(incl)
    lo, hi = start, end
    for _ in range(32):
        done = lo >= hi
        mid = (lo + hi) // 2
        ge = at(mid) >= xs
        lo = torch.where(done | ge, lo, mid + 1)
        hi = torch.where(~done & ge, mid, hi)
    pos = lo
    s = torch.where(pos == start, first, at(pos - 1))
    sym_f, s_f = descend_value(fi.sym_left, fi.sym_right, fi.sym_sum,
                               fi.num_terminals, fi.max_depth,
                               _clamped(fi.c)(pos), s, xs)
    answer = s_f + fi.sym_sum[_i64(sym_f)]
    out = torch.where(pos >= end, _INF, answer)
    out = torch.where(xs <= first, first, out)   # the head answers (even
    return torch.where(xs > last, _INF, out)     # when the span is empty)


def _window_prefix(fi: FlatIndex, readers, lo: torch.Tensor,
                   hi: torch.Tensor, base: torch.Tensor, win: int):
    """Symbols of the stream windows ``[lo, lo + win)`` masked to
    ``[lo, hi)``, with int32 running element counts and running absolute
    values (from ``base``) after each symbol.  ``readers`` are the
    ``(read_sym, read_sum)`` pair of the stream's layout."""
    read_sym, read_sum = readers
    idx = lo[:, None] + _arange(win, lo)[None, :]
    valid = idx < hi[:, None]
    syms = torch.where(valid, read_sym(idx), 0)
    lens = torch.where(valid, fi.sym_len[_i64(syms)], 0)
    sums = torch.where(valid, read_sum(idx), 0)
    cum_len = torch.cumsum(lens, 1, dtype=torch.int32)
    cum_sum = torch.cumsum(sums, 1, dtype=torch.int32) + base[:, None]
    return syms, cum_len, cum_sum


def _locate(fi: FlatIndex, syms, cum_len, cum_sum, base, w, win: int):
    """Value of the ``w``-th (1-based) gap element of each window: find
    its owning symbol (searchsorted-left on the running counts), then the
    positional descent inside it."""
    k = torch.searchsorted(cum_len, w, right=False).to(torch.int32)
    k = torch.clamp(k, max=win - 1)
    km1 = _i64(torch.clamp(k - 1, min=0))
    base_s = torch.where(k > 0, torch.gather(cum_sum, 1, km1), base[:, None])
    base_t = torch.where(k > 0, torch.gather(cum_len, 1, km1), 0)
    sym0 = torch.gather(syms, 1, _i64(k))
    sym_f, s_f = descend_position(fi.sym_left, fi.sym_right, fi.sym_sum,
                                  fi.sym_len, fi.num_terminals, fi.max_depth,
                                  sym0, base_s, w - base_t)
    return s_f + fi.sym_sum[_i64(sym_f)]


def expand_batch(fi: FlatIndex, list_ids: torch.Tensor,
                 max_len: int, readers=None) -> torch.Tensor:
    """Batched full-list expansion: list -> (max_len,) absolute ids padded
    with INT_INF, by pointer-free positional descent (output slot t finds
    the t-th element by walking the grammar with per-node lengths).
    ``readers`` (default: the flat stream) read the stream."""
    lid = _i64(list_ids)
    first = fi.firsts[lid]
    syms, cum_len, cum_sum = _window_prefix(
        fi, readers or _flat_readers(fi), fi.starts[lid],
        fi.starts[lid + 1], first, max_len)
    t = _arange(max_len, first, 1)[None, :].expand(lid.shape[0], -1)
    vals = _locate(fi, syms, cum_len, cum_sum, first, t.contiguous(),
                   max_len)
    # element 0 is the head; output[0] = first, output[i] = vals[i - 1]
    out = torch.cat([first[:, None], vals[:, :max_len - 1]], 1)
    pos = _arange(max_len, first)[None, :]
    return torch.where(pos < fi.lengths[lid][:, None], out, _INF)


def decode_pages_batch(fi: FlatIndex, sym_lo: torch.Tensor,
                       sym_hi: torch.Tensor, base: torch.Tensor,
                       head: torch.Tensor, *, win: int,
                       max_elems: int, readers=None) -> torch.Tensor:
    """Batched block-max page-entry decode: each lane expands ONE entry of
    the score directory — the stream symbols ``[sym_lo, sym_hi)`` of one
    page — to absolute doc ids from the entry's running ``base``.  ``head``
    = 1 emits the list head (``base`` itself) in slot 0 before the gap
    elements.  Output (Q, max_elems) int32, INT_INF padded.  ``readers``
    (default: the flat stream) read the stream."""
    syms, cum_len, cum_sum = _window_prefix(
        fi, readers or _flat_readers(fi), sym_lo, sym_hi, base, win)
    total = head + cum_len[:, win - 1]
    j = _arange(max_elems, base)[None, :]
    want = j - head[:, None] + 1   # 1-based gap-element index; < 1 -> base
    w = torch.clamp(want, min=1).contiguous()
    vals = _locate(fi, syms, cum_len, cum_sum, base, w, win)
    out = torch.where(want < 1, base[:, None], vals)
    return torch.where(j < total[:, None], out, _INF)


def expand_batch_resident(pi: PagedIndex, pool_syms: torch.Tensor,
                          pool_sums: torch.Tensor, slot_tab: torch.Tensor,
                          list_ids: torch.Tensor,
                          max_len: int) -> torch.Tensor:
    """Out-of-core twin of :func:`expand_batch`: the same positional
    descent, stream symbols read through the pool, phrase sums from the
    pre-gathered sums pages (``sym_sum[c]`` by construction)."""
    return expand_batch(pi.flat, list_ids, max_len, readers=resident_readers(
        pool_syms, pool_sums, slot_tab, pi.page_size))


def decode_pages_resident(pi: PagedIndex, pool_syms: torch.Tensor,
                          pool_sums: torch.Tensor, slot_tab: torch.Tensor,
                          sym_lo: torch.Tensor, sym_hi: torch.Tensor,
                          base: torch.Tensor, head: torch.Tensor, *,
                          win: int, max_elems: int) -> torch.Tensor:
    """Out-of-core twin of :func:`decode_pages_batch` (the ranked tier's
    page-entry decode) over the resident pool."""
    return decode_pages_batch(
        pi.flat, sym_lo, sym_hi, base, head, win=win, max_elems=max_elems,
        readers=resident_readers(pool_syms, pool_sums, slot_tab,
                                 pi.page_size))


def accumulate_scores_device(idf_terms: torch.Tensor,
                             doc_w_docs: torch.Tensor,
                             member: torch.Tensor) -> torch.Tensor:
    """Device twin of :func:`repro_torch.core.index.accumulate_scores`:
    the same SEQUENTIAL float32 idf sum (one elementwise add per term, in
    the fixed ascending-term order — never a ``torch.sum``, whose tree
    order would change the rounding) followed by the single doc-weight
    multiply.  Elementwise IEEE float32 adds round identically on the CPU
    and the card, so device scores are bit-identical to the host
    reduction.  ``idf_terms`` (K,) f32, ``doc_w_docs`` (D,) f32,
    ``member`` (K, D) bool."""
    acc = torch.zeros(member.shape[1], dtype=torch.float32,
                      device=member.device)
    zero = torch.zeros((), dtype=torch.float32, device=member.device)
    for k in range(member.shape[0]):
        acc = acc + torch.where(member[k], idf_terms[k], zero)
    return doc_w_docs * acc


def match_mask(vals: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Keep probes that hit: INT_INF padding never matches."""
    return torch.where((vals == xs) & (xs != _INF), xs, _INF)
