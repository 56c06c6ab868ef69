"""Elias-Fano encoding of inverted lists (quasi-succinct indices, Vigna).

Each strictly-increasing list ``v`` of length ``n`` with last value
``last`` is split at ``l = max(0, floor(log2((last+1)/n)))``:

* **low bits** — the ``l`` low-order bits of every element, packed
  LSB-first into a flat ``uint32`` array (``n*l`` bits per list);
* **high bits** — the values ``v >> l`` in unary: bit ``(v[i] >> l) + i``
  is set in the list's high region, so the region holds ``n`` ones and
  ``h_max + 1`` zeros (``h_max = last >> l``).

``next_geq(x)`` needs *select* on the high bits: with ``hx = x >> l``,

* ``i1 = select0(hx) - hx`` counts elements whose high part is ``<= hx``;
* ``i0 = select0(hx-1) - (hx-1)`` (or 0) counts those ``< hx``;
* a binary search over the packed lows in the bucket ``[i0, i1)`` finds
  the first element with low part ``>= x & ((1<<l)-1)``; on a miss the
  answer is element ``i1`` whose high part comes from ``select1(i1)``.

Select is answered from **per-page samples**: the store keeps a rank-of-
ones directory with one entry per ``SEL_PAGE`` words of the high-bits
array (derived by :meth:`EFStore.select_samples` and cached by the
engines).  A select is a fixed-trip bisection over the page samples, a
``SEL_PAGE``-word popcount scan, and a 32-step in-word scan — the same
arithmetic, instruction for instruction, in the vectorized numpy
implementation (:func:`ef_next_geq_np`) and the torch one
(:func:`ef_next_geq_torch`), so the two are bit-identical by
construction and the tests can compare them directly.

All words are ``uint32``.

The numpy half (the store, its builders and :func:`ef_next_geq_np`) is a
copy of ``repro/core/ef.py``.  The device half is torch:
:func:`ef_device_pack` puts the store on a device as int32 tensors, and
:func:`ef_next_geq_torch` is the twin of the JAX package's
``ef_next_geq_jnp`` — the same fixed trip counts and int32 arithmetic —
and the plain version of kernel K3 (``kernels/ef_next_geq``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .index import INT_INF

# words per select-sample page; one 32-bit rank entry per page puts the
# sample overhead at 32 / (SEL_PAGE * 32) = 1/SEL_PAGE of the high bits
SEL_PAGE = 8
_SEL_BITS = SEL_PAGE * 32
# fixed bisection depth: enough for any page count < 2**32
_BISECT = 32


def _pack_bits_le(bits: np.ndarray) -> np.ndarray:
    """Pack a 0/1 array (length a multiple of 32) LSB-first per word."""
    b = bits.reshape(-1, 32).astype(np.uint64)
    w = (b << np.arange(32, dtype=np.uint64)).sum(axis=1)
    return w.astype(np.uint32)


def _list_lbits(n: int, last: int) -> int:
    if n <= 0:
        return 0
    u = last + 1
    return max(0, (u // n).bit_length() - 1) if u >= n else 0


@dataclasses.dataclass(frozen=True)
class EFStore:
    """Concatenated Elias-Fano regions for a subset of the index's lists.

    The directory arrays are full length ``L`` (``n == 0`` marks lists
    not encoded here); each list's high region is padded to a multiple
    of ``SEL_PAGE`` words so the page samples never straddle lists.
    """

    n: np.ndarray          # (L,)   int32 — 0 for lists not in the store
    lbits: np.ndarray      # (L,)   int32 — low-bit width l
    firsts: np.ndarray     # (L,)   int32
    lasts: np.ndarray      # (L,)   int32 — -1 when absent
    lo_word: np.ndarray    # (L+1,) int32 — word offset of the low region
    hi_word: np.ndarray    # (L+1,) int32 — word offset of the high region
    lo_words: np.ndarray   # (Wl+1,) uint32 — packed lows (+1 guard word)
    hi_words: np.ndarray   # (Wh,)  uint32 — unary highs, SEL_PAGE-aligned
    universe: int
    max_bucket: int        # max elements sharing one high value (kernel trip)

    @property
    def num_lists(self) -> int:
        return int(self.n.shape[0])

    def select_samples(self) -> np.ndarray:
        """Rank-of-ones directory: ones before each SEL_PAGE-word page.

        This is the select acceleration structure; engines cache it in a
        bounded, version-keyed LRU (DESIGN.md §10.2).
        """
        if self.hi_words.size == 0:
            return np.zeros(1, dtype=np.int32)
        bits = np.unpackbits(self.hi_words.view(np.uint8),
                             bitorder="little")
        per_page = bits.reshape(-1, _SEL_BITS).sum(axis=1, dtype=np.int64)
        out = np.zeros(per_page.size + 1, dtype=np.int64)
        np.cumsum(per_page, out=out[1:])
        return out.astype(np.int32)

    def size_bits(self) -> dict:
        """Honest space accounting: data + samples + per-list directory."""
        data = 32 * (int(self.lo_words.size) + int(self.hi_words.size))
        samples = 32 * (int(self.hi_words.size) // SEL_PAGE + 1)
        directory = 32 * 6 * int(np.count_nonzero(self.n))
        return {"data_bits": data, "sample_bits": samples,
                "directory_bits": directory,
                "total_bits": data + samples + directory}

    def decode(self, i: int) -> np.ndarray:
        """Decode list ``i`` back to absolute doc ids (round-trip test)."""
        n = int(self.n[i])
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        l = int(self.lbits[i])
        hw0, hw1 = int(self.hi_word[i]), int(self.hi_word[i + 1])
        bits = np.unpackbits(self.hi_words[hw0:hw1].view(np.uint8),
                             bitorder="little")
        pos = np.flatnonzero(bits)[:n].astype(np.int64)
        highs = pos - np.arange(n, dtype=np.int64)
        e = np.arange(n, dtype=np.int64)
        lows = _low_read_np(self.lo_words,
                            np.int64(self.lo_word[i]) * 32 + e * l,
                            np.full(n, l, dtype=np.int64))
        return (highs << l) | lows


def build_ef_store(lists: list, universe: int) -> EFStore:
    """Encode ``lists`` (entries may be None to skip a list id)."""
    L = len(lists)
    n = np.zeros(L, dtype=np.int32)
    lbits = np.zeros(L, dtype=np.int32)
    firsts = np.zeros(L, dtype=np.int32)
    lasts = np.full(L, -1, dtype=np.int32)
    lo_word = np.zeros(L + 1, dtype=np.int32)
    hi_word = np.zeros(L + 1, dtype=np.int32)
    lo_parts: list[np.ndarray] = []
    hi_parts: list[np.ndarray] = []
    max_bucket = 1
    for i, v in enumerate(lists):
        if v is None or len(v) == 0:
            lo_word[i + 1] = lo_word[i]
            hi_word[i + 1] = hi_word[i]
            continue
        v = np.asarray(v, dtype=np.int64)
        ni, last = len(v), int(v[-1])
        l = _list_lbits(ni, last)
        n[i], lbits[i] = ni, l
        firsts[i], lasts[i] = int(v[0]), last
        highs = v >> l
        max_bucket = max(max_bucket,
                         int(np.bincount(highs.astype(np.int64)).max()))
        # low region
        if l:
            bits = np.zeros((-(-(ni * l) // 32)) * 32, dtype=np.uint8)
            lows = (v & ((1 << l) - 1)).astype(np.uint64)
            for k in range(l):
                bits[k:ni * l:l] = (lows >> np.uint64(k)) & np.uint64(1)
            lo_parts.append(_pack_bits_le(bits))
        lo_word[i + 1] = lo_word[i] + (len(lo_parts[-1]) if l else 0)
        # high region, padded to SEL_PAGE words
        hbits = ni + int(highs[-1]) + 1
        words = (hbits + 31) // 32
        hwords = ((words + SEL_PAGE - 1) // SEL_PAGE) * SEL_PAGE
        hw = np.zeros(hwords, dtype=np.uint32)
        p = highs + np.arange(ni, dtype=np.int64)
        np.bitwise_or.at(hw, (p >> 5).astype(np.int64),
                         (np.uint32(1) << (p & 31).astype(np.uint32)))
        hi_parts.append(hw)
        hi_word[i + 1] = hi_word[i] + hwords
    lo_words = (np.concatenate(lo_parts + [np.zeros(1, dtype=np.uint32)])
                if lo_parts else np.zeros(1, dtype=np.uint32))
    hi_words = (np.concatenate(hi_parts) if hi_parts
                else np.zeros(0, dtype=np.uint32))
    return EFStore(n=n, lbits=lbits, firsts=firsts, lasts=lasts,
                   lo_word=lo_word, hi_word=hi_word, lo_words=lo_words,
                   hi_words=hi_words, universe=int(universe),
                   max_bucket=int(max_bucket))


def ef_bits_estimate(n: int, last: int) -> float:
    """Predicted EF bits for an ``n``-element list ending at ``last``
    (data + the 1/SEL_PAGE sample overhead), without building it."""
    if n <= 0:
        return 0.0
    l = _list_lbits(n, last)
    hbits = n + ((last >> l) + 1)
    return (n * l + hbits) * (1.0 + 1.0 / SEL_PAGE) + 32 * 6


# --------------------------------------------------------------------------
# numpy implementation (vectorized over a batch of (list, probe) lanes)
# --------------------------------------------------------------------------

def _popcount32_np(x: np.ndarray) -> np.ndarray:
    """SWAR popcount; ``x`` int64 holding uint32 bit patterns."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def _select_np(hi_words64, rank_pg, hp0, hp1, hw_region0, k, ones):
    """Bit position (relative to the region start) of the k-th one/zero."""
    nw = hi_words64.shape[0]
    r0 = rank_pg[np.minimum(hp0, rank_pg.shape[0] - 1)].astype(np.int64)
    lo = hp0.astype(np.int64)
    hi = np.maximum(hp1.astype(np.int64) - 1, lo)
    for _ in range(_BISECT):
        mid = (lo + hi + 1) >> 1
        rm = rank_pg[np.minimum(mid, rank_pg.shape[0] - 1)].astype(np.int64)
        cnt = (rm - r0) if ones else (mid - hp0) * _SEL_BITS - (rm - r0)
        go = cnt <= k
        lo = np.where(go, mid, lo)
        hi = np.where(go, hi, mid - 1)
        hi = np.maximum(hi, lo)
    p = lo
    rp = rank_pg[np.minimum(p, rank_pg.shape[0] - 1)].astype(np.int64)
    base = (rp - r0) if ones else (p - hp0) * _SEL_BITS - (rp - r0)
    k_rel = k - base
    w0 = p * SEL_PAGE
    cum = np.zeros_like(k_rel)
    word_sel = w0.copy()
    k_in = k_rel.copy()
    found = np.zeros(k.shape, dtype=bool)
    for j in range(SEL_PAGE):
        w = hi_words64[np.minimum(w0 + j, nw - 1)]
        c = _popcount32_np(w)
        c = c if ones else 32 - c
        take = (~found) & (cum + c > k_rel)
        word_sel = np.where(take, w0 + j, word_sel)
        k_in = np.where(take, k_rel - cum, k_in)
        found |= take
        cum = cum + c
    w = hi_words64[np.minimum(word_sel, nw - 1)]
    cnt = np.zeros_like(k_in)
    bit = np.zeros_like(k_in)
    found2 = np.zeros(k.shape, dtype=bool)
    want = 1 if ones else 0
    for b in range(32):
        isb = ((w >> b) & 1) == want
        hitb = (~found2) & isb & (cnt == k_in)
        bit = np.where(hitb, b, bit)
        found2 |= hitb
        cnt = cnt + isb
    return (word_sel - hw_region0) * 32 + bit


def _low_read_np(lo_words, gbit, l):
    """Read ``l``-bit fields at absolute bit offsets ``gbit`` (int64)."""
    lw = lo_words.astype(np.int64)
    nw = lw.shape[0]
    w = np.minimum(gbit >> 5, nw - 2)
    off = gbit & 31
    w0v = lw[w]
    w1v = lw[w + 1]
    lowpart = w0v >> off
    hipart = np.where(off == 0, 0, (w1v << (32 - off)) & 0xFFFFFFFF)
    return (lowpart | hipart) & ((np.int64(1) << l) - 1)


def ef_probe_state_np(store: EFStore, rank_pg: np.ndarray,
                      lids, xs) -> dict:
    """Host half of ``next_geq``: masks + the three high-bits selects.

    The JAX package's TPU kernel routes lanes with it and only finishes
    the low-bits search; kernel K3 computes both halves on the card.
    """
    lids = np.asarray(lids, dtype=np.int64)
    xs = np.asarray(xs, dtype=np.int64)
    n = store.n[lids].astype(np.int64)
    first = store.firsts[lids].astype(np.int64)
    last = store.lasts[lids].astype(np.int64)
    l = store.lbits[lids].astype(np.int64)
    empty = n == 0
    head = (~empty) & (xs <= first)
    over = (~empty) & (xs > last)
    done = empty | head | over
    val0 = np.where(head, first, np.int64(INT_INF))
    x_eff = np.where(empty, 0, np.clip(xs, first, np.maximum(last, 0)))
    hx = x_eff >> l
    xlo = x_eff & ((np.int64(1) << l) - 1)
    hw0 = store.hi_word[lids].astype(np.int64)
    hp0 = hw0 // SEL_PAGE
    hp1 = store.hi_word[lids + 1].astype(np.int64) // SEL_PAGE
    hi64 = store.hi_words.astype(np.int64)
    pos1 = _select_np(hi64, rank_pg, hp0, hp1, hw0, hx, ones=False)
    i1 = pos1 - hx
    pos0 = _select_np(hi64, rank_pg, hp0, hp1, hw0,
                      np.maximum(hx - 1, 0), ones=False)
    i0 = np.where(hx == 0, 0, pos0 - (hx - 1))
    i1m = np.clip(i1, 0, np.maximum(n - 1, 0))
    posj = _select_np(hi64, rank_pg, hp0, hp1, hw0, i1m, ones=True)
    hi1 = posj - i1m
    return {"lids": lids, "done": done, "val0": val0, "i0": i0, "i1": i1,
            "i1m": i1m, "hx": hx, "l": l, "xlo": xlo, "hi1": hi1}


def ef_finish_np(store: EFStore, st: dict) -> np.ndarray:
    """Low-bits bucket search completing :func:`ef_probe_state_np`."""
    lids, l, xlo = st["lids"], st["l"], st["xlo"]
    gb0 = store.lo_word[lids].astype(np.int64) * 32
    lo_b, hi_b = st["i0"].copy(), st["i1"].copy()
    for _ in range(_BISECT):
        valid = lo_b < hi_b
        mid = (lo_b + hi_b) >> 1
        lv = _low_read_np(store.lo_words, gb0 + mid * l, l)
        ge = lv >= xlo
        hi_b = np.where(valid & ge, mid, hi_b)
        lo_b = np.where(valid & ~ge, mid + 1, lo_b)
    found = lo_b < st["i1"]
    e = np.where(found, lo_b, st["i1m"])
    lowe = _low_read_np(store.lo_words, gb0 + e * l, l)
    hfin = np.where(found, st["hx"], st["hi1"])
    val = (hfin << l) | lowe
    return np.where(st["done"], st["val0"], val).astype(np.int32)


def ef_next_geq_np(store: EFStore, rank_pg: np.ndarray,
                   lids, xs) -> np.ndarray:
    """Vectorized numpy ``next_geq`` over (list, probe) lanes."""
    return ef_finish_np(store, ef_probe_state_np(store, rank_pg, lids, xs))


# --------------------------------------------------------------------------
# torch implementation — the jnp twin's arithmetic, vectorized over lanes
# --------------------------------------------------------------------------

#: the device pack's tensors, in the order kernel K3 takes them
EF_PACK = ("n", "lbits", "firsts", "lasts", "lo_word", "hi_word",
           "lo_words", "hi_words", "rank_pg")

_U32 = 0xFFFFFFFF


def ef_device_pack(store: EFStore, rank_pg: np.ndarray, device) -> dict:
    """Device operands: contiguous int32 tensors on ``device``, keyed as
    :data:`EF_PACK`.  The packed words travel as int32 views of their
    uint32 bits; an empty high-bits array becomes one zero word, so every
    clamped gather stays in range."""
    hi = store.hi_words if store.hi_words.size else np.zeros(1, np.uint32)
    arrays = dict(n=store.n, lbits=store.lbits, firsts=store.firsts,
                  lasts=store.lasts, lo_word=store.lo_word,
                  hi_word=store.hi_word,
                  lo_words=store.lo_words.view(np.int32),
                  hi_words=hi.view(np.int32), rank_pg=rank_pg)
    return {k: torch.tensor(np.asarray(arrays[k], np.int32), device=device)
            for k in EF_PACK}


def srl(x: torch.Tensor, s) -> torch.Tensor:
    """Logical right shift of int32 ``x`` (``lax.shift_right_logical``);
    torch's ``>>`` on int32 is arithmetic."""
    if torch.is_tensor(s):
        s = s.long()
    return ((x.long() & _U32) >> s).to(torch.int32)


def sll(x: torch.Tensor, s) -> torch.Tensor:
    """int32 left shift that wraps (``lax.shift_left``; 0 for shifts of
    32 to 63)."""
    if torch.is_tensor(s):
        s = s.long()
    return ((x.long() << s) & _U32).to(torch.int32)


def popc(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 words, logical shifts throughout."""
    x = x - (srl(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (srl(x, 2) & 0x33333333)
    x = (x + srl(x, 4)) & 0x0F0F0F0F
    x = x + srl(x, 8)
    return (x + srl(x, 16)) & 0x3F


def _take(table: torch.Tensor, idx: torch.Tensor, top: int) -> torch.Tensor:
    """``table[min(idx, top)]``: the reference's clamped gather."""
    return table[torch.clamp(idx, max=top).long()]


def _select_torch(pack: dict, hp0, hp1, hw_reg, k, ones: bool):
    """Bit position (relative to the region start) of the k-th one or
    zero: bisection over the page samples, a SEL_PAGE-word popcount scan,
    a 32-step in-word scan."""
    rank, hi_words = pack["rank_pg"], pack["hi_words"]
    npg, nw = rank.shape[0] - 1, hi_words.shape[0] - 1
    r0 = _take(rank, hp0, npg)
    lo, hi = hp0, torch.maximum(hp1 - 1, hp0)
    for _ in range(_BISECT):
        mid = srl(lo + hi + 1, 1)
        rm = _take(rank, mid, npg)
        cnt = (rm - r0) if ones else (mid - hp0) * _SEL_BITS - (rm - r0)
        go = cnt <= k
        lo = torch.where(go, mid, lo)
        hi = torch.maximum(torch.where(go, hi, mid - 1), lo)
    rp = _take(rank, lo, npg)
    base = (rp - r0) if ones else (lo - hp0) * _SEL_BITS - (rp - r0)
    k_rel = k - base
    w0 = lo * SEL_PAGE
    cum = torch.zeros_like(k_rel)
    word_sel, k_in = w0, k_rel
    found = torch.zeros_like(k_rel, dtype=torch.bool)
    for j in range(SEL_PAGE):
        c = popc(_take(hi_words, w0 + j, nw))
        if not ones:
            c = 32 - c
        take = ~found & (cum + c > k_rel)
        word_sel = torch.where(take, w0 + j, word_sel)
        k_in = torch.where(take, k_rel - cum, k_in)
        found = found | take
        cum = cum + c
    w = _take(hi_words, word_sel, nw)
    cnt = torch.zeros_like(k_in)
    bit = torch.zeros_like(k_in)
    found = torch.zeros_like(found)
    for b in range(32):
        isb = (srl(w, b) & 1) == int(ones)
        hit = ~found & isb & (cnt == k_in)
        bit = torch.where(hit, b, bit)
        found = found | hit
        cnt = cnt + isb.to(torch.int32)
    return (word_sel - hw_reg) * 32 + bit


def _low_read_torch(lo_words: torch.Tensor, gbit, l):
    """The ``l``-bit fields at int32 bit offsets ``gbit``; a field may
    straddle two words."""
    w = torch.clamp(srl(gbit, 5), max=lo_words.shape[0] - 2).long()
    off = gbit & 31
    lowpart = srl(lo_words[w], off)
    hipart = torch.where(off == 0, 0, sll(lo_words[w + 1], (32 - off) & 31))
    return (lowpart | hipart) & (sll(torch.ones_like(l), l) - 1)


def ef_next_geq_torch(pack: dict, lids: torch.Tensor,
                      xs: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 lanes on the pack's device -> (Q,) int32 ``next_geq``
    values, INT_INF where no element >= x exists.  Bit-identical to
    :func:`ef_next_geq_np` and to the JAX package's ``ef_next_geq_jnp``;
    the plain version of kernel K3."""
    li = lids.long()
    n, first = pack["n"][li], pack["firsts"][li]
    last, l = pack["lasts"][li], pack["lbits"][li]
    empty = n == 0
    head = ~empty & (xs <= first)
    over = ~empty & (xs > last)
    done = empty | head | over
    val0 = torch.where(head, first, int(INT_INF))
    x_eff = torch.where(empty, 0, torch.minimum(torch.maximum(xs, first),
                                                torch.clamp(last, min=0)))
    hx = srl(x_eff, l)
    xlo = x_eff & (sll(torch.ones_like(l), l) - 1)
    hw0 = pack["hi_word"][li]
    hp0 = hw0 // SEL_PAGE
    hp1 = pack["hi_word"][li + 1] // SEL_PAGE
    i1 = _select_torch(pack, hp0, hp1, hw0, hx, False) - hx
    pos0 = _select_torch(pack, hp0, hp1, hw0, torch.clamp(hx - 1, min=0),
                         False)
    i0 = torch.where(hx == 0, 0, pos0 - (hx - 1))
    i1m = torch.minimum(torch.clamp(i1, min=0), torch.clamp(n - 1, min=0))
    hi1 = _select_torch(pack, hp0, hp1, hw0, i1m, True) - i1m
    lo_words = pack["lo_words"]
    gb0 = pack["lo_word"][li] * 32
    lo_b, hi_b = i0, i1
    for _ in range(_BISECT):
        valid = lo_b < hi_b
        mid = srl(lo_b + hi_b, 1)
        ge = _low_read_torch(lo_words, gb0 + mid * l, l) >= xlo
        hi_b = torch.where(valid & ge, mid, hi_b)
        lo_b = torch.where(valid & ~ge, mid + 1, lo_b)
    found = lo_b < i1
    e = torch.where(found, lo_b, i1m)
    lowe = _low_read_torch(lo_words, gb0 + e * l, l)
    val = sll(torch.where(found, hx, hi1), l) | lowe
    return torch.where(done, val0, val)
