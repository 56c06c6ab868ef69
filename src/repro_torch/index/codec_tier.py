"""Adaptive per-list codec tier: Re-Pair / Elias-Fano / bitmap.

A copy of ``repro/index/codec_tier.py`` whose device programs are torch.

The paper's conclusion is that Re-Pair alone "requires further
improvements to beat the state of the art"; this module stops forcing
one codec on every list.  At build time each list is assigned one of

* ``repair`` — the existing grammar-compressed paged layout (wins on
  long *repetitive* lists where phrases repeat);
* ``ef``     — quasi-succinct Elias-Fano (:mod:`repro_torch.core.ef`;
  wins on sparse lists: ~``2 + log2(u/n)`` bits/posting with O(1)-ish
  skipping);
* ``bitmap`` — a plain bitset with per-word skip pointers (wins on dense
  lists, ``n > u/8`` or so, and answers membership without any decode).

Selection extends the boolean planner's cost model with a **space
term**: per list, ``score(c) = bits_c(i) + λ · probe_rate(i) · t_c``
where ``bits_c`` is the codec's bits-per-list estimate, ``probe_rate``
is the list's share of predicted probe volume under the independence
model (∝ n_i / Σn), and ``t_c`` is the codec's per-probe cost in the
planner's units.  ``REPRO_CODEC`` ∈ {repair, ef, bitmap, adaptive}
forces a single tier for differential testing; the default (unset or
"repair") builds no tier at all, so the classic engine path is
untouched.

The bitmap store keeps ``uint32`` words plus a per-word
next-nonzero-word skip table so ``next_geq`` is O(1), with numpy and
torch implementations that are bit-identical by construction.
``codec_tier_from_arrays`` rebuilds a tier from numpy arrays, so the
tests can hand the JAX package's tier to this package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..core.ef import (EFStore, build_ef_store, ef_bits_estimate, popc, sll,
                       srl)
from ..core.index import INT_INF
from ..core.repair import RePairResult

CODEC_REPAIR, CODEC_EF, CODEC_BITMAP = 0, 1, 2
CODEC_NAMES = ("repair", "ef", "bitmap")
MODES = ("repair", "ef", "bitmap", "adaptive")

# per-probe codec costs in the planner's per-element units (§7): a
# repair probe pays a bucket scan + grammar descent, EF three fixed-trip
# selects + a low-bits bisection, a bitmap one word test + one skip
T_REPAIR, T_EF, T_BITMAP = 24.0, 8.0, 2.0
# per-ROUND setup charges for the planner (§7): the vectorized select /
# membership machinery runs a fixed number of full-width passes whatever
# the lane count, so a probe round on a non-repair list has a large
# constant cost on top of the per-probe term.  Measured on the host
# reference path an EF round costs about as much as merging a few
# thousand postings; bitmap rounds are ~an order of magnitude lighter.
# The effect: probing an EF list only wins over decode-and-merge when
# the list is long enough to amortize the selects — exactly the regime
# where skipping the decode pays on devices too.
T_EF_SETUP, T_BITMAP_SETUP = 4096.0, 256.0
# space/time exchange rate for the adaptive score; bits one probe-unit
# of saved work is worth.  Kept deliberately small so the space term
# dominates and the adaptive tier can only *shrink* the index vs.
# all-Re-Pair (the Pareto gate in bench_tradeoff).
LAMBDA = float(os.environ.get("REPRO_CODEC_LAMBDA", "0.1"))


def codec_mode(override: str | None = None) -> str:
    mode = override or os.environ.get("REPRO_CODEC", "repair")
    if mode not in MODES:
        raise ValueError(f"REPRO_CODEC must be one of {MODES}, got {mode!r}")
    return mode


# --------------------------------------------------------------------------
# bitmap store
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BitmapStore:
    """Concatenated per-list bitsets with next-nonzero-word skip pointers."""

    words: np.ndarray       # (W+1,) uint32 (+1 zero guard)
    word_start: np.ndarray  # (L+1,) int32
    nxt: np.ndarray         # (W+1,) int32 — next w' >= w with words[w'] != 0
                            #   inside w's region; clamps to >= region end
    counts: np.ndarray      # (L,) int32 — 0 for lists not in the store
    firsts: np.ndarray      # (L,) int32
    lasts: np.ndarray       # (L,) int32
    universe: int

    def size_bits(self) -> dict:
        nw = int(self.word_start[-1])
        present = int(np.count_nonzero(self.counts))
        return {"data_bits": 32 * nw, "skip_bits": 32 * nw,
                "directory_bits": 32 * 4 * present,
                "total_bits": 64 * nw + 32 * 4 * present}

    def decode(self, i: int) -> np.ndarray:
        w0, w1 = int(self.word_start[i]), int(self.word_start[i + 1])
        bits = np.unpackbits(self.words[w0:w1].view(np.uint8),
                             bitorder="little")
        return np.flatnonzero(bits).astype(np.int64)


def build_bitmap_store(lists: list, universe: int) -> BitmapStore:
    L = len(lists)
    nwords = (int(universe) + 31) // 32
    counts = np.zeros(L, dtype=np.int32)
    firsts = np.zeros(L, dtype=np.int32)
    lasts = np.full(L, -1, dtype=np.int32)
    word_start = np.zeros(L + 1, dtype=np.int32)
    parts: list[np.ndarray] = []
    for i, v in enumerate(lists):
        if v is None or len(v) == 0:
            word_start[i + 1] = word_start[i]
            continue
        v = np.asarray(v, dtype=np.int64)
        counts[i] = len(v)
        firsts[i], lasts[i] = int(v[0]), int(v[-1])
        w = np.zeros(nwords, dtype=np.uint32)
        np.bitwise_or.at(w, (v >> 5).astype(np.int64),
                         (np.uint32(1) << (v & 31).astype(np.uint32)))
        parts.append(w)
        word_start[i + 1] = word_start[i] + nwords
    W = int(word_start[-1])
    words = (np.concatenate(parts + [np.zeros(1, dtype=np.uint32)])
             if parts else np.zeros(1, dtype=np.uint32))
    nxt = np.full(W + 1, W, dtype=np.int32)
    for i in range(L):
        w0, w1 = int(word_start[i]), int(word_start[i + 1])
        if w1 == w0:
            continue
        idx = np.arange(w0, w1, dtype=np.int32)
        cand = np.where(words[w0:w1] != 0, idx, np.int32(w1))
        nxt[w0:w1] = np.minimum.accumulate(cand[::-1])[::-1]
    return BitmapStore(words=words, word_start=word_start, nxt=nxt,
                       counts=counts, firsts=firsts, lasts=lasts,
                       universe=int(universe))


def _popcount32_np(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def bitmap_next_geq_np(bs: BitmapStore, lids, xs) -> np.ndarray:
    lids = np.asarray(lids, dtype=np.int64)
    xs = np.maximum(np.asarray(xs, dtype=np.int64), 0)
    words = bs.words.astype(np.int64)
    W = bs.nxt.shape[0] - 1
    w0 = bs.word_start[lids].astype(np.int64)
    w1 = bs.word_start[lids + 1].astype(np.int64)
    wq = w0 + (xs >> 5)
    inr = wq < w1
    m = words[np.minimum(wq, W)] & ((0xFFFFFFFF << (xs & 31)) & 0xFFFFFFFF)
    m = np.where(inr, m, 0)
    nx = bs.nxt[np.minimum(wq + 1, W)].astype(np.int64)
    hit = m != 0
    wsel = np.where(hit, wq, nx)
    msel = np.where(hit, m, words[np.minimum(wsel, W)])
    ok = np.where(hit, inr, inr & (nx < w1))
    tz = _popcount32_np((msel ^ 0xFFFFFFFF) & (msel - 1))
    ans = (wsel - w0) * 32 + tz
    return np.where(ok, ans, np.int64(INT_INF)).astype(np.int32)


def bitmap_member_np(bs: BitmapStore, lids, xs) -> np.ndarray:
    """Membership without decode — the dense-list fast path."""
    lids = np.asarray(lids, dtype=np.int64)
    xs = np.maximum(np.asarray(xs, dtype=np.int64), 0)
    words = bs.words.astype(np.int64)
    W = bs.nxt.shape[0] - 1
    w0 = bs.word_start[lids].astype(np.int64)
    w1 = bs.word_start[lids + 1].astype(np.int64)
    wq = w0 + (xs >> 5)
    bit = (words[np.minimum(wq, W)] >> (xs & 31)) & 1
    return ((wq < w1) & (bit == 1))


def bitmap_device_pack(bs: BitmapStore, device) -> dict:
    """Device operands of :func:`bitmap_next_geq_torch`: contiguous int32
    tensors on ``device`` (the words as int32 views of their bits)."""
    arrays = dict(word_start=bs.word_start, words=bs.words.view(np.int32),
                  nxt=bs.nxt)
    return {k: torch.tensor(np.asarray(v, np.int32), device=device)
            for k, v in arrays.items()}


def bitmap_next_geq_torch(pack: dict, lids: torch.Tensor,
                          xs: torch.Tensor) -> torch.Tensor:
    """(Q,) int32 lanes on the pack's device -> (Q,) int32 ``next_geq``
    values: the twin of the JAX package's ``bitmap_next_geq_jnp`` (int32
    arithmetic, logical shifts), bit-identical to
    :func:`bitmap_next_geq_np`.  The JAX package runs no Pallas kernel for
    this probe, so this program serves bitmap lanes on every device."""
    word_start, words, nxt = pack["word_start"], pack["words"], pack["nxt"]
    W = nxt.shape[0] - 1
    x = torch.clamp(xs, min=0)
    li = lids.long()
    w0, w1 = word_start[li], word_start[li + 1]
    wq = w0 + srl(x, 5)
    inr = wq < w1
    m = words[torch.clamp(wq, max=W).long()] & sll(torch.full_like(x, -1),
                                                   x & 31)
    m = torch.where(inr, m, 0)
    nx = nxt[torch.clamp(wq + 1, max=W).long()]
    hit = m != 0
    wsel = torch.where(hit, wq, nx)
    msel = torch.where(hit, m, words[torch.clamp(wsel, max=W).long()])
    ok = torch.where(hit, inr, inr & (nx < w1))
    tz = popc((msel ^ -1) & (msel - 1))
    return torch.where(ok, (wsel - w0) * 32 + tz, int(INT_INF))


# --------------------------------------------------------------------------
# tier selection + container
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CodecTier:
    """Per-list codec assignment plus the non-repair stores."""

    mode: str
    codec: np.ndarray           # (L,) int8 — CODEC_* per list
    ef: EFStore | None
    bm: BitmapStore | None
    universe: int

    @property
    def num_lists(self) -> int:
        return int(self.codec.shape[0])

    def counts(self) -> dict:
        return {name: int(np.count_nonzero(self.codec == c))
                for c, name in enumerate(CODEC_NAMES)}

    def space_report(self, res: RePairResult) -> dict:
        """Bits of the mixed index under this assignment (repair lists
        keep their grammar share; ef/bitmap lists pay their stores)."""
        n_total = int(res.orig_lengths.sum())
        rep_mask = self.codec == CODEC_REPAIR
        bits = 0
        if rep_mask.any():
            bits += int(_repair_bits(res)[rep_mask].sum())
        if self.ef is not None:
            bits += self.ef.size_bits()["total_bits"]
        if self.bm is not None:
            bits += self.bm.size_bits()["total_bits"]
        return {"mode": self.mode, "total_bits": bits,
                "bits_per_posting": bits / max(1, n_total),
                "counts": self.counts()}


def _repair_bits(res: RePairResult) -> np.ndarray:
    """Per-list Re-Pair bits: symbols at S(l) bits each plus an
    n_i-proportional share of the dictionary (paper §3.4 accounting)."""
    from ..core import dictionary as D

    forest = D.build_forest(res.grammar)
    sigma = res.grammar.num_terminals
    lb = forest.rb.size
    d = forest.rs.size
    s_l = max(1, int(np.ceil(np.log2(max(2, sigma + lb - 2)))))
    clen = np.diff(res.starts).astype(np.float64)
    n = res.orig_lengths.astype(np.float64)
    dict_bits = (d + res.grammar.num_rules) * s_l + lb
    share = n / max(1.0, n.sum())
    return clen * s_l + dict_bits * share


def estimate_codec_bits(res: RePairResult, lasts: np.ndarray) -> np.ndarray:
    """(L, 3) bits-per-list estimate for repair / ef / bitmap."""
    L = res.num_lists
    n = res.orig_lengths.astype(np.int64)
    out = np.zeros((L, 3), dtype=np.float64)
    out[:, CODEC_REPAIR] = _repair_bits(res)
    for i in range(L):
        out[i, CODEC_EF] = ef_bits_estimate(int(n[i]), int(lasts[i]))
    # data + the equally-sized skip table + directory (BitmapStore)
    out[:, CODEC_BITMAP] = 2 * 32 * ((res.universe + 31) // 32) + 32 * 4
    return out


def choose_codecs(res: RePairResult, lasts: np.ndarray,
                  mode: str) -> np.ndarray:
    L = res.num_lists
    if mode != "adaptive":
        c = {"repair": CODEC_REPAIR, "ef": CODEC_EF,
             "bitmap": CODEC_BITMAP}[mode]
        codec = np.full(L, c, dtype=np.int8)
        codec[res.orig_lengths == 0] = CODEC_REPAIR
        return codec
    bits = estimate_codec_bits(res, lasts)
    n = res.orig_lengths.astype(np.float64)
    # predicted probe volume under the independence model: probes land
    # on a list in proportion to its cardinality (Zipf query sampling
    # follows list popularity), so volume_i ∝ n_i — the same units as
    # the per-list bits, traded at LAMBDA bits per probe-cost unit
    t = np.array([T_REPAIR, T_EF, T_BITMAP])
    score = bits + LAMBDA * n[:, None] * t[None, :]
    codec = np.argmin(score, axis=1).astype(np.int8)
    # the space term must dominate: never pick a codec that inflates the
    # list vs. Re-Pair (keeps the adaptive tier on the Pareto frontier)
    inflates = bits[np.arange(L), codec] > bits[:, CODEC_REPAIR]
    codec[inflates] = CODEC_REPAIR
    codec[res.orig_lengths == 0] = CODEC_REPAIR
    return codec


def build_codec_tier(res: RePairResult,
                     mode: "str | CodecTier | None" = None):
    """Build the tier for ``mode`` (None → ``REPRO_CODEC`` → "repair").

    Returns ``None`` for the pure-repair mode so the default engine path
    carries zero overhead; a prebuilt :class:`CodecTier` passes through
    (lets a server share one tier across engine rebuilds).
    """
    if isinstance(mode, CodecTier):
        return mode
    mode = codec_mode(mode)
    if mode == "repair":
        return None
    L = res.num_lists
    decoded = [res.decode_list(i) if res.orig_lengths[i] else
               np.zeros(0, np.int64) for i in range(L)]
    lasts = np.array([int(v[-1]) if len(v) else -1 for v in decoded],
                     dtype=np.int64)
    codec = choose_codecs(res, lasts, mode)
    ef_lists = [decoded[i] if codec[i] == CODEC_EF else None
                for i in range(L)]
    bm_lists = [decoded[i] if codec[i] == CODEC_BITMAP else None
                for i in range(L)]
    ef = (build_ef_store(ef_lists, res.universe)
          if any(v is not None for v in ef_lists) else None)
    bm = (build_bitmap_store(bm_lists, res.universe)
          if any(v is not None for v in bm_lists) else None)
    return CodecTier(mode=mode, codec=codec, ef=ef, bm=bm,
                     universe=res.universe)


_EF_FIELDS = ("n", "lbits", "firsts", "lasts", "lo_word", "hi_word",
              "lo_words", "hi_words")
_BM_FIELDS = ("words", "word_start", "nxt", "counts", "firsts", "lasts")


def codec_tier_to_arrays(tier) -> tuple[dict[str, np.ndarray], dict]:
    """Every array of a codec tier by name (EF fields prefixed ``ef_``,
    bitmap fields ``bm_``; a store that is absent has no keys) and its
    scalars.  Reads fields by name, so the JAX package's tier converts
    the same way."""
    arrays = {"codec": np.array(tier.codec)}
    statics = {"mode": str(tier.mode), "universe": int(tier.universe)}
    if tier.ef is not None:
        arrays.update({f"ef_{k}": np.array(getattr(tier.ef, k))
                       for k in _EF_FIELDS})
        statics["ef_max_bucket"] = int(tier.ef.max_bucket)
    if tier.bm is not None:
        arrays.update({f"bm_{k}": np.array(getattr(tier.bm, k))
                       for k in _BM_FIELDS})
    return arrays, statics


def codec_tier_from_arrays(arrays: dict[str, np.ndarray],
                           statics: dict) -> CodecTier:
    """Inverse of :func:`codec_tier_to_arrays`: a :class:`CodecTier` with
    its :class:`~repro_torch.core.ef.EFStore` and :class:`BitmapStore`
    rebuilt from copies of the arrays."""
    u = int(statics["universe"])
    ef = bm = None
    if "ef_n" in arrays:
        ef = EFStore(**{k: np.array(arrays[f"ef_{k}"]) for k in _EF_FIELDS},
                     universe=u, max_bucket=int(statics["ef_max_bucket"]))
    if "bm_words" in arrays:
        bm = BitmapStore(**{k: np.array(arrays[f"bm_{k}"])
                            for k in _BM_FIELDS}, universe=u)
    return CodecTier(mode=str(statics["mode"]),
                     codec=np.array(arrays["codec"], np.int8), ef=ef, bm=bm,
                     universe=u)
