"""TorchBuilder: fixed-shape Re-Pair rounds on tensors on one device.

The port of ``repro/build/jnp_builder.py::JnpBuilder``.  The host loop's
data-dependent steps become fixed-shape tensor programs over a padded
buffer of static length ``Np`` and rule tables of static budget ``Rb``
(doubled when a build outgrows them).  The same three design decisions
as the reference:

* **hole semantics, no per-round compaction** — a replaced right symbol
  is not sliced out; its slot goes dead in a ``live`` mask.  Logical
  adjacency is the *next-live chain* (a reversed ``cummin`` of live
  positions), so pair slots, greedy-overlap runs and partner invalidation
  are gathers and scans.  Separators stay live-but-not-real: they occupy
  a chain slot (breaking adjacency across lists) but never match a pair.
* **packed single-key sort histogram** — pair ``(a, b)`` packs into one
  int32 key ``a * S + b`` (``S = T + Rb``; the builder refuses symbol
  spaces past ``sqrt(2^31)`` rather than overflow).  One sort groups
  identical pairs into runs; run lengths are exact counts.
* **top-K ranked table** — the good runs are gathered into a ``RANK_K``
  table ranked by (count desc, left asc, right asc), the host's exact
  tie-break.  A round whose table runs dry before ``take`` pairs are
  chosen is re-ranked at full length, so parity is unconditional.

What differs from the reference, and why:

* The greedy disjoint selection (``_select_disjoint``) was a
  ``jax.lax.while_loop`` of one step per ranked pair.  Eagerly, one device
  step per pair would cost thousands of launches a round, so the ranked
  table (at most ``RANK_K`` pairs) is copied to the host once per round
  and the same greedy runs in Python — as the host builder does.  The
  exact-fallback decision is then taken before any replacement.
* Each round reads its control scalars (``n_good``, ``n_runs`` with the
  ranked table; then ``kept_any``, ``n_live``) in one transfer each.
* The rule count lives on the host (the greedy knows it), so rule
  registration is a slice assignment in place instead of a dropped-index
  scatter.
* Multi-key sorts (``jax.lax.sort(..., num_keys=3)``, stable) are three
  stable argsorts from the last key to the first.

Everything on the device is int32, like the reference (``torch.cumsum``
is given ``dtype=torch.int32`` wherever it feeds a ``searchsorted``).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..core.repair import Grammar, RePairResult, lists_to_gap_stream
from ..kernels import resolve_device
from ..obs import span
from .base import Builder, BuildConfig

I32 = torch.int32
BIG = 2**31 - 1      # sentinel key: sorts past every real packed pair
MAX_PACK = 46340     # floor(sqrt(2^31)): largest symbol space that packs
RANK_K = 4096        # static ranked-table size of the fast path


class TorchBuildState(NamedTuple):
    """The working set of a device build: int32/bool tensors of static
    shapes (Np,) / (Rb,) on one device, and the rule count."""

    seq: torch.Tensor         # (Np,) symbol per slot (garbage where dead)
    live: torch.Tensor        # (Np,) slot occupies a position in the
    #                           logical sequence (real symbols AND separators)
    real: torch.Tensor        # (Np,) live and not a separator
    rule_l: torch.Tensor      # (Rb,) left child of rule i
    rule_r: torch.Tensor      # (Rb,)
    rule_sum: torch.Tensor    # (Rb,) phrase sums
    rule_len: torch.Tensor    # (Rb,) expanded lengths
    rule_depth: torch.Tensor  # (Rb,) parse-tree depths
    num_rules: int


def _arange(lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(lo, hi, dtype=I32, device=device)


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """out[i] = min(x[i:]): a reversed cummin."""
    return torch.flip(torch.cummin(torch.flip(x, (0,)), 0).values, (0,))


# -- chain + pair-stream helpers ---------------------------------------------

def _next_live(live: torch.Tensor) -> torch.Tensor:
    """nl[i] = smallest live j > i (Np when none): reversed cummin."""
    Np = live.shape[0]
    at = _rev_cummin(torch.where(live, _arange(0, Np, live.device), Np))
    return torch.cat([at[1:], at.new_full((1,), Np)])


def _prev_live(live: torch.Tensor) -> torch.Tensor:
    """pl[i] = largest live j < i (-1 when none): cummax."""
    idx = _arange(0, live.shape[0], live.device)
    at = torch.cummax(torch.where(live, idx, -1), 0).values
    return torch.cat([at.new_full((1,), -1), at[:-1]])


def _pair_streams(seq, live, real, *, S):
    """Per-slot adjacent pair of the LOGICAL sequence: right symbol
    (through the next-live chain), validity, and the packed key
    ``a * S + b`` (BIG where invalid)."""
    Np = seq.shape[0]
    nl = _next_live(live)
    nlc = nl.clamp(max=Np - 1).long()
    pb = seq[nlc]
    vp = real & (nl < Np) & real[nlc]
    packed = torch.where(vp, seq * S + pb, BIG)
    return pb, vp, packed


# -- counting + ranking ------------------------------------------------------

def _runs_of_sorted(ks):
    """Distinct-pair runs of the sorted key array: (run-start mask, exact
    occurrence count at each run start, total valid pairs)."""
    Np = ks.shape[0]
    idx = _arange(0, Np, ks.device)
    valid = ks != BIG
    prev = torch.cat([ks.new_full((1,), -1), ks[:-1]])
    rs = valid & (ks != prev)
    nxt = _rev_cummin(torch.where(rs, idx, Np))
    nxt_after = torch.cat([nxt[1:], nxt.new_full((1,), Np)])
    total = valid.sum(dtype=I32)
    count = torch.minimum(nxt_after, total) - idx
    return rs, count, total


def _cap_kept(ks, packed, rs, *, cap):
    """[CN07] early-pairs filter: keep the ``cap`` distinct pairs whose
    first occurrence in the sequence comes earliest.  First occurrences
    are a scatter-min into each run's start slot (slot ``Np`` takes the
    invalid slots and is cut off)."""
    Np = ks.shape[0]
    idx = _arange(0, Np, ks.device)
    slot = torch.searchsorted(ks, packed)
    slot = torch.where(packed != BIG, slot, Np)
    fo = torch.full((Np + 1,), BIG, dtype=I32, device=ks.device)
    fo = fo.scatter_reduce_(0, slot, idx, reduce="amin")[:Np]
    thresh = torch.sort(torch.where(rs, fo, BIG)).values[min(cap - 1, Np - 1)]
    return rs & (fo <= thresh)


def _sort3(neg, a, b, c):
    """Stable lexicographic sort of (neg, a, b), carrying ``c`` — what
    ``jax.lax.sort((neg, a, b, c), num_keys=3)`` computes."""
    perm = torch.argsort(b, stable=True)
    perm = perm[torch.argsort(a[perm], stable=True)]
    perm = perm[torch.argsort(neg[perm], stable=True)]
    return neg[perm], a[perm], b[perm], c[perm]


def _rank_good(ks, count, good, *, S, K):
    """Gather the good runs into a K-slot table and rank it by
    (count desc, left asc, right asc) — the host's exact tie-break.
    ``K=None`` ranks at full length (the exact fallback).  Returns
    (neg_key, left, right, count) ranked tensors + n_good.

    When more than K runs are good, the table holds EXACTLY the top K of
    the host order: every run above the K-th-largest count, plus ties at
    the threshold broken by smallest packed key — so the ranked table is a
    true prefix of the host's ranking."""
    Np = ks.shape[0]
    dev = ks.device
    n_good = good.sum(dtype=I32)
    if K is None:
        neg = torch.where(good, -count, BIG)
        a = torch.where(good, ks // S, BIG)
        b = torch.where(good, ks % S, BIG)
        return (*_sort3(neg, a, b, count), n_good)
    thresh = torch.sort(torch.where(good, count, -1)).values[max(Np - K, 0)]
    strict = good & (count > thresh)
    ties = good & (count == thresh)
    room = K - strict.sum(dtype=I32)
    keep = strict | (ties & (torch.cumsum(ties, 0, dtype=I32) <= room))
    csum = torch.cumsum(keep, 0, dtype=I32)
    src = torch.searchsorted(csum, _arange(1, K + 1, dev))
    on = _arange(0, K, dev) < csum[Np - 1]
    srcc = src.clamp(max=Np - 1)
    kk = torch.where(on, ks[srcc], BIG)
    cc = torch.where(on, count[srcc], 0)
    neg = torch.where(on, -cc, BIG)
    a = torch.where(on, kk // S, BIG)
    b = torch.where(on, kk % S, BIG)
    return (*_sort3(neg, a, b, cc), n_good)


def _count_ranked(packed, pa, pb, vp, *, S, cap, min_count, K):
    """Ranked pair histogram via the packed single-key sort.  Returns
    (neg, left, right, count, n_good, n_runs)."""
    ks = torch.sort(packed).values
    rs, count, _ = _runs_of_sorted(ks)
    n_runs = rs.sum(dtype=I32)
    kept = _cap_kept(ks, packed, rs, cap=cap) if cap > 0 else rs
    good = kept & (count >= min_count)
    neg, a, b, c, n_good = _rank_good(ks, count, good, S=S, K=K)
    return neg, a, b, c, n_good, n_runs


# -- selection + replacement -------------------------------------------------

def _select_disjoint(neg, ra, rb, take: int) -> tuple[list, list]:
    """Host-greedy disjoint top-k over the ranked table (numpy): walk the
    ranked pairs, skip any pair sharing a symbol with an earlier choice,
    stop at ``take`` chosen or at the first non-good entry."""
    used: set[int] = set()
    ch_l: list[int] = []
    ch_r: list[int] = []
    for j in range(len(ra)):
        if len(ch_l) >= take or neg[j] == BIG:
            break
        l, r = int(ra[j]), int(rb[j])
        if l not in used and r not in used:
            used.update((l, r))
            ch_l.append(l)
            ch_r.append(r)
    return ch_l, ch_r


def _match_chosen(packed, ch_l, ch_r, n_chosen, *, S):
    """cand[i] = slot i's pair is one of the chosen; kidx[i] = which one.
    A searchsorted against the tiny sorted chosen-key table — pairs are
    symbol-disjoint, so each slot matches at most one."""
    P = ch_l.shape[0]
    kmask = _arange(0, P, packed.device) < n_chosen
    ckey = torch.where(kmask, ch_l * S + ch_r, BIG)
    sp, sk = torch.sort(ckey, stable=True)
    pos = torch.searchsorted(sp, packed).clamp(max=P - 1)
    cand = (packed != BIG) & (sp[pos] == packed)
    return cand, sk[pos].to(I32)


def _take_parity(cand, live):
    """Greedy left-to-right == take even offsets within each run of
    chain-consecutive candidates; offsets counted in LIVE positions, so
    dead holes never split a run the host would see as contiguous."""
    idx = _arange(0, cand.shape[0], cand.device)
    pl = _prev_live(live)
    plc = pl.clamp(min=0).long()
    cand_prev = cand[plc] & (pl >= 0)
    chain_start = cand & ~cand_prev
    start_pos = torch.cummax(torch.where(chain_start, idx, -1), 0
                             ).values.clamp(min=0).long()
    livec = torch.cumsum(live, 0, dtype=I32)
    offset = livec - livec[start_pos]
    return cand & (offset % 2 == 0), plc, pl >= 0


def _apply_replace(state: TorchBuildState, packed, ch_l, ch_r, n_chosen,
                   *, S, T):
    """Rewrite every taken slot to its new symbol and deaden its partner
    (the next-live slot) — elementwise ops and gathers."""
    cand, kidx = _match_chosen(packed, ch_l, ch_r, n_chosen, S=S)
    taken, plc, has_prev = _take_parity(cand, state.live)
    new_id = T + state.num_rules + kidx
    seq = torch.where(taken, new_id, state.seq)
    dead = taken[plc] & has_prev
    return state._replace(seq=seq, live=state.live & ~dead,
                          real=state.real & ~dead), taken, kidx


def _register_rules(state: TorchBuildState, ch_l, ch_r, n_chosen: int, *,
                    T) -> TorchBuildState:
    """Write the chosen pairs into the rule tables (in place) at slots
    ``num_rules + k`` with their phrase sums / lengths / depths."""
    if n_chosen == 0:
        return state
    Rb = state.rule_l.shape[0]
    l, r = ch_l[:n_chosen], ch_r[:n_chosen]

    def look(tab, term_val, s):
        ridx = (s - T).clamp(0, Rb - 1).long()
        return torch.where(s < T, term_val, tab[ridx])

    one, zero = torch.ones_like(l), torch.zeros_like(l)
    vals = {"rule_l": l, "rule_r": r,
            "rule_sum": look(state.rule_sum, l, l)
            + look(state.rule_sum, r, r),
            "rule_len": look(state.rule_len, one, l)
            + look(state.rule_len, one, r),
            "rule_depth": 1 + torch.maximum(look(state.rule_depth, zero, l),
                                            look(state.rule_depth, zero, r))}
    lo = state.num_rules
    for name, v in vals.items():
        getattr(state, name)[lo:lo + n_chosen] = v
    return state._replace(num_rules=lo + n_chosen)


def _compact_to(state: TorchBuildState, *, new_np: int) -> TorchBuildState:
    """Shrink the working buffer: gather the live slots (symbols AND
    separators, order preserved) into a fresh ``new_np``-slot buffer.
    Holes accumulate as rounds replace pairs; once fewer than half the
    slots are live, re-bucketing keeps every subsequent round's cost
    proportional to the CURRENT stream, not the original one."""
    Np = state.seq.shape[0]
    dev = state.seq.device
    csum = torch.cumsum(state.live, 0, dtype=I32)
    n_live = csum[Np - 1]
    src = torch.searchsorted(csum, _arange(1, new_np + 1, dev))
    srcc = src.clamp(max=Np - 1)
    on = _arange(0, new_np, dev) < n_live
    return state._replace(seq=torch.where(on, state.seq[srcc], 0),
                          live=on, real=on & state.real[srcc])


def _finalize(seq, live, real, *, L):
    """Strip separators and dead holes: per-list span ends + the
    compacted symbol stream."""
    acum = torch.cumsum(real, 0, dtype=I32)
    sep = live & ~real
    srank = torch.cumsum(sep, 0, dtype=I32)        # 1-based at separators
    ends = torch.zeros(L + 1, dtype=I32, device=seq.device)
    # non-separators all land on slot L, which is cut off
    ends[torch.where(sep, srank - 1, L).long()] = acum
    return seq[real], ends[:L]


class TorchBuilder(Builder):
    """Device Re-Pair construction with plain PyTorch rounds on
    ``device`` (default ``"cuda"``; raises without a card unless
    ``device="cpu"``) — the bit-exact yardstick of :class:`CudaBuilder`.
    ``stats`` holds the last build's rounds, budget growths, compactions
    and exact fallbacks."""

    name = "torch"

    def __init__(self, config: BuildConfig | None = None, *, device="cuda",
                 **overrides):
        super().__init__(config, device=resolve_device(device), **overrides)
        self.stats: dict[str, int] = {}

    def _count(self, packed, pa, pb, vp, *, S, K):
        """The counting stage of a round (``CudaBuilder`` swaps it)."""
        cfg = self.config
        return _count_ranked(packed, pa, pb, vp, S=S, cap=cfg.table_cap,
                             min_count=cfg.min_count, K=K)

    # -- state construction --------------------------------------------------

    def init_state(self, lists: Sequence[np.ndarray]
                   ) -> tuple[TorchBuildState, dict]:
        stream, firsts, lens, universe = lists_to_gap_stream(lists)
        sep = stream == -1
        max_gap = int(stream[~sep].max(initial=0))
        T = max_gap + 1
        n0 = stream.size
        Np = max(128, -(-n0 // 128) * 128)
        Rb = max(1, self.config.budget)
        self._check_pack(T, Rb)
        dev = self.device

        def padded(a: np.ndarray, dtype) -> torch.Tensor:
            out = torch.zeros(Np, dtype=dtype, device=dev)
            out[:n0] = torch.from_numpy(a).to(dev)
            return out

        rules = [torch.zeros(Rb, dtype=I32, device=dev) for _ in range(5)]
        state = TorchBuildState(
            seq=padded(np.where(sep, 0, stream).astype(np.int32), I32),
            live=padded(np.ones(n0, bool), torch.bool),
            real=padded(~sep, torch.bool), rule_l=rules[0],
            rule_r=rules[1], rule_sum=rules[2], rule_len=rules[3],
            rule_depth=rules[4], num_rules=0)
        meta = dict(T=T, firsts=firsts, lens=lens, universe=universe,
                    L=len(lists))
        return state, meta

    @staticmethod
    def _check_pack(T: int, Rb: int) -> None:
        if T + Rb > MAX_PACK:
            raise ValueError(
                f"symbol space T+Rb = {T + Rb} exceeds {MAX_PACK} "
                f"(int32 pair packing); lower rule_budget or use the "
                f"host builder for this corpus")

    def _grow(self, state: TorchBuildState, T: int) -> TorchBuildState:
        """Double the static rule budget."""
        Rb = state.rule_l.shape[0]
        self._check_pack(T, 2 * Rb)
        pad = lambda a: torch.cat([a, torch.zeros_like(a)])
        return state._replace(
            rule_l=pad(state.rule_l), rule_r=pad(state.rule_r),
            rule_sum=pad(state.rule_sum), rule_len=pad(state.rule_len),
            rule_depth=pad(state.rule_depth))

    # -- round-level API (numpy boundary, for cross-backend diffing) ---------

    @staticmethod
    def _pack_space(state: TorchBuildState, T: int, top_id: int = 0) -> int:
        """Packing base for the round-level API: wide enough for the
        budget, every symbol already in the sequence, and any explicit
        id block the caller hands replace_round."""
        s_max = int(torch.where(state.real, state.seq, 0).max())
        S = max(T + state.rule_l.shape[0], s_max + 1, top_id + 1)
        if S > MAX_PACK:
            raise ValueError(f"symbol space {S} exceeds {MAX_PACK}")
        return S

    def count_pairs(self, state_meta) -> tuple[np.ndarray, np.ndarray]:
        state, meta = state_meta
        cfg = self.config
        S = self._pack_space(state, meta["T"])
        _, _, packed = _pair_streams(state.seq, state.live, state.real, S=S)
        neg, ra, rb, rc, n_good, _ = _count_ranked(
            packed, None, None, None, S=S, cap=cfg.table_cap,
            min_count=cfg.min_count, K=None)
        g = int(n_good)
        pairs = torch.stack([ra[:g], rb[:g]], 1).cpu().numpy()
        return pairs.astype(np.int64), rc[:g].cpu().numpy().astype(np.int64)

    def replace_round(self, state_meta, pairs, new_ids):
        state, meta = state_meta
        pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        new_ids = np.asarray(new_ids, dtype=np.int64)
        if pairs.shape[0] > 1 and not (np.diff(new_ids) == 1).all():
            raise ValueError("device replace_round needs contiguous ids")
        P = max(1, self.config.pairs_per_round, pairs.shape[0])
        ch = np.full((2, P), -1, np.int32)
        ch[:, :pairs.shape[0]] = pairs.T
        T = meta["T"]
        first = int(new_ids[0]) if new_ids.size else T
        S = self._pack_space(state, T, top_id=first + pairs.shape[0])
        _, _, packed = _pair_streams(state.seq, state.live, state.real, S=S)
        # align the new-id arithmetic of _apply_replace (T + num_rules
        # + kidx) with the caller's explicit id block
        ch_t = torch.from_numpy(ch).to(self.device)
        new_state, taken, kidx = _apply_replace(
            state._replace(num_rules=first - T), packed, ch_t[0], ch_t[1],
            pairs.shape[0], S=S, T=T)
        new_state = new_state._replace(num_rules=state.num_rules)
        tk = taken.cpu().numpy()
        ki = kidx.cpu().numpy()
        counts = np.bincount(ki[tk], minlength=P)[:pairs.shape[0]]
        return (new_state, meta), counts.astype(np.int64)

    # -- fused build ---------------------------------------------------------

    def _check_round(self, n_runs: int) -> None:
        """Hook for backends whose candidate table is budget-bounded."""

    def _rank_k(self) -> int | None:
        """Static ranked-table size; None = always exact full length."""
        return RANK_K

    def _ranked(self, packed, seq, pb, vp, *, S, K):
        """Count and rank one round's pairs on the device, then bring the
        ranked table and (n_good, n_runs) to the host in one transfer."""
        neg, ra, rb, _, n_good, n_runs = self._count(packed, seq, pb, vp,
                                                     S=S, K=K)
        m = neg.shape[0]
        host = torch.cat([torch.stack([n_good, n_runs]), neg, ra, rb]
                         ).cpu().numpy()
        return ((host[2:2 + m], host[2 + m:2 + 2 * m], host[2 + 2 * m:]),
                int(host[0]), int(host[1]))

    def _round(self, state: TorchBuildState, take: int, *, T: int, P: int):
        """One Re-Pair round: histogram -> greedy top-k -> replacement ->
        rule registration.  Returns the new state and the control scalars
        (n_chosen, kept_any, n_good, n_runs, n_live)."""
        S = T + state.rule_l.shape[0]
        pb, vp, packed = _pair_streams(state.seq, state.live, state.real,
                                       S=S)
        K = self._rank_k()
        ranked, n_good, n_runs = self._ranked(packed, state.seq, pb, vp,
                                              S=S, K=K)
        take = min(take, n_good)
        ch_l, ch_r = _select_disjoint(*ranked, take)
        if K is not None and n_good > K and len(ch_l) < take:
            # ranked table ran dry mid-greedy: redo this round's ranking
            # at full length (rare; parity-critical)
            self.stats["fallbacks"] += 1
            ranked, n_good, n_runs = self._ranked(packed, state.seq, pb, vp,
                                                  S=S, K=None)
            ch_l, ch_r = _select_disjoint(*ranked, take)
        n_chosen = len(ch_l)
        ch = np.full((2, P), -1, np.int32)
        ch[0, :n_chosen], ch[1, :n_chosen] = ch_l, ch_r
        ch_t = torch.from_numpy(ch).to(self.device)
        state, taken, _ = _apply_replace(state, packed, ch_t[0], ch_t[1],
                                         n_chosen, S=S, T=T)
        state = _register_rules(state, ch_t[0], ch_t[1], n_chosen, T=T)
        kept_any, n_live = torch.stack(
            [taken.any().to(I32), state.live.sum(dtype=I32)]).tolist()
        return state, (n_chosen, kept_any, n_good, n_runs, n_live)

    def build_grammar(self, lists: Sequence[np.ndarray]) -> RePairResult:
        with span("build.grammar"):
            return self._build_grammar(lists)

    def _build_grammar(self, lists: Sequence[np.ndarray]) -> RePairResult:
        cfg = self.config
        state, meta = self.init_state(lists)
        T, L = meta["T"], meta["L"]
        P = max(1, cfg.pairs_per_round)
        self.stats = dict(rounds=0, growths=0, compactions=0, fallbacks=0)
        while True:
            if cfg.max_rules is not None and state.num_rules >= cfg.max_rules:
                break
            take = P
            if cfg.max_rules is not None:
                take = min(take, cfg.max_rules - state.num_rules)
            while state.num_rules + take > state.rule_l.shape[0]:
                state = self._grow(state, T)
                self.stats["growths"] += 1
            state, scalars = self._round(state, take, T=T, P=P)
            self.stats["rounds"] += 1
            _, kept_any, n_good, n_runs, n_live = scalars
            self._check_round(n_runs)
            if not n_good or not kept_any:
                break
            # re-bucket once fewer than half the slots are live, so the
            # long tail of small rounds runs on small buffers
            Np = state.seq.shape[0]
            if Np > 128 and n_live <= Np // 2:
                state = _compact_to(
                    state, new_np=max(128, -(-n_live // 128) * 128))
                self.stats["compactions"] += 1

        out_seq, ends = _finalize(state.seq, state.live, state.real, L=L)
        R = state.num_rules
        host = lambda t: t[:R].cpu().numpy()
        grammar = Grammar(
            num_terminals=T,
            rules=np.stack([host(state.rule_l), host(state.rule_r)],
                           axis=1).astype(np.int64).reshape(-1, 2),
            sums=host(state.rule_sum).astype(np.int64),
            lengths=host(state.rule_len).astype(np.int64),
            depths=host(state.rule_depth).astype(np.int32),
        )
        starts = np.concatenate([[0], ends.cpu().numpy()]).astype(np.int64)
        return RePairResult(
            grammar=grammar,
            seq=out_seq.cpu().numpy().astype(np.int64),
            starts=starts,
            first_values=meta["firsts"],
            orig_lengths=meta["lens"],
            universe=meta["universe"],
        )
