"""Inverted index builder: ties the corpus to the compressed representations.

A copy of ``repro/index/builder.py`` (numpy) for the port.  Builders are
routed by name through ``repro_torch.build`` (a device builder named by
string runs on ``device``, the card by default); ``store=`` (or
``REPRO_STORE``) also writes the paged stream into an out-of-core page
store.

Produces an ``InvertedIndex`` holding, per configuration:
  * Re-Pair compressed lists (+ optional §3.4 optimization, phrase sums),
  * (a)/(b)-samplings,
  * optional MC07 bitmap split for long lists,
  * any baseline codec (vbyte/rice/gamma/delta),
all over the SAME postings so benchmarks compare like against like.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..build import BuildConfig, Builder, make_builder
from ..core import bitmaps as BM
from ..core import codecs as CD
from ..core.optimize import optimize_rules
from ..core.repair import RePairResult
from ..core.sampling import ASampling, BSampling, build_a_sampling, build_b_sampling
from ..store import build_page_store, resolve_store_kind


@dataclasses.dataclass
class InvertedIndex:
    lists: list[np.ndarray]                  # the raw postings (oracle)
    universe: int
    repair: RePairResult
    a_samp: ASampling
    b_samp: BSampling
    bitmap_idx: list[int]                    # lists stored as bitmaps (hybrid)
    bitmaps: dict[int, BM.Bitmap]
    codecs: dict[str, CD.EncodedLists]
    term_of_list: np.ndarray | None = None
    #: out-of-core tier: the paged stream behind a PageStore, or None
    page_store: object = None

    def list_length(self, i: int) -> int:
        return int(len(self.lists[i]))

    # -- space accounting (bits) -------------------------------------------
    def space_report(self) -> dict[str, float]:
        n_post = sum(len(l) for l in self.lists)
        from ..core.dictionary import build_forest

        forest = build_forest(self.repair.grammar)
        rep_bits = forest.size_bits(self.repair.seq.size)
        out = {
            "postings": float(n_post),
            "repair_bits": float(rep_bits),
            "repair_bits_per_posting": rep_bits / n_post,
            "repair_dict_bits": float(forest.size_bits(0)),
            "a_sampling_bits": float(self.a_samp.size_bits(self.universe)),
            "b_sampling_bits": float(self.b_samp.size_bits(
                self.universe,
                np.asarray([self.repair.compressed_length(i)
                            for i in range(self.repair.num_lists)]))),
            "bitmap_bits": float(sum(b.size_bits() for b in self.bitmaps.values())),
            "plain_bits": float(n_post * max(1, int(np.ceil(np.log2(max(2, self.universe)))))),
        }
        for name, enc in self.codecs.items():
            out[f"{name}_bits"] = float(enc.size_bits())
        return out

    def codec_tier_report(self, mode: str = "adaptive") -> dict:
        """Space report of a per-list codec tier (DESIGN.md §10) over this
        index's Re-Pair result: per-codec list counts and bits/posting for
        ``mode`` in {"repair", "ef", "bitmap", "adaptive"}."""
        from .codec_tier import build_codec_tier

        tier = build_codec_tier(self.repair, mode)
        if tier is None:        # "repair" — the tier adds nothing
            rep = self.space_report()
            return {"mode": "repair", "total_bits": rep["repair_bits"],
                    "bits_per_posting": rep["repair_bits_per_posting"],
                    "counts": {"repair": self.repair.num_lists,
                               "ef": 0, "bitmap": 0}}
        return tier.space_report(self.repair)


def build_index(
    lists: Sequence[np.ndarray],
    universe: int | None = None,
    *,
    optimize: bool = True,
    a_k: int = 8,
    b_B: int = 8,
    hybrid_bitmaps: bool = False,
    bitmap_threshold_div: int = 8,
    codecs: Sequence[str] = ("vbyte", "rice"),
    codec_k: int = 32,
    pairs_per_round: int = 64,
    max_rules: int | None = None,
    builder: str | Builder = "host",
    build_cfg: BuildConfig | None = None,
    store: str | None = None,
    page_size: int | None = None,
    device="cuda",
) -> InvertedIndex:
    lists = [np.asarray(l, dtype=np.int64) for l in lists]
    u = universe or max(int(l[-1]) + 1 for l in lists)

    bitmap_idx: list[int] = []
    bitmaps: dict[int, BM.Bitmap] = {}
    repair_input = list(lists)
    if hybrid_bitmaps:
        bitmap_idx, _ = BM.split_for_hybrid(lists, u, bitmap_threshold_div)
        for i in bitmap_idx:
            bitmaps[i] = BM.build_bitmap(lists[i], u)
        # paper: "we extract the lists that would be represented by bitmaps
        # ... and then we proceed to the compression phase" — the extracted
        # lists are excluded from Re-Pair's input; we keep placeholders so
        # list indices stay aligned (a 2-element dummy compresses to ~nothing).
        repair_input = [l if i not in bitmaps else l[:2]
                        for i, l in enumerate(lists)]

    # Re-Pair construction routes through the backend-pluggable build
    # subsystem (DESIGN.md §3); all backends produce bit-identical
    # grammars, so the choice is a pure throughput knob.  The legacy
    # knobs (pairs_per_round/max_rules) only apply when this function
    # constructs the config itself — refuse conflicting requests rather
    # than silently prefer one side.
    knobs_set = pairs_per_round != 64 or max_rules is not None
    if knobs_set and (build_cfg is not None or isinstance(builder, Builder)):
        raise ValueError(
            "pass pairs_per_round/max_rules inside build_cfg (or the "
            "Builder's own config), not alongside one")
    if not isinstance(builder, Builder):
        if build_cfg is None:
            build_cfg = BuildConfig(pairs_per_round=pairs_per_round,
                                    max_rules=max_rules)
        builder = make_builder(builder, build_cfg, device=device)
    rep = builder.build_grammar(repair_input)
    if optimize:
        rep, _ = optimize_rules(rep)
    a_samp = build_a_sampling(rep, a_k)
    b_samp = build_b_sampling(rep, b_B)
    enc = {name: CD.encode_lists(lists, name, k=codec_k, universe=u)
           for name in codecs}
    # out-of-core storage axis (DESIGN.md §11): write the paged stream
    # (+ per-page phrase sums) at build time — ``store=None`` honours
    # REPRO_STORE, ""/"none" keeps the fully resident layout
    kind = resolve_store_kind(store)
    page_store = (build_page_store(rep, kind=kind, page_size=page_size)
                  if kind is not None else None)
    return InvertedIndex(
        lists=lists, universe=u, repair=rep, a_samp=a_samp, b_samp=b_samp,
        bitmap_idx=bitmap_idx, bitmaps=bitmaps, codecs=enc,
        page_store=page_store,
    )
