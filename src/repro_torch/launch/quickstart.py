"""Quickstart: build an inverted index over a synthetic collection,
compress it with Re-Pair, and run conjunctive queries with every method —
the port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Five sections: the collection, Re-Pair compression of its d-gap streams,
conjunctive queries by every method of the hybrid engine (all must agree),
phrase queries on a positional index, device-side construction by the
``torch`` builder (its grammar must be bit-identical to the host loop's),
and skipping by phrase sums.  The construction runs on the card unless
``--device cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..build import make_builder
from ..core.intersect import CompressedList
from ..index import HybridQueryEngine as QueryEngine, build_index, zipf_corpus
from ..index.positional import PositionalIndex, positional_corpus
from ..kernels import resolve_device


def main(device="cuda") -> None:
    dev = resolve_device(device)
    print("=== building synthetic collection (Zipf words, topical docs) ===")
    corpus = zipf_corpus(num_docs=2000, vocab_size=5000, mean_doc_len=120,
                         seed=0)
    lists = corpus.postings()
    n_post = sum(len(l) for l in lists)
    print(f"{corpus.num_docs} docs, {len(lists)} terms, {n_post} postings")

    print("\n=== Re-Pair compression of the d-gap streams (paper §3.1) ===")
    ix = build_index(lists, corpus.num_docs, codecs=("vbyte", "rice"),
                     builder="host", device=dev)
    rep = ix.space_report()
    print(f"plain:   {rep['plain_bits']/8/1024:8.1f} KiB")
    print(f"re-pair: {rep['repair_bits']/8/1024:8.1f} KiB "
          f"({rep['repair_bits_per_posting']:.2f} bits/posting, "
          f"dict {rep['repair_dict_bits']/8/1024:.1f} KiB)")
    print(f"vbyte:   {rep['vbyte_bits']/8/1024:8.1f} KiB")
    print(f"rice:    {rep['rice_bits']/8/1024:8.1f} KiB")
    g = ix.repair.grammar
    print(f"grammar: {g.num_rules} rules, max depth {g.max_depth()} "
          f"(§5.1 predicts O(log n))")

    print("\n=== conjunctive queries, all methods agree (paper §3.3) ===")
    # query three mid-frequency terms (rare random terms AND to nothing)
    by_len = sorted(range(len(lists)), key=lambda i: -len(lists[i]))
    qterms = [int(by_len[10]), int(by_len[25]), int(by_len[40])]
    oracle = None
    for method in ("merge", "skip", "svs", "lookup", "vbyte"):
        qe = QueryEngine(ix, method=method)
        got = qe.conjunctive(qterms)
        if oracle is None:
            oracle = got
        assert np.array_equal(got, oracle), method
        print(f"  {method:8s} -> {len(got)} documents")
    print(f"query terms {qterms}: {oracle[:10]}"
          f"{'...' if len(oracle) > 10 else ''}")

    print("\n=== phrase queries on a positional index (§1) ===")
    pc = positional_corpus(num_docs=300, vocab_size=800, mean_doc_len=60,
                           seed=2)
    pix = PositionalIndex(pc)
    n_pos = sum(len(l) for l in pix.lists)
    print(f"position postings: {n_pos} -> {pix.repair.seq.size} Re-Pair "
          f"symbols ({pix.space_bits()/8/1024:.1f} KiB)")
    hits = 0
    for t0 in range(12):
        docs = pix.phrase([t0, t0 + 1])     # sticky bigrams exist by corpus
        hits += len(docs)
    print(f"12 bigram phrase queries -> {hits} matching documents "
          f"(position-list intersection, lookup strategy)")

    print(f"\n=== device-side construction on {dev} (torch builder) ===")
    # the same compression as fixed-shape rounds on the device: postings ->
    # gap stream -> grammar -> FlatIndex on the device, bit-identical to
    # the host loop above
    sub = lists[:200]
    built = make_builder("torch", table_cap=256, device=dev).build_index(sub)
    oracle_res = make_builder("host", table_cap=256).build_grammar(sub)
    assert np.array_equal(built.res.grammar.rules, oracle_res.grammar.rules)
    assert np.array_equal(built.res.seq, oracle_res.seq)
    assert built.fi.device == dev
    n_sub = sum(len(l) for l in sub)
    print(f"torch builder: {n_sub} postings -> {built.res.seq.size} symbols, "
          f"{built.res.grammar.num_rules} rules — grammar bit-identical to "
          f"the host loop; FlatIndex on {built.fi.device} for any engine")

    print("\n=== skipping without expansion (phrase sums, §3.2) ===")
    i_long = max(range(len(lists)), key=lambda i: len(lists[i]))
    cl = CompressedList(ix.repair, i_long)
    x = int(lists[i_long][len(lists[i_long]) // 2])
    v = cl.next_geq(x, cl.cursor())
    print(f"longest list has {len(lists[i_long])} entries, compressed to "
          f"{ix.repair.compressed_length(i_long)} symbols; next_geq({x}) = "
          f"{v} touching {cl.ops} symbols")
    print("\nquickstart OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    main(device=ap.parse_args().device)
