"""Serving launcher of the port: the ``queries`` tier.

  PYTHONPATH=src python -m repro_torch.launch.serve --tier queries --engine cuda

Builds a Zipf synthetic collection (``index/corpus.py::zipf_corpus``),
compresses it with the host Re-Pair, and serves it from the chosen engine
on the chosen device (default: the CUDA kernels on the card):

* a batch of 2-term AND queries (``and_batch``), spot-checked against
  numpy set intersection;
* ``--concurrency N``: a Zipf boolean workload (``boolean_workload``)
  through the coalescing scheduler with N queries in flight, checked
  against ``naive_eval``;
* ``--topk K``: a Zipf ranked workload (``ranked_workload``) of BM25
  top-K queries with block-max page pruning, checked against
  ``rank_oracle`` (exact scores and order);
* ``--query Q``: one boolean query string, planned, explained, executed.

``boolean_workload`` and ``ranked_workload`` are copies of the JAX
package's ``benchmarks/common.py`` generators (same Zipf law over the
popularity ranking, same query shapes), so both packages can be driven by
the same query streams.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def boolean_workload(num_lists, lengths, n_queries=64, seed=0,
                     max_terms=4, p_or=0.2, p_not=0.12, p_phrase=0.12,
                     zipf_s=1.1):
    """Zipf-distributed boolean/phrase query stream over ``num_lists``
    postings lists: term draws follow a Zipf law over the POPULARITY
    ranking (longer list = more often queried).  Query shapes: k-term AND
    (k in [2, max_terms]), OR of two ANDs, AND with one negated term, and
    adjacent-term phrases.  Returns AST nodes; a pure function of the
    arguments."""
    from ..query.ast import And, Not, Or, Phrase, Term

    rng = np.random.default_rng(seed)
    order = np.argsort(-np.asarray(lengths))         # popularity ranking
    p = np.arange(1, num_lists + 1, dtype=np.float64) ** (-zipf_s)
    p /= p.sum()

    def draw_terms(k):
        ranks = rng.choice(num_lists, size=k, replace=False, p=p)
        return [int(order[r]) for r in ranks]

    out = []
    for _ in range(n_queries):
        u = rng.random()
        k = int(rng.integers(2, max_terms + 1))
        if u < p_phrase:
            t0 = int(order[rng.choice(num_lists, p=p)])
            out.append(Phrase(tuple(min(t0 + j, num_lists - 1)
                                    for j in range(k))))
        elif u < p_phrase + p_not:
            ts = draw_terms(k)
            out.append(And(tuple([Term(t) for t in ts[:-1]]
                                 + [Not(Term(ts[-1]))])))
        elif u < p_phrase + p_not + p_or:
            a, b = draw_terms(2), draw_terms(2)
            out.append(Or((And((Term(a[0]), Term(a[1]))),
                           And((Term(b[0]), Term(b[1]))))))
        else:
            out.append(And(tuple(Term(t) for t in draw_terms(k))))
    return out


def ranked_workload(num_lists, lengths, n_queries=32, seed=0,
                    max_terms=4, zipf_s=1.1):
    """Zipf-distributed ranked (bag-of-words) query stream: each query is
    a bag of 2..max_terms distinct term ids drawn like
    :func:`boolean_workload`'s terms.  Returns term-id lists."""
    rng = np.random.default_rng(seed)
    order = np.argsort(-np.asarray(lengths))         # popularity ranking
    p = np.arange(1, num_lists + 1, dtype=np.float64) ** (-zipf_s)
    p /= p.sum()
    out = []
    for _ in range(n_queries):
        k = int(rng.integers(2, max_terms + 1))
        ranks = rng.choice(num_lists, size=k, replace=False, p=p)
        out.append([int(order[r]) for r in ranks])
    return out


def build_corpus(num_docs: int, vocab: int, seed: int):
    """Postings of the Zipf collection and their Re-Pair compression."""
    from ..core.repair import repair_compress
    from ..index.corpus import zipf_corpus

    corpus = zipf_corpus(num_docs=num_docs, vocab_size=vocab,
                         mean_doc_len=120, seed=seed)
    lists = corpus.postings()
    return lists, repair_compress(lists)


def serve_queries(n_queries: int, engine: str = "cuda", device="cuda",
                  query: str | None = None, concurrency: int = 0,
                  topk: int = 0, batch_window: int | None = None,
                  num_docs: int = 2000, vocab: int = 4000,
                  seed: int = 0) -> None:
    from ..kernels import resolve_device
    from ..serve.query_serve import QueryServer

    if engine != "host":
        resolve_device(device)        # no card: raise before the build
    t0 = time.perf_counter()
    lists, res = build_corpus(num_docs, vocab, seed)
    dt = time.perf_counter() - t0
    n_sym = sum(len(l) for l in lists)
    print(f"corpus: {num_docs} docs / {len(lists)} lists (vocab {vocab}, "
          f"seed {seed}); host Re-Pair built {res.grammar.num_rules} rules "
          f"from {n_sym} postings in {dt:.2f}s")
    srv = QueryServer(res, max_short_len=256, engine=engine, device=device,
                      batch_window=batch_window)
    print(f"engine {engine} on "
          f"{getattr(srv.engine, 'device', 'host')}")
    rng = np.random.default_rng(0)
    pairs = [tuple(map(int, rng.choice(len(lists), 2, replace=False)))
             for _ in range(n_queries)]
    srv.and_batch(pairs[:2])
    t0 = time.perf_counter()
    outs = srv.and_batch(pairs)
    dt = time.perf_counter() - t0
    print(f"{len(pairs)} conjunctive queries in {dt*1e3:.1f} ms "
          f"({len(pairs)/dt:.0f} q/s), {sum(len(o) for o in outs)} hits")
    for (a, b), got in list(zip(pairs, outs))[::max(len(pairs)//8, 1)]:
        np.testing.assert_array_equal(got, np.intersect1d(lists[a], lists[b]))
    print("spot checks OK")
    lengths = [len(l) for l in lists]

    if concurrency:
        from ..query import naive_eval
        qs = boolean_workload(len(lists), lengths,
                              n_queries=max(concurrency * 4, 16), seed=seed)
        if batch_window is None:
            srv.scheduler.batch_window = max(1, concurrency)
        outs = srv.search_many(qs)
        for q, got in list(zip(qs, outs))[::max(len(qs) // 8, 1)]:
            np.testing.assert_array_equal(
                got, naive_eval(q, lists, res.universe))
        st = srv.serve_stats()
        print(f"scheduler: {st['completed']} boolean queries, "
              f"{st['qps']:.0f} q/s, p50 {st['p50_ms']:.2f} ms / "
              f"p95 {st['p95_ms']:.2f} ms, coalescing factor "
              f"{st['coalescing_factor']:.2f} over {st['dispatches']} "
              f"merged dispatches (window {st['batch_window']}), "
              f"spot checks OK")
        print(f"hot-path dedup: factor {st['dedup_factor']:.2f} "
              f"({st['real_lanes']} real / {st['unique_lanes']} unique / "
              f"{st['pad_lanes']} pad lanes), memo hit rate "
              f"{st['memo_hit_rate']:.3f}")

    if topk:
        from ..query import rank_oracle
        bags = ranked_workload(len(lists), lengths, n_queries=16, seed=seed)
        srv.search_topk(bags[0], topk)    # build the score tier
        t0 = time.perf_counter()
        routs = srv.search_topk_many(bags, topk)
        dt = time.perf_counter() - t0
        st = srv.serve_stats()
        print(f"ranked top-{topk}: {len(bags)} queries in {dt*1e3:.1f} ms "
              f"({len(bags)/dt:.0f} q/s), pages scored "
              f"{st['pages_scored']} / skipped {st['pages_skipped']} "
              f"(frac {st['pages_skipped_frac']:.3f}), final threshold "
              f"{st['threshold_final']:.3f}")
        for bag, got in list(zip(bags, routs))[::4]:
            od, osc = rank_oracle(lists, res.universe, bag, topk)
            np.testing.assert_array_equal(got.docs, od)
            np.testing.assert_array_equal(got.scores, osc)
        print("ranked spot checks OK (exact BM25 scores and order)")

    if query is not None:
        from ..query import naive_eval
        print(f"\nquery: {query}\nplan:\n{srv.explain(query)}")
        t0 = time.perf_counter()
        hits = srv.search(query)
        dt = time.perf_counter() - t0
        np.testing.assert_array_equal(
            hits, naive_eval(srv.plan(query).node, lists, res.universe))
        print(f"{hits.size} hits in {dt*1e3:.1f} ms (oracle-verified); "
              f"first 10: {hits[:10].tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", choices=("queries",), default="queries")
    ap.add_argument("--engine", choices=("host", "torch", "cuda"),
                    default="cuda")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain PyTorch versions")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--query", default=None,
                    help="boolean query string to plan + execute, e.g. "
                         "'(12 AND 40) OR NOT 7'")
    ap.add_argument("--concurrency", type=int, default=0,
                    help="run a Zipf boolean workload with this many "
                         "queries in flight through the coalescing "
                         "scheduler (0 = skip)")
    ap.add_argument("--batch-window", type=int, default=None,
                    help="scheduler in-flight window (default: "
                         "--concurrency, or REPRO_BATCH_WINDOW)")
    ap.add_argument("--topk", type=int, default=0,
                    help="run a ranked BM25 top-K workload with block-max "
                         "page pruning (0 = skip)")
    ap.add_argument("--num-docs", type=int, default=2000,
                    help="collection size")
    ap.add_argument("--vocab", type=int, default=4000,
                    help="corpus vocabulary size")
    ap.add_argument("--seed", type=int, default=0,
                    help="corpus and workload seed")
    args = ap.parse_args()
    serve_queries(args.n, args.engine, device=args.device, query=args.query,
                  concurrency=args.concurrency, topk=args.topk,
                  batch_window=args.batch_window, num_docs=args.num_docs,
                  vocab=args.vocab, seed=args.seed)


if __name__ == "__main__":
    main()
