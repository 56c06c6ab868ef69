"""Serving launcher of the port: both serving tiers behind one CLI.

  PYTHONPATH=src python -m repro_torch.launch.serve --tier queries --engine cuda
  PYTHONPATH=src python -m repro_torch.launch.serve --tier lm --arch yi-6b

``--tier lm`` serves ``--n`` requests (prompts of 3-11 random tokens) by
continuous-batching decode (``serve.engine.DecodeEngine``: 4 lanes, a
64-slot cache, 16 new tokens each) on the arch's smoke config with seeded
random weights, on ``--device``.  The rest of this docstring is the
``queries`` tier.

Builds a Zipf synthetic collection (``index/corpus.py::zipf_corpus``),
compresses it with the chosen builder (``--builder``: ``host`` Re-Pair by
default, ``torch`` rounds or ``cuda`` rounds over the ``pair_count``
kernel on the device; ``cuda`` gets the [CN07] capped-counting table
``table_cap=4096`` its candidate table holds exactly), and serves it from
the chosen engine on the chosen device (default: the CUDA kernels on the
card):

* a batch of 2-term AND queries (``and_batch``), spot-checked against
  numpy set intersection;
* ``--concurrency N``: a Zipf boolean workload (``boolean_workload``)
  through the coalescing scheduler with N queries in flight, checked
  against ``naive_eval``;
* ``--topk K``: a Zipf ranked workload (``ranked_workload``) of BM25
  top-K queries with block-max page pruning, checked against
  ``rank_oracle`` (exact scores and order);
* ``--query Q``: one boolean query string, planned, explained, executed;
* ``--codec C``: serve under the per-list codec tier (``repair``, ``ef``,
  ``bitmap`` or ``adaptive``; default ``REPRO_CODEC``, else ``repair``)
  and print the tier's list counts and bits per posting;
* ``--store S`` / ``--resident-pages N``: serve the compressed stream
  from a ``memory`` or ``mmap`` page store through a bounded admission
  cache of N pages (defaults ``REPRO_STORE``, ``REPRO_STORE_DIR`` for the
  mmap directory, and ``REPRO_RESIDENT_PAGES``; unset means fully
  resident); prints the store's geometry and, after the boolean
  workload, the cache's faults, evictions and hit rate (the page is
  ``REPRO_PAGE_SIZE`` symbols, else 2,048);
* ``--data-shards N``: serve list-sharded over the first N devices on a
  ``data`` mesh axis (``QueryServer(mesh=...)``; the served and the
  ingest server both); on ``--device cuda`` the devices are the cards, on
  ``--device cpu`` the CPU counts as one device; the host engine has no
  mesh and refuses it;
* ``--refresh N`` (alias ``--refreshes``): grow the collection N times by
  ``--growth-docs`` documents (default 500) of a ``PostingsSource`` (new
  documents only), rebuild it with the same builder, hot-swap it in
  (``QueryServer.rebuild``) and check 8 conjunctions against
  ``np.intersect1d`` after each swap;
* ``--ingest-rate N``: stream N documents a round, for 6 rounds, into a
  fresh coverage corpus served by the same engine through the segmented
  index (``QueryServer.enable_ingest``, delta budget
  ``REPRO_DELTA_BUDGET``, else 12, fanout 2), each round's boolean and
  top-10 answers held to ``naive_eval`` / ``rank_oracle`` over the
  current corpus (the interleaved == rebuild-from-scratch gate), and
  print the segment telemetry.

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


def zipf_postings(num_docs: int, vocab: int, seed: int):
    """Postings lists of the Zipf collection and the term id of each."""
    from ..index.corpus import zipf_corpus

    corpus = zipf_corpus(num_docs=num_docs, vocab_size=vocab,
                         mean_doc_len=120, seed=seed)
    lists = corpus.postings()
    return lists, corpus.term_ids


def build_corpus(num_docs: int, vocab: int, seed: int):
    """Postings of the Zipf collection and their host Re-Pair
    compression."""
    from ..core.repair import repair_compress

    lists, _ = zipf_postings(num_docs, vocab, seed)
    return lists, repair_compress(lists)


def serve_queries(n_queries: int, engine: str = "cuda", device="cuda",
                  query: str | None = None, concurrency: int = 0,
                  topk: int = 0, batch_window: int | None = None,
                  num_docs: int = 2000, vocab: int = 4000,
                  seed: int = 0, codec: str | None = None,
                  builder: str = "host", refreshes: int = 0,
                  store: str | None = None,
                  resident_pages: int | None = None,
                  ingest_rate: int = 0, data_shards: int = 0,
                  growth_docs: int = 500) -> None:
    from ..build import make_builder
    from ..kernels import resolve_device
    from ..serve.query_serve import QueryServer

    if data_shards and engine == "host":
        raise SystemExit("--data-shards shards the torch and cuda engines; "
                         "the host engine has no mesh")
    if engine != "host" or builder != "host":
        resolve_device(device)        # no card: raise before the build
    # the cuda builder counts against a static candidate table, so give
    # it the [CN07] capped-counting config its table holds exactly (host
    # and torch accept the same knob; uncapped they count everything)
    bld = make_builder(builder, device=device,
                       **({"table_cap": 4096} if builder == "cuda" else {}))
    lists, term_ids = zipf_postings(num_docs, vocab, seed)
    t0 = time.perf_counter()
    res = bld.build_grammar(lists)
    dt = time.perf_counter() - t0
    n_sym = sum(len(l) for l in lists)
    print(f"corpus: {num_docs} docs / {len(lists)} lists (vocab {vocab}, "
          f"seed {seed}); [{builder}] Re-Pair built "
          f"{res.grammar.num_rules} rules from {n_sym} postings in "
          f"{dt:.2f}s")
    mesh = None
    if data_shards:
        import torch
        from ..distributed import Mesh
        devs = (["cpu"] if torch.device(device).type == "cpu" else
                [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        if data_shards > len(devs):
            raise SystemExit(f"--data-shards {data_shards} > "
                             f"{len(devs)} available devices")
        mesh = Mesh(devs[:data_shards])
        print(f"list-sharded dispatch over data axis: {data_shards} "
              f"device(s)")
    srv = QueryServer(res, max_short_len=256, engine=engine, device=device,
                      batch_window=batch_window, codec=codec, store=store,
                      resident_pages=resident_pages, mesh=mesh)
    print(f"engine {engine} on "
          f"{getattr(srv.engine, 'device', 'host')}")
    if srv.engine.tier is not None:
        rep = srv.engine.tier.space_report(res)
        print(f"codec tier [{rep['mode']}]: {rep['counts']} "
              f"({rep['bits_per_posting']:.2f} bits/posting)")
    if srv.engine.resident is not None:
        ss = srv.engine.resident.stats()
        extra = (f", {srv.engine.store.disk_bytes / 1e6:.1f} MB on disk"
                 if hasattr(srv.engine.store, "disk_bytes") else "")
        print(f"page store [{ss['kind']}]: {ss['num_pages']} pages x "
              f"{ss['page_size']} syms, resident budget {ss['budget']}"
              f"{extra}")
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
              f"{st['memo_hit_rate']:.3f}; codec dispatches "
              f"{st['codec_dispatches']}")
        if st["store"] is not None:
            print(f"admission cache: {st['page_faults']} faults / "
                  f"{st['page_evictions']} evictions, "
                  f"{st['resident_pages']} pages resident "
                  f"(budget {st['store']['budget']}, pool grows "
                  f"{st['store']['pool_grows']}), "
                  f"{st['fault_bytes'] / 1e6:.2f} MB faulted, hit rate "
                  f"{st['store_hit_rate']:.3f}, prefetched "
                  f"{st['prefetched_pages']} pages (accuracy "
                  f"{st['prefetch_accuracy']:.3f})")

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

    if refreshes:
        # grow the served collection by one version's new documents of a
        # PostingsSource (doc ids continue after the base corpus), rebuild
        # with the same builder, hot-swap, keep answering
        from ..data import PostingsSource
        src = PostingsSource(base_docs=num_docs, growth_docs=growth_docs,
                             vocab=vocab, mean_doc_len=120, seed=seed)
        inv = {int(t): l.tolist() for t, l in zip(term_ids, lists)}
        n_docs = num_docs
        for v in range(1, refreshes + 1):
            for terms in src.deltas_at(v):
                for t in terms.tolist():
                    inv.setdefault(int(t), []).append(n_docs)
                n_docs += 1
            new_lists = [np.asarray(inv[t], np.int64) for t in sorted(inv)]
            t0 = time.perf_counter()
            srv.rebuild(new_lists, builder=bld)
            dt = time.perf_counter() - t0
            q = [tuple(map(int, rng.choice(len(new_lists), 2, replace=False)))
                 for _ in range(8)]
            for (a, b), got in zip(q, srv.and_batch(q)):
                np.testing.assert_array_equal(
                    got, np.intersect1d(new_lists[a], new_lists[b]))
            print(f"refresh v{v}: +{growth_docs} docs -> {len(new_lists)} "
                  f"lists / {sum(len(l) for l in new_lists)} postings "
                  f"rebuilt [{builder}] + swapped in {dt:.2f}s (index "
                  f"version {srv.version}), serving verified")

    if ingest_rate:
        # streaming ingestion: documents insert one at a time through the
        # segmented index — visible at once, flushed into immutable Re-Pair
        # segments past the delta budget, compacted by the scheduler —
        # while every round's answers are held to a rebuild-from-scratch
        # oracle
        import os
        from ..data import PostingsSource
        from ..query import naive_eval, rank_oracle
        from ..query.parser import parse

        cvocab = 96
        isrc = PostingsSource(base_docs=48, growth_docs=16, vocab=cvocab,
                              mean_doc_len=16, seed=seed)
        # a coverage head doc (every term) pins global term id == dense
        # list index on both the segmented and the rebuilt side
        docs = [np.arange(cvocab, dtype=np.int64)]
        docs += [isrc.doc_terms(d) for d in range(47 + 6 * ingest_rate)]

        def inv_of(ds):
            iv: dict[int, list[int]] = {}
            for d, terms in enumerate(ds):
                for t in terms.tolist():
                    iv.setdefault(int(t), []).append(d)
            return [np.asarray(iv[t], np.int64) for t in sorted(iv)]

        srv2 = QueryServer(bld.build_grammar(inv_of(docs[:48])),
                           max_short_len=256, engine=engine, device=device,
                           batch_window=batch_window, codec=codec,
                           store=store, resident_pages=resident_pages,
                           mesh=mesh)
        budget = int(os.environ.get("REPRO_DELTA_BUDGET", "12"))
        srv2.enable_ingest(delta_budget=budget, compact_fanout=2,
                           builder=bld)
        qgen = np.random.default_rng(seed + 5)
        pos, checked = 48, 0
        t0 = time.perf_counter()
        for _ in range(6):
            for _ in range(ingest_rate):
                srv2.insert(docs[pos])
                pos += 1
            lists2, n2 = inv_of(docs[:pos]), pos
            ts = sorted(qgen.choice(cvocab, 3, replace=False).tolist())
            qs = [f"{ts[0]} AND {ts[1]}",
                  f"({ts[0]} AND {ts[1]}) OR NOT {ts[2]}"]
            for qstr, got in zip(qs, srv2.search_many(qs)):
                np.testing.assert_array_equal(
                    got, naive_eval(parse(qstr, None), lists2, n2))
            rr = srv2.search_topk(ts, 10)
            od, osc = rank_oracle(lists2, n2, ts, 10)
            np.testing.assert_array_equal(rr.docs, od)
            np.testing.assert_array_equal(rr.scores, osc)
            checked += len(qs) + 1
        dt = time.perf_counter() - t0
        st = srv2.serve_stats()
        print(f"ingest: {pos - 48} docs streamed ({ingest_rate}/round, "
              f"delta budget {budget}, builder {builder}) interleaved with "
              f"{checked} verified queries in {dt:.2f}s")
        print(f"  segments {st['segments']}, delta_docs {st['delta_docs']}"
              f", flushes {st['flushes']} ({st['flush_ms']:.1f} ms), "
              f"compactions {st['compactions']}")
        print("ingest gate OK: interleaved insert/search == "
              "rebuild-from-scratch (boolean + top-k, exact scores)")


def serve_lm(arch_name: str, n_requests: int, device="cuda",
             seed: int = 0) -> list[list[int]]:
    """``--tier lm``: continuous-batching decode of ``n_requests`` random
    prompts on ``arch_name``'s smoke config (weights from a generator
    seeded with ``seed`` on ``device``).  Returns the finished token
    streams."""
    import torch
    from ..configs import get_arch
    from ..kernels import resolve_device
    from ..models.transformer import init_params
    from ..serve import DecodeEngine, ServeConfig

    dev = resolve_device(device)
    cfg = get_arch(arch_name).smoke_config
    model = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    eng = DecodeEngine(model, ServeConfig(max_batch=4, s_cache=64,
                                          max_new_tokens=16), device=dev)
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        plen = int(rng.integers(3, 12))
        eng.submit(rng.integers(1, cfg.vocab, plen).astype(np.int32))
    t0 = time.perf_counter()
    outs = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(o) for o in outs)
    print(f"[{arch_name} on {dev}] served {len(outs)} requests / {toks} "
          f"tokens in {dt:.2f}s ({toks/dt:.0f} tok/s, continuous batching "
          f"over 4 lanes)")
    return outs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tier", choices=("queries", "lm"), default="queries")
    ap.add_argument("--arch", default="yi-6b",
                    help="--tier lm: the architecture whose smoke config "
                         "is served (repro_torch.configs.list_archs())")
    ap.add_argument("--engine", choices=("host", "torch", "cuda"),
                    default="cuda")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain PyTorch versions")
    ap.add_argument("--n", type=int, default=256,
                    help="queries (--tier queries) or requests (--tier lm)")
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
                    help="corpus and workload seed (--tier lm: weights and "
                         "prompts)")
    ap.add_argument("--codec", default=None,
                    choices=("repair", "ef", "bitmap", "adaptive"),
                    help="per-list codec tier: force one codec or "
                         "'adaptive' cost-model selection (default: "
                         "repair, or REPRO_CODEC)")
    ap.add_argument("--builder", choices=("host", "torch", "cuda"),
                    default="host",
                    help="construction backend (repro_torch.build); torch "
                         "and cuda build on --device")
    ap.add_argument("--refresh", "--refreshes", dest="refresh", type=int,
                    default=0,
                    help="after serving, rebuild+hot-swap the index this "
                         "many times from a growing PostingsSource")
    ap.add_argument("--growth-docs", type=int, default=500,
                    help="documents each --refresh version adds")
    ap.add_argument("--data-shards", type=int, default=0,
                    help="shard the index across N devices on a 'data' "
                         "mesh axis (0 = unsharded)")
    ap.add_argument("--store", default=None, choices=("memory", "mmap"),
                    help="out-of-core page store: serve the compressed "
                         "stream from a page store behind the bounded "
                         "admission cache (default: fully resident, or "
                         "REPRO_STORE)")
    ap.add_argument("--resident-pages", type=int, default=None,
                    help="admission-cache budget in pages (default: all "
                         "pages, or REPRO_RESIDENT_PAGES)")
    ap.add_argument("--ingest-rate", type=int, default=0,
                    help="stream this many inserted docs per round "
                         "through the segmented index, interleaved with "
                         "oracle-verified boolean + top-k queries "
                         "(0 = skip)")
    args = ap.parse_args()
    if args.tier == "lm":
        serve_lm(args.arch, args.n, device=args.device, seed=args.seed)
        return
    serve_queries(args.n, args.engine, device=args.device, query=args.query,
                  concurrency=args.concurrency, topk=args.topk,
                  batch_window=args.batch_window, num_docs=args.num_docs,
                  vocab=args.vocab, seed=args.seed, codec=args.codec,
                  builder=args.builder, refreshes=args.refresh,
                  store=args.store, resident_pages=args.resident_pages,
                  ingest_rate=args.ingest_rate, data_shards=args.data_shards,
                  growth_docs=args.growth_docs)


if __name__ == "__main__":
    main()
