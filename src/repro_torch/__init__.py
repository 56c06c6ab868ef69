"""PyTorch/CUDA port of the Re-Pair compressed inverted-list server.

A package of its own beside the JAX reference package ``repro``: it
imports torch and numpy and nothing of JAX or ``repro``.  The layout
follows ``repro`` module for module where a counterpart exists:
``core`` (host Re-Pair construction, torch device indexes), ``build``
(host / torch / cuda index builders), ``data`` (the versioned postings
feed), ``index`` (corpus, codec tier, index builder), ``engine`` (host /
torch / cuda backends), ``kernels`` (hand-written CUDA kernels K1-K8:
``list_intersect``, ``page_score``, ``ef_next_geq``, ``pair_count``,
``grammar_expand``, ``gap_decode``, ``bucket_intersect`` and
``bitmap_and``, each with its plain version), ``query`` (planner and step
machines), ``store`` (page stores and the resident pool), ``segment``
(streaming segments), ``serve`` (coalescing scheduler and
``QueryServer``; the LM tier's continuous-batching ``DecodeEngine``),
``distributed`` (the mesh of named device axes, the partition rules,
``shard_map``'s collectives in one process, GPipe), ``models`` (the five
LM architectures as ``nn.Module``s, GCN, the recsys models, and the
carrier of the reference's parameters), ``configs`` (the architecture
registry) and ``launch`` (the serving launcher, both tiers; the
quickstart flow; the assigned cell grid; mesh construction).

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; without a card the CUDA default raises.
"""
