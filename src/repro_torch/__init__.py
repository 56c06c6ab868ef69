"""PyTorch/CUDA port of the Re-Pair compressed inverted-list server.

A package of its own beside the JAX reference package ``repro``: it
imports torch and numpy and nothing of JAX or ``repro``.  The layout
follows ``repro`` module for module where a counterpart exists:
``core`` (host Re-Pair construction, torch device indexes), ``engine``
(host / torch / cuda backends), ``kernels`` (hand-written CUDA kernels
``list_intersect`` and ``page_score`` with their plain versions),
``query`` (planner and step machines), ``serve`` (coalescing scheduler
and ``QueryServer``) and ``launch`` (the serving launcher).

Entry points run on the card (``device="cuda"``) unless the caller asks
for ``device="cpu"``; without a card the CUDA default raises.
"""
