"""Spans of the serving path and of the device build, kept in memory.

``span(name, qid=..., tick=..., op=...)`` is a context manager around one
step of the program.  Recording is off unless a caller turns it on with
``enable()``: ``span`` then returns one shared no-op object, reading no
clock and allocating nothing, for the cost of one flag test.  While it
is on, each span appends ``(name, start_ns, end_ns, parent, ids)`` to a
list in memory: ``time.perf_counter_ns()`` at both ends, ``parent`` the
index of the innermost span open when it started (-1 at the top), and
``ids`` the identifiers given (``qid`` on a query's spans, ``tick`` on
the scheduler's tick, ``op`` on a host step).  ``drain()`` returns the
records and clears the list.

Nothing bounds the list but whoever turns recording on: that caller
drains it.  Spans open and close on one thread, the serving loop's.

The spans, and where they are opened:

* ``query.submit`` — ``QueryScheduler.submit`` / ``submit_topk``: parse,
  plan, lowering and the result-cache lookup;
* ``scheduler.tick`` — one ``QueryScheduler.tick``;
* ``scheduler.advance`` — one step machine run to its next suspension;
* ``query.host_step`` — ``SetOp.run`` / ``PhraseShift.run``;
* ``engine.expand`` — one batched device expansion of whole lists
  (``DeviceEngine._decode_lists``), its copy to the host included;
* ``engine.dispatch_round`` — one merged probe round: dedup, memo, codec
  routing and the device call;
* ``device.sync`` — ``to_host``;
* ``build.grammar`` — ``TorchBuilder.build_grammar`` (and the
  ``CudaBuilder`` that inherits it).

``to_host(t)`` copies the serving path's results to the host: the
engines' probes, expansions, intersections, page decodes and scores,
and the kernels' paged probe.  On a card ``.cpu()`` waits for the work
queued before it, so its ``device.sync`` span holds that wait.  Copies
of index fields made when tables are built, and callers' inputs turned
into arrays, do not go through it.
"""

from __future__ import annotations

import time

__all__ = ["span", "enable", "disable", "drain", "to_host"]

_on = False
#: ``[name, start_ns, end_ns, parent, ids]`` per span, in start order
_records: list[list] = []
#: indices into ``_records`` of the spans open now, innermost last
_open: list[int] = []


class _Off:
    """The span ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec",)

    def __init__(self, name: str, ids: dict):
        self.rec = [name, 0, None, -1, ids]

    def __enter__(self):
        rec = self.rec
        rec[1] = time.perf_counter_ns()
        rec[3] = _open[-1] if _open else -1
        _open.append(len(_records))
        _records.append(rec)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rec[2] = time.perf_counter_ns()
        _open.pop()
        return False


def span(name: str, *, qid: int | None = None, tick: int | None = None,
         op: str | None = None):
    """A context manager that records ``name`` while recording is on.
    The identifiers are keyword parameters, not ``**ids``, so that the
    call builds no dictionary when recording is off."""
    if not _on:
        return _OFF
    ids = {}
    if qid is not None:
        ids["qid"] = qid
    if tick is not None:
        ids["tick"] = tick
    if op is not None:
        ids["op"] = op
    return _Span(name, ids)


def enable() -> None:
    """Record every span from now on."""
    global _on
    _on = True


def disable() -> None:
    """Record no span from now on; what was recorded stays for
    ``drain``."""
    global _on
    _on = False


def drain() -> list[tuple]:
    """The records since the last drain, in start order, as
    ``(name, start_ns, end_ns, parent, ids)``; the list is cleared.  A
    parent index points into the same drained list.  Raises while a span
    is open, since its children's parent would then point outside it."""
    if _open:
        raise RuntimeError(f"drain inside an open span "
                           f"({_records[_open[-1]][0]})")
    out = [tuple(r) for r in _records]
    _records.clear()
    return out


def to_host(t):
    """``t.cpu().numpy()`` inside a ``device.sync`` span."""
    with span("device.sync"):
        return t.cpu().numpy()
