"""The program's spans read beside the device's trace, and a run of one
cell that reads them.

While recording is on, the program keeps its spans in memory
(``repro_torch.obs``): ``(name, start_ns, end_ns, parent, ids)`` on the
host's ``time.perf_counter_ns`` clock, the clock of the harness and of
the tracer's markers.  The arithmetic here reads them:

* ``totals`` — each name's count, seconds and self seconds (its time
  less its children's) inside a window;
* ``to_device_clock`` — the spans moved onto the device's timeline with
  the offset the tracer applies to its host samples,
  ``d0 + (t - h0) * 1e6`` microseconds;
* ``transitions`` — the innermost open span as a timeline of
  ``(time, name)``, which ``tracing.idle_by_label`` turns into the
  device's idle time by span;
* ``starts_in`` — the device activities that start inside each name's
  spans, and inside any span;
* ``starts_by_innermost`` — the device activities by the innermost span
  open when they start;
* ``by_query`` — the ids on the spans read back: each whole query's
  ticks (the ``tick`` id above its advances), host time and expansion
  time (by ``qid``), and host set algebra by ``op``; ``query_spread``
  sums the queries up.

``python3 -m perfbench.spans --workload <cell> --seed <n>``, from the root
of a checkout, runs one cell on the card: its set-up with recording on,
then ``--windows`` pairs of ``SECONDS``-second windows, recording off
and then on, then ``TRACE_SECONDS`` under the tracer with recording on.
The last line of standard output is one JSON object: the per-query
readings of the spans over the windows with recording on, the engine's
decodes per query, the spread of the whole queries (``by_query``), the
tick with recording off and on, and from the traced span the device
activities per expansion, the share of activities that start inside a
program span and by innermost span, the tick's self share and the idle
seconds by innermost span.  Every answer is held to the
reference, as in a benchmark run.  The benchmark's own runs
(``harness.py``) record no span.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

from .bench import Benchmark
from .harness import ClosedLoop, _Answers, apply_env, compare, corpus_lists
from .reference import Reference
from .tracing import MARKER, Tracer, idle_by_label, merge
from .traffic import QueryStream

HERE = Path(__file__).resolve().parent
#: the label of time in which no program span is open
OUTSIDE = "(no program span)"
#: spans in which the program launches no device work: an activity that
#: starts in one was launched before it opened
LAUNCHLESS = ("query.host_step", "query.submit")
#: the length of each window, and of the traced span, in seconds
SECONDS, TRACE_SECONDS = 10.0, 20.0


def totals(spans, lo_ns: int, hi_ns: int) -> dict[str, dict]:
    """``{name: {"n", "s", "self_s"}}`` over ``[lo_ns, hi_ns]``: every span
    cut to the window, its self time its cut length less its children's;
    a span counts in ``n`` where any of it lies inside."""
    cut = [max(0, min(e, hi_ns) - max(s, lo_ns)) for _, s, e, _, _ in spans]
    child = [0] * len(spans)
    for i, (_, _, _, parent, _) in enumerate(spans):
        if parent >= 0:
            child[parent] += cut[i]
    out: dict[str, dict] = {}
    for i, (name, s, e, _, _) in enumerate(spans):
        if e < lo_ns or s > hi_ns:
            continue
        d = out.setdefault(name, {"n": 0, "s": 0.0, "self_s": 0.0})
        d["n"] += 1
        d["s"] += cut[i] / 1e9
        d["self_s"] += (cut[i] - child[i]) / 1e9
    return out


def to_device_clock(spans, h0: float, d0: float) -> list[tuple]:
    """``(name, start_us, end_us, parent)`` on the device's timeline: the
    first marker kernel was launched at host time ``h0`` (seconds) and
    started at device time ``d0`` (microseconds)."""
    return [(n, d0 + s / 1e3 - h0 * 1e6, d0 + e / 1e3 - h0 * 1e6, p)
            for n, s, e, p, _ in spans]


def transitions(dev_spans, lo: float, hi: float) -> list[tuple]:
    """``(time, label)``: from each time on, until the next, the innermost
    open span is ``label`` (``OUTSIDE`` where none is), the first at
    ``lo``'s next float, the rest strictly inside ``(lo, hi)``."""
    ev = []
    for i, (name, s, e, parent) in enumerate(dev_spans):
        ev.append((s, 1, i, name))
        ev.append((e, 0, -i, dev_spans[parent][0] if parent >= 0
                   else OUTSIDE))
    # at one time, ends before starts; inner ends and outer starts first
    ev.sort(key=lambda x: x[:3])
    first, out = OUTSIDE, []
    for t, _, _, label in ev:
        if t <= lo:
            first = label
        elif t < hi:
            out.append((t, label))
    return [(float(np.nextafter(lo, hi)), first)] + out


def starts_in(starts, dev_spans) -> tuple[Counter, int]:
    """How many of ``starts`` lie inside the spans of each name (nested
    spans of one name counted once) and inside any span."""
    starts = np.sort(np.asarray(starts, np.float64))

    def count(intervals) -> int:
        m = merge(intervals)
        if not m.size:
            return 0
        return int((np.searchsorted(starts, m[:, 1], side="right")
                    - np.searchsorted(starts, m[:, 0], side="left")).sum())

    by: dict[str, list] = {}
    for name, s, e, _ in dev_spans:
        by.setdefault(name, []).append((s, e))
    return (Counter({n: count(iv) for n, iv in by.items()}),
            count([(s, e) for _, s, e, _ in dev_spans]))


def starts_by_innermost(starts, trans) -> Counter:
    """How many of ``starts`` lie in each innermost span, on the
    timeline ``transitions`` gives; a start before its first time takes
    its first label."""
    times = np.asarray([t for t, _ in trans], np.float64)
    at = np.searchsorted(times, np.asarray(starts, np.float64),
                         side="right") - 1
    return Counter(trans[max(0, int(i))][1] for i in at)


def by_query(spans, open_qids=()) -> tuple[dict, Counter]:
    """The ids on ``spans`` read back.  ``{qid: {"ticks", "host_s",
    "expand_s"}}`` for each whole query: submitted among ``spans`` and
    not in ``open_qids``, those still in flight when they were drained.
    ``ticks`` counts the distinct ``tick`` ids above its advances,
    ``host_s`` is its submit and advances, ``expand_s`` the expansions
    inside them.  A span without a ``qid`` or ``tick`` takes its
    parent's.  Beside it, ``{op: seconds}`` of every host step."""
    qid_of: list = []
    tick_of: list = []
    for _, _, _, parent, ids in spans:
        qid_of.append(ids.get("qid", qid_of[parent] if parent >= 0
                              else None))
        tick_of.append(ids.get("tick", tick_of[parent] if parent >= 0
                               else None))
    shut = set(open_qids)
    rows = {ids["qid"]: {"ticks": set(), "host_s": 0.0, "expand_s": 0.0}
            for name, _, _, _, ids in spans
            if name == "query.submit" and ids["qid"] not in shut}
    ops: Counter = Counter()
    for i, (name, s, e, _, ids) in enumerate(spans):
        if name == "query.host_step":
            ops[ids.get("op")] += (e - s) / 1e9
        row = rows.get(qid_of[i])
        if row is None:
            continue
        if name in ("query.submit", "scheduler.advance"):
            row["host_s"] += (e - s) / 1e9
        if name == "scheduler.advance":
            row["ticks"].add(tick_of[i])
        elif name == "engine.expand":
            row["expand_s"] += (e - s) / 1e9
    for row in rows.values():
        row["ticks"] = len(row["ticks"])
    return rows, ops


def query_spread(rows) -> dict:
    """``by_query``'s queries summed up: their number, ticks a query,
    the median, 95th percentile and largest host time of one, the share
    that expands a list, and the share of all expansion time that the
    tenth of them with the most carries."""
    if not rows:
        return {"queries": 0}
    host = np.asarray([r["host_s"] for r in rows.values()]) * 1e3
    exp = np.sort([r["expand_s"] for r in rows.values()])[::-1]
    top = max(1, len(exp) // 10)
    return {
        "queries": len(rows),
        "ticks_per_query": float(np.mean([r["ticks"]
                                          for r in rows.values()])),
        "host_ms_p50": float(np.percentile(host, 50)),
        "host_ms_p95": float(np.percentile(host, 95)),
        "host_ms_max": float(host.max()),
        "expanding_pct": 100.0 * float((exp > 0).mean()),
        "expand_top10_pct": (100.0 * float(exp[:top].sum() / exp.sum())
                             if exp.sum() else None),
    }


def per_query(spans_s: dict[str, float], decodes: int, queries: int
              ) -> dict[str, float]:
    """The readings per query of seconds by span name and of the engine's
    decodes, under the names of the per-layer metrics they give."""
    if not queries:
        return {}
    ms = {"query.submit_ms_per_query": "query.submit",
          "query.host_step_ms_per_query": "query.host_step",
          "engine.expand_ms_per_query": "engine.expand",
          "engine.dispatch_ms_per_query": "engine.dispatch_round",
          "device.sync_ms_per_query": "device.sync"}
    out = {k: 1e3 * spans_s.get(v, 0.0) / queries for k, v in ms.items()}
    out["engine.decodes_per_query"] = decodes / queries
    return out


def _decodes(srv) -> dict[str, int]:
    st = srv.serve_stats()
    return {"engine_misses": st["engine_decode_cache"]["misses"],
            "engine_hits": st["engine_decode_cache"]["hits"],
            "scheduler_misses": st["decode_cache"]["misses"],
            "scheduler_hits": st["decode_cache"]["hits"]}


def _join(tracer, spans, queries: int, decodes: int) -> dict:
    """The traced span's device activities beside its program spans."""
    raw = tracer.device_events()
    marks = sorted(s for n, s, _ in raw if MARKER in n)
    if len(marks) < 2:
        raise RuntimeError("no marker kernels in the trace: the host's and "
                           "the device's timelines cannot be tied")
    d0, d1 = marks[0], marks[-1]
    h0, h1 = tracer.marks
    evs = [(max(s, d0), min(e, d1)) for n, s, e in raw
           if e > d0 and s < d1 and MARKER not in n]
    starts = [s for n, s, _ in raw if d0 <= s <= d1 and MARKER not in n]
    merged = merge(evs)
    dev = to_device_clock(spans, h0, d0)
    by, covered = starts_in(starts, dev)
    n_expand = sum(1 for s in dev if s[0] == "engine.expand")
    trans = transitions(dev, d0, d1)
    idle = idle_by_label(merged, trans, d0, d1)
    inner = starts_by_innermost(starts, trans)
    tot = totals(spans, int(h0 * 1e9), int(h1 * 1e9))
    tick = tot.get("scheduler.tick", {"s": 0.0, "self_s": 0.0})
    return {
        "queries": queries,
        "window_s": (d1 - d0) / 1e6,
        "busy_s": float((merged[:, 1] - merged[:, 0]).sum()) / 1e6
        if merged.size else 0.0,
        "device_activities": len(starts),
        "in_a_span_pct": 100.0 * covered / len(starts) if starts else None,
        "activities_by_span": dict(by.most_common()),
        "activities_by_innermost": dict(inner.most_common()),
        "in_launchless_pct": (100.0 * sum(inner[n] for n in LAUNCHLESS)
                              / len(starts) if starts else None),
        "expands": n_expand,
        "engine.device_ops_per_expand": (by["engine.expand"] / n_expand
                                         if n_expand else None),
        "tick_self_pct": (100.0 * tick["self_s"] / tick["s"]
                          if tick["s"] else None),
        "per_query": per_query({n: d["s"] for n, d in tot.items()},
                               decodes, queries),
        "idle_by_span": [[lab, float(us) / 1e6] for lab, us in
                         idle.most_common(10)],
    }


def run(cell, seed: int, *, windows: int, seconds: float = SECONDS,
        trace_seconds: float = TRACE_SECONDS, device="cuda",
        drain_s: float = 60.0,
        log=sys.stderr) -> dict:
    """One run of ``cell`` with the program's spans recorded as the
    module's docstring says; returns the result object."""
    import torch
    from repro_torch import obs

    from . import sut
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    obs.enable()
    t0 = time.perf_counter()
    lists = corpus_lists(cfg["corpus"])
    lengths = [int(l.size) for l in lists]
    res = sut.build_grammar(cfg, lists, dev)
    srv = sut.make_server(cfg, res, dev)
    loop = ClosedLoop(sut.Driver(srv),
                      QueryStream(tr, len(lists), lengths,
                                  [tr["warmup_seed"], 0x7761726D]),
                      int(tr["clients"]), int(tr["ramp_ticks"]))
    loop.run_count(int(tr["warmup_queries"]))
    setup = totals(obs.drain(), 0, time.perf_counter_ns())
    setup_s = time.perf_counter() - t0
    loop.stream = QueryStream(tr, len(lists), lengths, seed)

    rows, spans_s, on_queries, on_decodes = [], Counter(), 0, 0
    tick_self, whole, ops = 0.0, {}, Counter()
    for k in range(2 * windows):
        on = k % 2 == 1
        (obs.enable if on else obs.disable)()
        before, first = _decodes(srv), len(loop.tick_s)
        done = loop.run_for(seconds)
        spans = obs.drain()
        after, ticks = _decodes(srv), loop.tick_s[first:]
        row = {"recording": on, "queries": len(done),
               "qps": len(done) / seconds,
               "tick_ms": 1e3 * sum(ticks) / len(ticks) if ticks else None,
               "decodes": {c: after[c] - before[c] for c in after}}
        if on:
            tot = totals(spans, int(loop.t_start * 1e9),
                         int(loop.deadline * 1e9))
            row["spans"] = tot
            row["spans_per_tick"] = (sum(d["n"] for d in tot.values())
                                     / len(ticks) if ticks else None)
            spans_s.update({n: d["s"] for n, d in tot.items()})
            tick_self += tot.get("scheduler.tick", {"self_s": 0.0})["self_s"]
            on_queries += len(done)
            on_decodes += row["decodes"]["engine_misses"]
            got, by_op = by_query(spans, loop.inflight)
            whole.update(got)
            ops.update(by_op)
        rows.append(row)
        print(f"[window {k}] recording {'on' if on else 'off'}: "
              f"{row['queries']} queries, tick {row['tick_ms']} ms",
              file=log)

    traced = None
    if trace_seconds > 0:
        tracer = Tracer(dev, [Path(sut.CSRC).parent, HERE])
        before = _decodes(srv)["engine_misses"]
        obs.enable()
        tracer.start()
        done = loop.run_for(trace_seconds)
        tracer.stop()
        obs.disable()
        traced = _join(tracer, obs.drain(), len(done),
                       _decodes(srv)["engine_misses"] - before)
        del tracer
        print(f"[spans] idle by innermost span: {traced['idle_by_span']}",
              file=log)
    obs.disable()
    loop.drain(drain_s)
    obs.drain()
    answers = [(d.query, d.answer) for d in loop.done] + \
        [(q, None) for q, _, _ in loop.inflight.values()]

    loop.drv = None
    del srv, res, loop
    want = _Answers(Reference(lists, cfg["scoring"]["k1"],
                              cfg["scoring"]["b"]))
    checks = compare(answers, want, tr["kind"] == "topk")
    tick_on = [r["tick_ms"] for r in rows if r["recording"]]
    tick_off = [r["tick_ms"] for r in rows if not r["recording"]]
    tick_total = spans_s.get("scheduler.tick", 0.0)
    return {
        "correct": all(v <= cfg["limits"][k] for k, v in checks.items()),
        "checks": checks,
        "attempted": len(answers),
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "setup_s": setup_s,
        "setup.build_s": setup.get("build.grammar", {"s": None})["s"],
        "setup_spans_s": {n: d["s"] for n, d in setup.items()},
        "windows": rows,
        "tick_ms_off": tick_off,
        "tick_ms_on": tick_on,
        "per_query": per_query(spans_s, on_decodes, on_queries),
        "by_query": query_spread(whole),
        "host_step_ms_by_op": ({op: 1e3 * v / on_queries
                                for op, v in ops.most_common()}
                               if on_queries else {}),
        "tick_self_pct": (100.0 * tick_self / tick_total
                          if tick_total else None),
        "traced": traced,
    }


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell with the "
                                 "program's spans recorded; print what "
                                 "they read.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args(argv)
    root = HERE.parent
    cell = Benchmark.load(root).cell(args.workload)
    apply_env(cell.config, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    out = run(cell, args.seed, windows=args.windows)
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.path.insert(0, str(HERE.parent / "src"))
    sys.exit(main(sys.argv[1:]))
