"""The arithmetic that reads the program's spans beside the device trace
(``spans.py``), on hand-made spans and timelines, and a run of the span
reader on the CPU.

* ``totals``: seconds and self seconds by name, cut to a window;
* ``to_device_clock``: the tracer's marker offset;
* span transitions through ``tracing.idle_by_label``: idle time goes to
  the innermost open span, and to ``OUTSIDE`` where none is open;
* ``starts_in``: device activities counted per span name and in any span;
* ``starts_by_innermost``: device activities by the innermost open span;
* ``by_query`` / ``query_spread``: the ``qid``, ``tick`` and ``op`` ids
  read back into whole queries' ticks, host and expansion time, and host
  steps by operation;
* ``_join`` on a tracer stub whose markers tie the two clocks;
* ``run`` on a small corpus on the CPU: every answer correct, the
  per-query readings present, the recorder left off and empty.
"""

import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench.bench import Benchmark
from perfbench.spans import (OUTSIDE, _join, by_query, per_query,
                             query_spread, run, starts_by_innermost,
                             starts_in, to_device_clock, totals,
                             transitions)
from perfbench.tracing import MARKER, idle_by_label, merge

ROOT = Path(__file__).resolve().parents[1]


def _rec(name, s, e, parent=-1, **ids):
    return (name, s, e, parent, ids)


#: a tick [0, 100] holding an advance [10, 60] (with a host step
#: [20, 30] and an expansion [35, 55], its sync [50, 55]) and a dispatch
#: [70, 90]; a submit [110, 120] outside
SPANS = [
    _rec("scheduler.tick", 0, 100, tick=1),
    _rec("scheduler.advance", 10, 60, 0, qid=4),
    _rec("query.host_step", 20, 30, 1, op="union"),
    _rec("engine.expand", 35, 55, 1),
    _rec("device.sync", 50, 55, 3),
    _rec("engine.dispatch_round", 70, 90, 0),
    _rec("query.submit", 110, 120, qid=5),
]


def test_totals_and_self_time():
    t = totals(SPANS, 0, 1000)
    assert t["scheduler.tick"] == {"n": 1, "s": 100e-9,
                                   "self_s": pytest.approx(30e-9)}
    assert t["scheduler.advance"]["self_s"] == pytest.approx(20e-9)
    assert t["engine.expand"]["self_s"] == pytest.approx(15e-9)
    assert t["device.sync"]["s"] == pytest.approx(5e-9)
    assert t["query.submit"]["n"] == 1
    # cut to [40, 80]: the tick keeps 40, the advance 20 (its expansion
    # 15 of it), the dispatch 10; the host step and the submit fall out
    c = totals(SPANS, 40, 80)
    assert "query.host_step" not in c and "query.submit" not in c
    assert c["scheduler.tick"]["s"] == pytest.approx(40e-9)
    assert c["scheduler.tick"]["self_s"] == pytest.approx(10e-9)
    assert c["scheduler.advance"]["self_s"] == pytest.approx(5e-9)
    assert c["engine.dispatch_round"]["s"] == pytest.approx(10e-9)


def test_spans_move_onto_the_device_clock():
    # the first marker launched at host 100 s started at device 5,000 us
    dev = to_device_clock([_rec("x", 100_001_000_000, 100_002_500_000)],
                          100.0, 5000.0)
    assert dev == [("x", pytest.approx(6000.0), pytest.approx(7500.0), -1)]


def _dev(spans):
    return [(n, float(s), float(e), p) for n, s, e, p, _ in spans]


def test_idle_time_goes_to_the_innermost_open_span():
    busy = merge([(0, 25), (40, 52), (95, 105)])
    tr = transitions(_dev(SPANS), 0.0, 130.0)
    idle = idle_by_label(busy, tr, 0.0, 130.0)
    # [25, 30) step, [30, 35) advance, [35, 40) and [52, 55) expansion
    # (its sync [52, 55)), [55, 60) advance, [60, 70) tick, [70, 90)
    # dispatch, [90, 95) tick, [105, 110) and [120, 130) outside, [110,
    # 120) submit
    assert dict(idle) == pytest.approx({
        "query.host_step": 5, "scheduler.advance": 10,
        "engine.expand": 5, "device.sync": 3, "scheduler.tick": 15,
        "engine.dispatch_round": 20, "query.submit": 10, OUTSIDE: 15})
    assert sum(idle.values()) == pytest.approx(130 - 25 - 12 - 10)


def test_a_span_open_at_the_start_labels_it():
    tr = transitions(_dev(SPANS), 15.0, 65.0)
    assert tr[0][1] == "scheduler.advance" and tr[0][0] > 15.0
    assert tr[-1] == (60.0, "scheduler.tick")
    assert all(15.0 < t < 65.0 for t, _ in tr)
    idle = idle_by_label(merge([]), tr, 15.0, 65.0)
    assert sum(idle.values()) == pytest.approx(50.0)
    assert idle["engine.expand"] == pytest.approx(15.0)


def test_device_activities_counted_by_span():
    starts = [1, 12, 22, 36, 51, 52, 75, 95, 115, 125, 200]
    by, covered = starts_in(starts, _dev(SPANS))
    assert by == {"scheduler.tick": 8, "scheduler.advance": 5,
                  "query.host_step": 1, "engine.expand": 3,
                  "device.sync": 2, "engine.dispatch_round": 1,
                  "query.submit": 1}
    assert covered == 9
    # spans of one name nested in each other count an activity once
    nested = [("a", 0.0, 10.0, -1), ("a", 2.0, 4.0, 0)]
    assert starts_in([3, 5, 11], nested) == ({"a": 2}, 2)


def test_device_activities_by_innermost_span():
    starts = [0, 1, 12, 22, 36, 51, 52, 75, 95, 115, 125]
    got = starts_by_innermost(starts, transitions(_dev(SPANS), 0.0, 130.0))
    assert got == {"scheduler.tick": 3, "scheduler.advance": 1,
                   "query.host_step": 1, "engine.expand": 1,
                   "device.sync": 2, "engine.dispatch_round": 1,
                   "query.submit": 1, OUTSIDE: 1}


#: two ticks over three submitted queries; query 0 was submitted before
#: the records begin, query 3 is still in flight at their end
QUERIES = [
    _rec("query.submit", 0, 5, qid=1),
    _rec("query.submit", 6, 8, qid=2),
    _rec("scheduler.tick", 10, 50, tick=1),
    _rec("scheduler.advance", 11, 30, 2, qid=1),
    _rec("engine.expand", 12, 20, 3),
    _rec("device.sync", 18, 20, 4),
    _rec("query.host_step", 21, 25, 3, op="union"),
    _rec("scheduler.advance", 31, 40, 2, qid=2),
    _rec("engine.dispatch_round", 41, 49, 2),
    _rec("query.submit", 52, 53, qid=3),
    _rec("scheduler.tick", 60, 100, tick=2),
    _rec("scheduler.advance", 61, 70, 10, qid=1),
    _rec("query.host_step", 62, 66, 11, op="intersect"),
    _rec("scheduler.advance", 71, 80, 10, qid=3),
    _rec("query.host_step", 72, 73, 13, op="union"),
    _rec("scheduler.advance", 81, 90, 10, qid=0),
]


def test_ids_read_back_by_query():
    rows, ops = by_query(QUERIES, open_qids={3})
    assert set(rows) == {1, 2}
    assert rows[1] == {"ticks": 2, "host_s": pytest.approx(33e-9),
                       "expand_s": pytest.approx(8e-9)}
    assert rows[2] == {"ticks": 1, "host_s": pytest.approx(11e-9),
                       "expand_s": 0.0}
    # every host step counts by its operation, whole query or not
    assert ops == pytest.approx({"union": 5e-9, "intersect": 4e-9})
    assert set(by_query(QUERIES)[0]) == {1, 2, 3}
    got = query_spread(rows)
    assert got == pytest.approx({
        "queries": 2, "ticks_per_query": 1.5, "host_ms_p50": 22e-6,
        "host_ms_p95": 31.9e-6, "host_ms_max": 33e-6,
        "expanding_pct": 50.0, "expand_top10_pct": 100.0})
    assert query_spread({}) == {"queries": 0}


def test_join_on_a_traced_stub():
    # host 10 s is device 1,000 us; markers at the two ends
    h0, h1 = 10.0, 10.0002
    raw = [(MARKER + "_start", 1000.0, 1002.0),
           ("k_a", 1010.0, 1015.0), ("k_b", 1040.0, 1041.0),
           ("k_c", 1060.0, 1065.0), ("k_d", 1150.0, 1160.0),
           (MARKER + "_end", 1200.0, 1202.0)]
    ns = int(h0 * 1e9)
    spans = [_rec("scheduler.tick", ns + 5_000, ns + 100_000, tick=9),
             _rec("scheduler.advance", ns + 6_000, ns + 50_000, 0, qid=1),
             _rec("engine.expand", ns + 8_000, ns + 45_000, 1),
             _rec("device.sync", ns + 30_000, ns + 45_000, 2),
             _rec("engine.dispatch_round", ns + 55_000, ns + 80_000, 0),
             _rec("engine.expand", ns + 120_000, ns + 130_000)]
    tracer = SimpleNamespace(marks=[h0, h1], device_events=lambda: raw)
    got = _join(tracer, spans, queries=4, decodes=2)
    assert got["device_activities"] == 4
    assert got["in_a_span_pct"] == pytest.approx(75.0)
    assert got["expands"] == 2
    assert got["engine.device_ops_per_expand"] == pytest.approx(1.0)
    assert got["activities_by_span"]["engine.dispatch_round"] == 1
    assert got["activities_by_innermost"] == {
        "engine.expand": 1, "device.sync": 1, "engine.dispatch_round": 1,
        OUTSIDE: 1}
    assert got["in_launchless_pct"] == 0.0
    assert got["window_s"] == pytest.approx(200e-6)
    assert got["busy_s"] == pytest.approx(21e-6)
    # the tick's self time: 95 us less 44 (advance) and 25 (dispatch)
    assert got["tick_self_pct"] == pytest.approx(100 * 26 / 95)
    assert got["per_query"]["engine.expand_ms_per_query"] == pytest.approx(
        1e3 * 47e-6 / 4)
    assert got["per_query"]["engine.decodes_per_query"] == 0.5
    idle = dict(got["idle_by_span"])
    assert sum(idle.values()) == pytest.approx(200e-6 - 21e-6)
    assert idle["device.sync"] == pytest.approx(14e-6)


def test_per_query_names_the_metrics():
    got = per_query({"query.submit": 0.5, "engine.expand": 3.0,
                     "device.sync": 0.25}, decodes=10, queries=1000)
    assert got == pytest.approx({
        "query.submit_ms_per_query": 0.5, "query.host_step_ms_per_query": 0,
        "engine.expand_ms_per_query": 3.0,
        "engine.dispatch_ms_per_query": 0,
        "device.sync_ms_per_query": 0.25, "engine.decodes_per_query": 0.01})
    assert per_query({}, 0, 0) == {}


def test_span_run_on_the_cpu():
    from repro_torch import obs
    cell = Benchmark.load(ROOT).cell("repair.bool-c64")
    cell.config["corpus"].update(num_docs=300, vocab_size=400)
    cell.traffic.update(clients=8, ramp_ticks=2, warmup_queries=8)
    t0 = time.perf_counter()
    out = run(cell, 2**31 + 11, windows=1, seconds=0.5, trace_seconds=0,
              device="cpu")
    spread = out["by_query"]
    assert 0 < spread["queries"] <= out["windows"][1]["queries"]
    assert spread["ticks_per_query"] >= 1
    assert spread["host_ms_p50"] <= spread["host_ms_p95"] \
        <= spread["host_ms_max"]
    assert set(out["host_step_ms_by_op"]) <= {
        "union", "intersect", "filter", "complement", "shift", "project"}
    assert out["host_step_ms_by_op"]
    assert out["correct"], out["checks"]
    assert out["attempted"] > 8
    assert out["setup.build_s"] > 0
    assert out["setup_s"] <= time.perf_counter() - t0
    assert [w["recording"] for w in out["windows"]] == [False, True]
    off, on = out["windows"]
    assert "spans" not in off and on["spans_per_tick"] > 1
    assert on["spans"]["scheduler.tick"]["n"] >= 1
    pq = out["per_query"]
    assert set(pq) == {"query.submit_ms_per_query",
                       "query.host_step_ms_per_query",
                       "engine.expand_ms_per_query",
                       "engine.dispatch_ms_per_query",
                       "device.sync_ms_per_query",
                       "engine.decodes_per_query"}
    assert pq["engine.dispatch_ms_per_query"] > 0
    assert 0 <= out["tick_self_pct"] <= 100
    assert out["traced"] is None
    assert obs.drain() == [] and obs.span("x") is obs.span("y")
