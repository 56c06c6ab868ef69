"""The traced run's arithmetic, the window's readings and the collector's
clock.

* ``merge``, ``busy_before`` and ``idle_by_label`` on hand-made
  timelines;
* the host sampler names the function the main thread is in;
* the window and the traced span after it hold the queries each
  completed, and every metric reader reads its part of a hand-made run;
* ``GcClock`` times the collector's passes and lines them up with slow
  ticks.
"""

import gc
import time
from pathlib import Path

import numpy as np
import pytest

from perfbench.bench import Benchmark
from perfbench.harness import ClosedLoop, Done, GcClock, RunRecord
from perfbench.tracing import HostSampler, busy_before, idle_by_label, merge
from perfbench.traffic import Query

ROOT = Path(__file__).resolve().parents[1]


def test_merge_and_busy_time():
    m = merge([(5, 7), (0, 2), (1, 3), (6, 9), (12, 13)])
    np.testing.assert_array_equal(m, [[0, 3], [5, 9], [12, 13]])
    got = busy_before(m, [0, 1, 3, 4, 6, 9, 11, 12.5, 20])
    np.testing.assert_allclose(got, [0, 1, 3, 3, 4, 7, 7, 7.5, 8])
    assert busy_before(merge([]), [1.0, 2.0]).tolist() == [0.0, 0.0]


def test_idle_time_goes_to_the_host_sample_before_it():
    m = merge([(0, 10), (30, 40)])
    samples = [(5, "a"), (15, "b"), (35, "c"), (45, "d")]
    idle = idle_by_label(m, samples, 0, 50)
    # [10, 15) idle under a, [15, 30) under b, [40, 45) c, [45, 50) d
    assert dict(idle) == {"a": 5, "b": 15, "c": 5, "d": 5}
    assert sum(idle.values()) == 50 - 20


def _spin_here(seconds):
    end = time.perf_counter() + seconds
    x = 0
    while time.perf_counter() < end:
        x += 1
    return x


def test_host_sampler_names_the_running_function():
    s = HostSampler([Path(__file__).parent], interval=0.001)
    s.start()
    _spin_here(0.5)
    s.stop()
    labels = [lab for _, lab in s.samples]
    assert len(labels) > 10
    share = labels.count("test_perfbench_tracing.py:_spin_here") / len(labels)
    assert share > 0.5


class _Echo:
    """A driver whose every tick completes what is in flight."""

    def __init__(self):
        self.n, self.flight, self.ready = 0, [], []

    def submit(self, q):
        self.n += 1
        self.flight.append(self.n)
        return self.n

    def tick(self):
        time.sleep(0.002)
        self.ready, self.flight = self.ready + self.flight, []

    def completed(self):
        out, self.ready = self.ready, []
        return out

    def take(self, qid):
        return np.asarray([qid])


def test_window_and_traced_span_hold_their_own_queries():
    q = Query("bool", ("term", 1), "1")
    loop = ClosedLoop(_Echo(), iter([q] * 100000), clients=4, ramp=2)
    loop.run_count(8)
    window = loop.run_for(0.1)
    t_end = loop.deadline
    traced = loop.run_for(0.1)
    assert window and traced
    assert not {id(d) for d in window} & {id(d) for d in traced}
    assert all(d.t_done <= t_end for d in window)
    assert all(t_end < d.t_done <= loop.deadline for d in traced)
    assert len(loop.tick_t0) == len(loop.tick_s) == loop.ticks


def _record():
    q = Query("bool", ("term", 1), "1")
    window = [Done(q, None, 0.0, s, t) for s, t in
              ((0.010, 1), (0.020, 1), (0.030, 2), (0.040, 2))]
    traced = [Done(q, None, 0.0, 1.0, 9)] * 2
    zero = {"real_lanes": 0, "unique_lanes": 0, "pad_lanes": 0,
            "dispatched_lanes": 0, "pages_scored": 0, "pages_skipped": 0,
            "result_cache_hits": 0, "result_cache_misses": 0,
            "launches": {"k1": 5}}
    after = dict(zero, real_lanes=300, unique_lanes=200, pad_lanes=25,
                 dispatched_lanes=225, pages_scored=90, pages_skipped=10,
                 result_cache_hits=1, result_cache_misses=3,
                 launches={"k1": 7, "k2": 2})
    trace = {"window_s": 20.0, "busy_s": 5.0, "kernel_s": 0.004}
    return RunRecord("c", 2.0, 17.5, 1000, 1000, window, [0.1, 0.3], zero,
                     after, 3 * 2**20, trace, traced)


# what each reader gives on ``_record``: the window's queries, ticks and
# counters, and the traced span's device time over its own queries
WANT = {
    "qps": 2.0, "entry.p95_ms": 38.5, "device_bits_per_posting": 8.0,
    "setup_s": 17.5, "scheduler.tick_ms": 200.0,
    "scheduler.result_cache_hit_pct": 25.0, "query.ticks_per_query": 1.5,
    "query.pages_skipped_pct": 10.0, "engine.dedup_factor": 1.5,
    "engine.pad_lane_pct": 100 * 25 / 225,
    "kernels.device_ms_per_query": 2.0, "kernels.launches_per_query": 1.0,
    "device.idle_pct": 75.0, "device.window_peak_mib": 3.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_its_part_of_the_run(name):
    read = Benchmark.load(ROOT).reader(name)
    assert read(_record()) == pytest.approx(WANT[name])


def test_gc_clock_lines_passes_up_with_slow_ticks():
    clock = GcClock()
    clock.start()
    t0 = time.perf_counter()
    gc.collect()
    slow = time.perf_counter() - t0 + 0.05
    gc.collect(0)
    clock.stop()
    assert clock._note not in gc.callbacks
    gens = [p[0] for p in clock.passes]
    assert 2 in gens and 0 in gens
    assert all(s >= 0 for _, _, s in clock.passes)
    # the first tick holds the full pass and is slow; the others are not
    rep = clock.report([t0, t0 + 10, t0 + 11], [slow, 1e-3, 1e-3])
    assert "gen2 1 passes" in rep
    assert "1 of 3 ticks over twice the median" in rep
    assert "1 hold a pass, 1 a gen2 pass" in rep
