"""The check catches what it is there to catch.

A run of each kind of cell is driven on the CPU at a small size (the
look for a card skipped: the engine runs its plain versions), sound and
then with the timed path broken underneath, and ``correct`` has to come
out true for the sound run and false for each fault a serving cell can
have:

* an answer altered where it is produced (the scheduler's completion);
* half of every merged probe round left out (answered "no next doc");
* a tick that returns the state unchanged (nothing ever completes).

The controls (``reference.BloomReference`` for boolean answers,
``Bf16Reference`` for ranked scores) stand in the program's place on the
same queries and have to fail the comparison too.  (A serving cell on
one card has no exchange between cards to leave out.)
"""

import time
from pathlib import Path

import numpy as np
import pytest

from perfbench.bench import Benchmark
from perfbench.harness import run_cell

ROOT = Path(__file__).resolve().parents[1]

CELLS = ("repair.bool-c64", "repair.topk10-c64")
#: the ranked cell: proven on the card, and left out of BENCHMARK.json
#: for the spread of its runs; its traffic and reference stay
RANKED = {"name": "repair.topk10-c64", "config": "zipf42k-repair",
          "traffic": "topk10-c64", "chips": 1}


def _cell(name):
    bench = Benchmark.load(ROOT)
    bench.workloads.setdefault(RANKED["name"], RANKED)
    cell = bench.cell(name)
    cell.config["corpus"].update(num_docs=400, vocab_size=500)
    cell.traffic.update(warmup_queries=16, prefill=64)
    return cell


def _run(name, seed, fault=None, control=False):
    # a frozen tick never drains: its run waits a second, a sound one
    # as long as a loaded test machine needs
    return run_cell(_cell(name), seed, 0.75, False, t0=time.perf_counter(),
                    device="cpu", fault=fault, control=control,
                    drain_s=1.0 if fault is freeze_ticks else 300.0)


def alter_answer(srv):
    sched = srv.scheduler
    finish = sched._finish

    def altered(qid, out, t0):
        if hasattr(out, "scores"):
            out = out.copy()
            if out.scores.size:
                out.scores[0] = np.nextafter(out.scores[0], np.float32(1e9))
            else:
                out.docs, out.scores = (np.zeros(1, np.int64),
                                        np.zeros(1, np.float32))
        else:
            out = out[:-1] if out.size else np.zeros(1, np.int64)
        finish(qid, out, t0)

    sched._finish = altered


def drop_half_of_each_round(srv):
    from repro_torch.core.index import INT_INF
    eng = srv.engine
    dispatch = eng.dispatch_round

    def half(lids, xs, algo):
        vals = np.array(dispatch(lids, xs, algo), copy=True)
        vals[vals.size // 2:] = INT_INF
        return vals

    eng.dispatch_round = half


def freeze_ticks(srv):
    sched = srv.scheduler
    sched.tick = lambda: len(sched._running) + len(sched._queue)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_the_control_is_not(name):
    out = _run(name, 2**31 + 3, control=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    # an untraced run reports the end-to-end metrics alone (on the CPU
    # the index holds no device bytes, and its bits per posting are left out)
    assert set(out["metrics"]) == {"qps", "setup_s"}
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(v > limits[k] for k, v in out["control"].items()), out


@pytest.mark.parametrize("fault", (alter_answer, drop_half_of_each_round,
                                   freeze_ticks), ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(name, fault):
    out = _run(name, 11, fault=fault)
    assert not out["correct"], out["checks"]
