"""One run of one cell: set-up, the measured window, the check.

Set-up, in order: the environment the configuration states (every
``REPRO_*`` setting of the program, nothing inherited), the corpus, the
grammar built by the configuration's builder on the card, the server,
the run's query stream drawn from ``--seed``, and a warm-up of the
cell's own mix from a stream no seed draws (it loads the kernels, builds
the lazy score tier, fills the caches).  ``setup_s`` runs from the
process's start to the window's start.

The loop is closed: ``clients`` clients each send their next query as
soon as their last one completes.  They join in groups over the first
ticks, and the loop runs on from the warm-up into the window without a
pause, so the window sees the loop in its steady state.  The harness
submits, calls the scheduler's ``tick``, and collects what completed; a
query's latency runs on the harness's clock from its submit to the
moment the harness sees it done.  A traced run reads the window as an
untraced run does (the counters, the ticks and the queries give the
per-layer metrics), then runs on for ``TRACE_SECONDS`` under the tracer
and reads the device's metrics there.  After that no query is sent;
those in flight are waited for (up to ``drain_s``) and checked too, but
count in neither the rate nor the tail.  The interpreter's collector is
timed in the window (``GcClock``) and its passes are lined up with the
slow ticks on standard error.

The check holds every answer, the warm-up's too, to the plain reference
(``reference.py``), worked out from the generated postings once the
program's state is freed.  Each number compared is printed beside its
limit, which the configuration states.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from .bench import Benchmark, Cell
from .corpus import postings, zipf_corpus
from .reference import Bf16Reference, BloomReference, Reference
from .traffic import Query, QueryStream

HERE = Path(__file__).resolve().parent
#: seconds a traced run traces after its window: a second of serving
#: makes some 35,000 device activities to read back
TRACE_SECONDS = 20.0
#: top-level module names that may not be loaded when the result prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Done:
    query: Query
    answer: object
    t_submit: float
    t_done: float
    ticks: int                  # scheduler ticks from submit to completion

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class GcClock:
    """The collector's passes while it is started: each one's generation,
    start and seconds (``gc.callbacks``)."""

    def __init__(self):
        self.passes: list[tuple[int, float, float]] = []
        self._t = 0.0

    def _note(self, phase: str, info: dict) -> None:
        now = time.perf_counter()
        if phase == "start":
            self._t = now
        else:
            self.passes.append((info["generation"], self._t, now - self._t))

    def start(self) -> None:
        gc.callbacks.append(self._note)

    def stop(self) -> None:
        gc.callbacks.remove(self._note)

    def report(self, tick_t0: list[float], tick_s: list[float]) -> str:
        """Time per generation, and how many of the slow ticks (over twice
        the median) hold a pass, and how much of their excess it is."""
        parts = []
        for g in range(3):
            ps = [p for p in self.passes if p[0] == g]
            secs = sum(p[2] for p in ps)
            parts.append(f"gen{g} {len(ps)} passes {secs:.6f} s")
        if not tick_s:
            return "; ".join(parts)
        med = float(np.median(tick_s))
        slow = [(t, d) for t, d in zip(tick_t0, tick_s) if d > 2 * med]
        within = [[p for p in self.passes if t <= p[1] < t + d]
                  for t, d in slow]
        excess = sum(d - med for _, d in slow)
        in_gc = sum(p[2] for ps in within for p in ps)
        n_gen2 = sum(any(p[0] == 2 for p in ps) for ps in within)
        parts.append(
            f"{len(slow)} of {len(tick_s)} ticks over twice the median "
            f"{1e3 * med:.3f} ms; {sum(map(bool, within))} hold a pass, "
            f"{n_gen2} a gen2 pass; their excess {excess:.6f} s, in passes "
            f"{in_gc:.6f} s")
        return "; ".join(parts)


class ClosedLoop:
    """``clients`` clients over one driver, each sending its next query as
    soon as its last one completes (while ``open``).

    The clients join in ``ramp`` groups, one group before each of the
    first ticks, so that queries which take the same number of ticks do
    not move in lockstep; the loop then runs on, from the warm-up into
    the window, without draining in between."""

    def __init__(self, drv, stream, clients: int, ramp: int = 1):
        self.drv, self.stream = drv, stream
        self.inflight: dict[int, tuple[Query, float, int]] = {}
        self.done: list[Done] = []
        self.tick_t0: list[float] = []
        self.tick_s: list[float] = []
        self.ticks = 0
        self.open = True
        self.waiting = clients
        self.group = -(-clients // max(1, ramp))
        self.t_start = self.deadline = 0.0

    def _submit(self) -> None:
        q = next(self.stream)
        t = time.perf_counter()
        qid = self.drv.submit(q)
        self.inflight[qid] = (q, t, self.ticks)

    def _collect(self) -> None:
        while True:
            got = self.drv.completed()
            if not got:
                return
            now = time.perf_counter()
            for qid in got:
                q, t, tk = self.inflight.pop(qid)
                self.done.append(Done(q, self.drv.take(qid), t, now,
                                      self.ticks - tk))
                if self.open:
                    self._submit()

    def _tick(self) -> None:
        if self.waiting and self.open:
            n = min(self.group, self.waiting)
            self.waiting -= n
            for _ in range(n):
                self._submit()
            self._collect()
        t0 = time.perf_counter()
        self.drv.tick()
        self.tick_t0.append(t0)
        self.tick_s.append(time.perf_counter() - t0)
        self.ticks += 1
        self._collect()

    def run_count(self, n: int) -> None:
        """Tick until every client has joined and ``n`` queries are done."""
        while self.waiting or len(self.done) < n:
            self._tick()

    def run_for(self, seconds: float) -> list[Done]:
        """Tick on for ``seconds`` seconds; the queries completed in them."""
        first = len(self.done)
        self.t_start = time.perf_counter()
        self.deadline = self.t_start + seconds
        while time.perf_counter() < self.deadline:
            self._tick()
        return [d for d in self.done[first:] if d.t_done <= self.deadline]

    def drain(self, timeout: float) -> None:
        """Stop sending; tick until nothing is in flight or ``timeout``."""
        self.open = False
        end = time.perf_counter() + timeout
        while self.inflight and time.perf_counter() < end:
            self._tick()


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``)."""

    cell: str
    seconds: float
    setup_s: float
    postings: int
    index_bytes: int            # device bytes the served index holds
    window: list[Done]          # completed inside the window
    tick_s: list[float]         # each tick of the window, seconds
    before: dict                # the program's counters at the start
    after: dict                 # ... and at the close of the window
    window_peak_bytes: int
    trace: dict | None          # tracing.Tracer.summarize; traced runs only
    traced: list[Done]          # completed in the traced span

    def delta(self, key: str) -> int:
        return self.after[key] - self.before[key]

    def launches(self) -> int:
        return (sum(self.after["launches"].values())
                - sum(self.before["launches"].values()))


def apply_env(config: dict, root: Path) -> None:
    """Give the program the configuration's settings and nothing else:
    every ``REPRO_*`` variable is cleared, then set from the file; build
    caches stay inside the checkout."""
    for key in [k for k in os.environ if k.startswith("REPRO_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in config["env"].items()})
    cache = Path(root) / "build_torch"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def corpus_lists(corpus: dict) -> list[np.ndarray]:
    """The configuration's posting lists: its corpus, drawn from the seed
    the configuration states, so every run serves the same index."""
    kw = {k: v for k, v in corpus.items() if k != "seed"}
    return postings(zipf_corpus(seed=corpus["seed"], **kw))


class _Answers:
    """Answers of one reference, worked out once per distinct query."""

    def __init__(self, ref: Reference):
        self.ref, self.memo = ref, {}

    def __call__(self, q: Query):
        a = self.memo.get(q.text)
        if a is None:
            a = (self.ref.boolean(q.query) if q.kind == "bool"
                 else self.ref.topk(q.query, q.k))
            self.memo[q.text] = a
        return a


def compare(pairs, want: _Answers, ranked: bool) -> dict[str, int]:
    """How many of ``(query, answer)`` differ from the reference: in
    their doc ids, and (ranked) in their float32 scores bit for bit.  A
    missing answer (None) differs in both."""
    out = {"docs_wrong": 0}
    if ranked:
        out["scores_wrong"] = 0
    for q, got in pairs:
        if got is None:
            out["docs_wrong"] += 1
            if q.kind == "topk":
                out["scores_wrong"] += 1
            continue
        w = want(q)
        if q.kind == "bool":
            out["docs_wrong"] += not np.array_equal(got, w)
        else:
            out["docs_wrong"] += not np.array_equal(got[0], w[0])
            out["scores_wrong"] += not (
                got[1].dtype == np.float32
                and np.array_equal(got[1].view(np.uint32),
                                   w[1].view(np.uint32)))
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *,
             t0: float, device="cuda", control: bool = False,
             drain_s: float = 60.0, fault=None, log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last).
    ``fault(server)``, if given, breaks the program after the warm-up
    (the fault tests)."""
    import torch

    from . import sut
    cfg, tr = cell.config, cell.traffic
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    clients = int(tr["clients"])

    t = time.perf_counter()
    lists = corpus_lists(cfg["corpus"])
    n_post = int(sum(l.size for l in lists))
    lengths = [int(l.size) for l in lists]
    t_corpus = time.perf_counter() - t
    t = time.perf_counter()
    res = sut.build_grammar(cfg, lists, dev)
    t_build = time.perf_counter() - t
    gc.collect()
    mem = (lambda: torch.cuda.memory_allocated(dev)) if on_card else \
        (lambda: 0)
    mem0 = mem()
    t = time.perf_counter()
    srv = sut.make_server(cfg, res, dev)
    drv = sut.Driver(srv)
    t_server = time.perf_counter() - t
    stream = QueryStream(tr, len(lists), lengths, seed)
    ready = list(itertools.islice(stream, int(tr["prefill"])))
    t = time.perf_counter()
    # the warm-up draws a stream of the same mix that no run's seed draws
    loop = ClosedLoop(drv, QueryStream(tr, len(lists), lengths,
                                       [tr["warmup_seed"], 0x7761726D]),
                      clients, int(tr["ramp_ticks"]))
    loop.run_count(int(tr["warmup_queries"]))
    n_warm = len(loop.done)
    t_warm = time.perf_counter() - t
    gc.collect()
    index_bytes = mem() - mem0
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    if fault is not None:
        fault(srv)
    before = sut.counters(srv)
    loop.stream = itertools.chain(ready, stream)
    t_first = len(loop.tick_s)
    gcc = GcClock()
    gcc.start()
    window = loop.run_for(seconds)
    gcc.stop()
    after = sut.counters(srv)
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    setup_s = loop.t_start - t0
    t_start, t_end = loop.t_start, loop.deadline
    tick_t0, tick_s = loop.tick_t0[t_first:], loop.tick_s[t_first:]
    tracer, traced = None, []
    if trace:
        from .tracing import Tracer
        tracer = Tracer(dev, [Path(sut.CSRC).parent, HERE])
        tracer.start()
        traced = loop.run_for(TRACE_SECONDS)
        tracer.stop()
    loop.drain(drain_s)
    run_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    # a query that never completed is held to the reference as missing
    answers = [(d.query, d.answer) for d in loop.done] + \
        [(q, None) for q, _, _ in loop.inflight.values()]
    unanswered = len(loop.inflight)
    print(f"[setup] corpus {t_corpus:.3f} s ({len(lists)} lists, {n_post} "
          f"postings); build {t_build:.3f} s ({res.grammar.num_rules} "
          f"rules); server {t_server:.3f} s; warm-up {t_warm:.3f} s "
          f"({n_warm} queries); setup_s {setup_s:.3f}", file=log)
    print(f"[gc] window: {gcc.report(tick_t0, tick_s)}", file=log)
    summary = (tracer.summarize(sut.kernel_names()) if tracer is not None
               else None)
    if summary is not None:
        print(f"[trace] {summary['device_activities']} device activities, "
              f"busy {summary['busy_s']:.6f} s of {summary['window_s']:.6f}"
              f" s; timelines aligned by {summary['aligned_by']}", file=log)
    run = RunRecord(cell.name, t_end - t_start, setup_s, n_post,
                    index_bytes, window, tick_s, before, after, window_peak,
                    summary, traced)

    # the program's state goes before the reference runs
    loop.drv = drv = None
    del srv, res, loop, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    sc, limits = cfg["scoring"], cfg["limits"]
    ranked = tr["kind"] == "topk"
    want = _Answers(Reference(lists, sc["k1"], sc["b"]))
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in compare(answers, want, ranked).items()}
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(answers),
        "failed": unanswered,
        "metrics": {},
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": cell.chips if on_card else 1,
            "memory_peak_bytes": int(max(setup_peak, run_peak)),
        },
    }
    for m in cell.per_layer if trace else cell.end_to_end:
        v = cell.readers[m["name"]](run)
        if v is not None:
            out["metrics"][m["name"]] = {"value": float(v), "unit": m["unit"]}
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if control:
        ctl = {"bool": _Answers(BloomReference(lists, sc["k1"], sc["b"])),
               "topk": _Answers(Bf16Reference(lists, sc["k1"], sc["b"]))}
        out["control"] = compare([(q, ctl[q.kind](q)) for q, _ in answers],
                                 want, ranked)
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Run one cell of the "
                                 "benchmark once and print its result.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also hold the controls' answers to the reference")
    args = ap.parse_args(argv)
    root = HERE.parent
    cell = Benchmark.load(root).cell(args.workload)
    apply_env(cell.config, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0=t0,
                   control=bool(args.control))
    bad = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
