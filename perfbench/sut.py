"""The system under test: the port's ``QueryServer``, driven the way a
search front end drives it.

This is the one module of the benchmark that imports the program
(``repro_torch``, from ``src/``), and it is imported only once the run
has set the program's environment.  It builds the index with the
configuration's builder on the device, stands up the server, and gives
the harness four calls: ``submit``, ``tick``, ``completed`` and
``take``, plus the program's own cumulative counters and the names of
its CUDA kernels.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from repro_torch import kernels as KR
from repro_torch.build import make_builder
from repro_torch.serve.query_serve import QueryServer

CSRC = Path(KR.__file__).resolve().parents[1] / "csrc"


def build_grammar(config: dict, lists, device):
    """The Re-Pair grammar of ``lists``, built by the configuration's
    builder on ``device``."""
    b = dict(config["build"])
    builder = make_builder(b.pop("builder"), device=device, **b)
    return builder.build_grammar(lists)


def make_server(config: dict, res, device) -> QueryServer:
    ix = config["index"]
    return QueryServer(res, max_short_len=ix["max_short_len"], B=ix["B"],
                       engine=ix["engine"], device=device,
                       page_size=ix["page_size"],
                       batch_window=ix["batch_window"], codec=ix["codec"],
                       store=ix["store"],
                       resident_pages=ix["resident_pages"])


class Driver:
    """Submit queries to one server and collect what completes."""

    def __init__(self, srv: QueryServer):
        self.srv = srv
        self.sched = srv.scheduler

    def submit(self, q) -> int:
        if q.kind == "bool":
            return self.srv.submit(q.text)
        return self.srv.submit_topk(q.query, q.k)

    def tick(self) -> None:
        self.sched.tick()

    def completed(self) -> list[int]:
        """The query ids completed since the last call, in order."""
        order = self.sched.completion_order
        out = list(order)
        order.clear()
        return out

    def take(self, qid: int):
        """A boolean answer as int64 doc ids; a ranked one as (int64 doc
        ids, float32 scores)."""
        a = self.sched.take(qid)
        if hasattr(a, "scores"):
            return (np.asarray(a.docs, np.int64),
                    np.asarray(a.scores, np.float32))
        return np.asarray(a, np.int64)


_LANES = ("real_lanes", "unique_lanes", "pad_lanes", "dispatched_lanes",
          "memo_hits", "memo_misses")


def counters(srv: QueryServer) -> dict:
    """The program's cumulative counters: the scheduler's, its result
    cache's, the engine's per-codec dispatches and the kernel launches."""
    st = srv.serve_stats()
    out = {k: st[k] for k in ("completed", "failures", "dispatches",
                              "merged_lanes", "pages_scored",
                              "pages_skipped", *_LANES)}
    out["result_cache_hits"] = st["result_cache"]["hits"]
    out["result_cache_misses"] = st["result_cache"]["misses"]
    out["codec_dispatches"] = dict(st["codec_dispatches"])
    out["launches"] = dict(KR.LAUNCHES)
    return out


def kernel_names() -> tuple[str, ...]:
    """The ``__global__`` functions of the program's CUDA sources: the
    names its kernels carry in a device trace."""
    pat = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return tuple(sorted({n for f in sorted(CSRC.glob("*.cu"))
                         for n in pat.findall(f.read_text())}))
