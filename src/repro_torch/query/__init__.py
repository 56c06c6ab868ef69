"""Boolean query subsystem (DESIGN.md §7).

An AST (``Term``/``And``/``Or``/``Not``/``Phrase``), a query-string
parser, a cost-based planner that picks an intersection algorithm per
conjunctive step (merge / svs skip / Baeza-Yates binary search / k-way
adaptive melding), and an executor that lowers the plan onto the
backend-pluggable Engine API — so the same query runs on HostEngine,
TorchEngine (flat and paged) and CudaEngine.

    from repro_torch.query import QueryExecutor, parse
    qx = QueryExecutor(make_engine("torch", res, device="cuda"))
    qx.search('(12 AND 40) OR NOT 7')
    qx.search(And((Term(12), Term(40), Term(3))))   # AST directly

``tests/test_torch_serve.py`` holds the port's answers bit-identical to
the JAX package's on the same workloads.
"""

from .ast import And, Node, Not, Or, Phrase, Term, terms_of, to_str, walk
from .exec import QueryExecutor, naive_eval
from .parser import QueryParseError, parse
from .plan import ALGOS, ListStats, PlanNode, explain, make_plan
from .steps import (DecodeList, PhraseShift, ProbeRound, ScoreRound, SetOp,
                    drive)
from .topk import RankedResult, lower_topk, rank_oracle, search_topk

__all__ = [
    "And", "Node", "Not", "Or", "Phrase", "Term", "terms_of", "to_str",
    "walk", "QueryExecutor", "naive_eval", "QueryParseError", "parse",
    "ALGOS", "ListStats", "PlanNode", "explain", "make_plan",
    "ProbeRound", "ScoreRound", "DecodeList", "SetOp", "PhraseShift",
    "drive", "RankedResult", "lower_topk", "rank_oracle", "search_topk",
]
