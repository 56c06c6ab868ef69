"""Boolean query AST (DESIGN.md §7.1).

Five node types over integer term ids (a term id addresses one postings
list of the index the executor is bound to):

* ``Term(t)``            — one postings list; ``t < 0`` or an id past the
                           index means "term not in vocabulary" and
                           evaluates to the empty set;
* ``And(children)``      — conjunction (the paper's workload, §3.3/§5);
* ``Or(children)``       — disjunction;
* ``Not(child)``         — complement against the document domain;
* ``Phrase(terms)``      — exact phrase.  Over a positional index the
                           executor solves it by intersecting shifted
                           position lists (paper §1); over a document-level
                           index it degrades to the classic two-level
                           AND-then-verify skeleton (conjunction here,
                           verification left to the caller).

Nodes are frozen dataclasses so they hash and compare structurally —
hypothesis shrinks them, planners memoize them, tests use them as dict
keys.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Union

Node = Union["Term", "And", "Or", "Not", "Phrase"]


@dataclasses.dataclass(frozen=True)
class Term:
    t: int


@dataclasses.dataclass(frozen=True)
class And:
    children: tuple[Node, ...]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))


@dataclasses.dataclass(frozen=True)
class Or:
    children: tuple[Node, ...]

    def __post_init__(self):
        object.__setattr__(self, "children", tuple(self.children))


@dataclasses.dataclass(frozen=True)
class Not:
    child: Node


@dataclasses.dataclass(frozen=True)
class Phrase:
    terms: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "terms", tuple(int(t) for t in self.terms))


def walk(node: Node) -> Iterator[Node]:
    """Pre-order traversal."""
    yield node
    if isinstance(node, (And, Or)):
        for c in node.children:
            yield from walk(c)
    elif isinstance(node, Not):
        yield from walk(node.child)


def terms_of(node: Node) -> list[int]:
    """Every term id mentioned anywhere in the query."""
    out: list[int] = []
    for n in walk(node):
        if isinstance(n, Term):
            out.append(n.t)
        elif isinstance(n, Phrase):
            out.extend(n.terms)
    return out


def to_str(node: Node) -> str:
    """Render a node back to the query-string syntax ``parse`` accepts."""
    if isinstance(node, Term):
        return str(node.t)
    if isinstance(node, Phrase):
        return '"' + " ".join(str(t) for t in node.terms) + '"'
    if isinstance(node, Not):
        return f"NOT {to_str(node.child)}"
    if isinstance(node, And):
        return "(" + " AND ".join(to_str(c) for c in node.children) + ")"
    if isinstance(node, Or):
        return "(" + " OR ".join(to_str(c) for c in node.children) + ")"
    raise TypeError(f"not a query node: {node!r}")
