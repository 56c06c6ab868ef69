"""Query-string parser for the boolean AST (DESIGN.md §7.1).

Grammar (standard precedence NOT > AND > OR, parens, quoted phrases,
implicit AND between adjacent atoms):

    expr   := and ( 'OR' and )*
    and    := unary ( 'AND'? unary )*
    unary  := 'NOT' unary | atom
    atom   := TERM | '"' TERM+ '"' | '(' expr ')'

Terms are integer list ids by default; pass ``term_map`` (word -> id) to
query with words.  Unknown words map to ``Term(-1)``, which evaluates to
the empty set — a query mentioning an out-of-vocabulary term is answerable,
not an error (the same contract real engines implement).
"""

from __future__ import annotations

import re

from .ast import And, Node, Not, Or, Phrase, Term

_TOKEN = re.compile(r'\(|\)|"|[^\s()"]+')
_KEYWORDS = {"AND", "OR", "NOT"}


class QueryParseError(ValueError):
    pass


def _tokenize(s: str) -> list[str]:
    return _TOKEN.findall(s)


class _Parser:
    def __init__(self, tokens: list[str], term_map: dict[str, int] | None):
        self.toks = tokens
        self.i = 0
        self.term_map = term_map

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self) -> str:
        t = self.peek()
        if t is None:
            raise QueryParseError("unexpected end of query")
        self.i += 1
        return t

    def term_id(self, tok: str) -> int:
        if self.term_map is not None:
            return int(self.term_map.get(tok, -1))
        try:
            return int(tok)
        except ValueError:
            raise QueryParseError(
                f"term {tok!r} is not an integer id (pass term_map to "
                f"query with words)") from None

    # -- grammar -------------------------------------------------------------

    def expr(self) -> Node:
        parts = [self.and_()]
        while self.peek() == "OR":
            self.take()
            parts.append(self.and_())
        return parts[0] if len(parts) == 1 else Or(tuple(parts))

    def and_(self) -> Node:
        parts = [self.unary()]
        while True:
            t = self.peek()
            if t == "AND":
                self.take()
                parts.append(self.unary())
            elif t is not None and t not in ("OR", ")"):
                parts.append(self.unary())    # implicit AND
            else:
                break
        return parts[0] if len(parts) == 1 else And(tuple(parts))

    def unary(self) -> Node:
        if self.peek() == "NOT":
            self.take()
            return Not(self.unary())
        return self.atom()

    def atom(self) -> Node:
        t = self.take()
        if t == "(":
            node = self.expr()
            if self.take() != ")":
                raise QueryParseError("expected ')'")
            return node
        if t == '"':
            terms: list[int] = []
            while self.peek() not in ('"', None):
                terms.append(self.term_id(self.take()))
            if self.peek() != '"':
                raise QueryParseError("unterminated phrase")
            self.take()
            if not terms:
                raise QueryParseError("empty phrase")
            return Phrase(tuple(terms)) if len(terms) > 1 else Term(terms[0])
        if t in _KEYWORDS or t == ")":
            raise QueryParseError(f"unexpected {t!r}")
        return Term(self.term_id(t))


def parse(query: str, term_map: dict[str, int] | None = None) -> Node:
    """Parse a query string into an AST.

    >>> parse('(1 AND 2) OR NOT 3')
    Or(children=(And(children=(Term(t=1), Term(t=2))), Not(child=Term(t=3))))
    """
    toks = _tokenize(query)
    if not toks:
        raise QueryParseError("empty query")
    p = _Parser(toks, term_map)
    node = p.expr()
    if p.peek() is not None:
        raise QueryParseError(f"trailing input at {p.peek()!r}")
    return node
