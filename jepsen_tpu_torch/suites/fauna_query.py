"""FaunaDB query-language AST builders.

The reference drives FaunaDB through the official JVM driver's
expression tree (`faunadb/src/jepsen/faunadb/query.clj:18-330` wraps
`com.faunadb.client.query.Language`). FaunaDB's wire protocol is HTTP
POST of the JSON-serialized expression; this module builds that JSON
directly — each function mirrors one `q/...` builder — so the suite
client (`faunadb.py`) needs no driver. Literal maps are wrapped in
``{"object": ...}`` exactly like the real wire format, so data keyed
"get"/"if"/... can't be misparsed as function calls.

Evaluation semantics live in the test fake (`tests/fake_fauna.py`),
which interprets the same encoding over a versioned store (FaunaDB is
a temporal database: `at` reads past snapshots, `query.clj:187-195`).
"""

from __future__ import annotations

import functools
from typing import Any


class Expr(dict):
    """A built query expression. The marker lets wrap() distinguish
    expression dicts (pass through) from literal data maps (encode as
    {"object": ...}) — the JVM driver gets this from its typed Value
    tree (`query.clj:18-51`)."""


def wrap(v: Any):
    """Encode a literal Python value: plain dicts become {"object":
    ...} so data keys can't collide with function forms; Expr values
    pass through unchanged."""
    if isinstance(v, Expr):
        return v
    if isinstance(v, dict):
        return Expr({"object": {k: wrap(x) for k, x in v.items()}})
    if isinstance(v, (list, tuple)):
        return [wrap(x) for x in v]
    return v


def class_(name: str) -> dict:
    """A class ref (`query.clj:63-69`)."""
    return {"class": name}


def index(name: str) -> dict:
    """An index ref (`query.clj:77-80`)."""
    return {"index": name}


def ref(cls, id) -> dict:
    """An instance ref within a class (`query.clj:71-75`). The id may
    itself be an expression (e.g. a select over an index page)."""
    if isinstance(cls, str):
        cls = class_(cls)
    return {"ref": cls, "id": id if isinstance(id, dict) else str(id)}


def var(name: str) -> dict:
    """A let-bound variable (`query.clj:58-61`)."""
    return {"var": name}


def let(bindings: dict, in_) -> dict:
    """Sequential let bindings (`query.clj:121-156`)."""
    return {"let": [{k: v} for k, v in bindings.items()], "in": in_}


def if_(cond, then, else_) -> dict:
    return {"if": cond, "then": then, "else": else_}


def when(cond, then) -> dict:
    """if without an else branch (`query.clj:169-172`)."""
    return if_(cond, then, False)


def do(*exprs) -> dict:
    """Sequence expressions, returning the last (`query.clj:88-102`)."""
    return {"do": list(exprs)}


def fn(params: list[str], expr) -> dict:
    """An anonymous function (`query.clj:104-119`)."""
    return {"lambda": params, "expr": expr}


def map_(coll, f) -> dict:
    return {"map": f, "collection": coll}


def foreach(coll, f) -> dict:
    return {"foreach": f, "collection": coll}


def create(ref_or_cls, params: dict) -> dict:
    """Create an instance (`query.clj:207-210`); creating against a
    class ref allocates a fresh id."""
    return {"create": ref_or_cls, "params": wrap(params)}


def update(r, params: dict) -> dict:
    return {"update": r, "params": wrap(params)}


def delete(r) -> dict:
    return {"delete": r}


def get(r) -> dict:
    return {"get": r}


def exists(r) -> dict:
    return {"exists": r}


def select(path: list, from_, default=None) -> dict:
    out = {"select": list(path), "from": from_}
    if default is not None:
        out["default"] = default
    return out


def create_class(params: dict) -> dict:
    return {"create_class": wrap(params)}


def create_index(params: dict) -> dict:
    return {"create_index": wrap(params)}


def match(idx, terms=None) -> dict:
    """The set of instances matching an index (`query.clj:229-234`)."""
    out = {"match": idx}
    if terms is not None:
        out["terms"] = wrap(terms)
    return out


def paginate(set_, size: int = 64, after=None) -> dict:
    out = {"paginate": set_, "size": size}
    if after is not None:
        out["after"] = after
    return out


def events(r) -> dict:
    """The instance's version history (`query.clj:323-326`)."""
    return {"events": r}


def time(s: str) -> dict:
    """A timestamp; "now" is the transaction time (`query.clj:192-195`)."""
    return {"time": s}


def at(ts, expr) -> dict:
    """Run expr against the snapshot at ts (`query.clj:187-190`)."""
    return {"at": ts, "expr": expr}


def abort(msg: str) -> dict:
    """Abort the transaction with a message (`query.clj:158-160`)."""
    return {"abort": msg}


def add(*xs) -> dict:
    return {"add": list(xs)}


def subtract(*xs) -> dict:
    return {"subtract": list(xs)}


def lt(*xs) -> dict:
    return {"lt": list(xs)}


def eq(*xs) -> dict:
    return {"equals": list(xs)}


def not_(x) -> dict:
    return {"not": x}


def and_(*xs) -> dict:
    return {"and": list(xs)}


def or_(*xs) -> dict:
    return {"or": list(xs)}


def non_empty(x) -> dict:
    """True iff a page/array has elements (`query.clj:253-255`)."""
    return {"non_empty": x}


def union(*sets) -> dict:
    """Set union over index matches (`query.clj:275-282`)."""
    return {"union": list(sets)}


def intersection(*sets) -> dict:
    """Set intersection over index matches (`query.clj:284-291`)."""
    return {"intersection": list(sets)}


def singleton(r) -> dict:
    """Lift a ref into a one-element set (`query.clj:328-330`)."""
    return {"singleton": r}


def cond(*clauses) -> dict:
    """cond-style chain: pairs of (test, expr) with an optional final
    default (`query.clj:174-185`)."""
    if len(clauses) == 1:
        return clauses[0]
    test, expr, *rest = clauses
    return if_(test, expr, cond(*rest) if rest else False)


def _mark(fn):
    @functools.wraps(fn)
    def g(*a, **k):
        out = fn(*a, **k)
        return Expr(out) if isinstance(out, dict) \
            and not isinstance(out, Expr) else out
    return g


for _name in ("class_", "index", "ref", "var", "let", "if_", "when", "do",
              "fn", "map_", "foreach", "create", "update", "delete", "get",
              "exists", "select", "create_class", "create_index", "match",
              "paginate", "events", "time", "at", "abort", "add",
              "subtract", "lt", "eq", "not_", "and_", "or_", "non_empty",
              "union", "intersection", "singleton", "cond"):
    globals()[_name] = _mark(globals()[_name])

NOW = Expr({"time": "now"})
