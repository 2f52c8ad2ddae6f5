"""Renders an HTML timeline of a history.

Reference: `jepsen/src/jepsen/checker/timeline.clj` — one column per
process, one absolutely-positioned div per invoke/completion pair,
color-coded by completion type, capped at `OP_LIMIT` ops (:12-14), with
hover titles carrying the full op (:69-106).
"""

from __future__ import annotations

from html import escape

from .. import util
from ..history import NEMESIS, history
from . import Checker

OP_LIMIT = 10_000  # render cap for massive histories (`timeline.clj:12-14`)

COL_WIDTH = 100     # px
GUTTER_WIDTH = 106  # px
HEIGHT = 16         # px

STYLESHEET = """\
.ops        { position: absolute; }
.op         { position: absolute; padding: 2px; border-radius: 2px;
              box-shadow: 0 1px 3px rgba(0,0,0,0.12),
                          0 1px 2px rgba(0,0,0,0.24);
              transition: all 0.3s cubic-bezier(.25,.8,.25,1);
              overflow: hidden; }
.op.invoke  { background: #eeeeee; }
.op.ok      { background: #6DB6FE; }
.op.info    { background: #FFAA26; }
.op.fail    { background: #FEB5DA; }
.op:target  { box-shadow: 0 14px 28px rgba(0,0,0,0.25),
                          0 10px 10px rgba(0,0,0,0.22); }
"""


def pairs(hist) -> list:
    """Pair ops per process: yields [info] singletons or
    [invoke, completion] pairs (`timeline.clj:37-57`)."""
    invocations: dict = {}
    out = []
    for op in hist:
        t = op.get("type")
        p = op.get("process")
        if t == "info":
            if p in invocations:
                out.append([invocations.pop(p), op])
            else:
                out.append([op])
        elif t == "invoke":
            assert p not in invocations
            invocations[p] = op
        elif t in ("ok", "fail"):
            assert p in invocations
            out.append([invocations.pop(p), op])
    return out


def is_nemesis(op: dict) -> bool:
    return op.get("process") == NEMESIS


def render_op(op: dict) -> str:
    shown = ("process", "type", "f", "index")
    extra = "".join(f"\n {k} {v!r}" for k, v in op.items()
                    if k not in shown + ("sub-index", "value", "time"))
    return (f"Op:\n{{process {op.get('process')}"
            f"\n type {op.get('type')}"
            f"\n f {op.get('f')}"
            f"\n index {op.get('index')}"
            f"{extra}"
            f"\n value {op.get('value')!r}}}")


def title(test, op, start, stop) -> str:
    parts = []
    if is_nemesis(op):
        parts.append(f"Msg: {start.get('value')!r}")
    if stop:
        dur_ms = int((stop["time"] - start["time"]) / 1e6)
        parts.append(f"Dur: {dur_ms} ms")
    parts.append(f"Err: {op.get('error')!r}")
    parts.append(f"Rel-time: {util.nanos_to_secs(op.get('time', 0)):.3f} s")
    parts.append("")
    parts.append(render_op(op))
    return "\n".join(parts)


def body(op, start, stop) -> str:
    same = stop is not None and start.get("value") == stop.get("value")
    s = escape(f"{op.get('process')} {op.get('f')}") + " "
    if not is_nemesis(op):
        s += escape(repr(start.get("value")))
    if stop is not None and not same:
        s += "<br />" + escape(repr(stop.get("value")))
    return s


def process_index(hist) -> dict:
    """Process -> column number: clients in order, nemesis last
    (`timeline.clj:163-170`)."""
    procs = []
    for op in hist:
        p = op.get("process")
        if p not in procs:
            procs.append(p)
    ints = sorted(p for p in procs if isinstance(p, int))
    rest = [p for p in procs if not isinstance(p, int)]
    return {p: i for i, p in enumerate(ints + rest)}


def pair_to_div(hist_len, test, pindex, pair) -> str:
    start = pair[0]
    stop = pair[1] if len(pair) > 1 else None
    op = stop or start
    left = GUTTER_WIDTH * pindex.get(start.get("process"), 0)
    top = HEIGHT * start["sub-index"]
    if stop is not None and stop.get("type") == "info":
        h = HEIGHT * (hist_len + 1 - start["sub-index"])
    elif stop is not None:
        h = HEIGHT * max(stop["sub-index"] - start["sub-index"], 1)
    else:
        h = HEIGHT
    style = (f"width:{COL_WIDTH}px;left:{left}px;top:{top}px;"
             f"height:{h}px")
    idx = op.get("index")
    return (f'<a href="#i{idx}">'
            f'<div class="op {escape(str(op.get("type")))}" id="i{idx}" '
            f'style="{style}" title="{escape(title(test, op, start, stop))}"'
            f'>{body(op, start, stop)}</div></a>')


class Html(Checker):
    """Writes timeline.html into the test's store directory
    (`timeline.clj:180-209`)."""

    def check(self, test, hist, opts):
        hist = history(hist)
        sub = [dict(o, **{"sub-index": i}) for i, o in enumerate(hist)]
        ps = pairs(sub)
        total = len(ps)
        ps = ps[:OP_LIMIT]
        pindex = process_index(sub)
        parts = ["<html><head><style>", STYLESHEET, "</style></head><body>",
                 f"<h1>{escape(str(test.get('name', '')))} key "
                 f"{escape(str((opts or {}).get('history-key', '')))}</h1>"]
        if total > OP_LIMIT:
            parts.append(
                f'<div class="truncation-warning">Showing only {OP_LIMIT} '
                f'of {total} operations in this history.</div>')
        parts.append('<div class="ops">')
        for pair in ps:
            parts.append(pair_to_div(len(sub), test, pindex, pair))
        parts.append("</div></body></html>")
        from .perf import out_path
        with open(out_path(test, opts, "timeline.html"), "w") as f:
            f.write("\n".join(parts))
        return {"valid?": True}


def html() -> Checker:
    return Html()
