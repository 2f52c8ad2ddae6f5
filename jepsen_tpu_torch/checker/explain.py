"""Render the neighborhood of a nonlinearizable verdict as SVG.

The port's own copy of `jepsen_tpu/checker/explain.py`. The reference
renders failing knossos analyses with
`knossos.linear.report/render-analysis!` into ``linear.svg``
(`jepsen/src/jepsen/checker.clj:205-212`). Here the renderer is
self-contained: a window of operations around the culprit, one row per
process, invoke->completion bars colored by completion type, the
culprit op highlighted, and the reconstructed final paths listed
beneath it.
"""

from __future__ import annotations

from html import escape

from ..history import history as as_history

_BAR_H = 18
_ROW_H = 26
_CHAR_W = 7
_COLORS = {"ok": "#6DB6FE", "info": "#FFAA26", "fail": "#FEB5DA"}


def _fmt(op: dict) -> str:
    v = op.get("value")
    return f"{op.get('f')} {v if v is not None else 'nil'}"


def render_failure_svg(hist, op_index: int, final_paths=(),
                       window: int = 20) -> str:
    """SVG for the ops surrounding the op with history :index
    `op_index` (the culprit). window = ops kept either side."""
    hist = as_history(hist)
    if hist.ops and "index" not in hist.ops[0]:
        hist = hist.index()
    pairs = []  # (invoke, completion|None)
    culprit_row = None
    open_by_process: dict = {}
    for pos, o in enumerate(hist.ops):
        t = o.get("type")
        p = o.get("process")
        if not isinstance(p, int):
            continue
        if t == "invoke":
            open_by_process[p] = (len(pairs), o)
            pairs.append([o, None])
        elif p in open_by_process:
            row, _inv = open_by_process.pop(p)
            pairs[row][1] = o
            if o.get("index") == op_index or \
                    pairs[row][0].get("index") == op_index:
                culprit_row = row
    if culprit_row is None:
        for row, (inv, _c) in enumerate(pairs):
            if inv.get("index") == op_index:
                culprit_row = row
    lo = max(0, (culprit_row or 0) - window)
    hi = min(len(pairs), (culprit_row or 0) + window + 1)
    shown = pairs[lo:hi]
    procs = sorted({p[0]["process"] for p in shown})
    prow = {p: i for i, p in enumerate(procs)}

    # layout: x by pair order inside the window (time is too bursty for
    # a linear scale to stay readable), y by process
    x_step = 84
    width = 120 + x_step * max(1, len(shown))
    height = 60 + _ROW_H * len(procs) + 18 * (len(final_paths) and
                                              (2 + sum(len(p) + 1 for p in
                                                       final_paths)))
    svg = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
           f'height="{height}" font-family="monospace" font-size="11">',
           '<text x="8" y="16" font-size="13">nonlinearizable — ops '
           f'around culprit index {op_index}</text>']
    for p, r in prow.items():
        svg.append(f'<text x="8" y="{46 + r * _ROW_H + 12}">'
                   f'p{escape(str(p))}</text>')
    for i, (inv, comp) in enumerate(shown):
        r = prow[inv["process"]]
        x = 60 + i * x_step
        y = 42 + r * _ROW_H
        typ = (comp or {}).get("type", "info")
        color = _COLORS.get(typ, "#dddddd")
        is_culprit = (lo + i) == culprit_row
        stroke = ' stroke="#d32f2f" stroke-width="3"' if is_culprit else \
            ' stroke="#999" stroke-width="1"'
        svg.append(f'<rect x="{x}" y="{y}" width="{x_step - 6}" '
                   f'height="{_BAR_H}" rx="3" fill="{color}"{stroke}>'
                   f'<title>{escape(str(inv))} -> {escape(str(comp))}'
                   f'</title></rect>')
        label = _fmt(comp or inv)[:11]
        svg.append(f'<text x="{x + 3}" y="{y + 13}">'
                   f'{escape(label)}</text>')
    y = 42 + _ROW_H * len(procs) + 24
    if final_paths:
        svg.append(f'<text x="8" y="{y}" font-size="12">final paths '
                   '(legal linearizations ending at the failure):</text>')
        y += 18
        for path in final_paths:
            for step in path:
                op = step.get("op") or {}
                svg.append(
                    f'<text x="24" y="{y}">{escape(_fmt(op))} '
                    f'&#8594; {escape(str(step.get("model")))}</text>')
                y += 18
            y += 18
    svg.append("</svg>")
    return "\n".join(svg)


def write_failure_svg(test, opts, analysis: dict, hist) -> str | None:
    """Write linear.svg (linear-<key>.svg under the independent checker,
    so concurrent per-key failures don't clobber each other) into the
    test's store directory for a definite invalid analysis carrying an
    op-index. Only writes for real runs — a test map with both a name
    and a start-time (`core.run!` sets it); ad-hoc checker calls stay
    side-effect-free. Returns the path or None."""
    if analysis.get("valid?") is not False or \
            "op-index" not in analysis or not test.get("name") or \
            not test.get("start-time"):
        return None
    from .perf import out_path
    svg = render_failure_svg(hist, analysis["op-index"],
                             analysis.get("final-paths") or ())
    key = (opts or {}).get("history-key")
    fname = f"linear-{key}.svg" if key is not None else "linear.svg"
    p = out_path(test, opts, fname)
    with open(p, "w") as f:
        f.write(svg)
    return p
