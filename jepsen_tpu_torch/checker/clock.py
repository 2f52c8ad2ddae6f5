"""Clock-skew analysis: plots per-node clock offsets over time.

Reference: `jepsen/src/jepsen/checker/clock.clj` — any op carrying a
`clock-offsets` map (node -> offset seconds, emitted by the clock
nemesis's :check-offsets) contributes points; series render as step
functions, extended to the end of the history (:13-34).
"""

from __future__ import annotations

from .. import plot as gp
from .. import util
from ..history import history
from . import Checker
from .perf import out_path, polysort, with_nemeses


def history_to_datasets(hist) -> dict:
    """node -> [[t, offset], ...], each series extended to the final
    history time (`clock.clj:13-34`)."""
    hist = list(hist)
    if not hist:
        return {}
    final_time = util.nanos_to_secs(hist[-1].get("time", 0))
    series: dict = {}
    for op in hist:
        offsets = op.get("clock-offsets")
        if not offsets:
            continue
        t = util.nanos_to_secs(op.get("time", 0))
        for node, offset in offsets.items():
            series.setdefault(node, []).append([t, offset])
    return {node: pts + [[final_time, pts[-1][1]]]
            for node, pts in series.items()}


def short_node_names(nodes) -> list[str]:
    """Strip common trailing domains: n1.foo.com, n2.foo.com -> n1, n2
    (`clock.clj:36-45`)."""
    split = [list(reversed(str(n).split("."))) for n in nodes]
    prefix = util.longest_common_prefix(split)
    n = min(len(prefix), min((len(s) for s in split), default=1) - 1) \
        if split else 0
    return [".".join(reversed(s[n:])) for s in split]


def plot(test, hist, opts=None) -> dict:
    """Render clock-skew.svg from clock-offset ops
    (`clock.clj:47-75`)."""
    hist = history(hist)
    if len(hist):
        datasets = history_to_datasets(hist)
        nodes = polysort(datasets.keys())
        names = short_node_names(nodes)
        palette = ["#cc3333", "#3366cc", "#33aa33", "#aa33aa",
                   "#cc9933", "#33aaaa"]
        p = gp.Plot(title=f"{test.get('name', '')} clock skew",
                    ylabel="Skew (s)")
        for i, (node, name) in enumerate(zip(nodes, names)):
            if datasets[node]:
                p.series.append(gp.Series(
                    title=name, data=datasets[node],
                    color=palette[i % len(palette)], mode="steps",
                    line_width=1.5))
        if gp.has_data(p):
            with_nemeses(p, hist,
                         (test.get("plot") or {}).get("nemeses"))
            gp.write(p, out_path(test, opts, "clock-skew.svg"))
    return {"valid?": True}


class ClockPlot(Checker):
    """Checker wrapper (`checker.clj:831-837`)."""

    def check(self, test, hist, opts):
        return plot(test, hist, opts)


def clock_plot() -> Checker:
    return ClockPlot()
