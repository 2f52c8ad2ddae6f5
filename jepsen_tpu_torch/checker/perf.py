"""Performance analysis: latency and rate graphs from histories.

Reference: `jepsen/src/jepsen/checker/perf.clj` — time-bucketing and
quantile extraction (:21-86), splitting invocations by f and completion
type (:95-125), nemesis activity regions/lines (:184-324), and the
latency point/quantile/rate graphs (:484-599). Rendering goes through
`plot` (SVG) instead of the reference's external gnuplot
binary.
"""

from __future__ import annotations

import itertools
import logging
from typing import Iterable, Optional

from .. import plot as gp
from .. import store, util
from ..history import NEMESIS, history, is_invoke
from . import Checker

log = logging.getLogger(__name__)

DEFAULT_NEMESIS_COLOR = "#cccccc"
NEMESIS_ALPHA = 0.6

TYPES = ("ok", "info", "fail")

TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}

QUANTILE_COLORS = ["red", "orange", "purple", "blue", "green", "grey"]


# -- time bucketing (`perf.clj:21-49`) --------------------------------------

def bucket_scale(dt: float, b: float) -> float:
    """Time at the midpoint of bucket number b."""
    return int(b) * dt + dt / 2


def bucket_time(dt: float, t: float) -> float:
    """Midpoint of the bucket t falls into."""
    return bucket_scale(dt, t / dt)


def buckets(dt: float, tmax: float) -> list[float]:
    """Midpoints of each bucket up to tmax."""
    out, b = [], 0
    while True:
        t = bucket_scale(dt, b)
        if t > tmax:
            return out
        out.append(t)
        b += 1


def bucket_points(dt: float, points: Iterable) -> dict:
    """{bucket-midpoint: [point, ...]}, ordered by time."""
    out: dict = {}
    for p in points:
        out.setdefault(bucket_time(dt, p[0]), []).append(p)
    return dict(sorted(out.items()))


def quantiles(qs: Iterable[float], points: Iterable[float]) -> dict:
    """{q: value-at-q} over points (`perf.clj:51-61`)."""
    s = sorted(points)
    if not s:
        return {}
    n = len(s)
    return {q: s[min(n - 1, int(n * q))] for q in qs}


def latencies_to_quantiles(dt: float, qs, points) -> dict:
    """{q: [[bucket-time, latency-at-q], ...]} (`perf.clj:63-85`)."""
    assert all(0 <= q <= 1 for q in qs)
    bucketed = [(t, quantiles(qs, [p[1] for p in ps]))
                for t, ps in bucket_points(dt, points).items()]
    return {q: [[t, qv.get(q)] for t, qv in bucketed] for q in qs}


# -- history splitting (`perf.clj:87-148`) ----------------------------------

def invokes_by_type(ops) -> dict:
    """Split invocations by their completion's type."""
    return {t: [o for o in ops
                if (o.get("completion") or {}).get("type") == t]
            for t in TYPES}


def invokes_by_f(hist) -> dict:
    out: dict = {}
    for o in hist:
        if is_invoke(o):
            out.setdefault(o.get("f"), []).append(o)
    return out


def invokes_by_f_type(hist) -> dict:
    return {f: invokes_by_type(ops) for f, ops in invokes_by_f(hist).items()}


def completions_by_f_type(hist) -> dict:
    out: dict = {}
    for o in hist:
        if not is_invoke(o):
            out.setdefault(o.get("f"), {}) \
               .setdefault(o.get("type"), []).append(o)
    return out


def rate(hist) -> dict:
    """Completion *counts* by f and type, with 'all' totals at each
    level (`perf.clj:127-141`)."""
    out: dict = {}
    for o in hist:
        if is_invoke(o):
            continue
        f, t = o.get("f"), o.get("type")
        for kf, kt in ((f, t), (f, "all"), ("all", t), ("all", "all")):
            out.setdefault(kf, {})
            out[kf][kt] = out[kf].get(kt, 0) + 1
    return out


def latency_point(op: dict) -> tuple:
    """[time-in-seconds, latency-in-ms] (`perf.clj:143-148`)."""
    return (util.nanos_to_secs(op["time"]),
            op["latency"] / 1e6)


def fs_to_points(fs) -> dict:
    """f -> point-shape index, one distinct marker per f
    (`perf.clj:150-156`)."""
    return {f: i for i, f in enumerate(fs)}


def qs_to_colors(qs) -> dict:
    """quantile -> color, highest quantile hottest
    (`perf.clj:158-172`)."""
    return dict(zip(sorted(qs, reverse=True),
                    itertools.cycle(QUANTILE_COLORS)))


def polysort(xs) -> list:
    return sorted(xs, key=lambda x: (str(type(x)), str(x)))


# -- nemesis activity (`perf.clj:184-324`) ----------------------------------

def nemesis_ops(nemeses, hist) -> list[dict]:
    """Partition the history's nemesis ops among the nemesis specs;
    unmatched ops fall into a default 'nemesis' spec
    (`perf.clj:184-216`)."""
    nemeses = list(nemeses or [])
    assert all(n.get("name") for n in nemeses)
    index = {}
    for n in nemeses:
        for f in (list(n.get("start") or ["start"]) +
                  list(n.get("stop") or ["stop"]) +
                  list(n.get("fs") or [])):
            index[f] = n["name"]
    by_name: dict = {}
    for o in hist:
        if o.get("process") == NEMESIS:
            by_name.setdefault(index.get(o.get("f")), []).append(o)
    out = [dict(n, ops=by_name[n["name"]])
           for n in nemeses if n["name"] in by_name]
    if None in by_name:
        out.append({"name": "nemesis", "ops": by_name[None]})
    return out


def nemesis_activity(nemeses, hist) -> list[dict]:
    """nemesis_ops plus [start, stop] interval pairing
    (`perf.clj:218-231`)."""
    out = []
    for n in nemesis_ops(nemeses, hist):
        start = set(n.get("start") or ["start"])
        stop = set(n.get("stop") or ["stop"])
        out.append(dict(n, intervals=util.nemesis_intervals(
            n["ops"], start_fs=start, stop_fs=stop)))
    return out


def interval_times(interval) -> tuple:
    a, b = interval
    return (util.nanos_to_secs(a["time"]),
            util.nanos_to_secs(b["time"]) if b else None)


def with_nemeses(p: gp.Plot, hist, nemeses) -> gp.Plot:
    """Add shaded activity regions, event lines, and legend entries for
    each nemesis (`perf.clj:240-324`). Each nemesis gets a twelfth of
    the graph height, stacked from the top."""
    height, padding = 0.0834, 0.00615
    for i, n in enumerate(nemesis_activity(nemeses, hist)):
        fill = n.get("fill-color") or n.get("color") or DEFAULT_NEMESIS_COLOR
        line = n.get("line-color") or n.get("color") or DEFAULT_NEMESIS_COLOR
        alpha = n.get("transparency", NEMESIS_ALPHA)
        bot = 1 - height * (i + 1)
        top = bot + height
        for iv in n["intervals"]:
            t0, t1 = interval_times(iv)
            p.regions.append(gp.Region(
                x0=t0, x1=t1, y0_frac=bot + padding, y1_frac=top - padding,
                color=fill, alpha=alpha))
        for o in n["ops"]:
            p.vlines.append(gp.VLine(
                x=util.nanos_to_secs(o["time"]), color=line,
                width=float(n.get("line-width", 1))))
        # legend entry via a dummy line series (`perf.clj:295-308`)
        p.series.append(gp.Series(title=str(n["name"]), data=[],
                                  color=fill, mode="lines", line_width=6))
    return p


# -- graphs (`perf.clj:484-599`) --------------------------------------------

def out_path(test, opts, filename: str) -> str:
    """Path for a rendered artifact, honoring opts['subdirectory'] (the
    reference's `store/path! test subdirectory file` idiom)."""
    sub = (opts or {}).get("subdirectory")
    parts = ([str(sub)] if sub else []) + [filename]
    return store.make_path(test, *parts)


def _nemeses(test, opts):
    return (opts or {}).get("nemeses") or \
        ((test.get("plot") or {}).get("nemeses"))


def point_graph(test, hist, opts=None) -> Optional[str]:
    """Raw latency scatter: one point per invocation, colored by
    completion type, marker shape by f (`perf.clj:484-511`)."""
    hist = util.history_latencies(hist)
    datasets = invokes_by_f_type(hist)
    fs = polysort(datasets.keys())
    shapes = fs_to_points(fs)
    p = gp.Plot(title=f"{test.get('name', '')} latency",
                ylabel="Latency (ms)", logscale_y=True,
                draw_fewer_on_top=True)
    for f in fs:
        for t in TYPES:
            data = datasets[f].get(t) or []
            if data:
                p.series.append(gp.Series(
                    title=f"{f} {t}", data=[latency_point(o) for o in data],
                    color=TYPE_COLORS[t], mode="points",
                    point_type=shapes[f]))
    with_nemeses(p, hist, _nemeses(test, opts))
    return gp.write(p, out_path(test, opts, "latency-raw.svg"))


NICE_DTS = (1, 2, 5, 10, 30, 60, 120, 300, 600, 1800, 3600)


def adaptive_dt(hist, target_buckets: int = 60,
                t_max: float | None = None) -> float:
    """Bucket width giving ~target_buckets windows over the history's
    duration, snapped to a human-friendly step.  Fixed 30 s windows (the
    reference's default) flatten a one-minute test into two points and
    oversample a day-long soak; adapting to point density is its
    plan.md "adaptive temporal resolution" item.  Pass t_max (seconds)
    when the caller already scanned the history for it."""
    if t_max is None:
        t_max = util.nanos_to_secs(max((o.get("time", 0) for o in hist),
                                       default=0))
    want = t_max / max(target_buckets, 1)
    for dt in NICE_DTS:
        if dt >= want:
            return dt
    return NICE_DTS[-1]


def quantiles_graph(test, hist, opts=None, dt: float | None = None,
                    qs=(0.5, 0.95, 0.99, 1)) -> Optional[str]:
    """Latency quantiles per f over dt-second windows
    (`perf.clj:513-550`); dt=None picks an adaptive width."""
    hist = util.history_latencies(hist)
    if dt is None:
        dt = adaptive_dt(hist)
    colors = qs_to_colors(qs)
    datasets = {
        f: latencies_to_quantiles(dt, qs, [latency_point(o) for o in ops
                                           if "latency" in o])
        for f, ops in invokes_by_f(hist).items()}
    fs = polysort(datasets.keys())
    shapes = fs_to_points(fs)
    p = gp.Plot(title=f"{test.get('name', '')} latency",
                ylabel="Latency (ms)", logscale_y=True)
    for f in fs:
        for q in qs:
            data = [d for d in datasets[f].get(q, []) if d[1] is not None]
            if data:
                p.series.append(gp.Series(
                    title=f"{f} {q}", data=data, color=colors[q],
                    mode="linespoints", point_type=shapes[f]))
    with_nemeses(p, hist, _nemeses(test, opts))
    return gp.write(p, out_path(test, opts, "latency-quantiles.svg"))


def rate_graph(test, hist, opts=None, dt: float | None = None
               ) -> Optional[str]:
    """Completion rate (hz) by f and type over dt-second buckets;
    nemesis completions are excluded (`perf.clj:559-599`).  dt=None
    picks an adaptive width."""
    hist = history(hist)
    t_max = util.nanos_to_secs(max((o.get("time", 0) for o in hist),
                                   default=0))
    if dt is None:
        dt = adaptive_dt(hist, t_max=t_max)
    datasets: dict = {}
    for o in hist:
        if is_invoke(o) or not isinstance(o.get("process"), int):
            continue
        b = bucket_time(dt, util.nanos_to_secs(o["time"]))
        d = datasets.setdefault(o.get("f"), {}).setdefault(o.get("type"), {})
        d[b] = d.get(b, 0) + 1.0 / dt
    fs = polysort(datasets.keys())
    shapes = fs_to_points(fs)
    bs = buckets(dt, t_max)
    p = gp.Plot(title=f"{test.get('name', '')} rate",
                ylabel="Throughput (hz)")
    for f in fs:
        for t in TYPES:
            m = datasets[f].get(t)
            if m:
                p.series.append(gp.Series(
                    title=f"{f} {t}",
                    data=[(b, m.get(b, 0)) for b in bs],
                    color=TYPE_COLORS[t], mode="linespoints",
                    point_type=shapes[f]))
    with_nemeses(p, hist, _nemeses(test, opts))
    return gp.write(p, out_path(test, opts, "rate.svg"))


# -- checkers (`checker.clj:797-829`) ---------------------------------------

class LatencyGraph(Checker):
    """Renders raw + quantile latency graphs (`checker.clj:797-808`)."""

    def check(self, test, hist, opts):
        point_graph(test, hist, opts)
        quantiles_graph(test, hist, opts)
        return {"valid?": True}


def latency_graph() -> Checker:
    return LatencyGraph()


class RateGraph(Checker):
    """Renders the rate graph (`checker.clj:810-820`)."""

    def check(self, test, hist, opts):
        rate_graph(test, hist, opts)
        return {"valid?": True}


def rate_graph_checker() -> Checker:
    return RateGraph()


def perf_checker() -> Checker:
    """Composes latency and rate graphs (`checker.clj:822-829`)."""
    from . import compose
    return compose({"latency-graph": latency_graph(),
                    "rate-graph": rate_graph_checker()})
