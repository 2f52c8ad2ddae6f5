"""Dependency-free SVG plotting, standing in for gnuplot.

The reference shells out to an external native gnuplot binary for every
performance/clock graph (`jepsen/src/jepsen/checker/perf.clj:417-482`);
this environment has neither gnuplot nor matplotlib, so we render the
same plot model — series with point/line styles, log y scales, shaded
nemesis regions, vertical event lines, an outside legend — directly to
SVG, which the store's web browser serves natively.

The plot maps mirror the reference's gnuplot option maps: a Plot has
series/xrange/yrange/logscale, `broaden_range` mirrors
`perf.clj:334-357`, and `with_range` fills ranges from data the same
way (`perf.clj:370-394`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence
from xml.sax.saxutils import escape

# canvas geometry (reference: `set term png size 900,400`)
WIDTH = 900
HEIGHT = 400
# past this many points a series renders translucent, so overplotted
# regions read as density
DENSE_POINTS = 1500
DENSE_ALPHA = 0.35
MARGIN_L = 72
MARGIN_R = 168   # legend lives here ("set key outside top right")
MARGIN_T = 34
MARGIN_B = 48

POINT_SHAPES = ("circle", "square", "triangle", "diamond", "cross", "plus")


class NoPoints(Exception):
    """Raised when a plot has no data at all (reference ::no-points)."""


# qualitative series palette (Tol bright), cycled by per-process plots
PALETTE = ("#4477aa", "#ee6677", "#228833", "#ccbb44",
           "#66ccee", "#aa3377")


def merged_windows(s: int, points: list) -> list:
    """[lower, upper] windows of s elements around each point, with
    overlapping windows merged (the reference's merged-windows,
    `sequential.clj:139-158` / `monotonic.clj:242-263`; touching
    windows stay separate, as there)."""
    if not points:
        return []
    points = sorted(points)
    windows = []
    lower, upper = points[0] - s, points[0] + s
    for p in points[1:]:
        if upper <= p - s:
            windows.append([lower, upper])
            lower = p - s
        upper = p + s
    windows.append([lower, upper])
    return windows


def regression_spots(pairs: list, global_too: bool = False) -> list:
    """Indices where a value regresses, given (process, value) pairs in
    plot order: per-process decreases, plus — when global_too —
    decreases between consecutive pairs regardless of process (the two
    anomaly shapes the sequential/timestamp-value checkers flag)."""
    last: dict = {}
    prev = None
    spots = []
    for i, (p, v) in enumerate(pairs):
        pv = last.get(p)
        if (pv is not None and v < pv) or \
                (global_too and prev is not None and v < prev):
            spots.append(i)
        last[p] = v
        prev = v
    return spots


def process_series(by_process: dict) -> list:
    """One linespoints Series per process, palette-cycled — the shared
    shape of the per-process value plots (dgraph sequential, faunadb
    timestamp-value)."""
    return [Series(title=str(p), data=pts, mode="linespoints",
                   color=PALETTE[i % len(PALETTE)])
            for i, (p, pts) in enumerate(sorted(by_process.items()))]


@dataclass
class Series:
    title: Optional[str]
    data: Sequence  # [(x, y), ...]
    color: str = "#4477aa"
    mode: str = "points"  # points | lines | linespoints | steps
    point_type: int = 0   # index into POINT_SHAPES
    line_width: float = 1.0


@dataclass
class Region:
    """A shaded vertical band: x in [x0, x1] (x1 None = plot edge),
    y given as graph fractions (0 bottom, 1 top)."""
    x0: float
    x1: Optional[float]
    y0_frac: float = 0.0
    y1_frac: float = 1.0
    color: str = "#cccccc"
    alpha: float = 0.6


@dataclass
class VLine:
    x: float
    color: str = "#cccccc"
    width: float = 1.0


@dataclass
class Plot:
    title: str = ""
    xlabel: str = "Time (s)"
    ylabel: str = ""
    series: list = field(default_factory=list)
    regions: list = field(default_factory=list)
    vlines: list = field(default_factory=list)
    logscale_y: bool = False
    xrange: Optional[tuple] = None
    yrange: Optional[tuple] = None
    draw_fewer_on_top: bool = False
    width: int = WIDTH
    height: int = HEIGHT


def broaden_range(rng: tuple) -> tuple:
    """Expand [lo, hi] slightly to land on integral boundaries
    (`perf.clj:334-357`)."""
    a, b = rng
    if a == b:
        return (a - 1, a + 1)
    size = abs(float(b) - float(a))
    grid = size / 10
    scale = 10 ** round(math.log10(grid))
    a2 = a - (a % scale)
    m = b % scale
    b2 = b if (m / scale) < 0.001 else scale + (b - m)
    return (min(a, a2), max(b, b2))


def has_data(plot: Plot) -> bool:
    return any(len(s.data) for s in plot.series)


def without_empty_series(plot: Plot) -> Plot:
    plot.series = [s for s in plot.series if len(s.data)]
    return plot


def with_range(plot: Plot) -> Plot:
    """Fill missing x/y ranges from the series data
    (`perf.clj:370-394`)."""
    data = [p for s in plot.series for p in s.data]
    if not data:
        raise NoPoints()
    xs = [p[0] for p in data]
    ys = [p[1] for p in data]
    if plot.logscale_y:
        # nonpositive values can't be drawn on a log scale; gnuplot
        # drops them, and including them in the range would stretch the
        # axis across a dozen useless decades
        ys = [y for y in ys if y > 0]
        if not ys:
            raise NoPoints()
    if plot.xrange is None:
        plot.xrange = broaden_range((min(xs), max(xs)))
    if plot.yrange is None:
        lo, hi = min(ys), max(ys)
        # log plots aren't broadened — that would push the floor to <= 0
        plot.yrange = (lo, hi) if plot.logscale_y \
            else broaden_range((lo, hi))
    return plot


def _nice_ticks(lo: float, hi: float, n: int = 6) -> list[float]:
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / n
    mag = 10 ** math.floor(math.log10(raw))
    for mult in (1, 2, 2.5, 5, 10):
        if raw <= mult * mag:
            step = mult * mag
            break
    first = math.ceil(lo / step) * step
    ticks, t = [], first
    while t <= hi + step * 1e-9:
        ticks.append(round(t, 10))
        t += step
    return ticks


def _log_ticks(lo: float, hi: float) -> list[float]:
    lo = max(lo, 1e-12)
    ticks = []
    e = math.floor(math.log10(lo))
    while 10 ** e <= hi * (1 + 1e-9):
        if 10 ** e >= lo * (1 - 1e-9):
            ticks.append(10 ** e)
        e += 1
    return ticks or [lo, hi]


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1e5 or a < 1e-3:
        return f"{v:.0e}"
    if a >= 100 or float(v).is_integer():
        return f"{v:.0f}"
    if a >= 1:
        return f"{v:g}"
    return f"{v:.3g}"


def _marker(shape: str, x: float, y: float, r: float, color: str) -> str:
    if shape == "circle":
        return (f'<circle cx="{x:.1f}" cy="{y:.1f}" r="{r}" '
                f'fill="{color}"/>')
    if shape == "square":
        return (f'<rect x="{x - r:.1f}" y="{y - r:.1f}" width="{2 * r}" '
                f'height="{2 * r}" fill="{color}"/>')
    if shape == "triangle":
        pts = f"{x:.1f},{y - r:.1f} {x - r:.1f},{y + r:.1f} " \
              f"{x + r:.1f},{y + r:.1f}"
        return f'<polygon points="{pts}" fill="{color}"/>'
    if shape == "diamond":
        pts = f"{x:.1f},{y - r:.1f} {x + r:.1f},{y:.1f} " \
              f"{x:.1f},{y + r:.1f} {x - r:.1f},{y:.1f}"
        return f'<polygon points="{pts}" fill="{color}"/>'
    if shape == "cross":
        return (f'<path d="M{x - r:.1f} {y - r:.1f}L{x + r:.1f} {y + r:.1f}'
                f'M{x - r:.1f} {y + r:.1f}L{x + r:.1f} {y - r:.1f}" '
                f'stroke="{color}" stroke-width="1.2" fill="none"/>')
    return (f'<path d="M{x - r:.1f} {y:.1f}L{x + r:.1f} {y:.1f}'
            f'M{x:.1f} {y - r:.1f}L{x:.1f} {y + r:.1f}" '
            f'stroke="{color}" stroke-width="1.2" fill="none"/>')


def render(plot: Plot) -> str:
    """Render a Plot to an SVG document string."""
    plot = with_range(plot)
    x0p, x1p = MARGIN_L, plot.width - MARGIN_R
    y0p, y1p = plot.height - MARGIN_B, MARGIN_T
    xmin, xmax = plot.xrange
    ymin, ymax = plot.yrange
    if xmax == xmin:
        xmax = xmin + 1
    if plot.logscale_y:
        ymin = max(ymin, 1e-12)
        if ymax <= ymin:
            ymax = ymin * 10
        lymin, lymax = math.log10(ymin), math.log10(ymax)
        if lymax == lymin:
            lymax += 1

        def ty(y):
            y = max(y, 1e-12)
            return y0p + (math.log10(y) - lymin) / (lymax - lymin) \
                * (y1p - y0p)
        yticks = _log_ticks(ymin, ymax)
    else:
        if ymax == ymin:
            ymax = ymin + 1

        def ty(y):
            return y0p + (y - ymin) / (ymax - ymin) * (y1p - y0p)
        yticks = _nice_ticks(ymin, ymax)

    def tx(x):
        return x0p + (x - xmin) / (xmax - xmin) * (x1p - x0p)

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" '
           f'width="{plot.width}" height="{plot.height}" '
           f'viewBox="0 0 {plot.width} {plot.height}" '
           f'font-family="sans-serif" font-size="11">',
           f'<rect width="{plot.width}" height="{plot.height}" '
           f'fill="white"/>']

    # shaded regions + vlines go under the data, clipped to the frame
    out.append(f'<clipPath id="frame"><rect x="{x0p}" y="{y1p}" '
               f'width="{x1p - x0p}" height="{y0p - y1p}"/></clipPath>')
    out.append('<g clip-path="url(#frame)">')
    for rg in plot.regions:
        rx0 = tx(max(rg.x0, xmin))
        rx1 = tx(min(rg.x1, xmax)) if rg.x1 is not None else x1p
        ry1 = y0p + rg.y1_frac * (y1p - y0p)
        ry0 = y0p + rg.y0_frac * (y1p - y0p)
        out.append(f'<rect x="{rx0:.1f}" y="{ry1:.1f}" '
                   f'width="{max(rx1 - rx0, 0.5):.1f}" '
                   f'height="{abs(ry0 - ry1):.1f}" fill="{rg.color}" '
                   f'opacity="{rg.alpha}"/>')
    for vl in plot.vlines:
        if xmin <= vl.x <= xmax:
            vx = tx(vl.x)
            out.append(f'<line x1="{vx:.1f}" y1="{y0p}" x2="{vx:.1f}" '
                       f'y2="{y1p}" stroke="{vl.color}" '
                       f'stroke-width="{vl.width}"/>')
    out.append('</g>')

    # grid + axes + ticks
    for t in _nice_ticks(xmin, xmax):
        px = tx(t)
        out.append(f'<line x1="{px:.1f}" y1="{y0p}" x2="{px:.1f}" '
                   f'y2="{y1p}" stroke="#eeeeee"/>')
        out.append(f'<text x="{px:.1f}" y="{y0p + 16}" '
                   f'text-anchor="middle">{_fmt(t)}</text>')
    for t in yticks:
        py = ty(t)
        out.append(f'<line x1="{x0p}" y1="{py:.1f}" x2="{x1p}" '
                   f'y2="{py:.1f}" stroke="#eeeeee"/>')
        out.append(f'<text x="{x0p - 6}" y="{py + 4:.1f}" '
                   f'text-anchor="end">{_fmt(t)}</text>')
    out.append(f'<rect x="{x0p}" y="{y1p}" width="{x1p - x0p}" '
               f'height="{y0p - y1p}" fill="none" stroke="#333333"/>')

    # axis labels + title
    out.append(f'<text x="{(x0p + x1p) / 2:.0f}" y="{plot.height - 10}" '
               f'text-anchor="middle">{escape(plot.xlabel)}</text>')
    if plot.ylabel:
        out.append(f'<text x="16" y="{(y0p + y1p) / 2:.0f}" '
                   f'text-anchor="middle" transform="rotate(-90 16 '
                   f'{(y0p + y1p) / 2:.0f})">{escape(plot.ylabel)}</text>')
    if plot.title:
        out.append(f'<text x="{(x0p + x1p) / 2:.0f}" y="20" '
                   f'text-anchor="middle" font-size="14">'
                   f'{escape(plot.title)}</text>')

    # series, clipped to the frame; optionally densest-first so sparse
    # series stay visible (`perf.clj:441-457` draw-fewer-on-top)
    series = list(plot.series)
    if plot.draw_fewer_on_top:
        series = sorted(series, key=lambda s: -len(s.data))
    out.append('<g clip-path="url(#frame)">')
    for s in series:
        pts = [(tx(x), ty(y)) for x, y in s.data
               if y is not None and not (plot.logscale_y and y <= 0)]
        if not pts:
            continue
        shape = POINT_SHAPES[s.point_type % len(POINT_SHAPES)]
        if s.mode in ("lines", "linespoints", "steps"):
            d = [f"M{pts[0][0]:.1f} {pts[0][1]:.1f}"]
            for (px0, py0), (px1, py1) in zip(pts, pts[1:]):
                if s.mode == "steps":
                    d.append(f"L{px1:.1f} {py0:.1f}")
                d.append(f"L{px1:.1f} {py1:.1f}")
            out.append(f'<path d="{"".join(d)}" stroke="{s.color}" '
                       f'stroke-width="{s.line_width}" fill="none"/>')
        if s.mode in ("points", "linespoints"):
            r = 2.4 if s.mode == "points" else 2.8
            if len(pts) > DENSE_POINTS:
                # dense clouds: PER-MARKER translucency, so overlapping
                # points darken each other and overplotted regions read
                # as density (the reference wants this, its plan.md
                # "make points somewhat transparent"). Group-level
                # opacity would composite the layer as one unit and
                # flatten the overlaps.
                out.append(f'<g fill-opacity="{DENSE_ALPHA}" '
                           f'stroke-opacity="{DENSE_ALPHA}">')
                out.extend(_marker(shape, px, py, r, s.color)
                           for px, py in pts)
                out.append('</g>')
            else:
                out.extend(_marker(shape, px, py, r, s.color)
                           for px, py in pts)
    out.append('</g>')

    # legend, outside top right
    lx, ly = x1p + 10, y1p + 4
    entries = [s for s in plot.series if s.title]
    for i, s in enumerate(entries):
        py = ly + i * 16
        shape = POINT_SHAPES[s.point_type % len(POINT_SHAPES)]
        if s.mode in ("lines", "steps"):
            out.append(f'<line x1="{lx}" y1="{py + 4}" x2="{lx + 14}" '
                       f'y2="{py + 4}" stroke="{s.color}" '
                       f'stroke-width="{max(s.line_width, 2)}"/>')
        else:
            out.append(_marker(shape, lx + 7, py + 4, 3, s.color))
        out.append(f'<text x="{lx + 20}" y="{py + 8}">'
                   f'{escape(str(s.title))}</text>')
    out.append('</svg>')
    return "\n".join(out)


def write(plot: Plot, path: str) -> str:
    """Render a plot to an SVG file; returns the path, or None when the
    plot has no data (the reference's :no-points outcome)."""
    try:
        svg = render(plot)
    except NoPoints:
        return None
    with open(path, "w") as f:
        f.write(svg)
    return path
