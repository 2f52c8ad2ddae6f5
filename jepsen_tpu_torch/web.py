"""Web server frontend for browsing test results.

Reference: `jepsen/src/jepsen/web.clj` — a home page tabulating every
stored run with validity-colored cells (:25-135), a directory/file
browser with content types (:136-352), and whole-run zip downloads
(:253-311). Ring/http-kit become the standard library's threading HTTP
server; the route structure (`/` and `/files/...`, `<run>.zip`) is
preserved so bookmarks from the reference work unchanged.
"""

from __future__ import annotations

import html
import io
import json
import logging
import mimetypes
import os
import threading
import urllib.parse
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import store, telemetry

log = logging.getLogger(__name__)

_M_REQUESTS = telemetry.counter(
    "jepsen_tpu_web_requests_total",
    "Results-web requests by route", ("route",))

COLORS = {"ok": "#6DB6FE", "info": "#FFAA26", "fail": "#FEB5DA",
          None: "#eaeaea"}

VALID_COLOR = {True: COLORS["ok"], "unknown": COLORS["info"],
               False: COLORS["fail"]}


def valid_color(valid) -> str:
    return VALID_COLOR.get(valid, COLORS[None])


def url_encode_path_components(p: str) -> str:
    """URL-encode individual path components, leaving / alone
    (`web.clj:41-45`)."""
    return "/".join(urllib.parse.quote(c) for c in p.split("/"))


def fast_tests(base: str) -> list[dict]:
    """Abbreviated test maps: name, start-time, results (or
    {'valid?': 'incomplete'} for unparsable/unfinished runs)
    (`web.clj:47-68`)."""
    out = []
    for name, runs in store.tests(base).items():
        for t, d in runs.items():
            entry = {"name": name, "start-time": t, "dir": d}
            try:
                with open(os.path.join(d, "results.json")) as f:
                    entry["results"] = json.load(f)
            except (OSError, ValueError):
                entry["results"] = {"valid?": "incomplete"}
                # an unfinished run a verification service touched:
                # surface what the service left behind — a deferred
                # (shed) marker, a resume manifest from a drain, or
                # already-streamed verdicts awaiting analyze
                try:
                    sr = store.load_streamed_results(d)
                except (OSError, ValueError):
                    sr = None
                if isinstance(sr, dict) and sr.get("deferred"):
                    entry["results"]["service"] = "deferred"
                elif os.path.exists(os.path.join(
                        d, store.SERVICE_SUBDIR, "resume.json")):
                    entry["results"]["service"] = "drained"
                elif sr:
                    entry["results"]["service"] = "streamed"
            out.append(entry)
    return out


def _file_url(*components) -> str:
    return url_encode_path_components(
        "/files/" + "/".join(str(c) for c in components if c != ""))


def recovery_note(r: dict) -> str:
    """Validity-cell suffix when any checker result in the map carries
    a device-fault or tier-1 trail: '(degraded)' lost a verdict to
    backend faults, '(recovered)' faulted but resumed to a full
    verdict, '(escalated)' the tier-1 screen triggered a full check,
    '(screened)' the verdict came from the O(n) screen alone. Older
    stored results without these fields get no suffix."""
    subs = [r] + [v for v in r.values() if isinstance(v, dict)]
    if any(s.get("degraded") for s in subs):
        return " (degraded)"
    # dict-typed only: workload checkers reuse 'recovered' for their
    # own payloads (e.g. the set checker's recovered-element string)
    if any(isinstance(s.get("recovered"), dict) for s in subs):
        return " (recovered)"
    if any(isinstance(s.get("escalated"), dict) for s in subs):
        return " (escalated)"
    if any(s.get("screened") for s in subs):
        return " (screened)"
    # verification-service outcomes on not-yet-analyzed runs:
    # shed ('deferred' — analyze covers from the journal), drained
    # (a resume manifest awaits a restarted service), or streamed
    # verdicts awaiting adoption
    if r.get("service"):
        return f" (service: {r['service']})"
    return ""


def test_row(t: dict) -> str:
    r = t.get("results") or {}
    u = _file_url(t["name"], t["start-time"])
    valid = r.get("valid?")
    return (
        "<tr>"
        f'<td><a href="{u}">{html.escape(t["name"])}</a></td>'
        f'<td><a href="{u}">{html.escape(t["start-time"])}</a></td>'
        f'<td style="background: {valid_color(valid)}">'
        f'{html.escape(str(valid) + recovery_note(r))}</td>'
        f'<td><a href="{u}/results.json">results.json</a></td>'
        f'<td><a href="{u}/history.jsonl.gz">history</a></td>'
        f'<td><a href="{u}/jepsen.log">jepsen.log</a></td>'
        f'<td><a href="{u}.zip">zip</a></td>'
        "</tr>")


SORT_KEYS = {
    "name": lambda t: t["name"],
    "time": lambda t: t["start-time"],
    "valid": lambda t: str((t.get("results") or {}).get("valid?")),
}


def select_tests(tests: list[dict], params: dict) -> list[dict]:
    """Search/filter/sort the home-page rows (the reference's plan.md
    wants exactly these: search, sorting, filtering).

    params: q (substring match on name), valid (true/false/unknown/
    incomplete), sort (name|time|valid), dir (asc|desc)."""
    q = (params.get("q") or "").strip().lower()
    if q:
        tests = [t for t in tests if q in t["name"].lower()]
    want = (params.get("valid") or "").strip().lower()
    if want:
        tests = [
            t for t in tests
            if str((t.get("results") or {}).get("valid?")).lower() == want]
    key = SORT_KEYS.get(params.get("sort") or "time", SORT_KEYS["time"])
    default_desc = (params.get("sort") or "time") == "time"
    desc = {"asc": False, "desc": True}.get(
        (params.get("dir") or "").lower(), default_desc)
    return sorted(tests, key=key, reverse=desc)


def _sort_link(col: str, params: dict) -> str:
    cur = params.get("sort") or "time"
    cur_desc = (params.get("dir") or
                ("desc" if cur == "time" else "asc")) == "desc"
    nxt = "asc" if (col != cur or cur_desc) else "desc"
    qs = urllib.parse.urlencode(
        {k: v for k, v in {**params, "sort": col, "dir": nxt}.items()
         if v})
    arrow = (" ▼" if cur_desc else " ▲") if col == cur else ""
    return f'<a href="/?{qs}">{col.capitalize()}{arrow}</a>'


def home_page(base: str, params: dict | None = None) -> str:
    params = params or {}
    rows = select_tests(fast_tests(base), params)
    q = html.escape(params.get("q") or "", quote=True)
    valid = params.get("valid") or ""
    options = "".join(
        f'<option value="{v}"{" selected" if v == valid else ""}>'
        f"{label}</option>"
        for v, label in [("", "any validity"), ("true", "valid"),
                         ("false", "invalid"), ("unknown", "unknown"),
                         ("incomplete", "incomplete")])
    return (
        "<html><body><h1>Jepsen</h1>"
        '<p><a href="/metrics">metrics</a> (process telemetry, '
        "Prometheus text)</p>"
        '<form method="get" action="/">'
        f'<input type="text" name="q" value="{q}" '
        'placeholder="search test names">'
        f'<select name="valid">{options}</select>'
        '<input type="submit" value="filter">'
        "</form>"
        '<table cellspacing="3" cellpadding="3"><thead><tr>'
        f"<th>{_sort_link('name', params)}</th>"
        f"<th>{_sort_link('time', params)}</th>"
        f"<th>{_sort_link('valid', params)}</th><th>Results</th>"
        "<th>History</th><th>Log</th><th>Zip</th></tr></thead><tbody>"
        + "".join(test_row(t) for t in rows)
        + f"</tbody></table><p>{len(rows)} run(s)</p></body></html>")


def dir_listing(base: str, rel: str, full: str) -> str:
    """Directory browser page (`web.clj:136-250`). Directories holding a
    results.json get a validity-colored cell."""
    items = []
    for name in sorted(os.listdir(full)):
        p = os.path.join(full, name)
        u = _file_url(*(rel.split("/") if rel else []), name)
        if os.path.isdir(p):
            valid = None
            try:
                with open(os.path.join(p, "results.json")) as f:
                    valid = json.load(f).get("valid?")
                style = f' style="background: {valid_color(valid)}"'
            except (OSError, ValueError):
                style = ""
            items.append(f'<tr><td{style}><a href="{u}">{html.escape(name)}'
                         f"/</a></td></tr>")
        else:
            size = os.path.getsize(p)
            items.append(f'<tr><td><a href="{u}">{html.escape(name)}</a> '
                         f"({size} bytes)</td></tr>")
    up = _file_url(*(rel.split("/")[:-1] if rel else []))
    return ("<html><body>"
            f'<h1>{html.escape("/" + rel)}</h1>'
            f'<p><a href="/">home</a> | <a href="{up}">up</a> | '
            f'<a href="{_file_url(rel).rstrip("/")}.zip">zip</a></p>'
            f"<table>{''.join(items)}</table></body></html>")


def content_type(path: str) -> str:
    """Content types for store artifacts (`web.clj:312-324`)."""
    if path.endswith(".log") or path.endswith(".jsonl"):
        return "text/plain"
    if path.endswith(".svg"):
        return "image/svg+xml"
    guess, enc = mimetypes.guess_type(path)
    if enc == "gzip":
        return "application/gzip"
    return guess or "application/octet-stream"


def zip_dir(full: str) -> bytes:
    """Zip a run directory into memory (`web.clj:253-311`)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, _dirs, files in os.walk(full):
            for f in files:
                p = os.path.join(root, f)
                z.write(p, os.path.relpath(p, os.path.dirname(full)))
    return buf.getvalue()


class Handler(BaseHTTPRequestHandler):
    base = store.DEFAULT_BASE

    def log_message(self, fmt, *args):  # route through logging, not stderr
        log.debug("web: " + fmt, *args)

    def _send(self, code: int, body: bytes, ctype: str = "text/html"):
        self.send_response(code)
        if ctype.startswith("text/") and "charset" not in ctype:
            # explicit utf-8: the reference serves latin-1-ish bytes
            # and its plan.md wants this fixed
            ctype += "; charset=utf-8"
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _resolve(self, rel: str) -> str | None:
        """Resolve a /files/ path inside the store, refusing traversal
        outside it."""
        full = os.path.realpath(os.path.join(self.base, rel))
        root = os.path.realpath(self.base)
        if full != root and not full.startswith(root + os.sep):
            return None
        return full

    def do_GET(self):  # noqa: N802 — http.server API
        split = urllib.parse.urlsplit(self.path)
        path = urllib.parse.unquote(split.path)
        if path in ("/", ""):
            _M_REQUESTS.labels(route="home").inc()
            params = {k: v[0]
                      for k, v in urllib.parse.parse_qs(split.query).items()}
            return self._send(
                200, home_page(self.base, params).encode())
        if path == "/metrics":
            # the process-wide registry snapshot: when analyze/serve
            # run in this process, its chunk/engine/recovery series
            # are scrapeable straight off the results UI
            _M_REQUESTS.labels(route="metrics").inc()
            return self._send(
                200, telemetry.prometheus_text().encode(),
                "text/plain; version=0.0.4")
        if path.startswith("/files"):
            _M_REQUESTS.labels(route="files").inc()
            rel = path[len("/files"):].strip("/")
            if rel.endswith(".zip"):
                full = self._resolve(rel[:-len(".zip")])
                if full and os.path.isdir(full):
                    return self._send(200, zip_dir(full), "application/zip")
            full = self._resolve(rel)
            if full is None:
                return self._send(403, b"forbidden", "text/plain")
            if os.path.isdir(full):
                return self._send(
                    200, dir_listing(self.base, rel, full).encode())
            if os.path.isfile(full):
                with open(full, "rb") as f:
                    return self._send(200, f.read(), content_type(full))
        return self._send(404, b"not found", "text/plain")


def serve(options: dict | None = None) -> ThreadingHTTPServer:
    """Start the web server in a daemon thread; returns the server
    (`web.clj:361-366`). Options: host, port, store-dir."""
    options = options or {}
    handler = type("BoundHandler", (Handler,),
                   {"base": options.get("store-dir", store.DEFAULT_BASE)})
    server = ThreadingHTTPServer(
        (options.get("host", "0.0.0.0"), int(options.get("port", 8080))),
        handler)
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         name="jepsen web")
    t.start()
    return server
