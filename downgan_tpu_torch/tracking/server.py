"""Tracking UI server (the port's own copy of ``downgan_tpu/tracking/server.py``,
over the port's store; reference ``DoWnGAN/mlflow_tools/mlflow_server_cmd.py``).

The reference shells out to ``mlflow server --host 0.0.0.0 -p 5555``; here a
standard-library ``http.server`` serves the local tracking store: an HTML
index of experiments and runs, per-run param and metric tables with inline
SVG sparklines, and raw artifact files. Unknown experiment or run ids, a
path that escapes a run's artifact directory and a directory request get a
404.

Run: ``python -m downgan_tpu_torch.cli serve-tracking --root experiments -p 5555``
"""
from __future__ import annotations

import html
import json
import os
from http.server import HTTPServer, SimpleHTTPRequestHandler
from urllib.parse import unquote, urlparse

from downgan_tpu_torch.tracking.store import TrackingStore

_STYLE = (
    "<style>body{font-family:sans-serif;margin:2em;color:#222}"
    "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
    "padding:4px 10px;text-align:left}a{color:#06c}</style>"
)


def _sparkline(values, width=240, height=40):
    if len(values) < 2:
        return ""
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{i * width / (len(values) - 1):.1f},"
        f"{height - (v - lo) / span * height:.1f}"
        for i, v in enumerate(values)
    )
    return (
        f'<svg width="{width}" height="{height}">'
        f'<polyline points="{pts}" fill="none" stroke="#06c" stroke-width="1.5"/></svg>'
    )


class TrackingHandler(SimpleHTTPRequestHandler):
    store: TrackingStore = None  # injected by serve()

    def log_message(self, *args) -> None:  # quiet
        pass

    def _send_html(self, body: str, code: int = 200) -> None:
        data = f"<!doctype html><html><head>{_STYLE}</head><body>{body}</body></html>".encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802
        path = unquote(urlparse(self.path).path)
        parts = [p for p in path.split("/") if p]
        store = self.store
        try:
            if not parts:
                rows = "".join(
                    f'<tr><td>{eid}</td><td><a href="/exp/{eid}">'
                    f"{html.escape(info['name'])}</a></td></tr>"
                    for eid, info in store.experiments().items()
                )
                self._send_html(
                    f"<h1>downgan-tpu tracking</h1><table>"
                    f"<tr><th>id</th><th>experiment</th></tr>{rows}</table>"
                )
            elif parts[0] == "exp" and len(parts) == 2:
                # Only registered experiment ids: a raw path component fed
                # to store.runs() would os.path.join into the filesystem
                # (e.g. /exp/.. listing the store root's parent).
                if parts[1] not in store.experiments():
                    raise KeyError(parts[1])
                rows = "".join(
                    f'<tr><td><a href="/run/{r.run_id}">{r.run_id}</a></td>'
                    f"<td>{html.escape(r.meta.get('run_name', ''))}</td>"
                    f"<td>{html.escape(str(r.meta.get('status', '')))}</td></tr>"
                    for r in store.runs(parts[1])
                )
                self._send_html(
                    f'<p><a href="/">&larr; experiments</a></p><h1>experiment '
                    f"{html.escape(parts[1])}</h1><table><tr><th>run</th>"
                    f"<th>name</th><th>status</th></tr>{rows}</table>"
                )
            elif parts[0] == "run" and len(parts) == 2:
                run = store.get_run(parts[1])
                params = "".join(
                    f"<tr><td>{html.escape(str(k))}</td>"
                    f"<td>{html.escape(str(v))}</td></tr>"
                    for k, v in sorted(run.params.items())
                )
                metrics = ""
                for name in run.metric_names:
                    hist = run.metric_history(name)
                    vals = [h["value"] for h in hist]
                    last = f"{vals[-1]:.6g}" if vals else "-"
                    metrics += (
                        f"<tr><td>{html.escape(name)}</td><td>{last}</td>"
                        f"<td>{_sparkline(vals)}</td>"
                        f'<td><a href="/metric/{run.run_id}/{name}">csv</a></td></tr>'
                    )
                arts = ""
                for dirpath, _, files in os.walk(run.artifact_dir):
                    for fn in sorted(files):
                        rel = os.path.relpath(os.path.join(dirpath, fn), run.artifact_dir)
                        arts += f'<li><a href="/artifact/{run.run_id}/{rel}">{html.escape(rel)}</a></li>'
                self._send_html(
                    f'<p><a href="/exp/{run.experiment_id}">&larr; runs</a></p>'
                    f"<h1>run {run.run_id}</h1><h2>params</h2><table>{params}</table>"
                    f"<h2>metrics</h2><table><tr><th>metric</th><th>last</th>"
                    f"<th>history</th><th></th></tr>{metrics}</table>"
                    f"<h2>artifacts</h2><ul>{arts}</ul>"
                )
            elif parts[0] == "metric" and len(parts) == 3:
                run = store.get_run(parts[1])
                data = json.dumps(run.metric_history(parts[2])).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif parts[0] == "artifact" and len(parts) >= 3:
                run = store.get_run(parts[1])
                fpath = os.path.join(run.artifact_dir, *parts[2:])
                real_fpath = os.path.realpath(fpath)
                real_root = os.path.realpath(run.artifact_dir)
                # commonpath (not startswith) so a sibling like
                # <run>/artifacts_evil cannot pass a prefix check.
                if os.path.commonpath([real_fpath, real_root]) != real_root:
                    raise KeyError("path escape")
                # Stream, do not slurp: artifact dirs hold multi-GB
                # checkpoint files; f.read() of one could OOM the server.
                with open(fpath, "rb") as f:
                    size = os.fstat(f.fileno()).st_size
                    self.send_response(200)
                    self.send_header("Content-Type", self.guess_type(fpath))
                    self.send_header("Content-Length", str(size))
                    self.end_headers()
                    # Past this point the 200 status line is on the wire: a
                    # read error mid-stream (file rewritten concurrently, EIO)
                    # must NOT fall into the 404 handler below — that would
                    # inject an HTTP response into the declared body. Drop
                    # the connection instead so the client sees truncation.
                    # Copy AT MOST the declared size: training appends to
                    # live artifacts (CSVs, logs), and surplus bytes past
                    # Content-Length would be parsed by a keep-alive client
                    # as the start of the next response.
                    try:
                        left = size
                        while left > 0:
                            chunk = f.read(min(left, 1 << 20))
                            if not chunk:
                                # File shrank mid-stream (rewritten): the
                                # declared length can't be honored — drop.
                                self.close_connection = True
                                return
                            self.wfile.write(chunk)
                            left -= len(chunk)
                    except OSError:
                        self.close_connection = True
                        return
            else:
                self._send_html("<h1>404</h1>", 404)
        # OSError covers IsADirectoryError/PermissionError on the artifact
        # open — answer 404, don't kill the handler thread mid-connection.
        # (Errors after headers are sent are handled in-branch above.)
        except (KeyError, OSError):
            try:
                self._send_html("<h1>404</h1>", 404)
            except OSError:
                pass  # client gone (e.g. pipe broke mid-stream)


def serve(root: str, host: str = "0.0.0.0", port: int = 5555) -> HTTPServer:
    handler = type("Handler", (TrackingHandler,), {"store": TrackingStore(root)})
    server = HTTPServer((host, port), handler)
    return server
