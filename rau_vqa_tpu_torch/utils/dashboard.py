"""Live training dashboard (stdlib HTTP), host only.

The port's counterpart of ``rau_vqa_tpu/utils/dashboard.py`` (:1-170), the
parity piece for the reference's `display` live-plot server
(Ours_SS/...lua:743-746, 793-822): a zero-dependency web page over a run
directory with inline-SVG sparklines of the JSONL metrics, the latest train
and test records, an attention browser over the ``--visatt`` PNGs and the
rendered curves (where matplotlib is installed).  Its page is the JAX
package's, byte for byte, for the same run directory.

    python -m rau_vqa_tpu_torch.cli dashboard --workdir <run dir> [--port 8000]
"""

from __future__ import annotations

import html
import os
import sys
from http.server import BaseHTTPRequestHandler, HTTPServer


def _sparkline(values, *, width: int = 260, height: int = 48,
               color: str = "#06c") -> str:
    """Inline SVG sparkline — curve rendering with zero dependencies
    (matplotlib only backs the optional PNG curves)."""
    vals = [float(v) for v in values
            if isinstance(v, (int, float)) and v == v]
    if len(vals) < 2:
        return "<i>n/a</i>"
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    pts = " ".join(
        f"{i * width / (len(vals) - 1):.1f},"
        f"{height - 4 - (v - lo) / span * (height - 8):.1f}"
        for i, v in enumerate(vals))
    return (f'<svg width="{width}" height="{height}">'
            f'<polyline points="{pts}" fill="none" stroke="{color}" '
            f'stroke-width="1.5"/>'
            f'<text x="2" y="10" font-size="9">{hi:.4g}</text>'
            f'<text x="2" y="{height - 2}" font-size="9">{lo:.4g}</text>'
            f'</svg>')


def _sparkline_block(rows, n_hops: int) -> str:
    """Per-metric sparklines straight from the JSONL stream."""
    train = [r for r in rows if r.get("kind") == "train"]
    test = [r for r in rows if r.get("kind") == "test"]
    cells = []
    for label, series in (
            [("loss", [r.get("loss") for r in train]),
             ("uni_acc", [r.get("uni_acc") for r in train]),
             ("select_acc", [r.get("select_acc") for r in train]),
             ("examples/sec", [r.get("examples_per_sec") for r in train])]
            + [(f"testOE hop{h + 1:02d}",
                [r.get(f"testOEacc_{h + 1:02d}") for r in test])
               for h in range(n_hops)]):
        cells.append(f"<td><b>{html.escape(label)}</b><br>"
                     f"{_sparkline(series)}</td>")
    rows_html = "".join(f"<tr>{''.join(cells[i:i + 4])}</tr>"
                        for i in range(0, len(cells), 4))
    return f"<table>{rows_html}</table>"


def _attention_browser(workdir: str) -> str:
    """Thumbnails of the visatt attention dumps, newest epoch first.
    visatt.dump_attention_maps writes figures/epoch_XXX/hop_XXX/<qid>.png
    (per-question PNGs each epoch like the reference, :926-932), so this
    walks the nested layout and links the relative paths."""
    fig_dir = os.path.join(workdir, "figures")
    if not os.path.isdir(fig_dir):
        return "<i>no attention dumps (run with --visatt)</i>"
    rels = []
    for root, _, files in os.walk(fig_dir):
        for n in files:
            if n.endswith(".png"):
                rels.append(os.path.relpath(os.path.join(root, n), fig_dir))
    rels = sorted(rels, reverse=True)[:60]
    return "".join(
        f'<a href="/figures/{html.escape(r)}" title="{html.escape(r)}">'
        f'<img src="/figures/{html.escape(r)}" width="120" '
        f'style="margin:2px"></a>' for r in rels)


def _page(workdir: str, n_hops: int) -> str:
    from rau_vqa_tpu_torch.utils.logging import MetricsLogger

    rows = MetricsLogger(os.path.join(workdir, "training_log")).read()
    last_train = next((r for r in reversed(rows) if r.get("kind") == "train"),
                      {})
    last_test = next((r for r in reversed(rows) if r.get("kind") == "test"),
                     {})
    graphs = sorted(os.listdir(os.path.join(workdir, "graphs"))) \
        if os.path.isdir(os.path.join(workdir, "graphs")) else []
    imgs = "".join(f'<div><h4>{html.escape(g)}</h4>'
                   f'<img src="/graphs/{html.escape(g)}"></div>'
                   for g in graphs if g.endswith(".png"))
    def table(d):
        items = "".join(f"<tr><td>{html.escape(str(k))}</td>"
                        f"<td>{html.escape(f'{v:.5g}' if isinstance(v, float) else str(v))}</td></tr>"
                        for k, v in sorted(d.items()))
        return f"<table border=1 cellpadding=3>{items}</table>"
    return f"""<html><head><title>rau_vqa_tpu dashboard</title>
<meta http-equiv="refresh" content="15"></head>
<body><h2>{html.escape(workdir)}</h2>
<h3>sparklines</h3>{_sparkline_block(rows, n_hops)}
<h3>latest train record</h3>{table(last_train)}
<h3>latest test record</h3>{table(last_test)}
<h3>attention maps</h3>{_attention_browser(workdir)}
<h3>curves</h3>{imgs}
</body></html>"""


def make_handler(workdir: str, n_hops: int):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_GET(self):
            if self.path.startswith(("/graphs/", "/figures/")):
                sub = "graphs" if self.path.startswith("/graphs/") else \
                    "figures"
                # nested figure paths are legal; refuse directory escapes
                base = os.path.realpath(os.path.join(workdir, sub))
                rel = self.path.split("/", 2)[2]
                path = os.path.realpath(os.path.join(base, rel))
                if not path.startswith(base + os.sep):
                    self.send_error(403)
                    return
                if os.path.exists(path):
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    with open(path, "rb") as f:
                        self.wfile.write(f.read())
                    return
                self.send_error(404)
                return
            if self.path == "/metrics.jsonl":
                path = os.path.join(workdir, "training_log", "metrics.jsonl")
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.end_headers()
                if os.path.exists(path):
                    with open(path, "rb") as f:
                        self.wfile.write(f.read())
                return
            # render fresh curves, then the page
            from rau_vqa_tpu_torch.utils.plots import render_curves
            try:
                render_curves(os.path.join(workdir, "training_log"),
                              os.path.join(workdir, "graphs"), n_hops)
            except (OSError, ValueError) as e:   # the page still serves
                print(f"dashboard: curves not rendered: {e}", file=sys.stderr)
            body = _page(workdir, n_hops).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.end_headers()
            self.wfile.write(body)

    return Handler


def serve_dashboard(workdir: str, port: int = 8000, n_hops: int = 8) -> None:
    """Serve the dashboard over ``workdir`` until interrupted."""
    server = HTTPServer(("0.0.0.0", port), make_handler(workdir, n_hops))
    print(f"dashboard for {workdir} on http://localhost:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
