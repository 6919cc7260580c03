"""UI web server (reference `deeplearning4j-play/.../PlayUIServer.java:51`:
`UIServer.getInstance().attach(statsStorage)`, default port 9000, train
module pages `module/train/TrainModule.java:53` overview/model/system +
remote receiver `RemoteReceiverModule`).

Implemented on the stdlib ThreadingHTTPServer: JSON endpoints + a
self-contained HTML dashboard (inline SVG chart, no external assets — the
container has zero egress).

Counterpart of `deeplearning4j_tpu/ui/server.py`: the same routes, JSON
and pages (served raw, byte for byte the JAX package's)."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from deeplearning4j_tpu_torch.ui.storage import StatsRecord, StatsStorage

# shared chart + poll scaffolding, interpolated into every live page so
# a fix lands once (the doubled-brace bug had to be fixed twice before)
_CHART_JS = """
function poly(svg, xs, ys, color) {
  if (xs.length < 2) return;
  const W = svg.clientWidth || 800, H = svg.clientHeight || 300, pad = 30;
  const xmin = Math.min(...xs), xmax = Math.max(...xs);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const sx = x => pad + (x - xmin) / Math.max(xmax - xmin, 1e-9) * (W - 2 * pad);
  const sy = y => H - pad - (y - ymin) / Math.max(ymax - ymin, 1e-9) * (H - 2 * pad);
  const pts = xs.map((x, i) => sx(x) + ',' + sy(ys[i])).join(' ');
  const p = document.createElementNS('http://www.w3.org/2000/svg', 'polyline');
  p.setAttribute('points', pts);
  p.setAttribute('fill', 'none');
  p.setAttribute('stroke', color);
  svg.appendChild(p);
}
const COLORS = ['#d62728', '#2ca02c', '#9467bd', '#ff7f0e', '#17becf',
                '#1f77b4', '#8c564b', '#e377c2'];
"""

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu training UI</title>
<style>
 body { font-family: sans-serif; margin: 2em; }
 .chart { border: 1px solid #ccc; margin-bottom: 1.5em; }
 h2 { margin-bottom: 0.2em; }
</style></head>
<body>
<h1>Training overview</h1>
<div id="meta"></div>
<h2>Score vs iteration</h2>
<svg id="score" class="chart" width="800" height="300"></svg>
<h2>Parameter mean magnitudes</h2>
<svg id="params" class="chart" width="800" height="300"></svg>
<script>""" + _CHART_JS + """
async function refresh() {
  const r = await fetch('/train/overview/data');
  const d = await r.json();
  document.getElementById('meta').textContent =
    'session: ' + d.session_id + '  iterations: ' + d.iterations.length;
  const svg = document.getElementById('score');
  svg.innerHTML = '';
  poly(svg, d.iterations, d.scores, '#1f77b4');
  const ps = document.getElementById('params');
  ps.innerHTML = '';
  let ci = 0;
  for (const [name, series] of Object.entries(d.param_mean_magnitudes)) {
    poly(ps, d.iterations.slice(-series.length), series, COLORS[ci++ % COLORS.length]);
  }
}
refresh(); setInterval(refresh, 5000);
</script>
</body></html>
"""


_MODEL_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu model</title>
<style>
 body { font-family: sans-serif; margin: 2em; }
 .chart { border: 1px solid #ccc; margin-bottom: 1.5em; }
 table { border-collapse: collapse; margin-bottom: 1.5em; }
 td, th { border: 1px solid #ccc; padding: 4px 10px; text-align: right; }
 th { background: #f4f4f4; }
 td:first-child, th:first-child { text-align: left; }
</style></head>
<body>
<h1>Model</h1>
<div id="meta"></div>
<h2>Parameter table (latest iteration)</h2>
<table id="ptable"><thead><tr><th>parameter</th><th>mean</th>
<th>stdev</th><th>mean |w|</th></tr></thead><tbody></tbody></table>
<h2>Mean |w| vs iteration (per parameter)</h2>
<svg id="pchart" class="chart" width="800" height="300"></svg>
<div id="legend"></div>
<script>""" + _CHART_JS + """
function cell(row, text) {
  const td = document.createElement('td');
  td.textContent = text;     // names come from untrusted remote stats
  row.appendChild(td);       // records: textContent, never innerHTML
}
async function refresh() {
  const r = await fetch('/train/model/data');
  const d = await r.json();
  document.getElementById('meta').textContent =
    'session: ' + d.session_id + '  model: ' + (d.static.model_class || '?')
    + '  params: ' + (d.static.n_params || '?')
    + '  iteration: ' + d.latest_iteration;
  const tb = document.querySelector('#ptable tbody');
  tb.innerHTML = '';
  const svg = document.getElementById('pchart');
  svg.innerHTML = '';
  const legend = document.getElementById('legend');
  legend.innerHTML = '';
  let ci = 0;
  for (const [name, s] of Object.entries(d.params)) {
    const last = i => (s[i] && s[i].length ? s[i][s[i].length - 1] : NaN);
    const row = document.createElement('tr');
    cell(row, name);
    cell(row, Number(last('mean')).toPrecision(4));
    cell(row, Number(last('stdev')).toPrecision(4));
    cell(row, Number(last('mean_magnitude')).toPrecision(4));
    tb.appendChild(row);
    const color = COLORS[ci++ % COLORS.length];
    poly(svg, d.iterations.slice(-s.mean_magnitude.length),
         s.mean_magnitude, color);
    const span = document.createElement('span');
    span.style.color = color;
    span.textContent = '\u25A0 ' + name + '  ';
    legend.appendChild(span);
  }
}
refresh(); setInterval(refresh, 3000);
</script>
</body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    server_version = "dl4jtpu-ui/1.0"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _html(self, text: str):
        body = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/html")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    # -- GET ----------------------------------------------------------------
    def do_GET(self):
        ui: "UIServer" = self.server.ui  # type: ignore[attr-defined]
        if self.path in ("/", "/train", "/train/overview"):
            return self._html(_PAGE)
        if self.path == "/train/overview/data":
            return self._json(ui._overview_data())
        if self.path == "/train/sessions":
            return self._json({"sessions": ui._session_ids()})
        if self.path == "/train/model":
            return self._json(ui._model_data())
        if self.path == "/train/model/page":
            return self._html(_MODEL_PAGE)
        if self.path == "/train/model/data":
            return self._json(ui._model_series())
        if self.path == "/train/system":
            return self._json(ui._system_data())
        if self.path == "/train/histograms":
            return self._json(ui._histogram_data())
        if self.path == "/train/histograms/page":
            return self._html(ui._histogram_page())
        if self.path == "/tsne":
            return self._html(ui._tsne_page())
        if self.path == "/tsne/data":
            return self._json(ui._tsne)
        if self.path == "/train/flow":
            return self._html(ui._flow_page())
        if self.path == "/train/activations":
            return self._html(ui._activations_page())
        return self._json({"error": f"unknown path {self.path}"}, 404)

    # -- POST (remote stats receiver + tsne upload) -------------------------
    def do_POST(self):
        ui: "UIServer" = self.server.ui  # type: ignore[attr-defined]
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n)
        if self.path == "/remote/receive":
            try:
                rec = StatsRecord.from_json(body.decode())
            except Exception as e:  # malformed post
                return self._json({"error": str(e)}, 400)
            if ui._storages:
                ui._storages[0].put_record(rec)
                return self._json({"ok": True})
            return self._json({"error": "no storage attached"}, 503)
        if self.path == "/tsne/upload":
            # {"coords": [[x, y], ...], "labels": ["word", ...]}
            try:
                payload = json.loads(body)
                coords = [[float(c[0]), float(c[1])] for c in payload["coords"]]
                labels = payload.get("labels") or [""] * len(coords)
                if len(labels) != len(coords):
                    raise ValueError("labels/coords length mismatch")
                labels = [str(l) for l in labels]
            except Exception as e:
                return self._json({"error": f"bad upload: {e}"}, 400)
            ui._tsne = {"coords": coords, "labels": labels}
            return self._json({"ok": True, "points": len(coords)})
        return self._json({"error": f"unknown path {self.path}"}, 404)


class UIServer:
    """`UIServer().attach(storage)` then browse http://localhost:<port>/
    (reference `PlayUIServer.attach:247`; default port 9000 as at `:58`)."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000):
        self._storages: List[StatsStorage] = []
        self._tsne: dict = {"coords": [], "labels": []}
        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
        self._httpd.ui = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @classmethod
    def get_instance(cls, port: int = 9000) -> "UIServer":
        if cls._instance is None:
            cls._instance = UIServer(port)
        return cls._instance

    def attach(self, storage: StatsStorage) -> None:
        if storage not in self._storages:
            self._storages.append(storage)

    def detach(self, storage: StatsStorage) -> None:
        if storage in self._storages:
            self._storages.remove(storage)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if UIServer._instance is self:
            UIServer._instance = None

    # -- data assembly ------------------------------------------------------
    def _session_ids(self) -> List[str]:
        out: List[str] = []
        for s in self._storages:
            out.extend(s.list_session_ids())
        return sorted(set(out))

    def _latest_session(self):
        for s in self._storages:
            ids = s.list_session_ids()
            if ids:
                return s, ids[-1]
        return None, None

    def _overview_data(self):
        storage, sid = self._latest_session()
        if storage is None:
            return {"session_id": None, "iterations": [], "scores": [],
                    "param_mean_magnitudes": {}}
        recs = storage.get_records(sid, type_id="stats")
        iterations = [r.data.get("iteration") for r in recs]
        scores = [r.data.get("score") for r in recs]
        pmm: dict = {}
        for r in recs:
            for name, st in (r.data.get("parameters") or {}).items():
                pmm.setdefault(name, []).append(st.get("mean_magnitude"))
        return {"session_id": sid, "iterations": iterations, "scores": scores,
                "param_mean_magnitudes": pmm}

    def _model_data(self):
        storage, sid = self._latest_session()
        if storage is None:
            return {"session_id": None}
        static = storage.get_records(sid, type_id="static_info")
        latest = storage.get_latest_record(sid, type_id="stats")
        return {"session_id": sid,
                "static": static[-1].data if static else {},
                "latest": latest.data if latest else {}}

    def _model_series(self):
        """Model-page feed: static info + full per-parameter stat series
        (the reference TrainModule model tab's per-layer charts)."""
        storage, sid = self._latest_session()
        if storage is None:
            return {"session_id": None, "static": {}, "iterations": [],
                    "params": {}, "latest_iteration": None}
        static = storage.get_records(sid, type_id="static_info")
        recs = storage.get_records(sid, type_id="stats")
        iterations = [r.data.get("iteration") for r in recs]
        params: dict = {}
        for r in recs:
            for name, st in (r.data.get("parameters") or {}).items():
                slot = params.setdefault(
                    name, {"mean": [], "stdev": [], "mean_magnitude": []})
                for k in slot:
                    slot[k].append(st.get(k))
        return {"session_id": sid,
                "static": static[-1].data if static else {},
                "iterations": iterations, "params": params,
                "latest_iteration": iterations[-1] if iterations else None}

    def _system_data(self):
        """System page feed (reference TrainModule system tab: JVM/GC; here
        host RSS + device HBM per iteration)."""
        storage, sid = self._latest_session()
        if storage is None:
            return {"session_id": None, "iterations": [], "host_rss_mb": [],
                    "device_bytes_in_use": [], "gc_gen2_collections": []}
        recs = storage.get_records(sid, type_id="stats")
        out = {"session_id": sid, "iterations": [], "host_rss_mb": [],
               "device_bytes_in_use": [], "gc_gen2_collections": []}
        for r in recs:
            sysd = r.data.get("system") or {}
            out["iterations"].append(r.data.get("iteration"))
            # non-procfs platforms record peak RSS instead of current
            out["host_rss_mb"].append(sysd.get("host_rss_mb",
                                               sysd.get("host_rss_peak_mb")))
            out["device_bytes_in_use"].append(sysd.get("device_bytes_in_use"))
            gens = sysd.get("gc_collections")
            # gen-2 cumulative count — the reference system tab's GC trace
            out["gc_gen2_collections"].append(gens[-1] if gens else None)
        return out

    def _histogram_data(self):
        """Latest per-parameter histograms (reference HistogramModule)."""
        storage, sid = self._latest_session()
        latest = (storage.get_latest_record(sid, type_id="stats")
                  if storage else None)
        if latest is None:
            return {"session_id": None, "parameters": {}}
        params = {
            name: {k: st.get(k) for k in
                   ("histogram_counts", "histogram_min", "histogram_max",
                    "mean", "stdev")}
            for name, st in (latest.data.get("parameters") or {}).items()}
        return {"session_id": sid, "iteration": latest.data.get("iteration"),
                "parameters": params}

    def _histogram_page(self) -> str:
        from deeplearning4j_tpu_torch.ui.components import ChartHistogram, ComponentDiv, render_html

        d = self._histogram_data()
        div = ComponentDiv()
        for name, st in d["parameters"].items():
            counts = st.get("histogram_counts") or []
            if not counts:
                continue
            lo, hi = st.get("histogram_min", 0.0), st.get("histogram_max", 1.0)
            width = (hi - lo) / max(len(counts), 1)
            ch = ChartHistogram(title=f"{name} (iter {d.get('iteration')})")
            for i, c in enumerate(counts):
                ch.add_bin(lo + i * width, lo + (i + 1) * width, c)
            div.add(ch)
        return render_html(div, title="parameter histograms",
                           refresh_seconds=5)

    def _latest_of_type(self, type_id: str):
        """Most recent record of a type across all sessions/storages (flow
        and activation listeners run under their own session ids)."""
        best = None
        for storage in self._storages:
            for sid in storage.list_session_ids():
                rec = storage.get_latest_record(sid, type_id=type_id)
                if rec is not None and (best is None
                                        or rec.timestamp > best.timestamp):
                    best = rec
        return best

    def _flow_page(self) -> str:
        from deeplearning4j_tpu_torch.ui.flow import render_flow_svg

        rec = self._latest_of_type("flow")
        nodes = rec.data.get("nodes", []) if rec else []
        body = render_flow_svg(nodes) if nodes else "<p>no flow captured</p>"
        return ("<!DOCTYPE html><html><head><title>network flow</title>"
                "</head><body><h1>Network flow</h1>" + body + "</body></html>")

    def _activations_page(self) -> str:
        from deeplearning4j_tpu_torch.ui.flow import render_activation_svg

        rec = self._latest_of_type("activations")
        if rec is None:
            body = "<p>no activations captured</p>"
        else:
            body = (f"<p>iteration {rec.data.get('iteration')}</p>"
                    + render_activation_svg(rec.data.get("channels", [])))
        return ("<!DOCTYPE html><html><head><title>activations</title>"
                "</head><body><h1>Conv activations</h1>" + body
                + "</body></html>")

    def _tsne_page(self) -> str:
        from deeplearning4j_tpu_torch.ui.components import ChartScatter, render_html

        coords = self._tsne.get("coords") or []
        chart = ChartScatter(title=f"t-SNE ({len(coords)} points)")
        if coords:
            chart.add_series("points", [c[0] for c in coords],
                             [c[1] for c in coords],
                             labels=self._tsne.get("labels"))
        return render_html(chart, title="t-SNE", refresh_seconds=10)
