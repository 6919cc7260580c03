"""Flow + convolutional activation listeners.

Reference (SURVEY §2.7): `ui/flow/FlowIterationListener.java` (legacy
Dropwizard UI — network-structure flow chart with per-layer info) and
`ConvolutionalListenerModule` (activation images for conv layers). Both
capture into the same StatsStorage stream the train modules use; the
server renders them at /train/flow and /train/activations as standalone
SVG (no image codecs in this environment — activations render as SVG
heatmap cells).

Counterpart of `deeplearning4j_tpu/ui/flow.py`, writing the same records
and SVG: the activations the card computes are brought to the host once
per capture.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.ui.stats_listener import _host_array
from deeplearning4j_tpu_torch.ui.storage import StatsRecord, StatsStorageRouter


class FlowListener:
    """Captures the network structure once per session (reference
    `FlowIterationListener.java`): layer index/name/type/shape chain."""

    def __init__(self, router: StatsStorageRouter,
                 session_id: str = "flow-session"):
        self.router = router
        self.session_id = session_id
        self._sent = False

    def iteration_done(self, model, iteration: int) -> None:
        if self._sent:
            return
        self._sent = True
        nodes: List[Dict[str, Any]] = []
        layers = getattr(model, "layers", None)
        if layers:  # MultiLayerNetwork: a chain
            for i, layer in enumerate(layers):
                nodes.append({
                    "name": f"layer_{i}",
                    "type": type(layer).__name__,
                    "n_in": int(getattr(layer, "n_in", 0) or 0),
                    "n_out": int(getattr(layer, "n_out", 0) or 0),
                    "inputs": [f"layer_{i - 1}"] if i > 0 else [],
                })
        else:  # ComputationGraph: the DAG
            conf = getattr(model, "conf", None)
            for name in getattr(conf, "topological_order", []):
                node = conf.nodes[name]
                nodes.append({
                    "name": name,
                    "type": (type(node.layer).__name__ if node.is_layer
                             else type(node).__name__),
                    "n_in": 0, "n_out": 0,
                    "inputs": list(getattr(node, "inputs", [])),
                })
        self.router.put_record(StatsRecord(
            session_id=self.session_id, type_id="flow", worker_id="w0",
            timestamp=time.time(), data={"nodes": nodes}))


class ConvolutionalIterationListener:
    """Captures downsampled per-channel activation grids of the first
    convolution-shaped activation every `frequency` iterations (reference
    `ConvolutionalListenerModule` activation images)."""

    def __init__(self, router: StatsStorageRouter, frequency: int = 10,
                 session_id: str = "conv-session", max_channels: int = 8,
                 cell: int = 12):
        self.router = router
        self.frequency = max(1, frequency)
        self.session_id = session_id
        self.max_channels = max_channels
        self.cell = cell
        self._probe: Optional[np.ndarray] = None

    def record_batch(self, n: int) -> None:
        pass

    def set_probe(self, features: np.ndarray) -> None:
        """Sample inputs to visualize (first example is used)."""
        self._probe = np.asarray(features)[:1]

    def iteration_done(self, model, iteration: int) -> None:
        if self._probe is None or iteration % self.frequency != 0:
            return
        acts = model.feed_forward(self._probe)
        grids = None
        for a in acts:
            if a.ndim == 4:  # (1, H, W, C) — first conv activation
                grids = _host_array(a[0])
                break
        if grids is None:
            return
        H, W, C = grids.shape
        ds = max(1, H // self.cell, W // self.cell)
        small = grids[::ds, ::ds, :self.max_channels]
        lo, hi = float(small.min()), float(small.max())
        norm = (small - lo) / max(hi - lo, 1e-9)
        self.router.put_record(StatsRecord(
            session_id=self.session_id, type_id="activations",
            worker_id="w0", timestamp=time.time(),
            data={"iteration": iteration,
                  "channels": [norm[:, :, c].tolist()
                               for c in range(norm.shape[-1])]}))


def render_flow_svg(nodes: List[Dict[str, Any]]) -> str:
    """Layer boxes + arrows (the flow chart)."""
    import html as _html

    BW, BH, GAP = 180, 46, 28
    pos = {n["name"]: i for i, n in enumerate(nodes)}
    parts = []
    for n in nodes:
        i = pos[n["name"]]
        y = 10 + i * (BH + GAP)
        label = f'{n["name"]}: {n["type"]}'
        dims = (f'{n["n_in"]}→{n["n_out"]}'
                if n.get("n_in") or n.get("n_out") else "")
        parts.append(
            f'<rect x="20" y="{y}" width="{BW}" height="{BH}" rx="6" '
            f'fill="#eef" stroke="#336"/>'
            f'<text x="{20 + BW / 2}" y="{y + 19}" text-anchor="middle" '
            f'font-size="11">{_html.escape(label)}</text>'
            f'<text x="{20 + BW / 2}" y="{y + 35}" text-anchor="middle" '
            f'font-size="10" fill="#555">{_html.escape(dims)}</text>')
        for src in n.get("inputs", []):
            if src in pos:
                sy = 10 + pos[src] * (BH + GAP) + BH
                parts.append(
                    f'<line x1="{20 + BW / 2}" y1="{sy}" x2="{20 + BW / 2}" '
                    f'y2="{y}" stroke="#336" marker-end="url(#arr)"/>')
    height = 20 + len(nodes) * (BH + GAP)
    return (f'<svg width="400" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">'
            f'<defs><marker id="arr" markerWidth="8" markerHeight="8" '
            f'refX="6" refY="3" orient="auto"><path d="M0,0 L6,3 L0,6 z" '
            f'fill="#336"/></marker></defs>' + "".join(parts) + "</svg>")


def render_activation_svg(channels: List[List[List[float]]],
                          cell_px: int = 10) -> str:
    """Per-channel heatmap grids as SVG cells."""
    parts = []
    x0 = 0
    for grid in channels:
        h = len(grid)
        w = len(grid[0]) if h else 0
        for r in range(h):
            for c in range(w):
                v = grid[r][c]
                shade = int(255 * (1.0 - v))
                parts.append(
                    f'<rect x="{x0 + c * cell_px}" y="{r * cell_px}" '
                    f'width="{cell_px}" height="{cell_px}" '
                    f'fill="rgb({shade},{shade},255)"/>')
        x0 += (w + 1) * cell_px
    height = max((len(g) for g in channels), default=0) * cell_px
    return (f'<svg width="{x0}" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">' + "".join(parts)
            + "</svg>")
