"""UI component DSL: JSON-serializable charts/tables/text.

Reference: `deeplearning4j-ui-components` (SURVEY §2.7, 2,163 LoC —
`ui/components/chart/Chart*.java`, `table/ComponentTable.java`,
`text/ComponentText.java`) — declarative components a listener or report
builder assembles, serialized as JSON, rendered by the front end. Here the
renderer is `render_html`: a self-contained page with inline SVG (zero
external assets — mirrors `EvaluationTools`' standalone HTML export).


Counterpart of `deeplearning4j_tpu/ui/components.py`: the same component
gives the same JSON and the same HTML."""
from __future__ import annotations

import html
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _REGISTRY[cls.TYPE] = cls
    return cls


@dataclass
class Component:
    TYPE = "component"

    def to_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items()}
        d["type"] = self.TYPE
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d: dict) -> "Component":
        d = dict(d)
        t = d.pop("type")
        cls = _REGISTRY[t]
        obj = cls(**d)
        return obj

    @staticmethod
    def from_json(s: str) -> "Component":
        return Component.from_dict(json.loads(s))

    def _svg(self) -> str:
        raise NotImplementedError


_COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e", "#17becf"]
_W, _H, _PAD = 720, 300, 40


def _scale(vals, lo, hi, out_lo, out_hi):
    span = max(hi - lo, 1e-12)
    return [out_lo + (v - lo) / span * (out_hi - out_lo) for v in vals]


def _axes(title: str, xlo, xhi, ylo, yhi) -> str:
    fmt = lambda v: f"{v:.4g}"
    return (
        f'<text x="{_W / 2}" y="16" text-anchor="middle" '
        f'font-size="13">{html.escape(title)}</text>'
        f'<line x1="{_PAD}" y1="{_H - _PAD}" x2="{_W - _PAD}" '
        f'y2="{_H - _PAD}" stroke="#333"/>'
        f'<line x1="{_PAD}" y1="{_PAD}" x2="{_PAD}" y2="{_H - _PAD}" '
        f'stroke="#333"/>'
        f'<text x="{_PAD}" y="{_H - _PAD + 14}" font-size="10">{fmt(xlo)}</text>'
        f'<text x="{_W - _PAD}" y="{_H - _PAD + 14}" text-anchor="end" '
        f'font-size="10">{fmt(xhi)}</text>'
        f'<text x="{_PAD - 4}" y="{_H - _PAD}" text-anchor="end" '
        f'font-size="10">{fmt(ylo)}</text>'
        f'<text x="{_PAD - 4}" y="{_PAD + 4}" text-anchor="end" '
        f'font-size="10">{fmt(yhi)}</text>')


@_register
@dataclass
class ChartLine(Component):
    """Multi-series line chart (reference `ChartLine.java`)."""

    TYPE = "chart_line"
    title: str = ""
    series_names: List[str] = field(default_factory=list)
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)

    def add_series(self, name: str, xs: Sequence[float],
                   ys: Sequence[float]) -> "ChartLine":
        self.series_names.append(name)
        self.x.append([float(v) for v in xs])
        self.y.append([float(v) for v in ys])
        return self

    def _svg(self) -> str:
        allx = [v for s in self.x for v in s] or [0.0, 1.0]
        ally = [v for s in self.y for v in s] or [0.0, 1.0]
        xlo, xhi, ylo, yhi = min(allx), max(allx), min(ally), max(ally)
        parts = [_axes(self.title, xlo, xhi, ylo, yhi)]
        for i, (xs, ys) in enumerate(zip(self.x, self.y)):
            if len(xs) < 2:
                continue
            px = _scale(xs, xlo, xhi, _PAD, _W - _PAD)
            py = _scale(ys, ylo, yhi, _H - _PAD, _PAD)
            pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(px, py))
            color = _COLORS[i % len(_COLORS)]
            parts.append(f'<polyline points="{pts}" fill="none" '
                         f'stroke="{color}" stroke-width="1.5"/>')
            parts.append(f'<text x="{_W - _PAD + 4}" y="{_PAD + 14 * i + 10}" '
                         f'font-size="10" fill="{color}">'
                         f'{html.escape(self.series_names[i])}</text>')
        return (f'<svg width="{_W}" height="{_H}" '
                f'xmlns="http://www.w3.org/2000/svg">' + "".join(parts)
                + "</svg>")


@_register
@dataclass
class ChartScatter(Component):
    """Scatter chart (reference `ChartScatter.java`)."""

    TYPE = "chart_scatter"
    title: str = ""
    series_names: List[str] = field(default_factory=list)
    x: List[List[float]] = field(default_factory=list)
    y: List[List[float]] = field(default_factory=list)
    point_labels: List[Optional[List[str]]] = field(default_factory=list)

    def add_series(self, name, xs, ys, labels=None) -> "ChartScatter":
        self.series_names.append(name)
        self.x.append([float(v) for v in xs])
        self.y.append([float(v) for v in ys])
        self.point_labels.append(None if labels is None
                                 else [str(l) for l in labels])
        return self

    def _svg(self) -> str:
        allx = [v for s in self.x for v in s] or [0.0, 1.0]
        ally = [v for s in self.y for v in s] or [0.0, 1.0]
        xlo, xhi, ylo, yhi = min(allx), max(allx), min(ally), max(ally)
        parts = [_axes(self.title, xlo, xhi, ylo, yhi)]
        for i, (xs, ys) in enumerate(zip(self.x, self.y)):
            px = _scale(xs, xlo, xhi, _PAD, _W - _PAD)
            py = _scale(ys, ylo, yhi, _H - _PAD, _PAD)
            color = _COLORS[i % len(_COLORS)]
            parts.extend(f'<circle cx="{a:.1f}" cy="{b:.1f}" r="2.5" '
                         f'fill="{color}" fill-opacity="0.7"/>'
                         for a, b in zip(px, py))
            labels = (self.point_labels[i]
                      if i < len(self.point_labels) else None)
            if labels:
                parts.extend(
                    f'<text x="{a + 4:.1f}" y="{b - 3:.1f}" font-size="9" '
                    f'fill="#444">{html.escape(l)}</text>'
                    for a, b, l in zip(px, py, labels) if l)
        return (f'<svg width="{_W}" height="{_H}" '
                f'xmlns="http://www.w3.org/2000/svg">' + "".join(parts)
                + "</svg>")


@_register
@dataclass
class ChartHistogram(Component):
    """Histogram chart (reference `ChartHistogram.java`): explicit bin
    edges + counts."""

    TYPE = "chart_histogram"
    title: str = ""
    lower: List[float] = field(default_factory=list)
    upper: List[float] = field(default_factory=list)
    counts: List[float] = field(default_factory=list)

    def add_bin(self, lower: float, upper: float, count: float) -> "ChartHistogram":
        self.lower.append(float(lower))
        self.upper.append(float(upper))
        self.counts.append(float(count))
        return self

    def _svg(self) -> str:
        if not self.counts:
            return f'<svg width="{_W}" height="{_H}"></svg>'
        xlo, xhi = min(self.lower), max(self.upper)
        yhi = max(self.counts)
        parts = [_axes(self.title, xlo, xhi, 0.0, yhi)]
        for lo, up, c in zip(self.lower, self.upper, self.counts):
            x0 = _scale([lo], xlo, xhi, _PAD, _W - _PAD)[0]
            x1 = _scale([up], xlo, xhi, _PAD, _W - _PAD)[0]
            y = _scale([c], 0.0, yhi, _H - _PAD, _PAD)[0]
            parts.append(f'<rect x="{x0:.1f}" y="{y:.1f}" '
                         f'width="{max(x1 - x0 - 1, 1):.1f}" '
                         f'height="{_H - _PAD - y:.1f}" fill="#1f77b4" '
                         f'fill-opacity="0.8"/>')
        return (f'<svg width="{_W}" height="{_H}" '
                f'xmlns="http://www.w3.org/2000/svg">' + "".join(parts)
                + "</svg>")


@_register
@dataclass
class ComponentTable(Component):
    """Table (reference `table/ComponentTable.java`)."""

    TYPE = "table"
    header: List[str] = field(default_factory=list)
    rows: List[List[str]] = field(default_factory=list)

    def _svg(self) -> str:  # tables render as HTML, not SVG
        head = "".join(f"<th>{html.escape(str(h))}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in row)
            + "</tr>" for row in self.rows)
        return (f'<table border="1" cellpadding="4" cellspacing="0">'
                f"<tr>{head}</tr>{body}</table>")


@_register
@dataclass
class ComponentText(Component):
    """Text block (reference `text/ComponentText.java`)."""

    TYPE = "text"
    text: str = ""

    def _svg(self) -> str:
        return f"<p>{html.escape(self.text)}</p>"


@_register
@dataclass
class ComponentDiv(Component):
    """Container of components (reference `ComponentDiv.java`)."""

    TYPE = "div"
    components: List = field(default_factory=list)

    def add(self, c: Component) -> "ComponentDiv":
        # store the OBJECT: mutations after add() (the builder API invites
        # them) must be visible in the rendered/serialized output
        self.components.append(c)
        return self

    def _children(self) -> List[Component]:
        return [c if isinstance(c, Component) else Component.from_dict(c)
                for c in self.components]

    def to_dict(self) -> dict:
        return {"type": self.TYPE,
                "components": [c.to_dict() for c in self._children()]}

    def _svg(self) -> str:
        return "".join(c._svg() for c in self._children())


def render_html(component: Component, title: str = "deeplearning4j_tpu report",
                refresh_seconds: int = 0) -> str:
    """Standalone HTML document for a component tree (the
    `EvaluationTools.exportevaluation`-style artifact). `refresh_seconds`
    > 0 adds a meta-refresh so server-rendered dashboard pages update
    during a running fit (the Play UI's pages poll; meta-refresh is the
    zero-asset equivalent)."""
    refresh = int(refresh_seconds)  # gate on the NORMALIZED value: 0.5
    # would pass a raw >0 check but render content="0" (instant reload)
    meta = (f'<meta http-equiv="refresh" content="{refresh}">'
            if refresh > 0 else "")
    return (f"<!DOCTYPE html><html><head>{meta}"
            f"<title>{html.escape(title)}</title>"
            f"<style>body{{font-family:sans-serif;margin:2em}}"
            f"table{{border-collapse:collapse}}</style></head>"
            f"<body>{component._svg()}</body></html>")
