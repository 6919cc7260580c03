"""EvaluationTools: self-contained HTML report export (reference
`deeplearning4j-core/.../evaluation/EvaluationTools.java` —
`exportRocChartsToHtmlFile` / evaluation reports rendered via the
ui-components chart DSL; here inline SVG, zero external assets)."""
from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
from deeplearning4j_tpu_torch.eval.roc import ROC


def _svg_line_chart(xs, ys, title: str, w: int = 480, h: int = 360,
                    diagonal: bool = False) -> str:
    pad = 40
    xs, ys = np.asarray(xs, float), np.asarray(ys, float)

    def sx(x):
        return pad + x * (w - 2 * pad)

    def sy(y):
        return h - pad - y * (h - 2 * pad)

    pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
    diag = (f'<line x1="{sx(0):.1f}" y1="{sy(0):.1f}" x2="{sx(1):.1f}" '
            f'y2="{sy(1):.1f}" stroke="#bbb" stroke-dasharray="4"/>'
            if diagonal else "")
    return f"""<svg width="{w}" height="{h}" style="border:1px solid #ccc">
<text x="{w / 2}" y="20" text-anchor="middle" font-weight="bold">{title}</text>
<line x1="{pad}" y1="{h - pad}" x2="{w - pad}" y2="{h - pad}" stroke="#333"/>
<line x1="{pad}" y1="{pad}" x2="{pad}" y2="{h - pad}" stroke="#333"/>
{diag}
<polyline points="{pts}" fill="none" stroke="#1f77b4" stroke-width="1.5"/>
</svg>"""


class EvaluationTools:
    @staticmethod
    def roc_chart_html(roc: ROC) -> str:
        fpr, tpr = roc.get_roc_curve()
        auc = roc.calculate_auc()
        chart = _svg_line_chart(fpr, tpr, f"ROC (AUC = {auc:.4f})",
                                diagonal=True)
        return (f"<html><head><title>ROC</title></head><body>"
                f"<h1>ROC curve</h1>{chart}</body></html>")

    @staticmethod
    def export_roc_charts_to_html_file(roc: ROC,
                                       path: Union[str, Path]) -> None:
        Path(path).write_text(EvaluationTools.roc_chart_html(roc),
                              encoding="utf-8")

    @staticmethod
    def evaluation_html(ev: Evaluation) -> str:
        cm = ev.confusion_matrix
        n = cm.shape[0]
        rows = "".join(
            "<tr><th>{}</th>{}</tr>".format(
                i, "".join(f"<td>{int(cm[i, j])}</td>" for j in range(n)))
            for i in range(n))
        header = "".join(f"<th>{j}</th>" for j in range(n))
        return f"""<html><head><title>Evaluation</title>
<style>table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #999; padding: 4px 8px; text-align: right; }}</style>
</head><body>
<h1>Evaluation</h1>
<ul>
<li>Accuracy: {ev.accuracy():.4f}</li>
<li>Precision: {ev.precision():.4f}</li>
<li>Recall: {ev.recall():.4f}</li>
<li>F1: {ev.f1():.4f}</li>
</ul>
<h2>Confusion matrix (rows = actual)</h2>
<table><tr><th></th>{header}</tr>{rows}</table>
</body></html>"""

    @staticmethod
    def export_evaluation_to_html_file(ev: Evaluation,
                                       path: Union[str, Path]) -> None:
        Path(path).write_text(EvaluationTools.evaluation_html(ev),
                              encoding="utf-8")
