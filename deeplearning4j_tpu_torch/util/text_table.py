"""Plain-text column tables for the summary() surfaces."""
from typing import List, Sequence


def format_table(rows: Sequence[Sequence[str]], footer: str) -> str:
    """Left-aligned columns from (header, *data) rows, a rule under the
    header, and a footer line. Shared by MultiLayerNetwork.summary() and
    ComputationGraph.summary() so their formatting cannot diverge."""
    ncols = len(rows[0])
    widths = [max(len(r[c]) for r in rows) for c in range(ncols)]
    lines: List[str] = ["  ".join(f"{r[c]:<{widths[c]}}" for c in range(ncols))
                        for r in rows]
    lines.insert(1, "-" * len(lines[0]))
    lines.append(footer)
    return "\n".join(lines)
