"""Graph-vector persistence (reference
`deeplearning4j-graph/.../models/GraphVectorSerializer.java`): plain-text
`idx v0 v1 ...` lines, the same bytes as the JAX package's
`GraphVectorSerializer` writes."""
from __future__ import annotations

from pathlib import Path
from typing import Tuple, Union

import numpy as np


class GraphVectorSerializer:
    @staticmethod
    def write_graph_vectors(deepwalk, path: Union[str, Path]) -> None:
        table = deepwalk.lookup_table
        syn0 = table.syn0.detach().cpu().numpy()  # one read of the device
        with open(path, "w", encoding="utf-8") as f:
            for i in range(table.vocab.num_words()):
                vtx = table.vocab.word_at_index(i)
                vec = " ".join(f"{x:.6f}" for x in syn0[i])
                f.write(f"{vtx} {vec}\n")

    @staticmethod
    def read_graph_vectors(path: Union[str, Path]) -> Tuple[np.ndarray, list]:
        """Returns (vectors ordered by vertex idx, vertex ids)."""
        ids, vecs = [], []
        for line in Path(path).read_text(encoding="utf-8").splitlines():
            parts = line.split(" ")
            ids.append(int(parts[0]))
            vecs.append([float(x) for x in parts[1:]])
        order = np.argsort(ids)
        return np.asarray(vecs, np.float32)[order], [ids[i] for i in order]
