"""Weight storage + nearest-neighbor query surface (reference
`models/embeddings/inmemory/InMemoryLookupTable.java` — syn0/syn1/syn1Neg —
and the `WordVectors` query interface
`models/embeddings/wordvectors/WordVectorsImpl.java`).

Counterpart of `deeplearning4j_tpu/nlp/lookup_table.py`. The tables are
torch tensors on the table's device (the card unless the caller asks for
the CPU); the training steps of `nlp.kernels` update them in place. The
initial syn0 is drawn on the host by `np.random.default_rng(seed)`, as in
the JAX package, so both packages start from the same table.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device


class InMemoryLookupTable:
    """syn0 (input vectors), syn1 (HS weights), syn1neg (negative-sampling
    weights) as tensors on `device`."""

    def __init__(self, cache: AbstractCache, vector_length: int,
                 seed: int = 42, use_hs: bool = False, negative: int = 0,
                 dtype=torch.float32, device="cuda"):
        self.vocab = cache
        self.vector_length = vector_length
        self.device = resolve_device(device)
        n = cache.num_words()
        rng = np.random.default_rng(seed)
        # word2vec init: U(-0.5, 0.5)/D
        self.syn0 = torch.as_tensor(
            (rng.random((n, vector_length)) - 0.5) / vector_length,
            dtype=dtype).to(self.device)
        self.syn1 = (torch.zeros((max(n - 1, 1), vector_length), dtype=dtype,
                                 device=self.device) if use_hs else None)
        self.syn1neg = (torch.zeros((n, vector_length), dtype=dtype,
                                    device=self.device)
                        if negative > 0 else None)

    # -- query surface ------------------------------------------------------
    def vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        if i < 0:
            return None
        return self.syn0[i].cpu().numpy()

    def put_vector(self, word: str, vec: np.ndarray) -> None:
        i = self.vocab.index_of(word)
        if i < 0:
            raise KeyError(word)
        self.syn0[i] = torch.as_tensor(np.asarray(vec), dtype=self.syn0.dtype)

    def similarity(self, w1: str, w2: str) -> float:
        a, b = self.vector(w1), self.vector(w2)
        if a is None or b is None:
            return float("nan")
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na == 0 or nb == 0:
            return 0.0
        return float(a @ b / (na * nb))

    def words_nearest(self, word_or_vec, top_n: int = 10,
                      exclude: Sequence[str] = ()) -> List[Tuple[str, float]]:
        """Cosine top-N over the whole vocab: one (V, D) @ (D,) product on
        the table's device, read back once."""
        if isinstance(word_or_vec, str):
            v = self.vector(word_or_vec)
            if v is None:
                return []
            exclude = tuple(exclude) + (word_or_vec,)
        else:
            v = np.asarray(word_or_vec)
        sims = _cosine_scores(
            self.syn0, torch.as_tensor(v, dtype=self.syn0.dtype).to(
                self.syn0.device)).cpu().numpy()
        order = np.argsort(-sims)
        out = []
        for i in order:
            w = self.vocab.word_at_index(int(i))
            if w in exclude:
                continue
            out.append((w, float(sims[i])))
            if len(out) >= top_n:
                break
        return out


def _cosine_scores(syn0: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(syn0, dim=1) * torch.clamp(
        torch.linalg.vector_norm(v), min=1e-12)
    return syn0 @ v / torch.clamp(norms, min=1e-12)
