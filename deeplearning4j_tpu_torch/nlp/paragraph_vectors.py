"""ParagraphVectors (doc2vec): PV-DBOW / PV-DM + vector inference
(reference `models/paragraphvectors/ParagraphVectors.java`, sequence
learning algorithms `models/embeddings/learning/impl/sequence/DBOW.java`,
`DM.java`).

Doc/label vectors live as extra rows appended after the word rows of syn0
(the reference likewise stores labels in the shared lookup table), so the
same scatter steps train words and documents together:
  PV-DBOW — the doc row is the skip-gram center predicting each word;
  PV-DM   — the doc row joins the CBOW context mean predicting the center.
Negative sampling draws from the word unigram distribution only.

Counterpart of `deeplearning4j_tpu/nlp/paragraph_vectors.py`: the doc rows
are drawn on the host by `np.random.default_rng` and appended to the
device table; `infer_vector` runs `kernels.infer_step` on the device.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import kernels
from deeplearning4j_tpu_torch.nlp.sentence_iterator import LabelledDocument
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors, _PairBatcher
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class ParagraphVectors(SequenceVectors):
    def __init__(self,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 sequence_learning_algorithm: str = "dbow",
                 train_words: bool = True,
                 **kwargs):
        kwargs.setdefault("elements_learning_algorithm", "skipgram")
        # HS configurations default to PURE hierarchical softmax — the
        # inherited negative=5 default would silently put the model in
        # mixed HS+NS mode
        kwargs.setdefault(
            "negative", 0 if kwargs.get("use_hierarchic_softmax") else 5)
        super().__init__(**kwargs)
        if sequence_learning_algorithm not in ("dbow", "dm"):
            raise ValueError(sequence_learning_algorithm)
        if (self.use_hs and self.negative > 0
                and sequence_learning_algorithm == "dm"):
            # same restriction SequenceVectors applies to cbow (PV-DM is
            # the cbow-shaped path): the mixed-mode flush trains the
            # skip-gram buffers only
            raise NotImplementedError(
                "PV-DM with mixed HS+negative-sampling is not supported; "
                "use negative=0 (pure HS) or use_hierarchic_softmax=False")
        self.seq_algorithm = sequence_learning_algorithm
        self.train_words = train_words
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.labels: List[str] = []
        self._label_index: Dict[str, int] = {}

    # -- data prep ----------------------------------------------------------
    def _prepare(self, documents) -> List[Tuple[str, List[str]]]:
        out = []
        for i, doc in enumerate(documents):
            if isinstance(doc, LabelledDocument):
                label = doc.labels[0] if doc.labels else f"DOC_{i}"
                text = doc.content
            elif isinstance(doc, tuple):
                label, text = doc
            else:
                label, text = f"DOC_{i}", doc
            tokens = (self.tokenizer_factory.create(text).get_tokens()
                      if isinstance(text, str) else list(text))
            out.append((label, tokens))
        return out

    def fit(self, documents) -> None:  # type: ignore[override]
        docs = self._prepare(documents)
        if self.vocab is None:
            self.build_vocab([t for _, t in docs])
        # incremental fit: append rows for labels not seen before (word
        # vocab stays fixed; unknown words are dropped by _to_ids)
        new_labels = [l for l, _ in docs if l not in self._label_index]
        if new_labels:
            D = self.layer_size
            rng = np.random.default_rng(self.seed + 1 + len(self.labels))
            doc_rows = torch.as_tensor(
                (rng.random((len(new_labels), D)) - 0.5) / D,
                dtype=self.lookup_table.syn0.dtype).to(self.device)
            for l in new_labels:
                self._label_index[l] = len(self.labels)
                self.labels.append(l)
            self.lookup_table.syn0 = torch.cat(
                [self.lookup_table.syn0, doc_rows], dim=0)

        V = self.vocab.num_words()
        total_words = max(1.0, sum(len(t) for _, t in docs) * self.epochs)
        words_seen = 0.0
        self._reset_loss()
        batch = _PairBatcher(self)
        for _ in range(self.epochs * self.iterations):
            for label, tokens in docs:
                ids = self._to_ids(tokens)
                if not ids:
                    continue
                doc_row = V + self._label_index[label]
                alpha = max(self.min_learning_rate,
                            self.learning_rate * (1.0 - words_seen / total_words))
                if self.seq_algorithm == "dbow":
                    for w in ids:
                        batch.add_pair(doc_row, w, alpha)
                    if self.train_words:
                        self._train_sequence(ids, alpha, batch)
                else:  # dm
                    self._train_dm(ids, doc_row, alpha, batch)
                words_seen += len(ids)
        batch.flush()

    def _train_dm(self, ids: List[int], doc_row: int, alpha: float,
                  batch: "_PairBatcher"):
        for pos, center in enumerate(ids):
            b = int(self._rng.integers(1, self.window + 1))
            lo, hi = max(0, pos - b), min(len(ids), pos + b + 1)
            # doc row first: add_cbow truncates overlong contexts from the
            # tail, and the doc vector must never be dropped
            context = [doc_row] + [ids[j] for j in range(lo, hi) if j != pos]
            batch.add_cbow(context, center, alpha)

    # DM mixes skip-gram (words) and cbow rows in one batcher — force the
    # cbow kernel for dm, skipgram kernel for dbow word training
    @property
    def algorithm(self):
        return "cbow" if self.seq_algorithm == "dm" else "skipgram"

    @algorithm.setter
    def algorithm(self, v):
        pass

    # -- query --------------------------------------------------------------
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self._label_index.get(label)
        if i is None:
            return None
        return self.lookup_table.syn0[self.vocab.num_words() + i].cpu().numpy()

    def docs_nearest(self, label_or_vec, top_n: int = 5) -> List[Tuple[str, float]]:
        v = (self.doc_vector(label_or_vec)
             if isinstance(label_or_vec, str) else np.asarray(label_or_vec))
        if v is None:
            return []
        V = self.vocab.num_words()
        docs = self.lookup_table.syn0[V:].cpu().numpy()
        sims = docs @ v / np.maximum(
            np.linalg.norm(docs, axis=1) * np.linalg.norm(v), 1e-12)
        order = np.argsort(-sims)
        out = [(self.labels[i], float(sims[i])) for i in order
               if not (isinstance(label_or_vec, str) and self.labels[i] == label_or_vec)]
        return out[:top_n]

    def infer_vector(self, text: Union[str, Sequence[str]], steps: int = 20,
                     alpha: float = 0.05) -> np.ndarray:
        """Gradient-infer a vector for unseen text against FROZEN output
        weights (reference `ParagraphVectors.inferVector`)."""
        tokens = (self.tokenizer_factory.create(text).get_tokens()
                  if isinstance(text, str) else list(text))
        ids = self._to_ids(tokens)
        D = self.layer_size
        rng = np.random.default_rng(self.seed + 7)
        vec = torch.as_tensor((rng.random(D) - 0.5) / D,
                              dtype=self.lookup_table.syn0.dtype).to(self.device)
        if not ids:
            return vec.cpu().numpy()
        dev = lambda a: torch.from_numpy(a).to(self.device)
        hs_args = None
        if self.use_hs:
            # hierarchical softmax: each word contributes its Huffman path
            # (targets = internal-node rows of syn1, labels = 1 - code).
            # The paths are deterministic — build once, reuse every step.
            K = max(max((len(self.vocab.element_at_index(w).codes)
                         for w in ids), default=1), 1)
            t = np.zeros((len(ids), K), np.int32)
            lb = np.zeros((len(ids), K), np.float32)
            mk = np.zeros((len(ids), K), np.float32)
            for r, w in enumerate(ids):
                vw = self.vocab.element_at_index(w)
                for k, (code, point) in enumerate(zip(vw.codes, vw.points)):
                    t[r, k] = point
                    lb[r, k] = 1.0 - code
                    mk[r, k] = 1.0
            hs_args = (dev(t).long(), dev(lb), dev(mk))
        for step in range(steps):
            lr = alpha * (1.0 - step / steps)
            if hs_args is not None:
                vec, _ = kernels.infer_step(vec, self.lookup_table.syn1,
                                            *hs_args, float(np.float32(lr)))
            if self.negative > 0:
                # negatives resample every step — the training objective's
                # stochastic half (mixed HS+NS models optimize both)
                K = self.negative + 1
                targets = np.zeros((len(ids), K), np.int32)
                labels = np.zeros((len(ids), K), np.float32)
                mask = np.zeros((len(ids), K), np.float32)
                for r, w in enumerate(ids):
                    targets[r, 0] = w
                    labels[r, 0] = 1.0
                    mask[r, 0] = 1.0
                    negs = self._sample_negatives(self.negative)
                    targets[r, 1:] = negs
                    mask[r, 1:] = (negs != w).astype(np.float32)
                vec, _ = kernels.infer_step(
                    vec, self.lookup_table.syn1neg, dev(targets).long(),
                    dev(labels), dev(mask), float(np.float32(lr)))
        return vec.cpu().numpy()
