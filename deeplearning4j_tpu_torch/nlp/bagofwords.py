"""Bag-of-words / TF-IDF vectorizers (reference
`deeplearning4j-nlp/.../bagofwords/vectorizer/` — `BagOfWordsVectorizer`,
`TfidfVectorizer`): documents → fixed-width count/tf-idf feature vectors
suitable for `DataSet` construction.

Counterpart of `deeplearning4j_tpu/nlp/bagofwords.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabConstructor


class BagOfWordsVectorizer:
    def __init__(self, min_word_frequency: float = 1.0,
                 tokenizer_factory: Optional[TokenizerFactory] = None):
        self.min_word_frequency = min_word_frequency
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.vocab: Optional[AbstractCache] = None

    def _tokenize(self, docs) -> List[List[str]]:
        return [self.tokenizer_factory.create(d).get_tokens()
                if isinstance(d, str) else list(d) for d in docs]

    def fit(self, documents: Iterable[Union[str, Sequence[str]]]) -> "BagOfWordsVectorizer":
        toks = self._tokenize(list(documents))
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(toks)
        self._post_fit(toks)
        return self

    def _post_fit(self, tokenized: List[List[str]]) -> None:
        pass

    def transform(self, documents: Iterable[Union[str, Sequence[str]]]) -> np.ndarray:
        assert self.vocab is not None, "call fit() first"
        toks = self._tokenize(list(documents))
        out = np.zeros((len(toks), self.vocab.num_words()), np.float32)
        for r, doc in enumerate(toks):
            for t in doc:
                i = self.vocab.index_of(t)
                if i >= 0:
                    out[r, i] += 1.0
        return self._weight(out)

    def fit_transform(self, documents) -> np.ndarray:
        docs = list(documents)
        self.fit(docs)
        return self.transform(docs)

    def _weight(self, counts: np.ndarray) -> np.ndarray:
        return counts


class TfidfVectorizer(BagOfWordsVectorizer):
    """tf-idf weighting: tf * log(N / df) (reference
    `bagofwords/vectorizer/TfidfVectorizer.java`)."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._idf: Optional[np.ndarray] = None

    def _post_fit(self, tokenized: List[List[str]]) -> None:
        n_docs = max(len(tokenized), 1)
        df = np.zeros(self.vocab.num_words(), np.float64)
        for doc in tokenized:
            for i in {self.vocab.index_of(t) for t in doc}:
                if i >= 0:
                    df[i] += 1.0
        self._idf = np.log(n_docs / np.maximum(df, 1.0)).astype(np.float32)

    def _weight(self, counts: np.ndarray) -> np.ndarray:
        return counts * self._idf
