"""Word2Vec: skip-gram/CBOW over text corpora (reference
`models/word2vec/Word2Vec.java` — a SequenceVectors specialization wired to
the text pipeline: sentence iterator + tokenizer factory; BASELINE config 4).

Counterpart of `deeplearning4j_tpu/nlp/word2vec.py`; `device=` (a
`SequenceVectors` argument) puts the tables on the card by default.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Union

from deeplearning4j_tpu_torch.nlp.sentence_iterator import (
    CollectionSentenceIterator,
    SentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.sequence_vectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory,
    TokenizerFactory,
)


class Word2Vec(SequenceVectors):
    """Builder-style usage mirrors the reference:

        w2v = Word2Vec(layer_size=100, window=5, negative=5,
                       min_word_frequency=5)
        w2v.fit(sentence_iterator_or_strings)
        w2v.words_nearest("day", 10)
    """

    def __init__(self,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kwargs):
        kwargs.setdefault("elements_learning_algorithm", "skipgram")
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _tokenize(self, corpus) -> List[List[str]]:
        if isinstance(corpus, SentenceIterator):
            sentences: Iterable[str] = list(corpus)
        elif isinstance(corpus, (list, tuple)) and corpus and \
                not isinstance(corpus[0], str):
            return [list(s) for s in corpus]  # pre-tokenized
        else:
            sentences = list(corpus)
        return [self.tokenizer_factory.create(s).get_tokens() for s in sentences]

    def build_vocab(self, corpus) -> None:  # type: ignore[override]
        super().build_vocab(self._tokenize(corpus))

    def fit(self, corpus) -> None:  # type: ignore[override]
        super().fit(self._tokenize(corpus))
