"""Sentence/document iterators (reference
`deeplearning4j-nlp/.../text/sentenceiterator/` — `SentenceIterator`,
`CollectionSentenceIterator`, `BasicLineIterator`,
`documentiterator/LabelledDocument` for ParagraphVectors).

Counterpart of `deeplearning4j_tpu/nlp/sentence_iterator.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator, List, Optional, Union


class SentenceIterator:
    """Restartable sentence stream (reference
    `sentenceiterator/SentenceIterator.java`)."""

    def __init__(self) -> None:
        self.pre_processor: Optional[Callable[[str], str]] = None

    def __iter__(self) -> Iterator[str]:
        self.reset()
        while self.has_next():
            yield self.next_sentence()

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def _apply(self, s: str) -> str:
        return self.pre_processor(s) if self.pre_processor else s


class CollectionSentenceIterator(SentenceIterator):
    """Reference `sentenceiterator/CollectionSentenceIterator.java`."""

    def __init__(self, sentences: Iterable[str]):
        super().__init__()
        self._sentences: List[str] = list(sentences)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._pos]
        self._pos += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def reset(self) -> None:
        self._pos = 0


class BasicLineIterator(SentenceIterator):
    """One sentence per file line (reference
    `sentenceiterator/BasicLineIterator.java`)."""

    def __init__(self, path: Union[str, Path]):
        super().__init__()
        self._path = Path(path)
        self._lines = self._path.read_text(encoding="utf-8").splitlines()
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._lines[self._pos]
        self._pos += 1
        return self._apply(s)

    def has_next(self) -> bool:
        return self._pos < len(self._lines)

    def reset(self) -> None:
        self._pos = 0


@dataclass
class LabelledDocument:
    """Reference `text/documentiterator/LabelledDocument.java`."""

    content: str
    labels: List[str] = field(default_factory=list)


class LabelAwareIterator:
    """Restartable labelled-document stream (reference
    `text/documentiterator/LabelAwareIterator.java`)."""

    def __init__(self, documents: Iterable[LabelledDocument]):
        self._docs = list(documents)

    def __iter__(self) -> Iterator[LabelledDocument]:
        return iter(self._docs)
