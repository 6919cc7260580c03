"""Vocabulary: elements, cache, construction, Huffman coding (reference
`models/word2vec/wordstore/VocabConstructor.java`,
`wordstore/inmemory/AbstractCache.java`, `models/word2vec/VocabWord.java`,
`models/word2vec/Huffman.java`).

Counterpart of `deeplearning4j_tpu/nlp/vocab.py`: host code, a copy of
the JAX package's with the port's imports. Vocabularies, indices, Huffman
codes and points and the unigram table equal the JAX package's.
`build_vocab_from_files` counts with the port's `native` library when it
builds, else by the byte split below; both routes give the same
vocabulary (`native.loader.route` says which ran)."""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


@dataclass
class VocabWord:
    """One vocab element (reference `VocabWord.java` /
    `sequencevectors/sequence/SequenceElement.java`): frequency + index +
    Huffman code/point lists for hierarchical softmax."""

    word: str
    count: float = 1.0
    index: int = -1
    codes: List[int] = field(default_factory=list)
    points: List[int] = field(default_factory=list)


class AbstractCache:
    """In-memory vocab cache (reference `inmemory/AbstractCache.java`):
    word ↔ index ↔ VocabWord, plus total corpus counts."""

    def __init__(self) -> None:
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_occurrences = 0.0

    def __contains__(self, word: str) -> bool:
        return word in self._words

    def __len__(self) -> int:
        return len(self._by_index)

    def num_words(self) -> int:
        return len(self._by_index)

    def add_token(self, vw: VocabWord) -> None:
        if vw.word in self._words:
            self._words[vw.word].count += vw.count
        else:
            self._words[vw.word] = vw

    def increment_count(self, word: str, by: float = 1.0) -> None:
        self._words[word].count += by

    def word_for(self, word: str) -> VocabWord:
        return self._words[word]

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.count if vw else 0.0

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, index: int) -> str:
        return self._by_index[index].word

    def element_at_index(self, index: int) -> VocabWord:
        return self._by_index[index]

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def update_indices(self) -> None:
        """Assign indices by descending frequency (the reference sorts the
        vocab so frequent words get small indices)."""
        self._by_index = sorted(self._words.values(),
                                key=lambda v: (-v.count, v.word))
        for i, vw in enumerate(self._by_index):
            vw.index = i
        self.total_word_occurrences = float(sum(v.count for v in self._by_index))

    def remove_below(self, min_frequency: float) -> None:
        self._words = {w: vw for w, vw in self._words.items()
                       if vw.count >= min_frequency}

    def unigram_table(self, power: float = 0.75) -> np.ndarray:
        """Negative-sampling distribution p(w) ∝ count^0.75 (the reference
        builds a 100M-entry sampling table in `InMemoryLookupTable.java`;
        here the probabilities feed the host and device inverse-cdf
        samplers)."""
        counts = np.array([vw.count for vw in self._by_index], np.float64)
        p = counts ** power
        return p / p.sum()


class VocabConstructor:
    """Corpus scan → filtered, indexed vocab (reference
    `wordstore/VocabConstructor.java:441` `buildJointVocabulary`)."""

    def __init__(self, min_word_frequency: float = 1.0):
        self.min_word_frequency = min_word_frequency

    def build_vocab(self, sequences: Iterable[Sequence[str]]) -> AbstractCache:
        cache = AbstractCache()
        for seq in sequences:
            for token in seq:
                if token in cache:
                    cache.increment_count(token)
                else:
                    cache.add_token(VocabWord(token, 1.0))
        cache.remove_below(self.min_word_frequency)
        cache.update_indices()
        return cache

    def build_vocab_from_files(self, paths, lowercase: bool = True) -> AbstractCache:
        """Whitespace-tokenized corpus files → vocab. The count pass — the
        hot loop of `VocabConstructor.buildJointVocabulary` — runs in the
        C++ native counter when available (`native/src/dl4jtpu_native.cpp`),
        with a line-splitting Python route."""
        from deeplearning4j_tpu_torch.native import count_words

        counts = count_words(list(paths), lowercase=lowercase)
        if counts is None:
            # byte-level split (ASCII whitespace), NOT str.split(): the
            # native counter tokenizes on C isspace, and the two paths must
            # produce the same vocab for the same corpus (str.split would
            # additionally break on U+00A0/U+2028 etc.)
            def sequences():
                for p in paths:
                    with open(p, "rb") as f:
                        for raw in f:
                            toks = [t.decode("utf-8", errors="replace")
                                    for t in raw.split()]
                            if lowercase:
                                toks = [t.lower() for t in toks]
                            yield toks

            return self.build_vocab(sequences())
        cache = AbstractCache()
        for w, c in counts.items():
            cache.add_token(VocabWord(w, float(c)))
        cache.remove_below(self.min_word_frequency)
        cache.update_indices()
        return cache


def build_huffman_tree(cache: AbstractCache, max_code_length: int = 40) -> None:
    """Assign Huffman codes/points to every vocab word for hierarchical
    softmax (reference `models/word2vec/Huffman.java`): code[i] = branch
    bits root→leaf, points[i] = inner-node indices along the path."""
    vocab = cache.vocab_words()
    n = len(vocab)
    if n == 0:
        return
    # node ids: 0..n-1 leaves (vocab index order), n..2n-2 inner nodes
    heap: List = []
    for vw in vocab:
        heapq.heappush(heap, (vw.count, vw.index, vw.index))
    parent: Dict[int, int] = {}
    branch: Dict[int, int] = {}
    next_id = n
    while len(heap) > 1:
        c1, _, id1 = heapq.heappop(heap)
        c2, _, id2 = heapq.heappop(heap)
        parent[id1], branch[id1] = next_id, 0
        parent[id2], branch[id2] = next_id, 1
        heapq.heappush(heap, (c1 + c2, next_id, next_id))
        next_id += 1
    root = heap[0][2] if heap else None
    for vw in vocab:
        codes: List[int] = []
        points: List[int] = []
        node = vw.index
        while node != root:
            codes.append(branch[node])
            points.append(parent[node] - n)  # inner-node row in syn1
            node = parent[node]
        codes.reverse()
        points.reverse()
        vw.codes = codes[:max_code_length]
        vw.points = points[:max_code_length]
