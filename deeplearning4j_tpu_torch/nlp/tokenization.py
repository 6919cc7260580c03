"""Tokenizers + token preprocessing (reference
`deeplearning4j-nlp/.../text/tokenization/tokenizer/` and
`tokenizerfactory/` — `DefaultTokenizerFactory`, `NGramTokenizerFactory`,
`CommonPreprocessor`).

Counterpart of `deeplearning4j_tpu/nlp/tokenization.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional

# reference `text/stopwords/StopWords.java` loads a resource list; a compact
# english set serves the same API
STOP_WORDS = frozenset("""a an and are as at be but by for if in into is it no
not of on or such that the their then there these they this to was will with
""".split())


class TokenPreProcess:
    """Per-token normalization hook (reference
    `tokenization/tokenizer/TokenPreProcess.java`)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (reference
    `tokenization/tokenizer/preprocessor/CommonPreprocessor.java`)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    """One sentence's token stream (reference
    `tokenization/tokenizer/Tokenizer.java`)."""

    def __init__(self, tokens: List[str],
                 pre_processor: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre_processor

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def get_tokens(self) -> List[str]:
        out = []
        for t in self._tokens:
            if self._pre is not None:
                t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out

    def count_tokens(self) -> int:
        return len(self.get_tokens())


class TokenizerFactory:
    """Reference `tokenizerfactory/TokenizerFactory.java`."""

    def __init__(self) -> None:
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace/word-boundary tokenizer (reference
    `tokenizerfactory/DefaultTokenizerFactory.java`)."""

    _SPLIT = re.compile(r"\s+")

    def create(self, text: str) -> Tokenizer:
        toks = [t for t in self._SPLIT.split(text.strip()) if t]
        return Tokenizer(toks, self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Emits n-grams (joined by '_') over the base tokens (reference
    `tokenizerfactory/NGramTokenizerFactory.java`)."""

    def __init__(self, base: Optional[TokenizerFactory] = None,
                 min_n: int = 1, max_n: int = 2):
        super().__init__()
        self._base = base or DefaultTokenizerFactory()
        self.min_n, self.max_n = min_n, max_n

    def create(self, text: str) -> Tokenizer:
        base = self._base.create(text).get_tokens()
        out: List[str] = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base) - n + 1):
                out.append("_".join(base[i:i + n]))
        return Tokenizer(out, self._pre)
