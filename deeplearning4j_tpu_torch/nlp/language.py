"""Language-specific tokenization (reference `deeplearning4j-nlp-japanese`
— a vendored Kuromoji fork, 6,920 LoC of dictionary-based morphological
analysis — `deeplearning4j-nlp-korean` and `deeplearning4j-nlp-uima`,
SURVEY §2.5).

- `JapaneseTokenizerFactory`: dictionary-backed Viterbi segmentation over
  the embedded lexicon (`nlp/dictionary.py` — the Kuromoji mechanism in
  miniature), script-run fallback for OOV spans; `lexicon=` swaps in a
  full IPADIC-style dictionary, `analyzer=` plugs in a MeCab-class
  binding, `use_dictionary=False` reverts to pure script runs.
- `KoreanTokenizerFactory`: eojeol segmentation + dictionary-backed
  stem/josa/ending morpheme splitting (the reference's KoreanTwitterText
  tokenizer role); `particles=` picks drop/keep/eojeol modes.
- `UimaTokenizerFactory` / `UimaSentenceIterator`: the reference uses UIMA
  for sentence segmentation + tokenization; here the same surface backed by
  rule-based segmentation, gated on an optional analyzer callable.

Counterpart of `deeplearning4j_tpu/nlp/language.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Callable, List, Optional

from deeplearning4j_tpu_torch.nlp.sentence_iterator import SentenceIterator
from deeplearning4j_tpu_torch.nlp.tokenization import Tokenizer, TokenizerFactory


def _script(ch: str) -> str:
    """Coarse script class for a character (CJK segmentation)."""
    o = ord(ch)
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or 0x31F0 <= o <= 0x31FF:
        return "katakana"
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF:
        return "kanji"
    if 0xAC00 <= o <= 0xD7AF:
        return "hangul"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    if ch.isspace():
        return "space"
    return "other"


def segment_by_script(text: str) -> List[str]:
    """Split into runs of the same script class, dropping whitespace and
    punctuation. 'JAXは速い123' → ['JAX', 'は', '速い', '123'] (well — 速
    and い split only if scripts differ; kanji+kana runs stay separate)."""
    out: List[str] = []
    cur = ""
    cur_script = None
    for ch in text:
        s = _script(ch)
        if s in ("space", "other"):
            if cur:
                out.append(cur)
            cur, cur_script = "", None
            continue
        if s != cur_script and cur:
            out.append(cur)
            cur = ""
        cur += ch
        cur_script = s
    if cur:
        out.append(cur)
    return out


class JapaneseTokenizerFactory(TokenizerFactory):
    """Dictionary-backed tokenizer for Japanese text (reference
    `deeplearning4j-nlp-japanese`'s Kuromoji `JapaneseTokenizerFactory`):
    a Viterbi cost lattice over an embedded lexicon
    (`nlp/dictionary.py`) with script-run fallback for OOV spans — the
    Kuromoji mechanism in miniature. `lexicon=` swaps in a full
    IPADIC-style dictionary (`Lexicon.from_entries`);
    `use_dictionary=False` reverts to pure script-run segmentation;
    `analyzer=` (a `str -> List[str]` callable, e.g. a MeCab binding)
    overrides everything."""

    def __init__(self, analyzer: Optional[Callable[[str], List[str]]] = None,
                 use_dictionary: bool = True, lexicon=None):
        super().__init__()
        self.analyzer = analyzer
        self.use_dictionary = use_dictionary
        self.lexicon = lexicon

    def _lex(self):
        if self.lexicon is None:
            from deeplearning4j_tpu_torch.nlp.dictionary import JAPANESE_LEXICON

            self.lexicon = JAPANESE_LEXICON
        return self.lexicon

    def create(self, text: str) -> Tokenizer:
        norm = unicodedata.normalize("NFKC", text)
        if self.analyzer:
            tokens = self.analyzer(norm)
        elif self.use_dictionary:
            from deeplearning4j_tpu_torch.nlp.dictionary import viterbi_segment

            tokens = [t for t, _pos in viterbi_segment(norm, self._lex())]
        else:
            tokens = segment_by_script(norm)
        return Tokenizer(tokens, self._pre)

    def tokenize_with_pos(self, text: str):
        """(surface, pos) morphemes — the Kuromoji token attribute the
        plain Tokenizer surface drops. Consistent with create(): the same
        analyzer/use_dictionary configuration produces the same surfaces
        (non-dictionary modes tag pos='unknown')."""
        norm = unicodedata.normalize("NFKC", text)
        if self.analyzer:
            return [(t, "unknown") for t in self.analyzer(norm)]
        if not self.use_dictionary:
            return [(t, "unknown") for t in segment_by_script(norm)]
        from deeplearning4j_tpu_torch.nlp.dictionary import viterbi_segment

        return viterbi_segment(norm, self._lex())


class KoreanTokenizerFactory(TokenizerFactory):
    """Eojeol (whitespace) tokenizer with dictionary-backed morpheme
    splitting (reference `deeplearning4j-nlp-korean`'s Twitter-text
    tokenizer role): each eojeol splits into stem + trailing josa/ending
    morphemes via iterated longest-suffix matching against the embedded
    lexicon (`nlp/dictionary.py`). `particles=` picks the mode ('drop'
    stems only, 'keep' stems + particle morphemes, 'eojeol' no split);
    `analyzer=` plugs in a real morphological analyzer."""

    def __init__(self, strip_particles: bool = True,
                 analyzer: Optional[Callable[[str], List[str]]] = None,
                 particles: Optional[str] = None):
        """`particles` is the single mode switch: 'drop' (split, stems
        only — the default), 'keep' (split, stems + particle morphemes),
        'eojeol' (no split). The legacy strip_particles boolean maps onto
        it when `particles` is not given."""
        super().__init__()
        if particles is None:
            particles = "drop" if strip_particles else "eojeol"
        if particles not in ("drop", "keep", "eojeol"):
            raise ValueError(f"particles={particles!r}: choose "
                             "'drop' | 'keep' | 'eojeol'")
        self.particles = particles
        self.analyzer = analyzer

    def _split(self, token: str) -> List[str]:
        from deeplearning4j_tpu_torch.nlp.dictionary import split_korean_eojeol

        morphs = split_korean_eojeol(token)
        if self.particles == "drop":
            morphs = morphs[:1]  # stem only
        return [m for m, _kind in morphs]

    def create(self, text: str) -> Tokenizer:
        norm = unicodedata.normalize("NFKC", text)
        if self.analyzer:
            tokens = self.analyzer(norm)
        else:
            tokens = [t for raw in norm.split()
                      for t in segment_by_script(raw)]
            if self.particles != "eojeol":
                tokens = [m for t in tokens for m in self._split(t)]
        return Tokenizer(tokens, self._pre)

    def tokenize_with_pos(self, text: str):
        """(surface, kind) morphemes per eojeol (stem/particle/ending),
        consistent with create(): analyzer/eojeol modes return their
        surfaces tagged 'unknown'/'stem'."""
        from deeplearning4j_tpu_torch.nlp.dictionary import split_korean_eojeol

        norm = unicodedata.normalize("NFKC", text)
        if self.analyzer:
            return [(t, "unknown") for t in self.analyzer(norm)]
        raws = [t for raw in norm.split() for t in segment_by_script(raw)]
        if self.particles == "eojeol":
            return [(t, "stem") for t in raws]
        return [m for t in raws for m in split_korean_eojeol(t)]


# latin sentence enders need trailing whitespace (protects "U.S."-style
# abbreviations mid-token); CJK enders split with or without a space
_SENTENCE_RE = re.compile(r"(?<=[。！？])\s*|(?<=[.!?])\s+")


class UimaSentenceIterator(SentenceIterator):
    """Sentence segmentation over documents (reference
    `deeplearning4j-nlp-uima`'s `UimaSentenceIterator` — UIMA
    SentenceAnnotator role). Rule-based splitter on sentence-final
    punctuation, incl. CJK 。！？."""

    def __init__(self, documents: List[str],
                 segmenter: Optional[Callable[[str], List[str]]] = None):
        super().__init__()
        self.documents = list(documents)
        self.segmenter = segmenter
        self._sentences: List[str] = []
        self._pos = 0
        self.reset()

    def reset(self) -> None:
        self._sentences = []
        for doc in self.documents:
            if self.segmenter:
                self._sentences.extend(self.segmenter(doc))
            else:
                self._sentences.extend(
                    s.strip() for s in _SENTENCE_RE.split(doc) if s.strip())
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def next_sentence(self) -> str:
        s = self._sentences[self._pos]
        self._pos += 1
        return self._apply(s)


class UimaTokenizerFactory(TokenizerFactory):
    """Tokenizer driven by a UIMA-style analysis engine (reference
    `deeplearning4j-nlp-uima`'s `UimaTokenizerFactory`: create an
    AnalysisEngine, process the text into a CAS, read Token annotations
    back out). `analysis_engine` may be an `nlp/uima.AnalysisEngine`
    (anything with `.process(cas)`) or a plain `str -> [tokens]`
    callable; `with_default_engine()` builds the bundled
    sentence→token→lattice-morpheme→POS aggregate. Without an engine,
    falls back to script-aware word segmentation."""

    def __init__(self, analysis_engine=None):
        super().__init__()
        self.analysis_engine = analysis_engine

    @classmethod
    def with_default_engine(cls, lexicon=None) -> "UimaTokenizerFactory":
        from deeplearning4j_tpu_torch.nlp.uima import default_analysis_engine

        return cls(default_analysis_engine(lexicon))

    def create(self, text: str) -> Tokenizer:
        norm = unicodedata.normalize("NFKC", text)
        if self.analysis_engine is not None:
            if hasattr(self.analysis_engine, "process"):
                from deeplearning4j_tpu_torch.nlp.uima import engine_tokens

                return Tokenizer(engine_tokens(self.analysis_engine, norm),
                                 self._pre)
            return Tokenizer(self.analysis_engine(norm), self._pre)
        tokens = [t for raw in norm.split() for t in segment_by_script(raw)]
        return Tokenizer(tokens, self._pre)
