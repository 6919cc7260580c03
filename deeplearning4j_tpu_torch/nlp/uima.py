"""UIMA-style analysis engines: CAS, annotators, aggregate pipelines.

Reference: `deeplearning4j-nlp-uima` (3,222 LoC) drives real UIMA
analysis engines — `UimaTokenizerFactory.java` creates an
`AnalysisEngine` whose annotators write typed annotations into a CAS
(Common Analysis Structure), then reads Token annotations back out.
This module is that architecture natively: a `CAS` holding the document
text plus a typed, offset-indexed annotation store; `AnalysisEngine`
components that `process(cas)`; and `AggregateAnalysisEngine`
composing them in order (UIMA's aggregate descriptor). The bundled
annotators mirror the reference pipeline's roles (sentence detection,
tokenization, POS) with the CJK lattice tokenizer
(`nlp/dictionary.py`) as a drop-in annotator — so the
`UimaTokenizerFactory` analyzer hook is now driven by a real engine,
not an unimplemented callable.

Counterpart of `deeplearning4j_tpu/nlp/uima.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from deeplearning4j_tpu_torch.nlp.dictionary import (
    JAPANESE_LEXICON,
    Lexicon,
    viterbi_segment,
)
from deeplearning4j_tpu_torch.nlp.language import segment_by_script


@dataclass
class Annotation:
    """A typed text span (UIMA `AnnotationFS`): [begin, end) offsets into
    the CAS document plus free-form features (e.g. pos)."""

    begin: int
    end: int
    type: str
    features: Dict[str, str] = field(default_factory=dict)

    def covered_text(self, cas: "CAS") -> str:
        return cas.text[self.begin:self.end]


class CAS:
    """Common Analysis Structure: the shared document + annotation store
    every engine in an aggregate reads and writes (UIMA `JCas` role)."""

    def __init__(self, text: str):
        self.text = text
        self._annotations: List[Annotation] = []

    def add(self, ann: Annotation) -> Annotation:
        if not (0 <= ann.begin <= ann.end <= len(self.text)):
            raise ValueError(
                f"annotation [{ann.begin}, {ann.end}) outside document "
                f"of length {len(self.text)}")
        self._annotations.append(ann)
        return ann

    def remove(self, ann: Annotation) -> None:
        """Remove by IDENTITY (dataclass value-equality could silently
        delete a different but equal annotation)."""
        for i, a in enumerate(self._annotations):
            if a is ann:
                del self._annotations[i]
                return
        raise ValueError("annotation not in this CAS")

    def select(self, type_: str) -> List[Annotation]:
        """Annotations of a type in document order (UIMA `select`)."""
        return sorted((a for a in self._annotations if a.type == type_),
                      key=lambda a: (a.begin, a.end))

    def select_covered(self, type_: str, within: Annotation) -> List[Annotation]:
        """Annotations of `type_` inside `within`'s span (UIMA
        `selectCovered`)."""
        return [a for a in self.select(type_)
                if a.begin >= within.begin and a.end <= within.end]


class AnalysisEngine:
    """Component contract: mutate the CAS by adding annotations."""

    def process(self, cas: CAS) -> CAS:  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, text: str) -> CAS:
        """Convenience: run on raw text (primitive-engine entry)."""
        cas = CAS(unicodedata.normalize("NFKC", text))
        self.process(cas)
        return cas


class AggregateAnalysisEngine(AnalysisEngine):
    """Fixed-flow aggregate (UIMA aggregate descriptor): components run
    in order over the same CAS, each seeing its predecessors' output."""

    def __init__(self, components: Sequence[AnalysisEngine]):
        if not components:
            raise ValueError("aggregate needs at least one component")
        self.components = list(components)

    def process(self, cas: CAS) -> CAS:
        for c in self.components:
            c.process(cas)
        return cas


# a period after a single capital letter is an initialism ("U.S."), not a
# sentence end; CJK enders always end a sentence
_SENT_END = re.compile(r"[。！？]|(?<![A-Z])[.!?](?=\s|$)")


class SentenceAnnotator(AnalysisEngine):
    """Adds `sentence` annotations (the reference pipeline's
    SentenceAnnotator role): spans end at sentence-final punctuation,
    incl. CJK 。！？; trailing unpunctuated text forms a final sentence."""

    def process(self, cas: CAS) -> CAS:
        start = 0
        for m in _SENT_END.finditer(cas.text):
            end = m.end()
            span = cas.text[start:end]
            if span.strip():
                lead = len(span) - len(span.lstrip())
                cas.add(Annotation(start + lead, end, "sentence"))
            start = end
        tail = cas.text[start:]
        if tail.strip():
            lead = len(tail) - len(tail.lstrip())
            cas.add(Annotation(start + lead,
                               start + len(tail.rstrip()), "sentence"))
        return cas


class TokenAnnotator(AnalysisEngine):
    """Adds `token` annotations inside every sentence (TokenAnnotator
    role): whitespace split + script-run segmentation, with exact
    character offsets."""

    def process(self, cas: CAS) -> CAS:
        sentences = cas.select("sentence") or [
            Annotation(0, len(cas.text), "sentence")]
        for sent in sentences:
            text = sent.covered_text(cas)
            pos = 0
            for raw in text.split():
                at = text.index(raw, pos)
                pos = at + len(raw)
                off = 0
                for piece in segment_by_script(raw):
                    pat = text.index(piece, at + off)
                    cas.add(Annotation(sent.begin + pat,
                                       sent.begin + pat + len(piece),
                                       "token"))
                    off = pat - at + len(piece)
        return cas


class LatticeTokenAnnotator(AnalysisEngine):
    """Re-tokenizes CJK `token` spans through the dictionary lattice
    (`nlp/dictionary.viterbi_segment`), replacing each with morpheme
    tokens carrying a `pos` feature — the Kuromoji-annotator slot of the
    reference's Japanese pipeline, as a UIMA component."""

    def __init__(self, lexicon: Optional[Lexicon] = None):
        self.lexicon = lexicon if lexicon is not None else JAPANESE_LEXICON

    @staticmethod
    def _is_cjk(s: str) -> bool:
        return any(0x3040 <= ord(c) <= 0x30FF or 0x4E00 <= ord(c) <= 0x9FFF
                   for c in s)

    def process(self, cas: CAS) -> CAS:
        # merge ADJACENT CJK tokens first: the script-run TokenAnnotator
        # splits kanji↔kana boundaries (調|べる), but dictionary entries
        # routinely span them (調べる) — the lattice must see the whole
        # contiguous CJK run to find them
        runs: List[List[Annotation]] = []
        for tok in cas.select("token"):
            if not self._is_cjk(tok.covered_text(cas)):
                continue
            if runs and runs[-1][-1].end == tok.begin:
                runs[-1].append(tok)
            else:
                runs.append([tok])
        for run in runs:
            begin, end = run[0].begin, run[-1].end
            surface = cas.text[begin:end]
            pieces = viterbi_segment(surface, self.lexicon)
            if len(pieces) == 1 and len(run) == 1:
                run[0].features["pos"] = pieces[0][1]
                continue
            # retire the coarse tokens, add morpheme tokens
            for tok in run:
                cas.remove(tok)
            off = begin
            for surf, pos in pieces:
                at = cas.text.index(surf, off)
                cas.add(Annotation(at, at + len(surf), "token",
                                   {"pos": pos}))
                off = at + len(surf)
        return cas


class PosAnnotator(AnalysisEngine):
    """Attaches a `pos` feature to tokens that lack one, by lexicon
    lookup (the aggregate's POS-tagger slot; tokens outside the lexicon
    stay 'unknown' — honest, not a trained tagger)."""

    def __init__(self, lexicon: Optional[Lexicon] = None):
        self.lexicon = lexicon if lexicon is not None else JAPANESE_LEXICON

    def process(self, cas: CAS) -> CAS:
        for tok in cas.select("token"):
            if "pos" in tok.features:
                continue
            e = self.lexicon.lookup(tok.covered_text(cas))
            tok.features["pos"] = e.pos if e is not None else "unknown"
        return cas


def default_analysis_engine(lexicon: Optional[Lexicon] = None
                            ) -> AggregateAnalysisEngine:
    """The reference pipeline's shape (sentence → token → morpheme →
    POS) as an aggregate engine."""
    return AggregateAnalysisEngine([
        SentenceAnnotator(),
        TokenAnnotator(),
        LatticeTokenAnnotator(lexicon),
        PosAnnotator(lexicon),
    ])


def engine_tokens(engine: AnalysisEngine, text: str) -> List[str]:
    """Run an engine and read Token annotations back out — what
    `UimaTokenizerFactory.java` does with its AnalysisEngine."""
    cas = engine(text)
    return [a.covered_text(cas) for a in cas.select("token")]
