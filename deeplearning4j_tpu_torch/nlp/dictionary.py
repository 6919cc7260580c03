"""Dictionary-backed CJK morphological segmentation.

The reference vendors a full Kuromoji fork (~6,920 LoC of
lattice-and-Viterbi dictionary analysis) for `deeplearning4j-nlp-japanese`
and a Twitter-text analyzer for `-korean`. This module is the same
*mechanism* in miniature: a cost lattice over an embedded lexicon solved
by Viterbi, with script-run fallback for out-of-vocabulary spans. The
lexicon is deliberately small (no dictionary assets can ship in this
environment) and PLUGGABLE — `Lexicon.from_entries` accepts any
IPADIC-style word list, so a real dictionary drops in without code
changes (the Kuromoji-replacement seam).

Costs: known words cost less than unknown runs, and longer matches cost
less per character, so the lattice prefers "日本語 | を | 勉強 | します"
over per-character or whole-run segmentations — the standard unigram
lattice behavior.

Counterpart of `deeplearning4j_tpu/nlp/dictionary.py`:
host code, a copy of the JAX package's with the port's imports; it gives
the same results.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.language import _script


@dataclass(frozen=True)
class LexEntry:
    surface: str
    pos: str = "unknown"
    cost: float = 0.7
    # MeCab context-class ids for bigram connection costs (0 = the
    # default/BOS/unknown class; unigram lattices ignore them)
    left_id: int = 0
    right_id: int = 0


_UNKNOWN_BASE = 1.3    # an OOV run costs more than any dictionary word
_UNKNOWN_PER_CHAR = 0.3
_KNOWN_LEN_BONUS = 0.05  # longer dictionary matches cost slightly less
_USER_COST = 0.1  # user-dictionary entries sit at the _word_cost floor


@dataclass(frozen=True)
class CharCategory:
    """Unknown-word generation rules for one script class — the char.def
    category row (reference
    `com/atilika/kuromoji/dict/CharacterDefinitions.java`: INVOKE, GROUP,
    LENGTH per category, consumed by `UnknownDictionary.java` /
    `viterbi/ViterbiBuilder.processUnknownWord`).

    invoke: generate unknown candidates even when a dictionary word
    matches at the position (MeCab invoke=1); False = only where the
    dictionary is silent. group: the whole maximal same-class run is a
    candidate. length: additionally, prefixes of 1..length characters
    (KANJI-style short candidates). Costs are per-category — a NUMERIC
    run groups cheaply, an OOV kanji prefix stays expensive. left/right
    ids: the unk.def context classes for the bigram lattice."""

    name: str
    invoke: bool = True
    group: bool = True
    length: int = 1
    cost_base: float = _UNKNOWN_BASE
    cost_per_char: float = _UNKNOWN_PER_CHAR
    left_id: int = 0
    right_id: int = 0


class CharacterDefinitions:
    """Script class → CharCategory table (the char.def role). Categories
    key on this module's `_script` classes (hiragana/katakana/kanji/
    hangul/digit/latin); unmapped classes use `default`."""

    def __init__(self, categories: Dict[str, CharCategory],
                 default: Optional[CharCategory] = None):
        self._cats = dict(categories)
        self._default = default or CharCategory("DEFAULT")

    def category(self, ch: str) -> CharCategory:
        return self._cats.get(_script(ch), self._default)

    @classmethod
    def ipadic_style(cls) -> "CharacterDefinitions":
        """The IPADIC char.def flavor on this module's cost scale:
        NUMERIC/ALPHA runs group into one cheap token (a digit string is
        one number, not per-digit shards), KATAKANA groups (loanwords) with
        short alternatives, KANJI does NOT group — candidates are 1-2 char
        prefixes (real kanji words are short; whole-run unknowns would
        swallow compounds), HIRAGANA generates only where the dictionary
        is silent (function words are in-vocabulary)."""
        return cls({
            "digit": CharCategory("NUMERIC", invoke=True, group=True,
                                  length=0, cost_per_char=0.05),
            "latin": CharCategory("ALPHA", invoke=True, group=True,
                                  length=0, cost_per_char=0.1),
            "katakana": CharCategory("KATAKANA", invoke=True, group=True,
                                     length=2, cost_per_char=0.15),
            "kanji": CharCategory("KANJI", invoke=False, group=False,
                                  length=2),
            "hiragana": CharCategory("HIRAGANA", invoke=False, group=True,
                                     length=2),
            "hangul": CharCategory("HANGUL", invoke=True, group=True,
                                   length=2, cost_per_char=0.15),
        })


# leaf sentinel for the trie: a key that can never collide with a single
# character edge
_LEAF = ""


def _ctx_id(s: str) -> int:
    """MeCab context-class id column → int (blank/garbage → class 0).
    isdecimal, not isdigit: isdigit accepts characters int() rejects
    (superscripts like '²'), which would crash the loader mid-file."""
    return int(s) if s.strip().isdecimal() else 0


class Lexicon:
    """Surface-form dictionary with per-entry cost/POS.

    Lookup structure: a character trie (the `kuromoji/trie/DoubleArrayTrie`
    role — reference `deeplearning4j-nlp-japanese/.../kuromoji/trie/`).
    The lattice asks "which dictionary entries start at position i?", and
    the trie answers with ONE incremental traversal that stops at the
    first missing child — per-position cost is bounded by the longest
    real prefix in the text, not by `max_len` probes each allocating a
    substring, so a 50k+-entry dictionary with long surfaces costs the
    same per position as a toy one (`tests/test_lexicon_loader.py`
    latency bound).

    `connections`: optional (R, L) numpy matrix of bigram connection
    costs on this module's float scale, indexed [prev.right_id,
    next.left_id] — the `matrix.def` half of a MeCab dictionary
    (Kuromoji's `viterbi/ViterbiSearcher` adds exactly this term between
    adjacent lattice nodes). With a matrix loaded the lattice runs a
    BIGRAM Viterbi (states keyed by context class); without one it stays
    unigram."""

    def __init__(self, entries: Iterable[LexEntry], connections=None,
                 char_defs: Optional[CharacterDefinitions] = None):
        self._by_surface: Dict[str, LexEntry] = {}
        self._trie: Dict = {}
        self.connections = connections  # property: memoizes _conn_rows
        # unknown-word generation rules (char.def role); None = the legacy
        # script-run fallback (whole run + single char, flat cost)
        self.char_defs = char_defs
        self.max_len = 1
        entries = list(entries)
        if connections is not None:
            # dimension mismatch (CSV from one distribution, matrix.def
            # from another) must fail HERE: masking it per-lookup would
            # give out-of-range entries free transitions and let them
            # systematically win Viterbi paths
            self._check_ctx_ids(entries, connections)
        for e in entries:
            self._insert(e)

    @property
    def connections(self):
        """(R, L) bigram connection-cost matrix, or None (unigram).
        Assignment re-validates every existing entry's and char
        category's context ids against the NEW matrix shape (the same
        fail-fast contract as construction — an out-of-range id must
        raise ValueError here, not IndexError later inside the bigram
        lattice) and rebuilds the memoized nested-list form the lattice
        indexes (`_conn_rows`) — reassigning after construction cannot
        leave stale costs behind."""
        return self._connections

    @connections.setter
    def connections(self, m):
        if m is not None:
            self._check_ctx_ids(self._by_surface.values(), m)
            self._check_char_def_ids(getattr(self, "_char_defs", None), m)
        self._connections = m
        # nested-list form of the matrix, memoized: the bigram lattice
        # indexes it per (state, edge) — see _viterbi_chunk_bigram — and
        # a per-chunk tolist() of an IPADIC-size (1316x1316) matrix costs
        # ~100 ms, dominating multi-chunk documents
        self._conn_rows = None if m is None else m.tolist()

    @property
    def char_defs(self):
        """Unknown-word generation rules, or None (legacy script-run
        fallback). Assignment validates every category's context ids
        against the current connection matrix — post-construction
        mutation fails fast with ValueError, same as `__init__`."""
        return self._char_defs

    @char_defs.setter
    def char_defs(self, cd):
        conn = getattr(self, "_connections", None)
        if cd is not None and conn is not None:
            self._check_char_def_ids(cd, conn)
        self._char_defs = cd

    @staticmethod
    def _check_char_def_ids(char_defs, connections) -> None:
        if char_defs is None:
            return
        R, L = connections.shape
        for c in list(char_defs._cats.values()) + [char_defs._default]:
            if not (0 <= c.right_id < R and 0 <= c.left_id < L):
                raise ValueError(
                    f"char category {c.name} has context ids "
                    f"(left={c.left_id}, right={c.right_id}) "
                    f"outside the {R}x{L} connection matrix")

    @staticmethod
    def _check_ctx_ids(entries, connections) -> None:
        R, L = connections.shape
        bad = next((e for e in entries
                    if e.right_id >= R or e.left_id >= L
                    or e.right_id < 0 or e.left_id < 0), None)
        if bad is not None:
            raise ValueError(
                f"entry {bad.surface!r} has context ids "
                f"(left={bad.left_id}, right={bad.right_id}) outside "
                f"the {R}x{L} connection matrix — the dictionary CSVs "
                "and matrix.def are from different distributions")

    def _insert(self, e: LexEntry) -> None:
        self._by_surface[e.surface] = e
        self.max_len = max(self.max_len, len(e.surface))
        node = self._trie
        for ch in e.surface:
            node = node.setdefault(ch, {})
        node[_LEAF] = e

    def add_user_entries(self, entries, cost: float = _USER_COST) -> None:
        """User-dictionary overlay (reference
        `com/atilika/kuromoji/dict/UserDictionary.java`): entries insert
        into the SAME trie the lattice walks, replacing built-in entries
        on surface collision, and the default cost — the `_word_cost`
        floor — makes a user entry win Viterbi paths over any built-in
        segmentation of the same span (Kuromoji forces user entries into
        the lattice the same way). Accepts LexEntry objects or
        (surface, pos) pairs."""
        lex_entries = [e if isinstance(e, LexEntry)
                       else LexEntry(e[0], e[1], cost)
                       for e in entries]
        for e in lex_entries:
            if not e.surface:
                raise ValueError("user-dictionary entry with empty surface")
        if self.connections is not None:
            self._check_ctx_ids(lex_entries, self.connections)
        for e in lex_entries:
            self._insert(e)

    def prefixes(self, text: str, i: int, end: int):
        """Yield (j, entry) for every dictionary entry matching
        text[i:j] — one trie walk, no substring allocation."""
        node = self._trie
        while i < end:
            node = node.get(text[i])
            if node is None:
                return
            i += 1
            e = node.get(_LEAF)
            if e is not None:
                yield i, e

    @classmethod
    def from_entries(cls, words: Iterable[Tuple[str, str]],
                     cost: float = 0.7) -> "Lexicon":
        """Build from (surface, pos) pairs — the seam for loading a real
        IPADIC-style dictionary."""
        return cls(LexEntry(w, p, cost) for w, p in words)

    # MeCab integer costs (word and connection) map onto this module's
    # float scale by this divisor; word costs additionally offset+clip
    # into the known-word band
    _COST_SCALE = 20000.0

    @classmethod
    def from_mecab_csv(cls, lines: Iterable[str],
                       base: Optional["Lexicon"] = None,
                       connections=None) -> "Lexicon":
        """Parse MeCab/IPADIC dictionary CSV rows into a Lexicon (the
        loader for real dictionary assets the reference vendors under
        `deeplearning4j-nlp-japanese/`). Format per row:

            surface,left_id,right_id,word_cost,POS1,POS2,...

        surface, left/right context ids, word_cost, and POS1 are
        consumed, so truncated rows with >= 5 fields load fine. IPADIC
        word costs (~ -3000..15000, lower = more common) map
        monotonically onto this module's float scale so loaded words
        interoperate with embedded entries and stay cheaper than the OOV
        fallback. `base`: merge on top of an existing lexicon (loaded
        rows win on surface collisions). `connections`: a pre-scaled
        matrix (see `parse_matrix_def`) enabling the bigram lattice."""
        import csv

        entries: List[LexEntry] = []
        if base is not None:
            entries.extend(base._by_surface.values())
        stripped = (ln for ln in (l.strip() for l in lines)
                    if ln and not ln.startswith("#"))
        # csv.reader, not split(','): real MeCab dictionaries QUOTE
        # surfaces containing commas (Symbol.csv's ',' entry, many
        # neologd rows) — naive splitting would shift every column
        for parts in csv.reader(stripped):
            if len(parts) < 5:
                raise ValueError(
                    f"not a MeCab dictionary row (need >= 5 comma fields, "
                    f"got {len(parts)}): {','.join(parts)[:80]!r}")
            surface = parts[0]
            try:
                word_cost = int(parts[3])
            except ValueError as e:
                raise ValueError(
                    f"bad word_cost in row {','.join(parts)[:80]!r}") from e
            pos = parts[4] or "unknown"
            # -3000..15000 -> ~0.25..1.15: monotone, clipped into the
            # known-word band (below _UNKNOWN_BASE)
            cost = min(1.15, max(0.15, 0.4 + word_cost / cls._COST_SCALE))
            entries.append(LexEntry(surface, pos, cost,
                                    _ctx_id(parts[1]), _ctx_id(parts[2])))
        if connections is None and base is not None:
            connections = base.connections
        return cls(entries, connections=connections,
                   char_defs=base.char_defs if base is not None else None)

    @classmethod
    def parse_matrix_def(cls, lines: Iterable[str]):
        """Parse a MeCab `matrix.def` (bigram connection costs — the
        Kuromoji `ConnectionCosts` role): first line "R L", then
        "right_id left_id cost" rows. Returns an (R, L) float matrix on
        this module's cost scale (signed: negative = preferred
        transition), ready for `Lexicon(..., connections=...)`."""
        import numpy as np

        it = iter(ln for ln in (l.strip() for l in lines) if ln)
        try:
            r, l = (int(x) for x in next(it).split())
        except (StopIteration, ValueError) as e:
            raise ValueError("matrix.def must start with 'R L'") from e
        if r < 1 or l < 1:
            raise ValueError(
                f"matrix.def declares a {r}x{l} matrix; class 0 (BOS/EOS/"
                "unknown) requires at least 1x1")
        m = np.zeros((r, l), np.float32)
        for row in it:
            parts = row.split()
            if len(parts) != 3:
                raise ValueError(
                    f"matrix.def row needs 'right_id left_id cost', got "
                    f"{row[:60]!r}")
            ri, li = int(parts[0]), int(parts[1])
            if not (0 <= ri < r and 0 <= li < l):
                raise ValueError(
                    f"matrix.def row {row[:60]!r} indexes outside the "
                    f"declared {r}x{l} matrix")
            m[ri, li] = float(parts[2]) / cls._COST_SCALE
        return m

    @classmethod
    def from_mecab_path(cls, path,
                        base: Optional["Lexicon"] = None) -> "Lexicon":
        """Load a MeCab CSV file, or a DIRECTORY of them (the layout of an
        unpacked mecab-ipadic distribution: Noun.csv, Verb.csv, ...) —
        the downloadable-dictionary seam: point this at real IPADIC
        assets and the full dictionary drops in. A `matrix.def` in the
        directory loads too, switching the lattice to bigram Viterbi."""
        import pathlib

        p = pathlib.Path(path)
        files = sorted(p.glob("*.csv")) if p.is_dir() else [p]
        if not files:
            raise ValueError(f"no dictionary CSVs under {p}")

        def _read(f):
            # euc-jp is upstream ipadic's encoding; utf-8 the common
            # re-encode. Try utf-8 first, fall back per file.
            try:
                return f.read_text(encoding="utf-8")
            except UnicodeDecodeError:
                return f.read_text(encoding="euc-jp")

        def rows():
            for f in files:
                yield from _read(f).splitlines()

        connections = None
        if p.is_dir() and (p / "matrix.def").exists():
            connections = cls.parse_matrix_def(
                _read(p / "matrix.def").splitlines())
        return cls.from_mecab_csv(rows(), base=base,
                                  connections=connections)

    def lookup(self, surface: str) -> Optional[LexEntry]:
        return self._by_surface.get(surface)

    def __len__(self) -> int:
        return len(self._by_surface)


def viterbi_segment(text: str, lexicon: Lexicon) -> List[Tuple[str, str]]:
    """Minimum-cost segmentation of `text` into (surface, pos) tokens.
    Whitespace and punctuation separate the lattice; unknown spans fall
    back to script runs tagged pos='unknown'. Unigram lattice by
    default; BIGRAM (word costs + connection costs between adjacent
    context classes, Kuromoji's `ViterbiSearcher` model) when the
    lexicon carries a connection matrix."""
    chunk_fn = (_viterbi_chunk_bigram if lexicon.connections is not None
                else _viterbi_chunk)
    out: List[Tuple[str, str]] = []
    n = len(text)
    i = 0
    while i < n:
        ch = text[i]
        if _script(ch) in ("space", "other"):
            i += 1
            continue
        j = _chunk_end(text, i)
        out.extend(chunk_fn(text[i:j], lexicon))
        i = j
    return out


def _chunk_end(text: str, i: int) -> int:
    j = i
    while j < len(text) and _script(text[j]) not in ("space", "other"):
        j += 1
    return j


def _run_ends(chunk: str) -> List[int]:
    """run_end[i]: end of the maximal same-script run starting at i,
    precomputed right-to-left in ONE pass (recomputing per position
    would make long same-script chunks quadratic). Shared by the unigram
    and bigram lattices so the OOV fallback edges are identical."""
    n = len(chunk)
    scripts = [_script(c) for c in chunk]
    run_end = [0] * n
    for i in range(n - 1, -1, -1):
        run_end[i] = (run_end[i + 1]
                      if i + 1 < n and scripts[i + 1] == scripts[i]
                      else i + 1)
    return run_end


def _word_cost(e: LexEntry, i: int, j: int) -> float:
    """Dictionary-edge cost with the length bonus — ONE definition so
    unigram and bigram lattices can never drift apart."""
    return max(0.1, e.cost - _KNOWN_LEN_BONUS * (j - i - 1))


def _unknown_edges(chunk: str, i: int, run_end_i: int, lexicon: Lexicon,
                   dict_matched: bool):
    """Unknown-word candidates starting at i: [(j, cost, lid, rid)] —
    ONE generator for both lattices (the reference's
    `ViterbiBuilder.processUnknownWord` consuming
    `CharacterDefinitions`/`UnknownDictionary`).

    Without char_defs: the legacy fallback — the maximal script run
    (never zero-length, so the lattice always reaches n) AND a
    single-char edge, so an OOV prefix cannot swallow in-vocabulary
    words later in the same run; always generated (legacy invoke=all).
    With char_defs: the category's invoke/group/length rules decide the
    candidate set and its per-category costs; a position where the
    dictionary matched and invoke=False generates nothing (the
    dictionary edges advance the lattice, so completeness holds)."""
    cd = lexicon.char_defs
    if cd is None:
        return [(j, _UNKNOWN_BASE + _UNKNOWN_PER_CHAR * (j - i), 0, 0)
                for j in {run_end_i, i + 1}]
    c = cd.category(chunk[i])
    if dict_matched and not c.invoke:
        return []
    js = set()
    if c.group:
        js.add(run_end_i)
    for L in range(1, min(c.length, run_end_i - i) + 1):
        js.add(i + L)
    if not js and not dict_matched:
        js.add(i + 1)  # completeness: a silent position must advance
    return [(j, c.cost_base + c.cost_per_char * (j - i),
             c.left_id, c.right_id) for j in js]


def _viterbi_chunk(chunk: str, lexicon: Lexicon) -> List[Tuple[str, str]]:
    n = len(chunk)
    INF = float("inf")
    best = [INF] * (n + 1)
    back: List[Optional[Tuple[int, str, str]]] = [None] * (n + 1)
    best[0] = 0.0
    run_end = _run_ends(chunk)
    for i in range(n):
        if best[i] == INF:
            continue
        # dictionary matches starting at i: ONE trie traversal yields
        # every matching prefix (stops at the first missing child — cost
        # no longer max_len probes x substring allocations per position)
        matched = False
        for j, e in lexicon.prefixes(chunk, i, n):
            matched = True
            c = best[i] + _word_cost(e, i, j)
            if c < best[j]:
                best[j] = c
                back[j] = (i, e.surface, e.pos)
        # unknown candidates per the char.def rules (legacy run+char
        # fallback when the lexicon has no CharacterDefinitions)
        for j, ucost, _, _ in _unknown_edges(chunk, i, run_end[i],
                                             lexicon, matched):
            c = best[i] + ucost
            if c < best[j]:
                best[j] = c
                back[j] = (i, chunk[i:j], "unknown")
    # safety: lattice is always complete (the unknown edge advances), but
    # guard against pathological inputs
    if best[n] == INF:
        return [(chunk, "unknown")]
    toks: List[Tuple[str, str]] = []
    i = n
    while i > 0:
        prev, surf, pos = back[i]
        toks.append((surf, pos))
        i = prev
    toks.reverse()
    return toks


def _viterbi_chunk_bigram(chunk: str, lexicon: Lexicon
                          ) -> List[Tuple[str, str]]:
    """Bigram lattice: path cost = Σ word costs + Σ connection costs
    between adjacent (prev.right_id, next.left_id) context-class pairs —
    the Kuromoji `ViterbiSearcher` model over `ConnectionCosts`
    (matrix.def). DP states are (position, arriving right_id); BOS/EOS
    and unknown tokens use class 0 (MeCab's convention). Per position the
    state count is bounded by the distinct right_ids of incoming edges,
    so cost stays near the unigram lattice for real dictionaries."""
    # entry ids are validated against the matrix shape at Lexicon
    # construction, so no per-lookup bounds checks; plain nested lists
    # index ~100 ns faster than numpy scalar extraction in this
    # states x edges hot loop (memoized on the Lexicon — converting per
    # chunk dominated multi-chunk documents)
    conn: List[List[float]] = lexicon._conn_rows
    n = len(chunk)
    run_end = _run_ends(chunk)
    # states[i]: rid -> (cost, back) with back = (i_prev, rid_prev,
    # surface, pos)
    states: List[Dict[int, Tuple[float, Optional[tuple]]]] = \
        [dict() for _ in range(n + 1)]
    states[0][0] = (0.0, None)  # BOS carries context class 0
    for i in range(n):
        if not states[i]:
            continue
        edges = []  # (j, surface, pos, lid, rid, word_cost)
        for j, e in lexicon.prefixes(chunk, i, n):
            edges.append((j, e.surface, e.pos, e.left_id, e.right_id,
                          _word_cost(e, i, j)))
        for j, ucost, lid, rid in _unknown_edges(chunk, i, run_end[i],
                                                 lexicon, bool(edges)):
            edges.append((j, chunk[i:j], "unknown", lid, rid, ucost))
        for rid_prev, (c_prev, _) in list(states[i].items()):
            row = conn[rid_prev]
            for j, surf, pos, lid, rid, wc in edges:
                c = c_prev + wc + row[lid]
                cur = states[j].get(rid)
                if cur is None or c < cur[0]:
                    states[j][rid] = (c, (i, rid_prev, surf, pos))
    if not states[n]:  # unreachable in practice (unknown edges advance)
        return [(chunk, "unknown")]
    # EOS transition: class 0
    end_rid = min(states[n],
                  key=lambda rid: states[n][rid][0] + conn[rid][0])
    toks: List[Tuple[str, str]] = []
    i, rid = n, end_rid
    while i > 0:
        _, back = states[i][rid]
        i_prev, rid_prev, surf, pos = back
        toks.append((surf, pos))
        i, rid = i_prev, rid_prev
    toks.reverse()
    return toks


# ---------------------------------------------------------------------------
# Embedded Japanese lexicon — particles, auxiliaries, copulas, common
# verbs/adjectives/nouns. Small by necessity; the Kuromoji replacement
# seam is `Lexicon.from_entries` above.

_JA_PARTICLES = ["は", "が", "を", "に", "で", "と", "も", "へ", "の",
                 "や", "か", "ね", "よ", "から", "まで", "より", "など",
                 "だけ", "しか", "でも", "には", "とは", "ので", "のに"]
_JA_AUX = ["です", "でした", "ます", "ました", "ません", "ましょう",
           "する", "します", "しました", "した", "して", "している",
           "だ", "だった", "である", "ない", "なかった", "ある",
           "あります", "いる", "います", "いた", "れる", "られる",
           "たい", "ください"]
_JA_NOUNS = ["日本", "日本語", "東京", "学校", "学生", "先生", "勉強",
             "研究", "会社", "仕事", "言葉", "今日", "明日", "昨日",
             "時間", "天気", "電車", "映画", "音楽", "料理", "水",
             "本", "人", "私", "彼", "彼女", "猫", "犬", "山", "川",
             "機械", "学習", "計算", "模型"]
_JA_VERBS = ["行く", "行きます", "行った", "来る", "来ます", "来た",
             "食べる", "食べます", "食べた", "飲む", "飲みます",
             "読む", "読みます", "読んだ", "見る", "見ます", "見た",
             "書く", "書きます", "話す", "話します", "使う", "使います",
             "思う", "思います", "分かる", "分かります"]
_JA_ADJ = ["速い", "遅い", "高い", "安い", "大きい", "小さい",
           "新しい", "古い", "良い", "悪い", "面白い", "難しい",
           "簡単", "きれい", "静か"]

JAPANESE_LEXICON = Lexicon(
    [LexEntry(w, "particle", 0.5) for w in _JA_PARTICLES]
    + [LexEntry(w, "auxiliary", 0.6) for w in _JA_AUX]
    + [LexEntry(w, "noun", 0.7) for w in _JA_NOUNS]
    + [LexEntry(w, "verb", 0.7) for w in _JA_VERBS]
    + [LexEntry(w, "adjective", 0.7) for w in _JA_ADJ],
    char_defs=CharacterDefinitions.ipadic_style())


def load_bundled_ipadic_sample(base: Optional[Lexicon] = JAPANESE_LEXICON
                               ) -> Lexicon:
    """The committed IPADIC-format sample dictionary
    (`nlp/data/ipadic_sample.csv`, ~450 entries: common nouns, verbs,
    adjectives, katakana loanwords) merged over the embedded
    mini-lexicon — the in-repo stand-in for pointing
    `Lexicon.from_mecab_path` at a full unpacked mecab-ipadic; also
    honors `DL4J_TPU_IPADIC_DIR` to load real assets instead."""
    import os
    import pathlib

    override = os.environ.get("DL4J_TPU_IPADIC_DIR")
    if override:
        return Lexicon.from_mecab_path(override, base=base)
    p = pathlib.Path(__file__).resolve().parent / "data" / "ipadic_sample.csv"
    return Lexicon.from_mecab_path(p, base=base)


# ---------------------------------------------------------------------------
# Embedded Korean lexicon — josa (case particles) and common verb/copula
# endings; eojeol are split stem + particle(s), Twitter-text style.

KOREAN_PARTICLES = ["은", "는", "이", "가", "을", "를", "에", "의",
                    "와", "과", "도", "로", "으로", "에서", "부터",
                    "까지", "에게", "한테", "처럼", "보다", "마다",
                    "이나", "든지"]
KOREAN_ENDINGS = ["입니다", "합니다", "습니다", "있습니다", "없습니다",
                  "했습니다", "인다", "한다", "된다", "이다", "하다",
                  "했다", "되다"]

_KO_SUFFIXES = tuple(sorted(set(KOREAN_PARTICLES + KOREAN_ENDINGS),
                            key=len, reverse=True))


def split_korean_eojeol(token: str) -> List[Tuple[str, str]]:
    """Split one whitespace-delimited eojeol into stem + trailing
    particle/ending morphemes via longest-suffix dictionary matching
    (iterated, so '학교에서는' → 학교/에서/는)."""
    suffixes: List[Tuple[str, str]] = []
    stem = token
    single_char_stripped = False
    while len(stem) >= 2 and len(suffixes) < 2:  # josa stack depth <= 2
        for sfx in _KO_SUFFIXES:
            if not (stem.endswith(sfx) and len(stem) > len(sfx)
                    and all(_script(c) == "hangul"
                            for c in stem[:-len(sfx)])):
                continue
            if len(sfx) == 1:
                # single-char josa: at most one (the outermost), and not
                # when the remaining stem ends in the same syllable
                # (reduplicated words like 바나나 are not stem+josa)
                if single_char_stripped or stem[-2] == sfx:
                    continue
                single_char_stripped = True
            kind = ("ending" if sfx in KOREAN_ENDINGS else "particle")
            suffixes.append((sfx, kind))
            stem = stem[:-len(sfx)]
            break
        else:
            break
    return [(stem, "stem")] + list(reversed(suffixes))
