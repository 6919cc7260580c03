"""The NLP package of the port (`deeplearning4j_tpu_torch.nlp`) against the
JAX package's, on the CPU at small sizes: tokenizers, vocabularies,
Huffman codes, unigram tables and the host pair stream are identical; the
scatter steps agree to 1e-6 on the same inputs; CBOW, hierarchical-
softmax, ParagraphVectors and GloVe fits (every random draw on the host,
from the same numpy seeds) agree to 1e-5; serialized files cross both
ways. The NS skip-gram path draws its negatives on the device from a
`torch.Generator`, so it is held by statistics and by the reference's
topic-separation criterion, and two same-seed CPU fits are identical."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deeplearning4j_tpu.nlp as J
import deeplearning4j_tpu_torch.nlp as T
from deeplearning4j_tpu.nlp import kernels as jk
from deeplearning4j_tpu.nlp import sequence_vectors as jsv
from deeplearning4j_tpu_torch.nlp import kernels as tk
from deeplearning4j_tpu_torch.nlp import sequence_vectors as tsv

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores, so that
    every small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _topic_corpus(n_sentences=300, seed=0):
    """The reference tests' corpus: two disjoint topic vocabularies."""
    rng = np.random.default_rng(seed)
    topics = [["cat", "dog", "pet", "fur", "paw", "tail"],
              ["sun", "moon", "star", "sky", "orbit", "comet"]]
    return [list(rng.choice(topics[int(rng.integers(0, 2))], size=8))
            for _ in range(n_sentences)]


def _zipf_corpus(vocab_size, n_sentences, sent_len, seed=0):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab_size + 1)
    probs /= probs.sum()
    words = np.array([f"w{i}" for i in range(vocab_size)])
    return [list(words[row]) for row in
            rng.choice(vocab_size, (n_sentences, sent_len), p=probs)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------ tokenizers

TEXTS = ["The Quick, Brown FOX!! 123 jumps.", "  a b\tc \n d  ",
         "It's (a) test: [x]/y? z; w!"]


def _both(module):
    return [__import__(f"{pkg}.nlp.{module}", fromlist=["x"])
            for pkg in ("deeplearning4j_tpu", "deeplearning4j_tpu_torch")]


def test_tokenizers_give_identical_tokens():
    got = []
    for tz in _both("tokenization"):
        res = []
        for pre in (None, tz.CommonPreprocessor(), tz.LowCasePreProcessor()):
            for f in (tz.DefaultTokenizerFactory(),
                      tz.NGramTokenizerFactory(min_n=1, max_n=3)):
                if pre is not None:
                    f.set_token_pre_processor(pre)
                res.append([f.create(t).get_tokens() for t in TEXTS])
                res.append([f.create(t).count_tokens() for t in TEXTS])
        got.append(res)
    assert got[0] == got[1]


JA = ["東京都に住んでいます。", "私は日本語を勉強しています",
      "JAXは速い123です。", "猫が水を飲みます", "ヘリコプターは速い"]
KO = ["나는 학교에 갑니다", "저는 학교에서는 공부합니다", "한국어를 공부합니다."]


def test_japanese_korean_and_uima_tokenizers_give_identical_tokens(
        tmp_path, monkeypatch):
    got = []
    for lang, dic, uima in zip(_both("language"), _both("dictionary"),
                               _both("uima")):
        ja, ko = lang.JapaneseTokenizerFactory(), lang.KoreanTokenizerFactory()
        lex = dic.Lexicon.from_entries([("量子計算", "noun"),
                                        ("は", "particle"),
                                        ("面白い", "adjective")])
        res = [[ja.create(t).get_tokens() for t in JA],
               [ja.tokenize_with_pos(t) for t in JA],
               [lang.JapaneseTokenizerFactory(use_dictionary=False).create(
                   t).get_tokens() for t in JA],
               [ko.create(t).get_tokens() for t in KO],
               [lang.KoreanTokenizerFactory(particles="keep").create(
                   t).get_tokens() for t in KO],
               [dic.split_korean_eojeol(w) for t in KO for w in t.split()],
               dic.viterbi_segment("量子計算は面白い", lex),
               [lang.UimaTokenizerFactory().create(t).get_tokens()
                for t in JA + KO + TEXTS],
               list(lang.UimaSentenceIterator(
                   ["First one. Second two! 三番目です。最後?"])),
               uima.engine_tokens(uima.default_analysis_engine(),
                                  "私は東京の学生です。 hello 世界 123"),
               [dic.viterbi_segment(t, dic.load_bundled_ipadic_sample())
                for t in JA]]
        # DL4J_TPU_IPADIC_DIR points both packages at other assets
        (tmp_path / "Noun.csv").write_text(
            "量子計算,0,0,100,名詞,一般,*,*,*,*,量子計算,*,*\n",
            encoding="utf-8")
        monkeypatch.setenv("DL4J_TPU_IPADIC_DIR", str(tmp_path))
        res.append(dic.viterbi_segment("量子計算は面白い",
                                       dic.load_bundled_ipadic_sample()))
        monkeypatch.delenv("DL4J_TPU_IPADIC_DIR")
        got.append(res)
    assert got[0] == got[1]
    assert all(got[1][0]) and all(got[1][3])
    assert got[1][-1][0][0] == "量子計算"


def test_sentence_iterators_and_bag_of_words_match(tmp_path):
    p = tmp_path / "lines.txt"
    p.write_text("one two\nthree four five\n\nsix\n", encoding="utf-8")
    docs = ["the cat sat", "the dog sat down", "a cat and a dog", "cat"]
    got = []
    for M in (J, T):
        it = M.BasicLineIterator(p)
        it.pre_processor = str.upper
        col = M.CollectionSentenceIterator(docs)
        bow = M.BagOfWordsVectorizer().fit_transform(docs)
        tfidf = M.TfidfVectorizer(min_word_frequency=1).fit_transform(docs)
        got.append((list(it), list(col), bow, tfidf))
    assert got[0][:2] == got[1][:2]
    for a, b in zip(got[0][2:], got[1][2:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ vocabulary

def _vocab_rows(cache):
    return [(vw.word, vw.count, vw.index, list(vw.codes), list(vw.points))
            for vw in cache.vocab_words()]


@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_huffman_and_unigram_table_identical(min_freq):
    seqs = _zipf_corpus(300, 120, 15, seed=4)
    caches = []
    for M in (J, T):
        c = M.VocabConstructor(min_word_frequency=min_freq).build_vocab(seqs)
        __import__(M.__name__ + ".vocab",
                   fromlist=["x"]).build_huffman_tree(c)
        caches.append(c)
    a, b = caches
    assert _vocab_rows(a) == _vocab_rows(b)
    assert a.total_word_occurrences == b.total_word_occurrences
    np.testing.assert_array_equal(a.unigram_table(), b.unigram_table())
    np.testing.assert_array_equal(a.unigram_table(0.5), b.unigram_table(0.5))


def test_window_pairs_identical():
    rng = np.random.default_rng(0)
    lens = np.array([7, 1, 12, 3, 30], np.int64)
    ids = rng.integers(0, 50, lens.sum()).astype(np.int32)
    for window in (1, 3, 5):
        a = jsv._window_pairs(ids, lens, window, np.random.default_rng(9))
        b = tsv._window_pairs(ids, lens, window, np.random.default_rng(9))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _spy_stream(mod, kernels_mod, monkeypatch):
    """Record the host pair stream of a vectorized NS fit: every
    `add_pairs` call, and every flush's staged rows as the device step
    gets them (valid pairs only)."""
    adds, flushed = [], []
    orig_add = mod._PairBatcher.add_pairs

    def add(self, centers, contexts, alpha):
        adds.append((np.array(centers), np.array(contexts),
                     np.array(alpha, np.float32)))
        return orig_add(self, centers, contexts, alpha)

    orig_step = kernels_mod.skipgram_ns_scan

    def step(syn0, syn1, centers, contexts, cdf, key, acc, lrs, nvalids,
             negative):
        nv = _np(nvalids).astype(np.int64)
        c, x, lr = _np(centers), _np(contexts), _np(lrs)
        rows = [k for k in range(len(nv)) if nv[k] > 0]
        flushed.append((np.concatenate([c[k, :nv[k]] for k in rows]),
                        np.concatenate([x[k, :nv[k]] for k in rows]),
                        lr[rows], nv[rows]))
        return orig_step(syn0, syn1, centers, contexts, cdf, key, acc, lrs,
                         nvalids, negative)

    monkeypatch.setattr(mod._PairBatcher, "add_pairs", add)
    monkeypatch.setattr(mod.SequenceVectors, "_ns_kernel",
                        lambda self: step)
    return adds, flushed


@pytest.mark.parametrize("sampling", [0.0, 1e-2])
def test_host_pair_stream_identical(sampling, monkeypatch):
    """Subsampling, shrinking windows, chunking and the per-pair alpha:
    the (center, context, alpha) stream and every flush's rows are the
    JAX package's."""
    monkeypatch.setattr(jsv.SequenceVectors, "_CHUNK_TOKENS", 900)
    monkeypatch.setattr(tsv.SequenceVectors, "_CHUNK_TOKENS", 900)
    seqs = _zipf_corpus(200, 160, 12, seed=5)
    streams = []
    for M, mod, km, extra in ((J, jsv, jk, {}), (T, tsv, tk, CPU)):
        spy = _spy_stream(mod, km, monkeypatch)
        w = M.Word2Vec(layer_size=8, window=4, negative=3, epochs=2,
                       batch_size=128, scan_flushes=4, sampling=sampling,
                       seed=11, **extra)
        w.fit(seqs)
        streams.append(spy)
    (ja, jf), (ta, tf) = streams
    assert len(ja) == len(ta) > 2 and len(jf) == len(tf) > 2
    for x, y in zip(ja + jf, ta + tf):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


def test_host_negatives_identical():
    seqs = _zipf_corpus(100, 50, 10, seed=6)
    draws = []
    for M, extra in ((J, {}), (T, CPU)):
        sv = M.SequenceVectors(negative=4, seed=3, **extra)
        sv.build_vocab(seqs)
        draws.append(sv._sample_negatives((64, 4)))
    np.testing.assert_array_equal(*draws)


# --------------------------------------------------------------- kernels

def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _pair(rng, V, D, B, K, lr_scale=1.0):
    syn0, syn1 = _rand(rng, V, D, scale=0.3), _rand(rng, V, D, scale=0.3)
    center = rng.integers(0, V, B).astype(np.int32)
    targets = rng.integers(0, V, (B, K)).astype(np.int32)
    labels = (rng.random((B, K)) < 0.3).astype(np.float32)
    mask = (rng.random((B, K)) < 0.9).astype(np.float32)
    return syn0, syn1, center, targets, labels, mask, np.float32(lr_scale)


def _t(a, long=False):
    t = torch.from_numpy(np.array(a))
    return t.long() if long else t


def _close(got, ref, tol=1e-6):
    for g, r in zip(got, ref):
        g, r = _np(g), np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


@pytest.mark.parametrize("V,B", [(40, 64), (5000, 16)],
                         ids=["accumulator", "sorted segments"])
@pytest.mark.parametrize("lr", [0.05, 20.0], ids=["small", "clipped"])
def test_scatter_clipped_both_regimes_match(V, B, lr):
    rng = np.random.default_rng(1)
    table = _rand(rng, V, 8)
    idx = rng.integers(0, min(V, 30), (B, 3)).astype(np.int32)
    upd = _rand(rng, B, 3, 8, scale=lr)
    ref = jk._scatter_clipped(jnp.asarray(table), jnp.asarray(idx),
                              jnp.asarray(upd))
    got = tk._scatter_clipped(_t(table), _t(idx, True), _t(upd))
    _close([got], [ref])
    if lr > 1:  # the clip binds: each touched row moved by at most 1
        moved = np.linalg.norm(_np(got) - table, axis=1)
        assert moved.max() <= 1.0 + 1e-5 and moved.max() > 0.9


@pytest.mark.parametrize("V", [30, 3000])
def test_skipgram_step_matches(V):
    rng = np.random.default_rng(2)
    s0, s1, c, tg, lb, mk, lr = _pair(rng, V, 16, 48, 6, lr_scale=0.5)
    ref = jk.skipgram_step(s0.copy(), s1.copy(), c, tg, lb, mk, lr)
    got = tk.skipgram_step(_t(s0), _t(s1), _t(c, True), _t(tg, True),
                           _t(lb), _t(mk), float(lr))
    _close(got, ref)


def test_cbow_step_matches():
    rng = np.random.default_rng(3)
    V, D, B, W, K = 50, 12, 32, 6, 5
    s0, s1 = _rand(rng, V, D, scale=0.3), _rand(rng, V, D, scale=0.3)
    ctx = rng.integers(0, V, (B, W)).astype(np.int32)
    cmask = (rng.random((B, W)) < 0.7).astype(np.float32)
    tg = rng.integers(0, V, (B, K)).astype(np.int32)
    lb = (rng.random((B, K)) < 0.3).astype(np.float32)
    mk = np.ones((B, K), np.float32)
    ref = jk.cbow_step(s0.copy(), s1.copy(), ctx, cmask, tg, lb, mk,
                       np.float32(0.7))
    got = tk.cbow_step(_t(s0), _t(s1), _t(ctx, True), _t(cmask),
                       _t(tg, True), _t(lb), _t(mk), 0.7)
    _close(got, ref)


def test_infer_step_matches():
    rng = np.random.default_rng(4)
    vec = _rand(rng, 16, scale=0.1)
    syn1 = _rand(rng, 40, 16, scale=0.5)
    tg = rng.integers(0, 40, (9, 7)).astype(np.int32)
    lb = (rng.random((9, 7)) < 0.5).astype(np.float32)
    mk = (rng.random((9, 7)) < 0.8).astype(np.float32)
    ref = jk.infer_step(vec.copy(), syn1, tg, lb, mk, np.float32(0.3))
    got = tk.infer_step(_t(vec), _t(syn1), _t(tg, True), _t(lb), _t(mk), 0.3)
    _close(got, ref)


def test_glove_step_matches_with_duplicate_rows():
    """Duplicate rows make the order of the history add and its read
    visible: the steps read the histories after the whole batch's add."""
    rng = np.random.default_rng(5)
    V, D, B = 12, 8, 64
    W, Wc = _rand(rng, V, D, scale=0.2), _rand(rng, V, D, scale=0.2)
    b, bc = _rand(rng, V, scale=0.1), _rand(rng, V, scale=0.1)
    hW, hWc = np.ones((V, D), np.float32), np.ones((V, D), np.float32)
    hb, hbc = np.ones(V, np.float32), np.ones(V, np.float32)
    rows = rng.integers(0, 4, B).astype(np.int32)
    cols = rng.integers(0, V, B).astype(np.int32)
    v = rng.uniform(0.5, 30, B).astype(np.float32)
    logX, fX = np.log(v), np.minimum((v / 10.0) ** 0.75, 1.0).astype(
        np.float32)
    ref = jk.glove_step(*(a.copy() for a in (W, b, hW, hb, Wc, bc, hWc,
                                              hbc)),
                        rows, cols, logX, fX, np.float32(0.05))
    got = tk.glove_step(*(_t(a) for a in (W, b, hW, hb, Wc, bc, hWc, hbc)),
                        _t(rows, True), _t(cols, True), _t(logX), _t(fX),
                        0.05)
    _close(got, ref)


def test_ns_batch_with_given_negatives_matches_pair_update():
    """`_ns_batch` builds the NS targets on the device: the context first
    (label 1), negatives equal to it masked, rows past nvalid masked.
    With the negatives given, it equals `_pair_update` on targets built
    here, and the JAX package's `_pair_update` on the same."""
    rng = np.random.default_rng(6)
    V, D, B, N = 25, 8, 40, 5
    s0, s1 = _rand(rng, V, D, scale=0.3), _rand(rng, V, D, scale=0.3)
    center = rng.integers(0, V, B).astype(np.int32)
    context = rng.integers(0, V, B).astype(np.int32)
    negs = rng.integers(0, V, (B, N)).astype(np.int32)
    negs[::3, 1] = context[::3]  # collisions with the positive
    nvalid = 31
    targets = np.concatenate([context[:, None], negs], 1)
    labels = np.zeros((B, N + 1), np.float32)
    labels[:, 0] = 1.0
    mask = np.concatenate([np.ones((B, 1), np.float32),
                           (negs != context[:, None]).astype(np.float32)], 1)
    mask[nvalid:] = 0.0
    got = tk._ns_batch(_t(s0), _t(s1), None, _t(center, True),
                       _t(context, True), None, 0.4, torch.tensor(nvalid),
                       N, negs=_t(negs, True))
    want = tk._pair_update(_t(s0), _t(s1), _t(center, True),
                           _t(targets, True), _t(labels), _t(mask), 0.4)
    ref = jk._pair_update(*map(jnp.asarray, (s0, s1, center, targets,
                                             labels, mask)), np.float32(0.4))
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    _close(got[:3], ref)


def test_device_draws_follow_the_unigram_table():
    """The negatives drawn by the generator follow the 0.75-power table
    (chi-square), the tail is drawn, and the draws repeat per seed."""
    seqs = _zipf_corpus(400, 300, 20, seed=7)
    sv = T.SequenceVectors(negative=5, seed=3, **CPU)
    sv.build_vocab(seqs)
    cdf, gen = sv._ns_device_state()
    assert cdf.dtype == torch.int64 and int(cdf[-1]) <= 2 ** 32 - 1
    p = sv.vocab.unigram_table()
    n = 400_000
    negs = tk._draw_negatives(cdf, gen, n // 5, 5)
    counts = np.bincount(negs.numpy().ravel(), minlength=len(p))
    expected = n * p
    chi2 = ((counts - expected) ** 2 / expected).sum()
    dof = len(p) - 1
    assert abs(chi2 - dof) < 6 * np.sqrt(2 * dof), (chi2, dof)
    tail = np.argsort(p)[:20]
    assert (counts[tail] > 0).all()
    g2 = torch.Generator().manual_seed(3)
    again = tk._draw_negatives(cdf, g2, n // 5, 5)
    assert torch.equal(negs, again)


def test_device_cdf_keeps_the_tail_in_fixed_point():
    """Rare tail words keep their own fixed-point slots (the JAX
    package's `test_device_cdf_preserves_tail_probabilities`)."""
    sv = T.SequenceVectors(negative=5, min_word_frequency=1, **CPU)
    sv.build_vocab([["head"] * 50 + [f"tail{i}"] for i in range(5000)])
    cdf, _ = sv._ns_device_state()
    jv = J.SequenceVectors(negative=5, min_word_frequency=1)
    jv.build_vocab([["head"] * 50 + [f"tail{i}"] for i in range(5000)])
    ref, _ = jv._ns_device_state()
    np.testing.assert_array_equal(cdf.numpy(), np.asarray(ref).astype(
        np.int64))
    assert (np.diff(cdf.numpy()) > 0).mean() > 0.99


# ------------------------------------------------------------- end to end

KW = dict(layer_size=24, window=3, batch_size=256, seed=7)


def _fit_both(make):
    a, b = make(J, {}), make(T, CPU)
    return a, b


def _syn0_close(a, b, tol=1e-5):
    np.testing.assert_allclose(b.lookup_table.syn0.numpy(),
                               np.asarray(a.lookup_table.syn0),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("mode", ["cbow", "hs", "mixed"])
def test_word2vec_fits_match(mode):
    corpus = _topic_corpus()

    def make(M, extra):
        if mode == "cbow":
            w = M.Word2Vec(negative=5, elements_learning_algorithm="cbow",
                           epochs=4, learning_rate=0.1, **KW, **extra)
        elif mode == "hs":
            w = M.Word2Vec(negative=0, use_hierarchic_softmax=True,
                           epochs=3, learning_rate=0.05, **KW, **extra)
        else:
            w = M.Word2Vec(negative=3, use_hierarchic_softmax=True,
                           epochs=2, learning_rate=0.05, **KW, **extra)
        w.fit(corpus)
        return w

    a, b = _fit_both(make)
    _syn0_close(a, b)
    syn1 = b.lookup_table.syn1neg if mode == "cbow" else b.lookup_table.syn1
    ref = a.lookup_table.syn1neg if mode == "cbow" else a.lookup_table.syn1
    np.testing.assert_allclose(syn1.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert abs(a.mean_loss - b.mean_loss) < 1e-5


@pytest.mark.parametrize("algo", ["dbow", "dm"])
def test_paragraph_vectors_hs_fit_incremental_and_infer_match(algo):
    corpus = _topic_corpus(80, seed=1)
    docs = [(f"d{i}", " ".join(s)) for i, s in enumerate(corpus[:50])]
    more = [(f"e{i}", " ".join(s)) for i, s in enumerate(corpus[50:])]

    def make(M, extra):
        p = M.ParagraphVectors(sequence_learning_algorithm=algo,
                               layer_size=16, window=3, epochs=4, seed=3,
                               negative=0, use_hierarchic_softmax=True,
                               **extra)
        p.fit(docs)
        p.fit(more + docs[:5])  # incremental: appends the new doc rows
        return p

    a, b = _fit_both(make)
    assert a.labels == b.labels
    assert b.lookup_table.syn0.shape[0] == b.vocab.num_words() + 80
    _syn0_close(a, b)
    for text in ("cat dog pet fur", "sun moon star"):
        np.testing.assert_allclose(b.infer_vector(text, steps=10),
                                   a.infer_vector(text, steps=10),
                                   rtol=1e-5, atol=1e-5)
    assert [l for l, _ in b.docs_nearest("d0", 5)] == \
        [l for l, _ in a.docs_nearest("d0", 5)]


@pytest.mark.parametrize("cap", [None, 7])
def test_glove_fit_matches(cap, tmp_path):
    corpus = _topic_corpus(120, seed=2)

    def make(M, extra):
        g = M.Glove(layer_size=16, epochs=8, batch_size=64, seed=4,
                    cooccurrence_memory_cap=cap,
                    spill_dir=None if cap is None else tmp_path / M.__name__,
                    **extra)
        g.fit(corpus)
        return g

    a, b = _fit_both(make)
    _syn0_close(a, b)
    assert abs(a.mean_loss - b.mean_loss) < 1e-5
    assert b.similarity("cat", "dog") > b.similarity("cat", "moon")


def test_cooccurrence_counter_gives_the_same_triples(tmp_path):
    rng = np.random.default_rng(8)
    adds = [(int(i), int(j), float(w)) for i, j, w in zip(
        rng.integers(0, 30, 2000), rng.integers(0, 30, 2000),
        rng.random(2000))]
    out = []
    for M, d in ((J, tmp_path / "j"), (T, tmp_path / "t")):
        g = __import__(M.__name__ + ".glove", fromlist=["x"])
        c = g.CooccurrenceCounter(memory_cap_pairs=50, spill_dir=d)
        for a in adds:
            c.add(*a)
        out.append([np.array(x) for x in c.finalize()])
    for x, y in zip(*out):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_skipgram_ns_topic_separation_and_same_seed_fits():
    """The reference's criterion (`tests/test_nlp.py::
    test_word2vec_topic_separation`, mode "ns") on the port's device
    draws; two CPU fits from one seed are bit-identical."""
    corpus = _topic_corpus()
    fits = []
    for _ in range(2):
        w = T.Word2Vec(negative=5, epochs=3, learning_rate=0.05, **KW, **CPU)
        w.fit(corpus)
        fits.append(w)
    w = fits[0]
    assert w.similarity("cat", "dog") > w.similarity("cat", "moon")
    nearest = [x for x, _ in w.words_nearest("sun", 3)]
    assert len(set(nearest) & {"moon", "star", "sky", "orbit", "comet"}) >= 2
    assert torch.equal(fits[0].lookup_table.syn0, fits[1].lookup_table.syn0)
    assert torch.equal(fits[0].lookup_table.syn1neg,
                       fits[1].lookup_table.syn1neg)
    assert fits[0].mean_loss == fits[1].mean_loss > 0


def test_ns_fit_decays_alpha_within_one_chunk_and_resets_loss(monkeypatch):
    """Per-pair alpha decay reaches the device rows inside a single chunk,
    and a refit starts a fresh loss accumulator."""
    seen = []
    orig = tk.skipgram_ns_scan

    def step(*a):
        nv = a[8].numpy()
        seen.extend(a[7].numpy()[nv > 0].tolist())
        return orig(*a)

    monkeypatch.setattr(tsv.SequenceVectors, "_ns_kernel", lambda s: step)
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    sents = [[words[j] for j in rng.integers(0, 40, 15)] for _ in range(80)]
    w = T.Word2Vec(layer_size=16, negative=3, epochs=1, learning_rate=0.05,
                   batch_size=64, scan_flushes=4, seed=1, **CPU)
    w.fit(sents)
    assert seen[0] == np.float32(0.05)
    assert all(x > y for x, y in zip(seen, seen[1:]))
    assert seen[-1] < 0.1 * seen[0]
    m1 = w.mean_loss
    w.fit(sents)
    assert abs(w.mean_loss) < abs(m1) * 1.5


def test_staging_is_copied_before_it_is_sent(monkeypatch):
    """A flush sends copies: the tensors a step received do not change
    when the batcher refills its staging arrays."""
    got = []
    orig = tk.skipgram_ns_scan

    def step(syn0, syn1, centers, contexts, *rest):
        got.append((centers, centers.clone()))
        return orig(syn0, syn1, centers, contexts, *rest)

    monkeypatch.setattr(tsv.SequenceVectors, "_ns_kernel", lambda s: step)
    w = T.Word2Vec(layer_size=8, negative=2, batch_size=32, scan_flushes=2,
                   seed=1, **CPU)
    w.fit(_zipf_corpus(60, 40, 10, seed=3))
    assert len(got) > 2
    for sent, snapshot in got:
        assert torch.equal(sent, snapshot)


# ---------------------------------------------------------- serialization

def _tables(tmp_path):
    corpus = _topic_corpus(60, seed=3)
    ja = J.Word2Vec(negative=0, use_hierarchic_softmax=True, epochs=1, **KW)
    ja.fit(corpus)
    ta = T.Word2Vec(negative=2, epochs=1, **KW, **CPU)
    ta.fit(corpus)
    return ja.lookup_table, ta.lookup_table


@pytest.mark.parametrize("fmt", ["txt", "binary", "npz"])
def test_serializer_files_cross_both_ways(tmp_path, fmt):
    jt, tt = _tables(tmp_path)
    write = {"txt": "write_word_vectors", "binary": "write_binary",
             "npz": "write_lookup_table"}[fmt]
    read = {"txt": "read_word_vectors", "binary": "read_binary",
            "npz": "read_lookup_table"}[fmt]
    JS, TS = J.WordVectorSerializer, T.WordVectorSerializer
    # JAX writes, port reads; port writes, JAX reads
    p1, p2 = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
    getattr(JS, write)(jt, p1)
    getattr(TS, write)(tt, p2)
    for src, path, reader, kw in ((jt, p1, TS, CPU), (tt, p2, JS, {})):
        back = getattr(reader, read)(path, **kw)
        assert back.vocab.words() == src.vocab.words()
        want = _np(src.syn0)
        tol = 1e-6 if fmt == "txt" else 0.0
        np.testing.assert_allclose(_np(back.syn0), want, atol=tol, rtol=0)
        if fmt == "npz":
            for name in ("syn1", "syn1neg"):
                s, r = getattr(src, name), getattr(back, name)
                assert (s is None) == (r is None)
                if s is not None:
                    np.testing.assert_array_equal(_np(r), _np(s))
            assert [vw.count for vw in back.vocab.vocab_words()] == \
                [vw.count for vw in src.vocab.vocab_words()]
    # the same table written by both packages gives the same bytes
    q1, q2 = tmp_path / f"jj.{fmt}", tmp_path / f"tt.{fmt}"
    if fmt != "npz":
        getattr(JS, write)(jt, q1)
        jt_on_port = getattr(TS, read)(q1, **CPU)
        getattr(TS, write)(jt_on_port, q2)
        getattr(JS, write)(getattr(JS, read)(q1), q1)
        assert q1.read_bytes() == q2.read_bytes()


def test_lookup_table_queries_match():
    corpus = _topic_corpus(100, seed=4)
    a = J.Word2Vec(negative=0, use_hierarchic_softmax=True, epochs=2, **KW)
    b = T.Word2Vec(negative=0, use_hierarchic_softmax=True, epochs=2, **KW,
                   **CPU)
    a.fit(corpus)
    b.fit(corpus)
    ra, rb = a.words_nearest("cat", 4), b.words_nearest("cat", 4)
    assert [w for w, _ in ra] == [w for w, _ in rb]
    np.testing.assert_allclose([s for _, s in rb], [s for _, s in ra],
                               atol=1e-5)
    assert abs(a.similarity("sun", "moon") - b.similarity("sun", "moon")) \
        < 1e-5
    assert b.get_word_vector("nope") is None
    b.lookup_table.put_vector("cat", np.ones(24, np.float32))
    np.testing.assert_array_equal(b.get_word_vector("cat"), np.ones(24))
