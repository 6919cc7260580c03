"""The port's native host library (`deeplearning4j_tpu_torch.native`)
against the JAX package's: `count_words` and `csv_parse_numeric` give the
same results in both packages, and on both routes (the C++ library, and
the pure-Python route a caller runs when the library is unavailable);
`loader.route` says which ran. The library is built from the port's copy
of the source into `deeplearning4j_tpu_torch/_build/`."""
from pathlib import Path

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.native import count_words as j_count_words
from deeplearning4j_tpu.native import csv_parse_numeric as j_csv
from deeplearning4j_tpu.nlp.vocab import VocabConstructor as JVocab
from deeplearning4j_tpu_torch.native import (
    count_words,
    csv_parse_numeric,
    loader,
    native_available,
)
from deeplearning4j_tpu_torch.nlp.vocab import VocabConstructor

REPO = Path(__file__).resolve().parent.parent


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


@pytest.fixture
def python_route(monkeypatch):
    """The port's loader as on a machine without g++: every call
    returns None and the caller runs its Python route."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_tried", True)


def test_library_builds_from_the_ports_copy_into_build():
    assert native_available()
    path = loader.library_path()
    assert path.parent == REPO / "deeplearning4j_tpu_torch" / "_build"
    assert path.exists()
    ref = (REPO / "deeplearning4j_tpu/native/src/dl4jtpu_native.cpp").read_text()
    ours = (REPO / "deeplearning4j_tpu_torch/native/src/"
            "dl4jtpu_native.cpp").read_text()
    # the code below the header comment is the JAX package's, unchanged
    body = lambda s: s[s.index("#include"):]
    assert body(ours) == body(ref)


CORPORA = {
    "ascii": ["the quick brown Fox jumps over the lazy dog the end\n",
              "fox and dog\n  \n\tdog\tFOX  the\n"],
    "unicode": ["Über café naïve word ÜBER\n", "日本語 テキスト 日本語\n",
                "x y z\r\nlast"],
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("lowercase", [True, False])
def test_count_words_equal_in_both_packages(tmp_path, corpus, lowercase):
    paths = []
    for i, text in enumerate(CORPORA[corpus]):
        p = tmp_path / f"{i}.txt"
        p.write_bytes(text.encode("utf-8"))
        paths.append(p)
    got = count_words(paths, lowercase=lowercase)
    assert loader.route == "native"
    assert got == j_count_words(paths, lowercase=lowercase)
    assert got is not None and sum(got.values()) > 0


def _vocab(cache):
    return [(vw.word, vw.count, vw.index) for vw in cache.vocab_words()]


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_vocab_from_files_equal_on_both_routes(tmp_path, corpus,
                                               monkeypatch):
    """The native count and the byte-split Python route give the same
    vocabulary, which is the JAX package's."""
    paths = []
    for i, text in enumerate(CORPORA[corpus] * 3):
        p = tmp_path / f"{i}.txt"
        p.write_bytes(text.encode("utf-8"))
        paths.append(p)
    native = VocabConstructor(min_word_frequency=2).build_vocab_from_files(
        paths)
    assert loader.route == "native"
    ref = JVocab(min_word_frequency=2).build_vocab_from_files(paths)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_tried", True)
    python = VocabConstructor(min_word_frequency=2).build_vocab_from_files(
        paths)
    assert loader.route == "python"
    assert _vocab(native) == _vocab(python) == _vocab(ref)
    assert native.total_word_occurrences == ref.total_word_occurrences


def _python_csv(path, skip_lines=0, delimiter=","):
    """The string-aware reader's route for an all-numeric file."""
    lines = Path(path).read_text().splitlines()[skip_lines:]
    return np.asarray([[float(v) for v in ln.split(delimiter)]
                       for ln in lines if ln.strip()], np.float64)


@pytest.mark.parametrize("text,skip,delim", [
    ("h1,h2,h3\n1,2.5,3e2\n-4,5,6\n\n", 1, ","),
    ("0.5;1;2\n3;-4.25;1e-3\n", 0, ";"),
    ("\n".join(f"{i * 0.5},{i * 2.0},{i % 4}" for i in range(50)) + "\n", 0,
     ","),
])
def test_csv_parse_numeric_equal_in_both_packages_and_routes(
        tmp_path, text, skip, delim):
    p = tmp_path / "n.csv"
    p.write_text(text)
    got = csv_parse_numeric(p, skip_lines=skip, delimiter=delim)
    assert loader.route == "native"
    np.testing.assert_array_equal(got, j_csv(p, skip_lines=skip,
                                             delimiter=delim))
    np.testing.assert_array_equal(got, _python_csv(p, skip, delim))
    assert got.dtype == np.float64


@pytest.mark.parametrize("text", ["1,red,3\n", "1,2,3\n4,5\n"])
def test_csv_refusals_leave_the_python_route(tmp_path, text):
    p = tmp_path / "bad.csv"
    p.write_text(text)
    assert csv_parse_numeric(p) is None and j_csv(p) is None
    assert loader.route == "python"


def test_without_the_library_every_call_takes_the_python_route(
        tmp_path, python_route):
    p = tmp_path / "a.txt"
    p.write_text("a b a\n")
    assert not native_available()
    assert count_words([p]) is None
    assert loader.route == "python"
    q = tmp_path / "n.csv"
    q.write_text("1,2\n")
    assert csv_parse_numeric(q) is None
    assert loader.route == "python"
