"""Word-vector persistence (reference
`models/embeddings/loader/WordVectorSerializer.java`): the classic word2vec
text format (header 'V D', one word + vector per line) plus a binary npz
round-trip that preserves counts.

Counterpart of `deeplearning4j_tpu/nlp/serializer.py`: the same files (a
file either package writes is read by the other); the readers build the
table on `device`, the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp.lookup_table import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabWord


def _cache_from_ordered_words(words) -> AbstractCache:
    """Vocab cache preserving FILE order (txt/binary formats carry no
    counts; both loaders need identical index invariants)."""
    cache = AbstractCache()
    for w in words:
        cache.add_token(VocabWord(w, 1.0))
    cache._by_index = [cache.word_for(w) for w in words]
    for i, vw in enumerate(cache._by_index):
        vw.index = i
    cache.total_word_occurrences = float(len(words))
    return cache


class WordVectorSerializer:
    @staticmethod
    def write_word_vectors(table: InMemoryLookupTable,
                           path: Union[str, Path]) -> None:
        """word2vec .txt format (`WordVectorSerializer.writeWordVectors`)."""
        syn0 = table.syn0.cpu().numpy()[:table.vocab.num_words()]
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n")
            for i in range(syn0.shape[0]):
                vec = " ".join(f"{x:.6f}" for x in syn0[i])
                f.write(f"{table.vocab.word_at_index(i)} {vec}\n")

    @staticmethod
    def read_word_vectors(path: Union[str, Path],
                          device="cuda") -> InMemoryLookupTable:
        """Load word2vec .txt (`WordVectorSerializer.loadTxtVectors`)."""
        words = []
        with open(path, encoding="utf-8") as f:
            header = f.readline().split()
            n, d = int(header[0]), int(header[1])
            vecs = np.zeros((n, d), np.float32)
            for i in range(n):
                parts = f.readline().rstrip("\n").split(" ")
                words.append(parts[0])
                vecs[i] = [float(x) for x in parts[1:d + 1]]
        table = InMemoryLookupTable(_cache_from_ordered_words(words), d,
                                    device=device)
        table.syn0 = torch.from_numpy(vecs).to(table.device)
        return table

    @staticmethod
    def write_lookup_table(table: InMemoryLookupTable,
                           path: Union[str, Path]) -> None:
        """Binary npz with counts + output weights — the analogue of the
        reference's full zip serde (`WordVectorSerializer.writeFullModel`)."""
        vocab = table.vocab
        np.savez_compressed(
            path,
            words=np.array(vocab.words(), dtype=object),
            counts=np.array([vw.count for vw in vocab.vocab_words()], np.float64),
            syn0=table.syn0.cpu().numpy(),
            syn1=(table.syn1.cpu().numpy() if table.syn1 is not None
                  else np.zeros((0, 0), np.float32)),
            syn1neg=(table.syn1neg.cpu().numpy() if table.syn1neg is not None
                     else np.zeros((0, 0), np.float32)))

    @staticmethod
    def read_lookup_table(path: Union[str, Path],
                          device="cuda") -> InMemoryLookupTable:
        z = np.load(path if str(path).endswith(".npz") else f"{path}.npz",
                    allow_pickle=True)
        cache = AbstractCache()
        for w, c in zip(z["words"], z["counts"]):
            cache.add_token(VocabWord(str(w), float(c)))
        cache.update_indices()
        d = z["syn0"].shape[1]
        table = InMemoryLookupTable(cache, d, device=device)
        # npz stores rows in the saved index order == sorted-by-count order
        dev = lambda a: torch.from_numpy(np.array(a)).to(table.device)
        table.syn0 = dev(z["syn0"])
        if z["syn1"].size:
            table.syn1 = dev(z["syn1"])
        if z["syn1neg"].size:
            table.syn1neg = dev(z["syn1neg"])
        return table

    @staticmethod
    def write_binary(table: InMemoryLookupTable,
                     path: Union[str, Path]) -> None:
        """Google word2vec C BINARY format (`WordVectorSerializer.
        writeWordVectors` binary flavour — the format of
        GoogleNews-vectors-negative300.bin): header 'V D\\n', then per word
        'word ' + D little-endian float32s + '\\n'."""
        syn0 = table.syn0.cpu().numpy().astype(np.float32)[
            :table.vocab.num_words()]
        with open(path, "wb") as f:
            f.write(f"{syn0.shape[0]} {syn0.shape[1]}\n".encode())
            for i in range(syn0.shape[0]):
                f.write(table.vocab.word_at_index(i).encode("utf-8") + b" ")
                f.write(syn0[i].tobytes())
                f.write(b"\n")

    @staticmethod
    def read_binary(path: Union[str, Path],
                    device="cuda") -> InMemoryLookupTable:
        """Load the Google word2vec C binary format
        (`WordVectorSerializer.readBinaryModel`)."""
        with open(path, "rb") as f:
            data = f.read()  # one buffered read; parse by offset (real
            # word2vec binaries are millions of words — per-byte f.read
            # calls would cost minutes of interpreter overhead)
        nl = data.index(b"\n")
        header = data[:nl].split()
        n, d = int(header[0]), int(header[1])
        vecs = np.zeros((n, d), np.float32)
        order = []
        pos = nl + 1
        vec_bytes = 4 * d
        for i in range(n):
            while data[pos:pos + 1] == b"\n":  # record separator
                pos += 1
            sp = data.index(b" ", pos)
            order.append(data[pos:sp].decode("utf-8", errors="replace"))
            pos = sp + 1
            vecs[i] = np.frombuffer(data, np.float32, count=d, offset=pos)
            pos += vec_bytes
        table = InMemoryLookupTable(_cache_from_ordered_words(order), d,
                                    device=device)
        table.syn0 = torch.from_numpy(vecs).to(table.device)
        return table
