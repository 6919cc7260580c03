"""The port's DataVec-equivalent ETL (`deeplearning4j_tpu_torch.datavec`)
against the JAX package's on the same records and files.

Every case builds the same readers and iterators in both packages from
the same CSV, text, image and in-memory records, and the batches must be
equal: the same arrays bit for bit (float32 host arrays, tolerance 0),
the same masks, the same records, the same errors. Then the batches
train the port's network on the CPU as they train the JAX package's
(f32, losses within 1e-6 and parameters within 1e-6 after two epochs)."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu import datavec as jdv  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer,
    OutputLayer,
)

from deeplearning4j_tpu_torch import datavec as pdv  # noqa: E402
from deeplearning4j_tpu_torch.nn.conf import (  # noqa: E402
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several pytest-xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def files(tmp_path):
    """The CSV, sequence, text and image files every case reads."""
    (tmp_path / "data.csv").write_text(
        "a,b,c,label\n" + "\n".join(
            f"{i},{i + 0.5},{i * 2},{i % 3}" for i in range(10)) + "\n")
    (tmp_path / "s.csv").write_text("1.0,red,2.0\n3.0,blue,4.0\n")
    seqdir = tmp_path / "seqs"
    seqdir.mkdir()
    rng = np.random.default_rng(0)
    for s in range(5):
        n = int(rng.integers(2, 6))
        (seqdir / f"seq{s}.csv").write_text("".join(
            f"{rng.normal():.4f},{rng.normal():.4f},{int(rng.integers(0, 3))}"
            "\n" for _ in range(n)))
    (tmp_path / "t.txt").write_text("hello world\nsecond line\n")
    img = tmp_path / "img"
    for ci, cls in enumerate(["cat", "dog"]):
        (img / cls).mkdir(parents=True)
        np.save(img / cls / "img0.npy", np.full((4, 4), ci, np.float32))
    pgm = np.arange(12, dtype=np.uint8).reshape(3, 4)
    (tmp_path / "pgm" / "g").mkdir(parents=True)
    (tmp_path / "pgm" / "g" / "a.pgm").write_bytes(
        b"P5\n# comment\n4 3\n255\n" + pgm.tobytes())
    ppm = tmp_path / "ppm" / "x"
    ppm.mkdir(parents=True)
    (ppm / "b.ppm").write_bytes(b"P6 2 2 255\n" + bytes(range(12)))
    return tmp_path


def _csv_classification(dv, d):
    return list(dv.RecordReaderDataSetIterator(
        dv.CSVRecordReader(d / "data.csv", skip_lines=1), batch_size=4,
        label_index=3, num_classes=3))


def _regression(dv, d):
    recs = [[float(i), float(i * 2), float(i * 3), float(i * 4)]
            for i in range(6)]
    return list(dv.RecordReaderDataSetIterator(
        dv.CollectionRecordReader(recs), batch_size=3, label_index=2,
        label_index_to=3, regression=True))


def _no_labels(dv, d):
    return list(dv.RecordReaderDataSetIterator(
        dv.CollectionRecordReader([[1.0, 2.0], [3.0, 4.0]]), batch_size=2))


def _string_labels(dv, d):
    recs = [[1.0, 2.0, "cat"], [3.0, 4.0, "dog"], [5.0, 6.0, "cat"]]
    return list(dv.RecordReaderDataSetIterator(
        dv.CollectionRecordReader(recs), batch_size=3, label_index=2,
        num_classes=2))


def _csv_records(dv, d):
    return [list(dv.CSVRecordReader(d / "data.csv", skip_lines=1)),
            list(dv.CSVRecordReader(d / "s.csv"))]


def _sequence_single(dv, d):
    return list(dv.SequenceRecordReaderDataSetIterator(
        dv.CSVSequenceRecordReader(sorted((d / "seqs").glob("*.csv"))),
        batch_size=2, num_classes=3, label_index=2))


def _two_reader(dv, d, align="ALIGN_END"):
    feats = [[[1.0], [2.0], [3.0], [4.0]], [[5.0], [6.0]]]
    labs = [[[1.0]], [[0.0], [1.0], [1.0]]]
    return list(dv.SequenceRecordReaderDataSetIterator(
        dv.CollectionSequenceRecordReader(feats), batch_size=2,
        num_classes=2,
        label_reader=dv.CollectionSequenceRecordReader(labs),
        alignment=getattr(dv.AlignmentMode, align)))


def _two_reader_start(dv, d):
    return _two_reader(dv, d, "ALIGN_START")


def _multi(dv, d):
    return list(dv.RecordReaderMultiDataSetIterator(batch_size=5)
                .add_reader("csv", dv.CSVRecordReader(d / "data.csv",
                                                      skip_lines=1))
                .add_input("csv", 0, 1)
                .add_input("csv", 2, 2)
                .add_output_one_hot("csv", 3, 3))


def _lines(dv, d):
    return list(dv.LineRecordReader(d / "t.txt"))


def _images(dv, d):
    rr = dv.ImageRecordReader(4, 4, 1, d / "img" / "cat")
    recs = list(rr)
    pnm = list(dv.ImageRecordReader(3, 4, 1, d / "pgm"))
    rgb = list(dv.ImageRecordReader(2, 2, 3, d / "ppm"))
    return [rr.labels, recs, pnm, rgb]


CASES = {"csv_classification": _csv_classification,
         "regression": _regression, "no_labels": _no_labels,
         "string_labels": _string_labels, "csv_records": _csv_records,
         "sequence_single_reader": _sequence_single,
         "two_reader_align_end": _two_reader,
         "two_reader_align_start": _two_reader_start,
         "multi_dataset": _multi, "lines": _lines, "images": _images}


def _same(a, b, where="") -> None:
    """Equal structure, equal values, arrays bit for bit."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
        return
    if hasattr(a, "__dataclass_fields__"):
        assert type(a).__name__ == type(b).__name__, where
        for f in a.__dataclass_fields__:
            _same(getattr(a, f), getattr(b, f), f"{where}.{f}")
        return
    if a is None or b is None:
        assert a is None and b is None, where
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    assert a == b, where


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_port_reads_what_the_jax_package_reads(case, files):
    _same(CASES[case](pdv, files), CASES[case](jdv, files), case)


@pytest.mark.parametrize("case", ["label_out_of_range", "equal_length",
                                  "count_mismatch", "distinct_strings",
                                  "non_numeric"])
def test_errors_match_the_jax_package(case):
    def run(dv):
        if case == "label_out_of_range":
            it = dv.RecordReaderDataSetIterator(
                dv.CollectionRecordReader([[1.0, 7.0]]), batch_size=1,
                label_index=1, num_classes=3)
        elif case == "equal_length":
            it = dv.SequenceRecordReaderDataSetIterator(
                dv.CollectionSequenceRecordReader([[[1.0], [2.0]]]),
                batch_size=1, num_classes=2,
                label_reader=dv.CollectionSequenceRecordReader([[[0.0]]]),
                alignment=dv.AlignmentMode.EQUAL_LENGTH)
        elif case == "count_mismatch":
            it = dv.SequenceRecordReaderDataSetIterator(
                dv.CollectionSequenceRecordReader([[[1.0]], [[2.0]]]),
                batch_size=2, num_classes=2,
                label_reader=dv.CollectionSequenceRecordReader([[[0.0]]]),
                alignment=dv.AlignmentMode.ALIGN_END)
        elif case == "distinct_strings":
            recs = [[1.0, "cat"], [2.0, "dog"], [3.0, "bird"]]
            it = dv.RecordReaderDataSetIterator(
                dv.CollectionRecordReader(recs), batch_size=3,
                label_index=1, num_classes=2)
        else:
            it = dv.RecordReaderDataSetIterator(
                dv.CollectionRecordReader([["x", 1.0]]), batch_size=1,
                label_index=1, num_classes=2)
        with pytest.raises(Exception) as e:
            list(it)
        return type(e.value).__name__, str(e.value)

    assert run(pdv) == run(jdv)


def test_the_csv_reader_takes_the_native_parser_with_its_python_route(
        files, monkeypatch):
    """The CSV reader goes through the port's `native.csv_parse_numeric`
    (the g++ parser where it builds, the JAX package's Python route where
    it cannot): both give the JAX package's records."""
    from deeplearning4j_tpu_torch import native

    calls = []
    real = native.csv_parse_numeric

    def spy(*a, **k):
        calls.append(a[0])
        return real(*a, **k)

    monkeypatch.setattr(native, "csv_parse_numeric", spy)
    want = list(jdv.CSVRecordReader(files / "data.csv", skip_lines=1))
    assert list(pdv.CSVRecordReader(files / "data.csv", skip_lines=1)) \
        == want
    assert calls
    monkeypatch.setattr(native, "csv_parse_numeric", lambda *a, **k: None)
    assert list(pdv.CSVRecordReader(files / "data.csv", skip_lines=1)) \
        == want


def test_sequence_batches_train_like_the_jax_package(files):
    """ALIGN_END sequence batches with masks train a GravesLSTM char model
    in both packages from the same weights: losses within 1e-6, parameters
    within 1e-6 after two epochs (f32, SGD)."""
    from deeplearning4j_tpu.nn.conf.layers import GravesLSTM, RnnOutputLayer

    conf = (dl4j.NeuralNetConfiguration.Builder().seed(3).learning_rate(0.1)
            .list()
            .layer(GravesLSTM(n_in=2, n_out=6))
            .layer(RnnOutputLayer(n_in=6, n_out=3))
            .build())
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))

    def it(dv):
        return dv.SequenceRecordReaderDataSetIterator(
            dv.CSVSequenceRecordReader(sorted((files / "seqs").glob("*.csv"))),
            batch_size=2, num_classes=3, label_index=2,
            alignment=dv.AlignmentMode.ALIGN_END)

    for _ in range(2):
        for pb, jb in zip(it(pdv), it(jdv)):
            pnet.fit(pb)
            jnet.fit(jb)
            assert pnet.score_value == pytest.approx(
                float(jnet.score_value), rel=1e-6)
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=1e-6,
                               atol=1e-6)


def test_csv_batches_feed_a_network_end_to_end(files):
    """The reference's canonical CSV -> RecordReaderDataSetIterator -> fit
    flow in the port, as the JAX package's test runs it."""
    conf = (dl4j.NeuralNetConfiguration.Builder()
            .seed(12345).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=3, n_out=8))
            .layer(OutputLayer(n_in=8, n_out=3))
            .build())
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    pnet = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        conf.to_json()), device="cpu")
    pnet.set_param_tree(params_from_jax(pnet.conf, jnet._params))
    mk = lambda dv: dv.RecordReaderDataSetIterator(  # noqa: E731
        dv.CSVRecordReader(files / "data.csv", skip_lines=1), batch_size=5,
        label_index=3, num_classes=3)
    pnet.fit(mk(pdv), epochs=2)
    jnet.fit(mk(jdv), epochs=2)
    assert np.isfinite(pnet.score_value)
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=1e-5,
                               atol=1e-6)
