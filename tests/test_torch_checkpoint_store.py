"""The port's `util/checkpoint_store.py` held against the JAX package's on
the CPU: atomic publishes, integrity manifests (same format, same
digests), last-good fallback, retention, the save-phase hooks, the
bounded retry, and checkpoint directories written by either package
verified and restored by the other (parameters and optimizer state
exact). A crash at each save phase is a hook written here that raises.
"""
import json
import os
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from deeplearning4j_tpu.nn.conf import (  # noqa: E402
    DenseLayer,
    InputType,
    NeuralNetConfiguration,
    OutputLayer,
)
from deeplearning4j_tpu.datasets.dataset import (  # noqa: E402
    DataSet as JDataSet,
)
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JaxNet,
)
from deeplearning4j_tpu.nn.updater import Updater  # noqa: E402
from deeplearning4j_tpu.ops.activations import Activation  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction  # noqa: E402
from deeplearning4j_tpu.util import checkpoint_store as jcs  # noqa: E402
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.optimize.listeners import (  # noqa: E402
    CheckpointListener,
)
from deeplearning4j_tpu_torch.util import checkpoint_store as pcs  # noqa: E402
from deeplearning4j_tpu_torch.util import serialization as pser  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _conf():
    return (NeuralNetConfiguration.Builder()
            .seed(5).learning_rate(0.05).updater(Updater.ADAM)
            .activation(Activation.TANH).list()
            .layer(DenseLayer(n_out=8))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]


@pytest.fixture(scope="module")
def pnet(tmp_path_factory):
    """A port network after two Adam steps (restored from a JAX zip)."""
    jnet = JaxNet(_conf())
    jnet.init()
    path = tmp_path_factory.mktemp("seed") / "net.zip"
    jser.write_model(jnet, path)
    net = pser.restore_multi_layer_network(path, device="cpu")
    for s in range(2):
        net.fit(DataSet(*_data(s)))
    return net


def _same_net(a_params, a_upd, b_params, b_upd):
    np.testing.assert_array_equal(np.asarray(a_params), np.asarray(b_params))
    np.testing.assert_array_equal(np.asarray(a_upd), np.asarray(b_upd))


def _flat_upd_port(net):
    return pser._flat_updater_state(net._upd_state)


def _flat_upd_jax(net):
    from jax.flatten_util import ravel_pytree

    return np.asarray(ravel_pytree(net._upd_state)[0])


# ------------------------------------------------------------ primitives
def test_atomic_write_publishes_whole_file_and_keeps_old_on_failure(tmp_path):
    dst = tmp_path / "a.bin"
    pcs.atomic_write_bytes(dst, b"old")
    with pytest.raises(RuntimeError):
        with pcs.atomic_write(dst) as tmp:
            tmp.write_bytes(b"partial")
            raise RuntimeError("crash mid-write")
    assert dst.read_bytes() == b"old"
    assert [p.name for p in tmp_path.iterdir()] == ["a.bin"]
    pcs.atomic_write_bytes(dst, b"new", fsync=False)
    assert dst.read_bytes() == b"new"


def test_digests_and_manifests_match_the_jax_package(tmp_path):
    f = tmp_path / "payload.bin"
    f.write_bytes(bytes(range(256)) * 4099)
    assert pcs.file_digests(f) == jcs.file_digests(f)
    assert pcs.crc32_hex(b"abc") == jcs.crc32_hex(b"abc") \
        == format(zlib.crc32(b"abc"), "08x")
    mine, theirs = pcs.build_manifest(f, step=7), jcs.build_manifest(f, step=7)
    assert set(mine) == set(theirs)
    assert mine["format"] == theirs["format"] == pcs.MANIFEST_FORMAT
    assert mine["files"] == theirs["files"] and mine["step"] == 7
    from deeplearning4j_tpu_torch import __version__

    assert mine["library_version"] == __version__
    d = tmp_path / "tree"
    (d / "sub").mkdir(parents=True)
    (d / "sub" / "x.npy").write_bytes(b"x" * 10)
    (d / ".zarray").write_bytes(b"{}")
    assert pcs.build_manifest(d)["files"] == jcs.build_manifest(d)["files"]
    pcs.write_manifest_for(d, step=1)
    jcs.verify_manifest(d)
    assert pcs.verify_manifest(d)["step"] == 1


@pytest.mark.parametrize("damage", ["bitflip", "truncate", "append"])
def test_manifest_detects_damage_with_a_typed_error(tmp_path, damage):
    f = tmp_path / "ckpt.bin"
    f.write_bytes(b"\x01" * 4096)
    pcs.write_manifest_for(f, step=3)
    raw = bytearray(f.read_bytes())
    if damage == "bitflip":
        raw[100] ^= 0x40
    elif damage == "truncate":
        raw = raw[:2000]
    else:
        raw += b"tail"
    f.write_bytes(bytes(raw))
    with pytest.raises(pcs.CheckpointCorruptError):
        pcs.verify_manifest(f)
    with pytest.raises(jcs.CheckpointCorruptError):
        jcs.verify_manifest(f)


def test_manifest_missing_or_malformed_is_a_typed_error(tmp_path):
    f = tmp_path / "ckpt.bin"
    f.write_bytes(b"x")
    with pytest.raises(pcs.CheckpointCorruptError, match="no integrity"):
        pcs.load_manifest(f)
    pcs.manifest_path_for(f).write_text("[1, 2]")
    with pytest.raises(pcs.CheckpointCorruptError, match="malformed"):
        pcs.load_manifest(f)
    pcs.manifest_path_for(f).write_text("{not json")
    with pytest.raises(pcs.CheckpointCorruptError, match="unreadable"):
        pcs.load_manifest(f)


# ----------------------------------------------------------------- store
def test_store_publishes_payload_manifest_and_marker(tmp_path):
    store = pcs.CheckpointStore(tmp_path, keep_last=2)
    path = store.save_bytes(5, b"payload")
    assert path == tmp_path / "checkpoint_5.zip"
    assert (tmp_path / "latest").read_text() == "checkpoint_5.zip"
    manifest = json.loads(pcs.manifest_path_for(path).read_text())
    assert manifest["step"] == 5 and set(manifest["files"]) == {path.name}
    assert store.verify(5)["files"] == manifest["files"]
    assert store.latest_verified() == (5, path)
    assert jcs.CheckpointStore(tmp_path).latest_verified() == (5, path)


def test_store_keeps_the_newest_and_collects_sidecars_and_scratch(tmp_path):
    store = pcs.CheckpointStore(tmp_path, keep_last=2)
    for s in range(1, 5):
        store.save_bytes(s, f"p{s}".encode())
    assert store.steps() == [3, 4]
    assert not pcs.manifest_path_for(store.path_for(1)).exists()
    orphan = pcs.manifest_path_for(tmp_path / "checkpoint_9.zip")
    orphan.write_text("{}")
    scratch = tmp_path / ".checkpoint_4.zip.tmp-1-2"
    scratch.write_bytes(b"junk")
    store.path_for(2).write_bytes(b"manifest-less orphan payload")
    store.gc()
    assert not orphan.exists() and not scratch.exists()
    # an orphan payload never evicts a verifiable checkpoint
    assert store.steps() == [2, 3, 4]
    assert store.latest_verified() == (4, store.path_for(4))


def test_store_fallback_skips_corrupt_and_orphan_newest(tmp_path):
    store = pcs.CheckpointStore(tmp_path, keep_last=3)
    for s in (1, 2):
        store.save_bytes(s, f"p{s}".encode() * 100)
    store.path_for(3).write_bytes(b"orphan: no manifest")
    with open(store.path_for(2), "r+b") as f:
        f.truncate(50)
    assert store.latest_verified() == (1, store.path_for(1))
    got, step = store.load_latest_verified(lambda p: Path(p).read_bytes())
    assert step == 1 and got == b"p1" * 100
    store.path_for(1).write_bytes(b"damaged")
    with pytest.raises(pcs.CheckpointCorruptError, match="no loadable"):
        store.load_latest_verified(lambda p: p)
    with pytest.raises(pcs.CheckpointCorruptError, match="no verifiable"):
        store.latest_verified()
    with pytest.raises(FileNotFoundError):
        pcs.CheckpointStore(tmp_path / "empty").load_latest_verified(
            lambda p: p)
    assert pcs.CheckpointStore(tmp_path / "empty2").latest_verified() is None


def test_truncated_newest_model_falls_back_to_the_previous(tmp_path, pnet):
    """A truncated newest zip (its manifest says otherwise) is skipped;
    a loader refusing a zip with a typed error walks on too."""
    store = pcs.CheckpointStore(tmp_path, keep_last=3)
    for step in (1, 2):
        store.save(step, lambda p: pser.write_model(pnet, p, atomic=False))
    size = store.path_for(2).stat().st_size
    with open(store.path_for(2), "r+b") as f:
        f.truncate(size // 2)
    back, step = store.load_latest_verified(
        lambda p: pser.restore_model(p, device="cpu"))
    assert step == 1
    _same_net(back.params(), _flat_upd_port(back), pnet.params(),
              _flat_upd_port(pnet))
    # damage the manifest can't see: the loader's typed error moves on
    store.save(3, lambda p: Path(p).write_bytes(b"not a zip"))
    back, step = store.load_latest_verified(
        lambda p: pser.restore_model(p, device="cpu"))
    assert step == 1


@pytest.mark.parametrize("phase", ["pre_write", "mid_write", "pre_publish",
                                   "post_payload"])
def test_a_crash_at_each_save_phase_keeps_the_last_checkpoint(tmp_path,
                                                               phase, pnet):
    class Crash(RuntimeError):
        pass

    def hook(at, step, path):
        if at == phase and step == 2:
            raise Crash(f"killed at {at}")

    store = pcs.CheckpointStore(tmp_path, keep_last=3, save_hooks=[hook])
    store.save(1, lambda p: pser.write_model(pnet, p, atomic=False))
    with pytest.raises(Crash):
        store.save(2, lambda p: pser.write_model(pnet, p, atomic=False))
    back, step = store.load_latest_verified(
        lambda p: pser.restore_model(p, device="cpu"))
    assert step == 1
    np.testing.assert_array_equal(back.params().numpy(),
                                  pnet.params().numpy())
    assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]
    # the JAX package's store agrees on which checkpoint survives
    assert jcs.CheckpointStore(tmp_path).latest_verified()[0] == 1


def test_directories_load_in_the_other_package(tmp_path, pnet):
    """A store written by the port restores in the JAX package and the
    other way round: parameters, optimizer state and iteration exact."""
    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    pstore = pcs.CheckpointStore(pdir, keep_last=2)
    pstore.save(pnet.iteration,
                lambda p: pser.write_model(pnet, p, atomic=False))
    jnet, step = jcs.CheckpointStore(pdir).load_latest_verified(
        jser.restore_model)
    assert step == pnet.iteration == jnet.iteration
    _same_net(jnet.params(), _flat_upd_jax(jnet), pnet.params(),
              _flat_upd_port(pnet))
    jnet.fit(JDataSet(*_data(9)))
    jcs.CheckpointStore(jdir, keep_last=2).save(
        jnet.iteration, lambda p: jser.write_model(jnet, p, atomic=False))
    back, step = pcs.CheckpointStore(jdir).load_latest_verified(
        lambda p: pser.restore_model(p, device="cpu"))
    assert step == jnet.iteration == back.iteration
    _same_net(back.params(), _flat_upd_port(back), jnet.params(),
              _flat_upd_jax(jnet))


def test_transfer_needs_the_unported_cloud_module(tmp_path):
    store = pcs.CheckpointStore(tmp_path)
    for call in (store.upload, store.download):
        with pytest.raises(NotImplementedError, match="A14"):
            call(object())


# ----------------------------------------------------------------- retry
def test_retry_with_backoff_matches_the_jax_package():
    for mod in (pcs, jcs):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("transient")
            return "ok"

        assert mod.retry_with_backoff(flaky, backoff=0.0) == "ok"
        assert len(calls) == 3

        def always():
            raise TimeoutError("down")

        with pytest.raises(TimeoutError):
            mod.retry_with_backoff(always, max_retries=2, backoff=0.0)
        missing = []

        def gone():
            missing.append(1)
            raise FileNotFoundError("no such key")

        with pytest.raises(FileNotFoundError):
            mod.retry_with_backoff(gone, backoff=0.0)
        assert len(missing) == 1

        def bug():
            raise KeyError("a bug, not a transient")

        with pytest.raises(KeyError):
            mod.retry_with_backoff(bug, backoff=0.0)


# ------------------------------------------------------ CheckpointListener
def test_checkpoint_listener_saves_rotates_and_probes(tmp_path, pnet):
    net = pnet.clone()
    lis = CheckpointListener(tmp_path / "ck", every_n_iterations=1,
                             keep_last=2)
    net.set_listeners(lis)
    start = net.iteration
    for s in range(3):
        net.fit(DataSet(*_data(20 + s)))
    steps = [start + 2, start + 3]
    assert pcs.CheckpointStore(tmp_path / "ck").steps() == steps
    assert [os.path.basename(p) for p in lis.saved] == \
        [f"checkpoint_{s}.zip" for s in steps]
    assert CheckpointListener.last_checkpoint(tmp_path / "ck") == lis.saved[-1]
    assert CheckpointListener.last_checkpoint(tmp_path / "none") is None
    assert not (tmp_path / "none").exists()
    back = pser.restore_model(lis.saved[-1], device="cpu")
    np.testing.assert_array_equal(back.params().numpy(),
                                  net.params().numpy())


def test_a_crashed_listener_save_does_not_consume_its_slot(tmp_path, pnet):
    net = pnet.clone()
    fail = {"on": True}

    def hook(at, step, path):
        if at == "mid_write" and fail["on"]:
            raise OSError("disk full")

    lis = CheckpointListener(tmp_path, every_n_iterations=1,
                             save_hooks=[hook])
    with pytest.raises(OSError):
        lis.iteration_done(net, 7)
    fail["on"] = False
    lis.iteration_done(net, 7)
    assert pcs.CheckpointStore(tmp_path).steps() == [7]
