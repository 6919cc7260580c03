"""The port's sharded checkpoints (`util.sharded_checkpoint` on
`torch.distributed.checkpoint`, `ParallelWrapper.save_checkpoint` /
`load_checkpoint`) against the JAX package's orbax ones.

Held, as the JAX package's tests hold its own: a restore brings back the
parameters, the updater state, the layer state and the clocks bit for
bit, so a restored run continues exactly as the uninterrupted one
(tolerance 0 on the CPU); a checkpoint written on one mesh layout
restores onto another; the same training from the JAX package's weights
gives the JAX package's parameters (Adam: atol lr/30, the ROADMAP's
caveat on summation-order noise). The durability is the JAX module's: a
manifest sidecar verified on restore (a flipped byte raises
`CheckpointCorruptError`), a manifest-less directory restores with a
warning, an overwrite retires the old sidecar, and nothing temporary is
left. Across processes: two gloo processes save, one restores; one
saves, two restore (each worker bounded by a 100 s timeout)."""
import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    BatchNormalization,
    DenseLayer,
    OutputLayer,
)
from deeplearning4j_tpu.nn.updater import Updater  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from deeplearning4j_tpu.parallel.wrapper import (  # noqa: E402
    ParallelWrapper as JWrapper,
)
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multiprocess as pmp  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper  # noqa: E402
from deeplearning4j_tpu_torch.util import sharded_checkpoint as psc  # noqa: E402
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointCorruptError,
    manifest_path_for,
)
from deeplearning4j_tpu_torch.util.serialization import restore_model  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
LR = 0.05
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several pytest-xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnet(seed=5, bn=False):
    b = (dl4j.NeuralNetConfiguration.Builder()
         .seed(seed).learning_rate(LR).updater(Updater.ADAM).list()
         .layer(DenseLayer(n_in=8, n_out=16)))
    if bn:
        b = b.layer(BatchNormalization(n_out=16))
    conf = b.layer(OutputLayer(n_in=16, n_out=4)).build()
    net = dl4j.MultiLayerNetwork(conf)
    net.init()
    return net


def _port(jnet, tmp_path, name="init.zip"):
    """The port's copy of a JAX network (its weights and updater state,
    through the checkpoint zip)."""
    jser.write_model(jnet, tmp_path / name)
    return restore_model(tmp_path / name, device="cpu")


def _batches(n, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 8).astype(np.float32),
             np.eye(4, dtype=np.float32)[rng.randint(0, 4, batch)])
            for _ in range(n)]


def _state(net):
    flat = [net.params().numpy()]
    for _, st in sorted((str(k), v) for k, v in (
            enumerate(net._upd_state) if isinstance(net._upd_state, list)
            else net._upd_state.items())):
        for name in sorted(st):
            flat += [st[name][k].numpy() for k in sorted(st[name])]
    for st in (net._layer_state if isinstance(net._layer_state, list)
               else net._layer_state.values()):
        flat += [st[k].numpy() for k in sorted(st)]
    return flat, net.iteration, net.epoch


def _same_state(a, b):
    (fa, ia, ea), (fb, ib, eb) = _state(a), _state(b)
    assert (ia, ea) == (ib, eb) and len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("bn", [False, True])
def test_resume_is_exact_and_trains_like_the_jax_package(bn, tmp_path):
    """dp4 x tp2 with the JAX test's specs: save after 4 steps, go on,
    restore into a fresh net and redo: the two continuations are bit for
    bit the same, and both are the JAX package's run within Adam's
    tolerance (a BatchNormalization net carries its running moments)."""
    specs = {0: {"W": (None, "model"), "b": ("model",)},
             1 if not bn else 2: {"W": ("model", None)}}
    mesh = make_mesh({"data": 4, "model": 2}, devices=CPU8)
    jnet = _jnet(bn=bn)
    pnet = _port(jnet, tmp_path)
    pw = ParallelWrapper(pnet, mesh=mesh, param_specs=specs)
    batches = _batches(8)
    for b in batches[:4]:
        pw.fit(DataSet(*b))
    pw.save_checkpoint(tmp_path / "ckpt")
    fresh = _port(_jnet(seed=99, bn=bn), tmp_path, "other.zip")
    at_save = restore_model(tmp_path / "init.zip", device="cpu")
    pnet._copy_into(at_save)
    for b in batches[4:]:
        pw.fit(DataSet(*b))
    pw2 = ParallelWrapper(fresh, mesh=mesh, param_specs=specs)
    pw2.load_checkpoint(tmp_path / "ckpt")
    _same_state(fresh, at_save)
    for b in batches[4:]:
        pw2.fit(DataSet(*b))
    _same_state(fresh, pnet)
    jpw = JWrapper(jnet, mesh=jmake_mesh({"data": 8}))
    for b in batches:
        jpw.fit(JDataSet(*b))
    np.testing.assert_allclose(pnet.params().numpy(),
                               np.asarray(jnet.params()), rtol=0,
                               atol=LR / 30)


def test_a_checkpoint_restores_onto_another_layout(tmp_path):
    """Written from dp4 x tp2, restored onto dp8 (and a graph's dict
    trees round-trip as well)."""
    pnet = _port(_jnet(), tmp_path)
    pw = ParallelWrapper(pnet, mesh=make_mesh({"data": 4, "model": 2},
                                              devices=CPU8),
                         param_specs={0: {"W": (None, "model")}})
    for b in _batches(3):
        pw.fit(DataSet(*b))
    pw.save_checkpoint(tmp_path / "ckpt")
    other = _port(_jnet(seed=123), tmp_path, "o.zip")
    dp = ParallelWrapper(other, mesh=make_mesh({"data": 8}, devices=CPU8))
    dp.load_checkpoint(tmp_path / "ckpt")
    _same_state(other, pnet)
    dp.fit(DataSet(*_batches(1, seed=3)[0]))
    assert np.isfinite(other.score_value)

    from deeplearning4j_tpu_torch.models import resnet_tiny_configuration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    g = ComputationGraph(resnet_tiny_configuration(), device="cpu")
    g.init()
    psc.save_sharded_checkpoint(tmp_path / "graph", g)
    g2 = ComputationGraph(resnet_tiny_configuration(), device="cpu")
    g2.init()
    with torch.no_grad():
        for p in g2._params.values():
            for t in p.values():
                t.add_(1.0)
    psc.restore_sharded_checkpoint(tmp_path / "graph", g2)
    _same_state(g2, g)


def test_durability(tmp_path, caplog):
    """The manifest: written after the directory is published, verified
    on restore (a flipped byte raises), retired by an overwrite; a
    directory without one restores with a warning; nothing temporary is
    left beside the checkpoint."""
    net = _port(_jnet(), tmp_path)
    path = tmp_path / "ck"
    psc.save_sharded_checkpoint(path, net)
    m = manifest_path_for(path)
    assert m.exists() and sorted(p.name for p in tmp_path.iterdir()) == [
        "ck", "ck.manifest.json", "init.zip"]
    first = m.read_bytes()
    net.fit(DataSet(*_batches(1)[0]))
    psc.save_sharded_checkpoint(path, net)  # overwrite: a new manifest
    assert m.read_bytes() != first
    psc.restore_sharded_checkpoint(path, _port(_jnet(seed=2), tmp_path,
                                               "x.zip"))
    victim = max((p for p in path.iterdir() if p.is_file()),
                 key=lambda p: p.stat().st_size)
    raw = bytearray(victim.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        psc.restore_sharded_checkpoint(path, net)
    raw[len(raw) // 2] ^= 0xFF
    victim.write_bytes(bytes(raw))
    m.unlink()
    other = _port(_jnet(seed=3), tmp_path, "y.zip")
    with caplog.at_level(logging.WARNING, logger="deeplearning4j_tpu_torch"):
        psc.restore_sharded_checkpoint(path, other)
    assert "no integrity manifest" in caplog.text
    _same_state(other, net)
    assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]


WORKER = r'''
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.parallel import multiprocess as mp
from deeplearning4j_tpu_torch.util.serialization import restore_model

mode, rank, port, d = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
mp.initialize_multiprocess(f"localhost:{port}", 2, rank,
                           local_device_count=2, device="cpu")
try:
    net = restore_model(f"{d}/init.zip", device="cpu")
    pw = mp.MultiProcessParallelWrapper(net)
    if mode == "save":
        data = np.load(f"{d}/data.npz")
        rows = slice(rank * 8, rank * 8 + 8)
        for i in range(data["f"].shape[0]):
            pw.fit(DataSet(data["f"][i, rows], data["l"][i, rows]))
        pw.save_checkpoint(f"{d}/two")
    else:
        pw.load_checkpoint(f"{d}/one")
    np.save(f"{d}/{mode}{rank}.npy", net.params().numpy())
    np.save(f"{d}/{mode}{rank}_it.npy", np.int64(net.iteration))
finally:
    mp.shutdown_multiprocess()
'''


def _workers(tmp_path, mode):
    (tmp_path / "worker.py").write_text(WORKER)
    port = pmp.free_port()
    procs, logs = pmp.run_workers(
        [[sys.executable, str(tmp_path / "worker.py"), mode, str(r),
          str(port), str(tmp_path)] for r in range(2)],
        dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO)),
        timeout=100)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        (log or "")[-2000:] for log in logs)


def test_two_processes_save_one_restores_and_back(tmp_path):
    """Two gloo processes train and save one checkpoint; one process
    restores it bit for bit (their parameters and clock). One process
    saves; two processes restore it, each bit for bit."""
    jnet = _jnet()
    jser.write_model(jnet, tmp_path / "init.zip")
    batches = _batches(3)
    np.savez(tmp_path / "data.npz", f=np.stack([b[0] for b in batches]),
             l=np.stack([b[1] for b in batches]))
    _workers(tmp_path, "save")
    two = np.load(tmp_path / "save0.npy")
    assert np.array_equal(two, np.load(tmp_path / "save1.npy"))
    one = restore_model(tmp_path / "init.zip", device="cpu")
    ParallelWrapper(one, mesh=make_mesh(devices=CPU8)).load_checkpoint(
        tmp_path / "two")
    np.testing.assert_array_equal(one.params().numpy(), two)
    assert one.iteration == 3
    # and back: one process saves, two restore
    psc.save_sharded_checkpoint(tmp_path / "one", one)
    _workers(tmp_path, "load")
    for r in range(2):
        np.testing.assert_array_equal(np.load(tmp_path / f"load{r}.npy"),
                                      one.params().numpy())
        assert int(np.load(tmp_path / f"load{r}_it.npy")) == 3
