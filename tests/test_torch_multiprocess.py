"""The port's multi-process half of parallel training
(`deeplearning4j_tpu_torch.parallel.multiprocess`, the SPMD collectives
across processes, the C6 settle) against the JAX package.

Two gloo processes x 4 CPU slots train from the JAX package's weights (a
checkpoint zip the test writes) on their halves of each global batch;
the result is held to one process's `ParallelWrapper` on the whole batch
and to the JAX package's single-process wrapper (or `fit`: the same
global-view step) in this process. Tolerances: f32, parameters rtol 1e-5
and atol 1e-6 against one process (the row sums split in two), the ranks
bit for bit against each other; the BatchNormalization net (the gather
route: every rank runs the global step) bit for bit against one
process. JAX worker processes are not started here.

Each test that starts processes bounds them with `run_workers`' timeout
(at most 120 s), which kills every worker when it passes, and their
ports go with them.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JList,
)
from deeplearning4j_tpu.nn.conf import layers as JL  # noqa: E402
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType  # noqa: E402
from deeplearning4j_tpu.ops.activations import Activation as JA  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction as JLoss  # noqa: E402
from deeplearning4j_tpu.parallel import multiprocess as jmp  # noqa: E402
from deeplearning4j_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from deeplearning4j_tpu.parallel.wrapper import (  # noqa: E402
    ParallelWrapper as JWrapper,
)
from deeplearning4j_tpu.util import serialization as jser  # noqa: E402

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.ops.rng_rows import row_offset_scope  # noqa: E402
from deeplearning4j_tpu_torch.parallel import multiprocess as pmp  # noqa: E402
from deeplearning4j_tpu_torch.parallel import spmd  # noqa: E402
from deeplearning4j_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper  # noqa: E402
from deeplearning4j_tpu_torch.util.serialization import restore_model  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU8 = [torch.device("cpu")] * 8
RTOL, ATOL = 1e-5, 1e-6
TIMEOUT = 100  # seconds a pair of workers may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs (the tier runs
    several pytest-xdist workers on one host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORKER = r'''
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.parallel import multiprocess as mp
from deeplearning4j_tpu_torch.util.serialization import restore_model

mode, rank, world, port, slots, d = (sys.argv[1], int(sys.argv[2]),
                                     int(sys.argv[3]), sys.argv[4],
                                     int(sys.argv[5]), sys.argv[6])
mp.initialize_multiprocess(f"localhost:{port}", world, rank,
                           local_device_count=slots, device="cpu")


class Seen:
    def __init__(self):
        self.rows, self.its = [], []

    def record_batch(self, n):
        self.rows.append(n)

    def iteration_done(self, net, it):
        self.its.append(it)


try:
    if mode == "spmd":
        from deeplearning4j_tpu_torch.parallel import spmd
        sys.path.insert(0, d)
        from body import collectives
        mesh = mp.global_mesh(axes={"a": world * slots})
        y, gx, gw = collectives(torch, spmd, mesh, 1.0 / world)
        np.savez(f"{d}/rank{rank}.npz", y=y.numpy(),
                 gx=mp._sum_in_rank_order(gx).numpy(),
                 gw=mp._sum_in_rank_order(gw).numpy())
        sys.exit(0)
    net = restore_model(f"{d}/init.zip", device="cpu")
    data = np.load(f"{d}/data.npz")
    n, B = data["f"].shape[:2]
    rows = slice(rank * B // world, (rank + 1) * B // world)

    def part(k, i):
        return data[k][i, rows] if k in data else None

    batches = [DataSet(part("f", i), part("l", i), part("fm", i),
                       part("lm", i)) for i in range(n)]
    epochs = int(data["epochs"])
    seen = Seen()
    net.set_listeners(seen)
    if mode == "master":
        master = mp.MultiProcessTrainingMaster()
        for _ in range(epochs):
            master.execute_training(net, ListDataSetIterator(batches))
        route = master._wrapper.route
    else:
        mesh = (mp.global_mesh(axes=json.loads(mode[5:]))
                if mode.startswith("axes=") else None)
        pw = mp.MultiProcessParallelWrapper(net, mesh=mesh)
        it = ListDataSetIterator(batches)
        if mode == "prefetch":  # each process's rows on its own device
            from deeplearning4j_tpu_torch.parallel.device_prefetch import (
                DevicePrefetchIterator)
            place = pw.mesh.data_placement("data")
            assert place.device == torch.device("cpu")
            it = DevicePrefetchIterator(it, sharding=place)
        pw.fit(it, epochs=epochs)
        route = pw.route
    np.savez(f"{d}/rank{rank}.npz", params=net.params().numpy(),
             score=np.float64(net.score_value), iteration=net.iteration,
             epoch=net.epoch, route=route, rows=np.array(seen.rows),
             its=np.array(seen.its))
finally:
    mp.shutdown_multiprocess()
'''


def _run(tmp_path, mode, world=2, slots=4):
    """Start `world` worker processes of WORKER; their results by rank."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    port = pmp.free_port()
    cmds = [[sys.executable, str(script), mode, str(r), str(world), str(port),
             str(slots), str(tmp_path)] for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    procs, logs = pmp.run_workers(cmds, env, timeout=TIMEOUT)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"worker {r} ({p.returncode}):\n{(log or '')[-2500:]}"
        for r, (p, log) in enumerate(zip(procs, logs)))
    return [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]


def _share(tmp_path, jnet, batches, epochs=1):
    """The JAX net's zip and the global batches, for the workers."""
    jser.write_model(jnet, tmp_path / "init.zip")
    arrays = {"f": np.stack([b[0] for b in batches]),
              "l": np.stack([b[1] for b in batches]),
              "epochs": np.int64(epochs)}
    for i, k in ((2, "fm"), (3, "lm")):
        if len(batches[0]) > i and batches[0][i] is not None:
            arrays[k] = np.stack([b[i] for b in batches])
    np.savez(tmp_path / "data.npz", **arrays)


def _ds(cls, b):
    return cls(*b)


def _one_process(tmp_path, batches, epochs=1, mesh=None,
                 scope=contextlib.nullcontext):
    """The port's single-process ParallelWrapper on the global batches,
    from the same zip, its steps inside `scope()`."""
    net = restore_model(tmp_path / "init.zip", device="cpu")
    pw = ParallelWrapper(net, mesh=mesh or make_mesh(devices=CPU8))
    with scope():
        pw.fit(ListDataSetIterator([_ds(DataSet, b) for b in batches]),
               epochs=epochs)
    return net


def _check(res, ref, route, rtol=RTOL, atol=ATOL):
    for r in res[1:]:
        assert np.array_equal(r["params"], res[0]["params"])  # bit for bit
    assert all(str(r["route"]) == route for r in res)
    np.testing.assert_allclose(res[0]["params"], ref, rtol=rtol, atol=atol)


# ----------------------------------------------------------- the fixture
def test_two_processes_train_the_fixture_like_one_process(tmp_path):
    """The JAX package's parity fixture (Dense 6 -> 16 tanh, softmax 3):
    2 processes x 4 slots, 6 batches of 16, 3 epochs, through the module's
    own worker entry (`python -m ...multiprocess --init`), against one
    process's ParallelWrapper and the JAX single-process wrapper over 8
    devices."""
    jnet = jmp._parity_fixture_net()
    jser.write_model(jnet, tmp_path / "init.zip")
    feats, labels = jmp._parity_fixture_data()
    port = pmp.free_port()
    out = tmp_path / "params.npy"
    cmds = [[sys.executable, "-m",
             "deeplearning4j_tpu_torch.parallel.multiprocess", str(pid), "2",
             f"localhost:{port}", "4", str(out), "--device", "cpu",
             "--init", str(tmp_path / "init.zip")] for pid in range(2)]
    procs, logs = pmp.run_workers(
        cmds, dict(os.environ, OMP_NUM_THREADS="1"), timeout=TIMEOUT)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, (log or "")[-3000:]
    assert "DCN_PARITY" in logs[0]
    two = np.load(out)
    assert np.array_equal(np.load(f"{out}.rank0.npy"),
                          np.load(f"{out}.rank1.npy"))
    jpw = JWrapper(jnet, mesh=jmake_mesh({"data": 8}))
    jpw.fit(JList([JDataSet(feats[i], labels[i]) for i in range(6)]),
            epochs=3)
    one = _one_process(tmp_path, [(feats[i], labels[i]) for i in range(6)],
                       epochs=3)
    np.testing.assert_allclose(two, one.params().numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(two, np.asarray(jnet.params()), rtol=RTOL,
                               atol=ATOL)


def test_training_master_and_the_listeners(tmp_path):
    """MultiProcessTrainingMaster runs the wrapper in every process with
    its partition: the fixture's result again; the listeners see
    `record_batch(local rows x world)` and every iteration."""
    jnet = jmp._parity_fixture_net()
    feats, labels = jmp._parity_fixture_data()
    batches = [(feats[i], labels[i]) for i in range(6)]
    _share(tmp_path, jnet, batches, epochs=2)
    res = _run(tmp_path, "master")
    one = _one_process(tmp_path, batches, epochs=2)
    _check(res, one.params().numpy(), "local")
    assert res[0]["rows"].tolist() == [16] * 12
    assert res[0]["its"].tolist() == list(range(1, 13))
    assert int(res[0]["iteration"]) == one.iteration == 12
    assert int(res[0]["epoch"]) == one.epoch == 2
    assert np.isclose(float(res[0]["score"]), one.score_value, rtol=1e-6)


# ------------------------------------------------------------ the routes
def _jconf(*layers, input_type=None, seed=5, lr=0.1, l2=0.0):
    b = dl4j.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
    if l2:
        b = b.l2(l2)
    lb = b.list()
    for layer in layers:
        lb = lb.layer(layer)
    if input_type is not None:
        lb = lb.set_input_type(input_type)
    return lb.build()


def test_batch_normalization_takes_the_gather_route(tmp_path):
    """BatchNormalization's moments span the global batch: every rank
    gathers the rows and runs the global step, bit for bit the one
    process's (and the JAX package's within f32)."""
    conf = _jconf(JL.DenseLayer(n_in=6, n_out=8, activation=JA.TANH),
                  JL.BatchNormalization(n_out=8),
                  JL.OutputLayer(n_in=8, n_out=3, activation=JA.SOFTMAX,
                                 loss=JLoss.MCXENT))
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    rng = np.random.default_rng(3)
    batches = [(rng.normal(size=(16, 6)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
               for _ in range(3)]
    _share(tmp_path, jnet, batches)
    res = _run(tmp_path, "data")
    one = _one_process(tmp_path, batches)
    _check(res, one.params().numpy(), "gather", rtol=0, atol=0)
    for b in batches:
        jnet.fit(JDataSet(*b))
    np.testing.assert_allclose(res[0]["params"], np.asarray(jnet.params()),
                               rtol=RTOL, atol=ATOL)


def test_masked_sequences_divide_by_the_global_mask_count(tmp_path):
    """A GravesLSTM char model with ragged masks and an L2 penalty (the
    local route: each rank's row means divided by the unmasked count over
    both processes, the penalty on rank 0 alone) against one process and
    the JAX package."""
    conf = _jconf(JL.GravesLSTM(n_in=5, n_out=8, activation=JA.TANH),
                  JL.RnnOutputLayer(n_in=8, n_out=5, activation=JA.SOFTMAX,
                                    loss=JLoss.MCXENT), l2=1e-3, lr=0.05)
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    rng = np.random.default_rng(4)
    batches = []
    for _ in range(3):
        x = rng.normal(size=(8, 7, 5)).astype(np.float32)
        y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (8, 7))]
        lens = np.r_[rng.integers(1, 8, 4), np.full(4, 7)]  # rank 1 full
        m = (np.arange(7)[None] < lens[:, None]).astype(np.float32)
        batches.append((x, y, m, m))
    _share(tmp_path, jnet, batches)
    res = _run(tmp_path, "data")
    one = _one_process(tmp_path, batches)
    _check(res, one.params().numpy(), "local")
    for b in batches:
        jnet.fit(JDataSet(*b))
    np.testing.assert_allclose(res[0]["params"], np.asarray(jnet.params()),
                               rtol=RTOL, atol=ATOL)


def test_dropout_masks_follow_the_global_rows(tmp_path):
    """Input dropout and DropConnect on the local route: each rank draws
    the masks of its rows' global indices (a row-offset scope at its
    first global row) and DropConnect one mask over W, the same in every
    rank, so two processes give the one-process step under
    `row_offset_scope(0)` (f32, rtol 1e-5, atol 1e-6). The one-process
    step's own bulk draw gives other masks: the check sees them. (The
    packages' dropout bits differ, so there is no JAX reference here.)"""
    conf = _jconf(JL.DenseLayer(n_in=6, n_out=16, activation=JA.TANH,
                                dropout=0.5),
                  JL.DenseLayer(n_in=16, n_out=12, activation=JA.TANH,
                                dropout=0.3, use_drop_connect=True),
                  JL.OutputLayer(n_in=12, n_out=3, activation=JA.SOFTMAX,
                                 loss=JLoss.MCXENT), seed=11)
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    rng = np.random.default_rng(9)
    batches = [(rng.normal(size=(16, 6)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
               for _ in range(3)]
    _share(tmp_path, jnet, batches)
    res = _run(tmp_path, "data")
    one = _one_process(tmp_path, batches,
                       scope=lambda: row_offset_scope(0))
    _check(res, one.params().numpy(), "local")
    bulk = _one_process(tmp_path, batches).params().numpy()
    assert not np.allclose(res[0]["params"], bulk, rtol=RTOL, atol=ATOL)


def test_a_graph_takes_the_local_route(tmp_path):
    """A ComputationGraph (two dense nodes) through the wrapper, fed by a
    `DevicePrefetchIterator` placed by the global mesh (each process's
    rows on its own device): the local route, against one process and
    the JAX graph's fit."""
    from deeplearning4j_tpu.nn.graph.computation_graph import (
        ComputationGraph as JGraph,
    )

    gconf = (dl4j.NeuralNetConfiguration.Builder().seed(8).learning_rate(0.1)
             .graph_builder().add_inputs("in")
             .add_layer("h", JL.DenseLayer(n_in=6, n_out=10,
                                           activation=JA.RELU), "in")
             .add_layer("out", JL.OutputLayer(n_in=10, n_out=3,
                                              activation=JA.SOFTMAX,
                                              loss=JLoss.MCXENT), "h")
             .set_outputs("out").build())
    jnet = JGraph(gconf)
    jnet.init()
    rng = np.random.default_rng(6)
    batches = [(rng.normal(size=(16, 6)).astype(np.float32),
                np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
               for _ in range(3)]
    _share(tmp_path, jnet, batches)
    res = _run(tmp_path, "prefetch")
    one = _one_process(tmp_path, batches)
    _check(res, one.params().numpy(), "local")
    for b in batches:
        jnet.fit(JDataSet(*b))
    np.testing.assert_allclose(res[0]["params"], np.asarray(jnet.params()),
                               rtol=RTOL, atol=ATOL)


def test_expert_parallel_moe_across_processes(tmp_path):
    """A MoELayer with expert_axis over a global mesh of 2 processes x 2
    slots: the experts run in the processes that own their slots, the
    all_to_alls cross processes (the expert route), against one process's
    ParallelWrapper over 4 slots."""
    conf = _jconf(JL.DenseLayer(n_in=6, n_out=16, activation=JA.RELU),
                  JL.MoELayer(n_in=16, n_out=16, n_experts=4,
                              capacity_factor=8.0, expert_axis="expert"),
                  JL.RnnOutputLayer(n_in=16, n_out=3, activation=JA.SOFTMAX,
                                    loss=JLoss.MCXENT),
                  input_type=JInputType.recurrent(6), lr=0.05)
    jnet = dl4j.MultiLayerNetwork(conf)
    jnet.init()
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        c = rng.integers(0, 3, (8, 4))
        x = (rng.normal(size=(8, 4, 6)) * 0.3 + c[..., None]).astype(
            np.float32)
        batches.append((x, np.eye(3, dtype=np.float32)[c]))
    _share(tmp_path, jnet, batches)
    res = _run(tmp_path, 'axes={"expert": 4}', slots=2)
    mesh = make_mesh({"expert": 4}, devices=[torch.device("cpu")] * 4)
    one = _one_process(tmp_path, batches, mesh=mesh)
    _check(res, one.params().numpy(), "expert")
    assert np.isclose(float(res[0]["score"]), one.score_value, rtol=1e-5)


# --------------------------------------------------------------- refusals
def test_local_batch_divisibility_enforced():
    """A per-process trim would desynchronize the collectives: the wrapper
    refuses a local batch its local slots do not divide."""
    from deeplearning4j_tpu_torch.parallel.multiprocess import (
        MultiProcessParallelWrapper,
        _parity_fixture_net,
    )

    net = _parity_fixture_net(device="cpu")
    pw = MultiProcessParallelWrapper(net, mesh=make_mesh(devices=CPU8))
    rng = np.random.RandomState(0)
    bad = DataSet(rng.randn(13, 6).astype(np.float32),
                  np.eye(3, dtype=np.float32)[rng.randint(0, 3, 13)])
    with pytest.raises(ValueError, match="divisible"):
        pw.fit(bad)
    assert pw.num_local_devices == 8 and pw.route == "local"


def test_tbptt_is_refused():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = _jconf(JL.GravesLSTM(n_in=3, n_out=4, activation=JA.TANH),
                  JL.RnnOutputLayer(n_in=4, n_out=3, activation=JA.SOFTMAX,
                                    loss=JLoss.MCXENT))
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration

    pconf = MultiLayerConfiguration.from_json(conf.to_json())
    pconf.tbptt_fwd_length = 2
    net = MultiLayerNetwork(pconf, device="cpu")
    with pytest.raises(NotImplementedError, match="tBPTT"):
        pmp.MultiProcessParallelWrapper(net, mesh=make_mesh(devices=CPU8))


def test_global_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="initialize_multiprocess"):
        pmp.global_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            pmp.initialize_multiprocess("localhost:1", 1, 0)
        else:
            raise RuntimeError("no CUDA device (a card is present)")


# ------------------------------------------------- collectives across
BODY = r'''
def collectives(torch, spmd, mesh, scale):
    n = mesh.size

    def body(x, w):
        y = x * w
        s = spmd.psum(y, "a")
        t = spmd.all_to_all(y, "a", split_axis=0, concat_axis=0, tiled=True)
        p = spmd.ppermute(t, "a", [(i, (i + 1) % n) for i in range(n)])
        g = spmd.all_gather(p.sum(0, keepdim=True), "a", tiled=True)
        return torch.tanh(s) + p.sum() + g.mean()

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4 * n, 3, generator=gen).requires_grad_()
    w = torch.randn(3, generator=gen).requires_grad_()
    y = spmd.shard_map(body, mesh, in_specs=(spmd.P("a"), spmd.P()),
                       out_specs=spmd.P("a"))(x, w)
    wt = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape)
    ((y * wt).sum() * scale).backward()
    return y.detach(), x.grad, w.grad
'''


def test_psum_and_all_to_all_across_processes(tmp_path):
    """psum, all_to_all, ppermute and all_gather in one body over 2
    processes x 2 slots against 4 slots in this process: outputs bit for
    bit (the sums run in global slot order), gradients (the loss
    weighted 1/world in each process, summed in rank order) within rtol
    1e-5 of the largest."""
    (tmp_path / "body.py").write_text(BODY)
    sys.path.insert(0, str(tmp_path))
    try:
        from body import collectives
    finally:
        sys.path.remove(str(tmp_path))
        sys.modules.pop("body", None)
    mesh = make_mesh({"a": 4}, devices=[torch.device("cpu")] * 4)
    y, gx, gw = collectives(torch, spmd, mesh, 1.0)
    res = _run(tmp_path, "spmd", slots=2)
    for r in res:
        assert np.array_equal(r["y"], y.numpy())
        for k, want in (("gx", gx), ("gw", gw)):
            np.testing.assert_allclose(r[k], want.numpy(), rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
    assert np.array_equal(res[0]["gx"], res[1]["gx"])


# ----------------------------------------------------------------- C6
def test_host_math_is_settled_at_import_and_the_master_mode_agrees():
    """C6: importing the port makes the first CPU vector-math call alone;
    `spmd_thread_stress.py master` (the averaging master's 4 worker
    threads against one thread, bit for bit, in fresh processes) and
    `spmd` report no wrong result."""
    from deeplearning4j_tpu_torch.util import host_math

    assert host_math.host_math_settled()
    assert spmd._settle_host_math is host_math.settle_host_math
    p = subprocess.run(
        [sys.executable, str(REPO / "spmd_thread_stress.py"), "master",
         "spmd", "-n", "4", "-j", "2"], capture_output=True, text=True,
        timeout=110, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines() if ln.strip()]
    assert [ln["mode"] for ln in lines] == ["master", "spmd"]
    assert all(ln["processes"] == 4 and ln["with_a_difference"] == 0
               for ln in lines), lines
