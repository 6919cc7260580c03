"""Multi-process distributed training (counterpart of
`deeplearning4j_tpu/parallel/multiprocess.py`; reference role: the Spark
stack's driver and executors, `ParameterAveragingTrainingMaster.java:75`).

The JAX package joins its processes with `jax.distributed` and compiles
one SPMD step over a global mesh of every process's devices; XLA puts the
gradient all-reduce inside the step. The port maps cards to processes:
one process per card, joined by `torch.distributed` over gloo (NCCL
refuses two ranks on one device, and the tests run the processes on the
CPU). Every process calls `initialize_multiprocess`, builds the same
network with the same weights, and passes its own rows of each global
batch to `MultiProcessParallelWrapper`; the global batch is the
concatenation of the processes' rows in rank order.

The wrapper's step, chosen by the network's layers (never by a failure):

- **local** (the default): each process runs the network's own forward
  and backward on its rows, with the loss's row means divided by the row
  (or unmasked-row) count over every process and the L1/L2 terms on rank
  0 alone (`ops.losses.loss_share_scope`), and its dropout masks drawn
  for its rows' global indices (`ops.rng_rows.row_offset_scope` at the
  rank's first global row); one flat vector of the gradients and the
  loss is gathered from every process and summed in rank order, and
  every process applies the same updater step. Every rank holds the same
  bits, and they are the single-process step's on the concatenated rows
  up to the order of the row sums (with dropout: the single-process step
  under `row_offset_scope(0)`, whose masks do not depend on the split);
- **gather**: a layer whose training step takes a statistic of the whole
  batch (BatchNormalization, a replicated mixture of experts and its
  capacity) cannot get it from its rows, so the rows of every process
  are gathered and every process runs the network's own step on the
  global batch;
- **expert**: a `MoELayer` with `expert_axis` runs its experts one per
  slot of the global mesh (`parallel.spmd` across processes): the rows
  are gathered, every process runs the step with its loss weighted
  1/world, the experts' bodies run in the processes that own their slots
  and their collectives cross processes, and the gradients are summed in
  rank order as in the local step.

gloo takes CUDA tensors in all-reduce and broadcast only, so every
collective here stages through pinned host memory (`spmd.host_copy`):
the flat gradient vector, the gathered rows and the `spmd` deposits are
copied to the host before the collective and back to the card after it
(`_sum_in_rank_order`, `_gather_rows`, `spmd._exchange_across`).

Validated without a cluster as the JAX package validates it: tests and
the card's run start 2 processes x N slots (`_parity_worker_main`) and
hold their parameters to one process's `ParallelWrapper`.
"""
from __future__ import annotations

import contextlib
import datetime
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.parallel.mesh import (
    Mesh,
    local_slots,
    set_local_slots,
)
from deeplearning4j_tpu_torch.parallel.spmd import host_copy
from deeplearning4j_tpu_torch.parallel.training_master import TrainingMaster
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

logger = logging.getLogger("deeplearning4j_tpu_torch")

# every process's slots, as device strings, by rank (set by
# initialize_multiprocess)
_WORLD_SLOTS: Optional[List[List[str]]] = None
# a collective that a rank never joins fails after this long (gloo's
# default is 30 minutes)
_GLOO_TIMEOUT = datetime.timedelta(seconds=600)


def _dist():
    import torch.distributed as dist

    return dist


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    dist = _dist()
    return dist.get_rank() if dist.is_available() \
        and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def initialize_multiprocess(coordinator_address: str, num_processes: int,
                            process_id: int,
                            local_device_count: Optional[int] = None,
                            device="cuda") -> None:
    """Join the process group: gloo over `tcp://<coordinator_address>`
    (`host:port`, rank 0 listens there), `num_processes` ranks, this one
    `process_id`. Call it before building a mesh.

    `local_device_count`: expose that many slots of `device` in this
    process (`parallel.mesh.set_local_slots`), the counterpart of the JAX
    package's forced host device count; None leaves the process's slots
    as they are (one per CUDA device). `device` is the card by default
    (raises without one); tests pass "cpu"."""
    dist = _dist()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_multiprocess(device='cuda') but no CUDA device "
                "is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    if local_device_count is not None:
        set_local_slots(int(local_device_count), dev)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=_GLOO_TIMEOUT)
    slots = [str(d) for d in (local_slots() or [dev])]
    gathered: List[Optional[List[str]]] = [None] * int(num_processes)
    dist.all_gather_object(gathered, slots)
    if len({len(g) for g in gathered}) != 1:
        raise ValueError(f"the processes expose different slot counts "
                         f"{[len(g) for g in gathered]}: every process must "
                         "contribute the same number of slots")
    global _WORLD_SLOTS
    _WORLD_SLOTS = gathered
    logger.info("multiprocess runtime up: process %d/%d, %d local / %d "
                "global slots", process_id, num_processes, len(slots),
                sum(len(g) for g in gathered))


def shutdown_multiprocess() -> None:
    """Leave the process group (the counterpart of
    `jax.distributed.shutdown`)."""
    global _WORLD_SLOTS
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _WORLD_SLOTS = None


def global_mesh(data_axis: str = "data",
                axes: Optional[Dict[str, int]] = None) -> Mesh:
    """One mesh over every process's slots, in rank order: a `data_axis`
    over all of them, or the {axis: size} grid `axes` (a single -1 axis
    absorbs the rest, as in `make_mesh`). The mesh knows which process
    owns each slot (`Mesh.processes`)."""
    if _WORLD_SLOTS is None:
        raise RuntimeError("global_mesh() needs initialize_multiprocess() "
                           "first")
    me = process_index()
    own = local_slots()
    devs, procs = [], []
    for p, slots in enumerate(_WORLD_SLOTS):
        for i, d in enumerate(slots):
            devs.append(own[i] if p == me and own else torch.device(d))
            procs.append(p)
    n = len(devs)
    axes = dict(axes) if axes else {data_axis: n}
    sizes = list(axes.values())
    if sizes.count(-1) == 1:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh axes {axes} != {n} global slots")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(sizes), tuple(axes),
                processes=np.asarray(procs).reshape(sizes))


# -- collectives on host memory ---------------------------------------------
def _sum_in_rank_order(vec: torch.Tensor) -> torch.Tensor:
    """The sum of every process's `vec`, added in rank order (so every
    rank gets the same bits), on `vec`'s device. gloo gathers host
    tensors: `vec` is staged through host memory."""
    dist = _dist()
    host = host_copy(vec)
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    acc = parts[0].clone()
    for t in parts[1:]:
        acc += t
    return acc.to(vec.device)


def _global_count(local: float) -> float:
    """A count summed over every process (the divisor of the row means)."""
    dist = _dist()
    t = torch.tensor([local], dtype=torch.float64)
    dist.all_reduce(t)
    return float(t[0])


def _gather_array(a):
    """Every process's rows of `a` (numpy or a tensor; the same shape in
    every process), concatenated in rank order, as `a`'s kind."""
    if a is None:
        return None
    dist = _dist()
    if isinstance(a, torch.Tensor):
        host = host_copy(a)
    else:
        host = torch.from_numpy(np.ascontiguousarray(a))
    parts = [torch.empty_like(host) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, host)
    out = torch.cat(parts, dim=0)
    if isinstance(a, torch.Tensor):
        return out.to(a.device)
    return out.numpy()


def _gather_rows(ds):
    """The global batch: every process's rows in rank order."""
    if isinstance(ds, MultiDataSet):
        def many(xs):
            return None if xs is None else [_gather_array(x) for x in xs]

        return MultiDataSet(features=many(ds.features),
                            labels=many(ds.labels),
                            features_masks=many(ds.features_masks),
                            labels_masks=many(ds.labels_masks))
    return DataSet(_gather_array(ds.features), _gather_array(ds.labels),
                   _gather_array(ds.features_mask),
                   _gather_array(ds.labels_mask))


def _batch_wide(net) -> bool:
    """A layer whose training step takes a statistic of the whole batch:
    BatchNormalization's moments, a replicated mixture of experts'
    capacity and load-balancing fractions."""
    from deeplearning4j_tpu_torch.nn.conf.layers import (
        BatchNormalization,
        MoELayer,
    )

    for _, layer in net._layer_slots():
        if isinstance(layer, BatchNormalization):
            return True
        if isinstance(layer, MoELayer) and not layer.expert_axis:
            return True
        if getattr(layer, "moe_experts", 0):
            return True
    return False


class MultiProcessParallelWrapper(ParallelWrapper):
    """ParallelWrapper over a global multi-process mesh.

    The user surface of ParallelWrapper; each process passes its LOCAL
    rows of every batch (the same number of batches in every process),
    and the global batch is their concatenation in rank order. See the
    module docstring for the three steps and the contract: after every
    step every rank holds the same parameters, those of the
    single-process step on the global batch."""

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 data_axis: str = "data",
                 param_specs: Optional[Dict] = None,
                 prefetch_buffer: int = 2):
        if process_count() < 2:
            logger.warning(
                "MultiProcessParallelWrapper constructed with a single "
                "process — plain ParallelWrapper covers this case")
        if net.conf.tbptt_fwd_length > 0:
            raise NotImplementedError(
                "tBPTT under the multi-process wrapper is not supported "
                "yet; use single-process ParallelWrapper for recurrent "
                "windowed training")
        mesh = mesh if mesh is not None else global_mesh(data_axis)
        super().__init__(net, mesh=mesh, data_axis=data_axis,
                         param_specs=param_specs,
                         prefetch_buffer=prefetch_buffer)
        if self._expert_layers:
            self.route = "expert"
        elif _batch_wide(net):
            self.route = "gather"
        else:
            self.route = "local"

    @property
    def num_local_devices(self) -> int:
        """The mesh's slots in this process."""
        return len(self.mesh.local_slot_indices())

    def _shard_batch(self, ds):
        """A hard divisibility requirement, no trim: every process runs
        the same step in lockstep, and a per-process trim would leave one
        process waiting in a collective another skipped."""
        n = self.num_local_devices
        B = ds.num_examples()
        if B % n:
            raise ValueError(
                f"local batch of {B} rows is not divisible by the "
                f"{n} local devices; multi-process SPMD training cannot "
                "trim per process (collective lockstep) — size local "
                "batches as a multiple of the local device count")
        return ds

    def fit(self, data, epochs: int = 1) -> None:
        """Every process calls fit with its OWN rows of the data stream
        (the same number of batches everywhere); each global step is one
        step of the network on the concatenation of the processes'
        rows."""
        net = self.net
        if isinstance(data, (DataSet, MultiDataSet)):
            iterator: DataSetIterator = ListDataSetIterator([data])
        else:
            iterator = data
        if iterator.async_supported \
                and not isinstance(iterator, AsyncDataSetIterator):
            iterator = AsyncDataSetIterator(iterator, self.prefetch_buffer)

        def fit_one(ds):
            ds = self._step_input(self._shard_batch(ds))
            if self.route == "gather":
                net._fit_batch(_gather_rows(ds))
                return
            self._step(ds)

        net._fit_epochs(iterator, epochs, fit_one)

    def _step(self, ds) -> None:
        """The local and expert steps: this process's share of the loss
        and its gradients, one flat vector of them summed over the
        processes in rank order, the same update on every rank."""
        from deeplearning4j_tpu_torch.nn.multilayer import _tree_items
        from deeplearning4j_tpu_torch.ops.losses import loss_share_scope
        from deeplearning4j_tpu_torch.ops.rng_rows import row_offset_scope
        from deeplearning4j_tpu_torch.parallel.spmd import exchange_chain

        net = self.net
        world = process_count()
        local_rows = ds.num_examples()
        if self.route == "expert":
            # every rank runs the global batch: one bulk dropout draw,
            # the same on every rank
            ds = _gather_rows(ds)
            share = loss_share_scope(weight=1.0 / world)
            rows = contextlib.nullcontext()
        else:
            share = loss_share_scope(denominator=_global_count,
                                     penalties=process_index() == 0)
            rows = row_offset_scope(process_index() * local_rows)
        net._validate_labels(ds)
        f, l, fm, lm = net._batch_arrays(ds)
        with share, rows, self._expert_scope(), exchange_chain():
            loss, grads, new_state = net._loss_and_grads(f, l, fm, lm)
        leaves = [(key, k, g[k]) for key, g in _tree_items(grads)
                  for k in sorted(g)]
        vec = torch.cat([g.reshape(-1).to(net.dtype) for _, _, g in leaves]
                        + [loss.reshape(1).to(net.dtype)])
        vec = _sum_in_rank_order(vec)
        off = 0
        for key, k, g in leaves:
            n = g.numel()
            grads[key][k] = vec[off:off + n].reshape(g.shape).to(g.dtype)
            off += n
        net._apply_updates(grads, new_state)
        net._score = vec[off]
        net._last_batch = ds
        net.iteration += 1
        for listener in net.listeners:
            if hasattr(listener, "record_batch"):
                listener.record_batch(local_rows * world)
            listener.iteration_done(net, net.iteration)

    def local_params(self) -> np.ndarray:
        """The flat parameter vector on the host (every rank holds the
        same)."""
        return self.net.params().detach().cpu().numpy()


class MultiProcessTrainingMaster(TrainingMaster):
    """TrainingMaster SPI adapter for the multi-process tier (the seam the
    reference's Spark master occupied). `execute_training` runs in EVERY
    process with that process's local data partition; the global step
    replaces the master's average-and-broadcast round."""

    def __init__(self, data_axis: str = "data", param_specs=None):
        self.data_axis = data_axis
        self.param_specs = param_specs
        self._wrapper: Optional[MultiProcessParallelWrapper] = None

    def execute_training(self, net, iterator) -> None:
        if self._wrapper is None or self._wrapper.net is not net:
            self._wrapper = MultiProcessParallelWrapper(
                net, data_axis=self.data_axis,
                param_specs=self.param_specs)
        self._wrapper.fit(iterator)

    def get_training_stats(self):
        return None


def free_port() -> int:
    """A free localhost TCP port (test and card rigs)."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(cmds, env, timeout: int = 240):
    """Run worker subprocesses CONCURRENTLY (threaded communicate) and
    kill every worker on timeout/failure: a sequential communicate would
    leak live workers and can deadlock on an undrained stdout pipe.
    Returns (processes, their logs)."""
    import pathlib
    import subprocess
    import threading

    # workers import this package with `-m`: anchor their cwd at the repo
    # root so the spawn works regardless of the caller's cwd
    root = str(pathlib.Path(__file__).resolve().parents[2])
    procs = [subprocess.Popen(c, env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = [None] * len(procs)

    def drain(i):
        try:
            out, _ = procs[i].communicate(timeout=timeout)
            logs[i] = out.decode(errors="replace")
        except Exception as e:
            logs[i] = f"<communicate failed: {e}>"

    threads = [threading.Thread(target=drain, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return procs, logs


def _parity_fixture_net(device="cuda"):
    """The fixture model shared by the worker entry, the tests and the
    card's run (the JAX package's: Dense 6 -> 16 tanh, softmax output of
    3, seed 77, lr 0.1), on `device`."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    conf = (NeuralNetConfiguration.Builder()
            .seed(77).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=6, n_out=16,
                              activation=Activation.TANH))
            .layer(OutputLayer(n_in=16, n_out=3,
                               activation=Activation.SOFTMAX,
                               loss=LossFunction.MCXENT))
            .build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


def _parity_fixture_data():
    """Deterministic fixture stream (the JAX package's numpy draws):
    6 batches of 16 examples, 6 features, one-hot labels of 3."""
    rng = np.random.RandomState(123)
    feats = rng.randn(6, 16, 6).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (6, 16))]
    return feats, labels


def _parity_worker_main(argv=None) -> None:
    """Entry point of the no-cluster validation (tests and the card's
    run):

        python -m deeplearning4j_tpu_torch.parallel.multiprocess <pid>
            <nprocs> <coordinator> <local_slots> <out_path>
            [--device cuda|cpu] [--init model.zip]

    joins the process group, trains the fixture model (its weights from
    the `--init` checkpoint zip when given, as the JAX package's zip
    carries them) on this process's share of the fixture stream for 3
    epochs, and writes the final flat parameters: process 0 to
    `out_path`, every process to `<out_path>.rank<pid>.npy`."""
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("pid", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("coordinator")
    ap.add_argument("local_slots", type=int)
    ap.add_argument("out_path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init", default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    torch.set_num_threads(1)
    initialize_multiprocess(args.coordinator, args.nprocs, args.pid,
                            local_device_count=args.local_slots,
                            device=args.device)
    try:
        net = _parity_fixture_net(device=args.device)
        if args.init:
            from deeplearning4j_tpu_torch.util.serialization import (
                restore_model,
            )

            init = restore_model(args.init, device=args.device)
            init._copy_into(net)
        feats, labels = _parity_fixture_data()
        B = feats.shape[1]
        lo = args.pid * (B // args.nprocs)
        hi = (args.pid + 1) * (B // args.nprocs)
        batches = [DataSet(feats[i, lo:hi], labels[i, lo:hi])
                   for i in range(feats.shape[0])]
        pw = MultiProcessParallelWrapper(net)
        pw.fit(ListDataSetIterator(batches), epochs=3)
        params = pw.local_params()
        np.save(f"{args.out_path}.rank{args.pid}.npy", params)
        if args.pid == 0:
            np.save(args.out_path, params)
            print(f"DCN_PARITY params saved ({params.shape[0]} values), "
                  f"loss={float(net.score_value):.6f}", flush=True)
    finally:
        shutdown_multiprocess()


if __name__ == "__main__":
    _parity_worker_main()
