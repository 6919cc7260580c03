"""ParallelWrapper: data-parallel training over a device mesh (counterpart
of `deeplearning4j_tpu/parallel/wrapper.py`; reference
`deeplearning4j-scaleout-parallelwrapper/.../ParallelWrapper.java`).

The JAX wrapper is single-controller and global-view: its step over the
mesh computes exactly the single-device step on the global batch (XLA
inserts the gradient all-reduce inside the compiled step, and a
tensor-parallel `param_specs` entry or a `model` axis changes where the
math runs, not what it computes). So batch-wide reductions span the
whole batch: BatchNormalization's statistics, masked loss means, MoE
capacity. The port keeps that contract on one device: where every slot
of the mesh is one torch device (the card, or CPU slots in tests), `fit`
runs the network's own training step on the whole batch, trimmed to a
multiple of the data axis as the JAX wrapper trims it. It never runs one
replica per slot, whose per-shard statistics and masked means would
differ from the reference. `param_specs` and a `model` axis are checked
as the JAX wrapper checks them (the axes exist, the sizes divide) and
then computed unsplit.

Expert parallelism is the exception the JAX wrapper also writes by hand:
a `MoELayer` with `expert_axis` runs its experts one per slot of that
axis (`parallel.experts.moe_apply`, through `parallel.spmd`) inside
`expert_mesh_scope`, which `fit` opens around every step; batches are
trimmed further so the tokens split over expert x data.

Kept from the JAX wrapper: the trim and its logging (a batch smaller
than the data axis is dropped), the `AsyncDataSetIterator` wrap by
`prefetch_buffer`, the listeners (`record_batch`, `iteration_done`, the
epoch hooks), data-parallel truncated BPTT with the carries seeded and
restored around each batch's windows, and `get_network()`.

A mesh whose slots in this process name several distinct devices is
refused: the port runs one process per card, under
`parallel.multiprocess.MultiProcessParallelWrapper`, whose steps this
class's surface carries. `save_checkpoint` / `load_checkpoint` write and
read `util.sharded_checkpoint` (`torch.distributed.checkpoint`; orbax in
the JAX package).
"""
from __future__ import annotations

import contextlib
import logging
from typing import Dict, Optional, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _spec_axes(part):
    """The mesh axes one entry of a PartitionSpec-like names."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _same_device(a, b) -> bool:
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


class ParallelWrapper:
    """Usage (mirrors the reference's Builder API):

        pw = ParallelWrapper(net)            # DP over the default mesh
        pw.fit(iterator, epochs=...)

    `param_specs`: {layer_index or vertex name: {param_name: spec}}, a
    spec one entry per leading dimension (None or mesh axis names);
    checked, then computed unsplit on the mesh's one device (the module
    docstring).
    """

    def __init__(self, net, mesh: Optional[Mesh] = None,
                 data_axis: str = "data",
                 param_specs: Optional[Dict] = None,
                 prefetch_buffer: int = 2):
        net._ensure_init()
        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh()
        self.data_axis = data_axis
        self.prefetch_buffer = prefetch_buffer
        dev = self.mesh.single_device("ParallelWrapper")
        if not _same_device(dev, net.device):
            raise ValueError(f"the mesh's device {dev} is not the network's "
                             f"({net.device})")
        self.param_specs = {k: dict(v)
                            for k, v in (param_specs or {}).items()}
        self._check_param_specs()
        # expert parallelism: a MoELayer carrying expert_axis runs its
        # experts one per slot of that axis inside expert_mesh_scope
        self._expert_layers = []
        self._expert_axes = set()
        for key, layer in net._layer_slots():
            ax = getattr(layer, "expert_axis", None)
            if not ax:
                continue
            if ax not in self.mesh.shape:
                raise ValueError(
                    f"layer {key!r} wants expert_axis '{ax}' but the mesh "
                    f"axes are {dict(self.mesh.shape)}")
            if layer.n_experts != self.mesh.shape[ax]:
                raise ValueError(
                    f"layer {key!r} has {layer.n_experts} experts but mesh "
                    f"axis '{ax}' has size {self.mesh.shape[ax]} — expert-"
                    f"parallel execution shards one expert per device")
            self._expert_layers.append(key)
            self._expert_axes.add(ax)
            ep = self.param_specs.setdefault(key, {})
            for name in ("W1", "b1", "W2", "b2"):
                ep.setdefault(name, (ax,))
        if self._expert_layers and net.conf.tbptt_fwd_length > 0:
            raise NotImplementedError(
                "expert_axis with truncated BPTT is not supported yet "
                "(the padded tail window is masked, and masked tokens "
                "cannot ride the expert-parallel dispatch) — drop "
                "expert_axis or disable tbptt")

    def _check_param_specs(self) -> None:
        """Every axis a spec names is a mesh axis, and the dimension it
        splits divides by the axis size."""
        params = dict(self.net._layer_slots())
        for key, specs in self.param_specs.items():
            p = self.net._params[key] if key in params else None
            for name, spec in specs.items():
                parts = () if spec is None else tuple(spec)
                for dim, part in enumerate(parts):
                    axes = _spec_axes(part)
                    n = 1
                    for ax in axes:
                        if ax not in self.mesh.shape:
                            raise ValueError(
                                f"param_specs[{key!r}][{name!r}] = {spec!r} "
                                f"names {ax!r}, not a mesh axis: "
                                f"{dict(self.mesh.shape)}")
                        n *= self.mesh.shape[ax]
                    v = None if p is None else p.get(name)
                    if v is not None and n > 1 and (
                            dim >= v.ndim or v.shape[dim] % n):
                        raise ValueError(
                            f"param_specs[{key!r}][{name!r}] = {spec!r} "
                            f"splits dimension {dim} of a "
                            f"{tuple(v.shape)} parameter {n} ways")

    def get_network(self):
        """The wrapped network: the same accessor `DistributedMultiLayer`
        exposes, so `FaultTolerantTrainer` can drive either handle's fit
        while checkpointing and restoring the underlying net."""
        return self.net

    # -- sharded checkpointing ---------------------------------------------
    def save_checkpoint(self, path) -> None:
        """Write the training state as a sharded checkpoint
        (`util.sharded_checkpoint`; every process of a multi-process run
        calls it)."""
        from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
            save_sharded_checkpoint,
        )

        save_sharded_checkpoint(path, self.net)

    def load_checkpoint(self, path) -> None:
        """Restore the training state in place from a sharded
        checkpoint, written by any number of processes."""
        from deeplearning4j_tpu_torch.util.sharded_checkpoint import (
            restore_sharded_checkpoint,
        )

        restore_sharded_checkpoint(path, self.net)

    # subclass hooks (SequenceParallelWrapper overrides _step_scope) -----
    def _step_scope(self):
        """The context every step runs in."""
        return contextlib.nullcontext()

    def _expert_scope(self):
        """`expert_mesh_scope` when the network has expert-parallel MoE
        layers."""
        import contextlib

        if not self._expert_layers:
            return contextlib.nullcontext()
        from deeplearning4j_tpu_torch.parallel.experts import (
            expert_mesh_scope,
        )

        data_axis = (self.data_axis if self.data_axis in self.mesh.shape
                     else None)
        return expert_mesh_scope(self.mesh, data_axis)

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    def _shard_batch(self, ds):
        """Trim the batch to a multiple of the data-axis size (DataSet or
        MultiDataSet); None for a batch smaller than the axis."""
        n_data = self.mesh.shape.get(self.data_axis, 1)
        B = ds.num_examples()
        usable = (B // n_data) * n_data
        if self._expert_layers and usable:
            # moe_apply's all_to_all is static-shaped: the token count
            # B*T must divide by every expert axis x data
            f = ds.features[0] if isinstance(ds.features, list) \
                else ds.features
            first = (self.net.layers[0]
                     if getattr(self.net, "layers", None) else None)
            int_ids = (f.ndim == 2 and first is not None
                       and getattr(first, "integer_input", False))
            T = f.shape[1] if (f.ndim == 3 or int_ids) else 1
            need = n_data
            for ax in self._expert_axes:
                need = int(np.lcm(need, self.mesh.shape[ax] * n_data))
            while usable and (usable * T) % need:
                usable -= n_data
        if usable == 0:
            logger.warning("dropping batch of %d < %d devices", B, n_data)
            return None
        if usable != B:
            logger.warning("trimming batch %d -> %d (divisibility by %d)",
                           B, usable, n_data)
        if usable == B:
            return ds

        def sl(a):
            return None if a is None else a[:usable]

        if isinstance(ds, MultiDataSet):
            return MultiDataSet(
                features=[f[:usable] for f in ds.features],
                labels=[l[:usable] for l in ds.labels],
                features_masks=None if ds.features_masks is None
                else [sl(m) for m in ds.features_masks],
                labels_masks=None if ds.labels_masks is None
                else [sl(m) for m in ds.labels_masks])
        return DataSet(ds.features[:usable], sl(ds.labels),
                       sl(ds.features_mask), sl(ds.labels_mask))

    def _step_input(self, ds):
        """A graph trains on MultiDataSets."""
        to_mds = getattr(self.net, "_to_mds", None)
        return ds if to_mds is None else to_mds(ds)

    def fit(self, data: Union[DataSet, MultiDataSet, DataSetIterator],
            epochs: int = 1) -> None:
        """The training loop (reference `ParallelWrapper.fit:322`): each
        batch trimmed, then one step of the network on the whole batch,
        or its tBPTT windows."""
        net = self.net
        if isinstance(data, (DataSet, MultiDataSet)):
            iterator: DataSetIterator = ListDataSetIterator([data])
        else:
            iterator = data
        if iterator.async_supported \
                and not isinstance(iterator, AsyncDataSetIterator):
            iterator = AsyncDataSetIterator(iterator, self.prefetch_buffer)
        tbptt = net.conf.tbptt_fwd_length > 0

        def fit_one(ds):
            ds = self._shard_batch(ds)
            if ds is None:
                return
            ds = self._step_input(ds)
            with self._step_scope(), self._expert_scope():
                if tbptt and net._tbptt_applicable(ds):
                    self._fit_tbptt(ds)
                else:
                    net._fit_batch(ds)

        net._fit_epochs(iterator, epochs, fit_one)

    # -- data-parallel truncated BPTT --------------------------------------
    def _fit_tbptt(self, ds) -> None:
        """Truncated BPTT over the whole (trimmed) batch: the per-example
        LSTM (h, c) carries are seeded for the batch, carried from window
        to window, and the persistent state slots are restored after the
        windows whatever happens; the score is the windows' mean loss
        (reference analogue: `ParallelWrapper.java:322` +
        `MultiLayerNetwork.java:1140`)."""
        net = self.net
        windows = net._tbptt_windows(ds)
        saved = net._tbptt_seed_carries(ds.num_examples())
        losses = []
        try:
            for window in windows:
                net._fit_batch(window)
                losses.append(net._score)
        finally:
            net._tbptt_restore_carries(saved)
        net.score_value = float(np.mean([float(l) for l in losses]))
