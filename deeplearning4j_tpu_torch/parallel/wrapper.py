"""ParallelWrapper: data-parallel training over a device mesh (counterpart
of `deeplearning4j_tpu/parallel/wrapper.py`; reference
`deeplearning4j-scaleout-parallelwrapper/.../ParallelWrapper.java`).

The JAX wrapper is single-controller and global-view: its step over the
mesh computes exactly the single-device step on the global batch (XLA
inserts the gradient all-reduce inside the compiled step). So batch-wide
reductions span the whole batch: BatchNormalization's statistics, masked
loss means, MoE capacity. The port keeps that contract on one device:
where every slot of the mesh is one torch device (the card, or CPU slots
in tests), `fit` runs the network's own training step on the whole batch,
trimmed to a multiple of the data axis as the JAX wrapper trims it. It
never runs one replica per slot, whose per-shard statistics and masked
means would differ from the reference.

Kept from the JAX wrapper: the trim and its logging (a batch smaller
than the data axis is dropped), the `AsyncDataSetIterator` wrap by
`prefetch_buffer`, the listeners (`record_batch`, `iteration_done`, the
epoch hooks), data-parallel truncated BPTT with the carries seeded and
restored around each batch's windows, and `get_network()`.

Not ported here (ROADMAP queue A12b, the multi-device half on
`torch.distributed`): a mesh over more than one distinct device,
tensor-parallel `param_specs` (any non-replicated entry) and a `model`
axis, expert-parallel layers (`expert_axis`), and the sharded checkpoints
(`save_checkpoint` / `load_checkpoint`: orbax in the JAX package,
`util/sharded_checkpoint.py` in A12b). Each raises `NotImplementedError`
naming A12b.
"""
from __future__ import annotations

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

_A12B = "ROADMAP queue A12b: the multi-device half of parallel training"


def _replicated(spec) -> bool:
    """A PartitionSpec-like entry that shards nothing: None, or a
    sequence of Nones (the JAX package's `P()` / `P(None, None)`)."""
    return spec is None or all(s is None for s in tuple(spec))


def _same_device(a, b) -> bool:
    if a.type != b.type:
        return False
    return a.index is None or b.index is None or a.index == b.index


class ParallelWrapper:
    """Usage (mirrors the reference's Builder API):

        pw = ParallelWrapper(net)            # DP over the default mesh
        pw.fit(iterator, epochs=...)

    `param_specs`: {layer_index or vertex name: {param_name: spec}}; only
    replicated entries are accepted on one device (tensor parallelism is
    A12b).
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
        if "model" in self.mesh.shape:
            raise NotImplementedError(
                f"ParallelWrapper over a mesh with a 'model' axis "
                f"({dict(self.mesh.shape)}): tensor parallelism is not "
                f"ported yet ({_A12B})")
        for key, specs in (param_specs or {}).items():
            for name, spec in dict(specs).items():
                if not _replicated(spec):
                    raise NotImplementedError(
                        f"param_specs[{key!r}][{name!r}] = {spec!r} shards a "
                        f"parameter: tensor parallelism is not ported yet "
                        f"({_A12B})")
        for key, layer in net._layer_slots():
            if getattr(layer, "expert_axis", None):
                raise NotImplementedError(
                    f"layer {key!r} has expert_axis="
                    f"{layer.expert_axis!r}: expert-parallel MoE is not "
                    f"ported yet ({_A12B})")

    def get_network(self):
        """The wrapped network: the same accessor `DistributedMultiLayer`
        exposes, so `FaultTolerantTrainer` can drive either handle's fit
        while checkpointing and restoring the underlying net."""
        return self.net

    # -- sharded checkpointing ---------------------------------------------
    def save_checkpoint(self, path) -> None:
        raise NotImplementedError(
            "ParallelWrapper.save_checkpoint writes a sharded checkpoint "
            f"(util/sharded_checkpoint.py), which is not ported yet "
            f"({_A12B}); use util.serialization.write_model or a "
            "CheckpointListener")

    def load_checkpoint(self, path) -> None:
        raise NotImplementedError(
            "ParallelWrapper.load_checkpoint reads a sharded checkpoint "
            f"(util/sharded_checkpoint.py), which is not ported yet "
            f"({_A12B}); use util.serialization.restore_model")

    @property
    def num_devices(self) -> int:
        return int(np.prod(list(self.mesh.shape.values())))

    def _shard_batch(self, ds):
        """Trim the batch to a multiple of the data-axis size (DataSet or
        MultiDataSet); None for a batch smaller than the axis."""
        n_data = self.mesh.shape.get(self.data_axis, 1)
        B = ds.num_examples()
        usable = (B // n_data) * n_data
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
