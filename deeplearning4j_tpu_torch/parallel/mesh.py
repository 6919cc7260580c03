"""Device meshes (counterpart of `deeplearning4j_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` over its chips and lets XLA
route the collectives. The port's `Mesh` is its own small record of the
same layout: the axis names, `shape` as an ordered {axis: size} dict, and
`devices`, a numpy array of `torch.device`s in that shape.

The process exposes a list of slots, the counterpart of the devices
`jax.devices()` lists: by default one per CUDA device;
`set_local_slots(n, device)` exposes n slots of one device instead (N
slots of `cuda:0` on one card, or N CPU slots in the tests), the
counterpart of `XLA_FLAGS=--xla_force_host_platform_device_count=N`.
`make_mesh()` and `serving.tp_engine.tp_mesh` take their slots from it.

A mesh may span processes (`parallel.multiprocess.global_mesh`): then
`processes` holds, for each slot, the rank of the process that owns it,
the counterpart of `jax.Device.process_index`; a mesh of one process has
`processes` None.

Two kinds of entry point use a mesh. The global-view ones
(`ParallelWrapper`, `DevicePrefetchIterator`, `SequenceVectors(mesh=)`)
compute what the JAX package's partitioned step computes, the
single-device computation on the whole batch: on a mesh whose slots in
this process are all one device they run it there. The port maps cards
to processes: one process per card, the processes joined by
`torch.distributed` under `MultiProcessParallelWrapper`. So a mesh whose
slots in one process name several distinct devices is refused with a
message that says so. The per-slot bodies the JAX package writes under
`shard_map` (tensor-parallel decode, ring and Ulysses attention, the
pipeline, the expert-parallel MoE) run once per slot of this process
through `parallel.spmd`, whatever devices the slots name. Tests build an
8-slot mesh on the CPU, `make_mesh(devices=[torch.device("cpu")] * 8)`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Axis names, `shape` ({axis: size}, in axis order) and `devices`
    (a numpy object array of `torch.device`s of that shape)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 processes: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{devices.ndim}-d device array")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))
        if processes is not None:
            processes = np.asarray(processes, dtype=np.int64).reshape(
                devices.shape)
        self.processes = processes

    @property
    def is_multiprocess(self) -> bool:
        return self.processes is not None \
            and len(set(self.processes.reshape(-1).tolist())) > 1

    def process_of(self, slot: int) -> int:
        """The rank owning flat slot `slot` (0 on a one-process mesh)."""
        if self.processes is None:
            return 0
        return int(self.processes.reshape(-1)[slot])

    def local_slot_indices(self) -> list:
        """The flat slots this process owns (all of them on a
        one-process mesh)."""
        if self.processes is None:
            return list(range(self.size))
        from deeplearning4j_tpu_torch.parallel.multiprocess import (
            process_index,
        )

        me = process_index()
        return [s for s, p in enumerate(self.processes.reshape(-1))
                if int(p) == me]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        """The distinct `torch.device`s this process's slots name, in
        slot order."""
        flat = self.devices.reshape(-1)
        out = []
        for s in self.local_slot_indices():
            if flat[s] not in out:
                out.append(flat[s])
        return out

    def single_device(self, what: str) -> torch.device:
        """The one device every slot of this process names, for the
        global-view entry points (`what` names the caller). Slots in one
        process over several distinct devices raise: the port runs one
        process per card, under `MultiProcessParallelWrapper`."""
        devs = self.distinct_devices()
        if len(devs) != 1:
            raise ValueError(
                f"{what} over a mesh whose slots in one process name "
                f"{len(devs)} distinct devices ({devs}): the port runs one "
                "process per card, joined by torch.distributed under "
                "parallel.multiprocess.MultiProcessParallelWrapper "
                "(initialize_multiprocess, global_mesh); a mesh on one "
                "device runs the single-device step on the whole batch")
        return devs[0]

    def data_placement(self, axis: str = "data") -> "DataPlacement":
        """The placement of a batch split along `axis`: the counterpart of
        `NamedSharding(mesh, PartitionSpec(axis))`."""
        if axis not in self.shape:
            raise ValueError(f"mesh axes {dict(self.shape)} have no "
                             f"{axis!r} axis")
        return DataPlacement(self, axis)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, devices={self.distinct_devices()})"


class DataPlacement:
    """A batch placed along one mesh axis (`Mesh.data_placement`). On a
    mesh of one device it names that device."""

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh = mesh
        self.axis = axis

    @property
    def device(self) -> torch.device:
        return self.mesh.single_device("a batch placement")

    def __repr__(self) -> str:
        return f"DataPlacement({self.axis!r}, {self.mesh!r})"


_SLOTS: Optional[List[torch.device]] = None


def set_local_slots(n: Optional[int], device="cuda") -> None:
    """Expose `n` slots of `device` to this process (`local_slots`,
    `make_mesh()`, `tp_mesh`): N slots of one card, or N CPU slots. `n`
    None restores the default, one slot per CUDA device. Asking for CUDA
    slots without a card raises."""
    global _SLOTS
    if n is None:
        _SLOTS = None
        return
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"slot count must be a positive int, got {n!r}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{n} slots of {dev} requested but no CUDA device is "
                "available; pass device='cpu' for CPU slots")
        if dev.index is None:
            dev = torch.device("cuda", 0)
    _SLOTS = [dev] * n


def local_slots() -> List[torch.device]:
    """The process's slots: those `set_local_slots` set, else one per
    CUDA device (none without a card)."""
    if _SLOTS is not None:
        return list(_SLOTS)
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _default_devices() -> list:
    slots = local_slots()
    if not slots:
        raise RuntimeError(
            "make_mesh() covers the process's slots by default (one per "
            "CUDA device), but no CUDA device is available; pass "
            "devices=[torch.device('cpu')] * n, or call "
            "set_local_slots(n, 'cpu'), to build a mesh on the CPU")
    return slots


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from {axis_name: size}. Sizes must multiply to the
    device count; a single -1 axis absorbs the remainder (numpy reshape
    convention). `devices` defaults to the process's slots
    (`local_slots`: one per CUDA device unless `set_local_slots` says
    otherwise; raises with none); entries may be `torch.device`s or
    strings."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _default_devices())]
    n = len(devices)
    if not axes:
        axes = {"data": n}
    names = list(axes.keys())
    sizes = list(axes.values())
    n_neg = sizes.count(-1)
    if n_neg > 1:
        raise ValueError("at most one -1 axis")
    if n_neg == 1:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh axes {dict(zip(names, sizes))} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), tuple(names))
