"""Device meshes (counterpart of `deeplearning4j_tpu/parallel/mesh.py`).

The JAX package builds a `jax.sharding.Mesh` over its chips and lets XLA
route the collectives. The port's `Mesh` is its own small record of the
same layout: the axis names, `shape` as an ordered {axis: size} dict, and
`devices`, a numpy array of `torch.device`s in that shape.

On one card every slot of the mesh is the same `torch.device`, and the
data-parallel tier (`ParallelWrapper`, `DevicePrefetchIterator`,
`SequenceVectors(mesh=)`) runs the single-device computation on the whole
batch: that is what the JAX package's global-view step computes. A mesh
whose slots name more than one distinct device is the multi-device half
(ROADMAP queue A12b: `torch.distributed` across cards), which those
entry points refuse. Tests build an 8-slot mesh on the CPU,
`make_mesh(devices=[torch.device("cpu")] * 8)`, the counterpart of the
JAX test session's eight virtual CPU devices.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch


class Mesh:
    """Axis names, `shape` ({axis: size}, in axis order) and `devices`
    (a numpy object array of `torch.device`s of that shape)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a "
                             f"{devices.ndim}-d device array")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct_devices(self) -> list:
        """The distinct `torch.device`s the slots name, in slot order."""
        out = []
        for d in self.devices.reshape(-1):
            if d not in out:
                out.append(d)
        return out

    def single_device(self, what: str) -> torch.device:
        """The one device every slot names; a mesh over several distinct
        devices raises naming A12b (`what` names the caller)."""
        devs = self.distinct_devices()
        if len(devs) != 1:
            raise NotImplementedError(
                f"{what} over a mesh of {len(devs)} distinct devices "
                f"({devs}) is the multi-device half of parallel training "
                "(ROADMAP queue A12b: torch.distributed across cards); a "
                "mesh on one device runs the single-device step on the "
                "whole batch")
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


def _default_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh() covers every CUDA device by default, but no CUDA "
            "device is available; pass devices=[torch.device('cpu')] * n "
            "to build a mesh on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh from {axis_name: size}. Sizes must multiply to the
    device count; a single -1 axis absorbs the remainder (numpy reshape
    convention). `devices` defaults to every CUDA device (raises without
    one); entries may be `torch.device`s or strings."""
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
