"""Checkpoint reading (counterpart of the read side of
`deeplearning4j_tpu/util/serialization.py`).

A checkpoint written by the JAX package is a zip holding
`configuration.json`, `coefficients.npy` (the flat parameter vector in
`ravel_pytree` order: layer order, then sorted dict keys, each leaf in C
order) and `meta.json` (dtype, model type). Updater and layer state are
training-side and are not read here. The write side comes with the
training slice.
"""
from __future__ import annotations

import io
import json
import struct
import zipfile
import zlib
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

CONFIG_JSON = "configuration.json"
COEFFICIENTS = "coefficients.npy"
META_JSON = "meta.json"

_ZIP_DAMAGE = (zipfile.BadZipFile, KeyError, EOFError, zlib.error,
               struct.error)


class CheckpointCorruptError(RuntimeError):
    """A checkpoint is truncated, fails its CRC or misses an entry
    (copied from `deeplearning4j_tpu/util/checkpoint_store.py`)."""


def params_from_jax(conf, params) -> List[Dict[str, torch.Tensor]]:
    """The JAX network's `_params` (a list of per-layer dicts of numpy or
    JAX arrays) as this package's parameter list: CPU tensors with the
    same names, shapes and dtypes, checked against `conf`'s layer count.
    Load them with `MultiLayerNetwork.set_param_tree`."""
    if len(params) != len(conf.layers):
        raise ValueError(f"{len(params)} parameter dicts for "
                         f"{len(conf.layers)} layers")
    return [{k: torch.from_numpy(np.array(v, copy=True))
             for k, v in p.items()} for p in params]


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(np.dtype(name)), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def restore_multi_layer_network(path: Union[str, Path], device="cuda"):
    """Rebuild a `MultiLayerNetwork` from a zip the JAX package wrote
    (`write_model`), on `device` (the card by default). Zip-level damage
    raises the typed `CheckpointCorruptError`."""
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        MultiLayerConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device

    device = resolve_device(device)
    try:
        with zipfile.ZipFile(path, "r") as z:
            meta = json.loads(z.read(META_JSON).decode())
            cfg_json = z.read(CONFIG_JSON).decode()
            flat = np.load(io.BytesIO(z.read(COEFFICIENTS)))
    except _ZIP_DAMAGE as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is corrupt or truncated "
            f"({type(e).__name__}: {e})") from e
    model_type = meta.get("model_type", "MultiLayerNetwork")
    if model_type != "MultiLayerNetwork":
        raise NotImplementedError(
            f"checkpoint holds a {model_type}; only MultiLayerNetwork is "
            "ported (ROADMAP queue A10 for ComputationGraph)")
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(cfg_json),
                            dtype=_torch_dtype(meta.get("dtype", "float32")),
                            device=device)
    net.init()
    net.set_params(flat)
    return net
