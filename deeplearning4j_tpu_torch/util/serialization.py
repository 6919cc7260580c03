"""Checkpoint zips (counterpart of `deeplearning4j_tpu/util/serialization.py`).

The zip holds `configuration.json`, `coefficients.npy` (the flat
parameter vector in `ravel_pytree` order: layer order, then sorted dict
keys, each leaf in C order), `updaterState.npy` (the optimizer state in
the same order: layer, then sorted parameter name, then sorted state
name), `layerState.npy` (the persistent layer state in the same order:
layer, then sorted state name; BatchNormalization's running `mean` and
`var`, f32; empty for a network without one; tBPTT's LSTM carry lives
for one batch and is never saved), `meta.json` (iteration, epoch, dtype,
model type)
and, when one is given, `normalizer.bin` (any normalizer of
`datasets.normalizers`, in the JAX package's format). Either package
reads what the other writes. `write_model` commits through
`checkpoint_store.atomic_write`; zip-level damage on restore raises the
typed `CheckpointCorruptError`. `restore_model` reads the model type from
the zip, as the JAX package's does.
"""
from __future__ import annotations

import contextlib
import io
import json
import struct
import zipfile
import zlib
from pathlib import Path
from typing import Dict, List, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.checkpoint_store import (
    CheckpointCorruptError,
    atomic_write,
)

CONFIG_JSON = "configuration.json"
COEFFICIENTS = "coefficients.npy"
UPDATER_STATE = "updaterState.npy"
LAYER_STATE = "layerState.npy"
META_JSON = "meta.json"
NORMALIZER = "normalizer.bin"

_ZIP_DAMAGE = (zipfile.BadZipFile, KeyError, EOFError, zlib.error,
               struct.error)

__all__ = ["CheckpointCorruptError", "params_from_jax",
           "updater_state_from_jax", "write_model",
           "restore_model", "restore_multi_layer_network",
           "restore_normalizer"]


def params_from_jax(conf, params) -> List[Dict[str, torch.Tensor]]:
    """The JAX network's `_params` (a list of per-layer dicts of numpy or
    JAX arrays) as this package's parameter list: CPU tensors with the
    same names, shapes and dtypes, checked against `conf`'s layer count.
    Every layer keeps the JAX package's layout, so this is a copy: HWIO
    convolution weights, BatchNormalization's gamma/beta, SelfAttention's
    Wq/Wk/Wv/Wo, the MoE router and experts stacked on axis 0. Load them
    with `MultiLayerNetwork.set_param_tree`. The JAX network's
    `_layer_state` (BatchNormalization's running `mean`/`var`) converts
    the same way; load it with `MultiLayerNetwork.set_layer_state`."""
    if len(params) != len(conf.layers):
        raise ValueError(f"{len(params)} parameter dicts for "
                         f"{len(conf.layers)} layers")
    return [{k: torch.from_numpy(np.array(v, copy=True))
             for k, v in p.items()} for p in params]


def updater_state_from_jax(conf, upd_state):
    """The JAX network's `_upd_state` (layer -> parameter name -> state
    name -> array) as CPU tensors. Load it with
    `MultiLayerNetwork.set_updater_state`."""
    if len(upd_state) != len(conf.layers):
        raise ValueError(f"{len(upd_state)} updater-state dicts for "
                         f"{len(conf.layers)} layers")
    return [{k: {sk: torch.from_numpy(np.array(a, copy=True))
                 for sk, a in st.items()} for k, st in layer.items()}
            for layer in upd_state]


def _state_slots(net):
    """(state dict, name) of every persistent layer-state tensor in ravel
    order: the names each layer's `init_state` gives (a transient tBPTT
    carry is never among them)."""
    return [(st, k) for layer, it, st in zip(net.layers, net._input_types,
                                             net._layer_state)
            for k in sorted(layer.init_state(it))]


def _flat_layer_state(net) -> np.ndarray:
    """The persistent layer state in ravel order, f32."""
    leaves = [st[k].detach().reshape(-1).cpu().float()
              for st, k in _state_slots(net)]
    if not leaves:
        return np.zeros((0,), np.float32)
    return torch.cat(leaves).numpy()


def _load_layer_state(net, flat: np.ndarray) -> None:
    slots = _state_slots(net)
    n = sum(st[k].numel() for st, k in slots)
    if flat.size and flat.shape != (n,):
        raise ValueError(f"checkpoint layer state has {flat.size} values "
                         f"but the rebuilt network expects {n}")
    if not n or not flat.size:
        return
    t = torch.from_numpy(flat).to(device=net.device)
    off = 0
    for st, k in slots:
        m = st[k].numel()
        st[k] = t[off:off + m].reshape(st[k].shape).to(st[k].dtype).clone()
        off += m


def _flat_updater_state(upd_state) -> np.ndarray:
    leaves = [layer[k][sk].detach().reshape(-1).cpu()
              for layer in upd_state for k in sorted(layer)
              for sk in sorted(layer[k])]
    if not leaves:
        return np.zeros((0,), np.float32)
    return torch.cat(leaves).numpy()


def _np_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _np_load(b: bytes) -> np.ndarray:
    return np.load(io.BytesIO(b))


def write_model(net, path: Union[str, Path], save_updater: bool = True,
                normalizer=None, atomic: bool = True) -> None:
    """Save a MultiLayerNetwork as the JAX package's zip, with its
    optimizer state unless `save_updater` is False, and `normalizer` as
    `normalizer.bin`, committed atomically. `atomic=False` writes straight
    to `path`: only for a caller that owns the atomic commit itself (a
    `CheckpointStore.save` writer given the store's temp path), where a
    second temp + fsync + replace pass would only double the fsyncs."""
    net._ensure_init()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with (atomic_write(path) if atomic
          else contextlib.nullcontext(path)) as tmp:
        with zipfile.ZipFile(tmp, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr(CONFIG_JSON, net.conf.to_json())
            z.writestr(COEFFICIENTS,
                       _np_bytes(net.params().detach().cpu().numpy()))
            if save_updater:
                z.writestr(UPDATER_STATE,
                           _np_bytes(_flat_updater_state(net._upd_state)))
            z.writestr(LAYER_STATE, _np_bytes(_flat_layer_state(net)))
            if normalizer is not None:
                z.writestr(NORMALIZER, normalizer.to_bytes())
            z.writestr(META_JSON, json.dumps({
                "iteration": net.iteration,
                "epoch": net.epoch,
                "dtype": str(net.dtype).replace("torch.", ""),
                "model_type": "MultiLayerNetwork",
                "format": "deeplearning4j_tpu/model/v1",
            }))


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(np.dtype(name)), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def restore_multi_layer_network(path: Union[str, Path],
                                load_updater: bool = True, device="cuda"):
    """Rebuild a `MultiLayerNetwork` from a zip written by either package,
    on `device` (the card by default): parameters, and with
    `load_updater` the optimizer state, the iteration and the epoch, so
    training goes on exactly where it stopped."""
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
            flat = _np_load(z.read(COEFFICIENTS))
            upd = (_np_load(z.read(UPDATER_STATE))
                   if load_updater and UPDATER_STATE in z.namelist()
                   else None)
            lstate = (_np_load(z.read(LAYER_STATE))
                      if LAYER_STATE in z.namelist() else None)
    except _ZIP_DAMAGE as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is corrupt or truncated "
            f"({type(e).__name__}: {e})") from e
    model_type = meta.get("model_type", "MultiLayerNetwork")
    if model_type != "MultiLayerNetwork":
        raise NotImplementedError(
            f"checkpoint holds a {model_type}; only MultiLayerNetwork is "
            "ported (ROADMAP queue A10: ComputationGraph)")
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(cfg_json),
                            dtype=_torch_dtype(meta.get("dtype", "float32")),
                            device=device)
    net.init()
    net.set_params(flat)
    if upd is not None:
        _load_updater_state(net, upd)
    if lstate is not None:
        _load_layer_state(net, lstate)
    net.iteration = meta.get("iteration", 0)
    net.epoch = meta.get("epoch", 0)
    return net


def restore_model(path: Union[str, Path], load_updater: bool = True,
                  device="cuda"):
    """Type-sniffing restore (reference `util/ModelGuesser`): the model
    type is read from the zip's `meta.json`. A MultiLayerNetwork is
    rebuilt on `device` (the card by default); a ComputationGraph raises
    NotImplementedError naming queue A10."""
    return restore_multi_layer_network(path, load_updater, device)


def restore_computation_graph(path: Union[str, Path],
                              load_updater: bool = True, device="cuda"):
    """The JAX package's ComputationGraph restore: not ported yet."""
    raise NotImplementedError(
        "restore_computation_graph is not ported yet (ROADMAP queue A10: "
        "ComputationGraph)")


def _load_updater_state(net, flat: np.ndarray) -> None:
    slots = [(layer, k, sk) for layer in net._upd_state
             for k in sorted(layer) for sk in sorted(layer[k])]
    n = sum(layer[k][sk].numel() for layer, k, sk in slots)
    if flat.shape != (n,):
        raise ValueError(
            f"checkpoint updater state has {flat.size} values but the "
            f"rebuilt network expects {n} — corrupted checkpoint or config "
            "drift (pass load_updater=False to restore params only)")
    t = torch.from_numpy(flat).to(device=net.device, dtype=net.dtype)
    off = 0
    for layer, k, sk in slots:
        m = layer[k][sk].numel()
        layer[k][sk] = t[off:off + m].reshape(layer[k][sk].shape).clone()
        off += m


def restore_normalizer(path: Union[str, Path]):
    """The `normalizer.bin` of a checkpoint written by either package
    (any kind of `datasets.normalizers`), or None without one."""
    from deeplearning4j_tpu_torch.datasets.normalizers import (
        DataNormalization,
    )

    try:
        with zipfile.ZipFile(path, "r") as z:
            if NORMALIZER not in z.namelist():
                return None
            blob = z.read(NORMALIZER)
    except _ZIP_DAMAGE as e:
        raise CheckpointCorruptError(
            f"checkpoint {path} is corrupt or truncated "
            f"({type(e).__name__}: {e})") from e
    return DataNormalization.from_bytes(blob)
