"""Checkpoint zips (counterpart of `deeplearning4j_tpu/util/serialization.py`).

The zip holds `configuration.json`, `coefficients.npy` (the flat
parameter vector in `ravel_pytree` order: layer order for a
MultiLayerNetwork, sorted node names for a ComputationGraph, then sorted
dict keys, each leaf in C order), `updaterState.npy` (the optimizer
state in the same order: layer, then sorted parameter name, then sorted
state name), `layerState.npy` (the persistent layer state in the same
order: layer, then sorted state name; BatchNormalization's running
`mean` and `var`, f32; empty for a network without one; tBPTT's LSTM
carry lives for one batch and is never saved), `meta.json` (iteration,
epoch, dtype, model type)
and, when one is given, `normalizer.bin` (any normalizer of
`datasets.normalizers`, in the JAX package's format). Either package
reads what the other writes. `write_model` commits through
`checkpoint_store.atomic_write`; zip-level damage on restore raises the
typed `CheckpointCorruptError`. `restore_model` reads the model type from
the zip, as the JAX package's does; `restore_multi_layer_network` and
`restore_computation_graph` refuse the other type.
"""
from __future__ import annotations

import contextlib
import io
import json
import struct
import zipfile
import zlib
from pathlib import Path
from typing import Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.multilayer import _tree_items
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
           "restore_computation_graph", "restore_normalizer"]


def _per_layer(conf, tree, what: str):
    """The JAX network's tree checked against `conf`: a list with one
    entry per layer (MultiLayerNetwork) or a dict with one per node
    (ComputationGraph); returns (key, entry) pairs."""
    if isinstance(tree, dict):
        if set(tree) != set(conf.nodes):
            raise ValueError(f"{what} for nodes {sorted(tree)}; the graph "
                             f"has {sorted(conf.nodes)}")
        return list(tree.items())
    if len(tree) != len(conf.layers):
        raise ValueError(f"{len(tree)} {what} for {len(conf.layers)} layers")
    return list(enumerate(tree))


def _rebuild(pairs, like):
    return dict(pairs) if isinstance(like, dict) else [v for _, v in pairs]


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(conf, params):
    """The JAX network's `_params` (a list of per-layer dicts, or a
    graph's dict of per-node dicts, of numpy or JAX arrays) as this
    package's tree of the same kind: CPU tensors with the same names,
    shapes and dtypes, checked against `conf`'s layers or nodes. Every
    layer keeps the JAX package's layout, so this is a copy: HWIO
    convolution weights, BatchNormalization's gamma/beta, SelfAttention's
    Wq/Wk/Wv/Wo, the MoE router and experts stacked on axis 0. Load them
    with `set_param_tree`. The JAX network's `_layer_state`
    (BatchNormalization's running `mean`/`var`) converts the same way;
    load it with `set_layer_state`."""
    return _rebuild([(k, {n: _tensor(v) for n, v in p.items()})
                     for k, p in _per_layer(conf, params, "parameter dicts")],
                    params)


def updater_state_from_jax(conf, upd_state):
    """The JAX network's `_upd_state` (layer or node -> parameter name ->
    state name -> array) as CPU tensors. Load it with
    `set_updater_state`."""
    return _rebuild([(k, {n: {sk: _tensor(a) for sk, a in st.items()}
                          for n, st in layer.items()})
                     for k, layer in _per_layer(conf, upd_state,
                                                "updater-state dicts")],
                    upd_state)


def _state_slots(net):
    """(state dict, name) of every persistent layer-state tensor in ravel
    order: the names each layer's `init_state` gives (a transient tBPTT
    carry is never among them)."""
    layers = dict(net._layer_slots())
    return [(st, k) for key, st in _tree_items(net._layer_state)
            if key in layers
            for k in sorted(layers[key].init_state(
                net._layer_input_type(key)))]


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


def _updater_slots(upd_state):
    """(state dict, name) of every optimizer-state tensor in ravel order:
    layer or node, then sorted parameter name, then sorted state name."""
    return [(layer[k], sk) for _, layer in _tree_items(upd_state)
            for k in sorted(layer) for sk in sorted(layer[k])]


def _flat_updater_state(upd_state) -> np.ndarray:
    leaves = [st[sk].detach().reshape(-1).cpu()
              for st, sk in _updater_slots(upd_state)]
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
    """Save a MultiLayerNetwork or a ComputationGraph as the JAX
    package's zip, with its
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
                "model_type": type(net).__name__,
                "format": "deeplearning4j_tpu/model/v1",
            }))


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, str(np.dtype(name)), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def _restore(path, load_updater: bool, expect_type, device):
    """The network a zip written by either package holds, rebuilt on
    `device`: parameters, and with `load_updater` the optimizer state;
    the layer state, the iteration and the epoch, so training goes on
    exactly where it stopped. With `expect_type`, a zip of another model
    type is refused (ValueError) before anything is built."""
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
    if expect_type is not None and model_type != expect_type:
        fn = "computation_graph" if model_type == "ComputationGraph" \
            else "multi_layer_network"
        raise ValueError(f"checkpoint holds a {model_type}, not a "
                         f"{expect_type} — use restore_{fn}()")
    dtype = _torch_dtype(meta.get("dtype", "float32"))
    if model_type == "ComputationGraph":
        from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (  # noqa: E501
            ComputationGraphConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

        net = ComputationGraph(
            ComputationGraphConfiguration.from_json(cfg_json), dtype=dtype,
            device=device)
    else:
        from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (  # noqa: E501
            MultiLayerConfiguration,
        )
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(cfg_json),
                                dtype=dtype, device=device)
    net.init()
    net.set_params(flat)
    if upd is not None:
        _load_updater_state(net, upd)
    if lstate is not None:
        _load_layer_state(net, lstate)
    net.iteration = meta.get("iteration", 0)
    net.epoch = meta.get("epoch", 0)
    return net


def restore_multi_layer_network(path: Union[str, Path],
                                load_updater: bool = True, device="cuda"):
    """Rebuild a `MultiLayerNetwork` from a zip written by either package,
    on `device` (the card by default); a zip of a ComputationGraph is
    refused (ValueError)."""
    return _restore(path, load_updater, "MultiLayerNetwork", device)


def restore_computation_graph(path: Union[str, Path],
                              load_updater: bool = True, device="cuda"):
    """Rebuild a `ComputationGraph` from a zip written by either package,
    on `device` (the card by default); a zip of a MultiLayerNetwork is
    refused (ValueError)."""
    return _restore(path, load_updater, "ComputationGraph", device)


def restore_model(path: Union[str, Path], load_updater: bool = True,
                  device="cuda"):
    """Type-sniffing restore (reference `util/ModelGuesser`): the model
    type is read from the zip's `meta.json`."""
    return _restore(path, load_updater, None, device)


def _load_updater_state(net, flat: np.ndarray) -> None:
    slots = _updater_slots(net._upd_state)
    n = sum(st[sk].numel() for st, sk in slots)
    if flat.shape != (n,):
        raise ValueError(
            f"checkpoint updater state has {flat.size} values but the "
            f"rebuilt network expects {n} — corrupted checkpoint or config "
            "drift (pass load_updater=False to restore params only)")
    t = torch.from_numpy(flat).to(device=net.device, dtype=net.dtype)
    off = 0
    for st, sk in slots:
        m = st[sk].numel()
        st[sk] = t[off:off + m].reshape(st[sk].shape).clone()
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
