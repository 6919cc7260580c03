"""Export a trained network's inference path as one portable artifact
(counterpart of `deeplearning4j_tpu/util/stablehlo_export.py`; the module
keeps its name so a reader finds the counterpart).

The JAX package lowers `net.output` to serialized StableHLO with
`jax.export`. The port's artifact is a torch `ExportedProgram`, not
StableHLO: `torch.export.export` of the network's eval-mode `output`
(parameters and layer state baked in as constants, the normalizer and the
wire dtype inside, as at JAX `:40-75`), written by `torch.export.save`
into bytes. `load_inference` gives back a callable that runs it, with no
network object, configuration or checkpoint.

`torch.export` cannot trace into a kernel launched through ctypes, so
the inference forwards that `output` reaches are registered ops
(`dl4j::flash_attention_fwd` in `ops.flash_attention`, `dl4j::lstm_fwd`
and `dl4j::lstm_fwd_masked` in `ops.lstm`): the exported graph holds each
hand-written kernel as one op, whose body is the port's wrapper (the
kernel on CUDA tensors, counted as any launch; the plain version on CPU
tensors). `load_inference` registers them by importing those two modules.
"""
from __future__ import annotations

import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch


class _Serve(torch.nn.Module):
    """The network's eval forward from wire tensors (what `output`
    computes after `wire_asarray`)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, *xs):
        net = self.net
        if hasattr(net, "layers"):  # MultiLayerNetwork
            x = net._prep_features(xs[0])
            return net._forward_pure(net._params, x, train=False, rng=None,
                                     lstate=net._layer_state)[0]
        acts, _ = net._forward_pure(net._params, net._prep_inputs(list(xs)),
                                    train=False, rng=None,
                                    lstate=net._layer_state)
        return tuple(acts[o] for o in net.conf.network_outputs)


def export_inference(net, example_features, path: Optional[str] = None,
                     platforms: Optional[Sequence[str]] = None) -> bytes:
    """Export `net.output(features)` (eval mode) as bytes.

    `net`: an initialized MultiLayerNetwork or ComputationGraph.
    `example_features`: one features array (MLN) or a sequence of arrays
    (CG, one per network input) fixing the serving shapes and dtypes: the
    wire format (uint8 pixels when a device-side normalizer is attached,
    int ids for embedding nets).
    `path`: optionally also write the bytes to this file.
    `platforms`: the device types the artifact is built for ("cuda",
    "cpu"); the program holds the network's constants on its device, so
    the network's device type must be among them. Default: the network's.

    The exported function takes ONLY the feature array(s)."""
    from deeplearning4j_tpu_torch.nn.precision import wire_asarray

    net._ensure_init()
    kind = net.device.type
    platforms = [kind] if platforms is None else \
        [str(p).lower() for p in platforms]
    if kind not in platforms:
        raise ValueError(f"the network lies on {net.device}, but the "
                         f"artifact is asked for {platforms}: export on a "
                         "network of each platform")
    if hasattr(net, "layers"):
        feats = [example_features]
        ids = [net._feature_wire_mode() != "float"]
    else:
        feats = (list(example_features)
                 if isinstance(example_features, (list, tuple))
                 else [example_features])
        if len(feats) != len(net.conf.network_inputs):
            raise ValueError(
                f"graph has {len(net.conf.network_inputs)} inputs "
                f"({net.conf.network_inputs}); got {len(feats)} example "
                "feature arrays")
        ids = net._inputs_are_ids()
    xs = tuple(wire_asarray(x, net.dtype, net.device, i)
               for x, i in zip(feats, ids))
    with torch.no_grad():
        exported = torch.export.export(_Serve(net), xs)
    meta = {"platforms": platforms, "device": str(net.device),
            "inputs": [{"shape": list(x.shape), "dtype": str(x.dtype)}
                       for x in xs],
            "graph": not hasattr(net, "layers")}
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={"dl4j_meta.json": json.dumps(meta)})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_inference(src):
    """Load an exported artifact (bytes, or a str/PathLike file path) and
    return a callable `run(*features)` that runs it on the device it was
    exported on: host arrays in, numpy out (a list for a graph)."""
    # the kernels' registered ops the artifact names
    from deeplearning4j_tpu_torch.ops import (  # noqa: F401
        flash_attention,
        lstm,
    )

    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            src = f.read()
    extra = {"dl4j_meta.json": ""}
    exported = torch.export.load(io.BytesIO(bytes(src)), extra_files=extra)
    meta = json.loads(extra["dl4j_meta.json"])
    device = torch.device(meta["device"])
    dtypes = [getattr(torch, spec["dtype"].split(".")[-1])
              for spec in meta["inputs"]]
    module = exported.module()

    def run(*features):
        xs = [torch.as_tensor(np.asarray(f)).to(device=device, dtype=dt)
              for f, dt in zip(features, dtypes)]
        with torch.no_grad():
            out = module(*xs)
        if meta["graph"] or isinstance(out, (list, tuple)):
            return [o.detach().cpu().numpy() for o in out]
        return out.detach().cpu().numpy()

    return run
