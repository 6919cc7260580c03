"""MultiLayerNetwork: sequential network container (counterpart of
`deeplearning4j_tpu/nn/multilayer.py`), inference surface.

Parameters are a list (one entry per layer) of dicts of tensors on the
network's device, the JAX package's pytree. The flat view of
`params()`/`set_params()` follows `jax.flatten_util.ravel_pytree`:
layer order, then sorted dict keys, each tensor in C order; so a flat
vector or a checkpoint written by the JAX package loads here unchanged.
`fit` comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration,
)
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device

Params = List[Dict[str, torch.Tensor]]


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        """`dtype` is the parameter (master) dtype; `compute_dtype`
        (e.g. torch.bfloat16) the dtype the serving path computes the
        embedding and the blocks in. `device` defaults to the card and
        raises when there is none; pass "cpu" to run on the CPU."""
        self.device = resolve_device(device)
        self.conf = conf
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.layers: List[Layer] = conf.layers
        self._params: Optional[Params] = None
        self._input_types = self._resolve_input_types()

    def _resolve_input_types(self) -> List[InputType]:
        """Per-layer input InputType, as inferred at config build time."""
        it = self.conf.input_type
        if it is None:
            l0 = self.layers[0]
            n_in = getattr(l0, "n_in", 0)
            it = InputType.recurrent(n_in) if l0.input_kind == "rnn" \
                else InputType.feed_forward(n_in)
        out = []
        for layer in self.layers:
            out.append(it)
            it = layer.output_type(it)
        return out

    def init(self) -> None:
        """Draw every layer's parameters from one generator seeded with
        the configuration's seed, on the network's device."""
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self._params = [
            layer.init_params(gen, self._input_types[i], self.dtype)
            if layer.has_params else {}
            for i, layer in enumerate(self.layers)]

    def _ensure_init(self):
        if self._params is None:
            self.init()

    # ------------------------------------------------------------- forward
    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Forward pass of every layer (inference): token ids (B, T) in,
        (B, T, n_out) activations out, on the network's device."""
        self._ensure_init()
        x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x, device=self.device)
        if x.is_floating_point() \
                and not getattr(self.layers[0], "integer_input", False):
            x = x.to(self.dtype)
        for layer, p in zip(self.layers, self._params):
            x = layer.forward(p, x)
        return x

    # ---------------------------------------------------- params / serde
    def params(self) -> torch.Tensor:
        """Flat parameter vector in `ravel_pytree` order."""
        self._ensure_init()
        return torch.cat([p[k].reshape(-1) for p in self._params
                          for k in sorted(p)])

    def set_params(self, flat) -> None:
        """Load a flat vector (numpy or tensor) in `ravel_pytree` order."""
        self._ensure_init()
        flat = torch.as_tensor(np.asarray(flat) if not isinstance(
            flat, torch.Tensor) else flat)
        n = sum(v.numel() for p in self._params for v in p.values())
        if flat.ndim != 1 or flat.numel() != n:
            raise ValueError(f"flat parameter vector has shape "
                             f"{tuple(flat.shape)}; the network expects ({n},)")
        flat = flat.to(device=self.device, dtype=self.dtype)
        off = 0
        new = []
        for p in self._params:
            q = {}
            for k in sorted(p):
                m = p[k].numel()
                q[k] = flat[off:off + m].reshape(p[k].shape).clone()
                off += m
            new.append(q)
        self._params = new

    def set_param_tree(self, params: Params) -> None:
        """Load a per-layer list of parameter dicts (for example from
        `util.serialization.params_from_jax`), checked against this
        network's names and shapes, cast to its dtype and device."""
        self._ensure_init()
        if len(params) != len(self._params):
            raise ValueError(f"{len(params)} layers given, network has "
                             f"{len(self._params)}")
        new = []
        for i, (mine, theirs) in enumerate(zip(self._params, params)):
            if set(mine) != set(theirs):
                raise ValueError(f"layer {i}: parameter names "
                                 f"{sorted(theirs)} != {sorted(mine)}")
            q = {}
            for k, v in theirs.items():
                t = torch.as_tensor(v)
                if tuple(t.shape) != tuple(mine[k].shape):
                    raise ValueError(f"layer {i} {k}: shape {tuple(t.shape)} "
                                     f"!= {tuple(mine[k].shape)}")
                q[k] = t.to(device=self.device, dtype=self.dtype)
            new.append(q)
        self._params = new

    def num_params(self) -> int:
        self._ensure_init()
        return sum(v.numel() for p in self._params for v in p.values())
