"""MultiLayerNetwork: sequential network container and its training
loop (counterpart of `deeplearning4j_tpu/nn/multilayer.py`).

Parameters are a list (one entry per layer) of dicts of tensors on the
network's device, the JAX package's pytree; the optimizer state mirrors
it (layer -> parameter name -> state name -> tensor). The flat view of
`params()`/`set_params()` follows `jax.flatten_util.ravel_pytree`:
layer order, then sorted dict keys, each tensor in C order; so a flat
vector or a checkpoint written by the JAX package loads here unchanged.

One training step (`_step_core`) is the JAX package's: the loss of the
batch under the mixed-precision boundary of `_loss_pure`, its gradients
by autograd, then every layer's update applied in place to the f32
master weights under `torch.no_grad()`. PyTorch runs it eagerly; there
is no jit and no scan.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, fold_in
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    MultiLayerConfiguration,
    OptimizationAlgorithm,
)
from deeplearning4j_tpu_torch.nn.updater import (
    apply_layer_update,
    init_updater_state,
    regularization_score,
)
from deeplearning4j_tpu_torch.ops.kernel_dispatch import resolve_device

Params = List[Dict[str, torch.Tensor]]
UpdState = List[Dict[str, Dict[str, torch.Tensor]]]

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration, dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        """`dtype` is the parameter (master) dtype; `compute_dtype`
        (e.g. torch.bfloat16) the dtype the forward and backward run in,
        with parameters and optimizer state kept in `dtype`. `device`
        defaults to the card and raises when there is none; pass "cpu" to
        run on the CPU."""
        self.device = resolve_device(device)
        self.conf = conf
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self.layers: List[Layer] = conf.layers
        self._params: Optional[Params] = None
        self._upd_state: Optional[UpdState] = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        self._score: Optional[Any] = None
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
        the configuration's seed, on the network's device, and zero the
        optimizer state."""
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self._params = [
            layer.init_params(gen, self._input_types[i], self.dtype)
            if layer.has_params else {}
            for i, layer in enumerate(self.layers)]
        self._upd_state = [
            {name: init_updater_state(layer.updater_cfg, v)
             for name, v in p.items()} if layer.updater_cfg is not None
            else {} for layer, p in zip(self.layers, self._params)]

    def _ensure_init(self):
        if self._params is None:
            self.init()

    # ----------------------------------------------------------------- score
    @property
    def score_value(self) -> Optional[float]:
        """Loss of the most recent iteration. Kept as a device tensor by
        the training loop and turned into a float on first read (a read
        waits for the device)."""
        if self._score is None or isinstance(self._score, float):
            return self._score
        self._score = float(self._score)
        return self._score

    @score_value.setter
    def score_value(self, v) -> None:
        self._score = v if (v is None or isinstance(v, float)) else float(v)

    # ------------------------------------------------------------- forward
    def _int_input(self) -> bool:
        return bool(getattr(self.layers[0], "integer_input", False))

    def _forward_pure(self, params: Params, x, *, train: bool, rng,
                      fmask=None, upto: Optional[int] = None):
        n = len(self.layers) if upto is None else upto
        for i in range(n):
            mask = fmask if x.ndim == 3 else None
            x = self.layers[i].forward(params[i], x, train=train,
                                       rng=fold_in(rng, i), mask=mask)
        return x

    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Forward pass of every layer (inference): token ids (B, T) in,
        (B, T, n_out) activations out, on the network's device."""
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        self._ensure_init()
        x = wire_asarray(x, self.dtype, self.device, self._int_input())
        return self._forward_pure(self._params, x, train=False, rng=None)

    # ------------------------------------------------------------ training
    def _loss_pure(self, params: Params, features, labels, fmask, lmask,
                   rng, train: bool = True):
        """Output-layer loss + L1/L2. Mixed precision: every layer but
        the output layer runs in the compute dtype (token ids are never
        cast); the activations return to the parameter dtype before the
        output layer, which computes the loss, and the penalties, in the
        parameter dtype."""
        from deeplearning4j_tpu_torch.nn.precision import tree_cast

        params_in = params
        if self.compute_dtype is not None:
            params = [tree_cast(p, self.compute_dtype) for p in params]
            if not self._int_input():
                features = features.to(self.compute_dtype)
        n = len(self.layers)
        x = self._forward_pure(params, features, train=train, rng=rng,
                               fmask=fmask, upto=n - 1)
        if self.compute_dtype is not None:
            x = x.to(self.dtype)
        mask = lmask if lmask is not None else (fmask if x.ndim == 3 else None)
        loss = self.layers[-1].loss_score(params_in[-1], x, labels,
                                          train=train, rng=fold_in(rng, n - 1),
                                          mask=mask)
        return loss + regularization_score(zip(self.layers, params_in))

    def _step_core(self, features, labels, fmask, lmask) -> Tuple[
            torch.Tensor, List[Dict[str, torch.Tensor]]]:
        """One training step on one batch: loss, gradients, and every
        layer's update applied in place. Returns (loss, gradients)."""
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in self._params]
        flat = [t for p in leaves for t in p.values()]
        with torch.enable_grad():
            loss = self._loss_pure(leaves, features, labels, fmask, lmask,
                                   (self.conf.seed, self.iteration), True)
            g_flat = torch.autograd.grad(loss, flat, allow_unused=True)
        grads, it = [], iter(g_flat)
        for p in leaves:
            grads.append({k: (g if g is not None else torch.zeros_like(v))
                          for (k, v), g in zip(p.items(), it)})
        with torch.no_grad():
            for i, layer in enumerate(self.layers):
                apply_layer_update(layer, self._upd_state[i], self._params[i],
                                   grads[i], self.iteration)
        return loss.detach(), grads

    def _batch_arrays(self, ds: DataSet):
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        dev = self.device
        f = wire_asarray(ds.features, self.dtype, dev, self._int_input())
        l = None if ds.labels is None \
            else wire_asarray(ds.labels, self.dtype, dev)
        fm = None if ds.features_mask is None \
            else wire_asarray(ds.features_mask, self.dtype, dev)
        lm = None if ds.labels_mask is None \
            else wire_asarray(ds.labels_mask, self.dtype, dev)
        return f, l, fm, lm

    def fit(self, data: Union[DataSet, DataSetIterator, np.ndarray],
            labels: Optional[np.ndarray] = None, epochs: int = 1,
            scan_steps: int = 1) -> None:
        """Train on a DataSet, an iterator of DataSets, or (features,
        labels) arrays, for `epochs` passes. `scan_steps` is accepted for
        the JAX package's signature: its batches run one step each, which
        gives the same results."""
        self._ensure_init()
        algo = self.conf.global_conf.optimization_algo
        if algo != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT:
            raise _not_ported(f"line-search solvers ({algo.value})",
                              "queue A10: optimize/solvers.py")
        if self.conf.tbptt_fwd_length > 0:
            raise _not_ported("truncated BPTT", "queue 3: the recurrent path")
        if isinstance(data, (np.ndarray, torch.Tensor)):
            data = DataSet(data, labels)
        iterator = ListDataSetIterator([data]) if isinstance(data, DataSet) \
            else data
        for _ in range(epochs):
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_start"):
                    listener.on_epoch_start(self)
            n_batches = 0
            for ds in iterator:
                n_batches += 1
                self._fit_batch(ds)
            if n_batches == 0:
                logger.warning("fit(): iterator produced no batches this "
                               "epoch")
            for listener in self.listeners:
                if hasattr(listener, "on_epoch_end"):
                    listener.on_epoch_end(self)
            self.epoch += 1

    def _fit_batch(self, ds: DataSet) -> None:
        self._validate_labels(ds)
        f, l, fm, lm = self._batch_arrays(ds)
        self._score, _ = self._step_core(f, l, fm, lm)
        self.iteration += 1
        for listener in self.listeners:
            if hasattr(listener, "record_batch"):
                listener.record_batch(ds.num_examples())
            listener.iteration_done(self, self.iteration)

    def _validate_labels(self, ds: DataSet) -> None:
        if ds.labels is None:
            raise ValueError("fit() requires labels; got DataSet with "
                             "labels=None (pretrain() is not ported)")
        n_out = getattr(self.layers[-1], "n_out", None)
        labels = ds.labels
        sparse = (not labels.is_floating_point()
                  if isinstance(labels, torch.Tensor)
                  else np.issubdtype(np.asarray(labels).dtype, np.integer))
        if sparse:
            from deeplearning4j_tpu_torch.ops.losses import (
                check_sparse_label_range,
            )

            check_sparse_label_range(labels, n_out, mask=ds.labels_mask)
            return
        if n_out and labels.shape[-1] != n_out:
            raise ValueError(
                f"labels have width {labels.shape[-1]} but output layer "
                f"has n_out={n_out} (features shape "
                f"{tuple(ds.features.shape)}, labels shape "
                f"{tuple(labels.shape)})")

    def score(self, ds: DataSet) -> float:
        """Loss on a dataset without updating (no dropout)."""
        self._ensure_init()
        if ds.labels is not None:
            from deeplearning4j_tpu_torch.ops.losses import (
                check_sparse_label_range,
            )

            check_sparse_label_range(ds.labels,
                                     getattr(self.layers[-1], "n_out", None),
                                     mask=ds.labels_mask)
        f, l, fm, lm = self._batch_arrays(ds)
        with torch.no_grad():
            return float(self._loss_pure(self._params, f, l, fm, lm, None,
                                         False))

    def compute_gradient_and_score(self, ds: DataSet
                                   ) -> Tuple[np.ndarray, float]:
        """Flat gradient (ravel order) and score at the current
        parameters, without dropout."""
        self._ensure_init()
        f, l, fm, lm = self._batch_arrays(ds)
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in self._params]
        ordered = [p[k] for p in leaves for k in sorted(p)]
        with torch.enable_grad():
            loss = self._loss_pure(leaves, f, l, fm, lm, None, True)
            grads = torch.autograd.grad(loss, ordered, allow_unused=True)
        flat = torch.cat([(g if g is not None else torch.zeros_like(t))
                          .reshape(-1) for g, t in zip(grads, ordered)])
        return flat.detach().cpu().numpy(), float(loss.detach())

    # --------------------------------------------------------- not ported
    def set_normalizer(self, normalizer) -> None:
        raise _not_ported("device-side normalizers", "queue A14: data")

    def set_health_sentinel(self, sentinel) -> None:
        raise _not_ported("the training health sentinel",
                          "queue A10: optimize/health.py")

    def pretrain(self, iterator, epochs: int = 1) -> None:
        raise _not_ported("layerwise pretraining",
                          "queue A9: AutoEncoder/RBM/VAE layers")

    def evaluate(self, iterator, labels=None, top_n: int = 1):
        raise _not_ported("evaluate", "queue A10: eval/evaluation.py")

    # ------------------------------------------------------------- helpers
    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def get_updater_state(self) -> UpdState:
        return self._upd_state

    def set_updater_state(self, state) -> None:
        """Load an optimizer-state tree (for example from
        `util.serialization.updater_state_from_jax`), checked against this
        network's names and shapes, cast to its dtype and device."""
        self._ensure_init()
        if len(state) != len(self._upd_state):
            raise ValueError(f"{len(state)} layers given, network has "
                             f"{len(self._upd_state)}")
        for i, (mine, theirs) in enumerate(zip(self._upd_state, state)):
            if set(mine) != set(theirs) or any(
                    set(mine[k]) != set(theirs[k]) for k in mine):
                raise ValueError(f"layer {i}: updater state names differ")
            for k in mine:
                for sk, t in theirs[k].items():
                    t = torch.as_tensor(np.asarray(t) if not isinstance(
                        t, torch.Tensor) else t)
                    if tuple(t.shape) != tuple(mine[k][sk].shape):
                        raise ValueError(f"layer {i} {k}.{sk}: shape "
                                         f"{tuple(t.shape)} != "
                                         f"{tuple(mine[k][sk].shape)}")
                    mine[k][sk] = t.to(device=self.device, dtype=self.dtype,
                                       copy=True)

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
                q[k] = t.to(device=self.device, dtype=self.dtype, copy=True)
            new.append(q)
        self._params = new

    def num_params(self) -> int:
        self._ensure_init()
        return sum(v.numel() for p in self._params for v in p.values())
