"""MultiLayerNetwork: sequential network container and its training
loop (counterpart of `deeplearning4j_tpu/nn/multilayer.py`). What it
shares with `nn.graph.ComputationGraph` (the step, the guard, tBPTT's
window loop, the flat views, the tree loads, layerwise pretraining's
step) is `NetworkBase`.

Parameters are a list (one entry per layer) of dicts of tensors on the
network's device, the JAX package's pytree; the optimizer state mirrors
it (layer -> parameter name -> state name -> tensor). The flat view of
`params()`/`set_params()` follows `jax.flatten_util.ravel_pytree`:
layer order, then sorted dict keys, each tensor in C order; so a flat
vector or a checkpoint written by the JAX package loads here unchanged.

One training step is the JAX package's: the loss of the batch under the
mixed-precision boundary of `_loss_pure`, its gradients by autograd
(`_loss_and_grads`), then every layer's update applied in place to the
f32 master weights under `torch.no_grad()` (`_apply_updates`). PyTorch
runs it eagerly; there is no jit and no scan. With a health sentinel
attached (`set_health_sentinel`), the step reads one `(loss, grad_norm,
ok)` vector to the host between the two and applies the updates only
when loss and gradient norm are finite; the arithmetic of a committed
step is the unguarded step's. A line-search `optimization_algo` trains
each batch through `optimize.solvers.Solver` instead.

Layer state (`_layer_state`, one dict per layer, from each layer's
`init_state`) holds BatchNormalization's running mean and variance,
which a training step moves and inference reads, and, while truncated
BPTT runs, the recurrent layers' (h, c) carried from one window to the
next (`_fit_tbptt`); `rnn_time_step` keeps its own streaming carry
(`_rnn_state`). The configuration's input preprocessors run before their
layers on every path. A layer may add a loss term during the training
forward (the MoE load-balancing loss, `ops.aux_loss`); `_loss_pure` adds
them to the loss. A normalizer attached with `set_normalizer` runs on
the device before layer 0: `OneHotEncoder` expands raw ids, the
statistics normalizers scale features cast to the parameter dtype.
`pretrain` trains each layer that has a `pretrain_loss` (AutoEncoder,
RBM, VariationalAutoencoder) in turn on its input through the frozen
layers before it.
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
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, _generator, fold_in
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
LState = List[Dict[str, torch.Tensor]]

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _tree_items(tree):
    """(key, per-layer dict) pairs of a network tree in `ravel_pytree`
    order: a list in layer order, a dict (a graph's, by node name) in
    sorted key order, as jax flattens a dict."""
    return list(enumerate(tree)) if isinstance(tree, list) \
        else sorted(tree.items())


def _tree_map(fn, tree):
    """`fn` of every per-layer entry, in a tree of the same kind."""
    if isinstance(tree, list):
        return [fn(v) for v in tree]
    return {k: fn(v) for k, v in tree.items()}


def run_layer(layer: Layer, p, state, x, train: bool, rng, mask=None):
    """(out, new state) of one layer: a stateful layer reads and returns
    its state, the others keep theirs."""
    if layer.stateful:
        return layer.forward_with_state(p, state, x, train=train, rng=rng,
                                        mask=mask)
    return layer.forward(p, x, train=train, rng=rng, mask=mask), state


class NetworkBase:
    """What the list container and the graph share: the training step
    (loss and gradients by autograd, the optional finite guard, every
    layer's update in place, the listeners), truncated BPTT's window
    loop, the flat parameter view in `ravel_pytree` order, the checked
    loads of parameter, optimizer and layer-state trees, and the loss
    surfaces for gradient checks. A subclass keeps its trees (`_params`,
    `_upd_state`, `_layer_state`) as a list by layer or a dict by node
    name, and supplies `_layer_slots`, `_batch_arrays`, `_loss_pure`,
    `_validate_labels`, `_check_sparse_labels` and the tBPTT windows."""

    def __init__(self, conf, dtype, compute_dtype, device):
        """`dtype` is the parameter (master) dtype; `compute_dtype`
        (e.g. torch.bfloat16) the dtype the forward and backward run in,
        with parameters and optimizer state kept in `dtype`. `device`
        defaults to the card and raises when there is none; pass "cpu" to
        run on the CPU."""
        self.device = resolve_device(device)
        self.conf = conf
        self.dtype = dtype
        self.compute_dtype = compute_dtype
        self._params = None
        self._upd_state = None
        self._layer_state = None
        self._rnn_state: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._rnn_pos = 0
        self._normalizer = None
        self._sentinel = None
        self._last_batch = None
        self.iteration = 0
        self.epoch = 0
        self.listeners: List[Any] = []
        self._score: Optional[Any] = None

    def _layer_slots(self) -> List[Tuple[Any, Layer]]:
        """(tree key, layer) of every layer."""
        raise NotImplementedError

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

    def get_normalizer(self):
        return self._normalizer

    # ------------------------------------------------------------ training
    def _loss_and_grads(self, features, labels, fmask, lmask):
        """The loss of one batch and its gradients by autograd (a tree of
        per-layer dicts, zeros for unused parameters), at the current
        parameters; the new layer state, detached (no gradient crosses
        batches or tBPTT windows). Changes nothing."""
        leaves = _tree_map(lambda p: {k: v.detach().requires_grad_(True)
                                      for k, v in p.items()}, self._params)
        flat = [t for _, p in _tree_items(leaves) for t in p.values()]
        with torch.enable_grad():
            loss, new_state = self._loss_pure(
                leaves, features, labels, fmask, lmask,
                (self.conf.seed, self.iteration), True, self._layer_state)
            g_flat = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(g_flat)
        grads = {key: {k: (g if g is not None else torch.zeros_like(v))
                       for (k, v), g in zip(p.items(), it)}
                 for key, p in _tree_items(leaves)}
        if isinstance(leaves, list):
            grads = [grads[i] for i in range(len(leaves))]
        new_state = _tree_map(lambda st: {k: v.detach()
                                          for k, v in st.items()}, new_state)
        return loss.detach(), grads, new_state

    def _apply_updates(self, grads, new_state) -> None:
        """Every layer's update applied in place to the parameters and
        the optimizer state; the new layer state replaces the old."""
        with torch.no_grad():
            for key, layer in self._layer_slots():
                apply_layer_update(layer, self._upd_state[key],
                                   self._params[key], grads[key],
                                   self.iteration)
        self._layer_state = new_state

    @staticmethod
    def _health(loss, grads) -> torch.Tensor:
        """`[loss, grad_norm, ok]` in f32 on the device: the global
        gradient norm from each leaf's f32 sum of squares, added leaf by
        leaf in the JAX package's order (layer order, sorted names); ok is
        1 when loss and squared norm are both finite (a squared norm that
        overflows f32 counts as non-finite)."""
        gsq = None
        for _, g in _tree_items(grads):
            for k in sorted(g):
                s = torch.sum(torch.square(g[k].float()))
                gsq = s if gsq is None else gsq + s
        if gsq is None:
            gsq = torch.zeros((), dtype=torch.float32, device=loss.device)
        ok = torch.isfinite(loss) & torch.isfinite(gsq)
        return torch.stack([loss.float(), torch.sqrt(gsq), ok.float()])

    def _fit_batch(self, ds: DataSet) -> None:
        """One training step on one batch. With a health sentinel, the
        step's health vector is read to the host (its one sync) before
        the updates, which run only when it says finite; the iteration
        advances either way, and the sentinel's verdict (which may raise)
        comes before the listeners see the step."""
        self._validate_labels(ds)
        f, l, fm, lm = self._batch_arrays(ds)
        loss, grads, new_state = self._loss_and_grads(f, l, fm, lm)
        health = None
        if self._sentinel is None:
            self._apply_updates(grads, new_state)
            self._score = loss
        else:
            health = self._health(loss, grads).cpu().numpy()
            if health[2] >= 0.5:
                self._apply_updates(grads, new_state)
            self._score = float(health[0])
        self._last_batch = ds
        self.iteration += 1
        if health is not None:
            self._sentinel.observe(self, health)
        self._notify(ds)

    def _notify(self, ds) -> None:
        for listener in self.listeners:
            if hasattr(listener, "record_batch"):
                listener.record_batch(ds.num_examples())
            listener.iteration_done(self, self.iteration)

    def _fit_epochs(self, iterator, epochs: int, fit_one) -> None:
        """`epochs` passes of `fit_one(batch)` over `iterator`, with the
        listeners' epoch hooks. When an exception leaves the loop, the
        producer thread of an `AsyncDataSetIterator` being iterated is
        stopped before it propagates."""
        from deeplearning4j_tpu_torch.datasets.iterators import (
            AsyncDataSetIterator,
        )

        try:
            for _ in range(epochs):
                for listener in self.listeners:
                    if hasattr(listener, "on_epoch_start"):
                        listener.on_epoch_start(self)
                n_batches = 0
                for ds in iterator:
                    n_batches += 1
                    fit_one(ds)
                if n_batches == 0:
                    logger.warning("fit(): iterator produced no batches "
                                   "this epoch")
                for listener in self.listeners:
                    if hasattr(listener, "on_epoch_end"):
                        listener.on_epoch_end(self)
                self.epoch += 1
        except BaseException:
            if isinstance(iterator, AsyncDataSetIterator):
                iterator.close()
            raise

    # ------------------------------------------------------ truncated BPTT
    def _fit_tbptt(self, ds) -> None:
        """Truncated BPTT: the time axis in `tbptt_fwd_length` windows,
        one training step each, the LSTM (h, c) carried from window to
        window without a gradient; the score is the windows' mean loss.
        The windows (and their label checks) are built before the carries
        are seeded, and the persistent state slots are restored whatever
        happens."""
        windows = self._tbptt_windows(ds)
        saved = self._tbptt_seed_carries(ds.num_examples())
        losses = []
        try:
            for window in windows:
                self._fit_batch(window)
                losses.append(self._score)
        finally:
            self._tbptt_restore_carries(saved)
        self.score_value = float(np.mean([float(l) for l in losses]))

    def _tbptt_seed_carries(self, B: int):
        """Zero (h, c) carries in every GravesLSTM slot (not the
        bidirectional one); returns the saved slots."""
        from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTM

        saved = {}
        for key, layer in self._layer_slots():
            if type(layer) is GravesLSTM:
                zero = torch.zeros((B, layer.n_out), dtype=self.dtype,
                                   device=self.device)
                saved[key] = self._layer_state[key]
                self._layer_state[key] = {"h": zero, "c": zero.clone()}
        return saved

    def _tbptt_restore_carries(self, saved) -> None:
        for key, st in saved.items():
            self._layer_state[key] = st

    # ------------------------------------------------------ scores, checks
    def score(self, ds, train: bool = False) -> float:
        """Loss on a dataset without updating, no dropout (`train=True`:
        the layers' train-mode forward, still without a dropout draw, as
        in the JAX package)."""
        self._ensure_init()
        self._check_sparse_labels(ds)
        f, l, fm, lm = self._batch_arrays(ds)
        with torch.no_grad():
            return float(self._loss_pure(self._params, f, l, fm, lm, None,
                                         train, self._layer_state)[0])

    def score_function(self, ds):
        """A closure flat parameters (`params()` order) -> loss on this
        fixed batch, without dropout, for gradient checks by central
        differences; differentiable in the flat vector."""
        self._ensure_init()
        self._check_sparse_labels(ds)
        f, l, fm, lm = self._batch_arrays(ds)

        def score_at(flat) -> torch.Tensor:
            return self._loss_pure(self._unravel(flat), f, l, fm, lm, None,
                                   True, self._layer_state)[0]

        return score_at

    def compute_gradient_and_score(self, ds) -> Tuple[np.ndarray, float]:
        """Flat gradient (ravel order) and score at the current
        parameters, without dropout."""
        self._ensure_init()
        self._check_sparse_labels(ds)
        f, l, fm, lm = self._batch_arrays(ds)
        leaves = _tree_map(lambda p: {k: v.detach().requires_grad_(True)
                                      for k, v in p.items()}, self._params)
        ordered = [p[k] for _, p in _tree_items(leaves) for k in sorted(p)]
        with torch.enable_grad():
            loss = self._loss_pure(leaves, f, l, fm, lm, None, True,
                                   self._layer_state)[0]
            grads = torch.autograd.grad(loss, ordered, allow_unused=True)
        flat = torch.cat([(g if g is not None else torch.zeros_like(t))
                          .reshape(-1) for g, t in zip(grads, ordered)])
        return flat.detach().cpu().numpy(), float(loss.detach())

    # ---------------------------------------------------- health sentinel
    def set_health_sentinel(self, sentinel) -> None:
        """Attach an `optimize.health.HealthSentinel` (None detaches): each
        training step then computes one global gradient norm and a finite
        flag, reads `(loss, grad_norm, ok)` to the host once, and applies
        the parameter, optimizer and layer-state updates only when loss
        and norm are finite (the iteration advances either way); the
        sentinel runs its skip -> LR backoff -> rollback -> give-up ladder
        on those scalars. Not copied by `clone()`."""
        self._sentinel = sentinel

    def get_health_sentinel(self):
        return self._sentinel

    # ------------------------------------------------------------- helpers
    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def get_updater_state(self):
        return self._upd_state

    def _copy_into(self, net) -> None:
        """The normalizer (shared), copies of the parameters, optimizer
        state and layer state, and the iteration, epoch and score, into
        `net`, a fresh network of the same configuration."""
        net._normalizer = self._normalizer
        if self._params is not None:
            copy = lambda d: {k: v.clone() for k, v in d.items()}
            net._params = _tree_map(copy, self._params)
            net._upd_state = _tree_map(
                lambda u: {k: copy(st) for k, st in u.items()},
                self._upd_state)
            net._layer_state = _tree_map(copy, self._layer_state)
        net.iteration = self.iteration
        net.epoch = self.epoch
        net.score_value = self.score_value

    def set_updater_state(self, state) -> None:
        """Load an optimizer-state tree (for example from
        `util.serialization.updater_state_from_jax`), checked against this
        network's names and shapes, cast to its dtype and device."""
        self._ensure_init()
        self._check_keys(self._upd_state, state, "updater state")
        for key, mine in _tree_items(self._upd_state):
            theirs = state[key]
            if set(mine) != set(theirs) or any(
                    set(mine[k]) != set(theirs[k]) for k in mine):
                raise ValueError(f"layer {key}: updater state names differ")
            for k in mine:
                for sk, t in theirs[k].items():
                    t = torch.as_tensor(np.asarray(t) if not isinstance(
                        t, torch.Tensor) else t)
                    if tuple(t.shape) != tuple(mine[k][sk].shape):
                        raise ValueError(f"layer {key} {k}.{sk}: shape "
                                         f"{tuple(t.shape)} != "
                                         f"{tuple(mine[k][sk].shape)}")
                    mine[k][sk] = t.to(device=self.device, dtype=self.dtype,
                                       copy=True)

    # ---------------------------------------------------- params / serde
    def params(self) -> torch.Tensor:
        """Flat parameter vector in `ravel_pytree` order."""
        self._ensure_init()
        return torch.cat([p[k].reshape(-1)
                          for _, p in _tree_items(self._params)
                          for k in sorted(p)])

    def _unravel(self, flat):
        """A flat vector (numpy or tensor) in `ravel_pytree` order as this
        network's parameter tree, on its device in its dtype (views of
        the vector where it already is one)."""
        flat = torch.as_tensor(np.asarray(flat) if not isinstance(
            flat, torch.Tensor) else flat)
        n = self.num_params()
        if flat.ndim != 1 or flat.numel() != n:
            raise ValueError(f"flat parameter vector has shape "
                             f"{tuple(flat.shape)}; the network expects ({n},)")
        flat = flat.to(device=self.device, dtype=self.dtype)
        off = 0
        tree = {}
        for key, p in _tree_items(self._params):
            q = {}
            for k in sorted(p):
                m = p[k].numel()
                q[k] = flat[off:off + m].reshape(p[k].shape)
                off += m
            tree[key] = q
        if isinstance(self._params, list):
            return [tree[i] for i in range(len(self._params))]
        return tree

    def set_params(self, flat) -> None:
        """Load a flat vector (numpy or tensor) in `ravel_pytree` order."""
        self._ensure_init()
        self._params = _tree_map(lambda p: {k: v.clone()
                                            for k, v in p.items()},
                                 self._unravel(flat))

    def set_param_tree(self, params) -> None:
        """Load a parameter tree (for example from
        `util.serialization.params_from_jax`), checked against this
        network's names and shapes, cast to its dtype and device."""
        self._ensure_init()
        self._params = self._checked_copy(self._params, params, "parameter",
                                          self.dtype)

    def set_layer_state(self, state) -> None:
        """Load a layer-state tree (BatchNormalization's running
        `mean`/`var`; the JAX network's `_layer_state` through
        `util.serialization.params_from_jax`), checked against this
        network's names and shapes, on its device in each slot's dtype."""
        self._ensure_init()
        self._layer_state = self._checked_copy(self._layer_state, state,
                                               "state", None)

    @staticmethod
    def _check_keys(mine_tree, theirs_tree, what: str) -> None:
        if isinstance(mine_tree, list):
            if len(theirs_tree) != len(mine_tree):
                raise ValueError(f"{len(theirs_tree)} layers given, network "
                                 f"has {len(mine_tree)}")
        elif set(theirs_tree) != set(mine_tree):
            raise ValueError(f"{what} nodes {sorted(theirs_tree)} != "
                             f"{sorted(mine_tree)}")

    def _checked_copy(self, mine_tree, theirs_tree, what: str, dtype):
        """Copies of `theirs_tree`'s tensors on this network's device, in
        `dtype` (None: the dtype of the slot each replaces), after checking
        its layers, names and shapes against `mine_tree`."""
        self._check_keys(mine_tree, theirs_tree, what)
        new = {}
        for key, mine in _tree_items(mine_tree):
            theirs = theirs_tree[key]
            if set(mine) != set(theirs):
                raise ValueError(f"layer {key}: {what} names "
                                 f"{sorted(theirs)} != {sorted(mine)}")
            q = {}
            for k, v in theirs.items():
                t = torch.as_tensor(v)
                if tuple(t.shape) != tuple(mine[k].shape):
                    raise ValueError(f"layer {key} {k}: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(mine[k].shape)}")
                q[k] = t.to(device=self.device, dtype=dtype or mine[k].dtype,
                            copy=True)
            new[key] = q
        if isinstance(mine_tree, list):
            return [new[i] for i in range(len(mine_tree))]
        return new

    def num_params(self) -> int:
        self._ensure_init()
        return sum(v.numel() for _, p in _tree_items(self._params)
                   for v in p.values())

    # ------------------------------------------------------------ pretrain
    def _pretrain_layer(self, key, position: int, layer, batches,
                        epochs: int, layer_input) -> None:
        """Greedy layerwise pretraining of one layer: `epochs` passes over
        `batches` (an iterator of DataSets or MultiDataSets), each step
        the gradient of `layer.pretrain_loss` on the layer's input
        (`layer_input(batch)`, computed through the frozen layers before
        it without a gradient) applied with the layer's own updater and
        state; `score_value` is each step's loss. Each step draws from a
        generator of its own, made from (seed + position, step): the same
        stream for layer i of the list container and node i of a
        linear-chain graph's topological order."""
        it_count = 0
        for _ in range(epochs):
            for ds in batches:
                with torch.no_grad():
                    x = layer_input(ds)
                leaves = {k: v.detach().requires_grad_(True)
                          for k, v in self._params[key].items()}
                gen = _generator((self.conf.seed + position, it_count),
                                 self.device)
                with torch.enable_grad():
                    loss = layer.pretrain_loss(leaves, x, gen)
                    g = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
                grads = {k: (gk if gk is not None else torch.zeros_like(v))
                         for (k, v), gk in zip(leaves.items(), g)}
                with torch.no_grad():
                    apply_layer_update(layer, self._upd_state[key],
                                       self._params[key], grads, it_count)
                self._score = loss.detach()
                it_count += 1


class MultiLayerNetwork(NetworkBase):
    def __init__(self, conf: MultiLayerConfiguration, dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        super().__init__(conf, dtype, compute_dtype, device)
        self.layers: List[Layer] = conf.layers
        self._input_types = self._resolve_input_types()

    def _layer_slots(self):
        return list(enumerate(self.layers))

    def _layer_input_type(self, i: int) -> InputType:
        return self._input_types[i]

    def _resolve_input_types(self) -> List[InputType]:
        """Per-layer input InputType, as inferred at config build time."""
        it = self.conf.input_type
        if it is None:
            l0 = self.layers[0]
            n_in = getattr(l0, "n_in", 0)
            it = InputType.recurrent(n_in) if l0.input_kind == "rnn" \
                else InputType.feed_forward(n_in)
        out = []
        for i, layer in enumerate(self.layers):
            if i in self.conf.preprocessors:
                it = self.conf.preprocessors[i].output_type(it)
            out.append(it)
            it = layer.output_type(it)
        return out

    def init(self) -> None:
        """Draw every layer's parameters from one generator seeded with
        the configuration's seed, on the network's device, and zero the
        optimizer state; each layer's state from its `init_state`."""
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        self._params = [
            layer.init_params(gen, self._input_types[i], self.dtype)
            if layer.has_params else {}
            for i, layer in enumerate(self.layers)]
        self._upd_state = [
            {name: init_updater_state(layer.updater_cfg, v)
             for name, v in p.items()} if layer.updater_cfg is not None
            else {} for layer, p in zip(self.layers, self._params)]
        self._layer_state = [layer.init_state(self._input_types[i],
                                              self.device)
                             for i, layer in enumerate(self.layers)]

    # --------------------------------------------------------- normalizer
    def set_normalizer(self, normalizer) -> None:
        """Attach a normalizer whose `device_transform` runs on the device
        before layer 0 (`OneHotEncoder` on raw ids, the statistics
        normalizers on features cast to the parameter dtype), so batches
        cross to the device in their compact dtypes; it is also what
        `write_model(..., normalizer=)` stores. None detaches."""
        if normalizer is not None:
            normalizer.check_device_attachable()
            if self._int_input():
                raise ValueError(
                    "cannot attach a normalizer to a network whose first "
                    "layer consumes integer token ids "
                    f"({type(self.layers[0]).__name__}): ids are never "
                    "scaled, so the normalizer would be silently ignored")
        self._normalizer = normalizer

    def _feature_wire_mode(self) -> str:
        """'sink' (an integer-id first layer: ids pass straight through),
        'ids' (an id-consuming normalizer expands raw ids) or 'float'
        (cast to the model dtype)."""
        if self._int_input():
            return "sink"
        if self._normalizer is not None \
                and self._normalizer.consumes_integer_ids:
            return "ids"
        return "float"

    def _prep_features(self, features):
        """Token ids as they are; ids through the attached id-consuming
        normalizer, then in the model dtype; any other features in the
        model dtype, then through the attached normalizer."""
        mode = self._feature_wire_mode()
        if mode == "sink":
            return features
        if mode == "ids":
            features = self._normalizer.device_transform(features)
            return features if features.dtype == self.dtype \
                else features.to(self.dtype)
        if features.dtype != self.dtype:
            features = features.to(self.dtype)
        if self._normalizer is not None:
            features = self._normalizer.device_transform(features)
        return features

    # ------------------------------------------------------------- forward
    def _int_input(self) -> bool:
        return bool(getattr(self.layers[0], "integer_input", False))

    def _forward_pure(self, params: Params, x, *, train: bool, rng,
                      fmask=None, upto: Optional[int] = None,
                      lstate: Optional[LState] = None):
        """Every layer up to `upto`, each after its input preprocessor:
        (activations, new layer state). A stateful layer gets its
        `lstate` slot and returns the next one."""
        n = len(self.layers) if upto is None else upto
        new_state = list(lstate) if lstate is not None \
            else [{} for _ in self.layers]
        for i in range(n):
            lrng = fold_in(rng, i)
            x = self._preprocess(i, x, lrng, train)
            mask = fmask if x.ndim == 3 else None
            x, new_state[i] = run_layer(self.layers[i], params[i],
                                        new_state[i], x, train, lrng, mask)
        return x, new_state

    def _preprocess(self, i: int, x, rng=None, train: bool = False):
        """Layer i's input preprocessor, if the configuration has one."""
        pre = self.conf.preprocessors.get(i)
        return x if pre is None else pre.preprocess(x, rng=rng, train=train)

    def _wire_features(self, x):
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        return wire_asarray(x, self.dtype, self.device,
                            self._feature_wire_mode() != "float")

    @torch.no_grad()
    def output(self, x, train: bool = False) -> torch.Tensor:
        """Forward pass of every layer: features (token ids (B, T), ids
        for an attached OneHotEncoder, or (B, T, F) floats) in, (B, T,
        n_out) activations out, on the network's device. `train=True`
        runs the layers' train-mode forward, with dropout drawn from the
        current iteration (as a training step draws it)."""
        self._ensure_init()
        x = self._prep_features(self._wire_features(x))
        rng = (self.conf.seed, self.iteration) if train else None
        return self._forward_pure(self._params, x, train=train, rng=rng,
                                  lstate=self._layer_state)[0]

    def predict(self, x) -> torch.Tensor:
        """The index of the largest output (inference), on the network's
        device."""
        return torch.argmax(self.output(x), dim=-1)

    @torch.no_grad()
    def feed_forward(self, x) -> List[torch.Tensor]:
        """Every layer's activations (inference), in layer order."""
        self._ensure_init()
        h = self._prep_features(self._wire_features(x))
        acts = []
        for i, p in enumerate(self._params):
            h, _ = run_layer(self.layers[i], p, self._layer_state[i],
                             self._preprocess(i, h), False, None)
            acts.append(h)
        return acts

    # ------------------------------------------------------------ training
    def _loss_pure(self, params: Params, features, labels, fmask, lmask,
                   rng, train: bool = True, lstate: Optional[LState] = None):
        """(output-layer loss + L1/L2 + the layers' aux-loss terms, new
        layer state). Mixed precision: every layer but the output layer
        runs in the compute dtype (token ids are never cast); the
        activations return to the parameter dtype before the output
        layer, which computes the loss, and the penalties, in the
        parameter dtype; carried state keeps its dtype."""
        from deeplearning4j_tpu_torch.nn.precision import (
            restore_dtypes,
            tree_cast,
        )
        from deeplearning4j_tpu_torch.ops.aux_loss import aux_loss_scope
        from deeplearning4j_tpu_torch.ops.losses import (
            add_penalties,
            weigh_share,
        )

        params_in = params
        features = self._prep_features(features)
        if self.compute_dtype is not None:
            params = [tree_cast(p, self.compute_dtype) for p in params]
            if not self._int_input():
                features = features.to(self.compute_dtype)
        n = len(self.layers)
        with aux_loss_scope() as aux_terms:
            x, new_state = self._forward_pure(params, features, train=train,
                                              rng=rng, fmask=fmask,
                                              upto=n - 1, lstate=lstate)
        if self.compute_dtype is not None:
            x = x.to(self.dtype)
            if lstate is not None:
                new_state = restore_dtypes(new_state, lstate)
        out_rng = fold_in(rng, n - 1)
        x = self._preprocess(n - 1, x, out_rng, train)
        mask = lmask if lmask is not None else (fmask if x.ndim == 3 else None)
        loss = self.layers[-1].loss_score(params_in[-1], x, labels,
                                          train=train, rng=out_rng,
                                          mask=mask)
        loss = add_penalties(loss,
                             regularization_score(zip(self.layers, params_in)))
        for term in aux_terms:  # mid-network losses (MoE load balancing)
            loss = loss + term
        return weigh_share(loss), new_state

    def _batch_arrays(self, ds: DataSet):
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        dev = self.device
        f = self._wire_features(ds.features)
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
        gives the same results. A line-search `optimization_algo`
        (LINE_GRADIENT_DESCENT, CONJUGATE_GRADIENT, LBFGS) runs each batch
        through `optimize.solvers.Solver`. When an exception leaves the
        loop, the producer thread of an `AsyncDataSetIterator` being
        iterated is stopped before it propagates."""
        self._ensure_init()
        line_search = (self.conf.global_conf.optimization_algo
                       != OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT)
        tbptt = self.conf.tbptt_fwd_length > 0
        if isinstance(data, (np.ndarray, torch.Tensor)):
            data = DataSet(data, labels)
        iterator = ListDataSetIterator([data]) if isinstance(data, DataSet) \
            else data

        def fit_one(ds):
            if line_search:
                self._fit_batch_solver(ds)
            elif tbptt and self._tbptt_applicable(ds):
                self._fit_tbptt(ds)
            else:
                self._fit_batch(ds)

        self._fit_epochs(iterator, epochs, fit_one)

    def _fit_batch_solver(self, ds: DataSet) -> None:
        """One batch through the line-search solver of
        `optimization_algo` (reference `Solver.java:58-68`); an attached
        sentinel sees the solver's final score, and a rejected
        (non-finite) candidate as a skip."""
        from deeplearning4j_tpu_torch.optimize.solvers import Solver

        self._validate_labels(ds)
        solver = Solver(self)
        final = solver.optimize(ds)
        self._last_batch = ds
        self.iteration += 1
        if self._sentinel is not None:
            self._sentinel.observe_host(
                self, final, committed=not solver.last_commit_rejected)
        self._notify(ds)

    def _validate_labels(self, ds: DataSet) -> None:
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            OneHotEncoder,
        )

        ranges = getattr(ds, "_value_ranges", {})
        if isinstance(self._normalizer, OneHotEncoder):
            # an out-of-range id must fail here, not on the device
            self._normalizer.check_ids(ds.features,
                                       value_range=ranges.get("features"))
        if ds.labels is None:
            raise ValueError("fit() requires labels; got DataSet with "
                             "labels=None (use pretrain() for unsupervised "
                             "layerwise training)")
        n_out = getattr(self.layers[-1], "n_out", None)
        labels = ds.labels
        sparse = (not labels.is_floating_point()
                  if isinstance(labels, torch.Tensor)
                  else np.issubdtype(np.asarray(labels).dtype, np.integer))
        if sparse:
            from deeplearning4j_tpu_torch.ops.losses import (
                check_sparse_label_range,
            )

            check_sparse_label_range(labels, n_out, mask=ds.labels_mask,
                                     value_range=ranges.get("labels"))
            return
        if n_out and labels.shape[-1] != n_out:
            raise ValueError(
                f"labels have width {labels.shape[-1]} but output layer "
                f"has n_out={n_out} (features shape "
                f"{tuple(ds.features.shape)}, labels shape "
                f"{tuple(labels.shape)})")

    # ------------------------------------------------------ truncated BPTT
    def _tbptt_applicable(self, ds) -> bool:
        """3-D sequences always; (B, T) integer ids only when the first
        layer consumes id sequences (not ids that a normalizer expands,
        which the JAX package does not window either)."""
        f = getattr(ds, "features", None)
        if f is None:
            return False
        nd = np.ndim(f)
        if nd == 3:
            return True
        l0 = self.layers[0]
        if not (nd == 2 and getattr(l0, "integer_input", False)
                and l0.input_kind == "rnn"):
            return False
        dt = f.dtype if hasattr(f, "dtype") else np.asarray(f).dtype
        return np.issubdtype(dt, np.integer)

    def _tbptt_windows(self, ds: DataSet) -> List[DataSet]:
        """Window batches of `tbptt_fwd_length` steps; a short tail
        window is padded to the full length and its padding masked."""
        sparse = (ds.labels is not None
                  and np.issubdtype(np.asarray(ds.labels).dtype, np.integer)
                  and np.asarray(ds.labels).ndim == 2)
        if ds.labels is None or (ds.labels.ndim != 3 and not sparse):
            raise ValueError(
                "truncated BPTT requires per-timestep labels: one-hot "
                "(batch, time, nOut) or sparse int (batch, time); got "
                f"labels shape "
                f"{None if ds.labels is None else ds.labels.shape}. For "
                "sequence-to-one models, train without tBPTT "
                "(t_bptt_forward_length unset)")
        fwd_len = self.conf.tbptt_fwd_length
        B, T = ds.features.shape[:2]
        n_windows = (T + fwd_len - 1) // fwd_len
        sl = lambda a, lo, hi: None if a is None else a[:, lo:hi]
        windows = []
        for w in range(n_windows):
            lo, hi = w * fwd_len, min((w + 1) * fwd_len, T)
            if hi - lo < fwd_len and n_windows > 1:
                pad = fwd_len - (hi - lo)

                def padded(a):
                    a = np.asarray(a)
                    return np.concatenate([a[:, lo:hi],
                                           np.zeros_like(a[:, :pad])], axis=1)

                m = np.concatenate([np.ones((B, hi - lo), np.float32),
                                    np.zeros((B, pad), np.float32)], axis=1)
                fmask = m if ds.features_mask is None \
                    else padded(ds.features_mask)
                lmask = m if ds.labels_mask is None \
                    else padded(ds.labels_mask)
                windows.append(DataSet(padded(ds.features),
                                       padded(ds.labels), fmask, lmask))
            else:
                windows.append(DataSet(
                    ds.features[:, lo:hi], ds.labels[:, lo:hi],
                    sl(ds.features_mask, lo, hi), sl(ds.labels_mask, lo, hi)))
        return windows

    def _check_sparse_labels(self, ds: DataSet) -> None:
        """Range-check sparse labels outside `fit` too: the loss clamps
        its gather, so an out-of-range id would give a finite, wrong
        score instead of an error."""
        if ds.labels is None:
            return
        from deeplearning4j_tpu_torch.ops.losses import (
            check_sparse_label_range,
        )

        check_sparse_label_range(ds.labels,
                                 getattr(self.layers[-1], "n_out", None),
                                 mask=ds.labels_mask)

    @torch.no_grad()
    def score_examples(self, ds: DataSet,
                       add_regularization: bool = False) -> torch.Tensor:
        """Per-example losses (B,), on the network's device: the forward
        (inference), then the output layer's per-row scores, summed over
        the (masked) timesteps of a sequence. With `add_regularization`
        the network's L1/L2 penalty is added to every example's score.
        For unmasked single-step data the mean equals `score(ds)` minus
        the penalty."""
        self._ensure_init()
        self._check_sparse_labels(ds)
        f, l, fm, lm = self._batch_arrays(ds)
        x = self._forward_pure(self._params, self._prep_features(f),
                               train=False, rng=None, fmask=fm,
                               upto=len(self.layers) - 1,
                               lstate=self._layer_state)[0]
        x = self._preprocess(len(self.layers) - 1, x)
        mask = lm if lm is not None else (fm if x.ndim == 3 else None)
        scores = self.layers[-1].score_array(self._params[-1], x, l,
                                             mask=mask)
        if add_regularization:
            scores = scores + regularization_score(
                zip(self.layers, self._params))
        return scores

    # --------------------------------------------------------- rnn support
    @torch.no_grad()
    def rnn_time_step(self, x) -> torch.Tensor:
        """Stateful streaming inference: one step ((B, F) features, (B,)
        ids) or several ((B, T, F), or (B, T) ids into an id-sequence
        first layer), carrying each GravesLSTM's (h, c) and the stream
        position between calls. Returns (B, n_out) or (B, T, n_out)."""
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            GravesBidirectionalLSTM,
            GravesLSTM,
            TokenEmbedding,
            TransformerBlock,
        )

        self._ensure_init()
        for i, layer in enumerate(self.layers):
            if isinstance(layer, GravesBidirectionalLSTM):
                raise ValueError(
                    f"rnn_time_step cannot stream through bidirectional "
                    f"LSTM layer {i} (the backward pass needs the full "
                    "sequence)")
            if isinstance(layer, TransformerBlock):
                raise ValueError(
                    f"rnn_time_step cannot stream through attention layer "
                    f"{i} — use models.transformer.generate (KV-cache "
                    "sampler)")
        mode = self._feature_wire_mode()
        xx = x if isinstance(x, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(np.asarray(x)))
        xx = xx.to(self.device)
        token_seq = mode == "sink" and self.layers[0].input_kind == "rnn"
        temporal = xx.ndim == 3 or (token_seq and xx.ndim == 2)
        T = xx.shape[1] if temporal else 1
        B = xx.shape[0]
        for i, layer in enumerate(self.layers):
            if type(layer) is GravesLSTM and i not in self._rnn_state:
                zero = torch.zeros((B, layer.n_out), dtype=self.dtype,
                                   device=self.device)
                self._rnn_state[i] = (zero, zero.clone())
        outs = []
        for t in range(T):
            h = self._prep_features(xx[:, t] if temporal else xx)
            pos = self._rnn_pos + t
            for i, layer in enumerate(self.layers):
                p = self._params[i]
                h = self._preprocess(i, h)
                if type(layer) is GravesLSTM:
                    h, self._rnn_state[i] = layer.step(p, h,
                                                       *self._rnn_state[i])
                    continue
                if isinstance(layer, TokenEmbedding):
                    idx = (h if h.ndim == 1 else h[:, 0]).long()
                    h = p["W"][idx]
                    if layer.positional:
                        h = h + p["P"][min(pos, layer.max_length - 1)]
                    continue
                if h.ndim == 1:
                    h = h[:, None]   # single-step ids -> one timestep
                elif h.ndim == 2 and layer.input_kind == "rnn" \
                        and not getattr(layer, "integer_input", False):
                    h = h[:, None, :]
                h, _ = run_layer(layer, p, self._layer_state[i], h, False,
                                 None)
                if h.ndim == 3 and h.shape[1] == 1:
                    h = h[:, 0]
            outs.append(h)
        self._rnn_pos += T
        out = torch.stack(outs, dim=1)
        return out if temporal else out[:, 0]

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}
        self._rnn_pos = 0

    def rnn_get_previous_state(self) -> Dict:
        """Each streaming LSTM layer's {"h", "c"} as numpy arrays, plus the
        stream position under the reserved key '__pos__'."""
        out: Dict = {i: {"h": h.cpu().numpy(), "c": c.cpu().numpy()}
                     for i, (h, c) in self._rnn_state.items()}
        out["__pos__"] = self._rnn_pos
        return out

    def rnn_set_previous_state(self, states: Dict) -> None:
        states = dict(states)
        self._rnn_pos = int(states.pop("__pos__", 0))
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(
            device=self.device, dtype=self.dtype)
        self._rnn_state = {int(i): (as_t(st["h"]), as_t(st["c"]))
                           for i, st in states.items()}

    # ------------------------------------------------------------ evaluate
    def evaluate(self, iterator, labels=None, top_n: int = 1):
        """Classification evaluation over a DataSet or an iterator: each
        batch's `output` (inference, on the network's device, read back
        to the host) accumulated into an `eval.evaluation.Evaluation`
        with the batch's labels and labels mask. `labels`: class names."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        ev = Evaluation(labels=labels, top_n=top_n)
        if isinstance(iterator, DataSet):
            iterator = ListDataSetIterator([iterator])
        for ds in iterator:
            ev.eval(ds.labels, self.output(ds.features), mask=ds.labels_mask)
        return ev

    # ------------------------------------------------------------ pretrain
    def pretrain(self, iterator, epochs: int = 1) -> None:
        """Greedy layerwise unsupervised pretraining of every layer that
        has a `pretrain_loss` (AutoEncoder, RBM, VariationalAutoencoder),
        in layer order: each for `epochs` passes over `iterator`, on its
        input through the frozen layers before it (with `fit`'s feature
        preparation: the wire dtype and the normalizer), with its own
        updater configuration and state."""
        self._ensure_init()
        if isinstance(iterator, DataSet):
            iterator = ListDataSetIterator([iterator])
        for i, layer in enumerate(self.layers):
            if not hasattr(layer, "pretrain_loss"):
                continue

            def layer_input(ds, i=i):
                x = self._prep_features(self._wire_features(ds.features))
                x = self._forward_pure(self._params, x, train=False, rng=None,
                                       upto=i, lstate=self._layer_state)[0]
                return self._preprocess(i, x)

            self._pretrain_layer(i, i, layer, iterator, epochs, layer_input)

    def clone(self) -> "MultiLayerNetwork":
        """A network of the same configuration with its own copies of the
        parameters, optimizer state and layer state, and the same
        iteration, epoch and score (the clock travels with the optimizer
        state); the normalizer is shared, listeners and the health
        sentinel are not copied."""
        net = MultiLayerNetwork(self.conf, self.dtype,
                                compute_dtype=self.compute_dtype,
                                device=self.device)
        self._copy_into(net)
        return net

    def summary(self) -> str:
        """The architecture as a table: each layer's index, type (marked
        "* " where an input preprocessor runs before it), input and
        output types and parameter count, and the total (the JAX
        package's text)."""
        from deeplearning4j_tpu_torch.util.text_table import format_table

        self._ensure_init()
        rows = [("idx", "layer", "in", "out", "params")]
        total = 0
        for i, layer in enumerate(self.layers):
            it_in = self._input_types[i]
            n = sum(v.numel() for v in self._params[i].values())
            total += n
            pre = "* " if i in self.conf.preprocessors else ""
            rows.append((str(i), pre + type(layer).__name__, str(it_in),
                         str(layer.output_type(it_in)), f"{n:,}"))
        return format_table(
            rows, f"total parameters: {total:,}"
            + ("  (* = input preprocessor applied)"
               if self.conf.preprocessors else ""))
