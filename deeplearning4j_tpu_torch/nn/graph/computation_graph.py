"""ComputationGraph: the DAG network container, several inputs and
outputs (counterpart of `deeplearning4j_tpu/nn/graph/computation_graph.py`).

The nodes run eagerly in the configuration's topological order; autograd
differentiates that forward, so there is no reverse-order backward code.
Parameters, optimizer state and layer state are dicts keyed by node name
(a vertex holds empty dicts), the JAX package's trees; their flat view
(`params()`, the checkpoint zip) follows `ravel_pytree`, which flattens a
dict in sorted key order: node names sorted, then parameter names
sorted. The training step, the finite guard, truncated BPTT's window
loop, the parameter and state loads and the gradient-check surfaces are
the list container's (`nn.multilayer.NetworkBase`). BatchNormalization's
running stats are threaded through the forward as layer state and
committed with the step. Mixed precision as in `MultiLayerNetwork`: the
nodes run in the compute dtype, except that an input whose values reach
an integer-id layer, through vertices too, is never cast; each output
layer's loss is taken in the parameter dtype from its input activation.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
from deeplearning4j_tpu_torch.nn.conf.computation_graph_configuration import (
    ComputationGraphConfiguration,
    DuplicateToTimeSeriesVertex,
    LastTimeStepVertex,
    PreprocessorVertex,
)
from deeplearning4j_tpu_torch.nn.conf.layers import fold_in
from deeplearning4j_tpu_torch.nn.multilayer import NetworkBase, run_layer
from deeplearning4j_tpu_torch.nn.updater import (
    init_updater_state,
    regularization_score,
)

Params = Dict[str, Dict[str, torch.Tensor]]
LState = Dict[str, Dict[str, torch.Tensor]]


class ComputationGraph(NetworkBase):
    def __init__(self, conf: ComputationGraphConfiguration,
                 dtype=torch.float32,
                 compute_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        """`dtype` is the parameter (master) dtype; `compute_dtype`
        (e.g. torch.bfloat16) the dtype the forward and backward run in.
        `device` defaults to the card and raises when there is none; pass
        "cpu" to run on the CPU."""
        super().__init__(conf, dtype, compute_dtype, device)
        if not conf.resolved_types:
            conf._resolve_types()
        consumed = {i for n in conf.nodes.values() for i in n.inputs}
        # outputs no other node reads: the loss needs only their inputs
        self._loss_skip = frozenset(o for o in conf.network_outputs
                                    if o not in consumed)
        # names whose values reach an integer-id layer (never cast), and
        # the inputs whose (B, T) ids are a time sequence: they reach a
        # sequence-id layer (TokenEmbedding), unlike a feed-forward
        # EmbeddingLayer's (B, K) ids
        self._int_sinks = self._reaching(
            lambda layer: getattr(layer, "integer_input", False))
        self._temporal_tokens = self._reaching(
            lambda layer: getattr(layer, "integer_input", False)
            and layer.input_kind == "rnn") & set(conf.network_inputs)

    def _layer_slots(self):
        nodes = self.conf.nodes
        return [(n, nodes[n].layer) for n in self.conf.topological_order
                if nodes[n].is_layer]

    # ------------------------------------------------------------------ init
    def _layer_input_type(self, name: str):
        node = self.conf.nodes[name]
        it = self.conf.resolved_types.get(node.inputs[0]) \
            if node.inputs else None
        if node.preprocessor is not None and it is not None:
            it = node.preprocessor.output_type(it)
        return it

    def init(self) -> None:
        """Draw every layer node's parameters, in topological order, from
        one generator seeded with the configuration's seed on the
        network's device; zero the optimizer state; each layer's state
        from its `init_state`."""
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        params: Params = {}
        upd: Dict = {}
        lstate: LState = {}
        for name in self.conf.topological_order:
            node = self.conf.nodes[name]
            if not node.is_layer:
                params[name], upd[name], lstate[name] = {}, {}, {}
                continue
            layer, it = node.layer, self._layer_input_type(name)
            p = layer.init_params(gen, it, self.dtype) \
                if layer.has_params else {}
            params[name] = p
            cfg = layer.updater_cfg
            upd[name] = {k: init_updater_state(cfg, v)
                         for k, v in p.items()} if cfg else {}
            lstate[name] = layer.init_state(it, self.device)
        self._params, self._upd_state, self._layer_state = \
            params, upd, lstate

    # ------------------------------------------------------- normalization
    def set_normalizer(self, normalizer) -> None:
        """Attach a normalizer run on the device before the nodes: one
        normalizer for every input that does not feed an integer-id
        layer, or a list with one entry per network input (None leaves an
        input alone)."""
        inputs = self.conf.network_inputs
        many = isinstance(normalizer, (list, tuple))
        if many and len(normalizer) != len(inputs):
            raise ValueError(
                f"normalizer list has {len(normalizer)} entries but graph "
                f"has {len(inputs)} inputs ({inputs}); pass one entry per "
                "input (None to leave an input alone)")
        for n in (normalizer if many else [normalizer]):
            if n is not None:
                n.check_device_attachable()
        if many:
            for name, n in zip(inputs, normalizer):
                if n is not None and name in self._int_sinks:
                    raise ValueError(
                        f"input {name!r} feeds an integer-id layer; ids are "
                        "never scaled — pass None for this input")
        self._normalizer = normalizer

    def _reaching(self, pred) -> set:
        """Names (network inputs among them) whose values reach a layer
        for which `pred(layer)` holds, directly or through vertices."""
        nodes = self.conf.nodes
        out = set()
        for node in nodes.values():
            if node.is_layer and pred(node.layer):
                out.update(node.inputs)
        changed = True
        while changed:
            changed = False
            for name, node in nodes.items():
                if name in out and not node.is_layer:
                    new = set(node.inputs) - out
                    if new:
                        out.update(new)
                        changed = True
        return out

    def _temporal_feature_flags(self, features) -> List[bool]:
        """Per input: does it carry a time axis? 3-D always; (B, T)
        integer ids when they feed a sequence-id layer."""
        return [np.ndim(f) == 3 or (np.ndim(f) == 2
                                    and name in self._temporal_tokens)
                for name, f in zip(self.conf.network_inputs, features)]

    def _normalizers(self) -> List:
        norms = self._normalizer
        if norms is None or isinstance(norms, (list, tuple)):
            return list(norms or [None] * len(self.conf.network_inputs))
        return [norms] * len(self.conf.network_inputs)

    def _input_wire_modes(self) -> List[str]:
        """Per input: 'sink' (ids pass straight to an integer-id layer),
        'ids' (an id-consuming normalizer expands raw ids) or 'float'
        (cast to the model dtype, then the normalizer)."""
        modes = []
        for name, n in zip(self.conf.network_inputs, self._normalizers()):
            if name in self._int_sinks:
                modes.append("sink")
            elif n is not None and n.consumes_integer_ids:
                modes.append("ids")
            else:
                modes.append("float")
        return modes

    def _inputs_are_ids(self) -> List[bool]:
        return [m != "float" for m in self._input_wire_modes()]

    def _prep_inputs(self, inputs):
        """`MultiLayerNetwork._prep_features` for each input."""
        out = []
        for mode, n, x in zip(self._input_wire_modes(), self._normalizers(),
                              inputs):
            if mode == "sink":
                out.append(x)
                continue
            if mode == "ids":
                x = n.device_transform(x.to(torch.int32))
                out.append(x if x.dtype == self.dtype else x.to(self.dtype))
                continue
            if x.dtype != self.dtype:
                x = x.to(self.dtype)
            if n is not None:
                x = n.device_transform(x)
            out.append(x)
        return tuple(out)

    # ------------------------------------------------------------- forward
    def _forward_pure(self, params: Params, inputs: Sequence[torch.Tensor],
                      *, train: bool, rng, fmasks=None,
                      lstate: Optional[LState] = None,
                      skip=frozenset(), upto: Optional[int] = None):
        """The nodes in topological order (the first `upto`; those in
        `skip` left out): (activations by name, new layer state). Layer
        node i draws its dropout from `fold_in(rng, i)`; a node's mask is
        the first mask among its inputs', kept while its output is 3-D."""
        conf = self.conf
        acts: Dict[str, torch.Tensor] = dict(zip(conf.network_inputs, inputs))
        masks: Dict[str, Optional[torch.Tensor]] = {}
        if fmasks is not None:
            masks.update(zip(conf.network_inputs, fmasks))
        new_state = dict(lstate) if lstate is not None \
            else {n: {} for n in conf.nodes}
        order = conf.topological_order
        for li, name in enumerate(order if upto is None else order[:upto]):
            if name in skip:
                continue
            node = conf.nodes[name]
            in_acts = [acts[i] for i in node.inputs]
            in_mask = next((masks[i] for i in node.inputs
                            if masks.get(i) is not None), None)
            v = node.vertex
            if node.is_layer:
                lrng = fold_in(rng, li)
                x = in_acts[0]
                if node.preprocessor is not None:
                    x = node.preprocessor.preprocess(x, rng=lrng, train=train)
                acts[name], new_state[name] = run_layer(
                    node.layer, params[name], new_state[name], x, train, lrng,
                    in_mask if x.ndim == 3 else None)
            elif isinstance(v, PreprocessorVertex):
                acts[name] = v.forward(in_acts, rng=fold_in(rng, li),
                                       train=train)
            elif isinstance(v, LastTimeStepVertex):
                m = masks.get(v.mask_input) if v.mask_input else in_mask
                acts[name] = v.forward(in_acts, mask=m)
            elif isinstance(v, DuplicateToTimeSeriesVertex):
                ref = acts.get(v.reference_input)
                acts[name] = v.forward(
                    in_acts, length=ref.shape[1]
                    if ref is not None and ref.ndim == 3 else None)
                masks[name] = masks.get(v.reference_input)
                continue
            else:
                acts[name] = v.forward(in_acts)
            masks[name] = in_mask if acts[name].ndim == 3 else None
        return acts, new_state

    def _loss_pure(self, params: Params, inputs, labels, fmasks, lmasks, rng,
                   train: bool = True, lstate: Optional[LState] = None):
        """(the output layers' losses + L1/L2 + the aux-loss terms, new
        layer state). Each output layer's loss is computed from its input
        activation in the parameter dtype, its preprocessor drawing from
        the same rng as in the forward."""
        from deeplearning4j_tpu_torch.nn.precision import tree_cast
        from deeplearning4j_tpu_torch.ops.aux_loss import aux_loss_scope
        from deeplearning4j_tpu_torch.ops.losses import (
            add_penalties,
            weigh_share,
        )

        conf = self.conf
        params_in = params
        inputs = self._prep_inputs(inputs)
        cd = self.compute_dtype
        if cd is not None:
            params = {n: tree_cast(p, cd) for n, p in params.items()}
            inputs = tuple(x if name in self._int_sinks else x.to(cd)
                           for name, x in zip(conf.network_inputs, inputs))
        with aux_loss_scope() as aux_terms:
            acts, new_state = self._forward_pure(
                params, inputs, train=train, rng=rng, fmasks=fmasks,
                lstate=lstate, skip=self._loss_skip)
        if cd is not None and lstate is not None:
            new_state = {n: {k: v.to(lstate[n][k].dtype)
                             for k, v in st.items()}
                         for n, st in new_state.items()}
        total = 0.0
        for oi, oname in enumerate(conf.network_outputs):
            node = conf.nodes[oname]
            if not (node.is_layer and hasattr(node.layer, "loss_score")):
                raise ValueError(f"output vertex {oname!r} is not a "
                                 "loss-bearing output layer")
            x = acts[node.inputs[0]]
            if cd is not None:
                x = x.to(self.dtype)
            lrng = fold_in(rng, conf.topological_order.index(oname))
            if node.preprocessor is not None:
                x = node.preprocessor.preprocess(x, rng=lrng, train=train)
            total = total + node.layer.loss_score(
                params_in[oname], x, labels[oi], train=train, rng=lrng,
                mask=lmasks[oi] if lmasks is not None else None)
        total = add_penalties(total, self._reg_score(params_in))
        for term in aux_terms:  # mid-network losses (MoE load balancing)
            total = total + term
        return weigh_share(total), new_state

    def _reg_score(self, params: Params):
        return regularization_score(
            (node.layer, params[name])
            for name, node in self.conf.nodes.items() if node.is_layer)

    # ----------------------------------------------------------------- data
    @staticmethod
    def _to_mds(ds: Union[DataSet, MultiDataSet]) -> MultiDataSet:
        if isinstance(ds, MultiDataSet):
            return ds
        mds = MultiDataSet(
            features=[ds.features], labels=[ds.labels],
            features_masks=[ds.features_mask]
            if ds.features_mask is not None else None,
            labels_masks=[ds.labels_mask]
            if ds.labels_mask is not None else None)
        r = getattr(ds, "_value_ranges", None)
        if r is not None:
            mds._value_ranges = {"features": [r.get("features")],
                                 "labels": [r.get("labels")]}
        return mds

    def _mds_arrays(self, mds: MultiDataSet):
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        dt, dev = self.dtype, self.device
        inputs = tuple(wire_asarray(f, dt, dev, ids)
                       for f, ids in zip(mds.features, self._inputs_are_ids()))
        labels = tuple(None if l is None else wire_asarray(l, dt, dev)
                       for l in mds.labels)
        masks = lambda ms: None if ms is None else tuple(
            None if m is None else wire_asarray(m, dt, dev) for m in ms)
        return inputs, labels, masks(mds.features_masks), \
            masks(mds.labels_masks)

    def _batch_arrays(self, ds):
        """(inputs, labels, feature masks, label masks) tuples on the
        device."""
        return self._mds_arrays(self._to_mds(ds))

    def _validate_labels(self, ds) -> None:
        from deeplearning4j_tpu_torch.datasets.normalizers import (
            OneHotEncoder,
        )

        mds = self._to_mds(ds)
        outputs = self.conf.network_outputs
        if len(mds.labels) != len(outputs):
            raise ValueError(f"got {len(mds.labels)} label arrays but graph "
                             f"has {len(outputs)} outputs ({outputs})")
        if any(l is None for l in mds.labels):
            raise ValueError("fit() requires labels for every output (use "
                             "pretrain() for unsupervised layerwise "
                             "training)")
        f_ranges = getattr(mds, "_value_ranges", {}).get("features") \
            or [None] * len(mds.features)
        for name, n, f, fr in zip(self.conf.network_inputs,
                                  self._normalizers(), mds.features,
                                  f_ranges):
            # ids that reach an integer-id layer are never encoded
            if isinstance(n, OneHotEncoder) and name not in self._int_sinks:
                n.check_ids(f, value_range=fr)
        self._check_sparse_labels(mds)

    def _check_sparse_labels(self, ds) -> None:
        """Range-check sparse labels outside `fit` too: the loss clamps
        its gather, so an out-of-range id would score finite but wrong."""
        from deeplearning4j_tpu_torch.ops.losses import (
            check_sparse_label_range,
        )

        mds = self._to_mds(ds)
        lmasks = mds.labels_masks or [None] * len(mds.labels)
        l_ranges = getattr(mds, "_value_ranges", {}).get("labels") \
            or [None] * len(mds.labels)
        for oname, l, lm, lr in zip(self.conf.network_outputs, mds.labels,
                                    lmasks, l_ranges):
            if l is not None:
                check_sparse_label_range(
                    l, getattr(self.conf.nodes[oname].layer, "n_out", None),
                    mask=lm, where=f"output {oname!r}", value_range=lr)

    # ----------------------------------------------------------------- fit
    def fit(self, data, epochs: int = 1, scan_steps: int = 1) -> None:
        """Train on a DataSet, a MultiDataSet or an iterator of either,
        for `epochs` passes. `scan_steps` is accepted for the JAX
        package's signature: its batches run one step each, which gives
        the same results. With `t_bptt_forward_length` set, a batch with
        a temporal input trains by truncated BPTT."""
        self._ensure_init()
        iterator = ListDataSetIterator([data]) \
            if isinstance(data, (DataSet, MultiDataSet)) else data
        tbptt = self.conf.tbptt_fwd_length > 0

        def fit_one(ds):
            mds = self._to_mds(ds)
            if tbptt and self._tbptt_applicable(mds):
                self._fit_tbptt(mds)
            else:
                self._fit_batch(mds)

        self._fit_epochs(iterator, epochs, fit_one)

    # ------------------------------------------------------------- tBPTT
    def _tbptt_applicable(self, ds) -> bool:
        return any(self._temporal_feature_flags(self._to_mds(ds).features))

    def _tbptt_windows(self, ds) -> List[MultiDataSet]:
        """Windows of `tbptt_fwd_length` steps over every temporal input
        and per-step label (a static input rides every window); a short
        tail window is padded to the full length and its padding masked."""
        mds = self._to_mds(ds)
        fwd_len = self.conf.tbptt_fwd_length
        tflags = self._temporal_feature_flags(mds.features)
        t_lens = {np.asarray(f).shape[1]
                  for f, tf in zip(mds.features, tflags) if tf}
        if len(t_lens) != 1:
            raise ValueError(
                "truncated BPTT requires all temporal inputs to share "
                f"one sequence length; got lengths {sorted(t_lens)}")
        T = t_lens.pop()
        B = mds.num_examples()
        for o, l in zip(self.conf.network_outputs, mds.labels):
            arr = np.asarray(l)
            sparse = np.issubdtype(arr.dtype, np.integer) and arr.ndim == 2
            if arr.ndim != 3 and not sparse:
                raise ValueError(
                    f"truncated BPTT requires per-timestep labels for output "
                    f"{o!r}: one-hot (batch, time, nOut) or sparse int "
                    f"(batch, time); got shape {arr.shape}")

        def slice_time(a, lo, hi, pad, temporal):
            a = np.asarray(a)
            if not temporal:
                return a
            w = a[:, lo:hi]
            if pad:
                w = np.concatenate([w, np.zeros_like(a[:, :pad])], axis=1)
            return w

        def label_temporal(l):
            arr = np.asarray(l)
            return arr.ndim == 3 or (arr.ndim == 2
                                     and np.issubdtype(arr.dtype, np.integer))

        n_windows = (T + fwd_len - 1) // fwd_len
        fmasks = mds.features_masks or [None] * len(mds.features)
        lmasks = mds.labels_masks or [None] * len(mds.labels)
        windows = []
        for w in range(n_windows):
            lo, hi = w * fwd_len, min((w + 1) * fwd_len, T)
            pad = fwd_len - (hi - lo) \
                if (hi - lo < fwd_len and n_windows > 1) else 0
            win_m = np.concatenate(
                [np.ones((B, hi - lo), np.float32),
                 np.zeros((B, pad), np.float32)], axis=1) if pad else None

            def wmask(m):
                if m is None:
                    return win_m
                sliced = slice_time(m, lo, hi, 0, temporal=True)
                if pad:
                    sliced = np.concatenate(
                        [sliced, np.zeros((B, pad), np.float32)], axis=1)
                return sliced

            windows.append(MultiDataSet(
                features=[slice_time(f, lo, hi, pad, tf)
                          for f, tf in zip(mds.features, tflags)],
                labels=[slice_time(l, lo, hi, pad, label_temporal(l))
                        for l in mds.labels],
                features_masks=([wmask(m) for m in fmasks]
                                if pad or mds.features_masks else None),
                labels_masks=([wmask(m) for m in lmasks]
                              if pad or mds.labels_masks else None)))
        return windows

    # --------------------------------------------------------- rnn support
    def _check_streamable(self) -> None:
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            GravesBidirectionalLSTM,
            TransformerBlock,
        )

        for name, layer in self._layer_slots():
            if isinstance(layer, GravesBidirectionalLSTM):
                raise ValueError(
                    f"rnn_time_step cannot stream through bidirectional "
                    f"LSTM node {name!r} (the backward pass needs the full "
                    "sequence)")
            if isinstance(layer, TransformerBlock):
                raise ValueError(
                    f"rnn_time_step cannot stream through attention node "
                    f"{name!r} — use models.transformer.generate (KV-cache "
                    "sampler)")

    @torch.no_grad()
    def rnn_time_step(self, *inputs) -> List[torch.Tensor]:
        """Stateful streaming inference over the DAG: each GravesLSTM
        node's (h, c) and the stream position carried between calls.
        Inputs are (B, F) single steps or (B, T, F) chunks ((B, T) ids
        into a sequence-id layer); each output is 2-D when no input was
        temporal, else (B, T, n_out); on the network's device."""
        from deeplearning4j_tpu_torch.nn.conf.layers import (
            GravesLSTM,
            TokenEmbedding,
        )
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        self._ensure_init()
        self._check_streamable()
        conf = self.conf
        xs = [wire_asarray(x, self.dtype, self.device, ids)
              for x, ids in zip(inputs, self._inputs_are_ids())]
        tflags = self._temporal_feature_flags(xs)
        squeeze = not any(tflags)
        T = 1 if squeeze else max(x.shape[1]
                                  for x, tf in zip(xs, tflags) if tf)
        B = xs[0].shape[0]
        for name, layer in self._layer_slots():
            if type(layer) is GravesLSTM and name not in self._rnn_state:
                zero = torch.zeros((B, layer.n_out), dtype=self.dtype,
                                   device=self.device)
                self._rnn_state[name] = (zero, zero.clone())
        outs_t = []
        for t in range(T):
            acts = dict(zip(conf.network_inputs, self._prep_inputs(
                [x[:, t] if tf else x for x, tf in zip(xs, tflags)])))
            pos = self._rnn_pos + t
            for name in conf.topological_order:
                node = conf.nodes[name]
                in_acts = [acts[i] for i in node.inputs]
                if not node.is_layer:
                    v = node.vertex
                    if isinstance(v, (LastTimeStepVertex,
                                      DuplicateToTimeSeriesVertex)) \
                            and in_acts[0].ndim == 2:
                        acts[name] = in_acts[0]  # one step: the identity
                    else:
                        acts[name] = v.forward(in_acts)
                    continue
                layer, p = node.layer, self._params[name]
                x = in_acts[0]
                if node.preprocessor is not None:
                    x = node.preprocessor.preprocess(x)
                if type(layer) is GravesLSTM:
                    acts[name], self._rnn_state[name] = layer.step(
                        p, x, *self._rnn_state[name])
                    continue
                if isinstance(layer, TokenEmbedding):
                    idx = (x if x.ndim == 1 else x[:, 0]).long()
                    h = p["W"][idx]
                    if layer.positional:
                        h = h + p["P"][min(pos, layer.max_length - 1)]
                    acts[name] = h
                    continue
                if x.ndim == 1:
                    x = x[:, None]  # single-step ids -> one timestep
                elif x.ndim == 2 and layer.input_kind == "rnn" \
                        and not getattr(layer, "integer_input", False):
                    x = x[:, None, :]
                y, _ = run_layer(layer, p, self._layer_state[name], x, False,
                                 None)
                acts[name] = y[:, 0] if y.ndim == 3 and y.shape[1] == 1 \
                    else y
            outs_t.append([acts[o] for o in conf.network_outputs])
        self._rnn_pos += T
        out = []
        for oi in range(len(conf.network_outputs)):
            stacked = torch.stack([o[oi] for o in outs_t], dim=1)
            out.append(stacked[:, 0] if squeeze else stacked)
        return out

    def rnn_clear_previous_state(self) -> None:
        self._rnn_state = {}
        self._rnn_pos = 0

    def rnn_get_previous_state(self) -> Dict:
        """Each streaming LSTM node's {"h", "c"} as numpy arrays, plus
        the stream position under the reserved key '__pos__'."""
        out: Dict = {name: {"h": h.cpu().numpy(), "c": c.cpu().numpy()}
                     for name, (h, c) in self._rnn_state.items()}
        out["__pos__"] = self._rnn_pos
        return out

    def rnn_set_previous_state(self, states: Dict) -> None:
        states = dict(states)
        self._rnn_pos = int(states.pop("__pos__", 0))
        as_t = lambda a: torch.as_tensor(np.asarray(a)).to(
            device=self.device, dtype=self.dtype)
        self._rnn_state = {name: (as_t(st["h"]), as_t(st["c"]))
                           for name, st in states.items()}

    # ------------------------------------------------------------ pretrain
    def pretrain(self, iterator, epochs: int = 1) -> None:
        """Greedy layerwise unsupervised pretraining of every layer node
        that has a `pretrain_loss`, in topological order: each on its
        input through the frozen nodes before it. Node i of the
        topological order draws from the stream of the list container's
        layer i, so a linear-chain graph pretrains as the list container
        does."""
        self._ensure_init()
        if isinstance(iterator, (DataSet, MultiDataSet)):
            iterator = ListDataSetIterator([iterator])
        for li, name in enumerate(self.conf.topological_order):
            node = self.conf.nodes[name]
            if not (node.is_layer and hasattr(node.layer, "pretrain_loss")):
                continue

            def layer_input(ds, li=li, node=node):
                inputs = self._prep_inputs(self._batch_arrays(ds)[0])
                acts, _ = self._forward_pure(self._params, inputs,
                                             train=False, rng=None,
                                             lstate=self._layer_state,
                                             upto=li)
                x = acts[node.inputs[0]]
                return x if node.preprocessor is None \
                    else node.preprocessor.preprocess(x)

            self._pretrain_layer(name, li, node.layer, iterator, epochs,
                                 layer_input)

    # ------------------------------------------------------------ inference
    @torch.no_grad()
    def output(self, *inputs, train: bool = False) -> List[torch.Tensor]:
        """The network's outputs for `inputs` (one array per network
        input), on the network's device. `train=True` runs the layers'
        train-mode forward, with dropout drawn from the current
        iteration."""
        from deeplearning4j_tpu_torch.nn.precision import wire_asarray

        self._ensure_init()
        xs = self._prep_inputs([wire_asarray(x, self.dtype, self.device, ids)
                                for x, ids in zip(inputs,
                                                  self._inputs_are_ids())])
        rng = (self.conf.seed, self.iteration) if train else None
        acts, _ = self._forward_pure(self._params, xs, train=train, rng=rng,
                                     lstate=self._layer_state)
        return [acts[o] for o in self.conf.network_outputs]

    def evaluate(self, iterator, labels=None, top_n: int = 1):
        """Classification evaluation of the first output over a DataSet,
        a MultiDataSet or an iterator of either."""
        from deeplearning4j_tpu_torch.eval.evaluation import Evaluation

        ev = Evaluation(labels=labels, top_n=top_n)
        if isinstance(iterator, (DataSet, MultiDataSet)):
            iterator = ListDataSetIterator([iterator])
        for ds in iterator:
            mds = self._to_mds(ds)
            lmask = mds.labels_masks[0] \
                if mds.labels_masks is not None else None
            ev.eval(mds.labels[0], self.output(*mds.features)[0], mask=lmask)
        return ev

    # ------------------------------------------------------------- helpers
    def summary(self) -> str:
        """The vertex table in topological order: name, kind (the layer
        or vertex class), inputs, resolved output type and parameter
        count, and the total (the JAX package's text)."""
        from deeplearning4j_tpu_torch.util.text_table import format_table

        self._ensure_init()
        conf = self.conf
        rows = [("vertex", "kind", "inputs", "out", "params")]
        total = 0
        for name in conf.topological_order:
            node = conf.nodes[name]
            kind = type(node.layer if node.is_layer else node.vertex).__name__
            n = sum(v.numel() for v in self._params.get(name, {}).values())
            total += n
            rows.append((name, kind, ",".join(node.inputs or ["(input)"]),
                         str(conf.resolved_types.get(name)), f"{n:,}"))
        return format_table(rows, f"total parameters: {total:,}")

    def clone(self) -> "ComputationGraph":
        """A graph of the same configuration with its own copies of the
        parameters, optimizer state and layer state, and the same
        iteration, epoch and score; the normalizer is shared, listeners
        and the health sentinel are not copied."""
        net = ComputationGraph(self.conf, self.dtype,
                               compute_dtype=self.compute_dtype,
                               device=self.device)
        self._copy_into(net)
        return net
