"""PipelineParallelWrapper: GPipe pipeline training of a network
(counterpart of `deeplearning4j_tpu/parallel/pipeline_wrapper.py`).

The network's layer stack is partitioned into stages, one per slot of
the mesh's `pipe` axis, and microbatches flow stage to stage through
`parallel.pipeline.pipeline_apply`; one `backward()` through it runs the
reverse pipeline.

Partitioning: `find_trunk` finds the longest contiguous run of
config-identical, shape-preserving, stateless layers (the transformer or
MLP trunk), gives `run_len // S` consecutive layers to each of the S
stages, and keeps the layers before it (head: embeddings,
preprocessors) and after it (tail: the output head) replicated. The
wrapper owns the stage parameters stacked on a leading axis, and the
updater (elementwise) runs on the stacked trees as they are; the norm-
based gradient normalizations, whose per-layer norm would span every
stacked stage, are refused.

Dropout keeps single-device parity: each stage keys its layers by their
true index (`trunk_start + stage * k + j`), and the whole step runs in
`ops.rng_rows.row_offset_scope` (the head and tail at offset 0, each
microbatch at its first global row), so every dropout site draws the
per-global-row masks the whole batch gets on one device under
`row_offset_scope(0)`. (The JAX wrapper draws the head's and tail's
masks in one bulk draw outside any scope, which its own same-seed
dropout test, `tests/test_pipeline_wrapper.py:308`, does not match.)

`model_axis` (dp x tp x pp in one mesh): in the JAX package XLA's
partitioner owns that axis inside each stage, and the step it computes
is the unsplit stage. The port checks the axes as the JAX wrapper does
and computes that unsplit stage: the slots along the model axis hold
replicas of their stage.

Refused, with the JAX package's wording: BatchNormalization (stateful)
and MoE trunks, masked batches, truncated BPTT, a `ComputationGraph`,
and a batch that does not split into microbatches x data shards (it is
trimmed, or dropped when smaller).
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple, Union

import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import (
    AsyncDataSetIterator,
    DataSetIterator,
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn.conf.layers import fold_in
from deeplearning4j_tpu_torch.nn.updater import (
    GradientNormalization,
    apply_layer_update,
    regularization_score,
)
from deeplearning4j_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from deeplearning4j_tpu_torch.parallel.spmd import P

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _layer_signature(net, i):
    """Homogeneity key: the same layer config, the same param shapes,
    and a layer that maps its input type to itself."""
    layer = net.layers[i]
    it_in = net._input_types[i]
    it_out = layer.output_type(it_in)
    p = net._params[i]
    shapes = tuple(sorted((k, tuple(v.shape)) for k, v in p.items()))
    return (layer, shapes, repr(it_in), repr(it_out),
            repr(it_in) == repr(it_out))


def find_trunk(net, n_stages: int) -> Tuple[int, int]:
    """Longest contiguous run of pipeline-able identical layers, trimmed
    to a multiple of `n_stages`: (start, end) layer indices, end
    exclusive. Raises with a diagnosis when nothing qualifies."""
    n = len(net.layers)
    best = (0, 0)
    i = 0
    while i < n - 1:  # the output layer never joins the trunk
        if not _pipelineable(net, i):
            i += 1
            continue
        sig0 = _layer_signature(net, i)
        j = i
        while (j < n - 1 and _pipelineable(net, j)
               and _signature_matches(sig0, _layer_signature(net, j))):
            j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    start, end = best
    usable = ((end - start) // n_stages) * n_stages
    if usable < n_stages:
        raise ValueError(
            f"no pipeline-able trunk: need >= {n_stages} contiguous "
            "identical stateless shape-preserving layers (found a best run "
            f"of {end - start}). BatchNormalization/MoE layers cannot join "
            "a pipeline stage (see the module docstring for the math); "
            "use ParallelWrapper (dp/tp) for such nets")
    return start, start + usable


def _signature_matches(a, b) -> bool:
    la, sa, ia, oa, pa = a
    lb, sb, ib, ob, pb = b
    return la == lb and sa == sb and ia == ib and pa and pb


def _pipelineable(net, i) -> bool:
    layer = net.layers[i]
    if i in net.conf.preprocessors or not layer.has_params:
        return False
    if net._layer_state[i]:  # stateful (BN running stats, LSTM carries)
        return False
    if getattr(layer, "moe_experts", 0):  # aux-loss side channel
        return False
    return _layer_signature(net, i)[4]  # shape-preserving


_NORM_KINDS = frozenset({
    GradientNormalization.RENORMALIZE_L2_PER_LAYER,
    GradientNormalization.RENORMALIZE_L2_PER_PARAM_TYPE,
    GradientNormalization.CLIP_L2_PER_LAYER,
    GradientNormalization.CLIP_L2_PER_PARAM_TYPE})


def _own(tree):
    """A copy of a tree of dicts of tensors with storage of its own."""
    if isinstance(tree, dict):
        return {k: _own(v) for k, v in tree.items()}
    return tree.detach().clone()


def _leaves(tree):
    """The tensors of a list of {name: tensor} dicts, in order."""
    return [t for p in tree for t in p.values()]


class PipelineParallelWrapper:
    """Usage:

        pw = PipelineParallelWrapper(net, mesh)   # mesh axis 'pipe'
        pw.fit(iterator, epochs=...)
        # the trained params are written back into `net` after each fit,
        # so net.evaluate() and serialization see them
    """

    def __init__(self, net, mesh=None, pipe_axis: str = "pipe",
                 microbatches: Optional[int] = None,
                 data_axis: Optional[str] = None,
                 model_axis: Optional[str] = None,
                 model_specs: Optional[dict] = None,
                 prefetch_buffer: int = 2):
        """`data_axis`: dp x pp, a mesh with both axes; each microbatch's
        rows split over `data`. `model_axis`: dp x tp x pp; the stage
        computes the unsplit stage (module docstring). `model_specs` maps
        trunk param names to specs without the stage dim; derived
        Megatron-style for a TransformerBlock trunk when omitted."""
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

        if not hasattr(net, "layers"):
            raise ValueError(
                "PipelineParallelWrapper takes a MultiLayerNetwork (a "
                "linear layer stack to partition into stages); for a "
                "ComputationGraph express the trunk as an MLN or use "
                "ParallelWrapper (dp/tp), which supports both containers")
        net._ensure_init()
        if net.conf.tbptt_fwd_length > 0:
            raise ValueError("pipeline parallelism does not support tBPTT; "
                             "use ParallelWrapper for recurrent nets")
        self.net = net
        self.mesh = mesh if mesh is not None else make_mesh({pipe_axis: -1})
        if pipe_axis not in self.mesh.shape:
            raise ValueError(f"mesh has no '{pipe_axis}' axis: "
                             f"{dict(self.mesh.shape)}")
        if data_axis is not None and data_axis not in self.mesh.shape:
            raise ValueError(f"mesh has no '{data_axis}' axis: "
                             f"{dict(self.mesh.shape)}")
        if data_axis == pipe_axis:
            raise ValueError("data_axis must differ from pipe_axis "
                             f"({pipe_axis!r})")
        if model_axis is not None:
            if model_axis not in self.mesh.shape:
                raise ValueError(f"mesh has no '{model_axis}' axis: "
                                 f"{dict(self.mesh.shape)}")
            if model_axis in (pipe_axis, data_axis):
                raise ValueError(
                    f"model_axis {model_axis!r} must differ from the pipe "
                    f"and data axes")
        self.pipe_axis = pipe_axis
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.n_data = 1 if data_axis is None else self.mesh.shape[data_axis]
        self.n_stages = self.mesh.shape[pipe_axis]
        self.microbatches = microbatches or self.n_stages
        self.prefetch_buffer = prefetch_buffer

        self.trunk_start, self.trunk_end = find_trunk(net, self.n_stages)
        for i in range(self.trunk_start, self.trunk_end):
            cfg = net.layers[i].updater_cfg
            gn = getattr(cfg, "gradient_normalization", None)
            if gn in _NORM_KINDS:
                raise ValueError(
                    f"pipeline stages cannot use norm-based gradient "
                    f"normalization ({gn.value}): the norm would be "
                    "computed across all stacked stages instead of per "
                    "layer; use elementwise clipping or ParallelWrapper")
        self.layers_per_stage = (self.trunk_end
                                 - self.trunk_start) // self.n_stages
        logger.info(
            "pipeline: layers [%d, %d) -> %d stages x %d layers; head=%d "
            "tail=%d layers replicated", self.trunk_start, self.trunk_end,
            self.n_stages, self.layers_per_stage, self.trunk_start,
            len(net.layers) - self.trunk_end)
        if model_axis is None:
            self._model_specs = {}
        elif model_specs is not None:
            self._model_specs = dict(model_specs)
        else:
            self._model_specs = self._derive_model_specs()
        self._check_model_specs()
        self._split_from_net()

    def _derive_model_specs(self) -> dict:
        """Megatron-style specs for the trunk's param names: the
        up-projections by columns, the down-projections by rows."""
        from deeplearning4j_tpu_torch.nn.conf.layers import TransformerBlock

        ax = self.model_axis
        layer = self.net.layers[self.trunk_start]
        if isinstance(layer, TransformerBlock):
            return {"Wqkv": P(None, ax), "bqkv": P(ax), "Wo": P(ax, None),
                    "W1": P(None, ax), "b1": P(ax), "W3": P(None, ax),
                    "W2": P(ax, None)}
        return {"W": P(None, ax), "b": P(ax)}

    def _check_model_specs(self) -> None:
        """Every named axis is a mesh axis (the JAX wrapper's check; the
        stage computes the unsplit math, so a spec that does not divide
        changes nothing here)."""
        for name, spec in self._model_specs.items():
            for part in tuple(spec):
                for ax in ((part,) if isinstance(part, str)
                           else tuple(part or ())):
                    if ax not in self.mesh.shape:
                        raise ValueError(
                            f"model_specs[{name!r}] = {spec!r} names "
                            f"{ax!r}, not a mesh axis: "
                            f"{dict(self.mesh.shape)}")

    # ------------------------------------------------------------- layout
    def _stage_group(self, tree_list, s):
        """Stage s's k consecutive per-layer entries."""
        k = self.layers_per_stage
        lo = self.trunk_start + s * k
        return [tree_list[lo + j] for j in range(k)]

    def _split_from_net(self) -> None:
        net = self.net
        S = self.n_stages

        n = len(net.layers)
        self.head_params = [_own(net._params[i])
                            for i in range(self.trunk_start)]
        self.tail_params = [_own(net._params[i])
                            for i in range(self.trunk_end, n)]
        self.trunk_params = stack_stage_params(
            [self._stage_group(net._params, s) for s in range(S)])
        self.head_upd = [_own(net._upd_state[i])
                         for i in range(self.trunk_start)]
        self.tail_upd = [_own(net._upd_state[i])
                         for i in range(self.trunk_end, n)]
        self.trunk_upd = stack_stage_params(
            [self._stage_group(net._upd_state, s) for s in range(S)])
        # trunk layers are stateless; head and tail states as they are
        self.lstate = [_own(st) for st in net._layer_state]

    def sync_to_net(self) -> None:
        """Write the trained parameters back into the network (the trunk
        unstacked), so evaluate() and serialization see the result."""
        net = self.net
        S = self.n_stages

        def stage(tree, s):
            if isinstance(tree, dict):
                return {k: stage(v, s) for k, v in tree.items()}
            return tree[s].clone()

        params = [_own(p) for p in self.head_params]
        upd = [_own(u) for u in self.head_upd]
        for s in range(S):
            params.extend(stage(p, s) for p in self.trunk_params)
            upd.extend(stage(u, s) for u in self.trunk_upd)
        params.extend(_own(p) for p in self.tail_params)
        upd.extend(_own(u) for u in self.tail_upd)
        net._params = params
        net._upd_state = upd
        net._layer_state = [_own(st) for st in self.lstate]

    # --------------------------------------------------------------- loss
    def _loss_pipe(self, head_p, trunk_p, tail_p, lstate, features, labels,
                   fmask, lmask, rng):
        """The network's `_loss_pure` with the trunk replaced by the GPipe
        schedule: the same precision policy and the same per-layer keys
        (`fold_in(rng, layer index)`) as the single-device step."""
        from deeplearning4j_tpu_torch.nn.multilayer import run_layer
        from deeplearning4j_tpu_torch.nn.precision import (
            restore_dtypes,
            tree_cast,
        )
        from deeplearning4j_tpu_torch.ops.aux_loss import aux_loss_scope
        from deeplearning4j_tpu_torch.ops.rng_rows import row_offset_scope

        net = self.net
        train = True
        params_in = (head_p, trunk_p, tail_p)
        features = net._prep_features(features)
        cdt = net.compute_dtype
        if cdt is not None:
            head_p = [tree_cast(p, cdt) for p in head_p]
            trunk_p = [tree_cast(p, cdt) for p in trunk_p]
            tail_p = [tree_cast(p, cdt) for p in tail_p]
            if not net._int_input():
                features = features.to(cdt)
        new_state = list(lstate)
        n = len(net.layers)
        with aux_loss_scope() as aux_terms, row_offset_scope(0):
            # a replicated MoE head or tail block adds its term as in
            # `_loss_pure`; the trunk has none by construction
            x = features
            for i in range(self.trunk_start):
                lrng = fold_in(rng, i)
                x = net._preprocess(i, x, lrng, train)
                mask = fmask if x.ndim == 3 else None
                x, new_state[i] = run_layer(net.layers[i], head_p[i],
                                            new_state[i], x, train, lrng,
                                            mask)
            k = self.layers_per_stage
            trunk_layers = [net.layers[self.trunk_start + j]
                            for j in range(k)]

            def block_fn(stage_p, xb, stage, row_off):
                # the true layer index keys each layer as `_loss_pure`
                # does; row_off makes dropout draw the global rows' masks
                for j in range(k):
                    lrng = fold_in(rng, self.trunk_start + stage * k + j)
                    with row_offset_scope(row_off):
                        xb = trunk_layers[j].forward(
                            stage_p[j], xb, train=train, rng=lrng, mask=None)
                return xb

            x = pipeline_apply(block_fn, trunk_p, x, self.mesh,
                               axis_name=self.pipe_axis,
                               microbatches=self.microbatches,
                               data_axis=self.data_axis, block_ctx=True)
            for idx, i in enumerate(range(self.trunk_end, n - 1)):
                lrng = fold_in(rng, i)
                x = net._preprocess(i, x, lrng, train)
                mask = fmask if x.ndim == 3 else None
                x, new_state[i] = run_layer(net.layers[i], tail_p[idx],
                                            new_state[i], x, train, lrng,
                                            mask)
        if cdt is not None:
            x = x.to(net.dtype)
            new_state = restore_dtypes(new_state, list(lstate))
        out_rng = fold_in(rng, n - 1)
        mask = lmask if lmask is not None else (fmask if x.ndim == 3 else None)
        head_pi, trunk_pi, tail_pi = params_in
        with row_offset_scope(0):
            x = net._preprocess(n - 1, x, out_rng, train)
            loss = net.layers[-1].loss_score(tail_pi[-1], x, labels,
                                             train=train, rng=out_rng,
                                             mask=mask)
        loss = loss + self._reg_score(head_pi, trunk_pi, tail_pi)
        for term in aux_terms:
            loss = loss + term
        return loss, new_state

    def _reg_score(self, head_p, trunk_p, tail_p):
        """L1/L2 over every parameter; a stacked trunk leaf sums over the
        stage axis as the per-layer terms would."""
        net = self.net
        pairs = list(zip(net.layers[:self.trunk_start], head_p))
        trunk_layers = [net.layers[self.trunk_start + j]
                        for j in range(self.layers_per_stage)]
        pairs += list(zip(trunk_layers, trunk_p))
        pairs += list(zip(net.layers[self.trunk_end:], tail_p))
        return regularization_score(pairs)

    # --------------------------------------------------------------- step
    def _step(self, f, l, fm, lm):
        """One training step: loss and gradients through the pipeline,
        then every layer's update, in place, on the wrapper's trees (the
        trunk's on the stacked trees)."""
        net = self.net

        def grad_leaves(tree):
            return [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                    for p in tree]

        head, trunk, tail = (grad_leaves(self.head_params),
                             grad_leaves(self.trunk_params),
                             grad_leaves(self.tail_params))
        flat = _leaves(head) + _leaves(trunk) + _leaves(tail)
        with torch.enable_grad():
            loss, new_state = self._loss_pipe(
                head, trunk, tail, self.lstate, f, l, fm, lm,
                (net.conf.seed, net.iteration))
            g_flat = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter(g_flat)

        def grads_of(tree):
            return [{k: (g if g is not None else torch.zeros_like(v))
                     for (k, v), g in zip(p.items(), it)} for p in tree]

        g_head, g_trunk, g_tail = grads_of(head), grads_of(trunk), \
            grads_of(tail)
        k = self.layers_per_stage
        with torch.no_grad():
            for i in range(self.trunk_start):
                apply_layer_update(net.layers[i], self.head_upd[i],
                                   self.head_params[i], g_head[i],
                                   net.iteration)
            # elementwise updaters: each stage's slice of a stacked leaf
            # gets the update its layer would get unstacked
            for j in range(k):
                apply_layer_update(net.layers[self.trunk_start + j],
                                   self.trunk_upd[j], self.trunk_params[j],
                                   g_trunk[j], net.iteration)
            for idx, i in enumerate(range(self.trunk_end, len(net.layers))):
                apply_layer_update(net.layers[i], self.tail_upd[idx],
                                   self.tail_params[idx], g_tail[idx],
                                   net.iteration)
        self.lstate = [{k2: v.detach() for k2, v in st.items()}
                       for st in new_state]
        return loss.detach()

    # ---------------------------------------------------------------- fit
    def fit(self, data: Union[DataSet, DataSetIterator],
            epochs: int = 1) -> None:
        net = self.net
        if isinstance(data, DataSet):
            iterator: DataSetIterator = ListDataSetIterator([data])
        else:
            iterator = data
        if (iterator.async_supported
                and not isinstance(iterator, AsyncDataSetIterator)):
            iterator = AsyncDataSetIterator(iterator, self.prefetch_buffer)
        try:
            for _ in range(epochs):
                for ds in iterator:
                    if ds.features_mask is not None \
                            or ds.labels_mask is not None:
                        raise ValueError(
                            "PipelineParallelWrapper does not support "
                            "masked batches; use ParallelWrapper")
                    B = ds.num_examples()
                    quantum = self.microbatches * self.n_data
                    if B % quantum:
                        usable = (B // quantum) * quantum
                        if not usable:
                            logger.warning("dropping batch of %d < %d "
                                           "(microbatches x data shards)",
                                           B, quantum)
                            continue
                        logger.warning("trimming batch %d -> %d "
                                       "(microbatch/data divisibility)",
                                       B, usable)
                        ds = DataSet(ds.features[:usable],
                                     None if ds.labels is None
                                     else ds.labels[:usable])
                    net._validate_labels(ds)
                    f, l, fm, lm = net._batch_arrays(ds)
                    net._score = self._step(f, l, fm, lm)
                    net.iteration += 1
                    for listener in net.listeners:
                        if hasattr(listener, "record_batch"):
                            listener.record_batch(ds.num_examples())
                        listener.iteration_done(net, net.iteration)
                net.epoch += 1
        finally:
            self.sync_to_net()
