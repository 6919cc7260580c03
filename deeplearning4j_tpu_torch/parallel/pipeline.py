"""Pipeline parallelism: the GPipe microbatch schedule over a mesh axis
of slots (counterpart of `deeplearning4j_tpu/parallel/pipeline.py`).

S homogeneous stages' parameters are stacked on axis 0 and split one
stage per slot of the `pipe` axis; microbatches flow slot to slot by
`ppermute` (`parallel.spmd`). The schedule is the JAX package's: M + S - 1
ticks, a `ppermute` every tick; stage d holds microbatch t - d at tick t,
the last stage collects the finished microbatches, and a masked `psum`
hands them to every slot. On a tick where stage d holds no microbatch
(the fill and drain bubbles) the JAX body computes on a clamped garbage
input and masks the result; the port's body, whose stage index is a
Python int, computes nothing there and sends zeros.

Differentiable end to end: the collectives are torch ops on the slots'
tensors, so `backward()` through the output runs the reverse pipeline.

Stages must be homogeneous: the same param structure and an output the
shape of the input (transformer blocks, MLP stacks).
"""
from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.parallel.spmd import (
    P,
    Sharded,
    axis_index,
    ppermute,
    psum,
    shard_map,
)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def _first_leaf(tree):
    """The first tensor in the JAX package's leaf order (dict keys
    sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            leaf = _first_leaf(tree[k])
            if leaf is not None:
                return leaf
        return None
    if isinstance(tree, (list, tuple)):
        for v in tree:
            leaf = _first_leaf(v)
            if leaf is not None:
                return leaf
        return None
    return tree


def pipeline_apply(block_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, *, axis_name: str = "pipe",
                   microbatches: int = None, data_axis: str = None,
                   block_ctx: bool = False) -> torch.Tensor:
    """Apply S stacked stages as a pipeline over the mesh axis.

    block_fn(params_i, x) -> y with y.shape == x.shape; stacked_params: a
    tree whose leaves have leading dim S; x: (B, ...) the whole batch,
    split into `microbatches` equal chunks (default S).

    `data_axis`: each microbatch's rows are also split over this axis
    (dp x pp). Any other mesh axis is not named by the specs: its slots
    hold replicas of the stage and compute the unsplit stage (the
    global-view result).

    `block_ctx`: call `block_fn(params_i, x, stage, row_offset)`, with
    `stage` this slot's stage index and `row_offset` the first global
    batch row of the rows `x` holds (per-layer dropout keys and
    partition-invariant masks, `ops.rng_rows`)."""
    S = mesh.shape[axis_name]
    M = microbatches if microbatches is not None else S
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    if data_axis is not None:
        if data_axis == axis_name:
            raise ValueError(
                f"data_axis must differ from the pipeline axis "
                f"{axis_name!r}: sharding the batch over the axis the "
                "stage loop ppermutes over would silently mix shards")
        if data_axis not in mesh.shape:
            raise ValueError(f"mesh has no {data_axis!r} axis: "
                             f"{dict(mesh.shape)}")
        if (B // M) % mesh.shape[data_axis] != 0:
            raise ValueError(
                f"microbatch size {B // M} not divisible over data axis "
                f"'{data_axis}' of size {mesh.shape[data_axis]}")
    leaf = _first_leaf(stacked_params)
    if leaf.shape[0] != S:
        raise ValueError(
            f"stacked params have {leaf.shape[0]} stages but mesh axis "
            f"'{axis_name}' has size {S}")
    xs = x.reshape(M, B // M, *x.shape[1:])
    n_steps = S + M - 1

    def local(stage_p, xs_local):
        # stage_p leaves: (1, ...), this slot's stage
        p = _tree_map(lambda a: a[0], stage_p)
        d = axis_index(axis_name)
        perm = [(i, (i + 1) % S) for i in range(S)]
        local_rows = xs_local.shape[1]
        di_rows = (axis_index(data_axis) * local_rows
                   if data_axis is not None else 0)
        buf = torch.zeros_like(xs_local[0])
        outs = [None] * M
        for t in range(n_steps):
            m = t - d  # the microbatch this stage holds at tick t
            if 0 <= m < M:
                inp = xs_local[m] if d == 0 else buf
                if block_ctx:
                    y = block_fn(p, inp, d, m * (B // M) + di_rows)
                else:
                    y = block_fn(p, inp)
                if d == S - 1:
                    outs[m] = y
            else:
                y = torch.zeros_like(buf)
            buf = ppermute(y, axis_name, perm)
        # the results live on the last stage: a masked psum hands them to
        # every slot (replicated output)
        if d == S - 1:
            out = torch.stack(outs)
        else:
            out = torch.zeros_like(xs_local)
        return psum(out, axis_name)

    xspec = P(None, data_axis) if data_axis is not None else P()
    out = shard_map(local, mesh, in_specs=(P(axis_name), xspec),
                    out_specs=xspec)(stacked_params, xs)
    return out.reshape(B, *x.shape[1:])


def stack_stage_params(per_stage_params):
    """[stage0 tree, stage1 tree, ...] (identical structures) -> one tree
    whose leaves have a leading stage axis."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([t[k] for t in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        out = [stack_stage_params([t[i] for t in per_stage_params])
               for i in range(len(first))]
        return out if isinstance(first, list) else tuple(out)
    return torch.stack(list(per_stage_params))


def shard_stacked_params(stacked_params, mesh, axis_name: str = "pipe"):
    """Each stage's slice on its pipeline slot: every leaf becomes a
    `Sharded` over `axis_name`."""
    return _tree_map(lambda a: Sharded.split(a, P(axis_name), mesh),
                     stacked_params)
