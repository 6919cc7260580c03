"""Switch-style top-1 mixture of experts (counterpart of
`deeplearning4j_tpu/parallel/experts.py`): replicated on one device, and
expert-parallel over a mesh axis of slots.

A linear router gives each token a softmax over E experts and picks the
largest (argmax: the lower index on ties). Each expert takes at most
`capacity = ceil(N / E * capacity_factor)` of the N tokens, counted
globally over the flattened tokens in row-major order (the cumulative
count of each expert's one-hot column); a token past its expert's
capacity, or a padding token, is dropped and yields its input
(`passthrough="identity"`) or zero (`"zero"`, for callers that add their
own residual). The kept tokens are scattered into (E, capacity, D)
buffers by `index_add` (no host synchronization), the experts run as
one batched product, and the outputs are gathered back by
`index_select` (whose gradient is an `index_add`, not the sorting
`index_put` that advanced indexing's takes) and scaled by the token's
router probability. The load-balancing loss is Switch's
E * sum_e(fraction routed to e * mean router probability of e), over the
real tokens.

The expert-parallel path (`moe_apply`, `switch_ffn_sharded`) splits the
stacked experts one per slot of the `expert` axis and the tokens over
(data, expert), and runs the JAX package's per-device body once per slot
(`parallel.spmd`): route the local tokens, fill (E, capacity / E, D)
buffers (GShard's static capacity per expert and source slot), an
`all_to_all` to the experts' slots, one expert product, an `all_to_all`
back. `ParallelWrapper` opens `expert_mesh_scope` around its steps, so a
`MoELayer(expert_axis=...)` finds the mesh there.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.parallel.spmd import (
    P,
    all_to_all,
    pmean,
    shard_map,
)

# -- expert-parallel mesh scope ------------------------------------------
# ParallelWrapper enters this scope around its steps so that
# MoELayer.forward, which has no mesh in its signature, can find the mesh
# and route through the all_to_all path
_MESH_SCOPE: list = []


@contextlib.contextmanager
def expert_mesh_scope(mesh, data_axis: Optional[str] = None):
    """Declare the active mesh (and its data axis, if any) for the
    expert-parallel MoE layers run within the scope."""
    _MESH_SCOPE.append((mesh, data_axis))
    try:
        yield
    finally:
        _MESH_SCOPE.pop()


def current_expert_mesh():
    """(mesh, data axis) of the innermost `expert_mesh_scope`, or None."""
    return _MESH_SCOPE[-1] if _MESH_SCOPE else None


def router_probs(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    """(N, D) tokens x (D, E) router -> (N, E) softmax probabilities."""
    return torch.softmax(x @ router_w, dim=-1)


def _dispatch_indices(expert_idx: torch.Tensor, E: int, capacity: int,
                      valid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's position in its expert's capacity buffer, and the
    keep mask of the tokens under capacity. `valid` (N,) bool keeps
    padding tokens out of the dispatch and out of the count. The count
    runs along the tokens as the inner axis of an (E, N) one-hot: a scan
    over the outer axis of (N, E) took tens of ms on the card at
    N = 32768, E = 8."""
    onehot = F.one_hot(expert_idx, E).T.to(torch.int32)   # (E, N)
    if valid is not None:
        onehot = onehot * valid[None, :].to(torch.int32)
    pos = (torch.cumsum(onehot, dim=1, dtype=torch.int32)
           * onehot).amax(dim=0).long() - 1
    keep = pos < capacity
    if valid is not None:
        keep = keep & (pos >= 0)  # invalid tokens have pos == -1
    return pos, keep


def moe_apply_reference(expert_fn: Callable, stacked_params,
                        x: torch.Tensor, router_w: torch.Tensor, *,
                        capacity_factor: float = 1.25, token_mask=None,
                        passthrough: str = "identity"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing with a global capacity; (y, aux_loss). `expert_fn
    (params, buf)` maps one expert's params and its (capacity, D) buffer
    to outputs; here it is applied to the stacked (E, capacity, D)
    buffers at once, the params stacked on axis 0."""
    if passthrough not in ("identity", "zero"):
        raise ValueError(f"unknown passthrough {passthrough!r}")
    N, D = x.shape
    E = router_w.shape[1]
    capacity = int(math.ceil(N / E * capacity_factor))
    probs = router_probs(x, router_w)
    expert_idx = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
    valid = None if token_mask is None else token_mask > 0
    pos, keep = _dispatch_indices(expert_idx, E, capacity, valid)
    slot = expert_idx * capacity + torch.where(keep, pos, 0)
    kept = torch.where(keep[:, None], x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    buf = torch.zeros((E * capacity, D), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, slot, kept).reshape(E, capacity, D)
    out_buf = expert_fn(stacked_params, buf)
    y_expert = torch.index_select(out_buf.reshape(E * capacity, -1), 0,
                                  slot)
    dropped = x if passthrough == "identity" else torch.zeros_like(x)
    y = torch.where(keep[:, None], gate[:, None] * y_expert, dropped)

    oh = F.one_hot(expert_idx, E).to(torch.float32)
    if valid is not None:
        w = valid.to(x.dtype)
        denom = torch.clamp(w.sum(), min=1.0)
        frac_routed = (oh * w[:, None]).sum(dim=0) / denom
        mean_prob = (probs * w[:, None]).sum(dim=0) / denom
    else:
        frac_routed = oh.mean(dim=0)
        mean_prob = probs.mean(dim=0)
    aux = E * torch.sum(frac_routed * mean_prob)
    return y, aux


def _first_leaf(tree):
    if isinstance(tree, dict):
        return _first_leaf(tree[sorted(tree)[0]])
    return tree


def moe_apply(expert_fn: Callable, stacked_params, x: torch.Tensor,
              router_w: torch.Tensor, mesh, *, axis_name: str = "expert",
              capacity_factor: float = 1.25, passthrough: str = "identity",
              data_axis: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: the experts split over `axis_name`, the
    tokens dispatched and returned by `all_to_all`. `expert_fn(p, t)`
    maps ONE expert's params and its (n, D) tokens to outputs.

    Equals `moe_apply_reference` while no expert overflows. Under
    overflow the two drop different tokens: here the capacity holds per
    (expert, source slot), GShard's static dispatch shape, while the
    reference caps each expert globally in token order.

    `data_axis`: tokens split over (data_axis, axis_name) jointly, the
    all_to_all rides the expert axis within each data row, and the
    load-balancing loss means over both axes.

    x: (N, D) tokens; stacked_params: a tree with leading expert dim
    E == the axis size; router_w: (D, E). Returns (y, aux_loss)."""
    E = mesh.shape[axis_name]
    leaf = _first_leaf(stacked_params)
    if leaf.shape[0] != E:
        raise ValueError(f"{leaf.shape[0]} experts but mesh axis "
                         f"'{axis_name}' has size {E}")
    dp = mesh.shape.get(data_axis, 1) if data_axis else 1
    N, D = x.shape
    if N % (E * dp):
        raise ValueError(f"token count {N} not divisible by expert axis "
                         f"{E} x data axis {dp}")
    # capacity from the tokens ONE data row routes among E experts, then
    # whole per-slot slices
    capacity = int(math.ceil(N / dp / E * capacity_factor))
    capacity = int(math.ceil(capacity / E) * E)
    if passthrough not in ("identity", "zero"):
        raise ValueError(f"unknown passthrough {passthrough!r}")
    reduce_axes = (data_axis, axis_name) if dp > 1 else axis_name
    cap_local = capacity // E  # slots per (expert, source slot)

    def local(stage_p, x_local, rw):
        # x_local: this slot's (N / (E dp), D) tokens; stage_p: its
        # expert's params (leading dim 1)
        p = {k: v[0] for k, v in stage_p.items()}
        probs = router_probs(x_local, rw)
        expert_idx = torch.argmax(probs, dim=-1)
        gate = torch.gather(probs, 1, expert_idx[:, None])[:, 0]
        pos, keep = _dispatch_indices(expert_idx, E, cap_local)
        slot = expert_idx * cap_local + torch.where(keep, pos, 0)
        kept = torch.where(keep[:, None], x_local,
                           torch.zeros((), dtype=x_local.dtype,
                                       device=x_local.device))
        d = x_local.shape[1]
        buf = torch.zeros((E * cap_local, d), dtype=x_local.dtype,
                          device=x_local.device)
        buf = buf.index_add(0, slot, kept).reshape(E, cap_local, d)
        # expert e's slot receives every source's slice for e
        recv = all_to_all(buf, axis_name, split_axis=0, concat_axis=0,
                          tiled=True)
        out = expert_fn(p, recv.reshape(-1, d)).reshape(E, cap_local, -1)
        back = all_to_all(out, axis_name, split_axis=0, concat_axis=0,
                          tiled=True)
        y_expert = torch.index_select(back.reshape(E * cap_local, -1), 0,
                                      slot)
        dropped = x_local if passthrough == "identity" \
            else torch.zeros_like(x_local)
        y = torch.where(keep[:, None], gate[:, None] * y_expert, dropped)
        frac = F.one_hot(expert_idx, E).to(torch.float32).mean(dim=0)
        mean_prob = probs.mean(dim=0)
        aux = E * torch.sum(pmean(frac, reduce_axes)
                            * pmean(mean_prob, reduce_axes))
        return y, aux

    tok = P((data_axis, axis_name)) if dp > 1 else P(axis_name)
    return shard_map(local, mesh, in_specs=(P(axis_name), tok, P()),
                     out_specs=(tok, P()))(stacked_params, x, router_w)


def switch_ffn_sharded(params, tokens: torch.Tensor, mesh, *,
                       axis_name: str, data_axis: Optional[str],
                       act: Callable, capacity_factor: float,
                       aux_weight: float, train: bool = False,
                       passthrough: str = "identity") -> torch.Tensor:
    """The expert-parallel twin of `switch_ffn`: the same stacked
    router/W1/b1/W2/b2 params and aux-loss contract, the dispatch through
    `moe_apply`'s all_to_all over `axis_name` (composed with data
    parallelism over `data_axis`). `MoELayer(expert_axis=...)` takes it
    under `ParallelWrapper`."""
    from deeplearning4j_tpu_torch.ops.aux_loss import add_aux_loss

    def expert_fn(p, t):
        return act(t @ p["W1"] + p["b1"]) @ p["W2"] + p["b2"]

    stacked = {"W1": params["W1"], "b1": params["b1"],
               "W2": params["W2"], "b2": params["b2"]}
    y, aux = moe_apply(expert_fn, stacked, tokens, params["router"], mesh,
                       axis_name=axis_name, data_axis=data_axis,
                       capacity_factor=capacity_factor,
                       passthrough=passthrough)
    if train:
        add_aux_loss(aux_weight * aux)
    return y


def switch_ffn(params, tokens: torch.Tensor, *, act: Callable,
               capacity_factor: float, aux_weight: float, token_mask=None,
               train: bool = False, passthrough: str = "identity"
               ) -> torch.Tensor:
    """The Switch FFN of `MoELayer` and of `TransformerBlock`'s MoE
    branch: params router (D, E) and W1 (E, D, h), b1 (E, h), W2 (E, h,
    D), b2 (E, D); with `train` the weighted load-balancing loss is
    added through `ops.aux_loss`."""
    from deeplearning4j_tpu_torch.ops.aux_loss import add_aux_loss

    def experts(p, buf):
        h = act(torch.matmul(buf, p["W1"]) + p["b1"][:, None, :])
        return torch.matmul(h, p["W2"]) + p["b2"][:, None, :]

    y, aux = moe_apply_reference(experts, params, tokens, params["router"],
                                 capacity_factor=capacity_factor,
                                 token_mask=token_mask,
                                 passthrough=passthrough)
    if train:
        add_aux_loss(aux_weight * aux)
    return y
