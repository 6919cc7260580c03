"""Switch-style top-1 mixture of experts, replicated on one card
(counterpart of the single-device part of
`deeplearning4j_tpu/parallel/experts.py`).

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

The expert-parallel path over a device mesh (`moe_apply`,
`switch_ffn_sharded`, `expert_mesh_scope`) is ROADMAP queue A12b.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def _a12(name: str):
    return NotImplementedError(
        f"parallel.experts.{name} (expert parallelism over a device mesh) "
        "is not ported yet (ROADMAP queue A12b: the multi-device half of "
        "parallel training)")


def expert_mesh_scope(mesh, data_axis=None):
    raise _a12("expert_mesh_scope")


def current_expert_mesh():
    raise _a12("current_expert_mesh")


def moe_apply(expert_fn, stacked_params, x, router_w, mesh, **kw):
    raise _a12("moe_apply")


def switch_ffn_sharded(params, tokens, mesh, **kw):
    raise _a12("switch_ffn_sharded")


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
