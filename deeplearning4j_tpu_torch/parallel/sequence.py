"""Sequence (context) parallelism: ring attention and Ulysses all-to-all
(counterpart of `deeplearning4j_tpu/parallel/sequence.py`).

The time axis of attention is split over a `seq` mesh axis of slots
(`parallel.mesh`), and the JAX package's per-device bodies run once per
slot through `parallel.spmd`:

- **Ring attention** (`ring_attention`): each slot keeps its Q shard and
  the K/V shards rotate around the ring by `ppermute`; every visiting
  block is folded into the online-softmax accumulator
  (`ops.attention.attention_block_accum`, then `attention_finalize`).
- **Ulysses** (`ulysses_attention`): three `all_to_all`s reshard q/k/v
  from (T/n, H) to (T, H/n), `full_attention` runs over the whole
  sequence for the local heads, and one `all_to_all` reshards back.
  Like the JAX package, the body keeps `full_attention` (its scores for
  the local heads are (B, H/n, T, T)).

Both are exact up to the order of summation; `SequenceParallelWrapper`
trains a network with every attention layer routed through ring
attention (`ops.attention.sequence_parallel_scope`). On one card the
slots are all `cuda:0`, so the wrapper's step is the single-device step
with attention computed by the per-slot ring.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops.attention import (
    NEG_INF,
    _accum_init,
    attention_block_accum,
    attention_finalize,
    mask_bias,
)
from deeplearning4j_tpu_torch.parallel.spmd import (
    P,
    all_gather,
    all_to_all,
    axis_index,
    ppermute,
    shard_map,
)
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


def _ring_attention_local(q, k, v, key_mask, *, axis_name: str,
                          n_shards: int, causal: bool):
    """Per-slot body. q/k/v: the slot's time shard (B, T_local, H, D);
    key_mask: (B, T_local) or None. Slot i owns global positions
    [i*T_local, (i+1)*T_local)."""
    idx = axis_index(axis_name)
    Tl = q.shape[1]
    iq_local = torch.arange(Tl, device=q.device)
    perm = [(j, (j + 1) % n_shards) for j in range(n_shards)]
    carry = _accum_init(q)
    # no mask: no dummy mask rides the rotation
    kv = (k, v) if key_mask is None else (k, v, key_mask)
    for step in range(n_shards):
        # the block in hand came from slot (idx - step); the rotation for
        # the next step is issued first, as in the JAX body
        kv_next = tuple(ppermute(a, axis_name, perm) for a in kv) \
            if step < n_shards - 1 else kv
        k_blk, v_blk = kv[0], kv[1]
        src = (idx - step) % n_shards
        bias = None if key_mask is None else mask_bias(kv[2])
        if causal:
            q_pos = idx * Tl + iq_local  # global query positions
            k_pos = src * Tl + iq_local
            cb = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
            cb = cb[None, None, :, :]
            bias = cb if bias is None else bias + cb
        carry = attention_block_accum(carry, q, k_blk, v_blk, bias)
        kv = kv_next
    o, l, _ = carry
    return attention_finalize(o, l)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, axis_name: str = "seq", causal: bool = False,
                   key_mask: Optional[torch.Tensor] = None,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Exact attention with the time axis split over `axis_name`.

    q/k/v are whole (B, T, H, D) tensors; T must divide by the axis size.
    Returns the whole (B, T, H, D) output. `batch_axis` also splits B
    (dp x sp meshes). Differentiable."""
    n = mesh.shape[axis_name]
    if q.shape[1] % n != 0:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"mesh axis '{axis_name}' size {n}")
    spec = P(batch_axis, axis_name, None, None)
    fn = partial(_ring_attention_local, axis_name=axis_name, n_shards=n,
                 causal=causal)
    if key_mask is None:
        return shard_map(lambda qq, kk, vv: fn(qq, kk, vv, None), mesh,
                         in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)
    mask_spec = P(batch_axis, axis_name)
    return shard_map(fn, mesh, in_specs=(spec, spec, spec, mask_spec),
                     out_specs=spec)(q, k, v, key_mask)


def _ulysses_local(q, k, v, key_mask, *, axis_name: str, causal: bool):
    """Per-slot body: all-to-all from time-split to head-split, full
    attention over the whole sequence for H/n heads, all-to-all back."""
    from deeplearning4j_tpu_torch.ops.attention import full_attention

    # (B, T/n, H, D) -> (B, T, H/n, D)
    qg = all_to_all(q, axis_name, split_axis=2, concat_axis=1, tiled=True)
    kg = all_to_all(k, axis_name, split_axis=2, concat_axis=1, tiled=True)
    vg = all_to_all(v, axis_name, split_axis=2, concat_axis=1, tiled=True)
    if key_mask is None:
        bias = None
    else:
        bias = mask_bias(all_gather(key_mask, axis_name, axis=1, tiled=True))
    out = full_attention(qg, kg, vg, bias=bias, causal=causal)
    # (B, T, H/n, D) -> (B, T/n, H, D)
    return all_to_all(out, axis_name, split_axis=1, concat_axis=2,
                      tiled=True)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, axis_name: str = "seq", causal: bool = False,
                      key_mask: Optional[torch.Tensor] = None,
                      batch_axis: Optional[str] = None) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism by all-to-alls. Needs
    n_heads % axis size == 0."""
    n = mesh.shape[axis_name]
    H = q.shape[2]
    if H % n != 0:
        raise ValueError(f"n_heads {H} not divisible by mesh axis "
                         f"'{axis_name}' size {n} (use ring_attention)")
    if q.shape[1] % n != 0:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by "
                         f"mesh axis '{axis_name}' size {n}")
    spec = P(batch_axis, axis_name, None, None)
    fn = partial(_ulysses_local, axis_name=axis_name, causal=causal)
    if key_mask is None:
        return shard_map(lambda qq, kk, vv: fn(qq, kk, vv, None), mesh,
                         in_specs=(spec, spec, spec), out_specs=spec)(q, k, v)
    mask_spec = P(batch_axis, axis_name)
    return shard_map(fn, mesh, in_specs=(spec, spec, spec, mask_spec),
                     out_specs=spec)(q, k, v, key_mask)


class SequenceParallelWrapper(ParallelWrapper):
    """Train a SelfAttention / Transformer network with the time axis of
    attention split over the mesh's `seq` axis: the training loop is
    `ParallelWrapper`'s, each step runs inside `sequence_parallel_scope`,
    so every attention layer computes by ring attention over the slots.
    Batches must be unmasked and their length must divide by the seq
    axis. Parameters are replicated."""

    def __init__(self, net, mesh, seq_axis: str = "seq",
                 data_axis: str = "data", param_specs=None):
        if seq_axis not in mesh.shape:
            raise ValueError(f"mesh has no '{seq_axis}' axis: "
                             f"{dict(mesh.shape)}")
        if data_axis not in mesh.shape and mesh.shape.get(seq_axis) != \
                int(np.prod(list(mesh.shape.values()))):
            raise ValueError(
                f"data_axis {data_axis!r} not in mesh {dict(mesh.shape)}; "
                "for a pure-sequence mesh make the seq axis span all devices")
        self.seq_axis = seq_axis
        super().__init__(net, mesh=mesh, data_axis=data_axis,
                         param_specs=param_specs)

    def _step_scope(self):
        from deeplearning4j_tpu_torch.ops.attention import (
            sequence_parallel_scope,
        )

        d = self.data_axis if self.data_axis in self.mesh.shape else None
        return sequence_parallel_scope(self.mesh, self.seq_axis, d)

    def _shard_batch(self, ds):
        if ds.features_mask is not None or ds.labels_mask is not None:
            raise NotImplementedError(
                "masked sequences under sequence parallelism are not "
                "supported yet")
        n_seq = self.mesh.shape[self.seq_axis]
        if ds.features.shape[1] % n_seq:
            raise ValueError(
                f"sequence length {ds.features.shape[1]} not divisible by "
                f"the '{self.seq_axis}' mesh axis size {n_seq}")
        return super()._shard_batch(ds)
