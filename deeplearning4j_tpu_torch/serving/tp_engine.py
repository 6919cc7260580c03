"""Tensor-parallel serving plan: one decode engine sharded over a `tp`
mesh of slots (counterpart of `deeplearning4j_tpu/serving/tp_engine.py`).

A `TPPlan` shards a `GPTPlan` network Megatron-style (Shoeybi et al.,
2019) over the `tp` axis of a mesh of slots (`parallel.mesh`): on one
card every slot is `cuda:0`, in the tests every slot is the CPU. The
engine's per-block work runs once per slot through `parallel.spmd`
(`TPPlan.shard`, the counterpart of the JAX package's `shard_map`), so
chunked prefill, prefix-cache sharing, speculative verify, int8 KV pools
and the paged-attention kernel all run per shard, untouched.

**Sharding layout** (per transformer block, degree N):

| tensor | layout | shard |
|---|---|---|
| `Wqkv` | (d, d + 2*Hkv*hd), columns permuted to [Q_t ‖ K_t ‖ V_t] | columns over `tp` |
| `bqkv` | same permutation | over `tp` |
| `Wo`   | (d, d), rows ordered by query head | rows over `tp` |
| `bo`   | replicated, added after the all-reduce | - |
| `W1`/`W3`/`b1` | column-parallel FFN in | columns over `tp` |
| `W2`   | row-parallel FFN out | rows over `tp` |
| `b2`   | replicated, added after the all-reduce | - |
| embeddings / LNs / logits head | replicated | - |
| K/V page pools (+ int8 scale pools) | `(P+1, Hkv, ...)` | head axis over `tp` |

Exactly two all-reduces per block and step (after the output
projection and after the FFN out, `models.transformer._psum_partial`).
Each slot owns `Hkv/N` heads of every page, in a pool tensor of its own
(contiguous: the paged kernel's layout checks refuse a strided view of
the head axis), so the page table, free list, refcounts and prefix-cache
promotions stay host-global and byte-identical to the single-device
engine. Attention is parallel over heads: each slot runs the paged
kernel (or its plain version) at `Hkv/N` heads, and GQA grouping holds
because `(H/N)/(Hkv/N) == H/Hkv`.

Where the JAX package runs the embedding and the logits head replicated
inside the `shard_map` (every device computing the same values), the
port runs them once in the engine's thread and only the block stack per
slot: the values are the same, and sampling from one `torch.Generator`
draws once.

**Parity.** The sharded computation is the same math with one changed
reduction: the row-parallel products sum d/N-long partials, then the
slots' partials in slot order. f32 greedy tokens equal the single-device
engine's (`tests/test_torch_tp_engine.py`); in bf16 the changed order of
summation can flip an argmax.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.spmd import P, Sharded, shard_map

TP_AXIS = "tp"

# keys split along their output axis (column-parallel)
_COL_KEYS = ("Wqkv", "W1", "W3")
_COL_BIAS_KEYS = ("bqkv", "b1", "b3")
# keys split along their input axis (row-parallel; the bias is replicated
# and added after the psum, see models.transformer)
_ROW_KEYS = ("Wo", "W2")

# one mesh per degree per process
_MESH_CACHE: dict = {}


def tp_mesh(degree: int):
    """The serving `tp` mesh over the process's first `degree` slots
    (`parallel.mesh.local_slots`), cached per process. Raises
    ValueError when the process exposes fewer slots: on one card the fix
    is `parallel.mesh.set_local_slots(degree)`, on the CPU
    `set_local_slots(degree, "cpu")`."""
    from deeplearning4j_tpu_torch.parallel.mesh import local_slots, make_mesh

    slots = local_slots()
    mesh = _MESH_CACHE.get(degree)
    if mesh is not None and list(mesh.devices.reshape(-1)) \
            == slots[:degree]:
        return mesh
    if len(slots) < degree:
        raise ValueError(
            f"parallel={{'tp': {degree}}} needs {degree} devices but the "
            f"process exposes {len(slots)} slots; expose more with "
            f"parallel.mesh.set_local_slots({degree}) (slots of one card) "
            f"or set_local_slots({degree}, 'cpu')")
    mesh = make_mesh({TP_AXIS: degree}, devices=slots[:degree])
    _MESH_CACHE[degree] = mesh
    return mesh


def _same_kind(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.type == "cpu" or a.index is None
                                 or b.index is None or a.index == b.index)


class TPPlan:
    """Sharding plan for one `GPTPlan` network at tensor-parallel degree
    N: checks the geometry at construction (typed ValueErrors), owns the
    mesh and the per-layer spec trees, permutes and splits the params,
    and runs step bodies per slot (`shard`)."""

    def __init__(self, net, plan, degree: int):
        if not isinstance(degree, int) or isinstance(degree, bool) \
                or degree < 2:
            raise ValueError(
                f"tensor-parallel degree must be an int >= 2, got "
                f"{degree!r} (tp=1 is the single-device engine: omit "
                "parallel= instead)")
        self.degree = degree
        self.axis = TP_AXIS
        self.mesh = tp_mesh(degree)
        dev = torch.device(net.device)
        if not all(_same_kind(torch.device(s), dev)
                   for s in self.mesh.devices.reshape(-1)):
            raise ValueError(
                f"the tp slots {self.mesh.distinct_devices()} are not the "
                f"network's device {dev}: set_local_slots({degree}, "
                f"{str(dev)!r})")
        self.plan = plan
        params = net._params
        specs: list = [P()] * len(params)
        self._perms: dict = {}
        for i in plan.block_is:
            layer = plan.layers[i]
            if getattr(layer, "moe_experts", 0) > 0:
                raise ValueError(
                    "parallel={'tp': N} does not compose with MoE blocks "
                    "(expert parallelism is its own axis): serve the "
                    "dense net or drop parallel=")
            H, Hkv = layer.n_heads, layer._kv_heads
            if H % degree or Hkv % degree:
                raise ValueError(
                    f"tp={degree} must divide the head counts of every "
                    f"block: block {i} has n_heads={H}, kv_heads={Hkv}")
            p = params[i]
            f = int(p["W1"].shape[1]) if "W1" in p else 0
            if f % degree:
                raise ValueError(
                    f"tp={degree} must divide the FFN width of every "
                    f"block: block {i} has ffn={f}")
            d = int(layer.n_out)
            hd = d // H
            self._perms[i] = self._qkv_perm(d, H, Hkv, hd, degree)
            specs[i] = {
                k: (P(None, TP_AXIS) if k in _COL_KEYS
                    else P(TP_AXIS) if k in _COL_BIAS_KEYS
                    else P(TP_AXIS, None) if k in _ROW_KEYS
                    else P())
                for k in p}
        self.param_specs = specs

    @staticmethod
    def _qkv_perm(d, H, Hkv, hd, n):
        """Column permutation of the packed [Q | K | V] output axis so
        slot t's contiguous block of columns is [Q_t | K_t | V_t]."""
        Hl, Hkvl = H // n, Hkv // n
        k0, v0 = d, d + Hkv * hd
        idx = []
        for t in range(n):
            idx.extend(range(t * Hl * hd, (t + 1) * Hl * hd))
            idx.extend(range(k0 + t * Hkvl * hd, k0 + (t + 1) * Hkvl * hd))
            idx.extend(range(v0 + t * Hkvl * hd, v0 + (t + 1) * Hkvl * hd))
        return np.asarray(idx, np.int64)

    # -- placement ---------------------------------------------------------
    def shard_params(self, params):
        """Permute and split the params once per (re)build. Returns a new
        list: block entries hold `Sharded` tensors (one contiguous tensor
        per slot), the others the network's own tensors (replicated).
        `net._params` stays the untouched copy that weight swaps,
        checkpoints and the parity oracle read."""
        out = []
        for i, p in enumerate(params):
            spec = self.param_specs[i]
            if not isinstance(spec, dict):
                out.append(p)
                continue
            perm = torch.as_tensor(self._perms[i])
            q = {}
            for k, v in p.items():
                if k == "Wqkv":
                    v = v[:, perm.to(v.device)]
                elif k == "bqkv":
                    v = v[perm.to(v.device)]
                q[k] = Sharded.split(v, spec[k], self.mesh)
            out.append(q)
        return out

    def shard_pool(self, x):
        """One page pool (or scale pool) with its head axis (axis 1 in
        every pool layout) split over `tp`: a `Sharded` of one
        contiguous `(P+1, Hkv/N, ...)` tensor per slot."""
        spec = P(*([None, TP_AXIS] + [None] * (x.ndim - 2)))
        return Sharded.split(x, spec, self.mesh)

    # -- per-slot bodies ---------------------------------------------------
    def in_specs(self, n: int, params_at: int = 0, caches_at: int = 1):
        """Per-argument specs: the params' spec trees, the pools with
        their head axis over `tp`, everything else (page table, slot
        state, scalars) replicated."""
        specs = [P()] * n
        specs[params_at] = self.param_specs
        specs[caches_at] = P(None, TP_AXIS)
        return tuple(specs)

    def out_specs(self, n: int, caches_at: int = 0):
        specs = [P(None, TP_AXIS) if j == caches_at else P()
                 for j in range(n)]
        return specs[0] if n == 1 else tuple(specs)

    def shard(self, fn: Callable, *, n_in: int, n_out: int,
              params_at: int = 0, caches_at: int = 1,
              caches_out_at: int = 0):
        """`fn` as a per-slot body over the tp mesh (`spmd.shard_map`).
        Pool outputs stay split (`Sharded`); every other output is
        replicated, slot 0's: each slot runs the same math on the same
        inputs after every psum. The pools are written in place by the
        bodies, so callers pass `n_out` without a pool (`caches_out_at`
        -1) unless the body returns one."""
        return shard_map(
            fn, self.mesh,
            in_specs=self.in_specs(n_in, params_at, caches_at),
            out_specs=self.out_specs(n_out, caches_out_at), join=False)

    # -- byte accounting ---------------------------------------------------
    def weight_bytes_per_chip(self, params) -> int:
        """Weight bytes one slot holds: split matmul slices divide by
        the degree, replicated tensors do not."""
        total = 0
        for i, p in enumerate(params):
            spec = self.param_specs[i]
            items = p.items() if isinstance(p, dict) else ()
            for k, v in items:
                nb = v.numel() * v.element_size()
                split = isinstance(spec, dict) and tuple(spec[k]) != ()
                total += nb // (self.degree if split else 1)
        return total


def run_blocks(tp, body: Callable, params, caches, *args):
    """`body(params, caches, *args, shard=, axis_name=)` on one device
    (`tp` None), or once per tp slot with the slots' params and pools,
    returning slot 0's (replicated) result."""
    if tp is None:
        return body(params, caches, *args, shard=None, axis_name=None)

    def per_slot(p, c, *a):
        return body(p, c, *a, shard=tp.degree, axis_name=tp.axis)

    return tp.shard(per_slot, n_in=2 + len(args), n_out=1,
                    caches_out_at=-1)(params, caches, *args)


def leaf0(x):
    """Slot 0's tensor of a possibly split value."""
    return x.shards[0] if isinstance(x, Sharded) else x
