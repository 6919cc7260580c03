"""In-process SPMD over the slots of a mesh: the port's counterpart of
`jax.shard_map` and the `lax` collectives the JAX package's per-device
bodies call (no JAX file of this name: these are JAX built-ins).

The JAX package writes some of its parallel code as per-device bodies
with explicit collectives (tensor-parallel decode, ring and Ulysses
attention, the GPipe schedule, the expert-parallel MoE) and runs them
under `shard_map` on a mesh of devices. Here a mesh is a grid of slots
(`parallel.mesh`), each naming a `torch.device`; on one card every slot
is `cuda:0`, in the tests every slot is the CPU. `shard_map(fn, mesh,
in_specs, out_specs)` runs `fn` once per slot, each on its own thread,
with its share of every argument:

- an argument's spec is a `PartitionSpec` (`P`): one entry per leading
  dimension, None (whole) or the mesh axis (or tuple of axes) that
  splits it. A spec may be a tree matching the argument (dicts, lists,
  tuples), or one `P` for a whole subtree. A `Sharded` argument (a value
  already split, one tensor per slot) hands each slot its own tensor;
  anything that is not a tensor passes to every slot as it is;
- the collectives (`psum`, `pmean`, `ppermute`, `all_to_all`,
  `all_gather`) meet at a rendezvous of every slot: each slot deposits
  its tensor, waits for the others, and computes its own result from
  the deposits, moved to its device with `.to(device)`. A reduction adds
  the slots' tensors in slot order, so every slot's result has the same
  bits, and one run's bits do not depend on thread timing;
- outputs join by their out-specs: a replicated output is slot 0's (on
  a mesh over processes, this process's first slot's), a split one is
  concatenated over its axes (a `shard_map(...,
  join=False)` returns `Sharded` values instead).

The collectives are plain differentiable torch ops on the slots'
tensors, so one `backward()` from the caller runs the reverse program
(the reverse pipeline of GPipe, the transposed all-to-alls), as
`jax.grad` through a `shard_map` does.

Each slot thread starts with the caller's grad mode, inference mode,
intra-op thread count, current CUDA stream (on the caller's device) and
row-offset scope
(`ops.rng_rows`); aux-loss terms a body adds (`ops.aux_loss`) reach the
caller's scope from slot 0, once, as the single trace of the JAX body
adds them once. Between two rendezvous the slots take turns, one body
at a time, and the process's first call of the CPU's vector math is made before
any slot thread starts (`util.host_math`). If a body raises, the rendezvous is aborted, so the
other slots fail out of their waits instead of hanging, and the call
raises the first body's exception. A slot that finishes while others
still wait at a collective is a body that called different collectives
on different slots: the mismatch raises in every slot.
"""
from __future__ import annotations

import threading
from types import SimpleNamespace
from contextlib import ExitStack, nullcontext
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """Per-dimension placement: None (whole) or a mesh axis name (or a
    tuple of names) that splits the dimension; trailing dimensions not
    named are whole. `P()` is replicated."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def _is_replicated(spec) -> bool:
    return all(p is None for p in spec)


def _norm(spec) -> tuple:
    """A spec without its trailing Nones (P(None, 'tp') == P(None, 'tp',
    None))."""
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


class _Layout:
    """Slot coordinates of a mesh: flat slot order is row-major over the
    mesh's axes, as `np.unravel_index` gives it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.sizes = tuple(int(s) for s in mesh.shape.values())
        self.n = int(np.prod(self.sizes)) if self.sizes else 1
        self.devices = [torch.device(d) for d in mesh.devices.reshape(-1)]
        self.coords = [dict(zip(self.names, np.unravel_index(i, self.sizes)))
                       for i in range(self.n)]
        self._groups: Dict[Tuple[str, ...], List[Tuple[List[int], int]]] = {}
        # the slots this process runs; on a mesh over processes the rest
        # run in their owners (`Mesh.processes`)
        self.multiprocess = bool(getattr(mesh, "is_multiprocess", False))
        self.local = (mesh.local_slot_indices() if self.multiprocess
                      else list(range(self.n)))
        self.owner = [mesh.process_of(s) if self.multiprocess else 0
                      for s in range(self.n)]

    def check_axes(self, axes: Tuple[str, ...]) -> None:
        for a in axes:
            if a not in self.names:
                axes = dict(zip(self.names, self.sizes))
                raise ValueError(f"mesh axes {axes} have no {a!r} axis")

    def size(self, axes: Tuple[str, ...]) -> int:
        self.check_axes(axes)
        return int(np.prod([self.sizes[self.names.index(a)] for a in axes],
                           dtype=np.int64)) if axes else 1

    def index(self, slot: int, axes: Tuple[str, ...]) -> int:
        """Row-major index of `slot` over `axes` (in the order given)."""
        idx = 0
        for a in axes:
            idx = idx * self.sizes[self.names.index(a)] \
                + int(self.coords[slot][a])
        return idx

    def group(self, slot: int, axes: Tuple[str, ...]):
        """(the slots that share `slot`'s coordinates off `axes`, ordered
        by their index over `axes`; `slot`'s rank among them)."""
        table = self._groups.get(axes)
        if table is None:
            self.check_axes(axes)
            others = [a for a in self.names if a not in axes]
            buckets: Dict[tuple, List[int]] = {}
            for s in range(self.n):
                key = tuple(int(self.coords[s][a]) for a in others)
                buckets.setdefault(key, []).append(s)
            table = [None] * self.n
            for members in buckets.values():
                members = sorted(members, key=lambda s: self.index(s, axes))
                for rank, s in enumerate(members):
                    table[s] = (members, rank)
            self._groups[axes] = table
        return table[slot]


class Sharded:
    """A value split over a mesh: `shards[s]` is slot s's tensor (its own
    storage) under `spec`. Reads and writes along dimension 0 (the page
    axis of a KV pool, when `spec` splits a later dimension) go to every
    shard; `full()` joins the shards into one tensor."""

    def __init__(self, shards: Sequence[torch.Tensor], spec: PartitionSpec,
                 mesh):
        self.shards = list(shards)
        self.spec = PartitionSpec(*spec)
        self.mesh = mesh
        self._layout = _Layout(mesh)
        if len(self.shards) != self._layout.n:
            raise ValueError(f"{len(self.shards)} shards for a mesh of "
                             f"{self._layout.n} slots")

    @classmethod
    def split(cls, x: torch.Tensor, spec, mesh) -> "Sharded":
        """`x` split by `spec`: one contiguous tensor per slot, on the
        slot's device."""
        lay = _Layout(mesh)
        out = []
        for s in range(lay.n):
            part = _slice_for(x, spec, lay, s)
            out.append(torch.empty(part.shape, dtype=part.dtype,
                                   device=lay.devices[s]).copy_(part))
        return cls(out, spec, mesh)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def shape(self) -> torch.Size:
        shape = list(self.shards[0].shape)
        for d, part in enumerate(self.spec):
            shape[d] *= self._layout.size(_axes_of(part))
        return torch.Size(shape)

    @property
    def nbytes(self) -> int:
        """Bytes of the global value (as `jax.Array.nbytes`)."""
        return int(np.prod(self.shape, dtype=np.int64)) \
            * self.shards[0].element_size()

    def shard_nbytes(self) -> int:
        """Bytes one slot holds."""
        return self.shards[0].numel() * self.shards[0].element_size()

    def numel(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def _split_dim(self) -> int:
        dims = [d for d, p in enumerate(self.spec) if p is not None]
        if len(dims) != 1 or dims[0] == 0:
            raise NotImplementedError(
                f"indexing a Sharded value split as {self.spec!r}: only one "
                "split dimension past dimension 0 is indexable")
        return dims[0]

    def __getitem__(self, idx):
        """`x[idx]` on dimension 0 of every shard, joined."""
        self._split_dim()
        return _join([s[idx] for s in self.shards], self.spec, self._layout)

    def __setitem__(self, idx, value) -> None:
        """`x[idx] = value` on dimension 0: each shard takes its slice of
        `value` along the split dimension."""
        self._split_dim()
        for s, shard in enumerate(self.shards):
            shard[idx] = _slice_for(value, self.spec, self._layout, s).to(
                shard.device)

    def full(self) -> torch.Tensor:
        return _join(self.shards, self.spec, self._layout)

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec!r}, "
                f"{len(self.shards)} shards)")


def _slice_for(x: torch.Tensor, spec, lay: _Layout, slot: int):
    """Slot `slot`'s block of `x` under `spec` (a view)."""
    for d, part in enumerate(spec):
        axes = _axes_of(part)
        if not axes:
            continue
        n = lay.size(axes)
        if x.shape[d] % n:
            raise ValueError(f"dimension {d} of size {x.shape[d]} does not "
                             f"split over {axes} ({n} slots)")
        c = x.shape[d] // n
        x = x.narrow(d, lay.index(slot, axes) * c, c)
    return x


def _join(per_slot: Sequence[Any], spec, lay: _Layout):
    """Join per-slot outputs under `spec`: slot 0's for a replicated spec,
    else the blocks concatenated over their axes (the slots off those
    axes hold replicas: those at coordinate 0 are used), on slot 0's
    device."""
    parts = [(d, _axes_of(p)) for d, p in enumerate(spec) if p is not None]
    if not parts:
        return per_slot[0]
    used = {a for _, axes in parts for a in axes}
    blocks: Dict[tuple, torch.Tensor] = {}
    for s in range(lay.n):
        if any(int(lay.coords[s][a]) for a in lay.names if a not in used):
            continue
        blocks[tuple(lay.index(s, axes) for _, axes in parts)] = per_slot[s]
    dev = lay.devices[lay.local[0]]

    def build(prefix, k):
        if k == len(parts):
            return blocks[prefix].to(dev)
        d, axes = parts[k]
        return torch.cat([build(prefix + (i,), k + 1)
                          for i in range(lay.size(axes))], dim=d)

    return build((), 0)


# -- the per-call runtime ----------------------------------------------------
class _Runtime:
    """The rendezvous of one `shard_map` call: a barrier over every slot
    and two inboxes, used in alternate rounds, so a slot that leaves a
    round and deposits into the next cannot overwrite a deposit that a
    slower slot is still reading.

    `turn`: between two rendezvous one slot at a time runs its body.
    Slot threads that all issue torch ops at once hand the GIL back and
    forth at every op (each op releases it); taking turns hands it over
    once a segment. The work and its order within a slot are the same,
    and every result depends on the slot-order sums alone."""

    def __init__(self, lay: _Layout):
        self.lay = lay
        self.barrier = threading.Barrier(
            len(lay.local),
            action=self._across_processes if lay.multiprocess else None)
        self.inbox = [[None] * lay.n, [None] * lay.n]
        self.rounds = [0] * lay.n
        self.turn = threading.Lock()

    def _across_processes(self) -> None:
        """The barrier's action on a mesh over processes: once every
        local slot has deposited, fill the other processes' deposits into
        this round's inbox (`_exchange_across`)."""
        r = self.rounds[self.lay.local[0]] - 1
        _exchange_across(self.lay, self.inbox[r % 2])

    def exchange(self, ctx: "_Ctx", op: tuple, payload):
        slot = ctx.slot
        r = self.rounds[slot]
        self.rounds[slot] = r + 1
        box = self.inbox[r % 2]
        box[slot] = (op, payload)
        ctx.give_turn()
        try:
            self.barrier.wait()
        finally:
            ctx.take_turn()
        for s, (other, _) in enumerate(box):
            if other != op:
                raise RuntimeError(
                    f"SPMD mismatch at collective {r}: slot {slot} called "
                    f"{op}, slot {s} called {other}")
        return [p for _, p in box]


# -- across processes --------------------------------------------------------
# A mesh over processes (`parallel.multiprocess.global_mesh`) runs each
# process's own slots here; at every rendezvous the deposits of the other
# processes' slots arrive through the default `torch.distributed` process
# group, one round for all of a process's slots. gloo does not take CUDA
# tensors in every collective, so the deposits are staged through pinned
# host memory (`host_copy` here, `.to(device)` on arrival). The exchange is an
# autograd function: the cotangents of the copies another process used
# travel back to the slot that deposited them and add there, in process
# order, so `backward()` across processes runs the reverse program as it
# does within one.
def host_copy(t: torch.Tensor) -> torch.Tensor:
    """`t` in host memory for a gloo collective: a card's tensor copied
    into a pinned buffer, a host tensor as it is (contiguous)."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.contiguous()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _all_gather_host(t: torch.Tensor) -> List[torch.Tensor]:
    import torch.distributed as dist

    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


# The backward of every exchange is a collective too, so every process
# must run them in one order. The autograd engine orders independent
# branches by sequence numbers that are per thread, and the exchanges are
# made on whichever slot thread reaches the barrier last; so each
# exchange takes the previous one's `token` output as an input: its
# backward then waits for the next one's, and the backward runs the
# exchanges in exactly the reverse of their order in every process. The
# chain runs over one `shard_map` call, or over every call inside an
# `exchange_chain()` scope (a training step with several expert layers).
_CHAIN: Dict[str, Any] = {"token": None, "scoped": 0}


def _chain_token() -> torch.Tensor:
    t = _CHAIN["token"]
    return t if t is not None else torch.zeros((), requires_grad=True)


class exchange_chain:
    """Chain the cross-process exchanges of every `shard_map` call
    inside the scope (see `_CHAIN`)."""

    def __enter__(self):
        if not _CHAIN["scoped"]:
            _CHAIN["token"] = None
        _CHAIN["scoped"] += 1
        return self

    def __exit__(self, *exc):
        _CHAIN["scoped"] -= 1
        if not _CHAIN["scoped"]:
            _CHAIN["token"] = None


class _Exchange(torch.autograd.Function):
    """(the chain's token, the local slots' deposits) -> (the next token,
    the remote slots' deposits in flat slot order, on `device`)."""

    @staticmethod
    def forward(ctx, lay, device, token, *local):
        ctx.lay, ctx.devices = lay, [t.device for t in local]
        stacked = host_copy(torch.stack([t.detach() for t in local]))
        per_proc = _all_gather_host(stacked)
        rank = {p: [s for s in range(lay.n) if lay.owner[s] == p]
                for p in set(lay.owner)}
        outs = []
        for s in range(lay.n):
            if s in lay.local:
                continue
            p = lay.owner[s]
            outs.append(per_proc[p][rank[p].index(s)].to(device))
        ctx.shape, ctx.dtype = stacked.shape[1:], stacked.dtype
        return (torch.zeros(()),) + tuple(outs)

    @staticmethod
    def backward(ctx, _token_grad, *grads):
        lay = ctx.lay
        full = torch.zeros((lay.n,) + tuple(ctx.shape), dtype=ctx.dtype)
        remote = [s for s in range(lay.n) if s not in lay.local]
        for s, g in zip(remote, grads):
            if g is not None:
                full[s] = host_copy(g)
        per_proc = _all_gather_host(full)
        from deeplearning4j_tpu_torch.parallel.multiprocess import (
            process_index,
        )

        me = process_index()
        out = []
        for s, dev in zip(lay.local, ctx.devices):
            acc = None
            for p, cot in enumerate(per_proc):
                if p == me:
                    continue
                acc = cot[s] if acc is None else acc + cot[s]
            out.append(acc.to(dev))
        return (None, None, torch.zeros(())) + tuple(out)


def _exchange_across(lay: _Layout, box: list) -> None:
    """Fill the remote slots of one round's inbox from their owners: the
    collective each slot called (checked against every slot's, as within
    a process) and its tensor."""
    import torch.distributed as dist

    mine = [box[s] for s in lay.local]
    ops = [None] * dist.get_world_size()
    dist.all_gather_object(ops, [op for op, _ in mine])
    remote = [s for s in range(lay.n) if s not in lay.local]
    seen = {p: 0 for p in set(lay.owner)}
    remote_ops = {}
    for s in range(lay.n):
        p = lay.owner[s]
        remote_ops[s] = ops[p][seen[p]]
        seen[p] += 1
    if any(remote_ops[s] != mine[0][0] for s in remote):
        for s in remote:
            box[s] = (remote_ops[s], None)
        return  # every slot's mismatch check raises
    payloads = [p for _, p in mine]
    if not isinstance(payloads[0], torch.Tensor):
        for s in remote:
            box[s] = (remote_ops[s], None)
        return
    device = payloads[0].device
    if torch.is_grad_enabled() and payloads[0].is_floating_point() \
            and any(t.requires_grad for t in payloads):
        token, *got = _Exchange.apply(lay, device, _chain_token(), *payloads)
        _CHAIN["token"] = token
    else:
        with torch.no_grad():
            _, *got = _Exchange.forward(SimpleNamespace(), lay, device, None,
                                        *payloads)
    for s, t in zip(remote, got):
        box[s] = (remote_ops[s], t)


class _Ctx:
    __slots__ = ("rt", "slot", "holds")

    def __init__(self, rt: _Runtime, slot: int):
        self.rt = rt
        self.slot = slot
        self.holds = False

    def take_turn(self) -> None:
        self.rt.turn.acquire()
        self.holds = True

    def give_turn(self) -> None:
        if self.holds:
            self.holds = False
            self.rt.turn.release()


_tls = threading.local()

# the process's first CPU vector-math call is made alone, before any slot
# thread exists (`util.host_math`: the package import makes it)
from deeplearning4j_tpu_torch.util.host_math import (  # noqa: E402
    settle_host_math as _settle_host_math,
)


def _ctx(what: str) -> _Ctx:
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        raise RuntimeError(f"{what} called outside a shard_map body")
    return ctx


def current_slot() -> Optional[int]:
    """The flat slot index of the running `shard_map` body, or None
    outside one (kernel wrappers tally launches by it)."""
    ctx = getattr(_tls, "ctx", None)
    return None if ctx is None else ctx.slot


def _axes(axis_name) -> Tuple[str, ...]:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)


def axis_index(axis_name) -> int:
    """This slot's index along `axis_name` (a name or a tuple of names,
    row-major), as `lax.axis_index`."""
    ctx = _ctx("axis_index")
    axes = _axes(axis_name)
    ctx.rt.lay.check_axes(axes)
    return ctx.rt.lay.index(ctx.slot, axes)


def _collective(kind: str, x, axis_name, *params):
    ctx = _ctx(kind)
    axes = _axes(axis_name)
    lay = ctx.rt.lay
    members, rank = lay.group(ctx.slot, axes)
    deposits = ctx.rt.exchange(ctx, (kind, axes) + params, x)
    return [deposits[s] for s in members], rank, lay.devices[ctx.slot]


def _psum(x: torch.Tensor, axis_name):
    """(the slot-order sum of `x` over the slots along `axis_name`, the
    number of those slots)."""
    xs, _, dev = _collective("psum", x, axis_name)
    acc = xs[0].to(dev)
    for t in xs[1:]:
        acc = acc + t.to(dev)
    return acc, len(xs)


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """The sum of `x` over the slots along `axis_name`, added in slot
    order (every slot gets the same bits)."""
    return _psum(x, axis_name)[0]


def pmean(x: torch.Tensor, axis_name) -> torch.Tensor:
    """`psum(x) / n` over the slots along `axis_name`."""
    acc, n = _psum(x, axis_name)
    return acc / n


def ppermute(x: torch.Tensor, axis_name, perm) -> torch.Tensor:
    """Send `x` from index i to index j for every (i, j) in `perm` along
    `axis_name`; a slot no pair sends to gets zeros (`lax.ppermute`).
    The result may share storage with the sender's tensor: bodies do
    not write a collective's result in place."""
    perm = tuple((int(i), int(j)) for i, j in perm)
    xs, rank, dev = _collective("ppermute", x, axis_name, perm)
    src = [i for i, j in perm if j == rank]
    if len(src) > 1:
        raise ValueError(f"ppermute {perm} sends twice to index {rank}")
    if not src:
        return torch.zeros_like(x)
    return xs[src[0]].to(dev)


def all_to_all(x: torch.Tensor, axis_name, split_axis: int,
               concat_axis: int, *, tiled: bool = False) -> torch.Tensor:
    """`lax.all_to_all`: every slot splits `x` along `split_axis` into n
    chunks and sends chunk j to index j; each slot joins the chunks it
    receives, in sender order, along `concat_axis`. `tiled=False`: the
    split axis has size n and is removed, the received chunks stack on a
    new `concat_axis`."""
    xs, rank, dev = _collective("all_to_all", x, axis_name, split_axis,
                                concat_axis, tiled)
    n = len(xs)
    if tiled:
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: split axis {split_axis} of size "
                             f"{x.shape[split_axis]} does not split {n} ways")
        c = x.shape[split_axis] // n
        return torch.cat([t.narrow(split_axis, rank * c, c).to(dev)
                          for t in xs], dim=concat_axis)
    if x.shape[split_axis] != n:
        raise ValueError(f"all_to_all (tiled=False): split axis size "
                         f"{x.shape[split_axis]} != {n} slots")
    return torch.stack([t.select(split_axis, rank).to(dev) for t in xs],
                       dim=concat_axis)


def all_gather(x: torch.Tensor, axis_name, *, axis: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """Every slot's `x` along `axis_name`, in index order: stacked on a
    new dimension `axis`, or concatenated along `axis` with `tiled`."""
    xs, _, dev = _collective("all_gather", x, axis_name, axis, tiled)
    xs = [t.to(dev) for t in xs]
    return torch.cat(xs, dim=axis) if tiled else torch.stack(xs, dim=axis)


# -- shard_map ---------------------------------------------------------------
def _is_leaf_spec(spec) -> bool:
    return spec is None or isinstance(spec, PartitionSpec)


def _split_arg(arg, spec, lay: _Layout, slot: int):
    """Slot `slot`'s share of one argument under a spec (tree)."""
    if _is_leaf_spec(spec):
        spec = spec or P()
        return _split_tree(arg, spec, lay, slot)
    if isinstance(spec, dict):
        return {k: _split_arg(arg[k], spec[k], lay, slot) for k in arg}
    if isinstance(spec, (list, tuple)):
        if len(spec) != len(arg):
            raise ValueError(f"spec tree of {len(spec)} entries for an "
                             f"argument of {len(arg)}")
        out = [_split_arg(a, s, lay, slot) for a, s in zip(arg, spec)]
        return out if isinstance(arg, list) else tuple(out)
    raise TypeError(f"unknown spec {spec!r}")


def _split_tree(arg, spec: PartitionSpec, lay: _Layout, slot: int):
    if isinstance(arg, Sharded):
        if _norm(arg.spec) != _norm(spec) \
                or tuple(arg.mesh.shape.items()) \
                != tuple(lay.mesh.shape.items()):
            raise ValueError(f"a value sharded as {arg.spec!r} passed where "
                             f"{spec!r} is expected")
        return arg.shards[slot]
    if isinstance(arg, torch.Tensor):
        dev = lay.devices[slot]
        if _is_replicated(spec):
            return arg.to(dev)
        return _slice_for(arg, spec, lay, slot).to(dev)
    if isinstance(arg, dict):
        return {k: _split_tree(v, spec, lay, slot) for k, v in arg.items()}
    if isinstance(arg, (list, tuple)):
        out = [_split_tree(v, spec, lay, slot) for v in arg]
        return out if isinstance(arg, list) else tuple(out)
    return arg


def _join_out(outs: List[Any], spec, lay: _Layout, join: bool):
    """Join one output (tree) over the slots. A replicated output is the
    first slot's of this process (slot 0's within one process): on a
    mesh over processes each process computes it from the same
    collectives' results, so every process's backward takes the same
    path."""
    first = outs[lay.local[0]]
    if _is_leaf_spec(spec) and not isinstance(first, (dict, list, tuple)):
        spec = spec or P()
        if not isinstance(first, torch.Tensor) or _is_replicated(spec):
            return first
        return _join(outs, spec, lay) if join \
            else Sharded(outs, spec, lay.mesh)
    if isinstance(first, dict):
        sub = spec if _is_leaf_spec(spec) else None
        return {k: _join_out([o[k] for o in outs],
                             sub if sub is not None else spec[k], lay, join)
                for k in first}
    if isinstance(first, (list, tuple)):
        specs = [spec] * len(first) if _is_leaf_spec(spec) else list(spec)
        out = [_join_out([o[i] for o in outs], specs[i], lay, join)
               for i in range(len(first))]
        return out if isinstance(first, list) else tuple(out)
    return first


def _caller_state():
    """What each slot thread takes over from the calling thread."""
    from deeplearning4j_tpu_torch.ops import aux_loss, rng_rows

    stream = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stream = torch.cuda.current_stream()
    stack = aux_loss._stack()
    return {"grad": torch.is_grad_enabled(),
            "threads": torch.get_num_threads(),
            "inference": torch.is_inference_mode_enabled(),
            "stream": stream,
            "aux": stack[-1] if stack else None,
            "row_offset": rng_rows.current_row_offset()}


def _enter_state(stack: ExitStack, state, device: torch.device):
    from deeplearning4j_tpu_torch.ops import aux_loss, rng_rows

    # a new thread's OpenMP team is as wide as the machine, whatever the
    # caller set: CPU ops in a slot use the caller's width
    torch.set_num_threads(state["threads"])
    if state["inference"]:
        stack.enter_context(torch.inference_mode())
    stack.enter_context(torch.set_grad_enabled(state["grad"]))
    if device.type == "cuda":
        stack.enter_context(torch.cuda.device(device))
        s = state["stream"]
        if s is not None and s.device == device:
            stack.enter_context(torch.cuda.stream(s))
    terms = stack.enter_context(aux_loss.aux_loss_scope()) \
        if state["aux"] is not None else None
    if state["row_offset"] is not None:
        stack.enter_context(rng_rows.row_offset_scope(state["row_offset"]))
    return terms


def _run_slots(lay: _Layout, fn: Callable, per_slot_args: Sequence[tuple]):
    """Run `fn(*per_slot_args[s])` on every slot s, one thread each, with
    the collectives live; returns the per-slot results. The first body
    exception is raised after every thread has left."""
    _settle_host_math()
    rt = _Runtime(lay)
    state = _caller_state()
    results: List[Any] = [None] * lay.n
    errors: List[Optional[BaseException]] = [None] * lay.n
    aux_terms: List[Optional[list]] = [None] * lay.n
    remote_leaves: Dict[int, list] = {s: [] for s in range(lay.n)
                                      if s not in lay.local}

    def work(s: int) -> None:
        ctx = _tls.ctx = _Ctx(rt, s)
        try:
            ctx.take_turn()
            with ExitStack() as stack:
                aux_terms[s] = _enter_state(stack, state, lay.devices[s])
                results[s] = fn(*per_slot_args[s])
                if lay.multiprocess:
                    # the other processes' outputs, leaf by leaf, for
                    # the join
                    for i, leaf in enumerate(_leaves(results[s])):
                        if not isinstance(leaf, torch.Tensor):
                            continue
                        got = rt.exchange(ctx, ("join", i), leaf)
                        if s == lay.local[0]:
                            for r in remote_leaves:
                                remote_leaves[r].append(got[r])
                # leave together: a slot that ran fewer collectives than
                # the others meets their next one here and raises
                rt.exchange(ctx, ("exit",), None)
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[s] = e
            rt.barrier.abort()
        finally:
            ctx.give_turn()
            _tls.ctx = None

    threads = [threading.Thread(target=work, args=(s,), daemon=True,
                                name=f"spmd-slot-{s}")
               for s in lay.local]
    with exchange_chain() if lay.multiprocess else nullcontext():
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    real = [e for e in errors if e is not None
            and not isinstance(e, threading.BrokenBarrierError)]
    if real or any(e is not None for e in errors):
        raise (real or [e for e in errors if e is not None])[0]
    first = lay.local[0]
    if state["aux"] is not None and aux_terms[first]:
        state["aux"].extend(aux_terms[first])
    for r, leaves in remote_leaves.items():
        it = iter(leaves)
        results[r] = _map_leaves(
            lambda v: next(it) if isinstance(v, torch.Tensor) else v,
            results[first])
    return results


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in tree for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for x in tree for v in _leaves(x)]
    return [tree]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_leaves(fn, x) for x in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def shard_map(fn: Callable, mesh, in_specs, out_specs, *,
              join: bool = True, **_jax_options):
    """`fn` as a per-slot program over `mesh` (see the module docstring).
    `in_specs` has one spec (tree) per positional argument; `out_specs`
    is one spec (tree) for a single output or a tuple of them. JAX-only
    options (`check_vma`, `check_rep`, `axis_names`) are accepted and
    change nothing: there is no replication check, and a mesh axis the
    specs do not name is replicated."""
    lay = _Layout(mesh)
    in_specs = tuple(in_specs)

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map body takes {len(in_specs)} "
                             f"arguments, got {len(args)}")
        per_slot = [tuple(_split_arg(a, s, lay, slot)
                          for a, s in zip(args, in_specs))
                    if slot in lay.local else None
                    for slot in range(lay.n)]
        outs = _run_slots(lay, fn, per_slot)
        return _join_out(outs, out_specs, lay, join)

    return call
