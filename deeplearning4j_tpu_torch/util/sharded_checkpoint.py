"""Sharded checkpointing of the training state (counterpart of
`deeplearning4j_tpu/util/sharded_checkpoint.py`, which saves through
orbax).

The port saves the same state tree (parameters, updater state, layer
state, iteration and epoch: JAX `:62-69`) with
`torch.distributed.checkpoint` (DCP), with or without a process group:

    pw = MultiProcessParallelWrapper(net)      # or ParallelWrapper(net)
    pw.fit(...)
    pw.save_checkpoint("/ckpt/step1000")       # every rank calls it
    ...
    pw2.load_checkpoint("/ckpt/step1000")      # any number of processes

The port keeps every parameter whole on each process, so DCP writes each
tensor once (its planner drops the replicas) and every process reads all
of it: a checkpoint written by two processes restores into one, and one
written by one process restores into two. These files are DCP's, not
orbax's: the checkpoint zip (`util.serialization`) stays the format that
crosses packages.

Durability, as in the JAX module: the old manifest sidecar is retired
before the write; the directory is published atomically (DCP writes in
place, so every rank writes into one temporary directory beside the
target and rank 0 renames it, as orbax's finalize does); the manifest
(`util.checkpoint_store.write_manifest_for`: per-file size, SHA-256 and
CRC32) is published only after the rename; `restore` re-hashes against
it and raises `CheckpointCorruptError` on any drift; a directory without
a manifest restores unverified, with a warning.
"""
from __future__ import annotations

import contextlib
import logging
import os
import shutil
import uuid
from typing import Any, Dict

import torch

from deeplearning4j_tpu_torch.util.checkpoint_store import (
    manifest_path_for,
    verify_manifest,
    write_manifest_for,
)

logger = logging.getLogger("deeplearning4j_tpu_torch")


def _dist_on() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


@contextlib.contextmanager
def _quiet(on: bool):
    """Without a process group DCP warns that it assumes one process:
    that is this module's intent, so the warning is dropped."""
    import warnings

    with warnings.catch_warnings():
        if not on:
            warnings.filterwarnings(
                "ignore", message="torch.distributed is disabled")
        yield


def _as_dict(tree) -> Dict[str, Any]:
    """A tree by layer (a list) or by node name (a dict) as a dict with
    string keys (DCP's state dicts are keyed by strings)."""
    if isinstance(tree, dict):
        return {str(k): v for k, v in tree.items()}
    return {str(i): v for i, v in enumerate(tree)}


def _state_tree(net) -> Dict[str, Any]:
    return {
        "params": _as_dict(net._params),
        "upd_state": _as_dict(net._upd_state),
        "layer_state": _as_dict(net._layer_state),
        "iteration": torch.tensor(int(net.iteration), dtype=torch.int64),
        "epoch": torch.tensor(int(net.epoch), dtype=torch.int64),
    }


def save_sharded_checkpoint(path, net) -> None:
    """Write the network's training state (every rank of a process group
    calls this), then publish the integrity-manifest sidecar over the
    finished directory."""
    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    net._ensure_init()
    abspath = os.path.abspath(os.fspath(path))
    on = _dist_on()
    rank = dist.get_rank() if on else 0
    names = [f"{abspath}.tmp-{uuid.uuid4().hex}"]
    if on:
        dist.broadcast_object_list(names, src=0)
    tmp = names[0]
    if rank == 0:
        # retire any OLD sidecar first: overwriting an existing checkpoint
        # must never leave a stale manifest vouching for replaced bytes
        with contextlib.suppress(OSError):
            manifest_path_for(abspath).unlink()
        os.makedirs(os.path.dirname(abspath) or ".", exist_ok=True)
    with _quiet(on):
        dcp.save(_state_tree(net), checkpoint_id=tmp, no_dist=not on)
    if on:
        dist.barrier()
    if rank == 0:
        if os.path.isdir(abspath):
            shutil.rmtree(abspath)
        os.replace(tmp, abspath)
        # the manifest publishes only after the directory's rename: a
        # crash before this line leaves an unverifiable (untrusted)
        # checkpoint, never a manifest vouching for a partial one
        write_manifest_for(abspath, step=int(net.iteration))
    if on:
        dist.barrier()


def restore_sharded_checkpoint(path, net, shardings=None,
                               verify: bool = True) -> None:
    """Restore in place onto the network's device. `shardings` is the
    JAX package's target placement; the port keeps every parameter whole
    on the network's device, so it changes nothing. With `verify=True`
    (default) the directory is re-hashed against its manifest sidecar
    first, raising `CheckpointCorruptError` on damage; a checkpoint
    without a manifest restores unverified with a warning."""
    import torch.distributed.checkpoint as dcp

    net._ensure_init()
    abspath = os.path.abspath(os.fspath(path))
    if verify:
        if manifest_path_for(abspath).exists():
            verify_manifest(abspath)
        else:
            logger.warning(
                "sharded checkpoint %s has no integrity manifest "
                "(pre-durability build or foreign checkpoint); restoring "
                "UNVERIFIED", abspath)
    state = _state_tree(net)
    on = _dist_on()
    with _quiet(on):
        dcp.load(state, checkpoint_id=abspath, no_dist=not on)

    def back(tree, loaded):
        if isinstance(tree, dict):
            return {k: loaded[str(k)] for k in tree}
        return [loaded[str(i)] for i in range(len(tree))]

    net._params = back(net._params, state["params"])
    net._upd_state = back(net._upd_state, state["upd_state"])
    net._layer_state = back(net._layer_state, state["layer_state"])
    net.iteration = int(state["iteration"])
    net.epoch = int(state["epoch"])
