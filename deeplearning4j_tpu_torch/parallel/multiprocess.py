"""Multi-process helpers (counterpart of the parts of
`deeplearning4j_tpu/parallel/multiprocess.py` that the parameter server's
worker processes and their tests use).

Ported: `free_port`, `run_workers` (run worker processes concurrently,
drain their output on threads, kill every one on timeout) and the parity
fixtures (`_parity_fixture_net`, `_parity_fixture_data`: one definition
for the worker entry, the tests and the card's run).

Not ported (ROADMAP queue A12c, the multi-process half of parallel
training on `torch.distributed`): `initialize_multiprocess`,
`global_mesh`, `MultiProcessParallelWrapper` and
`MultiProcessTrainingMaster` raise `NotImplementedError` naming A12c.
"""
from __future__ import annotations

import numpy as np

_A12C_NAMES = frozenset({
    "initialize_multiprocess", "global_mesh", "MultiProcessParallelWrapper",
    "MultiProcessTrainingMaster",
})


def __getattr__(name):
    if name in _A12C_NAMES:
        raise NotImplementedError(
            f"parallel.multiprocess.{name} is not ported yet (ROADMAP queue "
            "A12c: the multi-process half of parallel training on "
            "torch.distributed)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def free_port() -> int:
    """A free localhost TCP port (test and card rigs)."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(cmds, env, timeout: int = 240):
    """Run worker subprocesses CONCURRENTLY (threaded communicate) and
    kill every worker on timeout/failure: a sequential communicate would
    leak live workers and can deadlock on an undrained stdout pipe.
    Returns (processes, their logs)."""
    import pathlib
    import subprocess
    import threading

    # workers import this package with `-m`: anchor their cwd at the repo
    # root so the spawn works regardless of the caller's cwd
    root = str(pathlib.Path(__file__).resolve().parents[2])
    procs = [subprocess.Popen(c, env=env, cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = [None] * len(procs)

    def drain(i):
        try:
            out, _ = procs[i].communicate(timeout=timeout)
            logs[i] = out.decode(errors="replace")
        except Exception as e:
            logs[i] = f"<communicate failed: {e}>"

    threads = [threading.Thread(target=drain, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 30)
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    return procs, logs


def _parity_fixture_net(device="cuda"):
    """The fixture model shared by the worker entry, the tests and the
    card's run (the JAX package's: Dense 6 -> 16 tanh, softmax output of
    3, seed 77, lr 0.1), on `device`."""
    from deeplearning4j_tpu_torch.nn.conf import (
        DenseLayer,
        NeuralNetConfiguration,
        OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction

    conf = (NeuralNetConfiguration.Builder()
            .seed(77).learning_rate(0.1)
            .list()
            .layer(DenseLayer(n_in=6, n_out=16,
                              activation=Activation.TANH))
            .layer(OutputLayer(n_in=16, n_out=3,
                               activation=Activation.SOFTMAX,
                               loss=LossFunction.MCXENT))
            .build())
    net = MultiLayerNetwork(conf, device=device)
    net.init()
    return net


def _parity_fixture_data():
    """Deterministic fixture stream (the JAX package's numpy draws):
    6 batches of 16 examples, 6 features, one-hot labels of 3."""
    rng = np.random.RandomState(123)
    feats = rng.randn(6, 16, 6).astype(np.float32)
    labels = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (6, 16))]
    return feats, labels
