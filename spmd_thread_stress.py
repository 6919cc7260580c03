#!/usr/bin/env python3
"""Stress check of host-side torch ops run from several threads at once,
each in a fresh process (CPU only: no card, no JAX).

    python3 spmd_thread_stress.py                  # every mode
    python3 spmd_thread_stress.py spmd -n 1200     # one mode, 1200 processes

Every child process is fresh, so the first call of each op in the
process is made by the check itself, and pins torch to one intra-op
thread, as the port's tests do. Then, by mode:

- threads: 8 plain threads each call `torch.set_num_threads(1)`, meet at a
  barrier and run the ops at once;
- threads-locked: the same with the `set_num_threads` calls made one at a
  time (under a lock), the ops still at once;
- threads-warm: the same as threads after the main thread ran one f32
  square root;
- threads-warm-exp: the same as threads after the main thread ran one f32
  exp;
- spmd: the ops as a `parallel.spmd.shard_map` body on 8 CPU slots (the
  runtime as it is: the calling thread makes the process's first call of
  the CPU vector math before the slot threads start, each slot thread
  sets the caller's width, and the slots take turns between rendezvous);
- spmd-noturn: the same with the slots' turn-taking switched off, so the
  8 slot threads run their bodies at once;
- spmd-nosetup: the runtime without that first call;
- spmd-bare: without either;
- master: the averaging master (`ParameterAveragingTrainingMaster`) trains
  the parity fixture network with 4 workers, each on its own thread, on
  CPU slots; its parameters are compared bit for bit with the same
  training run again with its workers one at a time on one thread.

Importing `deeplearning4j_tpu_torch` makes the process's first call of the
CPU vector math (`util.host_math`), so in the modes that import the port
(spmd*, master) that call is made alone, at import, whatever the mode
switches off in `shard_map` itself; the threads* modes import nothing of
the port and show the race as it is.

The ops: the f32, bf16 and f16 square roots of scalar head dims (the
attention scale was once taken so), then a vector square root, exp and
softmax. Each thread's results are compared bit for bit with the same ops
run afterwards in the main thread; a child prints "ok" or "BAD" with its
first differences. The parent prints one JSON line per mode: processes,
processes with a difference, and the first differences seen.
"""
import argparse
import json
import os
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

MODES = ("threads", "threads-locked", "threads-warm", "threads-warm-exp",
         "spmd", "spmd-noturn", "spmd-nosetup", "spmd-bare", "master")
N_THREADS = 8


def ops(torch):
    out = []
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for d in (8, 16, 32, 64, 128, 256, 3, 5, 7):
            out.append(("sqrt", str(dt), d,
                        float(torch.tensor(float(d), dtype=dt).sqrt())))
    g = torch.arange(1, 65, dtype=torch.float32)
    out.append(("sqrt vector", torch.sqrt(g).tolist()))
    out.append(("exp vector", torch.exp(g / 64).tolist()))
    out.append(("softmax vector", torch.softmax(g / 8, 0).tolist()))
    return out


def master_child() -> int:
    """The averaging master's 4 worker threads against its workers run
    one at a time on one thread, bit for bit."""
    import concurrent.futures as cf

    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.parallel import training_master as tm
    from deeplearning4j_tpu_torch.parallel.multiprocess import (
        _parity_fixture_data,
        _parity_fixture_net,
    )

    feats, labels = _parity_fixture_data()
    batches = [DataSet(feats[i, lo:lo + 4], labels[i, lo:lo + 4])
               for i in range(feats.shape[0]) for lo in range(0, 16, 4)]

    def train():
        net = _parity_fixture_net(device="cpu")
        master = tm.ParameterAveragingTrainingMaster(
            num_workers=4, averaging_frequency=2)
        master.execute_training(net, ListDataSetIterator(batches))
        return net.params().numpy().tolist()

    threaded = train()
    real_pool = tm.ThreadPoolExecutor
    tm.ThreadPoolExecutor = lambda max_workers=None, **kw: \
        cf.ThreadPoolExecutor(max_workers=1, **kw)
    try:
        one = train()
    finally:
        tm.ThreadPoolExecutor = real_pool
    bad = [i for i, (a, b) in enumerate(zip(threaded, one)) if a != b]
    if not bad:
        print("ok")
        return 0
    print("BAD " + json.dumps({"differences": len(bad), "first": bad[0],
                               "got": threaded[bad[0]],
                               "want": one[bad[0]]}))
    return 0


def child(mode: str) -> int:
    if mode == "master":
        return master_child()
    import torch

    torch.set_num_threads(1)
    res = [None] * N_THREADS
    if mode.startswith("threads"):
        if mode == "threads-warm":
            float(torch.tensor(2.0).sqrt())
        elif mode == "threads-warm-exp":
            float(torch.tensor(2.0).exp())
        lock = threading.Lock()
        barrier = threading.Barrier(N_THREADS)

        def work(i):
            if mode == "threads-locked":
                with lock:
                    torch.set_num_threads(1)
            else:
                torch.set_num_threads(1)
            barrier.wait()
            res[i] = ops(torch)

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(N_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from deeplearning4j_tpu_torch.parallel import spmd
        from deeplearning4j_tpu_torch.parallel.mesh import make_mesh

        if mode in ("spmd-noturn", "spmd-bare"):
            spmd._Ctx.take_turn = lambda self: None
            spmd._Ctx.give_turn = lambda self: None
        if mode in ("spmd-nosetup", "spmd-bare"):
            spmd._settle_host_math = lambda: None  # skipped in shard_map
        mesh = make_mesh({"a": N_THREADS},
                         devices=[torch.device("cpu")] * N_THREADS)

        def body(x):
            res[spmd.axis_index("a")] = ops(torch)
            return x

        spmd.shard_map(body, mesh, in_specs=(spmd.P("a"),),
                       out_specs=spmd.P("a"))(torch.zeros(N_THREADS))
    ref = ops(torch)
    bad = [(i, got, want) for i, r in enumerate(res)
           for got, want in zip(r, ref) if got != want]
    if not bad:
        print("ok")
        return 0
    i, got, want = bad[0]
    first = got if len(got) == 4 else got[0]
    print("BAD " + json.dumps({"differences": len(bad), "thread": i,
                               "first": first, "want": want[-1]
                               if len(want) == 4 else None}))
    return 0


def run_mode(mode: str, n: int, jobs: int) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", mode]

    def one(_):
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        out = p.stdout.strip().splitlines()
        return out[-1] if p.returncode == 0 and out else \
            f"FAILED {p.returncode}: {p.stderr.strip()[-300:]}"

    with ThreadPoolExecutor(jobs) as pool:
        lines = list(pool.map(one, range(n)))
    bad = [ln for ln in lines if ln != "ok"]
    return {"mode": mode, "processes": n, "with_a_difference": len(bad),
            "first": bad[:3]}


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("modes", nargs="*", metavar="MODE",
                    help=f"any of {', '.join(MODES)} (default: all)")
    ap.add_argument("-n", type=int, default=480,
                    help="fresh processes a mode (default 480)")
    ap.add_argument("-j", type=int, default=6,
                    help="processes at once (default 6)")
    ap.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child)
    unknown = set(args.modes) - set(MODES)
    if unknown:
        ap.error(f"unknown modes {sorted(unknown)}")
    for mode in args.modes or MODES:
        print(json.dumps(run_mode(mode, args.n, args.j)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
