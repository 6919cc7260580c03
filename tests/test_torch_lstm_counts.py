"""The LSTM launch, call and route counts stay exact when several threads
run LSTM networks at once (a `ModelServer` with `max_concurrent > 1`):
every increment goes through `ops.lstm.count`, under `_COUNT_LOCK`, as the
paged and flash wrappers' do. Threads bump the counts through the real
entry points (the fused route on CPU tensors runs the plain versions, the
plain loop for other activations) and through the kernel wrappers' own
counting, with the interpreter switching threads as often as it can."""
import sys
import threading

import pytest
import torch

from deeplearning4j_tpu_torch.nn.layers.recurrent import lstm_forward
from deeplearning4j_tpu_torch.ops import lstm as L


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread while this module runs: the tier runs
    several pytest-xdist workers on one host, and torch's default of a
    thread per core in each of them oversubscribes the cores, so that
    every small op waits for descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def busy_switching():
    """Switch threads as often as the interpreter allows, so that an
    unlocked read-add-write would lose increments."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    L.reset_counts()
    routes = dict(lstm_forward.routes)
    lstm_forward.routes.update({"fused": 0, "loop": 0})
    yield
    sys.setswitchinterval(old)
    L.reset_counts()
    lstm_forward.routes.update(routes)


def _run_threads(n, fn):
    errors = []
    barrier = threading.Barrier(n)

    def body(i):
        try:
            barrier.wait()
            fn(i)
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def _layer(seed, B=2, T=3, n_in=3, H=4):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: (0.3 * torch.randn(*s, generator=g)).requires_grad_()
    return (r(B, T, n_in), r(n_in, 4 * H), r(H, 4 * H), r(4 * H),
            (r(H), r(H), r(H)))


def test_entry_point_counts_exact_from_many_threads(busy_switching):
    threads, calls = 8, 6

    def work(i):
        x, W, RW, b, peep = _layer(i)
        for k in range(calls):
            fused = k % 2 == 0
            out, _ = lstm_forward(
                x, W, RW, b, peep,
                torch.sigmoid if fused else torch.nn.functional.hardsigmoid,
                torch.tanh, gate_is_sigmoid=fused, cell_is_tanh=True,
                reverse=k % 3 == 0)
            out.sum().backward()

    _run_threads(threads, work)
    fused = threads * ((calls + 1) // 2)
    assert lstm_forward.routes == {"fused": fused,
                                   "loop": threads * calls - fused}
    assert L.lstm_fwd_plain.calls == fused
    assert L.lstm_bwd_plain.calls == fused
    assert L.launches == {}


def test_kernel_launch_counts_exact_from_many_threads(busy_switching):
    """The wrappers' `_count` (one launch, by key and by route) and the
    plain versions' call counts, bumped from 16 threads."""
    threads, n = 16, 2000

    def work(i):
        for k in range(n):
            L._count("fwd" if k % 2 else "bwd", k % 3 == 0, False,
                     "bf16 clusters")
            L.count((L.lstm_fwd_plain, "calls"),
                    (lstm_forward.routes, "loop"))

    _run_threads(threads, work)
    total = threads * n
    assert sum(L.launches.values()) == total
    assert L.launches[("fwd", True, False)] + \
        L.launches[("fwd", False, False)] == total // 2
    assert L.launches_by_route == {("fwd", "bf16 clusters"): total // 2,
                                   ("bwd", "bf16 clusters"): total // 2}
    assert L.lstm_fwd_plain.calls == total
    assert lstm_forward.routes["loop"] == total
