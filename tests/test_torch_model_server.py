"""The port's `ModelServer` held against the JAX package's on the CPU.

The reference's serving ladders (`tests/test_serving.py`) on its
Dense -> Output network, loaded into both packages from one zip:
predict equal to the reference server's; micro-batch coalescing;
overload shed with `retry_after`; deadlines shed before the device; the
circuit breaker open, half-open and closed, a failed probe re-opening
it, non-finite outputs counted as failures; atomic hot reload with
in-flight requests finishing on the old model; corrupt, truncated,
poisoned and width-changing candidates refused with the old model
serving; the fallback past a corrupt newest checkpoint; auto-canary;
drain on shutdown. Then the quantized-weights drift gate on a small GPT
(the report equal to the reference's) and the stats schema.

Ordering uses `threading.Event` gates inside the servers' own hooks;
every wait has its own short bound.
"""
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import deeplearning4j_tpu as dl4j  # noqa: E402
from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet  # noqa: E402
from deeplearning4j_tpu.models.transformer import (  # noqa: E402
    gpt_configuration as jax_gpt_configuration,
)
from deeplearning4j_tpu.nn.conf.layers import (  # noqa: E402
    DenseLayer as JaxDense,
    OutputLayer as JaxOutput,
)
from deeplearning4j_tpu.ops.activations import Activation as JaxAct  # noqa: E402
from deeplearning4j_tpu.ops.losses import LossFunction as JaxLoss  # noqa: E402
from deeplearning4j_tpu.serving import ModelServer as JaxServer  # noqa: E402
from deeplearning4j_tpu.serving import (  # noqa: E402
    CircuitBreaker as JaxBreaker,
)
from deeplearning4j_tpu.util.checkpoint_store import (  # noqa: E402
    CheckpointStore as JaxStore,
)
from deeplearning4j_tpu.util.serialization import (  # noqa: E402
    write_model as jax_write_model,
)
from deeplearning4j_tpu_torch.serving import (  # noqa: E402
    CircuitBreaker,
    DeadlineExceededError,
    InferenceFailedError,
    ModelServer,
    ModelValidationError,
    ServerClosedError,
    ServerOverloadedError,
    ServiceUnavailableError,
)
from deeplearning4j_tpu_torch.serving.observability import (  # noqa: E402
    MODEL_SERVER_STATS_KEYS,
)
from deeplearning4j_tpu_torch.util.checkpoint_store import (  # noqa: E402
    CheckpointCorruptError,
    CheckpointStore,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    restore_model,
    write_model,
)


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


WAIT = 10.0  # the bound of every wait on another thread


def _wait_until(pred, what: str, timeout: float = WAIT) -> None:
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


class Gate:
    """An infer hook that holds each device step at `phase` (inside the
    server's read lock) until `release` is set; `entered` is set when a
    step is held, and `seen` keeps every step's info."""

    def __init__(self, phase: str = "pre_step"):
        self.phase = phase
        self.entered = threading.Event()
        self.release = threading.Event()
        self.seen = []

    def __call__(self, phase, info):
        if phase == self.phase:
            self.seen.append(dict(info))
            self.entered.set()
            if not self.release.wait(WAIT):
                raise TimeoutError("gate never released")


class Broken:
    """An infer hook that fails every step while armed."""

    def __init__(self):
        self.armed = True

    def __call__(self, phase, info):
        if phase == "pre_step" and self.armed:
            raise RuntimeError("injected step failure")


def _jax_conf(n_out=3, seed=7):
    return (dl4j.NeuralNetConfiguration.Builder()
            .seed(seed).learning_rate(0.3)
            .list()
            .layer(JaxDense(n_in=4, n_out=8))
            .layer(JaxOutput(n_in=8, n_out=n_out,
                             activation=JaxAct.SOFTMAX,
                             loss=JaxLoss.MCXENT))
            .build())


def _data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 3, n)
    x = (rng.normal(size=(n, 4)) + c[:, None]).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[c]


def _jax_net(seed=7, n_out=3, fit_epochs=0):
    net = dl4j.MultiLayerNetwork(_jax_conf(n_out=n_out, seed=seed))
    net.init()
    if fit_epochs:
        x, y = _data(48, seed=seed)
        net.fit(JaxDataSet(x, y), epochs=fit_epochs)
    return net


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX net, port net) with the same weights, through one zip."""
    jnet = _jax_net()
    path = tmp_path_factory.mktemp("live") / "live.zip"
    jax_write_model(jnet, path)
    return jnet, restore_model(path, device="cpu")


@pytest.fixture(scope="module")
def candidate(tmp_path_factory):
    """A fitted candidate, committed to one checkpoint store that both
    packages read: (JAX net, store directory)."""
    jnet = _jax_net(seed=1, fit_epochs=5)
    d = tmp_path_factory.mktemp("store")
    CheckpointStore(d).save(1, lambda tmp: jax_write_model(jnet, tmp,
                                                           atomic=False))
    return jnet, d


@pytest.fixture()
def x():
    return _data()[0]


@pytest.fixture()
def servers():
    made = []

    def make(net, cls=ModelServer, **kw):
        srv = cls(net, **kw)
        made.append(srv)
        return srv

    yield make
    for srv in made:
        srv.shutdown(drain_timeout=5.0)


def _out(pnet, x):
    return pnet.output(x).numpy()


# ---------------------------------------------------------------- predict
@pytest.mark.parametrize("rows", [1, 5, 32])
def test_predict_matches_the_jax_server(pair, servers, x, rows):
    jnet, pnet = pair
    got = servers(pnet).predict(x[:rows])
    want = servers(jnet, cls=JaxServer).predict(x[:rows])
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_predict_rejects_unbatched_input(pair, servers, x):
    with pytest.raises(ValueError, match="batched"):
        servers(pair[1]).predict(x[0])


def test_concurrent_predicts_coalesce_into_fewer_steps(pair, servers, x):
    """While one step is held on the device, queued compatible requests
    assemble into one step: fewer steps than requests, each result its
    own rows."""
    gate = Gate()
    srv = servers(pair[1], infer_hooks=[gate], max_batch_size=32,
                  max_queue=32)
    results = [None] * 7

    def call(i):
        results[i] = srv.predict(x[i:i + 1], timeout=30)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(7)]
    threads[0].start()
    assert gate.entered.wait(WAIT)
    for t in threads[1:]:
        t.start()
    _wait_until(lambda: srv.stats()["queued"] == 6, "6 queued requests")
    gate.release.set()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    stats = srv.stats()
    assert stats["served"] == 7 and stats["batches"] == 2
    assert [s["requests"] for s in gate.seen] == [1, 6]
    assert [s["padded_size"] for s in gate.seen] == [1, 8]
    for i, r in enumerate(results):
        np.testing.assert_allclose(r, _out(pair[1], x[i:i + 1]), atol=1e-6)


def test_overload_sheds_typed_with_retry_after_then_recovers(pair, servers,
                                                             x):
    gate = Gate()
    srv = servers(pair[1], max_queue=3, max_batch_size=2,
                  infer_hooks=[gate])
    outcomes, lock = [], threading.Lock()

    def flood():
        try:
            out = srv.predict(x[:2], timeout=30)
            with lock:
                outcomes.append(("ok", out.shape))
        except ServerOverloadedError as e:
            with lock:
                outcomes.append(("shed", e.retry_after))

    first = threading.Thread(target=flood)
    first.start()
    assert gate.entered.wait(WAIT)
    threads = [threading.Thread(target=flood) for _ in range(8)]
    for t in threads:
        t.start()
    # the held step keeps the queue from draining: 3 queue, 5 are shed
    _wait_until(lambda: srv.stats()["queued"] == 3
                and srv.stats()["shed_overload"] == 5, "a full queue")
    gate.release.set()
    for t in [first, *threads]:
        t.join(WAIT)
        assert not t.is_alive()
    served = [o for o in outcomes if o[0] == "ok"]
    shed = [o for o in outcomes if o[0] == "shed"]
    assert len(served) + len(shed) == 9 and len(shed) == 5
    assert all(r > 0 for _, r in shed)
    assert all(shape == (2, 3) for _, shape in served)
    stats = srv.stats()
    assert stats["served"] == 4 and stats["shed_overload"] == 5
    assert srv.predict(x, timeout=5).shape == (32, 3)
    assert srv.stats()["queued"] == 0


def test_expired_request_shed_before_the_device(pair, servers, x):
    """A request whose deadline passes while the device is busy is shed
    typed when the executor next assembles, and never dispatched."""
    gate = Gate()
    srv = servers(pair[1], infer_hooks=[gate], max_queue=8)
    held = threading.Thread(target=lambda: srv.predict(x, timeout=30))
    held.start()
    assert gate.entered.wait(WAIT)
    errors = []

    def doomed():
        try:
            srv.predict(x[:5], timeout=0.05)
        except DeadlineExceededError as e:
            errors.append(e)

    t = threading.Thread(target=doomed)
    t.start()
    _wait_until(lambda: srv.stats()["queued"] == 1, "the doomed request")
    time.sleep(0.06)  # its deadline passes while the step is held
    gate.release.set()
    for th in (held, t):
        th.join(WAIT)
        assert not th.is_alive()
    assert len(errors) == 1
    assert errors[0].trace["decision"] == "DeadlineExceededError"
    assert srv.stats()["shed_deadline"] == 1
    assert 5 not in [s["batch_size"] for s in gate.seen]


def test_an_already_expired_request_is_shed_at_the_door(pair, servers, x):
    srv = servers(pair[1])
    with pytest.raises(DeadlineExceededError, match="door"):
        srv.predict(x, timeout=0.0)
    assert srv.stats()["batches"] == 0


def test_a_full_queue_sweeps_expired_entries_before_shedding(pair, servers,
                                                             x):
    """Expired requests padding a full queue fail with their own
    DeadlineExceededError; the live request is admitted, not shed."""
    gate = Gate()
    srv = servers(pair[1], infer_hooks=[gate], max_queue=2)
    errors = []

    def doomed():
        try:
            srv.predict(x[:1], timeout=0.2)
        except DeadlineExceededError as e:
            errors.append(e)

    holder = threading.Thread(target=lambda: srv.predict(x, timeout=30))
    holder.start()
    assert gate.entered.wait(WAIT)
    doomed_threads = [threading.Thread(target=doomed) for _ in range(2)]
    for t in doomed_threads:
        t.start()
    _wait_until(lambda: srv.stats()["queued"] == 2, "a full queue")
    time.sleep(0.25)  # both queued deadlines pass
    live = threading.Thread(target=lambda: srv.predict(x[:3], timeout=30))
    live.start()
    for t in doomed_threads:
        t.join(WAIT)
    gate.release.set()
    for t in (holder, live):
        t.join(WAIT)
        assert not t.is_alive()
    stats = srv.stats()
    assert len(errors) == 2 and stats["shed_overload"] == 0
    assert stats["shed_deadline"] == 2 and stats["served"] == 2


def test_batch_assembly_bounded_by_the_earliest_deadline(pair, servers, x):
    srv = servers(pair[1], batch_window=10.0)
    t0 = time.monotonic()
    assert srv.predict(x, timeout=0.5).shape == (32, 3)
    assert time.monotonic() - t0 < 5.0


# ------------------------------------------------------------ the breaker
def test_breaker_opens_fails_fast_half_opens_closes(pair, servers, x):
    brk = Broken()
    srv = servers(pair[1], infer_hooks=[brk], breaker_threshold=3,
                  breaker_reset_timeout=0.2)
    for _ in range(3):
        with pytest.raises(InferenceFailedError, match="injected"):
            srv.predict(x)
    assert srv.breaker.state == "open"
    batches = srv.stats()["batches"]
    t0 = time.monotonic()
    with pytest.raises(ServiceUnavailableError) as ei:
        srv.predict(x)
    assert time.monotonic() - t0 < 0.15 and ei.value.retry_after > 0
    assert srv.stats()["batches"] == batches  # the device was not touched
    brk.armed = False
    _wait_until(lambda: srv.breaker.state == "half_open", "half-open")
    assert srv.predict(x).shape == (32, 3)
    stats = srv.stats()
    assert stats["breaker_state"] == "closed" and stats["breaker_opens"] == 1
    assert stats["failures"] == 3 and stats["shed_unavailable"] == 1
    events = [e["state"] for e in srv.flight_record()["events"]
              if e["kind"] == "breaker"]
    assert events == ["open", "half_open", "closed"]


def test_breaker_failed_probe_reopens(pair, servers, x):
    brk = Broken()
    srv = servers(pair[1], infer_hooks=[brk], breaker_threshold=2,
                  breaker_reset_timeout=0.2)
    for _ in range(2):
        with pytest.raises(InferenceFailedError):
            srv.predict(x)
    _wait_until(lambda: srv.breaker.state == "half_open", "half-open")
    with pytest.raises(InferenceFailedError):
        srv.predict(x)  # the probe, still broken
    assert srv.breaker.state == "open"
    assert srv.stats()["breaker_opens"] == 2
    brk.armed = False
    _wait_until(lambda: srv.breaker.state == "half_open", "half-open")
    assert srv.predict(x).shape == (32, 3)
    assert srv.breaker.state == "closed"


def test_non_finite_outputs_count_as_breaker_failures(pair, servers, x):
    poisoned = pair[1].clone()
    poisoned.set_params(torch.full_like(poisoned.params(), float("nan")))
    srv = servers(poisoned, breaker_threshold=2, breaker_reset_timeout=60.0)
    for _ in range(2):
        with pytest.raises(InferenceFailedError, match="non-finite"):
            srv.predict(x)
    assert srv.breaker.state == "open"
    with pytest.raises(ServiceUnavailableError):
        srv.predict(x)


_BREAKER_SCRIPT = ["fail", "fail", "state", "acquire", "fail_probe",
                   "state", "wait", "acquire", "acquire_again", "ok_probe",
                   "state", "fail", "ok", "fail", "state"]


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_circuit_breaker_follows_the_jax_class_step_for_step(threshold):
    """The same script of outcomes through both breakers: the same
    states, the same refusals, the same transition events."""
    logs = []
    for cls in (CircuitBreaker, JaxBreaker):
        log, events = [], []
        b = cls(failure_threshold=threshold, reset_timeout=0.3,
                on_event=events.append)
        probe = False
        for step in _BREAKER_SCRIPT:
            try:
                if step == "fail":
                    b.record_failure()
                elif step == "ok":
                    b.record_success()
                elif step == "state":
                    log.append(b.state)
                elif step == "wait":
                    time.sleep(0.35)
                elif step in ("acquire", "acquire_again"):
                    if step == "acquire":
                        time.sleep(0.35)
                    probe = b.acquire()
                    log.append(("probe", probe))
                elif step == "fail_probe":
                    b.record_failure(probe)
                elif step == "ok_probe":
                    b.record_success(probe)
            except Exception as e:  # a typed refusal is part of the log
                log.append(type(e).__name__)
        logs.append((log, events, b.opens))
    assert logs[0] == logs[1]


def test_circuit_breaker_validates_its_arguments():
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)
    with pytest.raises(ValueError):
        CircuitBreaker(reset_timeout=0)


# ------------------------------------------------------------- hot reload
def test_hot_reload_swaps_atomically_like_jax(pair, candidate, servers, x):
    cnet, d = candidate
    srv = servers(pair[1], canary=x[:2])
    jsrv = servers(pair[0], cls=JaxServer, canary=x[:2])
    before = srv.predict(x)
    assert srv.reload(CheckpointStore(d)) == 1
    assert jsrv.reload(JaxStore(d)) == 1
    after = srv.predict(x)
    assert not np.allclose(before, after)
    np.testing.assert_allclose(after, jsrv.predict(x), atol=1e-6)
    np.testing.assert_allclose(after, np.asarray(cnet.output(x)), atol=1e-5)
    assert srv.net.device.type == "cpu"  # restored on the live device
    stats = srv.stats()
    assert stats["reloads"] == 1 and stats["model_version"] == 1
    decisions = [e.get("decision") for e in srv.flight_record()["events"]
                 if e["kind"] == "reload"]
    assert decisions == ["complete"]


def test_inflight_requests_finish_on_the_old_model(pair, candidate, servers,
                                                   x):
    """A request held on the device when reload() lands is answered by
    the old model (the reload waits on the write lock); the next one
    sees the candidate."""
    cnet, d = candidate
    gate = Gate()
    srv = servers(pair[1], canary=x[:2], infer_hooks=[gate])
    gate.release.set()
    srv.predict(x[:2])  # warm, and let the canary's own steps through
    gate.release.clear()
    gate.entered.clear()
    got = {}
    t = threading.Thread(target=lambda: got.update(out=srv.predict(x)))
    t.start()
    assert gate.entered.wait(WAIT)
    r = threading.Thread(
        target=lambda: got.update(version=srv.reload(CheckpointStore(d))))
    r.start()
    _wait_until(lambda: srv._rwlock._writers_waiting == 1,
                "the reload waiting on the write lock")
    gate.release.set()
    for th in (t, r):
        th.join(WAIT)
        assert not th.is_alive()
    np.testing.assert_allclose(got["out"], _out(pair[1], x), atol=1e-6)
    assert got["version"] == 1
    np.testing.assert_allclose(srv.predict(x), np.asarray(cnet.output(x)),
                               atol=1e-5)


def _corrupt(path):
    data = bytearray(path.read_bytes())
    mid = len(data) // 2
    for i in range(mid, min(mid + 16, len(data))):
        data[i] ^= 0xFF
    path.write_bytes(bytes(data))


def _truncate(path):
    path.write_bytes(path.read_bytes()[:100])


@pytest.mark.parametrize("damage", [_corrupt, _truncate])
def test_damaged_candidate_refused_old_model_serves(pair, servers, x,
                                                    tmp_path, damage):
    store = CheckpointStore(tmp_path)
    path = store.save(1, lambda tmp: jax_write_model(_jax_net(seed=1), tmp,
                                                     atomic=False))
    damage(path)
    srv = servers(pair[1], canary=x[:2])
    before = srv.predict(x)
    with pytest.raises(CheckpointCorruptError):
        srv.reload(store, step=1)
    np.testing.assert_allclose(srv.predict(x), before, atol=0)
    stats = srv.stats()
    assert stats["model_version"] == 0 and stats["reload_rejections"] == 1


def _poison(store, step, jnet):
    clone = dl4j.MultiLayerNetwork(jnet.conf)
    clone.init()
    clone.set_params(np.full_like(np.asarray(clone.params()), np.nan))
    return store.save(step, lambda tmp: jax_write_model(clone, tmp,
                                                        atomic=False))


def test_poisoned_candidate_refused_by_the_canary(pair, servers, x,
                                                  tmp_path):
    store = CheckpointStore(tmp_path)
    _poison(store, 1, pair[0])
    srv = servers(pair[1], canary=x[:2])
    before = srv.predict(x)
    with pytest.raises(ModelValidationError, match="non-finite"):
        srv.reload(store, step=1)
    stats = srv.stats()
    assert stats["reload_rejections"] == 1 and stats["model_version"] == 0
    np.testing.assert_allclose(srv.predict(x), before, atol=0)
    events = [e for e in srv.flight_record()["events"]
              if e["kind"] == "reload"]
    assert events[-1]["decision"] == "rejected"
    assert events[-1]["error"] == "ModelValidationError"


def test_reload_falls_back_past_a_corrupt_newest(pair, candidate, servers,
                                                 x, tmp_path):
    cnet, _ = candidate
    store = CheckpointStore(tmp_path)
    store.save(1, lambda tmp: jax_write_model(cnet, tmp, atomic=False))
    bad = store.save(2, lambda tmp: jax_write_model(_jax_net(seed=3), tmp,
                                                    atomic=False))
    _corrupt(bad)
    srv = servers(pair[1], canary=x[:2])
    assert srv.reload(store) == 1
    np.testing.assert_allclose(srv.predict(x), np.asarray(cnet.output(x)),
                               atol=1e-5)


def test_width_changing_candidate_refused(pair, servers, x, tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, lambda tmp: jax_write_model(_jax_net(seed=1, n_out=5),
                                              tmp, atomic=False))
    srv = servers(pair[1], canary=x[:2])
    srv.predict(x)
    with pytest.raises(ModelValidationError, match="output shape"):
        srv.reload(store, step=1)
    assert srv.stats()["model_version"] == 0


def test_auto_canary_arms_reload_validation(pair, servers, x, tmp_path):
    """Without an explicit canary, the first served request donates its
    first row: a poisoned reload is still caught."""
    store = CheckpointStore(tmp_path)
    _poison(store, 1, pair[0])
    srv = servers(pair[1])
    assert srv.probe() is None  # no canary yet: inconclusive
    srv.predict(x)
    np.testing.assert_array_equal(srv._canary, x[:1])
    with pytest.raises(ModelValidationError):
        srv.reload(store, step=1)
    assert srv.probe() is True


def test_reload_from_a_path_with_and_without_a_manifest(pair, candidate,
                                                        servers, x,
                                                        tmp_path):
    cnet, d = candidate
    srv = servers(pair[1], canary=x[:2])
    (path,) = sorted(p for p in d.iterdir() if p.suffix == ".zip")
    assert srv.reload(path) == 1  # manifest verified
    bare = tmp_path / "bare.zip"
    write_model(pair[1], bare)  # no manifest: loaded unverified
    assert srv.reload(bare) == 2
    np.testing.assert_allclose(srv.predict(x), _out(pair[1], x), atol=0)


def test_restore_model_swaps_back_without_a_canary(pair, candidate,
                                                   servers, x):
    cnet, d = candidate
    srv = servers(pair[1], canary=x[:2])
    old = srv.net
    srv.reload(CheckpointStore(d))
    assert srv.restore_model(old) == 2
    np.testing.assert_allclose(srv.predict(x), _out(pair[1], x), atol=0)
    assert [e["decision"] for e in srv.flight_record()["events"]
            if e["kind"] == "reload"] == ["complete", "rolled-back"]


# --------------------------------------------------------------- shutdown
def test_shutdown_drains_then_rejects(pair, servers, x):
    gate = Gate()
    srv = servers(pair[1], infer_hooks=[gate], max_queue=8)
    results = []

    def call():
        results.append(srv.predict(x[:2], timeout=30).shape)

    threads = [threading.Thread(target=call) for _ in range(3)]
    threads[0].start()
    assert gate.entered.wait(WAIT)
    for t in threads[1:]:
        t.start()
    _wait_until(lambda: srv.pending() == 3, "three pending requests")
    gate.release.set()
    assert srv.shutdown(drain_timeout=WAIT) is True
    for t in threads:
        t.join(WAIT)
    assert results == [(2, 3)] * 3
    with pytest.raises(ServerClosedError):
        srv.predict(x)
    assert srv.shutdown() is True  # idempotent


def test_shutdown_times_out_and_fails_the_queue(pair, servers, x):
    gate = Gate()
    srv = servers(pair[1], infer_hooks=[gate], max_queue=8,
                  max_batch_size=2)
    errors = []

    def call():
        try:
            srv.predict(x[:2], timeout=30)
        except ServerClosedError as e:
            errors.append(e)

    threads = [threading.Thread(target=call) for _ in range(2)]
    threads[0].start()
    assert gate.entered.wait(WAIT)
    threads[1].start()
    _wait_until(lambda: srv.stats()["queued"] == 1, "one queued request")
    assert srv.shutdown(drain_timeout=0.1) is False
    gate.release.set()
    for t in threads:
        t.join(WAIT)
    assert len(errors) == 1


# ------------------------------------------------ stats and observability
def test_stats_keys_match_the_jax_server(pair, servers, x):
    srv = servers(pair[1])
    jsrv = servers(pair[0], cls=JaxServer)
    srv.predict(x)
    jsrv.predict(x)
    got, want = srv.stats(), jsrv.stats()
    assert set(got) == set(want)
    assert MODEL_SERVER_STATS_KEYS <= set(got)
    for k in ("served", "batches", "batch_fill_pct", "model_version",
              "breaker_state", "weight_bits", "queued", "in_flight"):
        assert got[k] == want[k], k


def test_metrics_and_flight_record_carry_predicts_and_sheds(pair, servers,
                                                            x):
    srv = servers(pair[1], max_queue=1)
    srv.predict(x)
    with pytest.raises(DeadlineExceededError):
        srv.predict(x, timeout=-1.0)
    text = srv.metrics_text(labels={"model": "m"})
    assert 'dl4j_model_server_predict_latency_ms_count{model="m"} 1' in text
    assert 'dl4j_stats_model_server_served{model="m"} 1' in text
    snap = srv.metrics_snapshot()
    assert snap["histograms"]["model_server_step_ms"]["count"] == 1
    dump = srv.flight_record()
    assert [r["decision"] for r in dump["requests"]] \
        == ["served", "DeadlineExceededError"]
    names = [s["name"] for s in dump["requests"][0]["trace"]["spans"]]
    assert sorted(names) == ["admission", "device-step", "queue-wait"]
    assert dump["failures"][0]["decision"] == "DeadlineExceededError"


@pytest.mark.parametrize("kw,err", [
    ({"max_queue": 0}, ValueError),
    ({"max_concurrent": 0}, ValueError),
    ({"max_batch_size": 0}, ValueError),
    ({"quantize": {"weights": "int4"}}, ValueError),
    ({"quantize": {"kv": "fp8"}}, ValueError),
    ({"quantize": {"activations": "int8"}}, ValueError),
    ({"quantize": {"weights": "int8"},
      "drift_gate": {"max_argmax_drift": 0.1}}, ValueError),
    ({"drift_gate": {"eval_set": [[1]], "max_drift": 0.1}}, ValueError),
    ({"parallel": {"tp": 2}}, NotImplementedError),
])
def test_server_refuses_bad_configuration(pair, kw, err):
    with pytest.raises(err):
        ModelServer(pair[1], **kw)


def test_generation_and_cluster_methods_without_an_engine(pair, servers, x):
    srv = servers(pair[1])
    with pytest.raises(RuntimeError, match="generation"):
        srv.generate(np.arange(4), 2)
    assert srv.migrate_slots() == 0
    assert srv.prefix_depth(np.arange(4)) == 0
    assert srv.prefix_chains() == {}
    for call in (lambda: srv.set_tenant_quota("t", rate=1.0),
                 lambda: srv.fetch_handoff("h"),
                 lambda: srv.commit_handoff("h"),
                 lambda: srv.abort_handoff("h"),
                 lambda: srv.resume_generate({}),
                 lambda: srv.bind_prefix_directory(None, "me"),
                 lambda: srv.export_prefix(np.arange(4)),
                 lambda: srv.fetch_handoff_header("h"),
                 lambda: srv.fetch_handoff_frame("h", 0)):
        with pytest.raises(NotImplementedError, match="A11"):
            call()


# ----------------------------------------------- quantized weights, drift
VOCAB = 48


@pytest.fixture(scope="module")
def gpt_pair(tmp_path_factory):
    jnet = dl4j.MultiLayerNetwork(jax_gpt_configuration(
        vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, max_length=64,
        seed=12345))
    jnet.init()
    path = tmp_path_factory.mktemp("gpt") / "gpt.zip"
    jax_write_model(jnet, path)
    return jnet, restore_model(path, device="cpu"), path


def _eval_ids():
    return np.random.default_rng(9).integers(0, VOCAB, (2, 12)) \
        .astype(np.int32)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_drift_report_matches_the_jax_server(gpt_pair, servers, mode):
    jnet, pnet, _ = gpt_pair
    gate = {"eval_set": _eval_ids(), "max_argmax_drift": 0.5,
            "max_ppl_delta": 1.0}
    srv = servers(pnet, quantize={"weights": mode}, drift_gate=gate)
    jsrv = servers(jnet, cls=JaxServer, quantize={"weights": mode},
                   drift_gate=gate)
    got, want = srv.stats(), jsrv.stats()
    assert got["weight_bits"] == want["weight_bits"]
    assert got["drift_gate_checks"] == 1 and got["drift_gate_failures"] == 0
    assert set(got["drift"]) == set(want["drift"])
    for k in got["drift"]:
        assert abs(got["drift"][k] - want["drift"][k]) <= 1e-6, k
    events = [e for e in srv.flight_record()["events"]
              if e["kind"] == "drift-gate"]
    assert events[-1]["decision"] == "accepted"
    np.testing.assert_allclose(srv.predict(_eval_ids()),
                               jsrv.predict(_eval_ids()), atol=1e-5)


def test_drift_gate_refuses_a_breach_at_construction(gpt_pair):
    _, pnet, _ = gpt_pair
    probe = ModelServer(pnet, quantize={"weights": "int8"},
                        drift_gate={"eval_set": _eval_ids()})
    try:
        measured = probe.stats()["drift"]["ppl_delta"]
    finally:
        probe.shutdown()
    with pytest.raises(ModelValidationError, match="drift gate"):
        ModelServer(pnet, quantize={"weights": "int8"},
                    drift_gate={"eval_set": _eval_ids(),
                                "max_ppl_delta": measured - 1e-3})


def test_drift_gate_refuses_a_reload_candidate(gpt_pair, servers, tmp_path):
    """A quantized reload candidate passes the gate and records its
    drift; with the gate set below that measured drift, the same
    candidate is refused and the serving weights and version stay."""
    _, pnet, _ = gpt_pair
    srv = servers(pnet, quantize={"weights": "int8"},
                  drift_gate={"eval_set": _eval_ids(),
                              "max_argmax_drift": 0.5,
                              "max_ppl_delta": 1.0})
    other = dl4j.MultiLayerNetwork(jax_gpt_configuration(
        vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=2, max_length=64,
        seed=777))
    other.init()
    store = CheckpointStore(tmp_path)
    store.save(1, lambda tmp: jax_write_model(other, tmp, atomic=False))
    assert srv.reload(store) == 1
    measured = srv.stats()["drift"]["ppl_delta"]
    after = srv.predict(_eval_ids())
    srv._drift_gate["max_ppl_delta"] = measured - 1e-3
    with pytest.raises(ModelValidationError, match="drift gate"):
        srv.reload(store)
    stats = srv.stats()
    assert stats["model_version"] == 1 and stats["drift_gate_failures"] == 1
    assert stats["drift_gate_checks"] == 3 and stats["reload_rejections"] == 1
    np.testing.assert_allclose(srv.predict(_eval_ids()), after, atol=0)
