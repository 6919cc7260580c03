"""Chaos suite for the port's elastic distributed-training tier
(`parallel.training_master`, `parallel.fault_tolerance`,
`parallel.early_stopping`), held against the JAX package on the CPU at
small size (4 features, 8 hidden units, 3 classes).

Crashed workers re-dispatch and the result equals a healthy run (and the
JAX package's healthy run); a persistently failing worker is dropped and
the window re-runs over the survivors, equal to a smaller healthy master;
a non-finite worker result is quarantined, never averaged in; stragglers
trip the timeout; give-up paths raise cleanly; `FaultTolerantTrainer`
restores the newest checkpoint that verifies and finishes with the JAX
package's parameters; parallel early stopping over the 8-slot mesh
terminates as the JAX package's does over its 8 devices. Tolerances:
parameters 1e-6 absolute and scores 1e-6 relative (SGD throughout).
Injected faults are asserted through `caplog` on the
`deeplearning4j_tpu_torch` logger. Every test bounds its own wall time.
"""
import logging
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from deeplearning4j_tpu.datasets.dataset import DataSet as JDataSet  # noqa: E402
from deeplearning4j_tpu.datasets.iterators import (  # noqa: E402
    ListDataSetIterator as JList,
)
from deeplearning4j_tpu.nn import conf as JC  # noqa: E402
from deeplearning4j_tpu.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork as JNet,
)
from deeplearning4j_tpu.parallel import fault_tolerance as jft  # noqa: E402
from deeplearning4j_tpu.parallel import training_master as jtm  # noqa: E402
from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: E402
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: E402
    ListDataSetIterator,
)
from deeplearning4j_tpu_torch.nn import conf as PC  # noqa: E402
from deeplearning4j_tpu_torch.nn.multilayer import (  # noqa: E402
    MultiLayerNetwork,
)
from deeplearning4j_tpu_torch.parallel.fault_tolerance import (  # noqa: E402
    CheckpointCrashInjector,
    FaultInjectionListener,
    FaultTolerantTrainer,
    InjectedFault,
    NaNGradientInjector,
    PoisonBatchInjector,
    SlowWorkerInjector,
    WorkerCrashInjector,
)
from deeplearning4j_tpu_torch.parallel.training_master import (  # noqa: E402
    DistributedMultiLayer,
    NoHealthyWorkersError,
    ParameterAveragingTrainingMaster,
    ParameterAveragingTrainingWorker,
    TrainingHook,
    WorkerFailureError,
)
from deeplearning4j_tpu_torch.util.serialization import (  # noqa: E402
    params_from_jax,
    restore_model,
)

LOGGER = "deeplearning4j_tpu_torch"
ATOL = 1e-6


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


@pytest.fixture(autouse=True)
def _bounded_wall():
    t0 = time.monotonic()
    yield
    assert time.monotonic() - t0 < 60.0


def _conf(C, seed=12345, lr=0.1):
    return (C.NeuralNetConfiguration.Builder().seed(seed).learning_rate(lr)
            .list()
            .layer(C.DenseLayer(n_in=4, n_out=8, activation="tanh"))
            .layer(C.OutputLayer(n_in=8, n_out=3, activation="softmax",
                                 loss="mcxent"))
            .build())


def _pair(**kw):
    jnet = JNet(_conf(JC, **kw))
    jnet.init()
    pconf = _conf(PC, **kw)
    pnet = MultiLayerNetwork(pconf, device="cpu")
    pnet.set_param_tree(params_from_jax(pconf, jnet._params))
    return jnet, pnet


def _net(**kw):
    return _pair(**kw)[1]


def _arrays(n, batch=16, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, 4).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n)]


def _batches(n, batch=16, seed=0):
    return [DataSet(f, l) for f, l in _arrays(n, batch, seed)]


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _master(net, num_workers, injector=None, **kw):
    worker = ParameterAveragingTrainingWorker(net)
    if injector is not None:
        worker.add_hook(injector)
    kw.setdefault("averaging_frequency", 2)
    kw.setdefault("collect_training_stats", True)
    return ParameterAveragingTrainingMaster(num_workers=num_workers,
                                            worker=worker, **kw)


# ---------------------------------------------------------------- crashes
def test_transient_crash_redispatches_and_matches_healthy_run(caplog):
    """Worker 3 of 4 crashes once; its shard re-dispatches and the final
    parameters equal the healthy 4-worker run, and the JAX package's."""
    arrs = _arrays(8, seed=2)
    jnet, healthy = _pair()
    jtm.ParameterAveragingTrainingMaster(
        num_workers=4, averaging_frequency=2).execute_training(
        jnet, JList([JDataSet(f, l) for f, l in arrs]))
    batches = [DataSet(f, l) for f, l in arrs]
    _master(healthy, 4).execute_training(healthy,
                                         ListDataSetIterator(batches))
    crashy = _net()
    injector = WorkerCrashInjector(worker_id=3, fail_at_fit=1, times=1)
    master = _master(crashy, 4, injector=injector)
    s0 = crashy.score(batches[0])
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        DistributedMultiLayer(crashy, master).fit(
            ListDataSetIterator(batches))
    assert injector.fired == 1
    np.testing.assert_array_equal(_np(crashy.params()),
                                  _np(healthy.params()))
    np.testing.assert_allclose(_np(crashy.params()),
                               np.asarray(jnet.params()), rtol=0, atol=ATOL)
    assert crashy.score(batches[0]) < s0
    assert all(h.alive for h in master.worker_health)
    stats = master.get_training_stats()
    assert stats.get_count("worker_failures") == 1
    assert stats.get_count("worker_retries") == 1
    assert stats.get_count("workers_dropped") == 0
    assert any("injected crash on worker 3" in r.message
               for r in caplog.records)
    assert any("re-dispatching shard" in r.message for r in caplog.records)


def test_persistent_crash_shrinks_pool_with_averaging_parity(caplog):
    batches = _batches(6, seed=3)
    healthy3 = _net()
    _master(healthy3, 3).execute_training(healthy3,
                                          ListDataSetIterator(batches))
    degraded = _net()
    injector = WorkerCrashInjector(worker_id=3, fail_at_fit=1, times=999)
    master = _master(degraded, 4, injector=injector, max_retries=0,
                     retry_backoff=0.0)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        master.execute_training(degraded, ListDataSetIterator(batches))
    np.testing.assert_allclose(_np(degraded.params()),
                               _np(healthy3.params()), rtol=0, atol=1e-7)
    assert not master.worker_health[3].alive
    assert len(master.alive_workers()) == 3
    stats = master.get_training_stats()
    assert stats.get_count("workers_dropped") == 1
    assert stats.get_count("window_reruns") == 1
    assert any("pool shrinks to 3 healthy workers" in r.message
               for r in caplog.records)


def test_nonfinite_worker_result_is_quarantined(caplog):
    """Worker 1's replica trains on NaN features once: its non-finite
    result is never averaged in, the shard re-dispatches on clean data,
    and the result equals the healthy run's; `TrainingStats` counts it."""
    batches = _batches(8, seed=4)
    healthy = _net()
    _master(healthy, 4).execute_training(healthy,
                                         ListDataSetIterator(batches))
    net = _net()
    inj = NaNGradientInjector(fail_at_fit=1, worker_id=1)
    master = _master(net, 4, injector=inj)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        master.execute_training(net, ListDataSetIterator(batches))
    assert inj.fired == 1
    assert np.all(np.isfinite(_np(net.params())))
    np.testing.assert_array_equal(_np(net.params()), _np(healthy.params()))
    stats = master.get_training_stats()
    assert stats.get_count("nonfinite_results") == 1
    assert stats.get_count("worker_retries") == 1
    assert any("quarantining non-finite result from worker 1" in r.message
               for r in caplog.records)
    # the batch the injector poisoned in place was restored
    assert all(np.all(np.isfinite(b.features)) for b in batches)


def test_all_workers_dropped_raises_cleanly():
    class CrashEveryone(WorkerCrashInjector):
        def pre_update(self, ds, net):
            raise InjectedFault("poisoned pool")

    net = _net()
    master = _master(net, 2, injector=CrashEveryone(worker_id=-1),
                     max_retries=0, retry_backoff=0.0)
    with pytest.raises(NoHealthyWorkersError):
        master.execute_training(net, ListDataSetIterator(_batches(4)))
    assert master.get_training_stats().get_count("workers_dropped") == 2
    assert not master.alive_workers()


def test_poison_shard_exhausts_redispatch_attempts():
    """A shard poisoned in place (PoisonBatchInjector: every re-dispatch
    sees the bad record) fails on every worker: WorkerFailureError once
    the attempts are spent, the pool not shrunk."""
    net = _net()
    inj = PoisonBatchInjector(poison_at=1)
    master = _master(net, 2, injector=inj, max_retries=1, retry_backoff=0.0)
    with pytest.raises(WorkerFailureError) as ei:
        master.execute_training(net, ListDataSetIterator(_batches(4, seed=4)))
    assert "non-finite" in str(ei.value)
    assert len(master.alive_workers()) == 2


# -------------------------------------------------------------- stragglers
def test_straggler_timeout_drops_slow_worker(caplog):
    batches = _batches(4, seed=5)
    net = _net()
    injector = SlowWorkerInjector(worker_id=1, delay=1.5, times=1)
    master = _master(net, 2, injector=injector, worker_timeout=0.4,
                     max_retries=0, retry_backoff=0.0)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        master.execute_training(net, ListDataSetIterator(batches))
    assert injector.fired == 1
    assert not master.worker_health[1].alive
    assert net.iteration == 4
    stats = master.get_training_stats()
    assert stats.get_count("worker_timeouts") >= 1
    assert stats.get_count("workers_dropped") == 1
    assert any("timed out" in r.message for r in caplog.records)
    assert master.worker_health[0].last_heartbeat_ms is not None
    assert master.worker_heartbeat_age_ms(0) >= 0


def test_transient_straggler_redispatches_and_survives():
    net = _net()
    injector = SlowWorkerInjector(worker_id=1, delay=1.5, times=1)
    master = _master(net, 2, injector=injector, worker_timeout=0.4,
                     max_retries=1, retry_backoff=0.0)
    master.execute_training(net, ListDataSetIterator(_batches(4, seed=6)))
    assert all(h.alive for h in master.worker_health)
    stats = master.get_training_stats()
    assert stats.get_count("worker_retries") == 1
    assert stats.get_count("workers_dropped") == 0


def test_hung_sole_worker_raises_instead_of_livelocking():
    net = _net()
    injector = SlowWorkerInjector(worker_id=0, delay=1.0, times=99)
    master = _master(net, 1, injector=injector, worker_timeout=0.3,
                     max_retries=1, retry_backoff=0.0)
    t0 = time.monotonic()
    with pytest.raises(NoHealthyWorkersError):
        master.execute_training(net, ListDataSetIterator(_batches(2)))
    assert time.monotonic() - t0 < 5.0


def test_abandoned_shard_thread_stops_at_the_next_minibatch():
    """A timed-out shard's thread is not killed: it bails out at its
    next minibatch boundary (no further fits, no heartbeats)."""
    fits = []

    class Count(TrainingHook):
        def pre_update(self, ds, net):
            from deeplearning4j_tpu_torch.parallel.training_master import (
                current_worker_id,
            )
            fits.append(current_worker_id())

    net = _net()
    worker = ParameterAveragingTrainingWorker(net)
    worker.add_hook(SlowWorkerInjector(worker_id=1, delay=0.8, times=1))
    worker.add_hook(Count())
    master = ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=3, worker=worker,
        worker_timeout=0.3, max_retries=0, retry_backoff=0.0)
    master.execute_training(net, ListDataSetIterator(_batches(6, seed=7)))
    time.sleep(1.2)  # past the straggler's sleep: it reached a boundary
    assert fits.count(1) == 1  # its first minibatch only


# ------------------------------------------- restart-aware composition
def test_fault_tolerant_trainer_drives_distributed_fit(tmp_path, caplog):
    restarts_seen = []

    class RestartRecorder:
        def iteration_done(self, model, iteration):
            pass

        def on_restart(self, model, restart_count):
            restarts_seen.append(restart_count)

    net = _net()
    master = ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2, collect_training_stats=True)
    handle = DistributedMultiLayer(net, master)
    fault = FaultInjectionListener(fail_at_iteration=2)
    net.set_listeners(fault, RestartRecorder())
    trainer = FaultTolerantTrainer(handle, ListDataSetIterator(_batches(8)),
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=1, max_restarts=2)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        trainer.fit(epochs=2)
    assert fault.fired == 1
    assert trainer.restarts == 1
    assert restarts_seen == [1]
    assert master.get_training_stats().get_count("restarts") == 1
    assert any("FaultInjectionListener: injected fault" in r.message
               for r in caplog.records)
    assert np.isfinite(net.score_value)


def test_fault_tolerant_resume_matches_jax(tmp_path):
    """The same injected fault (iteration 3, checkpoints every 2) on a
    bare network in both packages: each restores its newest verified
    checkpoint, re-runs the epoch, and they finish with equal parameters
    and clocks."""
    arrs = _arrays(6, seed=8)
    jnet, pnet = _pair()
    jnet.set_listeners(jft.FaultInjectionListener(fail_at_iteration=3))
    pnet.set_listeners(FaultInjectionListener(fail_at_iteration=3))
    jtr = jft.FaultTolerantTrainer(
        jnet, JList([JDataSet(f, l) for f, l in arrs]),
        checkpoint_dir=tmp_path / "j", checkpoint_every=2, max_restarts=2)
    ptr = FaultTolerantTrainer(
        pnet, ListDataSetIterator([DataSet(f, l) for f, l in arrs]),
        checkpoint_dir=tmp_path / "p", checkpoint_every=2, max_restarts=2)
    jtr.fit(epochs=2)
    ptr.fit(epochs=2)
    assert ptr.restarts == jtr.restarts == 1
    assert pnet.iteration == jnet.iteration
    assert pnet.epoch == jnet.epoch
    np.testing.assert_allclose(_np(pnet.params()), np.asarray(jnet.params()),
                               rtol=0, atol=ATOL)
    assert ptr.checkpoint_store.steps() == jtr.checkpoint_store.steps()


def test_restart_readmits_drained_pool(tmp_path):
    class CrashUntilDisarmed(TrainingHook):
        armed = True

        def pre_update(self, ds, net):
            if self.armed:
                raise InjectedFault("transient pool-wide outage")

    class Disarm:
        def iteration_done(self, model, iteration):
            pass

        def on_restart(self, model, restart_count):
            injector.armed = False

    injector = CrashUntilDisarmed()
    net = _net()
    net.set_listeners(Disarm())
    worker = ParameterAveragingTrainingWorker(net)
    worker.add_hook(injector)
    master = ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2, worker=worker,
        max_retries=0, retry_backoff=0.0, collect_training_stats=True)
    trainer = FaultTolerantTrainer(DistributedMultiLayer(net, master),
                                   ListDataSetIterator(_batches(4)),
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=1, max_restarts=2)
    trainer.fit(epochs=1)
    assert trainer.restarts == 1
    assert len(master.alive_workers()) == 2
    assert master.get_training_stats().get_count("restarts") == 1
    assert np.isfinite(net.score_value)


def test_sentinel_is_refused_on_a_distributed_handle(tmp_path):
    from deeplearning4j_tpu_torch.optimize.health import HealthSentinel

    net = _net()
    handle = DistributedMultiLayer(net, ParameterAveragingTrainingMaster(
        num_workers=2))
    trainer = FaultTolerantTrainer(handle, ListDataSetIterator(_batches(2)),
                                   checkpoint_dir=tmp_path,
                                   sentinel=HealthSentinel())
    with pytest.raises(ValueError, match="never consult it"):
        trainer.fit()


def test_early_stopping_distributed_recovers_from_fault(tmp_path):
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        TerminationReason,
    )
    from deeplearning4j_tpu_torch.parallel.early_stopping import (
        EarlyStoppingDistributedTrainer,
    )

    net = _net()
    fault = FaultInjectionListener(fail_at_iteration=3)
    net.set_listeners(fault)
    cfg = (EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(MaxEpochsTerminationCondition(3))
           .model_saver(InMemoryModelSaver()).build())
    trainer = EarlyStoppingDistributedTrainer(
        cfg, net, ListDataSetIterator(_batches(8, seed=8)),
        ParameterAveragingTrainingMaster(num_workers=2,
                                         averaging_frequency=2),
        checkpoint_dir=tmp_path, checkpoint_every=1, max_restarts=2)
    result = trainer.fit()
    assert fault.fired == 1
    assert trainer.fault_tolerant.restarts == 1
    assert result.termination_reason == \
        TerminationReason.EPOCH_TERMINATION_CONDITION


def test_early_stopping_distributed_net_mismatch_raises():
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
    )
    from deeplearning4j_tpu_torch.parallel.early_stopping import (
        EarlyStoppingDistributedTrainer,
    )

    net1, net2 = _net(), _net(seed=999)
    handle = DistributedMultiLayer(
        net1, ParameterAveragingTrainingMaster(num_workers=2))
    cfg = (EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(MaxEpochsTerminationCondition(1))
           .model_saver(InMemoryModelSaver()).build())
    it = ListDataSetIterator(_batches(2))
    with pytest.raises(ValueError, match="different net"):
        EarlyStoppingDistributedTrainer(cfg, net2, it, handle)
    EarlyStoppingDistributedTrainer(cfg, net1, it, handle)
    EarlyStoppingDistributedTrainer(cfg, None, it, handle)


# ------------------------------------------- checkpoint durability chaos
def test_save_crash_leaves_prior_checkpoint_loadable_and_resumes(
        tmp_path, caplog):
    resumed_at = []

    class ResumeClock:
        def iteration_done(self, model, iteration):
            pass

        def on_restart(self, model, restart_count):
            resumed_at.append((model.iteration, model.epoch))

    net = _net()
    net.set_listeners(ResumeClock())
    inj = CheckpointCrashInjector(phase="mid_write", fail_at_save=2)
    trainer = FaultTolerantTrainer(net, ListDataSetIterator(_batches(4)),
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=2, max_restarts=2,
                                   save_hooks=[inj])
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        trainer.fit(epochs=2)
    assert inj.fired == 1
    assert trainer.restarts == 1
    assert resumed_at == [(0, 0)]
    assert net.iteration == 8 and net.epoch == 2
    step, path = trainer.checkpoint_store.latest_verified()
    assert restore_model(path, device="cpu").iteration == step
    assert any("CheckpointCrashInjector: injected crash" in r.message
               for r in caplog.records)
    assert any("restored" in r.message for r in caplog.records)


def test_save_crash_mid_run_falls_back_to_newest_good(tmp_path):
    resumed_at = []

    class ResumeClock:
        def iteration_done(self, model, iteration):
            pass

        def on_restart(self, model, restart_count):
            resumed_at.append(model.iteration)

    net = _net()
    net.set_listeners(ResumeClock())
    inj = CheckpointCrashInjector(phase="post_payload", fail_at_save=3)
    trainer = FaultTolerantTrainer(net, ListDataSetIterator(_batches(6)),
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=2, max_restarts=2,
                                   save_hooks=[inj])
    trainer.fit(epochs=1)
    assert trainer.restarts == 1
    assert resumed_at == [2]
    assert net.iteration == 8


def test_all_checkpoints_corrupt_raises_typed_error(tmp_path):
    from deeplearning4j_tpu_torch.util.checkpoint_store import (
        CheckpointCorruptError,
    )

    net = _net()
    net.set_listeners(FaultInjectionListener(fail_at_iteration=3))
    trainer = FaultTolerantTrainer(net, ListDataSetIterator(_batches(4)),
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=2, max_restarts=2)
    real_save = trainer.checkpoint_store.save

    def save_then_rot(step, writer):
        path = real_save(step, writer)
        data = bytearray(path.read_bytes())
        data[len(data) // 2] ^= 0xFF
        path.write_bytes(bytes(data))
        return path

    trainer.checkpoint_store.save = save_then_rot
    with pytest.raises(CheckpointCorruptError, match="no loadable"):
        trainer.fit(epochs=1)


def test_distributed_fit_survives_save_crash(tmp_path):
    net = _net()
    master = ParameterAveragingTrainingMaster(
        num_workers=2, averaging_frequency=2, collect_training_stats=True)
    inj = CheckpointCrashInjector(phase="mid_write", fail_at_save=2)
    trainer = FaultTolerantTrainer(DistributedMultiLayer(net, master),
                                   ListDataSetIterator(_batches(8)),
                                   checkpoint_dir=tmp_path,
                                   checkpoint_every=2, max_restarts=2,
                                   save_hooks=[inj])
    trainer.fit(epochs=2)
    assert inj.fired == 1
    assert trainer.restarts == 1
    assert master.get_training_stats().get_count("restarts") == 1
    assert np.isfinite(net.score_value)
    trainer.checkpoint_store.latest_verified()


def test_early_stopping_distributed_survives_save_crash(tmp_path):
    from deeplearning4j_tpu_torch.earlystopping import (
        EarlyStoppingConfiguration,
        InMemoryModelSaver,
        MaxEpochsTerminationCondition,
        TerminationReason,
    )
    from deeplearning4j_tpu_torch.parallel.early_stopping import (
        EarlyStoppingDistributedTrainer,
    )

    net = _net()
    cfg = (EarlyStoppingConfiguration.Builder()
           .epoch_termination_conditions(MaxEpochsTerminationCondition(3))
           .model_saver(InMemoryModelSaver()).build())
    inj = CheckpointCrashInjector(phase="mid_write", fail_at_save=2)
    trainer = EarlyStoppingDistributedTrainer(
        cfg, net, ListDataSetIterator(_batches(8, seed=8)),
        ParameterAveragingTrainingMaster(num_workers=2,
                                         averaging_frequency=2),
        checkpoint_dir=tmp_path, checkpoint_every=2, max_restarts=2,
        checkpoint_save_hooks=[inj])
    result = trainer.fit()
    assert inj.fired == 1
    assert trainer.fault_tolerant.restarts == 1
    assert result.termination_reason == \
        TerminationReason.EPOCH_TERMINATION_CONDITION


# --------------------------------------------- parallel early stopping
def test_early_stopping_parallel_trainer_matches_jax():
    """EarlyStoppingParallelTrainer over the 8-slot mesh terminates with
    the JAX package's trainer over its 8 devices: same epochs, reason,
    best epoch and held-out scores (1e-6 relative)."""
    import deeplearning4j_tpu.earlystopping as JE
    import deeplearning4j_tpu_torch.earlystopping as PE
    from deeplearning4j_tpu.parallel import EarlyStoppingParallelTrainer as J
    from deeplearning4j_tpu.parallel.mesh import make_mesh as jmesh
    from deeplearning4j_tpu_torch.parallel import (
        EarlyStoppingParallelTrainer,
        make_mesh,
    )

    def blobs(seed, n=96, batch=32):
        rng = np.random.default_rng(seed)
        centers = np.asarray([[0, 0, 2, 2], [2, 2, 0, 0], [-2, 2, -2, 2]],
                             np.float32)
        X = np.concatenate([centers[c] + 0.3 * rng.normal(size=(n // 3, 4))
                            for c in range(3)]).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[
            np.concatenate([np.full(n // 3, c) for c in range(3)])]
        idx = rng.permutation(n)
        return [(X[idx][i:i + batch], y[idx][i:i + batch])
                for i in range(0, n, batch)]

    def cfg(E, held):
        return (E.EarlyStoppingConfiguration.Builder()
                .epoch_termination_conditions(
                    E.MaxEpochsTerminationCondition(8))
                .score_calculator(E.DataSetLossCalculator(held))
                .model_saver(E.InMemoryModelSaver()).build())

    train, held = blobs(0), blobs(1)
    jnet, pnet = _pair(seed=7)
    jres = J(cfg(JE, JList([JDataSet(*b) for b in held])), jnet,
             JList([JDataSet(*b) for b in train]),
             mesh=jmesh({"data": 8})).fit()
    pres = EarlyStoppingParallelTrainer(
        cfg(PE, ListDataSetIterator([DataSet(*b) for b in held])), pnet,
        ListDataSetIterator([DataSet(*b) for b in train]),
        mesh=make_mesh({"data": 8}, devices=[torch.device("cpu")] * 8)).fit()
    assert pres.termination_reason.value == jres.termination_reason.value
    assert pres.total_epochs == jres.total_epochs == 8
    assert pres.best_model_epoch == jres.best_model_epoch
    for e, s in jres.score_vs_epoch.items():
        assert pres.score_vs_epoch[e] == pytest.approx(s, rel=1e-6)
    assert isinstance(pres.best_model, MultiLayerNetwork)
    assert np.isfinite(pres.best_model.score(DataSet(*train[0])))
