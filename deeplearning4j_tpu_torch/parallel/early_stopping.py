"""Early stopping over data-parallel training (counterpart of
`deeplearning4j_tpu/parallel/early_stopping.py`).

Reference: `deeplearning4j-scaleout-parallelwrapper/.../
EarlyStoppingParallelTrainer.java` — the early-stopping epoch loop where
each epoch's fit runs through ParallelWrapper instead of plain
`net.fit` — and `spark/earlystopping/SparkEarlyStoppingTrainer.java`,
the same loop driving the TrainingMaster's worker/averaging path.
"""
from __future__ import annotations

from deeplearning4j_tpu_torch.earlystopping.config import EarlyStoppingConfiguration
from deeplearning4j_tpu_torch.earlystopping.trainer import EarlyStoppingTrainer
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper


class _FitFacade:
    """Presents a (fit delegate + net) pair as a single model: `fit` runs
    the delegate's data-parallel path (ParallelWrapper's step, or the
    TrainingMaster's worker pool); everything else (score, listeners,
    serialization, clone) proxies to the underlying network — so model
    savers store real network clones, never the facade."""

    def __init__(self, fit_target, net):
        object.__setattr__(self, "_fit_target", fit_target)
        object.__setattr__(self, "_net", net)

    def fit(self, iterator, epochs: int = 1):
        object.__getattribute__(self, "_fit_target").fit(iterator,
                                                         epochs=epochs)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_net"), name)

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_net"), name, value)


class _RecoveringFit:
    """Routes the facade's per-epoch fit through a `FaultTolerantTrainer`
    so each distributed epoch gets checkpoint-restore-retry semantics."""

    def __init__(self, fault_tolerant):
        self.fault_tolerant = fault_tolerant

    def fit(self, iterator, epochs: int = 1):
        self.fault_tolerant.fit(epochs=epochs, iterator=iterator)


class EarlyStoppingDistributedTrainer(EarlyStoppingTrainer):
    """Early stopping where each epoch's fit goes through the
    TrainingMaster's worker/averaging path (reference
    `spark/earlystopping/SparkEarlyStoppingTrainer.java` — extends
    `BaseSparkEarlyStoppingTrainer.fit`: per-epoch
    `trainingMaster.executeTraining`, then score calculators / termination
    conditions on the synced net). Iteration-level termination conditions
    fire through the master's `iteration_done` listener fan-out, exactly
    as on the single-device trainer.

    `checkpoint_dir` (optional) makes each epoch's distributed fit
    restart-aware: a `FaultTolerantTrainer` checkpoints every
    `checkpoint_every` iterations and, on a worker-tier failure that
    escapes the master's own retry/degradation layer, restores the newest
    VERIFIED checkpoint (durable atomic saves + integrity manifests via
    `util/checkpoint_store`) and resumes — up to `max_restarts` times
    (restart counts land in the master's `TrainingStats` when it collects
    stats). `checkpoint_save_hooks` passes chaos hooks
    (`CheckpointCrashInjector`) down to the store's save protocol."""

    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, training_master,
                 checkpoint_dir=None, checkpoint_every: int = 100,
                 max_restarts: int = 3, checkpoint_save_hooks=()):
        from deeplearning4j_tpu_torch.parallel.training_master import (
            DistributedMultiLayer,
        )

        if isinstance(training_master, DistributedMultiLayer):
            if net is not None and training_master.net is not net:
                raise ValueError(
                    "EarlyStoppingDistributedTrainer was given BOTH an "
                    "existing DistributedMultiLayer and a different net — "
                    "the handle would silently train its own net, not the "
                    "one passed. Pass net=None or the handle's own net.")
            self.distributed = training_master
        else:
            self.distributed = DistributedMultiLayer(net, training_master)
        self.fault_tolerant = None
        fit_target = self.distributed
        if checkpoint_dir is not None:
            from deeplearning4j_tpu_torch.earlystopping.trainer import (
                _IterationAbort,
            )
            from deeplearning4j_tpu_torch.parallel.fault_tolerance import (
                FaultTolerantTrainer,
            )

            self.fault_tolerant = FaultTolerantTrainer(
                self.distributed, train_iterator,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                max_restarts=max_restarts,
                save_hooks=checkpoint_save_hooks,
                # iteration-condition aborts are control flow, not faults
                propagate=(_IterationAbort,))
            fit_target = _RecoveringFit(self.fault_tolerant)
        super().__init__(config,
                         _FitFacade(fit_target, self.distributed.net),
                         train_iterator)


class EarlyStoppingParallelTrainer(EarlyStoppingTrainer):
    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator, wrapper: ParallelWrapper = None,
                 **wrapper_kwargs):
        if wrapper is None:
            wrapper = ParallelWrapper(net, **wrapper_kwargs)
        self.wrapper = wrapper
        super().__init__(config, _FitFacade(wrapper, wrapper.net),
                         train_iterator)
