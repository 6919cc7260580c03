"""Early-stopping trainer (reference
`earlystopping/trainer/BaseEarlyStoppingTrainer.java`): an epoch loop with
per-iteration abort conditions, periodic held-out scoring and best-model
capture. One trainer drives `MultiLayerNetwork` and `ComputationGraph`
alike, through their common `fit(iterator, epochs=1)` and
`set_listeners` surface."""
from __future__ import annotations

import logging
from typing import Optional

from deeplearning4j_tpu_torch.earlystopping.config import EarlyStoppingConfiguration
from deeplearning4j_tpu_torch.earlystopping.result import (
    EarlyStoppingResult,
    TerminationReason,
)
from deeplearning4j_tpu_torch.earlystopping.termination import (
    MaxEpochsTerminationCondition,
)
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

log = logging.getLogger(__name__)


class _IterationAbort(Exception):
    def __init__(self, condition):
        self.condition = condition


class _IterationConditionListener(IterationListener):
    """Checks the iteration termination conditions after every minibatch
    (the reference checks them in its inner fit loop). Reading the score
    waits for the step's device work."""

    def __init__(self, conditions):
        self.conditions = conditions

    def iteration_done(self, model, iteration):
        if not self.conditions:
            return
        score = model.score_value
        if score is None:
            return
        for c in self.conditions:
            if c.terminate(score):
                raise _IterationAbort(c)


class EarlyStoppingTrainer:
    def __init__(self, config: EarlyStoppingConfiguration, net,
                 train_iterator):
        self.config = config
        self.net = net
        self.train_iterator = train_iterator

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        for c in cfg.epoch_termination_conditions:
            c.initialize()
        for c in cfg.iteration_termination_conditions:
            c.initialize()

        listener = _IterationConditionListener(
            cfg.iteration_termination_conditions)
        prev_listeners = list(getattr(self.net, "listeners", []))
        self.net.set_listeners(*(prev_listeners + [listener]))

        score_vs_epoch = {}
        best_score: Optional[float] = None
        best_epoch = -1
        epoch = 0
        reason = TerminationReason.EPOCH_TERMINATION_CONDITION
        details = ""
        try:
            while True:
                try:
                    self.train_iterator.reset()
                    self.net.fit(self.train_iterator, epochs=1)
                except _IterationAbort as a:
                    reason = TerminationReason.ITERATION_TERMINATION_CONDITION
                    details = str(a.condition)
                    log.info("early stopping: iteration condition hit: %s",
                             details)
                    break

                # the held-out score only on evaluation epochs: with a
                # calculator, the training loss never enters the
                # best-model or termination stream (reference semantics)
                if cfg.score_calculator is not None:
                    evaluated = epoch % cfg.evaluate_every_n_epochs == 0
                    score = (cfg.score_calculator.calculate_score(self.net)
                             if evaluated else None)
                else:
                    evaluated = True
                    score = self.net.score_value
                if evaluated:
                    score_vs_epoch[epoch] = score
                    if best_score is None or score < best_score:
                        best_score, best_epoch = score, epoch
                        cfg.model_saver.save_best_model(self.net, score)
                if cfg.save_last_model:
                    cfg.model_saver.save_latest_model(self.net, score)

                stop = None
                last_score = score if evaluated else (
                    score_vs_epoch[max(score_vs_epoch)] if score_vs_epoch
                    else float("inf"))
                for c in cfg.epoch_termination_conditions:
                    # score-based conditions advance only on evaluated
                    # epochs
                    if isinstance(c, MaxEpochsTerminationCondition) \
                            or evaluated:
                        if c.terminate(epoch, last_score):
                            stop = c
                            break
                epoch += 1
                if stop is not None:
                    reason = TerminationReason.EPOCH_TERMINATION_CONDITION
                    details = str(stop)
                    break
        # the reference reports a failed run as TerminationReason.ERROR
        except Exception as e:  # noqa: BLE001
            return EarlyStoppingResult(
                termination_reason=TerminationReason.ERROR,
                termination_details=repr(e), score_vs_epoch=score_vs_epoch,
                best_model_epoch=best_epoch,
                best_model_score=best_score if best_score is not None
                else float("nan"),
                total_epochs=epoch, best_model=cfg.model_saver.get_best_model())
        finally:
            self.net.set_listeners(*prev_listeners)

        return EarlyStoppingResult(
            termination_reason=reason, termination_details=details,
            score_vs_epoch=score_vs_epoch, best_model_epoch=best_epoch,
            best_model_score=best_score if best_score is not None
            else float("nan"),
            total_epochs=epoch, best_model=cfg.model_saver.get_best_model())
