"""Evaluation metrics (counterpart of `deeplearning4j_tpu/eval`)."""

from deeplearning4j_tpu_torch.eval.evaluation import Evaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation  # noqa: F401
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCMultiClass  # noqa: F401
