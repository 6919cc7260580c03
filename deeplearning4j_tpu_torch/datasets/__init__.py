"""Data API: DataSet containers, iterators and normalizers (counterpart
of `deeplearning4j_tpu/datasets`)."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet,
    MultiDataSet,
)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    QuarantiningDataSetIterator,
)
