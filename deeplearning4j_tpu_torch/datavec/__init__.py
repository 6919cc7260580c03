"""DataVec-equivalent ETL: record readers + DataSet iterator adapters.

The reference consumes DataVec (external Java ETL library) through adapter
iterators in `deeplearning4j-core/.../datasets/datavec/` (SURVEY §2.2 / §2.9
"DataVec" row: "host-side input pipeline feeding device infeed"). This
package (the port's copy of `deeplearning4j_tpu.datavec`) is the host-side
input pipeline: readers parse records
on the host (optionally via the C++ native parser), the iterator adapters
assemble padded/masked numpy batches, and `AsyncDataSetIterator` overlaps
that with device dispatch.
"""
from deeplearning4j_tpu_torch.datavec.records import (
    CollectionRecordReader,
    CollectionSequenceRecordReader,
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    LineRecordReader,
    RecordReader,
    SequenceRecordReader,
)
from deeplearning4j_tpu_torch.datavec.iterators import (
    AlignmentMode,
    RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)

__all__ = [
    "AlignmentMode",
    "CollectionRecordReader",
    "CollectionSequenceRecordReader",
    "CSVRecordReader",
    "CSVSequenceRecordReader",
    "ImageRecordReader",
    "LineRecordReader",
    "RecordReader",
    "RecordReaderDataSetIterator",
    "RecordReaderMultiDataSetIterator",
    "SequenceRecordReader",
    "SequenceRecordReaderDataSetIterator",
]
