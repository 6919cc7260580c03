"""Export-staged distributed training: batch-and-export DataSets to
files, then train from paths (counterpart of
`deeplearning4j_tpu/parallel/export.py`; the npz files are the JAX
package's, so either package's `FileDataSetIterator` reads them).

Reference: the second RDD training approach
(`spark/api/RDDTrainingApproach.java` Export,
`spark/data/BatchAndExportDataSetsFunction.java`,
`ParameterAveragingTrainingMaster.executeTrainingPathsHelper`): instead of
holding the whole training set in executor memory, batches are re-batched
to a uniform minibatch size, written to files, and workers stream them
from paths — the larger-than-memory seam.

Shape: files are npz DataSets (`DataSet.save/load`),
`FileDataSetIterator` streams them one at a time, and
`ParameterAveragingTrainingMaster.execute_training_paths` drives the same
averaging schedule over the exported shards.
"""
from __future__ import annotations

import fnmatch
import os
from typing import List

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterators import IteratorDataSetIterator


def batch_and_export(iterator, export_dir, batch_size: int,
                     prefix: str = "dataset") -> List[str]:
    """Re-batch a stream of DataSets to a uniform `batch_size` and write
    one file per batch under `export_dir` (created if needed). Returns
    the ordered list of written paths.

    Matches `BatchAndExportDataSetsFunction.java`: incoming batches of any
    size are split/merged so every exported file except possibly the last
    holds exactly `batch_size` examples — uniform minibatches keep the
    train step at ONE shape. Re-batching
    (including mixed-mask merge semantics) is `IteratorDataSetIterator` —
    the exact batches a consumer would see training in-memory.

    Stale shards from a previous export under the same prefix are removed
    first: directory-mode `FileDataSetIterator(export_dir)` globs every
    npz, and a smaller re-export would otherwise silently train on
    leftover files from the earlier run."""
    export_dir = os.fspath(export_dir)
    os.makedirs(export_dir, exist_ok=True)
    for f in os.listdir(export_dir):
        if fnmatch.fnmatch(f, f"{prefix}_*.npz"):
            os.remove(os.path.join(export_dir, f))
    paths: List[str] = []
    rebatch = IteratorDataSetIterator(iterator, batch_size)
    while rebatch.has_next():
        path = os.path.join(export_dir, f"{prefix}_{len(paths):06d}.npz")
        rebatch.next().save(path)
        paths.append(path)
    return paths
