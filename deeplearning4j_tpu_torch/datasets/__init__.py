"""Datasets: the `DataSet` container and its iterators."""
