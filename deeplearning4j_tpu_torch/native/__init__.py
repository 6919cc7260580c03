"""Native (C++) host components, loaded through ctypes (counterpart of
`deeplearning4j_tpu/native`).

The input pipeline's hot host loops, parsing numeric CSV and counting the
words of a corpus, run in C++ (`native/src/dl4jtpu_native.cpp`, the port's
copy of the JAX package's source), built with g++ at first use into
`deeplearning4j_tpu_torch/_build/`. Every entry point returns None when
the library cannot be built or loaded, and its caller then runs the
reference's pure-Python route: the package works without a compiler.
`loader.route` says which route the last call took.
"""
from deeplearning4j_tpu_torch.native.loader import (
    count_words,
    csv_parse_numeric,
    native_available,
    native_lib,
)

__all__ = ["count_words", "csv_parse_numeric", "native_available", "native_lib"]
