"""Utilities — counterpart of `deeplearning4j_tpu.util`."""


def __getattr__(name):
    if name == "determinism":
        raise NotImplementedError(
            "util.determinism is not ported yet (ROADMAP queue A10b: early "
            "stopping, util.determinism, the profiler)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
