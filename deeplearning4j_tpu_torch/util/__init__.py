"""Utilities — counterpart of `deeplearning4j_tpu.util`."""
