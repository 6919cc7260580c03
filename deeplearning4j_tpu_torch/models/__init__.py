"""Model builders — counterpart of `deeplearning4j_tpu.models`."""
