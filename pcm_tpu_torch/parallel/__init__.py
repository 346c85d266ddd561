"""Data parallelism of the port (counterpart of `pcm_tpu/parallel/`)."""
