"""Weight quantization (counterpart of `pcm_tpu/utils/quant.py`)."""
