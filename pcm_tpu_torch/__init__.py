"""PyTorch + CUDA port of `pcm_tpu` for NVIDIA Hopper (sm_90a).

Same layout and names as `pcm_tpu/`; every Pallas kernel on a ported path is
a hand-written CUDA kernel under `csrc/`, built at first use (`ops/common.py`).
"""

__version__ = "0.1.0"
