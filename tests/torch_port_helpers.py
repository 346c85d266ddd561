"""Shared helpers of the tests that hold `pcm_tpu_torch` to `pcm_tpu`.

Parameters of the JAX modules are drawn with numpy over a `jax.eval_shape`
of their init (no XLA compile of the init), every leaf random: biases and
norm scales too, so the converter's handling of each is exercised.
"""

import jax
import numpy as np


def rel_max(ours, ref) -> float:
    if hasattr(ours, "detach"):
        ours = ours.detach().numpy()
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6))


def random_params(init_fn, *args, seed: int = 0):
    """numpy-drawn variables shaped like ``init_fn(PRNGKey, *args)``; LoRA
    ``b`` factors non-zero so adapters act."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        name = jax.tree_util.keystr(path)
        shape = sds.shape
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("['bias']") or name.endswith("['b']"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
        std = 0.02 if "embedding" in name else fan_in ** -0.5
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)
