"""Seeded numpy variables for a flax model, for the port's parity tests of
the video models (tests/test_torch_{superslomo,amt,davsr}.py).

``model.init`` draws every parameter with JAX's threefry, which XLA on the
CPU compiles once for each parameter shape: about 100 s for the tiny AMT's
~150 shapes, eager or jitted. Here the shapes come from
``jax.eval_shape`` (nothing compiles) and the values from numpy: kernels
N(0, 1/fan_in) (flax's lecun_normal scale, fan_in every axis but the
last), biases N(0, 0.02²) (flax starts them at zero), PReLU slopes
0.25 + N(0, 0.05²).
"""

import numpy as np


def random_flax_params(model, seed, *args, **kwargs):
    """Flat ``{"params/...": float32 array}`` for ``model.init(key, *args,
    **kwargs)``."""
    import jax
    from flax.traverse_util import flatten_dict

    shapes = flatten_dict(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, **kwargs)), sep="/")
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in shapes.items():
        leaf = k.rsplit("/", 1)[-1]
        v = rng.standard_normal(s.shape)
        if leaf == "kernel":
            v = v / np.sqrt(np.prod(s.shape[:-1]))
        elif leaf == "prelu":
            v = 0.25 + 0.05 * v
        else:
            v = 0.02 * v
        flat[k] = v.astype(np.float32)
    return flat


def with_norms(flat, seed):
    """``flat`` with every norm's ``scale`` drawn as 1 + N(0, 0.1²) and
    BatchNorm running statistics away from (0, 1): mean N(0, 0.1²), var
    U(0.5, 1.5) (``random_flax_params`` draws them as biases)."""
    rng = np.random.default_rng(seed)
    out = dict(flat)
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(v.shape)
        elif k.startswith("batch_stats/") and leaf == "mean":
            v = 0.1 * rng.standard_normal(v.shape)
        elif k.startswith("batch_stats/") and leaf == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out
