"""Random JAX variables for the port's parity tests.

``redraw`` replaces every leaf of a flax variables tree with numpy draws
from a seed, so layers the JAX modules zero-initialise (the ADM UNet's
out_conv / proj_out) are live in the comparison and BatchNorm statistics
are not the identity.
"""

import numpy as np

import jax


def redraw(variables, seed):
    """A numpy copy of ``variables`` with every leaf redrawn: kernels
    U(+-1/sqrt(fan_in)), biases U(+-0.1), norm scales U(0.9, 1.1), running
    means U(+-0.1), running variances U(0.5, 1.5), embeddings N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        shape = np.shape(leaf)
        if name == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            out = rng.uniform(-bound, bound, shape)
        elif name == "scale":
            out = rng.uniform(0.9, 1.1, shape)
        elif name in ("bias", "mean"):
            out = rng.uniform(-0.1, 0.1, shape)
        elif name == "var":
            out = rng.uniform(0.5, 1.5, shape)
        elif name == "embedding":
            out = rng.normal(size=shape)
        else:
            raise KeyError(f"no draw rule for leaf {name!r}")
        return out.astype(np.float32)

    return _thaw(jax.tree_util.tree_map_with_path(draw, variables))


def _thaw(tree):
    """Plain nested dicts (flax may hand back FrozenDicts)."""
    if hasattr(tree, "items"):
        return {k: _thaw(v) for k, v in tree.items()}
    return tree
