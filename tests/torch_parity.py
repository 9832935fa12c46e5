"""Shared helpers of the port parity tests (tests/test_torch_*.py)."""

import jax
import numpy as np
import torch


def randomize(tree, seed):
    """Replace every leaf of a flax param tree with seeded random values:
    kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), other vectors
    N(0, 0.1^2). Zero-initialised heads would otherwise make the outputs
    agree trivially."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if a.ndim >= 4:  # conv kernels [k.., C, F]
            fan_in = int(np.prod(a.shape[:-1]))
        elif a.ndim >= 2:  # Dense [in, out], DenseGeneral [in, H, hd]
            fan_in = a.shape[0]
        else:
            base = 1.0 if getattr(path[-1], "key", None) == "scale" else 0.0
            return (base + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return (rng.normal(size=a.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def init_params(module, *args, seed=0, **kwargs):
    """flax ``module.init`` -> randomized numpy param tree."""
    params = jax.jit(module.init)(jax.random.key(0), *args,
                                  **kwargs)["params"]
    return randomize(jax.tree.map(np.asarray, params), seed)


def apply(module, params, *args):
    """jitted flax ``module.apply`` (one compile instead of op-by-op
    dispatch)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params,
                                                                   *args)


def load(port_module, state_dict):
    """Load a numpy or torch state_dict strictly (every key, nothing more)
    and put the module in ``eval()`` mode: no dropout, as the JAX side's
    deterministic apply."""
    port_module.load_state_dict(
        {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
         state_dict.items()}, strict=True)
    return port_module.eval()


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))
