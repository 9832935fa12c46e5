"""Shared helpers of the port parity tests (tests/test_torch_*.py)."""

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one CPU thread for each module that imports this fixture:
    the test workers share the cores, and torch's default of one thread a
    core makes them contend (on an 8-core CPU a tiny flagship train step
    takes 0.2 s alone and 6 s beside one other process doing the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def counting(monkeypatch, module, name):
    """Patch ``module.name`` to count its calls; returns the list the calls
    append to."""
    calls = []
    fn = getattr(module, name)

    def wrapped(*args):
        calls.append(1)
        return fn(*args)

    monkeypatch.setattr(module, name, wrapped)
    return calls


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
    """The shapes of flax ``module.init`` (traced, not compiled: every leaf
    is replaced anyway) -> randomized numpy param tree."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args,
                                                **kwargs))["params"]
    return randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                  shapes), seed)


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


def model_pair(cfg, x, seed=0):
    """The JAX TransoarNet of ``cfg`` with every parameter seeded-random
    (``randomize``) and the port's model carrying the same numbers through
    ``state_dict_from_jax``, in ``eval()``; returns (jax model, numpy
    params, port model)."""
    import jax.numpy as jnp

    from transoar_tpu.models.transoarnet import build_transoarnet
    from transoar_tpu_torch.models.transoarnet import build_model
    from transoar_tpu_torch.utils.weights import state_dict_from_jax

    jmodel = build_transoarnet(cfg)
    params = init_params(jmodel, jnp.asarray(x), seed=seed)
    port = build_model(cfg)
    return jmodel, params, load(port, state_dict_from_jax(params, cfg))


def forward_pair(jmodel, params, port, x):
    """Both models' outputs on ``x`` as numpy dicts (JAX, port)."""
    import jax.numpy as jnp

    ref = apply(jmodel, params, jnp.asarray(x))
    with torch.inference_mode():
        ours = port(t(x))
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in ours.items()})


def train_step_pair(cfg, jmodel, params, port, image, seg):
    """One train step on both sides from the same parameters: the JAX
    side's ``value_and_grad`` of apply(deterministic) + its criterion +
    ``total_loss``; the port's ``make_train_step`` with the model in
    ``eval()`` (no dropout). Returns (JAX total, JAX losses, JAX grads as
    a port state_dict, port losses); the port's gradients stay on its
    parameters."""
    import jax.numpy as jnp

    from transoar_tpu.models.criterion import build_criterion as jcrit
    from transoar_tpu.models.criterion import total_loss as jtotal
    from transoar_tpu.training.trainer import derive_targets as jderive
    from transoar_tpu_torch.models.criterion import build_criterion
    from transoar_tpu_torch.training.train_state import make_optimizer
    from transoar_tpu_torch.training.trainer import make_train_step
    from transoar_tpu_torch.utils.weights import state_dict_from_jax

    crit = jcrit(cfg)
    anchors = None if jmodel.anchors is None else jnp.asarray(jmodel.anchors)
    targets = jderive(jnp.asarray(seg), cfg["neck"]["num_organs"])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(image),
                           deterministic=True)
        losses = crit(out, targets, anchors)
        return jtotal(losses, cfg["loss_coefs"]), losses

    (loss, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    optimizer, scheduler = make_optimizer(port, cfg, 1)
    step = make_train_step(port, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    ours = step({"image": t(image), "seg": torch.from_numpy(seg)})
    return (float(loss), {k: float(v) for k, v in losses.items()},
            state_dict_from_jax(jax.tree.map(np.asarray, grads), cfg), ours)


def assert_grads_close(port, ref_grads, rel=1e-2):
    """Every port gradient within rel-L2 ``rel`` of the JAX one, above a
    floor of 1e-5 of the global norm (below it both must be float
    noise)."""
    norm = float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in ref_grads.values()])))
    floor = 1e-5 * norm
    checked = 0
    for name, p in port.named_parameters():
        ref = ref_grads[name]
        if ref.norm() < floor:
            assert p.grad.norm() < 10 * floor, name
            continue
        err = float((p.grad - ref).norm() / ref.norm())
        assert err < rel, f"{name}: rel grad err {err:.2e}"
        checked += 1
    assert checked > 0.8 * len(ref_grads)
