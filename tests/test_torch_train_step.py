"""One train step of the port against the JAX package, and the train
step's ``nan_guard``.

tiny_config at f32, batch 2, ``stage0_pack: 4``: at batch 2 the JAX side
takes the packed stage-0 chain, and ``TRANSOAR_PALLAS_CONV=1`` with
interpret mode puts it on the Pallas kernels 1-3 (forward, dx, dw). JAX
side: ``jax.value_and_grad`` of ``model.apply(deterministic=True)`` +
``Criterion`` + ``total_loss``, then ``make_optimizer``'s update with
active clipping (max norm half the gradient norm). Port side: its train
step with the model in ``eval()`` (no dropout), on the plain versions of
the kernels. Both start from the same parameters (the flax init with the
zero heads overwritten by seeded values), bridged by
``state_dict_from_jax``, and gradients are compared under the port's names.
The port runs its encoder under remat (``torch.utils.checkpoint``); the JAX
side without it, since interpret-mode Pallas cannot run under ``nn.remat``.

Tolerances, as tests/test_model_parity.py's gradient test: loss rtol 1e-4;
per-tensor gradient rel-L2 < 1e-2 above a floor of 1e-5 of the global
norm; AdamW deltas rtol 0.05, atol 0.25 x the group's lr, on the entries
whose gradient is above float noise (Adam's g / (|g| + eps) has no
defined direction there).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parity import randomize
from transoar_tpu.models.criterion import Criterion as JCriterion
from transoar_tpu.models.criterion import total_loss as jtotal_loss
from transoar_tpu.models.transoarnet import build_transoarnet as build_jax
from transoar_tpu.ops.pallas import packed_conv as jpacked
from transoar_tpu.training.train_state import TrainState, make_optimizer
from transoar_tpu.training.trainer import derive_targets as jderive
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training import train_state as tstate
from transoar_tpu_torch.training.trainer import Trainer, make_train_step
from transoar_tpu_torch.utils.weights import state_dict_from_jax

STEPS_PER_EPOCH = 100


def _config():
    cfg = tiny_config(precision="float32")
    cfg["backbone"]["stage0_pack"] = 4
    return cfg


@pytest.fixture(scope="module")
def step_run():
    cfg = _config()
    image, seg = synthetic_batch(cfg, batch_size=2, seed=1)
    # interpret-mode Pallas cannot run under nn.remat; remat changes memory,
    # not numbers (the port keeps it on)
    jcfg = copy.deepcopy(cfg)
    jcfg["backbone"]["remat"] = False
    jmodel = build_jax(jcfg)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.key(0), jnp.asarray(image))["params"])
    params["cls_head"] = randomize(params["cls_head"], 1)
    params["reg_head"]["Dense_2"] = randomize(params["reg_head"]["Dense_2"],
                                              2)

    crit = JCriterion(cfg)
    anchors = jnp.asarray(jmodel.anchors)
    targets = jderive(jnp.asarray(seg), cfg["neck"]["num_organs"])

    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(image),
                           deterministic=True)
        losses = crit(out, targets, anchors)
        return jtotal_loss(losses, cfg["loss_coefs"]), losses

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRANSOAR_PALLAS_CONV", "1")
        kernel_rows = jpacked._conv_rows

        def counting(*args):
            calls.append(1)
            return kernel_rows(*args)

        mp.setattr(jpacked, "_conv_rows", counting)
        with pltpu.force_tpu_interpret_mode():
            (loss, losses), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
    grads = jax.tree.map(np.asarray, grads)
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in jax.tree.leaves(grads))))
    cfg["trainer"]["clip_max_norm"] = 0.5 * norm
    state = TrainState.create(apply_fn=jmodel.apply, params=params,
                              tx=make_optimizer(cfg, STEPS_PER_EPOCH))
    new_params = jax.tree.map(np.asarray,
                              state.apply_gradients(grads=grads).params)

    port = build_model(cfg).eval()  # no dropout, as deterministic apply
    port.load_state_dict(state_dict_from_jax(params, cfg))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    optimizer, scheduler = tstate.make_optimizer(port, cfg, STEPS_PER_EPOCH)
    step = make_train_step(port, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    ours = step({"image": torch.from_numpy(image),
                 "seg": torch.from_numpy(seg)})
    return SimpleNamespace(
        cfg=cfg, norm=norm, loss=float(loss),
        losses={k: float(v) for k, v in losses.items()}, ours=ours,
        ref_grads=state_dict_from_jax(grads, cfg),
        ref_old=state_dict_from_jax(params, cfg),
        ref_new=state_dict_from_jax(new_params, cfg),
        before=before, port=port, jax_kernel_calls=len(calls))


def test_jax_side_ran_the_pallas_kernels(step_run):
    # traced once: forward of both stage-0 convs, plus dx (second conv
    # only) inside the custom VJP; dw is _dw_rows
    assert step_run.jax_kernel_calls >= 3


def test_loss_matches_jax(step_run):
    np.testing.assert_allclose(float(step_run.ours["total"]), step_run.loss,
                               rtol=1e-4)
    for key, ref in step_run.losses.items():
        np.testing.assert_allclose(float(step_run.ours[key]), ref,
                                   rtol=1e-4, atol=1e-6, err_msg=key)


def _negligible(run):
    floor = 1e-5 * run.norm * 0.5  # the clipped global norm
    return floor, {n for n, g in run.ref_grads.items()
                   if g.norm() < floor}


def test_gradients_match_jax(step_run):
    floor, negligible = _negligible(step_run)
    assert len(negligible) < 0.2 * len(step_run.ref_grads)
    for name, p in step_run.port.named_parameters():
        ref = 0.5 * step_run.ref_grads[name]  # the port's grads are clipped
        ours = p.grad
        if name in negligible:
            assert ours.norm() < 10 * floor, name
            continue
        rel = float((ours - ref).norm() / max(float(ref.norm()), floor))
        assert rel < 1e-2, f"{name}: rel grad err {rel:.2e}"


def test_adamw_step_matches_jax(step_run):
    _, negligible = _negligible(step_run)
    lrs = {"backbone": step_run.cfg["trainer"]["lr_backbone"],
           "neck": step_run.cfg["trainer"]["lr"]}
    for name, p in step_run.port.named_parameters():
        torch.testing.assert_close(step_run.before[name],
                                   step_run.ref_old[name])
        if name in negligible:
            continue
        g = step_run.ref_grads[name]
        decided = g.abs() > 1e-4 * g.abs().max()
        lr = lrs["backbone" if name.startswith("_backbone.") else "neck"]
        np.testing.assert_allclose(
            (p.detach() - step_run.before[name])[decided].numpy(),
            (step_run.ref_new[name] - step_run.ref_old[name])[decided]
            .numpy(), rtol=0.05, atol=0.25 * lr, err_msg=name)


def _adam_steps(optimizer):
    return int(next(iter(optimizer.state.values()))["step"])


def _tiny_step(nan_guard):
    cfg = _config()
    cfg["trainer"]["nan_guard"] = nan_guard
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    optimizer, scheduler = tstate.make_optimizer(model, cfg, 1)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    image, seg = synthetic_batch(cfg, batch_size=2, seed=2)
    return cfg, model, optimizer, scheduler, step, image, seg


def test_nan_guard_skip_drops_the_whole_update():
    _, model, optimizer, scheduler, step, image, seg = _tiny_step("skip")
    batch = {"image": torch.from_numpy(image), "seg": torch.from_numpy(seg)}
    step(batch)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {k: {s: v.clone() for s, v in st.items()}
               for k, st in optimizer.state.items()}
    lrs = [g["lr"] for g in optimizer.param_groups]
    bad = dict(batch, image=torch.full_like(batch["image"], float("nan")))
    losses = step(bad)
    assert not torch.isfinite(losses["total"])
    for n, p in model.named_parameters():
        assert torch.equal(p, params[n]), n
    for k, st in optimizer.state.items():
        for s, v in st.items():
            assert torch.equal(v, moments[k][s]), s
    assert _adam_steps(optimizer) == 1
    assert scheduler.last_epoch == 1
    assert [g["lr"] for g in optimizer.param_groups] == lrs
    step(batch)  # a finite loss steps again
    assert _adam_steps(optimizer) == 2


def test_nan_guard_error_raises_at_the_end_of_the_epoch(tmp_path):
    cfg, model, optimizer, scheduler, _, image, seg = _tiny_step("error")
    bad = [{"image": np.full_like(image, np.nan), "seg": seg}]
    trainer = Trainer(cfg, model, bad, bad, tmp_path, "cpu", optimizer,
                      scheduler)
    with pytest.raises(RuntimeError, match="nan_guard"):
        trainer._train_one_epoch(1)


def test_schedule_and_groups():
    cfg = _config()
    cfg["trainer"]["lr_drop"] = 2
    model = build_model(cfg)
    optimizer, scheduler = tstate.make_optimizer(model, cfg, 3)
    names = {g["name"]: len(g["params"]) for g in optimizer.param_groups}
    n_backbone = sum(1 for n, _ in model.named_parameters()
                     if n.startswith("_backbone."))
    assert names == {"backbone": n_backbone,
                     "neck": len(list(model.parameters())) - n_backbone}
    seen = []
    for _ in range(8):
        seen.append(tstate.current_lrs(optimizer)["neck"])
        optimizer.step()
        scheduler.step()
    # optax's piecewise-constant schedule: x0.1 from step lr_drop * 3 on
    assert seen == pytest.approx([2e-4] * 6 + [2e-5] * 2)
    cfg["trainer"]["grad_accum_steps"] = 2
    with pytest.raises(NotImplementedError, match="grad_accum_steps"):
        tstate.make_optimizer(model, cfg, 3)
