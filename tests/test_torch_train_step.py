"""One train step of the port against the JAX package, and the train
step's ``nan_guard``.

tiny_config at f32, batch 2, ``stage0_pack: 4``: at batch 2 both sides
take the packed stage-0 chain. JAX side, on its default XLA path (the band
conv as ``lax.conv_general_dilated``, the function its Pallas kernels 1-3
compute; their parity with the port's band conv is pinned at kernel size in
tests/test_torch_packed_conv.py and tests/test_torch_packed_conv_grad.py):
``jax.value_and_grad`` of ``model.apply(deterministic=True)`` +
``Criterion`` + ``total_loss``, then ``make_optimizer``'s update with
active clipping (max norm half the gradient norm). Port side: its train
step with the model in ``eval()`` (no dropout), on the plain versions of
the kernels. Both start from the same parameters (the flax init with the
zero heads overwritten by seeded values), bridged by
``state_dict_from_jax``, and gradients are compared under the port's names.
Both run their encoder under remat, as the config has it.

Tolerances, as tests/test_model_parity.py's gradient test: loss rtol 1e-4;
per-tensor gradient rel-L2 < 1e-2 above a floor of 1e-5 of the global
norm; AdamW deltas rtol 0.05, atol 0.25 x the group's lr, on the entries
whose gradient is above float noise (Adam's g / (|g| + eps) has no
defined direction there).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parity import counting, randomize
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models.criterion import Criterion as JCriterion
from transoar_tpu.models.criterion import total_loss as jtotal_loss
from transoar_tpu.models.transoarnet import build_transoarnet as build_jax
from transoar_tpu.training.train_state import TrainState, make_optimizer
from transoar_tpu.training.trainer import derive_targets as jderive
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.ops.kernels import packed_conv as pc
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
    jmodel = build_jax(cfg)
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

    (loss, losses), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    grads = jax.tree.map(np.asarray, grads)
    norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                             for g in jax.tree.leaves(grads))))
    cfg["trainer"]["clip_max_norm"] = 0.5 * norm
    state = TrainState.create(apply_fn=jmodel.apply, params=params,
                              tx=make_optimizer(cfg, STEPS_PER_EPOCH))
    # one compile for the update, not one an op
    new_params = jax.tree.map(np.asarray, jax.jit(
        lambda s, g: s.apply_gradients(grads=g))(state, grads).params)

    port = build_model(cfg).eval()  # no dropout, as deterministic apply
    port.load_state_dict(state_dict_from_jax(params, cfg))
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    optimizer, scheduler = tstate.make_optimizer(port, cfg, STEPS_PER_EPOCH)
    step = make_train_step(port, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    # the band conv's plain versions, which kernels 1-3 replace on a card
    with pytest.MonkeyPatch.context() as mp:
        calls = {name: counting(mp, pc, f"packed_conv{name}_reference")
                 for name in ("", "_dx", "_dw")}
        ours = step({"image": torch.from_numpy(image),
                     "seg": torch.from_numpy(seg)})
    return SimpleNamespace(
        cfg=cfg, norm=norm, loss=float(loss),
        losses={k: float(v) for k, v in losses.items()}, ours=ours,
        ref_grads=state_dict_from_jax(grads, cfg),
        ref_old=state_dict_from_jax(params, cfg),
        ref_new=state_dict_from_jax(new_params, cfg),
        before=before, port=port,
        port_conv_calls={k: len(v) for k, v in calls.items()})


def test_port_ran_its_packed_chain(step_run):
    # both stage-0 convs forward, again in the encoder's remat recompute;
    # dx of the second conv only (the image needs none); dw of both
    assert step_run.port_conv_calls == {"": 4, "_dx": 1, "_dw": 2}


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
    # grad_accum_steps: the update, and the schedule with it, every k-th
    # call only
    cfg["trainer"]["grad_accum_steps"] = 2
    optimizer, scheduler = tstate.make_optimizer(model, cfg, 3)
    update = tstate.UpdateRule(optimizer, scheduler, model.parameters(),
                               accum=2)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    assert [update() for _ in range(5)] == [False, True, False, True, False]
    assert scheduler.last_epoch == 2 and update.mini_step == 1


@pytest.mark.parametrize("accum,clip", [(2, 0.5), (3, -1.0)])
def test_grad_accumulation_matches_optax(accum, clip):
    """``trainer.grad_accum_steps`` k: the port's UpdateRule against the JAX
    package's ``optax.MultiSteps(chain(clip, multi_transform(adamw)))``
    over 4k calls of seeded gradients (two rate groups, the clip active,
    the schedule's drop after the second update): the parameters after
    every call within 1e-6."""
    import optax

    cfg = {"trainer": {"lr": 1e-2, "lr_backbone": 3e-3, "weight_decay": 0.1,
                       "lr_drop": 1, "clip_max_norm": clip,
                       "grad_accum_steps": accum}}
    rng = np.random.default_rng(accum)
    init = {"backbone": {"w": rng.normal(size=(3, 4))},
            "neck": {"w": rng.normal(size=(5,))}}
    init = jax.tree.map(lambda a: a.astype(np.float32), init)
    tx = make_optimizer(cfg, 2)
    jparams = jax.tree.map(jnp.asarray, init)
    opt_state = tx.init(jparams)

    model = torch.nn.Module()
    for name in ("backbone", "neck"):
        part = torch.nn.Module()
        part.w = torch.nn.Parameter(torch.from_numpy(init[name]["w"]))
        model.add_module(f"_{name}", part)
    optimizer, scheduler = tstate.make_optimizer(model, cfg, 2)
    update = tstate.UpdateRule(optimizer, scheduler, model.parameters(),
                               clip=clip, accum=accum)
    applied = []
    for call in range(4 * accum):
        grads = {name: {"w": (3 * rng.normal(size=init[name]["w"].shape))
                        .astype(np.float32)} for name in init}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        optimizer.zero_grad(set_to_none=True)
        for name in init:
            getattr(model, f"_{name}").w.grad = torch.from_numpy(
                grads[name]["w"])
        applied.append(update())
        for name in init:
            np.testing.assert_allclose(
                getattr(model, f"_{name}").w.detach().numpy(),
                np.asarray(jparams[name]["w"]), rtol=1e-6, atol=1e-6,
                err_msg=f"call {call}, {name}")
    assert applied == ([False] * (accum - 1) + [True]) * 4
    assert tstate.current_lrs(optimizer)["neck"] == pytest.approx(1e-3)


def test_grad_accumulation_resumes_mid_way(tmp_path):
    """A run of ``grad_accum_steps`` 3 checkpointed after 4 calls (one call
    into an accumulation) and resumed from it takes the same updates as the
    run without the interruption: the checkpoint holds the count and the
    partial mean (without them the resumed run would update a call
    late)."""
    from transoar_tpu_torch.training import checkpoints as ckpt_lib

    cfg = {"trainer": {"lr": 1e-2, "lr_backbone": 3e-3, "weight_decay": 0.1,
                       "lr_drop": 2, "clip_max_norm": 0.5,
                       "grad_accum_steps": 3}}
    rng = np.random.default_rng(7)
    init = {"backbone": rng.normal(size=(3, 4)), "neck": rng.normal(size=5)}
    grads = [{k: torch.from_numpy(3 * rng.normal(size=v.shape)).float()
              for k, v in init.items()} for _ in range(7)]

    def run(calls, resume=None):
        model = torch.nn.Module()
        for name, value in init.items():
            part = torch.nn.Module()
            part.w = torch.nn.Parameter(torch.from_numpy(value).float())
            model.add_module(f"_{name}", part)
        optimizer, scheduler = tstate.make_optimizer(model, cfg, 2)
        update = tstate.UpdateRule(optimizer, scheduler,
                                   list(model.parameters()), clip=0.5,
                                   accum=3)
        if resume is not None:
            ckpt_lib.restore_checkpoint(resume, model, optimizer, scheduler,
                                        update=update)
        for g in calls:
            optimizer.zero_grad(set_to_none=True)
            for name in init:
                getattr(model, f"_{name}").w.grad = g[name].clone()
            update()
        return model, optimizer, scheduler, update

    whole = run(grads)[0]
    model, optimizer, scheduler, update = run(grads[:4])
    assert update.mini_step == 1
    path = ckpt_lib.save_training_checkpoint(
        tmp_path, "model_last", model, optimizer, scheduler, 1, 0.0,
        update=update)
    saved = torch.load(path, weights_only=True)["accumulation"]
    assert saved["mini_step"] == 1 and set(saved["mean"]) == {
        "_backbone.w", "_neck.w"}
    resumed = run(grads[4:], resume=path)[0]
    for name, p in whole.named_parameters():
        torch.testing.assert_close(resumed.get_parameter(name), p, rtol=0,
                                   atol=0, msg=name)
