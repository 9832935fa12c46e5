"""Spatial parallelism of the port (``parallel/sp.py``) on the CPU (gloo):
the ``sp`` axis alone and beside dp, tp and FSDP2, against the port's
one-process step and the JAX package's dp 1 x sp 2 mesh step.

In this process: ``sp_plan``'s shape rule, and the halo assembly behind
``sp.roll`` against ``torch.roll`` on the whole tensor. In the ranks of
``tests/torch_parallel_worker.py`` (one launch of 2 ranks, one of 4, all
cases in each; the one-process steps and the JAX step run here
meanwhile): f64 gradchecks of the primitives; the tiny flagship (stage 0
on the packed band conv), a tiny SwinFPN with one sharded and one gathered
Swin stage (the shifted windows of the sharded one cross the ranks), the
seg proxy, the refine, DETR, Deformable DETR and RetinaNet at sp 2;
FSDP2 at sp 2 with the clip and an accumulation checkpointed mid-way;
dp 2 x sp 2 and sp 2 x tp 2 with the clip.

Tolerances: ``tests/test_torch_parallel.py``'s (``tests/test_sharding.py``'s
for the JAX mesh): the loss within rtol 2e-4, every parameter after the
AdamW step within atol 5e-5 where the gradient is above float noise;
every gradient within rel-L2 1e-4 (f32 sums in another order); against
the JAX sp mesh step the loss within rtol 1e-4.
"""

import copy
import json

import numpy as np
import pytest
import torch

from tests.helpers import synthetic_batch, tiny_config
from tests.test_torch_parallel import (_assert_state_matches, _save_init,
                                       jax_mesh_step, one_process)
from tests.torch_parallel_worker import free_ports, launch, results, wait
from tests.torch_parity import init_params
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import presets
from transoar_tpu_torch.parallel import sp as sp_lib
from transoar_tpu_torch.utils.weights import state_dict_from_jax

BATCH = 2


def assert_grads_close(grads, ref, rel=1e-4):
    """Each gradient within rel-L2 ``rel`` of the one-process one, above a
    floor of 1e-6 of the global norm (below it both are float noise)."""
    floor = 1e-6 * float(torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in ref.values()])))
    for name, want in ref.items():
        err = float((grads[name] - want).norm())
        assert err <= max(rel * float(want.norm()), floor), (
            name, err, float(want.norm()))


def _json(cfg):
    return json.loads(json.dumps(cfg))  # numpy scalars -> json


def _flagship():
    cfg = tiny_config(precision="float32")
    cfg["trainer"]["batch_size"] = BATCH
    cfg["backbone"]["stage0_pack"] = 4
    return cfg


def _tiny(make, **kw):
    cfg = make(num_organs=3, **kw)
    cfg["trainer"].update(batch_size=BATCH, precision="float32")
    return _json(cfg)


@pytest.mark.parametrize("name,patch,sp,want", [
    ("flagship", (32, 32, 16), 2, ["sharded"] * 4),
    ("flagship", (32, 32, 16), 4, ["sharded"] * 4),
    ("foc_dec_amos", (256, 256, 128), 2, ["sharded"] * 6),
    ("swin_fpn_visceral", (160, 160, 256), 2,
     ["sharded"] * 5 + ["gathered"]),
    ("swin_fpn_visceral", (160, 160, 256), 4,
     ["sharded"] * 4 + ["gathered"] * 2),
    ("swin", (40, 40, 16), 2, ["sharded"] * 3 + ["gathered"]),
    ("flagship", (32, 32, 16), 8, "odd local extent 1 before the stride-2"),
    ("flagship", (32, 32, 16), 3, "does not split into 3"),
    ("flagship", (24, 32, 16), 4, "local depth 6 of stage 0 is not a "
                                  "multiple of stage0_pack = 4"),
])
def test_sp_plan(name, patch, sp, want):
    """Which stages run on the rank's block and which gathered; the
    shapes sp cannot split raise, naming the constraint."""
    if name == "flagship":
        backbone = _flagship()["backbone"]
    elif name == "swin":
        backbone = presets.tiny_swin_config()["backbone"]
    else:
        backbone = presets.model_config(name)["backbone"]
    if isinstance(want, list):
        assert sp_lib.sp_plan(backbone, patch, sp) == want
    else:
        with pytest.raises(ValueError, match=want):
            sp_lib.sp_plan(backbone, patch, sp)


@pytest.mark.parametrize("ranks,shift", [(2, -2), (2, 3), (4, 1), (4, -1),
                                         (3, 2)])
def test_roll_blocks_match_torch_roll(ranks, shift):
    """``sp.roll``'s halo assembly, given every rank's edge rows (what its
    all-gather delivers), puts together ``torch.roll`` of the whole
    tensor."""
    whole = torch.arange(2 * ranks * 4 * 3, dtype=torch.float32).view(
        2, ranks * 4, 3)
    blocks = whole.chunk(ranks, 1)
    lo, hi = max(shift, 0), max(-shift, 0)
    edges = [sp_lib._edges(b, lo, hi) for b in blocks]
    got = [sp_lib._with_halo(b, edges, lo, hi, r, ranks, True)
           for r, b in enumerate(blocks)]
    got = [h[:, :4] if shift > 0 else h[:, hi:] for h in got]
    assert torch.equal(torch.cat(got, 1), torch.roll(whole, shift, 1))
    # without wrap the ends take zeros: a conv's halo
    padded = [sp_lib._with_halo(b, [sp_lib._edges(c, 1, 1) for c in blocks],
                                1, 1, r, ranks, False)
              for r, b in enumerate(blocks)]
    full = torch.nn.functional.pad(whole, (0, 0, 1, 1))
    for r, h in enumerate(padded):
        assert torch.equal(h, full[:, r * 4:r * 4 + 6])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    cfg = _flagship()
    image, seg = synthetic_batch(cfg, batch_size=BATCH, seed=1)
    seg[1][seg[1] == 2] = 0  # the dp ranks of dp 2 x sp 2 differ
    np.savez(out / "flagship.npz", image=image, seg=seg)
    from transoar_tpu.models.transoarnet import build_transoarnet

    params = init_params(build_transoarnet(cfg), image, seed=0)
    torch.save({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
                state_dict_from_jax(params, cfg).items()}, out / "init.pt")
    flag = dict(config=cfg, init=str(out / "init.pt"),
                batch=str(out / "flagship.npz"))
    clip = copy.deepcopy(cfg)
    clip["trainer"]["clip_max_norm"] = 0.05
    accum = copy.deepcopy(clip)
    accum["trainer"]["grad_accum_steps"] = 2

    two = [dict(name="primitives", kind="sp_primitives"),
           dict(flag, name="flagship_sp2", sp=2),
           dict(flag, name="fsdp_sp2", sp=2, fsdp=True, config=accum,
                steps=3, checkpoint=True)]
    families = {"swin": lambda: _tiny(presets.tiny_swin_config)}
    for family in ("seg", "refine", "detr", "def_detr", "retina"):
        families[family] = (lambda f=family: _tiny(
            lambda **kw: presets.tiny_config(f, **kw)))
    for family, make in families.items():
        fcfg = make()
        fimage, fseg = synthetic_batch(fcfg, batch_size=BATCH, seed=4)
        np.savez(out / f"{family}.npz", image=fimage, seg=fseg)
        _save_init(fcfg, out / f"{family}.pt")
        two.append(dict(name=f"{family}_sp2", sp=2, config=fcfg,
                        init=str(out / f"{family}.pt"),
                        batch=str(out / f"{family}.npz")))
    four = [dict(flag, name="dp2sp2", dp=2, sp=2),
            dict(flag, name="sp2tp2", sp=2, tp=2, config=clip)]
    ports = free_ports(2)
    procs = launch(two, 2, out, port=ports[0]) + launch(four, 4, out,
                                                        port=ports[1])
    try:
        ref = {c["name"]: one_process(c) for c in two + four
               if c.get("kind") is None}
        jax_losses, _ = jax_mesh_step(cfg, params, image, seg, dp=1, sp=2)
    finally:
        wait(procs)
    done = {**results(two, 2, out), **results(four, 4, out)}
    return dict(ref=ref, jax=jax_losses, cases={c["name"]: c
                                                for c in two + four},
                results={k: v[0] for k, v in done.items()},
                local={k: v[1] for k, v in done.items()}, out=out)


def test_primitives_gradcheck(runs):
    """f64 gradchecks of halo (1, 1) and (2, 0), roll by -1 and 3 (across
    the ranks, wrapping), gather / scatter and the all-reduce, each between
    a scatter and a gather; their forward values equal the whole-tensor
    reference (zeros past the ends, ``torch.roll``)."""
    record = runs["results"]["primitives"]
    assert all(record["gradcheck"].values()), record["gradcheck"]
    assert max(record["forward_err"].values()) < 1e-12, record["forward_err"]


@pytest.mark.parametrize("name", [
    "flagship_sp2", "swin_sp2", "seg_sp2", "refine_sp2", "detr_sp2",
    "def_detr_sp2", "retina_sp2", "fsdp_sp2", "dp2sp2", "sp2tp2"])
def test_step_matches_one_process(runs, name):
    """Each sp step's losses, its last gradients (AdamW's step hides a
    gradient's scale) and its parameters after AdamW match the one-process
    step's (three calls with the update at the second for FSDP2 with
    accumulation; the clip active there and under sp 2 x tp 2)."""
    ref, got = runs["ref"][name], runs["results"][name]
    assert len(got["losses"]) == len(ref.losses)
    for mine, want in zip(got["losses"], ref.losses):
        assert mine.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(mine[key], want[key], rtol=2e-4,
                                       atol=1e-7, err_msg=key)
    assert set(got["grads"]) == set(ref.grads)
    assert_grads_close(got["grads"], ref.grads)
    _assert_state_matches(got["state"], ref)


def test_sp_layout(runs):
    """The plans the ranks took (the tiny Swin's last stage gathered), the
    Functions of kernels 1-5 handed plain local tensors, the checkpoint of
    FSDP2 at sp 2 and its accumulation restored as saved."""
    local = runs["local"]
    for name in ("flagship_sp2", "seg_sp2", "dp2sp2", "sp2tp2"):
        assert all(r["sp_plan"] == ["sharded"] * 4 for r in local[name])
        assert all("_PackedConv" in r["function_inputs"]
                   for r in local[name]), name
    assert all(r["sp_plan"] == ["sharded"] * 3 + ["gathered"]
               for r in local["swin_sp2"])
    for facts in local["swin_sp2"]:
        seen = facts["function_inputs"]
        assert {"_PackedConv", "_WindowAttention"} <= set(seen)
        assert set().union(*seen.values()) <= {"Tensor", "Parameter"}
    assert all(r["dtensor_params"] for r in local["fsdp_sp2"])
    assert all(r["tp_sharded"] for r in local["sp2tp2"])
    got = runs["results"]["fsdp_sp2"]
    for name, value in got["state"].items():  # the checkpoint round trip
        assert torch.equal(got["restored"]["state"][name], value), name
    assert got["accumulation"]["mini_step"] == 1
    assert got["restored"]["accumulation"]["mini_step"] == 1
    mean = got["accumulation"]["mean"]
    assert set(mean) == set(got["state"])
    for name, value in mean.items():
        assert torch.equal(got["restored"]["accumulation"]["mean"][name],
                           value), name
    # the third call's gradient is the accumulation's mean (one call of k)
    ref = runs["ref"]["fsdp_sp2"]
    for name, grad in ref.grads.items():
        torch.testing.assert_close(mean[name], grad, rtol=2e-3,
                                   atol=1e-6 * float(grad.abs().max()) + 1e-9,
                                   msg=name)


def test_sp2_matches_the_jax_sp_mesh_step(runs):
    """The port's sp 2 loss is the JAX dp 1 x sp 2 mesh step's."""
    got = runs["results"]["flagship_sp2"]["losses"][0]
    for key, want in runs["jax"].items():
        np.testing.assert_allclose(got[key], want, rtol=1e-4, atol=1e-6,
                                   err_msg=key)
