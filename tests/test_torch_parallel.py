"""Multi-process training of the port on the CPU (gloo): the ``dp`` axis
under DDP and FSDP2, Megatron ``tp`` and the 2-D ``dp x tp`` with FSDP2,
against the port's one-process step and the JAX package's dp-2 mesh step.

The ranks run in jax-free subprocesses (``tests/torch_parallel_worker.py``,
started once for every case of one world size: 2 ranks, then 4), the
train CLI under ``torch.distributed.run``. While they run, this process
computes the one-process steps and the JAX step.

Tolerances: after one AdamW step the loss within rtol 2e-4 and every
parameter within atol 5e-5 (``tests/test_sharding.py``'s for the JAX mesh),
except the entries whose one-process gradient is float noise (below 1e-6
of the largest gradient of the model; the k-chunk of ``in_proj_bias`` has
an exact zero gradient: a bias shared by every key leaves each query's
softmax as it is): there Adam's step ``g / (|g| + eps)`` has no defined
direction, and they are held to within the learning rate. Against the
JAX mesh step, the parity rules of ``tests/test_torch_train_step.py``:
loss 1e-4, AdamW deltas where the gradient is above 1e-4 of the tensor's
largest (rtol 0.05, atol 0.25 x lr).
"""

import copy
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tests.helpers import synthetic_batch, tiny_config
from tests.torch_parallel_worker import free_ports, launch, results, wait
from tests.torch_parity import init_params
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import presets
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.parallel import mesh as mesh_lib
from transoar_tpu_torch.parallel import tp as tp_lib
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.training.trainer import make_train_step
from transoar_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
BATCH = 4
NOISE = 1e-6  # of the model's largest gradient: Adam's direction undefined


def _uneven(seg, organs):
    """Rows 2.. lose their organs ``organs``: the two dp ranks then hold
    different present counts (and seg-proxy sums)."""
    seg = seg.copy()
    for c in organs:
        seg[2:][seg[2:] == c] = 0
    return seg


def _flagship():
    """tiny_config at f32 and batch 4, stage 0 on the packed band conv
    (kernels 1-3's custom autograd Function, its plain versions here)."""
    cfg = tiny_config(precision="float32")
    cfg["trainer"]["batch_size"] = BATCH
    cfg["backbone"]["stage0_pack"] = 4
    return cfg


def _family(name):
    cfg = presets.tiny_config(name, num_organs=3)
    cfg["trainer"].update(batch_size=BATCH, precision="float32")
    return json.loads(json.dumps(cfg))  # numpy scalars -> json


def _save_init(cfg, path, seed=0):
    """A seeded port state_dict with the zero-initialised heads made
    non-zero, for the configs without a JAX twin here."""
    model = build_model(cfg, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.05, generator=g)
    torch.save(model.state_dict(), path)


def one_process(case):
    """The port's one-process steps of ``case`` (no layout): losses, the
    state after them and the last step's gradients."""
    cfg = case["config"]
    model = build_model(cfg)
    model.load_state_dict(torch.load(case["init"], weights_only=True))
    model.train(bool(case.get("train_mode")))
    optimizer, scheduler = make_optimizer(model, cfg, 1)
    generator = torch.Generator().manual_seed(cfg["seed"])
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg, generator)
    data = np.load(case["batch"])
    batch = {"image": torch.from_numpy(data["image"]),
             "seg": torch.from_numpy(data["seg"])}
    losses = [{k: float(v) for k, v in step(batch).items()}
              for _ in range(int(case.get("steps", 1)))]
    return types.SimpleNamespace(
        losses=losses, state={k: v.clone() for k, v in
                              model.state_dict().items()},
        grads={n: p.grad.clone() for n, p in model.named_parameters()},
        lr=cfg["trainer"]["lr"])


def jax_mesh_step(cfg, params, image, seg, dp=2, sp=1):
    """The JAX package's train step on a ``dp x sp`` CPU mesh (dp 2 by
    default); the Focused Decoder's fixed 0.1 output dropout is set to 0
    (the port steps in ``eval()``). Returns (losses, new params as a port
    state_dict)."""
    import flax.linen as flax_nn
    import jax

    from transoar_tpu.models import focused_decoder as jfd
    from transoar_tpu.models.criterion import Criterion
    from transoar_tpu.models.transoarnet import build_transoarnet
    from transoar_tpu.parallel import mesh as jmesh
    from transoar_tpu.training.train_state import (TrainState,
                                                   make_optimizer as jopt)
    from transoar_tpu.training.trainer import make_train_step as jstep

    no_drop = types.SimpleNamespace(**{k: getattr(flax_nn, k)
                                       for k in dir(flax_nn)
                                       if not k.startswith("__")})
    no_drop.Dropout = lambda rate, **kw: flax_nn.Dropout(0.0, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfd, "nn", no_drop)
        jmodel = build_transoarnet(cfg)
        mesh = jmesh.make_mesh(dp=dp, sp=sp,
                               devices=jax.devices()[:dp * sp])
        rep = jmesh.replicated(mesh)
        state = TrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=jopt(cfg, 1))
        step = jax.jit(jstep(jmodel, Criterion(cfg), cfg, jmodel.anchors,
                             mesh=mesh), out_shardings=(rep, rep))
        new, losses = step(jax.device_put(state, rep),
                           jmesh.shard_batch({"image": image, "seg": seg},
                                             mesh), jax.random.key(1))
        new_params = jax.tree.map(np.asarray, new.params)
    return ({k: float(v) for k, v in losses.items()},
            state_dict_from_jax(new_params, cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel")
    cfg = _flagship()
    image, seg = synthetic_batch(cfg, batch_size=BATCH, seed=1)
    seg = _uneven(seg, (2, 3))
    np.savez(out / "flagship.npz", image=image, seg=seg)
    from transoar_tpu.models.transoarnet import build_transoarnet

    params = init_params(build_transoarnet(cfg), image, seed=0)
    torch.save({k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
                state_dict_from_jax(params, cfg).items()}, out / "init.pt")
    flag = dict(config=cfg, init=str(out / "init.pt"),
                batch=str(out / "flagship.npz"))

    clip = copy.deepcopy(cfg)
    clip["trainer"]["clip_max_norm"] = 0.05
    accum = copy.deepcopy(cfg)
    accum["trainer"]["grad_accum_steps"] = 2
    dropout = copy.deepcopy(cfg)
    dropout["neck"]["dropout"] = 0.1
    nan = copy.deepcopy(cfg)
    nan["trainer"]["nan_guard"] = "skip"
    two = [dict(flag, name="dp2", dp=2),
           dict(flag, name="fsdp2_clip", dp=2, fsdp=True, config=clip,
                steps=2),
           dict(flag, name="tp2_accum", tp=2, config=accum, steps=2),
           dict(flag, name="tp2_dropout", tp=2, config=dropout,
                train_mode=True),
           dict(flag, name="nan_dp2", dp=2, config=nan, nan_rank=1)]
    swin = presets.tiny_swin_config(num_organs=3)
    swin["trainer"].update(batch_size=BATCH, precision="float32")
    swin = json.loads(json.dumps(swin))
    simage, sseg = synthetic_batch(swin, batch_size=BATCH, seed=5)
    np.savez(out / "swin.npz", image=simage, seg=sseg)
    _save_init(swin, out / "swin.pt")
    two.append(dict(name="swin_dp2", dp=2, config=swin,
                    init=str(out / "swin.pt"), batch=str(out / "swin.npz")))
    for family, drop in (("seg", (2,)), ("detr", (2, 3)), ("retina", (3,))):
        fcfg = _family(family)
        fimage, fseg = synthetic_batch(fcfg, batch_size=BATCH, seed=4)
        np.savez(out / f"{family}.npz", image=fimage,
                 seg=_uneven(fseg, drop))
        _save_init(fcfg, out / f"{family}.pt")
        two.append(dict(name=f"{family}_dp2", dp=2, config=fcfg,
                        init=str(out / f"{family}.pt"),
                        batch=str(out / f"{family}.npz")))
    four = [dict(flag, name="dp2tp2_fsdp", dp=2, tp=2, fsdp=True,
                 config=clip, checkpoint=True)]
    ports = free_ports(2)  # the two groups start at once
    procs = launch(two, 2, out, port=ports[0]) + launch(four, 4, out,
                                                        port=ports[1])
    try:
        ref = {c["name"]: one_process(c) for c in two + four}
        jax_losses, jax_new = jax_mesh_step(cfg, params, image, seg)
    finally:
        wait(procs)
    done = {**results(two, 2, out), **results(four, 4, out)}
    return types.SimpleNamespace(
        out=out, cases={c["name"]: c for c in two + four}, ref=ref,
        results={k: v[0] for k, v in done.items()},
        local={k: v[1] for k, v in done.items()}, jax_losses=jax_losses,
        jax_new=jax_new, init=torch.load(out / "init.pt"))


def _assert_state_matches(got, ref):
    top = max(float(g.abs().max()) for g in ref.grads.values())
    assert set(got) == set(ref.state)
    for name, want in ref.state.items():
        have = got[name]
        assert have.shape == want.shape, name
        grad = ref.grads.get(name)
        if grad is None:
            torch.testing.assert_close(have, want, rtol=0, atol=5e-5)
            continue
        noise = torch.cat([(grad.abs() <= NOISE * top).ravel(),
                           torch.tensor([True, False])])
        err = torch.cat([(have - want).abs().ravel(), torch.zeros(2)])
        assert float(err[~noise].max()) <= 5e-5, name
        assert float(err[noise].max()) <= 2 * ref.lr, name


@pytest.mark.parametrize("name", ["dp2", "fsdp2_clip", "tp2_accum",
                                  "tp2_dropout", "dp2tp2_fsdp", "swin_dp2"])
def test_step_matches_one_process(runs, name):
    """dp 2 (DDP), FSDP2 over dp 2 with the clip active over two steps, tp 2
    with two accumulated calls, tp 2 with dropout (the tp ranks draw the
    one-process masks), dp 2 x tp 2 under FSDP2 with the clip, the SwinFPN
    under dp 2 (kernels 4-5's Function)."""
    ref, got = runs.ref[name], runs.results[name]
    assert len(got["losses"]) == len(ref.losses)
    for mine, want in zip(got["losses"], ref.losses):
        assert mine.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(mine[key], want[key], rtol=2e-4,
                                       atol=1e-7, err_msg=key)
    _assert_state_matches(got["state"], ref)


def test_clip_was_active(runs):
    """The clip cases clip: the one-process gradients after the step have
    the clip's norm (the global norm was above it)."""
    for name in ("fsdp2_clip", "dp2tp2_fsdp"):
        grads = runs.ref[name].grads.values()
        norm = float(torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in grads])))
        assert norm == pytest.approx(0.05, rel=1e-4)


def test_wrappers_and_shards(runs):
    """DDP prefixes the names, FSDP2 holds DTensors, tp shards the planned
    parameters; every case but the NaN one stepped AdamW once a rank."""
    local = runs.local
    assert all(r["prefixed"] and not r["dtensor_params"]
               for r in local["dp2"])
    assert all(r["dtensor_params"] and not r["prefixed"]
               for r in local["fsdp2_clip"] + local["dp2tp2_fsdp"])
    model = build_model(runs.cases["dp2"]["config"])
    planned = len(tp_lib.tp_plan(model, 2))
    assert planned >= 18
    assert all(r["tp_sharded"] == planned
               for r in local["tp2_accum"] + local["dp2tp2_fsdp"])
    assert all(r["tp_sharded"] == 0 for r in local["dp2"])
    for name, ranks in local.items():
        steps = int(runs.cases[name].get("steps", 1)) // (
            2 if name == "tp2_accum" else 1)
        if name != "nan_dp2":
            assert all(r["adam_steps"] == [steps] for r in ranks), name
    # make_optimizer's two groups through DDP's ``module.`` prefix
    plain, _ = make_optimizer(model, runs.cases["dp2"]["config"])
    want = {g["name"]: len(g["params"]) for g in plain.param_groups}
    for name in ("dp2", "fsdp2_clip", "tp2_accum", "dp2tp2_fsdp"):
        assert all(r["groups"] == want for r in local[name]), name


def test_custom_functions_see_plain_local_tensors(runs):
    """Under DDP, FSDP2 (which hands the forward its unsharded parameters),
    tp and FSDP2 + tp, the band conv's and the window attention's custom
    autograd Functions are handed plain tensors, never DTensors."""
    for name in ("dp2", "fsdp2_clip", "tp2_accum", "dp2tp2_fsdp",
                 "swin_dp2"):
        for facts in runs.local[name]:
            seen = facts["function_inputs"]
            assert "_PackedConv" in seen, name
            kinds = set().union(*seen.values())
            assert kinds <= {"Tensor", "Parameter"}, (name, seen)
    assert all("_WindowAttention" in facts["function_inputs"]
               for facts in runs.local["swin_dp2"])


def test_dp2_matches_the_jax_mesh_step(runs):
    ref, got = runs.ref["dp2"], runs.results["dp2"]
    np.testing.assert_allclose(got["losses"][0]["total"],
                               runs.jax_losses["total"], rtol=1e-4)
    for name, grad in ref.grads.items():
        decided = grad.abs() > 1e-4 * grad.abs().max()
        lr = ref.lr if not name.startswith("_backbone.") else \
            runs.cases["dp2"]["config"]["trainer"]["lr_backbone"]
        np.testing.assert_allclose(
            (got["state"][name] - runs.init[name])[decided].numpy(),
            (torch.as_tensor(runs.jax_new[name]) - runs.init[name])[decided]
            .numpy(), rtol=0.05, atol=0.25 * lr, err_msg=name)


@pytest.mark.parametrize("family", ["seg", "detr", "retina"])
def test_batch_coupled_losses(runs, family):
    """The seg proxy's batch SoftDice, DETR's and RetinaNet's normalizers
    under dp 2 give the one-process batch-4 loss and step, with the ranks
    holding different present counts (a per-rank normalizer would not)."""
    name = f"{family}_dp2"
    data = np.load(runs.cases[name]["batch"])
    counts = [len(np.unique(data["seg"][r])) for r in range(BATCH)]
    assert counts[:2] != counts[2:]
    ref, got = runs.ref[name], runs.results[name]
    for key, want in ref.losses[0].items():
        np.testing.assert_allclose(got["losses"][0][key], want, rtol=2e-4,
                                   atol=1e-7, err_msg=key)
    if family == "seg":
        assert ref.losses[0]["segdice"] > 0
    _assert_state_matches(got["state"], ref)


def test_nan_guard_skip_drops_the_update_on_every_rank(runs):
    """Rank 1's rows are NaN: the global loss is not finite, and no rank
    steps (no AdamW state, the weights as they started)."""
    got = runs.results["nan_dp2"]
    assert not np.isfinite(got["losses"][0]["total"])
    assert all(r["adam_steps"] == [] for r in runs.local["nan_dp2"])
    for name, value in runs.init.items():
        assert torch.equal(got["state"][name], value), name


def test_checkpoint_under_fsdp_and_tp(tmp_path, runs):
    """The dp 2 x tp 2 FSDP2 checkpoint holds the one-process layout
    (reference names, no prefix, whole tensors, the optimizer's own
    state_dict layout), loads into one process unchanged, and restores
    into the sharded run as it was."""
    got = runs.results["dp2tp2_fsdp"]
    saved = torch.load(runs.out / "dp2tp2_fsdp.pt", weights_only=True)
    model = build_model(runs.cases["dp2tp2_fsdp"]["config"])
    assert set(saved["model"]) == set(model.state_dict())
    model.load_state_dict(saved["model"])
    for name, value in got["state"].items():
        assert type(saved["model"][name]) is torch.Tensor
        torch.testing.assert_close(saved["model"][name], value, rtol=0,
                                   atol=0)
    optimizer, _ = make_optimizer(model, runs.cases["dp2tp2_fsdp"]["config"])
    optimizer.load_state_dict(saved["optimizer"])
    assert len(optimizer.state) == len(list(model.parameters()))
    restored = got["restored"]
    assert (restored["epoch"], restored["best"]) == (1, 0.5)
    for name, value in got["state"].items():
        assert torch.equal(restored["state"][name], value), name
    for i, st in got["optimizer"]["state"].items():
        for key, value in st.items():
            assert torch.equal(restored["optimizer"]["state"][i][key],
                               value), (i, key)


@pytest.mark.parametrize("family", ["flagship", "detr"])
def test_tp_rule_matches_jax_param_pspec(family):
    """Each tp rank's shard of every port parameter holds exactly the
    values the JAX ``param_pspec`` rule gives that rank of the mapped flax
    leaves (every flax element carries a distinct value through
    ``state_dict_from_jax``): the same leaves sharded, on the mapped axis,
    the packed ``in_proj_weight`` chunk by chunk."""
    from transoar_tpu.models.transoarnet import build_transoarnet
    from transoar_tpu.parallel.tp import _divides, _path_key_names, \
        param_pspec
    import jax

    tp = 2
    cfg = _flagship() if family == "flagship" else _family("detr")
    patch = cfg["augmentation"]["patch_size"]
    shapes = init_params(build_transoarnet(cfg),
                         np.zeros((1, *patch, 1), np.float32))
    counter = iter(range(1, 1 << 30))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    tree, per_rank = [], [set() for _ in range(tp)]
    for path, leaf in leaves:
        n = int(np.prod(leaf.shape))
        values = np.array([next(counter) for _ in range(n)],
                          np.float64).reshape(leaf.shape)
        tree.append(values)
        spec = param_pspec(_path_key_names(path), leaf.shape)
        axis = list(spec).index("tp") if (
            "tp" in spec and _divides(spec, leaf.shape, tp)) else None
        for r in range(tp):
            part = values if axis is None else np.split(values, tp,
                                                        axis)[r]
            per_rank[r].update(part.ravel().tolist())
    full = state_dict_from_jax(jax.tree_util.tree_unflatten(treedef, tree),
                               cfg)
    model = build_model(cfg)
    plan = tp_lib.tp_plan(model, tp)
    names = {n for n, _ in model.named_parameters()}
    assert any(n.endswith("in_proj_weight") for n in plan)
    assert any(n.endswith("linear2.weight") for n in plan)
    for name in names:
        whole = torch.as_tensor(np.asarray(full[name], np.float64))
        for r in range(tp):
            mine = whole if name not in plan else tp_lib.shard_tensor(
                whole, *plan[name], r, tp)
            want = set(whole.ravel().tolist()) & per_rank[r]
            assert mine.numel() == len(want), (name, r)
            assert set(mine.ravel().tolist()) == want, (name, r)


def test_packed_in_proj_shard_is_per_chunk():
    """Rank r of tp 2 holds rows [rC/2, (r+1)C/2) of each of q, k, v."""
    C = 8
    full = torch.arange(3 * C, dtype=torch.float32)[:, None].expand(3 * C, 2)
    for r in range(2):
        rows = tp_lib.shard_tensor(full, 0, 3, r, 2)[:, 0].tolist()
        assert rows == [i * C + j for i in range(3)
                        for j in range(r * C // 2, (r + 1) * C // 2)]
    parts = [tp_lib.shard_tensor(full, 0, 3, r, 2) for r in range(2)]
    assert torch.equal(tp_lib.unshard_tensors(parts, 0, 3), full)


@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 1), (2, 2), (1, 2)])
def test_local_batch_rows_cover_the_epoch(tmp_path, dp, tp):
    """The ranks' rows of each global batch together are the one-process
    batch, each dp index its own block, the tp ranks of one dp index the
    same rows; ``Loader(rows=...)`` and the host augmenter give each rank
    the one-process rows bit for bit."""
    from transoar_tpu_torch.data import dataset
    from transoar_tpu_torch.data.synthetic import generate_dataset
    from transoar_tpu_torch.data.transforms import HostAugmentingLoader

    generate_dataset(tmp_path, name="syn", shape=(16, 12, 8), num_classes=3,
                     num_train=8, num_val=0, num_test=0, seed=2)
    cfg = tiny_config(num_organs=3)
    cfg.update(dataset="syn")
    cfg["trainer"].update(batch_size=4, num_workers=2, shuffle=True)
    aug = dict(cfg["augmentation"], use_augmentation=True)
    stats = {"percentile_00_5": -0.5, "percentile_99_5": 1.5}
    whole = HostAugmentingLoader(
        dataset.get_loader(cfg, "train", data_dir=tmp_path), aug, stats,
        seed=3, workers=2)
    ranks = []
    for rank in range(dp * tp):
        layout = types.SimpleNamespace(dp=dp, dp_rank=rank // tp,
                                       world=dp * tp)
        rows = mesh_lib.local_batch_rows(layout, 4)
        assert rows.tolist() == list(range(rank // tp * (4 // dp),
                                           (rank // tp + 1) * (4 // dp)))
        loader = dataset.get_loader(cfg, "train", data_dir=tmp_path,
                                    rows=rows)
        assert isinstance(loader, dataset.Loader)  # rows: the Python loader
        ranks.append((rows, HostAugmentingLoader(loader, aug, stats, seed=3,
                                                 workers=2)))
    for _ in range(2):  # two epochs: the per-epoch shuffle agrees
        batches = list(whole)
        per_rank = [list(loader) for _, loader in ranks]
        for step, batch in enumerate(batches):
            for (rows, _), mine in zip(ranks, per_rank):
                for key in ("image", "seg", "index"):
                    np.testing.assert_array_equal(mine[step][key],
                                                  batch[key][rows])
    with pytest.raises(ValueError, match="split"):
        mesh_lib.local_batch_rows(types.SimpleNamespace(
            dp=3, dp_rank=0, world=3), 4)


def test_one_process_builds_nothing(monkeypatch, tmp_path):
    """Without torchrun's environment: no process group, no layout, no
    rows, and the trainer's model is the plain module with the reference
    names."""
    import torch.distributed as dist

    from transoar_tpu_torch.training.trainer import Trainer

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.init_distributed("cpu") is None
    assert not dist.is_initialized()
    cfg = _flagship()
    assert mesh_lib.layout_from_config(cfg, "cpu") is None
    assert mesh_lib.local_batch_rows(None, 4) is None
    model = build_model(cfg)
    trainer = Trainer(cfg, model, [], [], tmp_path, "cpu")
    assert trainer._model is model and trainer._layout is None
    assert not any(k.startswith("module.") for k in model.state_dict())
    assert all(getattr(m, "sp", None) is None for m in model.modules())


def test_train_cli_under_torchrun(tmp_path):
    """``torch.distributed.run --nproc_per_node=2 -m
    transoar_tpu_torch.train`` with ``parallel.fsdp: true, tp: 2`` (gloo)
    trains one short epoch and writes the run; one-process ``test`` and
    ``predict`` load its checkpoint, and ``predict``'s boxes are those of a
    plain model holding the checkpoint's gathered weights."""
    from transoar_tpu_torch import predict, test
    from transoar_tpu_torch.data.synthetic import generate_dataset
    from transoar_tpu_torch.data.transforms import eval_transform
    from transoar_tpu_torch.training import checkpoints as ckpt_lib

    cfg = presets.tiny_flagship_config(num_organs=3)
    for key in ("bbox_properties", "labels", "labels_small", "labels_mid",
                "labels_large", "foreground_voxel_statistics"):
        cfg.pop(key, None)
    cfg.update(dataset="syn", experiment_name="tp_fsdp", debug_mode=False)
    cfg["augmentation"]["use_augmentation"] = False
    cfg["trainer"].update(epochs=1, batch_size=2, num_workers=2)
    cfg["parallel"] = {"dp": -1, "sp": 1, "tp": 2, "fsdp": True}
    generate_dataset(tmp_path / "dataset", name="syn",
                     shape=tuple(cfg["augmentation"]["patch_size"]),
                     num_classes=3, num_train=4, num_val=2, num_test=0,
                     seed=1)
    (tmp_path / "tp_fsdp.yaml").write_text(yaml.safe_dump(
        json.loads(json.dumps(cfg))))
    port = free_ports()[0]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=f"{ROOT}{os.pathsep}"
                          f"{os.environ.get('PYTHONPATH', '')}")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         f"--master_port={port}", "-m", "transoar_tpu_torch.train",
         "--config", str(tmp_path / "tp_fsdp.yaml"), "--data_dir",
         str(tmp_path / "dataset"), "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    run = tmp_path / "runs" / "tp_fsdp"
    last = torch.load(run / "model_last.pt", weights_only=True)
    config = ckpt_lib.load_run_config(run)
    plain = build_model(config)
    assert set(last["model"]) == set(plain.state_dict())
    for name, value in plain.state_dict().items():
        assert last["model"][name].shape == value.shape, name
    # one epoch of 2 steps: every parameter's AdamW state stepped twice
    # (the validation's checkpoint before the first step made no state)
    assert last["epoch"] == 1
    assert len(last["optimizer"]["state"]) == len(last["model"])
    assert {int(st["step"]) for st in last["optimizer"]["state"].values()} \
        == {2}
    assert "mesh dp 1 x sp 1 x tp 2, FSDP2" in (tmp_path / "logs" /
                                               "train.log").read_text()

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        metrics = test.main(["--run", "tp_fsdp", "--val", "--last",
                             "--data_dir", str(tmp_path / "dataset"),
                             "--device", "cpu"])
        inputs = presets.write_ct_volumes(tmp_path, [(40, 36, 20)], seed=2)
        records = predict.main(["--run", "tp_fsdp", "--input", *inputs,
                                "--last", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert np.isfinite(metrics["mAP_coco"])

    plain.load_state_dict(last["model"])
    plain.eval()
    stats = config.get("foreground_voxel_statistics")

    @torch.inference_mode()
    def forward(image):
        x = eval_transform(torch.as_tensor(image, dtype=torch.float32),
                           stats)
        return {k: v.numpy() for k, v in plain(x).items()}

    want = predict.predict_case(inputs[0], config, forward)[0]
    got = records[0]["detections"]
    assert len(got) == len(want) > 0
    for mine, ref in zip(got, want):
        assert mine["class"] == ref["class"]
        np.testing.assert_allclose(mine["box_cxcyczwhd_norm"],
                                   ref["box_cxcyczwhd_norm"], rtol=0,
                                   atol=1e-6)
