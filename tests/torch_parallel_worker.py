"""One rank of the port's multi-process tests (``tests/test_torch_parallel.py``,
``tests/test_torch_parallel_cuda.py``), jax-free.

Launched once per rank with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), which
``launch`` sets:

    python tests/torch_parallel_worker.py SPEC.json OUT_DIR [--device D]
        [--backend gloo|nccl]

``SPEC.json`` holds ``cases``, each run in turn by every rank:

- ``name``; ``config`` (the run config, json); ``dp``, ``sp``, ``tp``,
  ``fsdp`` (the mesh; ``tp_always`` shards the neck over a one-rank tp
  group too);
- ``init``: a port state_dict file (the step's start), ``batch``: an npz of
  the global ``image`` / ``seg`` batch; each rank steps on its rows
  (``parallel.mesh.local_batch_rows``);
- ``steps`` (train steps on the same batch, default 1), ``train_mode``
  (dropout on; else ``eval()``), ``nan_rank`` (that rank's rows turned to
  NaN), ``checkpoint`` (save under the layout, restore into a fresh
  wrapped model and gather again, the accumulation of
  ``trainer.grad_accum_steps`` included);
- or ``kind: "sp_primitives"``: f64 gradchecks of ``parallel/sp.py``'s
  halo, gather, scatter, all-reduce and roll over an sp group of every
  rank, each between a ``scatter`` of a whole tensor and a ``gather``, and
  their forward values against the whole-tensor reference.

Rank 0 writes ``OUT_DIR/<name>.result.pt``: the losses of each step, the
gathered state and gradients after the last, and what the case asked
for; every rank
writes ``OUT_DIR/<name>.rank<r>.pt`` with its local facts (AdamW steps,
the optimizer's groups, the number of tp-sharded and DTensor parameters,
the band conv's and the window attention's kernel launches, which count
only on a card, the tensor types the custom autograd Functions were
handed, and the sp plan).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from transoar_tpu_torch.models.criterion import build_criterion  # noqa: E402
from transoar_tpu_torch.models.transoarnet import build_model  # noqa: E402
from transoar_tpu_torch.parallel import fsdp as fsdp_lib  # noqa: E402
from transoar_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from transoar_tpu_torch.parallel import tp as tp_lib  # noqa: E402
from transoar_tpu_torch.training import checkpoints as ckpt_lib  # noqa: E402
from transoar_tpu_torch.training.train_state import make_optimizer  # noqa
from transoar_tpu_torch.training.trainer import make_train_step  # noqa: E402


def free_ports(n=1):
    """``n`` distinct free localhost ports for process groups' rendezvous
    (held open together while chosen, so two groups started at once do
    not get the same one)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def launch(cases, world, out, device="cpu", backend=None, port=None):
    """Start ``world`` ranks of this worker over ``cases`` (on ``port``, a
    fresh localhost port by default; one thread a rank); returns the
    processes."""
    spec = Path(out) / f"spec{world}.json"
    spec.write_text(json.dumps({"cases": cases},
                               default=lambda o: o.tolist()))
    port = free_ports()[0] if port is None else port
    args = [sys.executable, str(Path(__file__)), str(spec), str(out),
            "--device", device] + (["--backend", backend] if backend else [])
    return [subprocess.Popen(
        args, env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT) for r in range(world)]


def wait(procs, timeout=240):
    """Wait for the ranks; fails with the log of each rank that failed."""
    logs = [p.communicate(timeout=timeout)[0] for p in procs]
    failed = [f"rank {r}:\n{log[-3000:]}" for r, (p, log) in
              enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, "\n".join(failed)


def results(cases, world, out):
    """{case name: (rank 0's record, [each rank's local facts])}."""
    out = Path(out)
    return {c["name"]: (torch.load(out / f"{c['name']}.result.pt",
                                   weights_only=False),
                        [torch.load(out / f"{c['name']}.rank{r}.pt")
                         for r in range(world)]) for c in cases}


def _band_conv_wrappers():
    """The band conv's three wrappers (kernels 1-3) and the window
    attention's two (kernels 4-5), whose ``launches`` count their kernels
    on a card."""
    from transoar_tpu_torch.ops.kernels import packed_conv as pc
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    return {"packed_conv": pc.packed_conv, "packed_conv_dx": pc.packed_conv_dx,
            "packed_conv_dw": pc.packed_conv_dw,
            "fused_window_attention": wa.fused_window_attention,
            "fused_window_attention_bwd": wa.fused_window_attention_bwd}


# the types each custom autograd Function (the band conv's, kernels 1-3;
# the window attention's, kernels 4-5) was handed in the current case
SEEN = {}


def _spy_on_functions():
    """Record the tensor types every call of the two Functions gets."""
    from transoar_tpu_torch.ops.kernels import packed_conv as pc
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    for fn in (pc._PackedConv, wa._WindowAttention):
        def forward(ctx, *args, _orig=fn.forward, _name=fn.__name__):
            SEEN.setdefault(_name, set()).update(
                type(a).__name__ for a in args if torch.is_tensor(a))
            return _orig(ctx, *args)

        fn.forward = staticmethod(forward)


def build(case, device):
    """(wrapped model, optimizer, scheduler, layout) of ``case``."""
    cfg = case["config"]
    layout = mesh_lib.Layout(mesh_lib.make_mesh(
        case.get("dp", -1), case.get("sp", 1), case.get("tp", 1),
        device.type), fsdp=case.get("fsdp", False))
    model = build_model(cfg, device=device)
    model.load_state_dict(torch.load(case["init"], weights_only=True))
    model.train(bool(case.get("train_mode")))
    model = fsdp_lib.parallelize(model, layout, device,
                                 tp_always=case.get("tp_always", False))
    optimizer, scheduler = make_optimizer(model, cfg, 1)
    return model, optimizer, scheduler, layout


def _whole_grads(model, layout):
    """Every parameter's gradient after the last step, whole, under its
    reference name (a collective of every rank)."""
    grads = {n.removeprefix("module."): p.grad
             for n, p in model.named_parameters() if p.grad is not None}
    grads = {n: g.full_tensor() if hasattr(g, "full_tensor") else g
             for n, g in grads.items()}
    plan = getattr(fsdp_lib.unwrap(model), "tp_plan", {})
    grads = tp_lib.gather_state(grads, plan, layout.tp_group, layout.tp)
    return {n: g.detach().cpu() for n, g in grads.items()}


def run_case(case, out, device):
    cfg = case["config"]
    model, optimizer, scheduler, layout = build(case, device)
    generator = torch.Generator(device=device).manual_seed(
        layout.generator_seed(cfg["seed"]))
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg, generator, layout)
    data = np.load(case["batch"])
    image, seg = data["image"], data["seg"]
    rows = mesh_lib.local_batch_rows(layout, image.shape[0])
    if rows is not None:
        image, seg = image[rows], seg[rows]
    if case.get("nan_rank") == layout.rank:
        image = np.full_like(image, np.nan)
    batch = {"image": torch.from_numpy(image).to(device),
             "seg": torch.from_numpy(seg).to(device)}
    for fn in _band_conv_wrappers().values():
        fn.launches = 0
    SEEN.clear()
    losses = []
    for _ in range(int(case.get("steps", 1))):
        losses.append({k: float(v) for k, v in step(batch).items()})
    record = {"losses": losses,
              "state": ckpt_lib.model_state_dict(model, layout),
              "grads": _whole_grads(model, layout)}
    local = {"adam_steps": sorted({int(s["step"]) for s in
                                   optimizer.state.values()}),
             "tp_sharded": sum(tp_lib.tp_sharded(model)),
             "dtensor_params": sum(hasattr(p, "to_local")
                                   for p in model.parameters()),
             "prefixed": any(n.startswith("module.")
                             for n, _ in model.named_parameters()),
             "groups": {g["name"]: len(g["params"])
                        for g in optimizer.param_groups},
             "function_inputs": {k: sorted(v) for k, v in SEEN.items()},
             "sp_plan": getattr(fsdp_lib.unwrap(model), "sp_plan", None)}
    local["launches"] = {name: fn.launches
                         for name, fn in _band_conv_wrappers().items()}
    if case.get("checkpoint"):
        ckpt_lib.save_training_checkpoint(out, case["name"], model,
                                          optimizer, scheduler, 1, 0.5,
                                          layout, step.update)
        dist.barrier()
        again, opt2, sched2, _ = build(case, device)
        step2 = make_train_step(again, build_criterion(cfg), opt2, sched2,
                                cfg, None, layout)
        epoch, best = ckpt_lib.restore_checkpoint(
            out / f"{case['name']}.pt", again, opt2, sched2, device, layout,
            step2.update)
        record["restored"] = {
            "epoch": epoch, "best": best,
            "state": ckpt_lib.model_state_dict(again, layout),
            "optimizer": ckpt_lib.optimizer_state_dict(again, opt2, layout),
            "accumulation": ckpt_lib.accumulation_state(again, step2.update,
                                                        layout)}
        record["optimizer"] = ckpt_lib.optimizer_state_dict(
            model, optimizer, layout)
        record["accumulation"] = ckpt_lib.accumulation_state(
            model, step.update, layout)
    torch.save(local, out / f"{case['name']}.rank{layout.rank}.pt")
    if layout.rank == 0:
        torch.save(record, out / f"{case['name']}.result.pt")
    dist.barrier()


def run_sp_primitives(case, out, device):
    """f64 gradchecks of the sp primitives over every rank, in lockstep:
    each runs between a ``scatter`` of a whole tensor (the same on every
    rank) and a ``gather``, so its Jacobian is that of the whole-tensor
    function on every rank iff the backwards follow the gradient design of
    ``parallel/sp.py``; and the forward values against the whole-tensor
    reference."""
    from torch.autograd import gradcheck

    from transoar_tpu_torch.parallel import sp as sp_lib

    layout = mesh_lib.Layout(mesh_lib.make_mesh(1, dist.get_world_size(),
                                                1, device.type))
    shard = layout.sp_shard
    n = shard.size
    L = 4  # > 3: roll 3 crosses one rank boundary, wrapping at the ends
    whole = torch.randn(2, n * L, 1, 2, dtype=torch.float64, device=device,
                        generator=torch.Generator(device).manual_seed(0))

    def around(fn):
        return lambda x: sp_lib.gather(fn(sp_lib.scatter(x, shard)), shard)

    def padded(lo, hi):  # each rank's block with its halo, concatenated
        full = torch.nn.functional.pad(whole, (0, 0, 0, 0, lo, hi))
        return torch.cat([full[:, r * L:r * L + lo + L + hi]
                          for r in range(n)], 1)

    fns = {
        "halo_1_1": (around(lambda x: sp_lib.halo(x, 1, 1, shard)),
                     padded(1, 1)),
        "halo_2_0": (around(lambda x: sp_lib.halo(x, 2, 0, shard)),
                     padded(2, 0)),
        "roll_-1": (around(lambda x: sp_lib.roll(x, -1, shard)),
                    torch.roll(whole, -1, 1)),
        "roll_3": (around(lambda x: sp_lib.roll(x, 3, shard)),
                   torch.roll(whole, 3, 1)),
        "gather_scatter": (around(lambda x: x.square()), whole.square()),
        "all_reduce": (around(lambda x: sp_lib.all_reduce(
            x.sum(1, keepdim=True), shard).expand_as(x) * x),
            whole.sum(1, keepdim=True) * whole),
    }
    record = {"gradcheck": {}, "forward_err": {}}
    for name, (fn, want) in fns.items():
        with torch.no_grad():
            record["forward_err"][name] = float((fn(whole) - want).abs()
                                                .max())
        record["gradcheck"][name] = gradcheck(
            fn, (whole.clone().requires_grad_(),), raise_exception=False)
    if layout.rank == 0:
        torch.save(record, out / f"{case['name']}.result.pt")
    torch.save({}, out / f"{case['name']}.rank{layout.rank}.pt")
    dist.barrier()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("spec")
    parser.add_argument("out")
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--backend", default=None)
    args = parser.parse_args()
    device = mesh_lib.init_distributed(args.device, args.backend)
    assert device is not None, "launch with torchrun's environment"
    # f32 in full f32 on a card too (cuDNN's convs default to TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    _spy_on_functions()
    try:
        for case in json.loads(Path(args.spec).read_text())["cases"]:
            if case.get("kind") == "sp_primitives":
                run_sp_primitives(case, out, device)
            else:
                run_case(case, out, device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
