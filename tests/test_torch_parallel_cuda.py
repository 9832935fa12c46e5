"""Multi-process training of the port on a card (jax-free): the tiny
flagship (f32, ``stage0_pack: 4``, so the band conv's kernels 1-3 run on
the card) stepped by ranks of ``tests/torch_parallel_worker.py`` against
the one-process step on the same card.

- one rank over NCCL under DDP, FSDP2 and the tp code path (``tp_always``:
  the neck's Megatron modules over a one-rank group), each launching the
  band conv's forward, dx and dw kernels;
- two ranks sharing the card over gloo (NCCL refuses two ranks on one
  device): dp 2 (DDP) and tp 2. FSDP2's reduce-scatter has no gloo
  implementation for CUDA tensors, so its two-rank case runs on the CPU
  (``tests/test_torch_parallel.py``);
- two ranks sharing the card over gloo at sp 2: the spatial axis's
  primitives (f64 gradchecks) and the tiny flagship's step on each rank's
  half of S0 (``tests/test_torch_sp.py`` holds the CPU cases).

Tolerances: the loss within rtol 2e-4, each parameter within atol 5e-5
where the one-process gradient is above float noise, within the learning
rate elsewhere (see ``tests/test_torch_parallel.py``).

Every test carries the ``cuda`` marker (registered in pytest.ini) and
skips without a CUDA device. On a card:
``python -m pytest --noconftest -q -m cuda tests/test_torch_parallel_cuda.py``.
"""

import numpy as np
import pytest
import torch

from tests.torch_parallel_worker import launch, results, wait
from transoar_tpu_torch.data.synthetic import make_case
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.presets import tiny_flagship_config
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.training.trainer import make_train_step

pytestmark = pytest.mark.cuda

BATCH = 2
# the band conv's wrappers (kernels 1-3) among the ranks' counts
_BAND_CONV = ("packed_conv", "packed_conv_dx", "packed_conv_dw")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the ranks' f32 is full f32 (the worker turns TF32 off), so is this one
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = tmp_path_factory.mktemp("parallel_cuda")
    cfg = tiny_flagship_config(num_organs=3)
    cfg["trainer"].update(precision="float32", batch_size=BATCH)
    cfg["neck"]["dropout"] = 0.0
    rng = np.random.default_rng(3)
    cases = [make_case(rng, cfg["augmentation"]["patch_size"],
                       cfg["bbox_properties"]) for _ in range(BATCH)]
    np.savez(out / "batch.npz",
             image=np.stack([c[0] for c in cases])[..., None]
             .astype(np.float32),
             seg=np.stack([c[1] for c in cases]).astype(np.int32))
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.normal_(0.0, 0.05, generator=g)
    torch.save(model.state_dict(), out / "init.pt")
    base = dict(config=cfg, init=str(out / "init.pt"),
                batch=str(out / "batch.npz"))
    return out, cfg, base


def _one_process(case):
    cfg = case["config"]
    model = build_model(cfg, device="cuda")
    model.load_state_dict(torch.load(case["init"], weights_only=True))
    model.eval()
    optimizer, scheduler = make_optimizer(model, cfg, 1)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg)
    data = np.load(case["batch"])
    losses = step({"image": torch.from_numpy(data["image"]).cuda(),
                   "seg": torch.from_numpy(data["seg"]).cuda()})
    return ({k: float(v) for k, v in losses.items()},
            {k: v.cpu() for k, v in model.state_dict().items()},
            {n: p.grad.cpu() for n, p in model.named_parameters()})


def _check(record, ref, lr):
    losses, state, grads = ref
    for key, want in losses.items():
        np.testing.assert_allclose(record["losses"][0][key], want, rtol=2e-4,
                                   atol=1e-7, err_msg=key)
    top = max(float(g.abs().max()) for g in grads.values())
    for name, want in state.items():
        err = (record["state"][name] - want).abs()
        decided = grads[name].abs() > 1e-6 * top if name in grads else \
            torch.ones_like(err, dtype=torch.bool)
        if decided.any():
            assert float(err[decided].max()) <= 5e-5, name
        assert float(err.max()) <= 2 * lr, name


def test_world1_nccl_under_each_wrapper(setup):
    out, cfg, base = setup
    cases = [dict(base, name="ddp1"), dict(base, name="fsdp1", fsdp=True),
             dict(base, name="tp1", tp_always=True)]
    wait(launch(cases, 1, out, device="cuda"))
    ref = _one_process(cases[0])
    for name, (record, ranks) in results(cases, 1, out).items():
        _check(record, ref, cfg["trainer"]["lr"])
        launches = ranks[0]["launches"]
        assert all(launches[k] > 0 for k in _BAND_CONV), (name, launches)
    assert results(cases, 1, out)["tp1"][1][0]["tp_sharded"] > 0


def test_two_ranks_share_the_card_over_gloo(setup):
    out, cfg, base = setup
    cases = [dict(base, name="dp2_card", dp=2),
             dict(base, name="tp2_card", tp=2)]
    wait(launch(cases, 2, out, device="cuda:0", backend="gloo"))
    ref = _one_process(cases[0])
    for name, (record, _) in results(cases, 2, out).items():
        _check(record, ref, cfg["trainer"]["lr"])


def test_sp_two_ranks_share_the_card_over_gloo(setup):
    """sp 2 on the card: f64 gradchecks of the halo, gather / scatter,
    all-reduce and roll (``parallel/sp.py``) on CUDA tensors over gloo,
    and the tiny flagship's step with each rank holding half of S0 against
    the one-process step, both ranks launching kernels 1-3."""
    out, cfg, base = setup
    cases = [dict(name="sp_primitives_card", kind="sp_primitives"),
             dict(base, name="sp2_card", sp=2)]
    wait(launch(cases, 2, out, device="cuda:0", backend="gloo"))
    done = results(cases, 2, out)
    record = done["sp_primitives_card"][0]
    assert all(record["gradcheck"].values()), record["gradcheck"]
    assert max(record["forward_err"].values()) < 1e-12
    record, ranks = done["sp2_card"]
    _check(record, _one_process(cases[1]), cfg["trainer"]["lr"])
    for facts in ranks:
        assert facts["sp_plan"] == ["sharded"] * 4
        assert all(facts["launches"][k] > 0 for k in _BAND_CONV)
