"""The port's spans (``transoar_tpu_torch.utils.spans``) on the CPU: off
without a profiler, the train step's and the served request's phases
under ``torch.profiler``, which spans take CUDA timing events (the
step's phases and the deformable refine), and the benchmark's ten readers
of them.

Tiny flagship (4 CNN stages, remat on), batch 2; a 48x40x20 int16
``.nii.gz`` served to its 32x32x16 grid.
"""

from __future__ import annotations

import importlib.util
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import predict, presets
from transoar_tpu_torch.data.nifti import write_nifti
from transoar_tpu_torch.models.criterion import build_criterion
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.training.train_state import make_optimizer
from transoar_tpu_torch.training.trainer import make_train_step
from transoar_tpu_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
STEP = ("step.inputs", "step.forward", "step.criterion", "step.backward",
        "step.update")
PREDICT = ("predict.read", "predict.reorient", "predict.resize",
           "predict.forward", "predict.decode")
METRICS = {f"predict.{k}_ms.serve": f"predict.{k}"
           for k in ("read", "reorient", "resize", "decode")} | \
          {f"step.{k}_ms.train": f"step.{k}"
           for k in ("inputs", "forward", "criterion", "backward", "update")} | \
          {"refine.forward_ms.train": "model.fpn.refine"}


@pytest.fixture(autouse=True)
def empty_registry():
    spans.clear()
    yield
    spans.clear()


@pytest.fixture(scope="module")
def tiny():
    """(config, model, train step, batch) of a tiny flagship at batch 2."""
    cfg = presets.tiny_flagship_config()
    cfg["trainer"]["batch_size"] = 2
    cfg["augmentation"]["use_augmentation"] = False
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    optimizer, scheduler = make_optimizer(model, cfg, 10)
    step = make_train_step(model, build_criterion(cfg), optimizer, scheduler,
                           cfg, torch.Generator().manual_seed(0))
    shape = tuple(cfg["augmentation"]["patch_size"])
    seg = torch.zeros(2, *shape, dtype=torch.long)
    seg[:, 4:12, 4:12, 2:8] = 1
    seg[:, 16:28, 10:20, 6:14] = 2
    batch = {"image": torch.randn(2, *shape, 1), "seg": seg}
    return cfg, model, step, batch


def _forward(model):
    @torch.inference_mode()
    def forward(image):
        out = model(torch.as_tensor(image, dtype=torch.float32))
        return {k: v.numpy() for k, v in out.items()}
    return forward


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    rng = np.random.default_rng(0)
    data = rng.integers(-1000, 1000, size=(48, 40, 20)).astype(np.int16)
    path = tmp_path_factory.mktemp("spans") / "case.nii.gz"
    write_nifti(data, path, affine=np.diag([-0.8, -0.8, 2.5, 1.0]))
    return str(path)


def test_off_without_a_profiler(tiny, volume):
    cfg, model, step, batch = tiny
    assert spans.span("step.forward") is spans.span("predict.read")
    with spans.span("step.forward"):
        pass
    step(batch)
    model.eval()
    try:
        predict.predict_case(volume, cfg, _forward(model))
    finally:
        model.train()
    assert spans.summary() == {}


def test_train_step_phases_once_and_no_recompute(tiny):
    cfg, model, step, batch = tiny
    step(batch)  # first call outside the profiler
    stages = len(model._backbone._encoder._stages)
    assert cfg["backbone"].get("remat", True) and stages == 4
    with torch.profiler.profile() as prof:
        start = time.perf_counter()
        step(batch)
        call_ms = 1e3 * (time.perf_counter() - start)
    got = spans.summary()
    for name in STEP + tuple(f"model.encoder.stage{i}"
                             for i in range(stages)):
        assert got[name]["calls"] == 1, name
        assert got[name]["device_ms"] == []  # no CUDA here
    assert {"model.fpn", "model.neck", "model.heads"} <= set(got)
    assert sum(got[n]["host_ms"][0] for n in STEP) <= call_ms
    ranges = {e.key for e in prof.key_averages()}
    assert set(got) <= ranges


def test_predict_case_phases_cover_the_call(tiny, volume):
    cfg, model, _, _ = tiny
    forward = _forward(model)
    model.eval()
    try:
        predict.predict_case(volume, cfg, forward)  # warm
        with torch.profiler.profile():
            start = time.perf_counter()
            dets, *_ = predict.predict_case(volume, cfg, forward)
            call_ms = 1e3 * (time.perf_counter() - start)
    finally:
        model.train()
    got = spans.summary()
    assert len(dets) == cfg["neck"]["num_organs"]
    for name in PREDICT:
        assert got[name]["calls"] == 1, name
    covered = sum(got[n]["host_ms"][0] for n in PREDICT)
    assert 0.9 * call_ms <= covered <= call_ms


def test_span_nests_and_closes_on_error():
    with torch.profiler.profile() as prof:
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("inner"):
                    raise ValueError
        with spans.span("outer"):
            pass
    got = spans.summary()
    assert got["outer"]["calls"] == 2 and got["inner"]["calls"] == 1
    assert got["inner"]["host_ms"][0] <= got["outer"]["host_ms"][0]
    assert {"outer", "inner"} <= {e.key for e in prof.key_averages()}
    assert spans.span("outer") is spans.span("inner")


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_metric_reads_its_span(metric):
    path = ROOT / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"span_metric_{metric}",
                                                  path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert reader.read(None) is None
    for host, device in ((1.0, 4.0), (3.0, 6.0), (2.0, 8.0)):
        spans._record(METRICS[metric], host, device)
    spans._record("other", 100.0, 100.0)
    # host phases read the median host ms, step phases the mean device ms
    want = 2.0 if metric.startswith("predict.") else 6.0
    assert reader.read(None) == pytest.approx(want)


def test_only_step_phases_take_events(monkeypatch):
    class Event:
        """A host-clock stand-in for a CUDA timing event."""

        def __init__(self, enable_timing):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return 1e3 * (end.t - self.t)

    others = ("model.neck", "model.encoder.stage0", "predict.read")
    with torch.profiler.profile():
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_initialized", lambda: True)
            m.setattr(torch.cuda, "Event", Event)
            m.setattr(torch.cuda, "synchronize", lambda: None)
            for name in STEP + ("model.fpn.refine",) + others:
                with spans.span(name):
                    pass
            got = spans.summary()
    assert spans.TIMED == {METRICS[k] for k in METRICS
                           if not k.startswith("predict.")}
    for name in STEP + ("model.fpn.refine",):
        assert len(got[name]["device_ms"]) == 1, name
        assert got[name]["device_ms"][0] >= 0
    for name in others:
        assert got[name]["calls"] == 1 and got[name]["device_ms"] == [], name
