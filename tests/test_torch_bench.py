"""``transoar_tpu_torch.bench`` against the JAX package's ``bench.py``: the
same JSON line (``device`` aside) for the same flags, the same synthetic
batch bit for bit, one tiny CPU run of each measurement, no fall back to
the CPU without a card, and an eval mode that honours ``--config`` (the
JAX tool measures the flagship whatever ``--config`` says)."""

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import transoar_tpu.models.transoarnet as jax_transoarnet
import transoar_tpu.training.train_state as jax_train_state
import transoar_tpu.training.trainer as jax_trainer
import transoar_tpu.utils.cache as jax_cache
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch import bench, presets

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
jax_bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_bench)

# volumes/s each fake measurement returns, by batch size
VOLS = {2: 13.123456789, 1: 7.00000499}
TINY = ["--steps", "1", "--warmup", "1", "--scan_steps", "1",
        "--device", "cpu"]


def _line(capsys):
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _fakes(monkeypatch, module):
    """Replace ``module``'s measurements by constants per batch size;
    returns the (batch, patch, steps, warmup, scan_steps) of each call."""
    calls = []

    def fake(b, patch, steps, warmup, scan_steps, *rest, **kwargs):
        calls.append((b, tuple(patch), steps, warmup, scan_steps))
        return VOLS[b]

    monkeypatch.setattr(module, "measure", fake)
    monkeypatch.setattr(module, "measure_eval", fake)
    return calls


@pytest.mark.parametrize("args", [
    [], ["--batch_size", "1"], ["--mode", "eval"],
    ["--config", "swin_fpn_visceral"], ["--patch", "64", "64", "32"],
    ["--microbatch", "off", "--steps", "3", "--scan_steps", "2"]],
    ids=["default", "batch1", "eval", "swin", "patch", "flags"])
def test_output_line_matches_jax(args, monkeypatch, capsys):
    monkeypatch.setattr(jax_cache, "enable_compilation_cache", lambda: None)
    jax_calls = _fakes(monkeypatch, jax_bench)
    monkeypatch.setattr(sys, "argv", ["bench.py", *args])
    jax_bench.main()
    want = _line(capsys)

    port_calls = _fakes(monkeypatch, bench)
    returned = bench.main([*args, "--device", "cpu"])
    got = _line(capsys)
    assert got == returned
    assert got.pop("device") == {"name": "cpu", "power_limit_w": None}
    assert list(got) == list(want)
    assert got == want
    assert port_calls == jax_calls


@pytest.mark.parametrize("config_name", [None, "swin_fpn_visceral"],
                         ids=["flagship", "swin"])
def test_synthetic_batch_matches_jax(config_name, monkeypatch):
    monkeypatch.setattr(jax_transoarnet, "build_model",
                        lambda config: SimpleNamespace(anchors=None))
    monkeypatch.setattr(jax_train_state, "create_train_state",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_trainer, "make_multi_train_step",
                        lambda *a, **k: (lambda state, batch, rng: None))
    config = bench.bench_config(config_name)
    patch = tuple(config["augmentation"]["patch_size"])
    _, _, batch = jax_bench.build_benchmark(2, patch, scan_steps=1,
                                            config_name=config_name)
    image, seg = bench.synthetic_batch(bench.bench_config(
        config_name, 2, patch), 2, patch)
    assert image.dtype == np.float32 and seg.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(batch["image"][0]), image)
    np.testing.assert_array_equal(np.asarray(batch["seg"][0]), seg)
    assert len(np.unique(seg)) > 1


def _tiny_yaml(tmp_path, family):
    cfg = (presets.tiny_flagship_config() if family == "flagship"
           else presets.tiny_config(family))
    path = tmp_path / f"tiny_{family}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_tiny_train_run_moves_parameters(tmp_path, monkeypatch, capsys):
    built = []
    real = bench.build_benchmark

    def spy(*args, **kwargs):
        model, step = real(*args, **kwargs)
        built.append((model, {n: p.detach().clone()
                              for n, p in model.named_parameters()}))
        return model, step

    monkeypatch.setattr(bench, "build_benchmark", spy)
    result = bench.main(["--config", _tiny_yaml(tmp_path, "flagship"),
                         *TINY])
    assert _line(capsys) == result
    for key in ("value", "batch1_volumes_per_sec"):
        assert np.isfinite(result[key]) and result[key] > 0
    assert "train step, 32x32x16, batch 2" in result["metric"]
    assert [m.training for m, _ in built] == [True, True]
    for model, before in built:  # batch 2, then batch 1
        moved = [not torch.equal(before[n], p)
                 for n, p in model.named_parameters()]
        assert sum(moved) > 0.9 * len(moved)
        assert all(torch.isfinite(p).all() for p in model.parameters())


@pytest.mark.parametrize("family, decode, other", [
    ("flagship", "inference", "retina_inference"),
    ("retina", "retina_inference", "inference")])
def test_tiny_eval_run_honours_config(family, decode, other, tmp_path,
                                      monkeypatch, capsys):
    calls = {decode: 0, other: 0}

    def counted(name):
        real = getattr(bench, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return real(*args, **kwargs)
        return wrapper

    for name in calls:
        monkeypatch.setattr(bench, name, counted(name))
    result = bench.main(["--config", _tiny_yaml(tmp_path, family),
                         "--mode", "eval", *TINY])
    assert _line(capsys) == result
    for key in ("value", "batch1_volumes_per_sec"):
        assert np.isfinite(result[key]) and result[key] > 0
    assert "inference fwd+decode" in result["metric"]
    # (warmup + steps) x scan_steps rounds of batch 2, then of batch 1,
    # one volume decoded at a time
    assert calls == {decode: 2 * 2 + 2 * 1, other: 0}


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = _tiny_yaml(tmp_path, "flagship")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--config", path, "--batch_size", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure(1, (32, 32, 16), 1, 1, 1, None, config_name=path)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.measure_eval(1, (32, 32, 16), 1, 1, 1, config_name=path)
