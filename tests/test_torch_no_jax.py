"""The port never imports jax, flax or the JAX package: every module of
transoar_tpu_torch (its CLIs ``train``, ``test``, ``predict``,
``prepare_dataset_amos``, ``prepare_dataset_visceral``,
``import_checkpoint`` and ``bench`` included, and ``parallel/``),
``chip_smoke.py``, the port's scripts, the multi-process test worker and
the CUDA-only parallel tests import in a fresh interpreter where all three
are blocked, and no import statement anywhere in their sources (function
bodies included) names ``transoar_tpu``."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ["chip_smoke.py", "scripts/profile_torch_serving.py",
           "scripts/probe_window_kernels.py",
           "tests/torch_parallel_worker.py",
           "tests/test_torch_parallel_cuda.py"]

SCRIPT = """
import importlib, importlib.util, pkgutil, sys
for blocked in ("jax", "flax", "transoar_tpu"):
    sys.modules[blocked] = None
import transoar_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    transoar_tpu_torch.__path__, "transoar_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for i, path in enumerate(%r):
    spec = importlib.util.spec_from_file_location(f"script{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in ("transoar_tpu_torch.predict", "transoar_tpu_torch.train",
             "transoar_tpu_torch.bench",
             "transoar_tpu_torch.test",
             "transoar_tpu_torch.prepare_dataset_amos",
             "transoar_tpu_torch.prepare_dataset_visceral",
             "transoar_tpu_torch.import_checkpoint",
             "transoar_tpu_torch.native.native_loader",
             "transoar_tpu_torch.utils.visualization",
             "transoar_tpu_torch.data.preprocessor",
             "transoar_tpu_torch.data.transforms",
             "transoar_tpu_torch.ops.kernels.packed_conv",
             "transoar_tpu_torch.ops.kernels.window_attention",
             "transoar_tpu_torch.ops.kernels.conv2d",
             "transoar_tpu_torch.models.swin",
             "transoar_tpu_torch.models.retina",
             "transoar_tpu_torch.ops.nms",
             "transoar_tpu_torch.parallel.mesh",
             "transoar_tpu_torch.parallel.sp",
             "transoar_tpu_torch.parallel.tp",
             "transoar_tpu_torch.parallel.fsdp"):
    assert name in names, name
print(len(names))
""" % SCRIPTS


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 25


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_import_of_the_jax_package_anywhere():
    files = sorted((ROOT / "transoar_tpu_torch").rglob("*.py"))
    files += [ROOT / s for s in SCRIPTS]
    bad = [f"{path.relative_to(ROOT)}: {name}" for path in files
           for name in _imported_modules(path)
           if name.split(".")[0] in ("jax", "flax", "transoar_tpu")]
    assert not bad, bad
