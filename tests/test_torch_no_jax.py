"""The port never imports jax or flax: every module of transoar_tpu_torch,
the serving CLI included, imports in a fresh interpreter where both are
blocked."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
import transoar_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    transoar_tpu_torch.__path__, "transoar_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert "transoar_tpu_torch.predict" in names, names
assert "transoar_tpu_torch.ops.kernels.packed_conv" in names, names
print(len(names))
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15
