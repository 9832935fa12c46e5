"""Nothing under ``benchmark/`` loads JAX: every module (the traffic
drivers and the per-layer readers, which the harness loads by path,
included) imports in a fresh interpreter where ``jax``, ``flax`` and
``transoar_tpu`` are blocked, and no import statement in their sources
names them. Names are
compared whole, by the part before the first dot: ``transoar_tpu_torch``
begins with ``transoar_tpu`` and is the system under test."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "transoar_tpu"}


def _sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                  p.parts)


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_import_statement_names_jax():
    found = {(str(p.relative_to(ROOT)), name) for p in _sources()
             for name in _imported(p)
             if name.split(".", 1)[0] in FORBIDDEN}
    assert not found


def test_every_module_imports_with_jax_blocked():
    paths = [str(p) for p in _sources() if not p.name.startswith("test_")]
    script = f"""
import sys
for blocked in {sorted(FORBIDDEN)!r}:
    sys.modules[blocked] = None
from benchmark import harness
for i, path in enumerate({paths!r}):
    harness.load_module(__import__("pathlib").Path(path), f"m{{i}}")
import transoar_tpu_torch.training.trainer, transoar_tpu_torch.predict
loaded = sorted({{m.split(".", 1)[0] for m in sys.modules
                 if sys.modules[m] is not None}} & set({sorted(FORBIDDEN)!r}))
assert not loaded, loaded
print("ok", len({paths!r}))
"""
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("ok")


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "transoar_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert harness.forbidden_modules() == ["flax"]
