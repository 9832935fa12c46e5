"""Driver ``train_step_refine``: the ``train_step`` driver on a config with
the deformable refine of the FPN levels (``use_decoder_attn``), checked
against the plain reference with the refine (``reference/refine.py``).

The port's side is ``train_step``'s, unchanged: the port's own
``make_train_step`` on ``build_model(cfg)``, the pool of seeded batches
resident on the card, the checked steps, the window. This module loads a
private copy of ``drivers/train_step.py`` and of ``reference/runs.py``
and points their reference module at ``reference/refine.py``, so that the
seeded weights take the refine's parameter shapes and the replay after
the window runs the refine; the modules the other cells load are not
touched. The window's counters add the deformable sampling's
(``ops.deformable_attention.ms_deform_attn.calls`` and ``.samples``:
``launches["deform_calls"]``, ``["deform_samples"]``), and the outcome's
counters the device functions the op names (``deform_kernels``); a port
without them leaves them out, and the readers of the refine's metrics
then read None.

Traffic keys: those of ``train_step``.
"""

from __future__ import annotations

from pathlib import Path

from benchmark import counters, harness
from benchmark.reference import refine

_HERE = Path(__file__).resolve().parent


def _deformable_attention():
    """The port's sampling op's module, or None where it has no counters."""
    from transoar_tpu_torch.ops import deformable_attention as da

    return da if hasattr(da.ms_deform_attn, "calls") else None


def launch_counts() -> dict:
    """``counters.launch_counts`` plus the sampling op's counters."""
    out = counters.launch_counts()
    da = _deformable_attention()
    if da is not None:
        out["deform_calls"] = da.ms_deform_attn.calls
        out["deform_samples"] = da.ms_deform_attn.samples
    return out


_runs = harness.load_module(_HERE.parent / "reference" / "runs.py",
                            f"{__name__}.runs")
_runs.ref = refine
_step = harness.load_module(_HERE / "train_step.py", f"{__name__}.step")
_step.ref, _step.runs, _step.launch_counts = refine, _runs, launch_counts


def run(cell) -> harness.Outcome:
    outcome = _step.run(cell)
    da = _deformable_attention()
    if da is not None:
        outcome.counters["deform_kernels"] = tuple(da.KERNELS)
    return outcome


readings = _step.readings
