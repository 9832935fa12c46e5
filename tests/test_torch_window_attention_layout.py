"""The host side of the window attention's wg kernels, on the CPU: which
kernel each shape takes (``_window_variant``), the static assignment of
(head, window run) to blocks (``_wg_split``), and the arithmetic of
``fwd_wg`` / ``bwd_wg`` in ``csrc/window_attention.cu``, replayed here as
plain f32 products on bf16-valued inputs and held against
``window_attention_reference`` / ``window_attention_bwd_reference``:

- each window padded to 128 tokens (TMA's zero fill), the bias -inf at
  padded keys and 0 in padded rows, and two 64-row query tiles;
- S = q k^T + bias + mask, e = exp(S - row max); the forward's o = (bf16(e)
  v) / rowsum(e); the backward's P = e / rowsum(e), zero in padded rows;
- dP = do v^T once, D = rowsum(P o dP), dS = P o (dP - D);
- dS as a bf16 hi + lo pair: dq = hi k + lo k, dk = hi^T q + lo^T q; dv =
  bf16(P)^T do;
- dbias: one partial per block, its windows' dS summed in window order,
  the partials added in block order.

Tolerances, as rel-L2 over each tensor: the replay rounds exactly where the
kernels do, so it differs from the f32 plain versions by those roundings
alone. bf16(e) and bf16(P) carry their 2^-9 relative error into o and dv:
4e-3 (and the card's bf16 tolerance, rtol 1.6e-2 atol 1e-2, per element).
hi + lo carry dS to ~2^-17: dq and dk within 1e-5, where dS rounded once
to bf16 misses by a hundred times more (the reason for the pair). dbias
only changes its summation order: 1e-6.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch.ops.kernels.window_attention import (
    _window_variant, _wg_split, window_attention_bwd_reference,
    window_attention_reference)

NP = 128
# swin_fpn_visceral at batch 2 (chip_smoke.py's SWIN_STAGES): windows of
# both volumes and heads per Swin stage, N = 125, d = 16; shifted blocks
# have one region row per window of a volume, unshifted ones a single row
STAGES = [(13312, 3, 6656), (1664, 6, 832), (224, 12, 112), (32, 24, 16)]
# the blocks an H100 holds at once: 132 SMs x 2 forward blocks or 1
# backward block (the C side's window_attention_wg_blocks_per_sm)
TARGETS = (264, 132)


def _shaped(shape, dtype=torch.bfloat16):
    """A tensor of ``shape`` backed by one element (no memory)."""
    return torch.zeros(1, dtype=dtype).reshape([1] * len(shape)).expand(shape)


@pytest.mark.parametrize("stage", STAGES)
def test_window_variant_main_path(stage):
    """q as the Swin module hands it over (a [B_, N, H, d] view); shifted
    and unshifted blocks differ only in the region, which does not choose."""
    B, H, nW = stage
    q = _shaped((B, 125, H, 16)).transpose(1, 2)
    assert q.shape == (B, H, 125, 16)
    assert _window_variant(q) == "wg"


@pytest.mark.parametrize("shape,dtype,want", [
    ((8, 3, 125, 8), torch.bfloat16, "generic"),     # d != 16
    ((8, 3, 125, 32), torch.bfloat16, "generic"),
    ((4, 1, 128, 64), torch.bfloat16, "generic"),
    ((4, 1, 130, 16), torch.bfloat16, "generic"),    # N > 128
    ((8, 3, 125, 16), torch.float32, "fma"),         # f32
    ((7, 3, 100, 16), torch.bfloat16, "wg"),         # ragged N
    ((5, 2, 13, 16), torch.bfloat16, "wg"),
])
def test_window_variant_other_shapes(shape, dtype, want):
    assert _window_variant(_shaped(shape, dtype)) == want


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("target", TARGETS)
def test_wg_split_covers_every_window_once(stage, target):
    """Each head's windows go to ``chunks`` consecutive runs of ``wpb``,
    none empty; the grid needs no second wave, and its longest run is the
    shortest that ``target // H`` blocks per head allow."""
    B, H, _ = stage
    wpb, chunks = _wg_split(B, H, target)
    runs = [range(c * wpb, min(B, (c + 1) * wpb)) for c in range(chunks)]
    assert all(len(r) for r in runs)
    assert [b for r in runs for b in r] == list(range(B))
    assert chunks * H <= target
    assert wpb == -(-B // (target // H))


def test_wg_split_edges():
    assert _wg_split(7, 2, 6) == (3, 3)     # runs 3, 3, 1
    assert _wg_split(5, 200, 132) == (5, 1)  # more heads than blocks
    assert _wg_split(3, 1, 264) == (1, 3)    # fewer windows than blocks


def _inputs(B, H, N, d, nW, seed):
    """bf16-valued f32 q (scaled), k, v, do; f32 bias; region labels."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, H, N, d)))
                   .float().bfloat16().float() for _ in range(4))
    q = (q * d ** -0.5).bfloat16().float()
    bias = torch.from_numpy(rng.standard_normal((H, N, N))).float()
    region = torch.from_numpy(rng.integers(0, 4, (nW, N))).float()
    return q, k, v, bias, region, do


def _bf16(t):
    return t.bfloat16().float()


def _rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def _replay(q, k, v, bias, region, do, target):
    """The wg kernels' arithmetic: (o, dq, dk, dv, dbias) and dq with dS
    rounded once to bf16."""
    B, H, N, d = q.shape
    nW = region.shape[0]
    pad = NP - N
    qp, kp, vp, dop = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v, do))
    bp = torch.zeros(H, NP, NP)
    bp[:, :N, :N] = bias
    bp[:, :, N:] = -torch.inf
    labels = F.pad(region, (0, pad))
    valid = (torch.arange(NP) < N).float()[:, None]
    wpb, chunks = _wg_split(B, H, target)
    o, dq, dq1, dk, dv = (torch.zeros(B, H, NP, d) for _ in range(5))
    part = torch.zeros(chunks, H, NP, NP)
    for h in range(H):
        for c in range(chunks):
            for b in range(c * wpb, min(B, (c + 1) * wpb)):
                lab = labels[b % nW]
                mask = torch.where(lab[:, None] != lab[None, :], -100.0, 0.0)
                P, HI, LO, DS = (torch.zeros(NP, NP) for _ in range(4))
                for g in range(2):  # the two warpgroups' query tiles
                    rows = slice(64 * g, 64 * g + 64)
                    s = qp[b, h, rows] @ kp[b, h].T + bp[h, rows] + \
                        mask[rows]
                    e = torch.exp(s - s.max(-1, keepdim=True).values)
                    total = e.sum(-1, keepdim=True)
                    o[b, h, rows] = (_bf16(e) @ vp[b, h]) / total
                    p = e / total * valid[rows]
                    dp = dop[b, h, rows] @ vp[b, h].T  # computed once
                    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
                    hi = _bf16(ds)
                    lo = _bf16(ds - hi)
                    dq[b, h, rows] = hi @ kp[b, h] + lo @ kp[b, h]
                    dq1[b, h, rows] = hi @ kp[b, h]
                    P[rows], HI[rows], LO[rows], DS[rows] = _bf16(p), hi, \
                        lo, ds
                dv[b, h] = P.T @ dop[b, h]
                dk[b, h] = HI.T @ qp[b, h] + LO.T @ qp[b, h]
                part[c, h] += DS
    dbias = torch.zeros(H, NP, NP)
    for c in range(chunks):  # dbias_reduce: block order
        dbias += part[c]
    cut = (slice(None), slice(None), slice(0, N))
    return (o[cut], dq[cut], dk[cut], dv[cut], dbias[:, :N, :N], dq1[cut])


@pytest.mark.parametrize("shape", [
    (7, 2, 125, 16, 7),   # SwinFPN windows, shifted; runs of 3, 3, 1
    (4, 3, 100, 16, 1),   # ragged N, unshifted
])
def test_wg_arithmetic_matches_plain(shape):
    B, H, N, d, nW = shape
    q, k, v, bias, region, do = _inputs(B, H, N, d, nW, seed=sum(shape))
    o, dq, dk, dv, dbias, dq1 = _replay(q, k, v, bias, region, do,
                                        target=3 * H)
    ref_o = window_attention_reference(q, k, v, bias, region)
    rq, rk, rv, rbias = window_attention_bwd_reference(q, k, v, bias,
                                                       region, do)
    for name, ours, ref, tol in (("o", o, ref_o, 4e-3), ("dv", dv, rv, 4e-3),
                                 ("dq", dq, rq, 1e-5), ("dk", dk, rk, 1e-5),
                                 ("dbias", dbias, rbias, 1e-6)):
        assert _rel_l2(ours, ref) < tol, (name, _rel_l2(ours, ref))
    for ours, ref in ((o, ref_o), (dv, rv)):
        torch.testing.assert_close(ours, ref, rtol=1.6e-2, atol=1e-2)
    # the hi + lo pair: dS rounded once to bf16 is a hundred times off
    assert _rel_l2(dq1, rq) > 100 * _rel_l2(dq, rq)


def _probe():
    """scripts/probe_window_kernels.py as a module (it builds nothing on
    import)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "probe_window_kernels.py"
    spec = importlib.util.spec_from_file_location("probe_window_kernels",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_probe_edits_match_the_source():
    """Every edit of every probe variant finds its text exactly once in the
    current kernel source, so the probe builds what it says it does."""
    probe = _probe()
    src = (probe.CSRC / "window_attention.cu").read_text()
    variants = probe._variants(src)
    assert "base" in variants and len(variants) > 1
    for name, edits in variants.items():
        assert probe._edited(src, name, edits) != src or not edits


@pytest.mark.parametrize("variant", ["wg", "generic"])
def test_labels_kept_until_changed(variant):
    """The wg kernels' labels are padded to 128 with zeros once per region
    tensor and made anew after an in-place change; the other kernels read
    [nW, N] f32 as given."""
    from transoar_tpu_torch.ops.kernels.window_attention import _labels

    region = torch.tensor(np.random.default_rng(0).integers(
        0, 4, (6, 125)), dtype=torch.float32)
    first = _labels(region, variant)
    want = F.pad(region, (0, NP - 125)) if variant == "wg" else region
    assert torch.equal(first, want) and first.is_contiguous()
    if variant == "wg":
        assert _labels(region, variant) is first
    region[2, 7] = 9.0
    again = _labels(region, variant)
    assert torch.equal(again[:, :125], region) and again[2, 7] == 9.0
    if variant == "wg":
        assert again is not first and first[2, 7] != 9.0
    with torch.inference_mode():
        frozen = torch.zeros((1, 125))
    assert torch.equal(_labels(frozen, variant)[:, :125], frozen)
