"""The Focused Decoder's RoI gather (``ops/kernels/roi_gather.py``) and the
inverse of its index (``models.focused_decoder.roi_inverse_index``).

This file imports no jax, so its card tests run on a machine with a card
and no JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_roi_gather.py

On the CPU: the inverse index against a brute-force map (pads skipped,
uncovered tokens empty, up to the 6 and 8 slots a token of the flagship's
and the SwinFPN's configs), the plain backward against autograd of
``k[:, flat]`` in f32 (values exact, gradients within f32 summation order),
the gradient's strided views as the kernel reads them, and the RoI path
of ``FocusedAttn`` against the same attention over ``k[:, flat]``. RoIs are
small synthetic ones shaped like the flagship's (15 organs, up to 6 slots
a token) and the SwinFPN's (20 organs, up to 8), at the row width of 384
and at tp 2's 192. The tests marked ``cuda`` skip without a card (decided
inside the fixture): the kernel against the plain version at the two
configs' shapes, bf16 and f32, strided and contiguous gradients, the same
bits when run twice, and its launch count.
"""

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu_torch.models import focused_decoder as tfd
from transoar_tpu_torch.ops.kernels import roi_gather as rg

# organs, grid, the most slots on one token, the tokens they share
SHAPES = {"flagship": (15, (8, 8, 6), 6), "swin": (20, (8, 8, 8), 8)}
# the configs' RoIs: organs, P3 tokens, the most slots on one token, the
# tokens some slot reads
CONFIG_ROIS = {"foc_dec_amos": (15, 16384, 6, 4397),
               "swin_fpn_visceral": (20, 12800, 8, 3896)}
# row widths: the configs' 8 heads of 48, and a tp-2 rank's 4 heads
WIDTHS = {384: (8, 48), 192: (4, 48)}


def _synthetic_roi(organs, grid, most, seed=0, pad_multiple=16):
    """(idx, valid, S) from the port's own helpers: a bias whose first
    ``most`` organs share a few tokens no other organ reads, and whose
    others each read a sparse random set; token 0 is read by one organ."""
    rng = np.random.default_rng(seed)
    S = int(np.prod(grid))
    shared = rng.choice(np.arange(1, S), 3, replace=False)
    rest = np.setdiff1d(np.arange(1, S), shared)
    bias = np.full((organs, S), tfd.MASKED_BIAS, np.float32)
    bias[:most, shared] = 0.0
    for o in range(organs):
        bias[o, rng.choice(rest, rng.integers(8, 40), replace=False)] = 0.0
    bias[organs - 1, 0] = 0.0
    idx, valid = tfd.roi_token_indices(bias, pad_multiple)
    counts = np.bincount(idx[valid], minlength=S)
    assert counts.max() == most and (counts == 0).any() and (~valid).any()
    return idx, valid, S


def _brute_force(idx, valid, S):
    """token -> the ascending flat slots that read it, pads left out."""
    T = idx.shape[1]
    readers = {s: [] for s in range(S)}
    for o, t in zip(*np.nonzero(valid)):
        readers[int(idx[o, t])].append(int(o * T + t))
    return {s: sorted(v) for s, v in readers.items()}


def _inverse(idx, valid, S):
    return tfd.roi_inverse_index(torch.as_tensor(idx, dtype=torch.long),
                                 torch.as_tensor(valid), S)


def _config_roi(name):
    from transoar_tpu_torch.presets import model_config

    cfg = model_config(name)
    shape = tfd.level_spatial_shape(cfg["augmentation"]["patch_size"],
                                    int(cfg["neck"]["input_levels"][-1]))
    bias = tfd.generate_attn_bias(cfg["bbox_properties"], shape)
    idx, valid = tfd.roi_token_indices(bias)
    return idx, valid, bias.shape[1]


def _check_inverse(idx, valid, S):
    offsets, slots = _inverse(idx, valid, S)
    assert offsets.dtype == slots.dtype == torch.int32
    assert offsets.shape == (S + 1,) and slots.shape == (idx.size,)
    assert int(offsets[-1]) == int(valid.sum())
    want = _brute_force(idx, valid, S)
    got = np.split(slots[:int(offsets[-1])].numpy(), offsets[1:-1].numpy())
    assert {s: g.tolist() for s, g in enumerate(got)} == want
    return offsets, slots


@pytest.mark.parametrize("name", [*SHAPES, *CONFIG_ROIS])
def test_inverse_index_matches_brute_force(name):
    """Synthetic RoIs shaped like the configs', and the configs' own (the
    benchmark's synthetic box statistics), whose pads all point at token 0
    and are left out."""
    if name in SHAPES:
        organs, grid, most = SHAPES[name]
        idx, valid, S = _synthetic_roi(organs, grid, most)
    else:
        idx, valid, S = _config_roi(name)
        organs, tokens, most, covered = CONFIG_ROIS[name]
        assert (S, idx.shape[0]) == (tokens, organs)
        assert (idx[~valid] == 0).all() and (~valid).sum() > 6000
    offsets, _ = _check_inverse(idx, valid, S)
    counts = offsets.diff()
    assert int(counts.max()) == most
    if name in SHAPES:
        assert int(counts[0]) == 1
    else:
        assert int((counts > 0).sum()) == covered


def test_an_organ_without_tokens_keeps_its_pads():
    """An organ with no valid slot spreads its softmax over its pads, which
    then carry gradient: all of its slots are live."""
    idx = np.array([[3, 5, 0, 0], [0, 0, 0, 0]])
    valid = np.array([[True, True, False, False], [False] * 4])
    offsets, slots = _inverse(idx, valid, 6)
    assert offsets.tolist() == [0, 4, 4, 4, 5, 5, 6]
    assert slots[:6].tolist() == [4, 5, 6, 7, 0, 1]


def _rows(B, S, width, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    H, hd = WIDTHS[width]
    return [torch.randn((B, S, H, hd), generator=gen).to(dtype)
            .requires_grad_() for _ in range(2)]


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_gather_matches_autograd_of_indexing(name, width):
    organs, grid, most = SHAPES[name]
    idx, valid, S = _synthetic_roi(organs, grid, most, seed=1)
    flat = torch.as_tensor(idx).reshape(-1).long()
    live = torch.as_tensor(valid).reshape(-1)
    inverse = _inverse(idx, valid, S)
    k, v = _rows(2, S, width, seed=2)
    gen = torch.Generator().manual_seed(3)
    # the incoming gradients, zero on the pad slots as the softmax gives
    wk, wv = (torch.randn((2, flat.numel(), *k.shape[2:]), generator=gen)
              * live[None, :, None, None] for _ in range(2))

    ours = rg.roi_gather(k, v, flat, *inverse)
    torch.testing.assert_close(ours[0], k[:, flat], rtol=0, atol=0)
    torch.testing.assert_close(ours[1], v[:, flat], rtol=0, atol=0)
    got = torch.autograd.grad((ours[0] * wk).sum() + (ours[1] * wv).sum(),
                              (k, v))
    want = torch.autograd.grad((k[:, flat] * wk).sum()
                               + (v[:, flat] * wv).sum(), (k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    uncovered = torch.as_tensor(np.bincount(idx[valid], minlength=S) == 0)
    assert uncovered.any()
    assert not got[0][:, uncovered].any() and not got[1][:, uncovered].any()


def test_plain_backward_in_f64_passes_gradcheck():
    """Token 5 read thrice, token 4 never; organ 2 has no valid slot."""
    idx = np.array([[3, 5, 0, 0], [5, 1, 2, 5], [0, 0, 0, 0]])
    valid = np.array([[True, True, False, False], [True] * 4, [False] * 4])
    S = 6
    flat = torch.as_tensor(idx).reshape(-1)
    live = np.logical_or(valid, ~valid.any(1, keepdims=True))
    live = torch.as_tensor(live).reshape(-1)[None, :, None].double()
    inverse = _inverse(idx, valid, S)
    gen = torch.Generator().manual_seed(5)
    k, v = (torch.randn((2, S, 4), generator=gen, dtype=torch.float64)
            .requires_grad_() for _ in range(2))

    def fn(k, v):  # pads zeroed, as the softmax zeroes their gradient
        kr, vr = rg.roi_gather(k, v, flat, *inverse)
        return kr * live, vr * live

    assert torch.autograd.gradcheck(fn, (k, v))


@pytest.mark.parametrize("layout,copied", [
    ("contiguous", False), ("strided_rows", False), ("heads_apart", True),
    ("misaligned", True)])
def test_operand_reads_the_gradient_where_it_lies(layout, copied):
    """The kernel's reading of a gradient as [B, N, W] rows at (sb, sn),
    replayed with ``as_strided``, gives the gradient back; a copy is made
    only where the rows are not contiguous and 16-byte aligned."""
    B, N, H, hd = 2, 12, 4, 48
    g = {"contiguous": torch.randn(B, N, H, hd),
         "strided_rows": torch.randn(B, 2 * N, H, hd)[:, ::2],
         "heads_apart": torch.randn(B, H, N, hd).transpose(1, 2),
         "misaligned": torch.randn(B * N * H * hd + 1)}[layout]
    g = g.to(torch.bfloat16)  # keeps the view's strides and offset
    if layout == "misaligned":  # one element past an aligned start
        g = g[1:].view(B, N, H, hd)
    view = rg._operand(g)
    sb, sn, one = view.stride()
    assert view.shape == (B, N, H * hd) and one == 1
    assert sb % 8 == sn % 8 == 0 and view.data_ptr() % 16 == 0
    assert (view.data_ptr() != g.data_ptr()) == copied
    read = torch.as_strided(view, (B, N, H * hd), (sb, sn, 1))
    torch.testing.assert_close(read, g.reshape(B, N, -1), rtol=0, atol=0)


def test_kernel_raises_off_the_cpu_and_the_card():
    offsets, slots = torch.zeros(5, dtype=torch.int32), torch.zeros(
        0, dtype=torch.int32)
    g = torch.empty((1, 3, 8), device="meta")
    with pytest.raises(TypeError):
        rg.roi_gather_bwd(g, g, offsets, slots, 4)
    with pytest.raises(ValueError):
        rg.roi_gather_bwd(g, g, offsets, slots, 5)


def _attention_over_indexing(attn, q, k, v, idx, valid):
    """FocusedAttn's RoI path with the gather as ``kh[:, flat]``."""
    B, Q = q.shape[:2]
    O, T = idx.shape
    H, hd = attn.num_heads, attn.head_dim
    kh = attn.k_proj(k).unflatten(-1, (H, hd))
    vh = attn.v_proj(v).unflatten(-1, (H, hd))
    qh = attn.k_proj(q).unflatten(-1, (H, hd)) * hd ** -0.5
    flat = idx.reshape(-1)
    k_r = kh[:, flat].view(B, O, T, H, hd)
    v_r = vh[:, flat].view(B, O, T, H, hd)
    logits = torch.einsum("boqhd,bothd->bhoqt", qh.view(B, O, -1, H, hd),
                          k_r).float()
    logits = logits + torch.where(valid, 0.0, tfd.MASKED_BIAS)[
        None, None, :, None, :]
    out = torch.einsum("bhoqt,bothd->boqhd", logits.softmax(-1), v_r)
    return attn.proj(out.reshape(B, Q, H * hd))


@pytest.mark.parametrize("empty_organ", [False, True])
def test_focused_attention_roi_path_against_indexing(empty_organ):
    """Forward and parameter gradients of the RoI path, with the inverse
    precomputed and built from the bare pair, against the same attention
    over ``kh[:, flat]``; an organ with no valid token included."""
    organs, grid, most = SHAPES["flagship"]
    idx, valid, S = _synthetic_roi(organs, grid, most, seed=6)
    if empty_organ:
        valid[2] = False
        idx[2] = 0
    idx, valid = torch.as_tensor(idx).long(), torch.as_tensor(valid)
    C, qpo = 96, 2
    attn = tfd.FocusedAttn(C, 8, organs, dtype=torch.float32).eval()
    gen = torch.Generator().manual_seed(8)
    for layer in (attn.k_proj, attn.v_proj, attn.proj):
        layer.reset_parameters(gen)
    q = torch.randn((2, organs * qpo, C), generator=gen)
    k, v = (torch.randn((2, S, C), generator=gen) for _ in range(2))
    bias = torch.zeros(organs, S)
    params = list(attn.parameters())

    want_out = _attention_over_indexing(attn, q, k, v, idx, valid)
    want = torch.autograd.grad(want_out.square().sum(), params)
    for roi in ((idx, valid), (idx, valid, *tfd.roi_inverse_index(
            idx, valid, S))):
        out = attn(q, k, v, bias, roi)
        torch.testing.assert_close(out, want_out, rtol=1e-6, atol=1e-6)
        got = torch.autograd.grad(out.square().sum(), params)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("name", list(CONFIG_ROIS))
def test_kernel_matches_plain_on_the_card(cuda, name, strided, dtype):
    idx, valid, S = _config_roi(name)
    offsets, slots = (t.to(cuda) for t in _inverse(idx, valid, S))
    live = torch.as_tensor(valid, device=cuda).reshape(-1)
    B, (H, hd), N = 2, WIDTHS[384], idx.size
    gen = torch.Generator(device=cuda).manual_seed(0)
    grads = []
    for _ in range(2):
        g = torch.randn((B, H, N, hd), generator=gen, device=cuda)
        g = g * live[None, None, :, None]
        g = g.to(dtype).transpose(1, 2)  # [B, N, H, hd], heads apart
        grads.append(g if strided else g.contiguous())
    before = rg.roi_gather_bwd.launches
    dk, dv = rg.roi_gather_bwd(*grads, offsets, slots, S)
    again = rg.roi_gather_bwd(*grads, offsets, slots, S)
    torch.cuda.synchronize()
    assert rg.roi_gather_bwd.launches == before + 2
    assert dk.shape == dv.shape == (B, S, H, hd) and dk.dtype == dtype
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])
    # the plain version on the CPU adds in the same order in f32 and
    # rounds once, as the kernel does: the same bits
    ref = rg.roi_gather_bwd_reference(*(g.cpu() for g in grads),
                                      offsets.cpu(), slots.cpu(), S)
    torch.testing.assert_close(dk.cpu(), ref[0], rtol=0, atol=0)
    torch.testing.assert_close(dv.cpu(), ref[1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("width", list(WIDTHS))
def test_gather_backward_on_the_card_matches_indexing(cuda, width):
    """Through autograd, at a row width of 384 and tp 2's 192: the kernel
    against the autograd of ``k[:, flat]`` in f32, pads zeroed."""
    idx, valid, S = _config_roi("foc_dec_amos")
    flat = torch.as_tensor(idx, device=cuda).reshape(-1).long()
    live = torch.as_tensor(valid, device=cuda).reshape(-1)
    inverse = [t.to(cuda) for t in _inverse(idx, valid, S)]
    k, v = (t.detach().to(cuda).requires_grad_()
            for t in _rows(2, S, width, seed=1))
    gen = torch.Generator(device=cuda).manual_seed(2)
    wk, wv = (torch.randn((2, flat.numel(), *k.shape[2:]), generator=gen,
                          device=cuda) * live[None, :, None, None]
              for _ in range(2))
    before = rg.roi_gather_bwd.launches
    kr, vr = rg.roi_gather(k, v, flat, *inverse)
    got = torch.autograd.grad((kr * wk).sum() + (vr * wv).sum(), (k, v))
    assert rg.roi_gather_bwd.launches == before + 1
    want = torch.autograd.grad((k[:, flat] * wk).sum()
                               + (v[:, flat] * wv).sum(), (k, v))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
