"""Config keys that no shipped config sets, against the JAX package at f32:
the learned position encoding (``pos_encoding: learned``) alone and
wherever ``build_pos_enc`` is called (the focused and DETR necks, the
deformable refine), and the Focused Decoder's own ``q_proj``
(``neck.share_qk_proj: false``); weights bridged by ``state_dict_from_jax``,
logits within 2e-4 and boxes within 2e-5. ``swin.conv_merging`` is in
``tests/test_torch_swin.py``, ``trainer.grad_accum_steps`` in
``tests/test_torch_train_step.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_config as jax_tiny_config
from tests.torch_parity import forward_pair, init_params, load, model_pair
from tests.torch_parity import one_torch_thread  # noqa: F401
from transoar_tpu.models import position_encoding as jpe
from transoar_tpu_torch.models import position_encoding as pe
from transoar_tpu_torch.models.transoarnet import build_model
from transoar_tpu_torch.presets import tiny_config
from transoar_tpu_torch.utils import weights


def test_learned_pos_enc_matches_jax():
    """Three [50, 2 * ceil(C / 6)] tables, channel blocks col, row, depth,
    truncated to C; U[0, 1) at init; the reference's names."""
    x = np.zeros((2, 5, 4, 3, 20), np.float32)
    jmod = jpe.PositionEmbeddingLearned3D(channels=20, dtype=jnp.float32)
    params = init_params(jmod, jnp.asarray(x), seed=2)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    port = pe.build_pos_enc("learned", 20, torch.float32)
    load(port, weights.learned_pos_enc(params))
    assert sorted(port.state_dict()) == ["col_embed.weight",
                                         "depth_embed.weight",
                                         "row_embed.weight"]
    out = port(torch.from_numpy(x))
    assert out.shape == (2, 5, 4, 3, 20)
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    fresh = pe.PositionEmbeddingLearned3D(20)
    for table in (fresh.row_embed, fresh.col_embed, fresh.depth_embed):
        table.reset_parameters(torch.Generator().manual_seed(0))
        w = table.weight
        assert w.shape == (50, 8) and 0 <= w.min() and w.max() < 1


def _f32(cfg):
    cfg["trainer"]["precision"] = "float32"
    return cfg


def _learned(family):
    if family == "focused":
        cfg = jax_tiny_config(num_organs=3, qpo=7)
        cfg["neck"]["pos_encoding"] = "learned"
    elif family == "detr":
        cfg = _f32(tiny_config("detr", num_organs=3))
        cfg["neck"]["pos_encoding"] = "learned"
    else:  # the deformable refine's own encoding
        cfg = _f32(tiny_config("refine", num_organs=3))
        cfg["backbone"]["def_attn"]["pos_encoding"] = "learned"
    return cfg


def _compare(cfg, seed):
    x = np.random.default_rng(seed).normal(
        size=(2, *cfg["augmentation"]["patch_size"], 1)).astype(np.float32)
    jmodel, params, port = model_pair(cfg, x, seed=seed)
    ref, ours = forward_pair(jmodel, params, port, x)
    for key in ("pred_logits", "aux_logits"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=2e-4,
                                   err_msg=key)
    for key in ("pred_boxes", "aux_boxes"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=0, atol=2e-5,
                                   err_msg=key)
    return port


@pytest.mark.parametrize("family", ["focused", "detr", "refine"])
def test_models_with_learned_pos_enc_match_jax(family):
    port = _compare(_learned(family), 11)
    prefix = ("_backbone._decoder._refine._pos_enc" if family == "refine"
              else "_pos_enc")
    names = {n for n, _ in port.named_parameters() if "_pos_enc" in n}
    assert names == {f"{prefix}.{t}_embed.weight"
                     for t in ("row", "col", "depth")}


def test_separate_q_proj_matches_jax():
    cfg = jax_tiny_config(num_organs=3, qpo=7)
    cfg["neck"]["share_qk_proj"] = False
    port = _compare(cfg, 12)
    for i in range(cfg["neck"]["dec_layers"]):
        attn = port._neck.decoder["layers"][i].cross_attn
        assert hasattr(attn, "q_proj")
        assert not torch.equal(attn.q_proj.weight, attn.k_proj.weight)
    shared = jax_tiny_config(num_organs=3, qpo=7)
    assert not any("q_proj" in n for n in build_model(shared).state_dict())
