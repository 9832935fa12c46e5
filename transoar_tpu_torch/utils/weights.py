"""Weight bridge: the JAX package's flax parameters -> the port's state_dict.

``state_dict_from_jax(params, config)`` takes the flax parameter tree of a
``transoar_tpu`` TransoarNet (AttnFPN with CNN or Swin encoder stages,
either patch merging, the deformable refine and the seg head; the Focused
Decoder, with or without its own ``q_proj``, DETR or Deformable-DETR neck;
the sine or learned position encoding) or RetinaNet (the same backbone, the
shared ``cls_tower`` / ``reg_tower`` and the seg head), as nested dicts of
numpy arrays, and returns the port's ``state_dict``. The port names its parameters as the reference torch
model does, so for the reference's modules this is the inverse of
``transoar_tpu.utils.torch_import.map_reference_state_dict``: transposes of
conv and dense kernels, and the ``[C, H, hd]`` attention kernels flattened
back to ``[C, C]``. The DETR necks and RetinaNet, which the reference
checkout lacks, use the port's own names (``models/detr.py``,
``models/retina.py``). No jax is needed; the
per-module converters are used by the parity tests too.
"""

from __future__ import annotations

import numpy as np
import torch


def conv_weight(kernel):
    """flax [k, k, k, C, F] -> torch Conv3d [F, C, k, k, k]."""
    return np.transpose(kernel, (4, 3, 0, 1, 2))


def conv_transpose_weight(kernel):
    """flax [s, s, s, Cin, Cout] -> torch ConvTranspose3d
    [Cin, Cout, s, s, s]."""
    return np.transpose(kernel, (3, 4, 0, 1, 2))


def linear_weight(kernel):
    """flax Dense [in, out] or DenseGeneral [in, H, hd] -> torch [out, in]."""
    kernel = np.asarray(kernel)
    return kernel.reshape(kernel.shape[0], -1).T


def _prefixed(prefix, tree):
    return {f"{prefix}.{k}": v for k, v in tree.items()}


def norm(p):
    return {"weight": p["scale"], "bias": p["bias"]}


def dense(p):
    out = {"weight": linear_weight(p["kernel"])}
    if "bias" in p:
        out["bias"] = np.asarray(p["bias"]).reshape(-1)
    return out


def conv(p):
    out = {"weight": conv_weight(p["kernel"])}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


def conv_in_relu(p, first=0):
    """flax ConvInReLU -> children ``first`` (conv), ``first + 1`` (norm)."""
    return {f"{first}.weight": conv_weight(p["FastConv3D_0"]["kernel"]),
            **_prefixed(str(first + 1), norm(p["InstanceNorm_0"]))}


def encoder_block(p):
    return _prefixed("_block", {**conv_in_relu(p["ConvInReLU_0"], 0),
                                **conv_in_relu(p["ConvInReLU_1"], 3)})


def swin_block(p):
    """flax SwinBlock -> ``norm1``, ``attn.*``, ``norm2``, ``mlp.fc{1,2}``
    (the names ``torch_import._map_swin_stage`` reads)."""
    return {**_prefixed("norm1", norm(p["norm1"])),
            "attn.relative_position_bias_table": p["attn"]["rel_pos_bias"],
            **_prefixed("attn.qkv", dense(p["attn"]["qkv"])),
            **_prefixed("attn.proj", dense(p["attn"]["proj"])),
            **_prefixed("norm2", norm(p["norm2"])),
            **_prefixed("mlp.fc1", dense(p["mlp1"])),
            **_prefixed("mlp.fc2", dense(p["mlp2"]))}


def patch_merging(p):
    """flax PatchMerging -> ``norm``, ``reduction``; ConvPatchMerging
    (``swin.conv_merging``) -> ``conv`` (2x2x2, no bias), ``norm``."""
    if "FastConv3D_0" in p:
        return {"conv.weight": conv_weight(p["FastConv3D_0"]["kernel"]),
                **_prefixed("norm", norm(p["InstanceNorm_0"]))}
    return {**_prefixed("norm", norm(p["LayerNorm_0"])),
            "reduction.weight": linear_weight(p["Dense_0"]["kernel"])}


def learned_pos_enc(p):
    """flax PositionEmbeddingLearned3D -> the reference's ``row_embed``
    (axis 0), ``col_embed`` (axis 1) and ``depth_embed`` tables, the names
    ``torch_import`` reads."""
    return {"row_embed.weight": p["embed_0"],
            "col_embed.weight": p["embed_1"],
            "depth_embed.weight": p["embed_2"]}


def _pos_enc(p):
    """The learned position encoding a flax module holds, if any, under
    ``_pos_enc``."""
    pe = p.get("PositionEmbeddingLearned3D_0")
    return {} if pe is None else _prefixed("_pos_enc", learned_pos_enc(pe))


def swin_stage(p):
    """flax EncoderSwinBlock -> ``blocks.{j}.*``, ``downsample.*``."""
    sd = {}
    for j in _stage_numbers(p, "block"):
        sd.update(_prefixed(f"blocks.{j}", swin_block(p[f"block{j}"])))
    return {**sd, **_prefixed("downsample", patch_merging(p["merge"]))}


def mlp(p):
    n = len([k for k in p if k.startswith("Dense_")])
    out = {}
    for i in range(n):
        out.update(_prefixed(f"layers.{i}", dense(p[f"Dense_{i}"])))
    return out


def ffn(p, names=("linear1", "linear2", "norm")):
    return {**_prefixed(names[0], dense(p["Dense_0"])),
            **_prefixed(names[1], dense(p["Dense_1"])),
            **_prefixed(names[2], norm(p["LayerNorm_0"]))}


def self_attention(p):
    qkv = [dense(p[n]) for n in ("q_proj", "k_proj", "v_proj")]
    return {"in_proj_weight": np.concatenate([d["weight"] for d in qkv]),
            "in_proj_bias": np.concatenate([d["bias"] for d in qkv]),
            **_prefixed("out_proj", dense(p["out_proj"]))}


def focused_attention(p):
    """flax FocusedAttn -> ``k_proj``, ``v_proj``, ``proj`` and, with
    ``share_qk_proj: false``, ``q_proj``."""
    q = ({"q_proj.weight": linear_weight(p["q_proj"]["kernel"])}
         if "q_proj" in p else {})
    return {**q, "k_proj.weight": linear_weight(p["k_proj"]["kernel"]),
            "v_proj.weight": linear_weight(p["v_proj"]["kernel"]),
            **_prefixed("proj", dense(p["proj"]))}


def decoder_layer(p):
    return {**_prefixed("self_attn", self_attention(p["self_attn"])),
            **_prefixed("norm2", norm(p["norm_sa"])),
            **_prefixed("cross_attn", focused_attention(p["cross_attn"])),
            **_prefixed("norm1", norm(p["norm_ca"])),
            **ffn(p["ffn"], ("linear1", "linear2", "norm3"))}


def ms_deform_attn(p):
    """flax MSDeformAttn -> ``value_proj``, ``sampling_offsets``,
    ``attention_weights``, ``output_proj``."""
    out = {}
    for name in ("value_proj", "sampling_offsets", "attention_weights",
                 "output_proj"):
        out.update(_prefixed(name, dense(p[name])))
    return out


def refine(p):
    """flax DecoderDefAttnBlock -> ``level_embed``,
    ``refine_def_attn.layers.{i}.*`` (the names
    ``torch_import._map_refine`` reads)."""
    sd = {"level_embed": p["level_embed"], **_pos_enc(p)}
    for i in _stage_numbers(p, "layer"):
        lay = p[f"layer{i}"]
        sd.update(_prefixed(f"refine_def_attn.layers.{i}", {
            **_prefixed("self_attn", ms_deform_attn(lay["self_attn"])),
            **_prefixed("norm1", norm(lay["LayerNorm_0"])),
            **ffn(lay["FFN_0"], ("linear1", "linear2", "norm2"))}))
    return sd


def detr_layer(p):
    """flax DETRDecoderLayer / DeformableDETRDecoderLayer -> ``self_attn``,
    ``norm_sa``, ``cross_attn``, ``norm_ca``, ``ffn.*``."""
    ca = p["cross_attn"]
    return {**_prefixed("self_attn", self_attention(p["self_attn"])),
            **_prefixed("norm_sa", norm(p["norm_sa"])),
            **_prefixed("cross_attn", self_attention(ca["mha"]) if "mha" in ca
                        else ms_deform_attn(ca)),
            **_prefixed("norm_ca", norm(p["norm_ca"])),
            **_prefixed("ffn", ffn(p["ffn"]))}


def _stage_numbers(tree, prefix):
    return sorted(int(k[len(prefix):]) for k in tree if k.startswith(prefix))


def conv_tower(p):
    """flax ConvTower -> ``conv{i}``, ``out``."""
    return {f"{name}.{k}": v for name in p for k, v in conv(p[name]).items()}


def _backbone(params, config):
    sd = {}
    enc = params["backbone"]["encoder"]
    for i in range(config["backbone"]["num_stages"]):
        stage = enc[f"stage{i}"]
        sd.update(_prefixed(f"_backbone._encoder._stages.{i}",
                            swin_stage(stage) if "merge" in stage
                            else encoder_block(stage)))
    dec = params["backbone"]["decoder"]
    for j, s in enumerate(_stage_numbers(dec, "lateral")):
        sd.update(_prefixed(f"_backbone._decoder._lateral.{j}",
                            conv(dec[f"lateral{s}"])))
    for k, s in enumerate(reversed(_stage_numbers(dec, "up"))):
        sd[f"_backbone._decoder._up.{k}.weight"] = conv_transpose_weight(
            dec[f"up{s}"]["kernel"])
        sd[f"_backbone._decoder._up.{k}.bias"] = dec[f"up{s}"]["bias"]
    for m, s in enumerate(_stage_numbers(dec, "out")):
        sd.update(_prefixed(f"_backbone._decoder._out.{m}",
                            conv(dec[f"out{s}"])))
    if "refine" in dec:
        sd.update(_prefixed("_backbone._decoder._refine",
                            refine(dec["refine"])))
    return sd


def state_dict_from_jax(params, config) -> dict:
    """flax params (``{"params": ...}`` or the inner tree) of a TransoarNet
    or a RetinaNet -> port ``state_dict`` of f32 CPU tensors."""
    if set(params) == {"params"}:
        params = params["params"]
    sd = _backbone(params, config)
    if "seg_head" in params:
        sd.update(_prefixed("_seg_head", conv(params["seg_head"])))
    if "cls_tower" in params:  # RetinaNet
        for name in ("cls_tower", "reg_tower"):
            sd.update(_prefixed(f"_{name}", conv_tower(params[name])))
        return to_torch(sd)
    neck = params["neck"]
    focused = config["neck"].get("name", "foc_attn") == "foc_attn"
    for i in range(config["neck"]["dec_layers"]):
        sd.update(_prefixed(f"_neck.decoder.layers.{i}",
                            decoder_layer(neck[f"layer{i}"])) if focused
                  else _prefixed(f"_neck.layers.{i}",
                                 detr_layer(neck[f"layer{i}"])))
    if "ref_points" in neck:
        sd.update(_prefixed("_neck.ref_points", dense(neck["ref_points"])))
    sd.update(_pos_enc(params))
    sd.update(_prefixed("_cls_head", dense(params["cls_head"])))
    sd.update(_prefixed("_reg_head", mlp(params["reg_head"])))
    sd["_query_embed.weight"] = params["query_embed"]
    return to_torch(sd)


def to_torch(tree: dict) -> dict:
    """numpy values -> contiguous f32 CPU tensors."""
    return {k: torch.tensor(np.asarray(v), dtype=torch.float32)
            for k, v in tree.items()}


def random_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Every parameter drawn from ``numpy.random.default_rng(seed)``: kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1^2), biases N(0, 0.1^2) and the
    query embedding N(0, 1). Nothing is left at zero, unlike a fresh model
    whose zero-initialised heads give every query the same score."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name == "_query_embed.weight":
            v = rng.normal(size=shape)
        elif len(shape) >= 2:
            v = rng.normal(size=shape) / np.sqrt(np.prod(shape[1:]))
        elif name.endswith("bias"):
            v = 0.1 * rng.normal(size=shape)
        else:
            v = 1.0 + 0.1 * rng.normal(size=shape)
        sd[name] = v
    return to_torch(sd)
