"""AttnFPN backbone: multi-stage 3D CNN (or Swin) encoder + FPN decoder.

Port of ``transoar_tpu/models/attn_fpn.py``. Module names follow the
reference ``state_dict``: ``_encoder._stages.{i}._block.*`` (CNN stages),
``_encoder._stages.{i}.blocks.{j}.*`` and ``.downsample.*`` (Swin stages),
``_decoder._lateral.{j}``, ``_decoder._up.{k}`` (top-down order) and
``_decoder._out.{m}``. Layout is ``[B, S0, S1, S2, C]`` throughout.

With ``use_encoder_attn`` the stages from 2 on are 3D Swin stages
(``models/swin.py``), their stochastic-depth rates a linear schedule over
all Swin blocks, sliced per stage. ``swin.blocked_attn`` (a TPU layout
choice with the same values) is accepted and has no effect.

The stride-1 stage takes the depth-packed chain whenever ``stage0_pack`` is
set and the depth divides by it. The JAX package also gates it on batch
size; that gate is a TPU speed choice, not semantics, and the port drops it.

With ``remat`` (default true, as the JAX encoder's ``nn.remat``) each CNN
encoder block runs under ``torch.utils.checkpoint`` when grad is enabled:
its activations are recomputed in the backward instead of kept. Swin stages
are not rematerialised, as in the JAX encoder.

With ``use_seg_proxy_loss`` the decoder runs down to stage 0 (the laterals,
the up-convs and ``out0`` at ``start_channels``, full resolution) for the
seg head; with ``use_decoder_attn`` the ``def_attn.feature_levels`` are
refined by deformable self-attention (``_decoder._refine``,
``models/def_attn.DecoderDefAttnBlock``) and replace their P-levels.

Under spatial parallelism (``parallel/sp.py``, ``apply_sp``) the encoder
runs its sharded stages on the rank's block of S0 and gathers before the
first gathered stage (``gather_from``); the decoder runs each level on the
block where its stage was sharded, takes its slice of a gathered level's
up-path (``sp.scatter``) and gathers the refine's levels before the
refine. ``AttnFPN.whole`` gives a caller a decoder output (or a tensor
computed from it position by position) whole.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from transoar_tpu_torch.models.def_attn import DecoderDefAttnBlock
from transoar_tpu_torch.models.layers import EncoderCnnBlock
from transoar_tpu_torch.models.swin import EncoderSwinBlock
from transoar_tpu_torch.ops.conv3d import Conv3d, ConvTranspose3d
from transoar_tpu_torch.parallel import sp as sp_lib
from transoar_tpu_torch.utils.spans import span


def required_stages(config) -> list[int]:
    """Stages whose P-level must be produced (reference attn_fpn.py:47-53)."""
    fmaps = list(config["out_fmaps"])
    if config.get("use_decoder_attn"):
        fmaps = fmaps + list(config["def_attn"]["feature_levels"])
    stages = {int(f[-1]) for f in fmaps}
    if config.get("use_seg_proxy_loss"):
        stages.add(0)
    return sorted(stages)


class Encoder(nn.Module):
    """Downsampling encoder; returns {"C{s}": ...} for stages >= first_out.
    ``input_shape`` (S0, S1, S2) sizes the Swin stages' bias tables."""

    def __init__(self, config: Dict[str, Any], first_out: int = 0,
                 dtype: torch.dtype = torch.bfloat16, input_shape=None):
        super().__init__()
        self.config = config
        self.input_shape = input_shape
        self.sp, self.gather_from = None, None
        self.first_out = first_out
        self.remat = bool(config.get("remat", True))
        start = config["start_channels"]
        k = config.get("kernel_size", 3)
        num_stages = config["num_stages"]
        # stages from swin_from on are Swin stages (reference
        # attn_fpn.py:172-185): blocks at the incoming channel count, then
        # a merge that halves the resolution and doubles the channels
        self.swin_from = 2 if config.get("use_encoder_attn") else num_stages
        swin = config.get("swin", {})
        if self.swin_from < num_stages:
            depths = swin["depths"]
            dpr = np.linspace(0.0, float(swin.get("drop_path_rate", 0.0)),
                              sum(depths)).tolist()
        stages = []
        in_ch = config["in_channels"]
        spatial = None if input_shape is None else tuple(input_shape)
        for s in range(num_stages):
            if s >= self.swin_from:
                i = s - self.swin_from
                lo = sum(depths[:i])
                stages.append(EncoderSwinBlock(
                    in_ch, depths[i], swin["num_heads"][i],
                    swin["window_size"], swin["mlp_ratio"], swin["qkv_bias"],
                    dpr[lo:lo + depths[i]], swin.get("conv_merging", False),
                    dtype, spatial))
                stride = (2, 2, 2)  # the merge pads odd sizes
            else:
                stride = tuple(config["strides"][s])
                pack = int(config.get("stage0_pack", 0)) \
                    if stride == (1, 1, 1) else 0
                stages.append(EncoderCnnBlock(in_ch, start * 2 ** s, k,
                                              stride, pack=pack, dtype=dtype))
            if spatial is not None:  # both round up
                spatial = tuple(-(-n // st) for n, st in zip(spatial, stride))
            in_ch = start * 2 ** s
        self._stages = nn.ModuleList(stages)
        self._spans = tuple(f"model.encoder.stage{i}"
                            for i in range(len(stages)))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        """``generator`` draws the Swin stages' DropPath masks."""
        outputs = {}
        for s, stage in enumerate(self._stages):
            if self.sp is not None and s == self.gather_from:
                x = sp_lib.gather(x, self.sp)
            # outside the checkpoint: the recompute never re-enters the span
            with span(self._spans[s]):
                if s >= self.swin_from:
                    x = stage(x, generator)
                elif self.remat and torch.is_grad_enabled():
                    x = checkpoint(stage, x, use_reentrant=False)
                else:
                    x = stage(x)
            if s >= self.first_out:
                outputs[f"C{s}"] = x
        return outputs


class Decoder(nn.Module):
    """FPN decoder: 1x1 laterals, kernel == stride transposed-conv top-down
    path, 3x3 out convs for the required stages only (``out0`` at
    ``start_channels`` under the seg proxy), then the optional deformable
    refine of ``def_attn.feature_levels``."""

    def __init__(self, config: Dict[str, Any],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.sp, self.sharded = None, frozenset()
        num_stages = config["num_stages"]
        fpn = config["fpn_channels"]
        start = config["start_channels"]
        self.stages_needed = required_stages(config)
        self.earliest = min(self.stages_needed)
        strides = [tuple(s) for s in config["strides"]]
        self.lateral_stages = list(range(self.earliest, num_stages))
        enc_ch = [start * 2 ** s for s in range(num_stages)]
        lat_ch = [min(enc_ch[s], fpn) for s in self.lateral_stages]

        self._lateral = nn.ModuleList(
            Conv3d(enc_ch[s], c, 1, dtype=dtype)
            for s, c in zip(self.lateral_stages, lat_ch))
        self._up = nn.ModuleList(
            ConvTranspose3d(lat_ch[s - self.earliest],
                            lat_ch[s - self.earliest - 1], strides[s],
                            dtype=dtype)
            for s in reversed(self.lateral_stages) if s > self.earliest)
        seg_proxy = config.get("use_seg_proxy_loss", False)
        self._out = nn.ModuleList(
            Conv3d(lat_ch[s - self.earliest],
                   start if seg_proxy and s == 0 else fpn, 3, dtype=dtype)
            for s in self.stages_needed)
        self.refine_levels = []
        if config.get("use_decoder_attn"):
            da = config["def_attn"]
            self.refine_levels = list(da["feature_levels"])
            self._refine = DecoderDefAttnBlock(
                da["hidden_dim"], da["nheads"], da["layers"],
                da["dim_feedforward"], float(da["dropout"]), da["n_points"],
                len(self.refine_levels), da.get("pos_encoding", "sine"),
                dtype)

    def forward(self, enc_out: Dict[str, torch.Tensor],
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        """``generator`` draws the refine's dropout masks."""
        top_down = {}
        up = None
        ups = iter(self._up)
        for j in reversed(range(len(self.lateral_stages))):
            s = self.lateral_stages[j]
            x = self._lateral[j](enc_out[f"C{s}"])
            if up is not None and s in self.sharded \
                    and s + 1 not in self.sharded:
                up = sp_lib.scatter(up, self.sp)
            x = x if up is None else x + up
            top_down[s] = x
            if s > self.earliest:
                up = next(ups)(x)
        outputs = {f"P{s}": out(top_down[s])
                   for s, out in zip(self.stages_needed, self._out)}
        if self.refine_levels:
            with span("model.fpn.refine"):
                refined = self._refine(
                    [sp_lib.gather(outputs[lv], self.sp)
                     if int(lv[1:]) in self.sharded else outputs[lv]
                     for lv in self.refine_levels], generator)
            outputs.update(zip(self.refine_levels, refined))
        return outputs

    def is_sharded(self, level: str) -> bool:
        """Whether the output ``level`` is the rank's block (sp)."""
        return int(level[1:]) in self.sharded and \
            level not in self.refine_levels


class AttnFPN(nn.Module):
    """Backbone = Encoder + FPN Decoder (reference attn_fpn.py:18-29)."""

    def __init__(self, config: Dict[str, Any],
                 dtype: torch.dtype = torch.bfloat16, input_shape=None):
        super().__init__()
        self._encoder = Encoder(config, min(required_stages(config)), dtype,
                                input_shape)
        self._decoder = Decoder(config, dtype)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None
                ) -> Dict[str, torch.Tensor]:
        feats = self._encoder(x, generator)
        with span("model.fpn"):
            return self._decoder(feats, generator)

    def whole(self, x: torch.Tensor, level: str) -> torch.Tensor:
        """``x``, the decoder's output ``level`` or a tensor computed from it
        position by position, whole: gathered over sp where the level is
        the rank's block."""
        if self._decoder.is_sharded(level):
            return sp_lib.gather(x, self._decoder.sp)
        return x
