"""AttnFPN backbone, CNN path: multi-stage 3D CNN encoder + FPN decoder.

Port of ``transoar_tpu/models/attn_fpn.py``. Module names follow the
reference ``state_dict``: ``_encoder._stages.{i}._block.*``,
``_decoder._lateral.{j}``, ``_decoder._up.{k}`` (top-down order) and
``_decoder._out.{m}``. Layout is ``[B, S0, S1, S2, C]`` throughout.

The stride-1 stage takes the depth-packed chain whenever ``stage0_pack`` is
set and the depth divides by it. The JAX package also gates it on batch
size; that gate is a TPU speed choice, not semantics, and the port drops it.

With ``remat`` (default true, as the JAX encoder's ``nn.remat``) each
encoder block runs under ``torch.utils.checkpoint`` when grad is enabled:
its activations are recomputed in the backward instead of kept.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from transoar_tpu_torch.models.layers import EncoderCnnBlock
from transoar_tpu_torch.ops.conv3d import Conv3d, ConvTranspose3d


def required_stages(config) -> list[int]:
    """Stages whose P-level must be produced (reference attn_fpn.py:47-53)."""
    fmaps = list(config["out_fmaps"])
    if config.get("use_decoder_attn"):
        fmaps = fmaps + list(config["def_attn"]["feature_levels"])
    stages = {int(f[-1]) for f in fmaps}
    if config.get("use_seg_proxy_loss"):
        stages.add(0)
    return sorted(stages)


def _check_supported(cfg) -> None:
    if cfg.get("use_encoder_attn"):
        raise NotImplementedError(
            "Swin encoder stages (use_encoder_attn) are not ported yet: "
            "ROADMAP Queue 1, Swin family")
    if cfg.get("use_decoder_attn"):
        raise NotImplementedError(
            "the deformable FPN refine (use_decoder_attn) is not ported yet: "
            "ROADMAP Queue 1, deformable family")
    if cfg.get("use_seg_proxy_loss"):
        raise NotImplementedError(
            "the segmentation-proxy head is not ported yet: ROADMAP Queue 1, "
            "matcher + criterion")


class Encoder(nn.Module):
    """Downsampling encoder; returns {"C{s}": ...} for stages >= first_out."""

    def __init__(self, config: Dict[str, Any], first_out: int = 0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.first_out = first_out
        self.remat = bool(config.get("remat", True))
        start = config["start_channels"]
        k = config.get("kernel_size", 3)
        stages = []
        in_ch = config["in_channels"]
        for s in range(config["num_stages"]):
            stride = tuple(config["strides"][s])
            pack = int(config.get("stage0_pack", 0)) \
                if stride == (1, 1, 1) else 0
            stages.append(EncoderCnnBlock(in_ch, start * 2 ** s, k, stride,
                                          pack=pack, dtype=dtype))
            in_ch = start * 2 ** s
        self._stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        outputs = {}
        for s, stage in enumerate(self._stages):
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(stage, x, use_reentrant=False)
            else:
                x = stage(x)
            if s >= self.first_out:
                outputs[f"C{s}"] = x
        return outputs


class Decoder(nn.Module):
    """FPN decoder: 1x1 laterals, kernel == stride transposed-conv top-down
    path, 3x3 out convs for the required stages only."""

    def __init__(self, config: Dict[str, Any],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
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
        self._out = nn.ModuleList(
            Conv3d(lat_ch[s - self.earliest], fpn, 3, dtype=dtype)
            for s in self.stages_needed)

    def forward(self, enc_out: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        top_down = {}
        up = None
        ups = iter(self._up)
        for j in reversed(range(len(self.lateral_stages))):
            s = self.lateral_stages[j]
            x = self._lateral[j](enc_out[f"C{s}"])
            x = x if up is None else x + up
            top_down[s] = x
            if s > self.earliest:
                up = next(ups)(x)
        return {f"P{s}": out(top_down[s])
                for s, out in zip(self.stages_needed, self._out)}


class AttnFPN(nn.Module):
    """Backbone = Encoder + FPN Decoder (reference attn_fpn.py:18-29)."""

    def __init__(self, config: Dict[str, Any],
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        _check_supported(config)
        self._encoder = Encoder(config, min(required_stages(config)), dtype)
        self._decoder = Decoder(config, dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._decoder(self._encoder(x))
