"""3D multi-scale deformable attention sampling (port of
``transoar_tpu/ops/deformable_attention.py``).

The reference's pure-PyTorch spec ``ms_deform_attn_core_pytorch``: one
trilinear ``F.grid_sample`` per level (``align_corners=False``,
``padding_mode='zeros'``, grid = ``2 * loc - 1``), weighted by the
attention weights and summed over levels and points.

- ``value``: [B, S, M, D], the levels' tokens concatenated along S in the
  order of ``spatial_shapes`` [(s0, s1, s2), ...].
- ``sampling_locations``: [B, Q, M, L, P, 3], normalized; coordinate 0
  indexes the LAST spatial axis of a level and coordinate 2 the first
  (grid_sample's x / y / z, as the JAX op).
- ``attention_weights``: [B, Q, M, L, P]; output [B, Q, M * D], f32.

Rounding follows the JAX op, whose bf16 gathers meet f32 corner weights:
the value is taken in its own dtype (bf16 from a bf16 ``value_proj``) and
widened to f32 exactly, the weights likewise, and the interpolation, the
weighting and the sums over points and levels run in f32. Sampling in f32
also keeps bf16 atomics out of grid_sample's backward on the card, and
grid_sample keeps only its input and grid for the backward, not each
corner's gathered values.

The JAX package left this op to XLA gathers (no Pallas kernel: its
vector gathers do not lower), so it is stock PyTorch here.

Tracing: each call is the span ``ops.ms_deform_attn`` (a host range while
a profiler records) and counts itself in ``ms_deform_attn.calls`` and its
sampled points, B * Q * M * L * P, in ``ms_deform_attn.samples``.
``KERNELS`` names the device functions that do the op's work, forward and
backward, as the profiler's trace names them: grid_sample's. The
weighting's batched products run in cuBLAS functions that other products
of a step share by name, so they are not named.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from transoar_tpu_torch.utils.spans import span

KERNELS = ("grid_sampler_3d_kernel", "grid_sampler_3d_backward_kernel")


def ms_deform_attn(value: torch.Tensor, spatial_shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """[B, S, M, D], static [(s0, s1, s2)] * L, [B, Q, M, L, P, 3],
    [B, Q, M, L, P] -> [B, Q, M * D] f32."""
    ms_deform_attn.calls += 1
    ms_deform_attn.samples += attention_weights.numel()
    with span("ops.ms_deform_attn"):
        return _sample(value, spatial_shapes, sampling_locations,
                       attention_weights)


ms_deform_attn.calls = 0
ms_deform_attn.samples = 0


def _sample(value, spatial_shapes, sampling_locations, attention_weights):
    B, S, M, D = value.shape
    Q, L, P = sampling_locations.shape[1], sampling_locations.shape[3], \
        sampling_locations.shape[4]
    sizes = [math.prod(s) for s in spatial_shapes]
    if sum(sizes) != S or len(sizes) != L:
        raise ValueError(f"spatial shapes {spatial_shapes} do not tile "
                         f"{S} tokens over {L} levels")
    levels = value.float().split(sizes, dim=1)
    grids = (2.0 * sampling_locations.float() - 1.0).transpose(1, 2)
    weights = attention_weights.float().transpose(1, 2)  # [B, M, Q, L, P]
    out = None
    for lvl, (s0, s1, s2) in enumerate(spatial_shapes):
        v = levels[lvl].reshape(B, s0, s1, s2, M * D).permute(0, 4, 1, 2, 3)
        v = v.reshape(B * M, D, s0, s1, s2)
        grid = grids[:, :, :, lvl].reshape(B * M, Q, P, 1, 3)
        sampled = F.grid_sample(v, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
        # [B*M, D, Q, P] . [B*M, Q, P] -> [B*M, D, Q]
        part = torch.einsum("ndqp,nqp->ndq", sampled[..., 0],
                            weights[:, :, :, lvl].reshape(B * M, Q, P))
        out = part if out is None else out + part
    return out.reshape(B, M, D, Q).permute(0, 3, 1, 2).reshape(B, Q, M * D)
