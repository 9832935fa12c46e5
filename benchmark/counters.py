"""The port's own counters that the per-layer readers read."""

from __future__ import annotations


def launch_counts() -> dict:
    """The kernel wrappers' launch counters: the band conv's forward, input
    and weight gradients (kernels 1-3) and the window attention's forward
    and backward (kernels 4-5)."""
    from transoar_tpu_torch.ops.kernels import packed_conv as pc
    from transoar_tpu_torch.ops.kernels import window_attention as wa

    return {"band_fwd": pc.packed_conv.launches,
            "band_dx": pc.packed_conv_dx.launches,
            "band_dw": pc.packed_conv_dw.launches,
            "window_fwd": wa.fused_window_attention.launches,
            "window_bwd": wa.fused_window_attention_bwd.launches}
