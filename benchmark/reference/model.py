"""Plain TransoarNet: the AttnFPN encoder (CNN stages, or Swin stages from
stage 2 on), the FPN decoder, the sine position encoding, the Focused
Decoder and its heads, the anchor matcher and the detection criterion, and
AdamW, written as functions of a flat parameter dict in plain PyTorch.

The yardstick of the benchmark's ``correct``: frozen at transoar_tpu_torch
commit bf64563 from the math of ``models/{attn_fpn,layers,swin,
focused_decoder,transoarnet,matcher,criterion}.py``,
``utils/boxes.py``, ``training/trainer.derive_targets`` and
``training/train_state.py``, with plain ops in place of the port's
kernels: every 3x3x3 conv is ``F.conv3d`` (the port runs the stride-1
stage through a depth-packed band conv, kernels 1-3), the window attention
is a softmax of plain products (kernels 4-5), and the Focused Decoder's
cross-attention is the dense form with the per-organ bias on every token
(the port gathers each organ's tokens). Layout ``[B, S0, S1, S2, C]``;
parameter names and shapes are those of the port's ``state_dict``
(``param_shapes``), so one weight dict loads into both.

Precision: everything runs in float32 unless ``quant`` is given; then
every tensor the port holds in its compute dtype goes through it: the
operands and outputs of every conv, linear and attention product, the
norms' outputs and the residual sums (the benchmark's control passes an
fp8 rounding). Dropout and DropPath draw
their masks from the generator passed in, in the order and at the shapes
the port draws them, so both sides see the same masks.

Nothing here imports the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import geometry

MASKED_BIAS = -1e9
SWIN_MASK = -100.0


def _ident(t):
    return t


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def stage_layout(cfg):
    """Per encoder stage: (kind, in channels, out channels, input spatial,
    stride). Stages from 2 on are Swin stages under ``use_encoder_attn``."""
    bb = cfg["backbone"]
    start, n = bb["start_channels"], bb["num_stages"]
    swin_from = 2 if bb.get("use_encoder_attn") else n
    spatial = tuple(cfg["augmentation"]["patch_size"])
    in_ch = bb["in_channels"]
    out = []
    for s in range(n):
        stride = (2, 2, 2) if s >= swin_from else tuple(bb["strides"][s])
        out.append(("swin" if s >= swin_from else "cnn", in_ch,
                    start * 2 ** s, spatial, stride))
        spatial = tuple(-(-a // b) for a, b in zip(spatial, stride))
        in_ch = start * 2 ** s
    return out


def decoder_layout(cfg):
    """(lateral stages, their channels, the needed stages) of the FPN."""
    bb = cfg["backbone"]
    needed = sorted({int(f[-1]) for f in bb["out_fmaps"]})
    earliest = min(needed)
    lateral = list(range(earliest, bb["num_stages"]))
    lat_ch = [min(bb["start_channels"] * 2 ** s, bb["fpn_channels"])
              for s in lateral]
    return lateral, lat_ch, needed


def _check_supported(cfg):
    bb, neck = cfg["backbone"], cfg["neck"]
    if bb.get("use_decoder_attn") or bb.get("use_seg_proxy_loss") \
            or neck.get("name", "foc_attn") != "foc_attn" \
            or "retina" in cfg or bb.get("swin", {}).get("conv_merging") \
            or neck.get("pos_encoding", "sine") != "sine":
        raise ValueError("the plain reference covers the Focused Decoder "
                         "over the CNN or Swin AttnFPN with a sine encoding")


def param_shapes(cfg) -> dict:
    """{name: shape} of every parameter, as the port's ``state_dict``."""
    _check_supported(cfg)
    bb, neck = cfg["backbone"], cfg["neck"]
    shapes = {}
    enc = "_backbone._encoder._stages"
    swin = bb.get("swin", {})
    for s, (kind, cin, cout, spatial, _) in enumerate(stage_layout(cfg)):
        if kind == "cnn":
            k = bb.get("kernel_size", 3)
            shapes[f"{enc}.{s}._block.0.weight"] = (cout, cin, k, k, k)
            shapes[f"{enc}.{s}._block.1.weight"] = (cout,)
            shapes[f"{enc}.{s}._block.1.bias"] = (cout,)
            shapes[f"{enc}.{s}._block.3.weight"] = (cout, cout, k, k, k)
            shapes[f"{enc}.{s}._block.4.weight"] = (cout,)
            shapes[f"{enc}.{s}._block.4.bias"] = (cout,)
            continue
        i = s - 2
        dim, heads = cin, swin["num_heads"][i]
        ws, _ = geometry.effective_window(spatial, swin["window_size"],
                                          (0, 0, 0))
        table = (2 * ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1)
        hidden = int(dim * swin["mlp_ratio"])
        for j in range(swin["depths"][i]):
            p = f"{enc}.{s}.blocks.{j}"
            shapes.update({
                f"{p}.norm1.weight": (dim,), f"{p}.norm1.bias": (dim,),
                f"{p}.attn.relative_position_bias_table": (table, heads),
                f"{p}.attn.qkv.weight": (3 * dim, dim),
                f"{p}.attn.proj.weight": (dim, dim),
                f"{p}.attn.proj.bias": (dim,),
                f"{p}.norm2.weight": (dim,), f"{p}.norm2.bias": (dim,),
                f"{p}.mlp.fc1.weight": (hidden, dim),
                f"{p}.mlp.fc1.bias": (hidden,),
                f"{p}.mlp.fc2.weight": (dim, hidden),
                f"{p}.mlp.fc2.bias": (dim,)})
            if swin.get("qkv_bias", True):
                shapes[f"{p}.attn.qkv.bias"] = (3 * dim,)
        shapes[f"{enc}.{s}.downsample.norm.weight"] = (8 * dim,)
        shapes[f"{enc}.{s}.downsample.norm.bias"] = (8 * dim,)
        shapes[f"{enc}.{s}.downsample.reduction.weight"] = (2 * dim, 8 * dim)

    lateral, lat_ch, needed = decoder_layout(cfg)
    enc_ch = [bb["start_channels"] * 2 ** s for s in range(bb["num_stages"])]
    dec = "_backbone._decoder"
    for j, (s, c) in enumerate(zip(lateral, lat_ch)):
        shapes[f"{dec}._lateral.{j}.weight"] = (c, enc_ch[s], 1, 1, 1)
        shapes[f"{dec}._lateral.{j}.bias"] = (c,)
    k = 0
    for s in reversed(lateral):
        if s > lateral[0]:
            st = tuple(bb["strides"][s])
            cin, cout = lat_ch[s - lateral[0]], lat_ch[s - lateral[0] - 1]
            shapes[f"{dec}._up.{k}.weight"] = (cin, cout, *st)
            shapes[f"{dec}._up.{k}.bias"] = (cout,)
            k += 1
    for m, s in enumerate(needed):
        shapes[f"{dec}._out.{m}.weight"] = (bb["fpn_channels"],
                                            lat_ch[s - lateral[0]], 3, 3, 3)
        shapes[f"{dec}._out.{m}.bias"] = (bb["fpn_channels"],)

    C, ff = neck["hidden_dim"], neck["dim_feedforward"]
    for i in range(neck["dec_layers"]):
        p = f"_neck.decoder.layers.{i}"
        shapes.update({
            f"{p}.self_attn.in_proj_weight": (3 * C, C),
            f"{p}.self_attn.in_proj_bias": (3 * C,),
            f"{p}.self_attn.out_proj.weight": (C, C),
            f"{p}.self_attn.out_proj.bias": (C,),
            f"{p}.norm2.weight": (C,), f"{p}.norm2.bias": (C,),
            f"{p}.cross_attn.k_proj.weight": (C, C),
            f"{p}.cross_attn.v_proj.weight": (C, C),
            f"{p}.cross_attn.proj.weight": (C, C),
            f"{p}.cross_attn.proj.bias": (C,),
            f"{p}.norm1.weight": (C,), f"{p}.norm1.bias": (C,),
            f"{p}.linear1.weight": (ff, C), f"{p}.linear1.bias": (ff,),
            f"{p}.linear2.weight": (C, ff), f"{p}.linear2.bias": (C,),
            f"{p}.norm3.weight": (C,), f"{p}.norm3.bias": (C,)})
        if not neck.get("share_qk_proj", True):
            shapes[f"{p}.cross_attn.q_proj.weight"] = (C, C)
    shapes["_query_embed.weight"] = (neck["num_queries"], 2 * C)
    shapes["_cls_head.weight"] = (1, C)
    shapes["_cls_head.bias"] = (1,)
    for i, (a, b) in enumerate([(C, C), (C, C), (C, 6)]):
        shapes[f"_reg_head.layers.{i}.weight"] = (b, a)
        shapes[f"_reg_head.layers.{i}.bias"] = (b,)
    return shapes


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _dropout(x, p, gen):
    if p <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def _drop_path(x, p, gen):
    if p <= 0.0:
        return x
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    keep = torch.rand(shape, generator=gen, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)


def _linear(x, w, b, q):
    return q(F.linear(q(x), q(w), b))


def _conv(x, w, b, stride, q):
    """Channels-last conv with symmetric padding (k - 1) // 2."""
    pad = (w.shape[-1] - 1) // 2
    y = F.conv3d(q(x).permute(0, 4, 1, 2, 3), q(w), b, stride, pad)
    return q(y.permute(0, 2, 3, 4, 1))


def _instance_norm(x, w, b, eps=1e-5):
    dims = (1, 2, 3)
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def _layer_norm(x, P, name, q=_ident):
    return q(F.layer_norm(x, x.shape[-1:], P[f"{name}.weight"],
                          P[f"{name}.bias"], 1e-5))


def _cnn_stage(x, P, p, stride, q):
    x = F.relu(q(_instance_norm(_conv(x, P[f"{p}._block.0.weight"], None,
                                      stride, q),
                                P[f"{p}._block.1.weight"],
                                P[f"{p}._block.1.bias"])))
    return F.relu(q(_instance_norm(_conv(x, P[f"{p}._block.3.weight"], None,
                                         1, q),
                                   P[f"{p}._block.4.weight"],
                                   P[f"{p}._block.4.bias"])))


def _window_attention(x, P, p, heads, ws, regions, q):
    """x [B_, N, C] windows -> [B_, N, C]."""
    B_, N, C = x.shape
    hd = C // heads
    qkv = _linear(x, P[f"{p}.attn.qkv.weight"], P.get(f"{p}.attn.qkv.bias"),
                  q).view(B_, N, 3, heads, hd)
    qh = (qkv[:, :, 0] * hd ** -0.5).transpose(1, 2)
    kh = qkv[:, :, 1].transpose(1, 2)
    vh = qkv[:, :, 2].transpose(1, 2)
    table = P[f"{p}.attn.relative_position_bias_table"]
    idx = torch.as_tensor(geometry.relative_position_index(ws).reshape(-1),
                          device=x.device)
    bias = table[idx].view(N, N, heads).permute(2, 0, 1)
    s = q(qh) @ q(kh).transpose(-1, -2) + bias
    nW = regions.shape[0]
    mask = torch.where(regions[:, :, None] != regions[:, None, :],
                       SWIN_MASK, 0.0)
    s = (s.view(B_ // nW, nW, heads, N, N) + mask[None, :, None]).view(
        B_, heads, N, N)
    out = q(s.softmax(-1)) @ q(vh)
    out = out.transpose(1, 2).reshape(B_, N, C)
    return _linear(out, P[f"{p}.attn.proj.weight"], P[f"{p}.attn.proj.bias"],
                   q)


def _swin_block(x, P, p, heads, window, shift, rate, gen, q):
    B, D, H, W, C = x.shape
    ws, ss = geometry.effective_window(
        (D, H, W), window, tuple(w // 2 for w in window) if shift
        else (0, 0, 0))
    shortcut = x
    x = _layer_norm(x, P, f"{p}.norm1", q)
    pad = [(ws[i] - x.shape[1 + i] % ws[i]) % ws[i] for i in range(3)]
    x = F.pad(x, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
    Dp, Hp, Wp = x.shape[1:4]
    if any(ss):
        x = torch.roll(x, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
        regions = geometry.shifted_window_regions((Dp, Hp, Wp), ws, ss)
    else:
        regions = np.zeros((1, int(np.prod(ws))), np.float32)
    regions = torch.as_tensor(regions, device=x.device)
    x = _window_attention(geometry.window_partition(x, ws), P, p, heads, ws,
                          regions, q)
    x = geometry.window_reverse(x, ws, B, Dp, Hp, Wp)
    if any(ss):
        x = torch.roll(x, shifts=tuple(ss), dims=(1, 2, 3))
    x = q(shortcut + _drop_path(x[:, :D, :H, :W], rate, gen))
    h = _layer_norm(x, P, f"{p}.norm2", q)
    h = _linear(F.gelu(_linear(h, P[f"{p}.mlp.fc1.weight"],
                               P[f"{p}.mlp.fc1.bias"], q)),
                P[f"{p}.mlp.fc2.weight"], P[f"{p}.mlp.fc2.bias"], q)
    return q(x + _drop_path(h, rate, gen))


def _patch_merging(x, P, p, q):
    B, D, H, W, C = x.shape
    x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))
    D2, H2, W2 = x.shape[1] // 2, x.shape[2] // 2, x.shape[3] // 2
    x = x.reshape(B, D2, 2, H2, 2, W2, 2, C)
    x = x.permute(0, 1, 3, 5, 2, 6, 4, 7).reshape(B, D2, H2, W2, 8 * C)
    x = _layer_norm(x, P, f"{p}.norm", q)
    return _linear(x, P[f"{p}.reduction.weight"], None, q)


def encoder(x, P, cfg, gen, train, q=_ident):
    """{stage: output} of the encoder."""
    bb = cfg["backbone"]
    swin = bb.get("swin", {})
    layout = stage_layout(cfg)
    if any(kind == "swin" for kind, *_ in layout):
        depths = swin["depths"]
        rates = np.linspace(0.0, float(swin.get("drop_path_rate", 0.0)),
                            sum(depths)).tolist()
    outs = {}
    for s, (kind, _, _, _, stride) in enumerate(layout):
        p = f"_backbone._encoder._stages.{s}"
        if kind == "cnn":
            x = _cnn_stage(x, P, p, stride, q)
        else:
            i = s - 2
            lo = sum(depths[:i])
            for j in range(depths[i]):
                rate = rates[lo + j] if train else 0.0
                x = _swin_block(x, P, f"{p}.blocks.{j}", swin["num_heads"][i],
                                tuple(swin["window_size"]), j % 2 == 1, rate,
                                gen, q)
            x = _patch_merging(x, P, f"{p}.downsample", q)
        outs[s] = x
    return outs


def fpn(enc, P, cfg, q=_ident):
    """{stage: P-level} of the FPN decoder for the needed stages."""
    bb = cfg["backbone"]
    lateral, _, needed = decoder_layout(cfg)
    dec = "_backbone._decoder"
    top, up, k = {}, None, 0
    for j in reversed(range(len(lateral))):
        s = lateral[j]
        x = _conv(enc[s], P[f"{dec}._lateral.{j}.weight"],
                  P[f"{dec}._lateral.{j}.bias"], 1, q)
        x = x if up is None else q(x + up)
        top[s] = x
        if s > lateral[0]:
            st = tuple(bb["strides"][s])
            y = F.conv_transpose3d(q(x).permute(0, 4, 1, 2, 3),
                                   q(P[f"{dec}._up.{k}.weight"]),
                                   P[f"{dec}._up.{k}.bias"], st)
            up = q(y.permute(0, 2, 3, 4, 1))
            k += 1
    return {s: _conv(top[s], P[f"{dec}._out.{m}.weight"],
                     P[f"{dec}._out.{m}.bias"], 1, q)
            for m, s in enumerate(needed)}


def _self_attention(x_q, x_v, P, p, heads, drop, gen, q):
    w, b = P[f"{p}.in_proj_weight"], P[f"{p}.in_proj_bias"]
    B, Q, C = x_q.shape
    hd = C // heads

    def proj(x, i):
        return _linear(x, w[i * C:(i + 1) * C], b[i * C:(i + 1) * C],
                       q).view(B, -1, heads, hd)

    qh, kh, vh = proj(x_q, 0), proj(x_q, 1), proj(x_v, 2)
    attn = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) / math.sqrt(hd)
    attn = _dropout(attn.softmax(-1), drop, gen)
    out = torch.einsum("bhqk,bkhd->bqhd", q(attn), q(vh)).reshape(B, Q, C)
    return _linear(out, P[f"{p}.out_proj.weight"], P[f"{p}.out_proj.bias"],
                   q)


def _focused_attention(x_q, x_k, x_v, bias_q, P, p, heads, gen, train, q):
    """Dense form: every query over every token, the organ's bias added."""
    B, Q, C = x_q.shape
    hd = C // heads
    wk = P[f"{p}.k_proj.weight"]
    wq = P.get(f"{p}.q_proj.weight", wk)
    kh = _linear(x_k, wk, None, q).view(B, -1, heads, hd)
    vh = _linear(x_v, P[f"{p}.v_proj.weight"], None, q).view(B, -1, heads, hd)
    qh = _linear(x_q, wq, None, q).view(B, Q, heads, hd) * hd ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q(qh), q(kh)) + bias_q
    attn = logits.softmax(-1)
    out = torch.einsum("bhqk,bkhd->bqhd", q(attn), q(vh)).reshape(B, Q, C)
    out = _linear(out, P[f"{p}.proj.weight"], P[f"{p}.proj.bias"], q)
    return _dropout(out, 0.1 if train else 0.0, gen)


def neck_forward(src, P, cfg, consts, gen, train, q=_ident):
    """src [B, S0, S1, S2, C] -> hs [L, B, Q, C]."""
    neck = cfg["neck"]
    B, C = src.shape[0], src.shape[-1]
    pos = consts["pos"].to(src.device).expand(B, *consts["pos"].shape)
    src, pos = src.reshape(B, -1, C), pos.reshape(B, -1, C)
    query_pos, tgt = P["_query_embed.weight"].chunk(2, dim=-1)
    query_pos = query_pos.expand(B, *query_pos.shape)
    tgt = tgt.expand(B, *tgt.shape)
    drop = float(neck.get("dropout", 0.0)) if train else 0.0
    heads = neck["nheads"]
    bias_q = consts["attn_bias_q"]
    hs = []
    for i in range(neck["dec_layers"]):
        p = f"_neck.decoder.layers.{i}"
        x = tgt + query_pos
        sa = _self_attention(x, tgt, P, f"{p}.self_attn", heads, drop, gen, q)
        tgt = _layer_norm(q(tgt + _dropout(sa, drop, gen)), P,
                          f"{p}.norm2", q)
        ca = _focused_attention(tgt + query_pos, src + pos, src, bias_q, P,
                                f"{p}.cross_attn", heads, gen, train, q)
        tgt = _layer_norm(q(tgt + _dropout(ca, drop, gen)), P,
                          f"{p}.norm1", q)
        h = _dropout(F.relu(_linear(tgt, P[f"{p}.linear1.weight"],
                                    P[f"{p}.linear1.bias"], q)), drop, gen)
        h = _linear(h, P[f"{p}.linear2.weight"], P[f"{p}.linear2.bias"], q)
        tgt = _layer_norm(q(tgt + _dropout(h, drop, gen)), P,
                          f"{p}.norm3", q)
        hs.append(tgt)
    return torch.stack(hs)


def constants(cfg, device):
    """Anchors, restrictions, the per-query attention bias and the sine
    table, worked out from the config's box statistics."""
    neck = cfg["neck"]
    level = int(neck["input_levels"][-1])
    shape = tuple(int(s) // 2 ** level
                  for s in cfg["augmentation"]["patch_size"])
    anchors, restr = geometry.generate_anchors(neck, cfg["bbox_properties"])
    bias = geometry.generate_attn_bias(cfg["bbox_properties"], shape,
                                       neck.get("restrict_attn", True))
    qpo = neck["num_queries"] // neck["num_organs"]
    as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return {"anchors": as_t(anchors), "restrictions": as_t(restr),
            "attn_bias_q": as_t(np.repeat(bias, qpo, axis=0)),
            "pos": as_t(geometry.sine_position_encoding(
                shape, neck["hidden_dim"]))}


def forward(P, x, cfg, consts, gen=None, train=False, q=_ident):
    """x [B, S0, S1, S2, 1] -> {pred_logits [B, Q, 1], pred_boxes [B, Q, 6],
    aux_logits, aux_boxes [L-1, B, Q, .]}."""
    feats = fpn(encoder(x, P, cfg, gen, train, q), P, cfg, q)
    level = int(cfg["neck"]["input_levels"][-1])
    hs = neck_forward(feats[level], P, cfg, consts, gen, train, q)
    logits = _linear(hs, P["_cls_head.weight"], P["_cls_head.bias"], q)
    raw = hs
    for i in range(3):
        raw = _linear(raw, P[f"_reg_head.layers.{i}.weight"],
                      P[f"_reg_head.layers.{i}.bias"], q)
        if i < 2:
            raw = F.relu(raw)
    boxes = (torch.tanh(raw) * consts["restrictions"]
             + consts["anchors"]).clamp(0.0, 1.0)
    out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
    if cfg["neck"].get("aux_loss"):
        out["aux_logits"], out["aux_boxes"] = logits[:-1], boxes[:-1]
    return out


# ---------------------------------------------------------------------------
# targets, matcher, criterion
# ---------------------------------------------------------------------------

def targets(seg, num_classes, padding=1, min_extent=5):
    """Per-organ boxes of a label batch [B, S0, S1, S2]: (boxes [B, O, 6]
    normalized cxcyczwhd, present [B, O])."""
    B, spatial = seg.shape[0], seg.shape[1:]
    boxes = torch.zeros((B, num_classes, 6), device=seg.device)
    present = torch.zeros((B, num_classes), dtype=torch.bool,
                          device=seg.device)
    size = torch.tensor(spatial, dtype=torch.float32, device=seg.device)
    for b in range(B):
        for c in range(num_classes):
            idx = torch.nonzero(seg[b] == c + 1)
            if len(idx) == 0:
                continue
            lo, hi = idx.amin(0).float(), idx.amax(0).float()
            if ((hi - lo) < min_extent).any():
                continue
            lo = (lo - padding).clamp_min(0.0) / size
            hi = torch.minimum(hi + padding, size) / size
            boxes[b, c] = torch.cat([(lo + hi) / 2, hi - lo])
            present[b, c] = True
    return boxes, present


def _corners(b):
    return torch.cat([b[..., :3] - 0.5 * b[..., 3:],
                      b[..., :3] + 0.5 * b[..., 3:]], -1)


def _giou(a, b, eps=1e-7):
    """GIoU of broadcastable corner boxes [..., 6]."""
    def vol(lo, hi):
        d = (hi - lo).clamp_min(0.0)
        return d[..., 0] * d[..., 1] * d[..., 2]

    va = vol(a[..., :3], a[..., 3:])
    vb = vol(b[..., :3], b[..., 3:])
    inter = vol(torch.maximum(a[..., :3], b[..., :3]),
                torch.minimum(a[..., 3:], b[..., 3:]))
    union = va + vb - inter
    iou = inter / (union + eps)
    hull = vol(torch.minimum(a[..., :3], b[..., :3]),
               torch.maximum(a[..., 3:], b[..., 3:]))
    return iou - (hull - union) / (hull + eps)


@torch.no_grad()
def match(logits, boxes, anchors, tgt, present, organs, m):
    """(one-hot matches [B, O, qpo], soft labels, -1 where absent)."""
    B, Q, _ = logits.shape
    qpo = Q // organs
    lg = logits.reshape(B, organs, qpo)
    qb = (anchors.reshape(1, organs, qpo, 6).expand(B, -1, -1, -1)
          if m["anchor_matching"] else boxes.reshape(B, organs, qpo, 6))
    c_class = -torch.sigmoid(lg)
    c_bbox = (qb - tgt[:, :, None]).abs().sum(-1)
    c_giou = -_giou(_corners(qb.clamp_min(0.0)), _corners(tgt)[:, :, None])
    cost = (float(m["cost_bbox"]) * c_bbox + float(m["cost_class"]) * c_class
            + float(m["cost_giou"]) * c_giou)
    matches = F.one_hot(cost.argmin(-1), qpo).float()
    c_max = c_giou.amax(-1, keepdim=True)
    c_min = c_giou.amin(-1, keepdim=True)
    denom = c_min - c_max
    soft = torch.where(denom.abs() > 1e-12, (c_giou - c_max) / denom,
                       torch.ones_like(c_giou)).clamp_min(0.0)
    p = present[:, :, None]
    return torch.where(p, matches, 0.0), torch.where(p, soft, -1.0)


def _det_losses(logits, boxes, matches, soft, tgt, present, organs):
    B = logits.shape[0]
    lg = logits.reshape(B, organs, -1)
    valid = soft != -1
    bce = F.binary_cross_entropy_with_logits(lg, soft.clamp_min(0.0),
                                             reduction="none")
    cls = torch.where(valid, bce, 0.0).sum() / valid.sum().clamp_min(1)
    matched = torch.einsum("boq,boqc->boc", matches,
                           boxes.reshape(B, organs, -1, 6))
    pres = present.float()
    n = pres.sum().clamp_min(1.0)
    l1 = ((matched - tgt).abs().sum(-1) * pres).sum() / n
    giou = _giou(_corners(matched.clamp_min(0.0)), _corners(tgt))
    return l1, ((1.0 - giou) * pres).sum() / n, cls


def total_loss(out, tgt, present, consts, cfg):
    """(the weighted sum of the final and auxiliary detection losses, its
    classification part). The classification part is BCE against the soft
    labels, which the anchors and targets fix: it does not depend on
    which query the matcher picks."""
    organs = cfg["neck"]["num_organs"]
    coefs = cfg["loss_coefs"]
    sets = [(out["pred_logits"], out["pred_boxes"])]
    if "aux_logits" in out:
        sets += list(zip(out["aux_logits"], out["aux_boxes"]))
    total = cls_part = 0.0
    for logits, boxes in sets:
        mt, soft = match(logits.detach(), boxes.detach(), consts["anchors"],
                         tgt, present, organs, cfg["matching"])
        l1, giou, cls = _det_losses(logits, boxes, mt, soft, tgt, present,
                                    organs)
        total = total + coefs["bbox"] * l1 + coefs["giou"] * giou \
            + coefs["cls"] * cls
        cls_part = cls_part + coefs["cls"] * cls.detach()
    return total, cls_part


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamW:
    """AdamW, betas 0.9 / 0.999, eps 1e-8, decoupled decay ``lr * wd * p``;
    ``_backbone.*`` at ``lr_backbone``, the rest at ``lr``. The schedule's
    10x drop lies thousands of epochs past the steps compared."""

    def __init__(self, params: dict, cfg):
        t = cfg["trainer"]
        self.P = params
        self.lr = {n: float(t["lr_backbone"] if n.startswith("_backbone.")
                            else t["lr"]) for n in params}
        self.wd = float(t["weight_decay"])
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict):
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for n, g in grads.items():
            p, lr = self.P[n], self.lr[n]
            p.mul_(1 - lr * self.wd)
            self.m[n].mul_(0.9).add_(g, alpha=0.1)
            self.v[n].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = (self.v[n] / c2).sqrt_().add_(1e-8)
            p.addcdiv_(self.m[n], denom, value=-lr / c1)
