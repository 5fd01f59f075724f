"""UFC feature & cost aggregation (loop layout).

Counterpart of ``coponerf_tpu/models/ufc.py`` with ``scan_layers=False``:
three coarse-to-fine stages of UFCLayers over flattened
correlation volumes (B, L, Hq*Wq, Hs*Ws), token stacks (2B, N, C) =
[all src; all trg], and the soft-argmax flow extraction: unfused by
default, through K5 (``ops/soft_argmax.py``) with ``fused_argmax``.
``dtype`` is the volume/token compute dtype (None = f32); norm statistics,
the dual softmax and the flow correlations stay f32, as in the JAX package.
With ``remat`` each UFC layer runs under ``torch.utils.checkpoint`` while
gradients are on (the JAX package's ``nn.remat``): its activations are
recomputed in the backward instead of kept; the numbers are unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from coponerf_tpu_torch.models.conv4d import Encoder4D, encoder4d_args
from coponerf_tpu_torch.models.layers import ConvNHWC, Dense, LayerNorm
from coponerf_tpu_torch.ops.correlation import (
    l2_normalize_channels,
    soft_argmax_flat,
    unnormalise_and_convert_mapping_to_flow,
)
from coponerf_tpu_torch.ops.resize import resize_bilinear
from coponerf_tpu_torch.ops.soft_argmax import soft_argmax_both


def linear_attention(q, k, v, eps: float = 1e-6):
    """elu-kernel linear attention; q/k: (N, L, H, D), v: (N, S, H, V)."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    v_length = v.shape[1]
    values = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, values)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def correlation_tokens_flat(src_tokens, trg_tokens, eps: float = 1e-5):
    """Cosine correlation (B, N, C) x (B, M, C) -> (B, 1, N, M); normalization
    in f32, the product in the input dtype."""
    dt = src_tokens.dtype
    src = l2_normalize_channels(src_tokens.float(), eps).to(dt)
    trg = l2_normalize_channels(trg_tokens.float(), eps).to(dt)
    return torch.einsum("bnc,bmc->bnm", src, trg)[:, None]


def corr_to_feat_tokens(corr, qhw, feat_hw):
    """(B, H, Q, S) -> tokens (B, feat_h*feat_w, H*S)."""
    b, h, Q, S = corr.shape
    x = corr.transpose(2, 3).reshape(b, h * S, qhw[0], qhw[1])
    x = resize_bilinear(x, feat_hw, align_corners=True, axes=(-2, -1))
    return x.reshape(b, h * S, feat_hw[0] * feat_hw[1]).transpose(1, 2)


def feat_tokens_to_corr(tokens, heads: int, src_hw):
    """tokens (B, N, H, S) -> flattened correlation (B, H, src_h*src_w, S)."""
    b, n, h, S = tokens.shape
    grid = int(round(n ** 0.5))
    x = tokens.permute(0, 2, 3, 1).reshape(b, h * S, grid, grid)
    x = resize_bilinear(x, src_hw, align_corners=True, axes=(-2, -1))
    return x.reshape(b, h, S, src_hw[0] * src_hw[1]).transpose(2, 3)


def interpolate4d_flat(corr, qhw, shw, out_q, out_s, align_corners: bool = True):
    """Resize a flattened volume (B, C, Q, S) on all four spatial axes."""
    b, c, Q, S = corr.shape
    x = corr.reshape(b, c, Q, shw[0], shw[1])
    x = resize_bilinear(x, out_s, align_corners, axes=(-2, -1))
    x = x.reshape(b, c, qhw[0], qhw[1], out_s[0] * out_s[1])
    x = resize_bilinear(x, out_q, align_corners, axes=(2, 3))
    return x.reshape(b, c, out_q[0] * out_q[1], out_s[0] * out_s[1])


class TokenMLP(nn.Module):
    """Linear -> depthwise 3x3 conv on the token grid -> GELU -> Linear."""

    def __init__(self, d_model: int, hidden: int, feat_hw, dtype=None):
        super().__init__()
        self.fc1 = Dense(d_model, hidden, dtype)
        self.dwconv = ConvNHWC(hidden, hidden, 3, padding=1, groups=hidden, dtype=dtype)
        self.fc2 = Dense(hidden, d_model, dtype)
        self.feat_hw = feat_hw

    def forward(self, x):
        b, n, _ = x.shape
        h, w = self.feat_hw
        x = self.fc1(x)
        x = self.dwconv(x.reshape(b, h, w, -1)).reshape(b, n, -1)
        return self.fc2(F.gelu(x))


class UFCLayer(nn.Module):
    def __init__(self, feat_dim: int = 256, corr_size: int = 16, d_model: int = 256, nhead: int = 8,
                 expand_ratio: float = 4.0, feat_size: Tuple[int, int] = (16, 16),
                 feat_to_corr_kernel: int = 3, feat_to_corr_stride: int = 1,
                 feat_to_corr_pad: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        h = nhead
        dt = dtype
        self.nhead, self.d_model, self.corr_size, self.feat_size = nhead, d_model, corr_size, feat_size
        self.dim = d_model // h
        cin = h * corr_size * corr_size + feat_dim  # [corr tokens || features]
        hidden = int(d_model * expand_ratio)
        self.q_proj = Dense(cin, d_model, dt)
        self.k_proj = Dense(cin, d_model, dt)
        self.v_proj = Dense(feat_dim, d_model, dt)
        self.v_proj_corr = Encoder4D(**encoder4d_args((h, h), 3, 1, 1, (1,)), dtype=dt)
        self.mlp = TokenMLP(d_model, hidden, feat_size, dt)
        self.mlp_corr = Encoder4D(**encoder4d_args((h, h * 4, h), 3, 1, 1, (1, 1)), dtype=dt)
        self.mlp_cross = TokenMLP(d_model, hidden, feat_size, dt)
        self.mlp_refine_corr = Encoder4D(**encoder4d_args((h, h * 4, h), 3, 1, 1, (1, 1)), dtype=dt)
        self.mlp_refine_corr2 = Encoder4D(**encoder4d_args((h, h * 4, h), 3, 1, 1, (1, 1)), dtype=dt)
        f2c = encoder4d_args((1, h), feat_to_corr_kernel, feat_to_corr_stride, feat_to_corr_pad, (1,))
        self.feat_to_corr1 = Encoder4D(**f2c, dtype=dt)
        self.feat_to_corr2 = Encoder4D(**f2c, dtype=dt)
        self.norm1 = LayerNorm(d_model, dt)
        self.norm2 = LayerNorm(d_model, dt)
        self.v_cross = Dense(d_model, d_model, dt)
        self.norm_cross1 = LayerNorm(d_model, dt)
        self.norm_cross2 = LayerNorm(d_model, dt)
        self.pos_embed = nn.Parameter(torch.zeros(1, feat_size[0] ** 2, 1, self.dim))

    def forward_attention(self, corr, feat):
        B, H, Q, S = corr.shape
        g = (self.corr_size, self.corr_size)
        fs = self.feat_size
        feat_r = feat
        feat = self.norm1(feat)
        cf = torch.cat([corr_to_feat_tokens(corr, g, fs), feat], dim=-1)
        q0 = self.q_proj(cf).reshape(B, -1, self.nhead, self.dim)
        pe = self.pos_embed.to(q0.dtype)
        query = q0 + pe
        key = self.k_proj(cf).reshape(B, -1, self.nhead, self.dim) + pe
        value_feat = self.v_proj(feat).reshape(B, -1, self.nhead, self.dim)
        vc, _, _ = self.v_proj_corr(corr, g, g)
        value_corr = corr_to_feat_tokens(vc, g, fs).reshape(B, fs[0] * fs[1], self.nhead, S)
        msg_feat = linear_attention(query, key, value_feat).reshape(B, -1, self.nhead * self.dim)
        msg_corr = feat_tokens_to_corr(linear_attention(query, key, value_corr), self.nhead, g)
        msg_feat = feat_r + msg_feat
        msg_corr = corr + msg_corr
        msg_feat = msg_feat + self.mlp(self.norm2(msg_feat))
        mc, _, _ = self.mlp_corr(msg_corr, g, g)
        return msg_corr + mc, msg_feat

    def forward_cross(self, corr, feat2):
        B = corr.shape[0]
        hs = ws = self.corr_size
        fh, fw = self.feat_size
        p1, p2 = fh // hs, fw // ws
        B2 = feat2.shape[0]
        pooled = feat2.reshape(B2, hs, p1, ws, p2, self.d_model).mean(dim=(2, 4))
        pooled = pooled.reshape(B2, hs * ws, self.d_model)
        v = self.v_cross(self.norm_cross1(pooled)).reshape(B2, -1, self.nhead, self.dim)
        src_v, trg_v = v[:B], v[B:]
        corr32 = corr.float()
        src_attn = torch.einsum(
            "bhst,bthc->bshc", torch.softmax(corr32, dim=-1).to(trg_v.dtype), trg_v
        ).reshape(B, -1, self.d_model)
        trg_attn = torch.einsum(
            "bhst,bshc->bthc", torch.softmax(corr32, dim=-2).to(src_v.dtype), src_v
        ).reshape(B, -1, self.d_model)
        attn2 = torch.cat([src_attn, trg_attn], dim=0).reshape(B2, hs, ws, self.d_model)
        attn2 = attn2.repeat_interleave(p1, dim=1).repeat_interleave(p2, dim=2).reshape(B2, -1, self.d_model)
        feat2 = feat2 + attn2
        return feat2 + self.mlp_cross(self.norm_cross2(feat2))

    def forward(self, corr, feat2, refine_last_corr: bool = True):
        B = corr.shape[0]
        g = (self.corr_size, self.corr_size)
        corr2 = torch.cat([corr, corr.transpose(2, 3)], dim=0)
        corr_out, feat2 = self.forward_attention(corr2, feat2)
        corr_r = corr_out[:B] + corr_out[B:].transpose(2, 3)
        c_new, _, _ = self.feat_to_corr1(correlation_tokens_flat(feat2[:B], feat2[B:]), self.feat_size, self.feat_size)
        corr_r = corr_r + c_new
        mr, _, _ = self.mlp_refine_corr(corr_r, g, g)
        corr_r = corr_r + mr
        feat2 = self.forward_cross(corr_r, feat2)
        if refine_last_corr:
            c_new2, _, _ = self.feat_to_corr2(correlation_tokens_flat(feat2[:B], feat2[B:]), self.feat_size, self.feat_size)
            corr_r = corr_r + c_new2
            mr2, _, _ = self.mlp_refine_corr2(corr_r, g, g)
            corr_r = corr_r + mr2
        return corr_r, feat2


class UFC(nn.Module):
    """Three-stage coarse-to-fine aggregation.  ``stage_hw`` are the input
    pyramid's grid sizes, coarse to fine (16/32/64 for a 256^2 image);
    ``in_dims`` their channel counts."""

    def __init__(self, stage_hw: Sequence[int], in_dims: Sequence[int] = (512, 256, 128),
                 nhead: int = 8, feat_dim: Sequence[int] = (256, 256, 256),
                 layer_nums: Sequence[int] = (2, 2, 1), f2c_kernel: Sequence[int] = (3, 3, 5),
                 f2c_stride: Sequence[int] = (1, 2, 4), f2c_pad: Sequence[int] = (1, 1, 2),
                 dtype: Optional[torch.dtype] = None, remat: bool = False, fused_argmax: bool = False):
        super().__init__()
        self.stage_hw, self.nhead, self.feat_dim, self.layer_nums = list(stage_hw), nhead, feat_dim, layer_nums
        self.remat, self.fused_argmax = remat, fused_argmax
        for s in range(3):
            for i in range(layer_nums[s]):
                self.add_module(f"layers_{s}_{i}", UFCLayer(
                    feat_dim=feat_dim[s], corr_size=stage_hw[0], d_model=feat_dim[s], nhead=nhead,
                    feat_size=(stage_hw[s], stage_hw[s]), feat_to_corr_kernel=f2c_kernel[s],
                    feat_to_corr_stride=f2c_stride[s], feat_to_corr_pad=f2c_pad[s], dtype=dtype,
                ))
            self.add_module(f"embedding_{s}", Encoder4D(
                **encoder4d_args((1, nhead), f2c_kernel[s], f2c_stride[s], f2c_pad[s], (1,)), dtype=dtype))
            self.add_module(f"proj_feat_{s}", Dense(in_dims[s], feat_dim[s], dtype))

    def forward(self, feats, nview: int = 2):
        """feats: 3 NHWC maps (B*nview, H, W, C), coarse to fine.  Returns
        (feat_list [3 NHWC maps], (flow, flow_flip, mapping_fwd, mapping_bwd),
        c (B, 1, fineHW, fineHW))."""
        B2 = feats[0].shape[0]
        B = B2 // nview
        tok2 = []
        for i, f in enumerate(feats):
            h, w, c = f.shape[1:]
            fv = f.reshape(B, nview, h, w, c)
            pair = torch.cat([fv[:, 0], fv[:, 1]], dim=0).reshape(B2, h * w, c)
            tok2.append(torch.relu(getattr(self, f"proj_feat_{i}")(pair)))

        def interp_tokens(tokens, out_hw):
            b, n, c = tokens.shape
            g = int(round(n ** 0.5))
            x = resize_bilinear(tokens.reshape(b, g, g, c), out_hw, align_corners=True, axes=(1, 2))
            return x.reshape(b, out_hw[0] * out_hw[1], c)

        feat_list, correlations = [], []
        corr_res = ft2_prev = None
        for s in range(3):
            hw = self.stage_hw[s]
            ft2 = tok2[s]
            corr = correlation_tokens_flat(ft2[:B], ft2[B:])
            corr, _, _ = getattr(self, f"embedding_{s}")(corr, (hw, hw), (hw, hw))
            if corr_res is not None:
                corr = corr_res + corr
            if s > 0:
                ft2 = interp_tokens(ft2_prev, (hw, hw)) + ft2
            for i in range(self.layer_nums[s]):
                layer = getattr(self, f"layers_{s}_{i}")
                if self.remat and torch.is_grad_enabled():
                    corr, ft2 = checkpoint(layer, corr, ft2, use_reentrant=False)
                else:
                    corr, ft2 = layer(corr, ft2)
            corr_res = corr
            ft2_prev = ft2
            src, trg = ft2[:B], ft2[B:]
            feat_list.append(torch.stack([src, trg], dim=1).reshape(B2, hw, hw, self.feat_dim[s]))
            correlations.append((correlation_tokens_flat(src.float(), trg.float()), hw))

        fine = self.stage_hw[-1]
        ups = [interpolate4d_flat(x, (hw, hw), (hw, hw), (fine, fine), (fine, fine)) for x, hw in correlations]
        c = sum(ups) / len(ups)
        if self.fused_argmax:
            mapping_fwd, mapping_bwd = soft_argmax_both(c[:, 0])
        else:
            mapping_fwd = soft_argmax_flat(c[:, 0], axis=2)
            mapping_bwd = soft_argmax_flat(c[:, 0], axis=1)
        flow = unnormalise_and_convert_mapping_to_flow(mapping_fwd)
        flow_flip = unnormalise_and_convert_mapping_to_flow(mapping_bwd)
        return feat_list, (flow, flow_flip, mapping_fwd, mapping_bwd), c
