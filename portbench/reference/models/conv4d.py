"""Separable 4D convolution over flattened correlation volumes.

Counterpart of ``coponerf_tpu/models/conv4d.py``: a Conv4d is a 2D conv
over the query pair plus a 2D conv over the support pair, summed; a strided
branch first max-pools the other pair (kernel = stride, ceil mode).
Volumes stay ``(B, L, Hq*Wq, Hs*Ws)``.  Two formulations of the branches
(``impl``, from ``ModelConfig.conv4d_impl``), the same numbers:
  - ``"2d"``: the untouched pair folded into the batch of a ``conv2d``,
    which takes a permute copy of the input and of the output a branch;
  - ``"3d"``: one ``conv3d`` a branch straight on the flattened layout,
    ``(B, L, hq, wq, Sq)`` with a ``(k0, k1, 1)`` kernel and ``(B, L, Qs,
    hs, ws)`` with a ``(1, k2, k3)`` one: no copies.  The weights are the
    same ``conv2d`` parameters, unsqueezed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.models.layers import GroupNormND


def maxpool_pair_flat(x: torch.Tensor, size: int, pair: str, qhw: Tuple[int, int], shw: Tuple[int, int]):
    """Max-pool one coordinate pair of (B, L, Q, S) with kernel = stride =
    ``size``, ceil mode (right-padded with -inf)."""
    if size == 1:
        return x, qhw, shw
    B, L, Q, S = x.shape
    inf = float("-inf")
    if pair == "support":
        hs, ws = shw
        x5 = F.pad(x.reshape(B, L, Q, hs, ws), (0, (-ws) % size, 0, (-hs) % size), value=inf)
        h2, w2 = x5.shape[3] // size, x5.shape[4] // size
        out = x5.reshape(B, L, Q, h2, size, w2, size).amax(dim=(4, 6))
        return out.reshape(B, L, Q, h2 * w2), qhw, (h2, w2)
    hq, wq = qhw
    x5 = F.pad(x.reshape(B, L, hq, wq, S), (0, 0, 0, (-wq) % size, 0, (-hq) % size), value=inf)
    h2, w2 = x5.shape[2] // size, x5.shape[3] // size
    out = x5.reshape(B, L, h2, size, w2, size, S).amax(dim=(3, 5))
    return out.reshape(B, L, h2 * w2, S), (h2, w2), shw


class Conv4d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride, padding,
                 dtype: Optional[torch.dtype] = None, impl: str = "2d"):
        super().__init__()
        if impl not in ("2d", "3d"):
            raise ValueError(f"Conv4d impl must be '2d' or '3d', not {impl!r}")
        k, s, p = kernel_size, stride, padding
        self.query_conv = nn.Conv2d(in_channels, out_channels, (k[0], k[1]), (s[0], s[1]), (p[0], p[1]))
        self.supp_conv = nn.Conv2d(in_channels, out_channels, (k[2], k[3]), (s[2], s[3]), (p[2], p[3]))
        self.k, self.s = k, s
        self.out_channels = out_channels
        self.dtype = dtype
        self.impl = impl

    def forward(self, x: torch.Tensor, qhw, shw):
        """x: (B, L, Hq*Wq, Hs*Ws) -> (B, L', Hq'*Wq', Hs'*Ws'), new dims."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        dt = x.dtype
        B, L, Q, S = x.shape
        k, s = self.k, self.s
        change_supp = s[-1] > 1 or (s[0] == 1 and k[0] == 1)
        change_query = s[0] > 1 or (s[0] == 1 and k[0] == 1)
        xq_in, qhw_q, _ = maxpool_pair_flat(x, s[-1], "support", qhw, shw) if change_supp else (x, qhw, shw)
        xs_in, _, shw_s = maxpool_pair_flat(x, s[0], "query", qhw, shw) if change_query else (x, qhw, shw)
        hq, wq = qhw_q
        hs, ws = shw_s
        Sq = xq_in.shape[-1]
        Qs = xs_in.shape[-2]
        O = self.out_channels
        qc, sc = self.query_conv, self.supp_conv

        if self.impl == "3d":
            oq = F.conv3d(xq_in.reshape(B, L, hq, wq, Sq), qc.weight.to(dt)[..., None], qc.bias.to(dt),
                          (*qc.stride, 1), (*qc.padding, 0))
            os_ = F.conv3d(xs_in.reshape(B, L, Qs, hs, ws), sc.weight.to(dt)[:, :, None], sc.bias.to(dt),
                           (1, *sc.stride), (0, *sc.padding))
            hqo, wqo = oq.shape[2:4]
            hso, wso = os_.shape[3:5]
            return (oq.reshape(B, O, hqo * wqo, Sq) + os_.reshape(B, O, Qs, hso * wso)), (hqo, wqo), (hso, wso)

        xq = xq_in.reshape(B, L, hq, wq, Sq).permute(0, 4, 1, 2, 3).reshape(B * Sq, L, hq, wq)
        xs = xs_in.reshape(B, L, Qs, hs, ws).permute(0, 2, 1, 3, 4).reshape(B * Qs, L, hs, ws)
        oq = F.conv2d(xq, qc.weight.to(dt), qc.bias.to(dt), qc.stride, qc.padding)
        os_ = F.conv2d(xs, sc.weight.to(dt), sc.bias.to(dt), sc.stride, sc.padding)
        hqo, wqo = oq.shape[2:]
        hso, wso = os_.shape[2:]
        oq = oq.reshape(B, Sq, O, hqo * wqo).permute(0, 2, 3, 1)
        os_ = os_.reshape(B, Qs, O, hso * wso).permute(0, 2, 1, 3)
        return oq + os_, (hqo, wqo), (hso, wso)


class Encoder4D(nn.Module):
    """N x (Conv4d -> GroupNorm -> ReLU) over a flattened volume."""

    def __init__(self, corr_levels: Sequence[int], kernel_size, stride, padding, group: Sequence[int] = (1,),
                 dtype: Optional[torch.dtype] = None, impl: str = "2d"):
        super().__init__()
        self.n = len(kernel_size)
        for i, (k, s, p) in enumerate(zip(kernel_size, stride, padding)):
            self.add_module(f"conv4d_{i}", Conv4d(corr_levels[i], corr_levels[i + 1], k, s, p, dtype, impl))
            self.add_module(f"gn_{i}", GroupNormND(group[i], corr_levels[i + 1]))

    def forward(self, x, qhw, shw):
        for i in range(self.n):
            x, qhw, shw = getattr(self, f"conv4d_{i}")(x, qhw, shw)
            x = torch.relu(getattr(self, f"gn_{i}")(x))
        return x, qhw, shw


def encoder4d_args(levels, k, s, p, groups):
    n = len(levels) - 1
    return dict(
        corr_levels=levels,
        kernel_size=((k,) * 4,) * n,
        stride=((s,) * 4,) * n,
        padding=((p,) * 4,) * n,
        group=groups,
    )
