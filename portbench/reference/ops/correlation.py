"""Correlation-volume primitives: cosine correlation, soft-argmax flow
extraction and mapping-to-flow conversion.

Counterpart of ``coponerf_tpu/ops/correlation.py``.  ``soft_argmax_flat``
is the unfused form the UFC runs by default.
"""

from __future__ import annotations

import torch


def l2_normalize_channels(feat: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x / (||x|| + eps) over the trailing channel axis."""
    return feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True) + eps)


def correlation_tokens(src_tokens: torch.Tensor, trg_tokens: torch.Tensor, feat_hw: tuple[int, int], eps: float = 1e-5) -> torch.Tensor:
    """Cosine correlation of row-major token sequences (B, H*W, C) ->
    (B, 1, H, W, H, W)."""
    h, w = feat_hw
    b, _, c = src_tokens.shape
    src = l2_normalize_channels(src_tokens.reshape(b, h, w, c), eps)
    trg = l2_normalize_channels(trg_tokens.reshape(b, h, w, c), eps)
    return torch.einsum("bhwc,bxyc->bhwxy", src, trg)[:, None]


def soft_argmax_flat(logits: torch.Tensor, axis: int, beta: float = 0.02) -> torch.Tensor:
    """Soft-argmax on a flattened correlation (B, Q, S).

    ``axis`` is the token axis the softmax runs over (1 = Q, 2 = S);
    positions are the other axis's row-major grid.  Returns the [-1, 1]
    mapping (B, 2, h, w); the softmax division is deferred past the
    coordinate dots, as in the JAX package."""
    b, Q, S = logits.shape
    n = logits.shape[axis]
    hs = int(round(n ** 0.5))
    ws = n // hs
    m = Q if axis == 2 else S
    hm = int(round(m ** 0.5))
    wm = m // hm
    mx = torch.amax(logits, dim=axis, keepdim=True)
    e = torch.exp((logits - mx) / beta)
    z = torch.sum(e, dim=axis)
    ar = torch.arange(n, device=logits.device)
    xv = torch.linspace(-1.0, 1.0, ws, dtype=logits.dtype, device=logits.device)[ar % ws]
    yv = torch.linspace(-1.0, 1.0, hs, dtype=logits.dtype, device=logits.device)[ar // ws]
    spec = "bqs,s->bq" if axis == 2 else "bqs,q->bs"
    gx = torch.einsum(spec, e, xv) / z
    gy = torch.einsum(spec, e, yv) / z
    return torch.stack([gx, gy], dim=1).reshape(b, 2, hm, wm)


def unnormalise_and_convert_mapping_to_flow(mapping: torch.Tensor) -> torch.Tensor:
    """[-1, 1]-normalized mapping (B, 2, H, W) -> pixel flow (B, 2, H, W)."""
    _, _, h, w = mapping.shape
    mx = (mapping[:, 0] + 1) * (w - 1) / 2.0
    my = (mapping[:, 1] + 1) * (h - 1) / 2.0
    xx = torch.arange(w, dtype=mapping.dtype, device=mapping.device)[None, None, :]
    yy = torch.arange(h, dtype=mapping.dtype, device=mapping.device)[None, :, None]
    return torch.stack([mx - xx, my - yy], dim=1)
