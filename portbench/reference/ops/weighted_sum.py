"""K3's plain expression: the attention-weighted sum over the samples of
sample-major tokens, in f32.

    out[b, n] = sum_v sum_s w[b*V+v, n, s] * pre[b*V+v, s*N + n]
"""

from __future__ import annotations

import torch


def weighted_sum_smaj(pre: torch.Tensor, w: torch.Tensor, S: int, vsum: int | None = None) -> torch.Tensor:
    """pre: (R, S*N, C) sample-major tokens; w: (R, N, S) weights.  Returns
    (R, N, C), or with ``vsum=V`` the view-row sum (R/V, N, C)."""
    R, T, C = pre.shape
    N = T // S
    per_row = torch.einsum("rsnc,rns->rnc", pre.reshape(R, S, N, C).float(), w.float())
    if vsum is None:
        return per_row
    return per_row.reshape(R // vsum, vsum, N, C).sum(dim=1)
