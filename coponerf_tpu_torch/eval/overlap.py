"""Overlap-table generation: the port's counterpart of
``coponerf_tpu/eval/overlap.py``.

The reference ships precomputed per-scene overlap scalars
(assets/overlap/{realestate,acid}.npy) but not the code that produced them.
For datasets without a shipped table this computes the JAX package's proxy:
the fraction of context-view-1 pixels whose forward flow lands inside view
2 and passes the forward-backward consistency check, i.e. the co-visible
image fraction under the model's own correspondence field.  Use the
official tables where they exist.
"""

from __future__ import annotations

import numpy as np
import torch

from coponerf_tpu_torch.flow import cyclic_consistency_masks
from coponerf_tpu_torch.models.coponerf import batch_to_torch


@torch.no_grad()
def compute_overlap_table(model, dataset) -> np.ndarray:
    """(len(dataset), 1) f32 overlaps, one encode per item on the model's
    device."""
    device = next(model.parameters()).device
    out = np.zeros((len(dataset), 1), np.float32)
    for i in range(len(dataset)):
        batch = batch_to_torch({k: {kk: np.asarray(vv)[None] for kk, vv in v.items()}
                                for k, v in dataset[i][0].items()}, device)
        state = model.encode(batch, train=False)
        _, _, mask_f, _ = cyclic_consistency_masks(state.flows[0], state.flows[1], out_size=256)
        out[i, 0] = float(mask_f.float().mean(dim=(1, 2))[0])
    return out
