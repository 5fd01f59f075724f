"""Model FLOPs and K2's operations and bytes, from the layers' shapes.

Extends the port's ``scripts/flops_ledger.py`` (a per-ray ledger of the
render at S 64 against another card's peak) in three ways:

- the render's per-ray count takes the samples of each stage as
  parameters; coarse-to-fine (cf[16,4]) is the same per-sample terms summed
  over its two stages (S1 coarse, S2 fine): every per-token term runs once
  a token of either stage, while the per-ray terms (the weighted sums' value
  maps, the second round's per-ray embeds, the light-field MLP) run once a
  ray, whatever the stages;
- the terms are those of the port's own algebra (the reference's): W1 with
  the folded key head (K2), the key and query embeds, the two attention
  rounds' weighted sums over both sample sets, the folded value maps;
- the encode (ResNet-34, the conv_map layer, the UFC's correlations,
  4-D convolutions, linear attentions and resizes, the cross block and the
  pose head) and the train step's forward with its losses are counted by
  running the plain reference on the ``meta`` device, where tensors have
  shapes and no data, under ``torch.utils.flop_counter.FlopCounterMode``.

A count is of matrix products and convolutions (FlopCounterMode's), two
FLOPs a multiply-add, whatever kernel runs them; gathers, elementwise work
and reductions are not counted.  The train step is counted as three times
its forward (forward plus backward); remat's recompute is not counted.
"""

from __future__ import annotations

import functools
import json
from typing import Dict, List, Tuple

V = 2              # context views, and val mode's query hypotheses
LC = 7             # per-sample query-embed inputs: camera ray (3) and depth encoding (4)


def mm(m: int, n: int) -> int:
    """FLOPs a token of an (m -> n) dense layer."""
    return 2 * m * n


def _widths(model: Dict) -> Tuple[int, int, int, int]:
    lat = model["latent_dim"]
    return lat, lat // 2, model["hidden_dim"], model["num_hidden_units_phi"]


def per_token(model: Dict) -> Dict[str, int]:
    """FLOPs a sample token (one view row, one sample of one ray), val mode."""
    lat, half, hid, _ = _widths(model)
    t = {
        # W1 on [3 latents | conv latent | tanh(point)] and the folded key head,
        # for the primary and the secondary sample set (K2, two calls)
        "W1 + key head (K2)": 2 * (mm(lat + 3, lat) + mm(lat, hid)),
        "key_map_2": mm(hid, hid),
        "query embed (per sample) + query_embed_2": mm(LC, hid) + mm(hid, hid),
        # round 1's weighted sums of both sample sets (K3)
        "weighted sums, round 1 (K3)": 2 * 2 * lat,
    }
    if model["repeat_attention"]:
        t["repeat embed (per sample) + repeat_embed_2"] = mm(LC, hid) + mm(hid, hid)
        t["weighted sums, round 2 (K3)"] = 2 * 2 * lat
    return t


def per_ray(model: Dict) -> Dict[str, int]:
    """FLOPs a ray (the batch row, both views together), whatever the stages."""
    lat, half, hid, phi = _widths(model)
    rounds = 2 if model["repeat_attention"] else 1
    r = {
        # per view row: the per-ray part of the query embed
        "query embed (per ray)": V * 2 * mm(3, hid),
        # the folded value maps of both sample sets, each round
        "value maps": rounds * 2 * mm(lat, half),
        # the light-field MLP on [z_sum per view | coordinates of both views]
        "phi": mm(2 * 9, phi) + 3 * (mm(V * half, phi) + 2 * mm(phi, phi)) + mm(phi, 3),
    }
    if model["repeat_attention"]:
        r["encode_latent + repeat embed (per ray)"] = mm(half, hid) + mm(hid, hid) + V * 2 * mm(3, hid)
    return r


def per_call(model: Dict) -> int:
    """FLOPs a render call spends folding W2 into the key and value heads."""
    lat, half, hid, _ = _widths(model)
    # W2 (lat -> half) into both halves of key_map and of latent_value, and the biases
    return 2 * (half * mm(lat, hid) + half * mm(lat, half)) + mm(half, hid) + mm(half, half)


def stages(model: Dict) -> List[int]:
    """Samples of each stage of the inference render."""
    if model["fast_sampling"] and model["coarse_samples"] > 0 and model["fine_samples"] > 0:
        return [model["coarse_samples"], model["fine_samples"]]
    return [model["npoints"]]


def render_flops(model: Dict, n_rays: int, chunk: int) -> int:
    """FLOPs of one val-mode image of ``n_rays`` rays rendered in ``chunk``-ray calls."""
    s_total = sum(stages(model))
    tokens = V * s_total * n_rays
    calls = -(-n_rays // chunk)
    return tokens * sum(per_token(model).values()) + n_rays * sum(per_ray(model).values()) + calls * per_call(model)


def k2_calls(model: Dict, n_rays: int, chunk: int) -> List[Tuple[int, int, int, int]]:
    """K2's calls in one val-mode image: (rows, K, N, NK) each."""
    lat, _, hid, _ = _widths(model)
    out = []
    for a in range(0, n_rays, chunk):
        n = min(chunk, n_rays - a)
        for s in stages(model):
            out += [(V * s * n, lat + 3, lat, hid)] * 2      # primary and secondary sample sets
    return out


def k2_bound_s(calls, peaks: Dict[str, float], elem_bytes: int = 2) -> float:
    """The least time the card could take for ``calls``: for each, the larger
    of its operations over the bf16 peak and its bytes (the parts read once,
    the weights read once, both outputs written once) over the HBM rate."""
    t = 0.0
    for M, K, N, NK in calls:
        flops = 2 * M * K * N + 2 * M * N * NK
        nbytes = elem_bytes * (M * K + K * N + N * NK + M * N + M * NK) + 4 * N
        t += max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
    return t


def _reference(model_fields: Dict, image_size: int):
    import torch

    from portbench.reference.config import ModelConfig
    from portbench.reference.models import CoPoNeRF

    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in model_fields.items()}
    fields["compute_dtype"] = "float32"
    return CoPoNeRF(ModelConfig(**fields), image_size=image_size).to(torch.device("meta"))


def _meta_batch(image_size: int, batch: int, n_rays: int):
    import torch

    meta = dict(device="meta", dtype=torch.float32)
    return {
        "context": {"rgb": torch.empty(batch, V, image_size, image_size, 3, **meta),
                    "cam2world": torch.empty(batch, V, 4, 4, **meta),
                    "intrinsics": torch.empty(batch, V, 4, 4, **meta)},
        "query": {"rgb": torch.empty(batch, 1, n_rays, 3, **meta), "uv": torch.empty(batch, 1, n_rays, 2, **meta),
                  "cam2world": torch.empty(batch, 1, 4, 4, **meta), "intrinsics": torch.empty(batch, 1, 4, 4, **meta)},
    }


@functools.lru_cache(maxsize=None)
def _encode_flops(model_json: str, image_size: int, batch: int, train: bool) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    ref = _reference(json.loads(model_json), image_size)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.encode(_meta_batch(image_size, batch, 1), train=train)
    return fc.get_total_flops()


def encode_flops(model: Dict, image_size: int, batch: int = 1, train: bool = False) -> int:
    """FLOPs of one ``encode`` of ``batch`` pairs."""
    return _encode_flops(json.dumps(model, sort_keys=True), image_size, batch, train)


@functools.lru_cache(maxsize=None)
def _train_flops(model_json: str, loss_json: str, image_size: int, batch: int, rays: int) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference.config import LossConfig
    from portbench.reference.losses import lf_loss

    ref = _reference(json.loads(model_json), image_size)
    b = _meta_batch(image_size, batch, rays)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        out = ref(b, val=False, train=True)
        lf_loss(LossConfig(**json.loads(loss_json)), b, out, b["query"])
    return 3 * fc.get_total_flops()


def train_flops(model: Dict, loss: Dict, image_size: int, batch: int, rays: int) -> int:
    """FLOPs of one train step of ``batch`` pairs of ``rays`` rays: three
    times the forward with its losses."""
    return _train_flops(json.dumps(model, sort_keys=True), json.dumps(loss, sort_keys=True), image_size, batch, rays)
