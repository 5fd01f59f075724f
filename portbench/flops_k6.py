"""K6's operations and bytes: what one ``render_core`` call computes, from
the layers' shapes, whatever implements it.

``render_core`` (``coponerf_tpu_torch/ops/render_core.py``) takes both
sample sets of one single-stage chunk and returns ``z_sum`` and the
attention weights: W1 with the folded key head on each set, the key and
query embeds, both attention rounds' weighted sums, the folded value maps,
``encode_latent`` and round 2's embeds.  The count is of products (two
operations a multiply-add), as ``flops.py`` counts the render: the logits'
dot products, the softmaxes and the elementwise work are not counted.  The
weighted sums are counted as products (two operations a weight and
channel), as ``flops.py`` counts K3.

Bytes: each input read once and each output written once, as K6 takes
them: both sample sets, the positions and the local coordinates in bf16,
the weights in bf16, ``z_sum`` and the weights of round 1 in f32.
"""

from __future__ import annotations

from typing import Dict, List

from portbench.flops import V, _widths, mm, stages

LC = 16           # local coordinates a token
POINT = 3         # the tanh'd point's rows of W1


def per_token(model: Dict) -> Dict[str, int]:
    """Operations a sample token (one view row, one sample of one ray)."""
    lat, _, hid, _ = _widths(model)
    return {
        "W1 on the latents, both sets": 2 * mm(lat, lat),
        "W1 on the points, both sets": 2 * mm(POINT, lat),
        "folded key head, both sets": 2 * mm(lat, hid),
        "key_map_2": mm(hid, hid),
        "query embed chain": mm(LC, hid) + mm(hid, hid),
        "repeat embed chain": mm(LC, hid) + mm(hid, hid),
        "weighted sums, both rounds and sets": 2 * 2 * 2 * lat,
    }


def per_ray(model: Dict) -> Dict[str, int]:
    """Operations a ray (both views together)."""
    lat, half, hid, _ = _widths(model)
    return {
        "value maps, both rounds and sets": 2 * 2 * mm(lat, half),
        "encode_latent": mm(half, hid),
        "round 2's per-ray embed": mm(hid, hid),
    }


def k6_flops(model: Dict, n_rays: int, S: int) -> int:
    """Operations of one ``render_core`` call on ``n_rays`` rays (B 1) of ``S`` samples."""
    return V * S * n_rays * sum(per_token(model).values()) + n_rays * sum(per_ray(model).values())


def weight_elems(model: Dict) -> int:
    """Elements of K6's weights and biases."""
    lat, half, hid, _ = _widths(model)
    return ((lat + POINT) * lat + lat + 2 * lat * hid + hid          # W1, its bias, the key folds and bias
            + 3 * (hid * hid + hid) + LC * hid + hid                 # key_map_2, query_embed(_2), repeat_embed_2
            + hid * hid + LC * hid + hid                             # query_repeat_embed
            + half * hid + hid + 2 * lat * half + half)              # encode_latent, the value folds and bias


def k6_bytes(model: Dict, n_rays: int, S: int) -> int:
    """Bytes of one ``render_core`` call on ``n_rays`` rays (B 1) of ``S`` samples."""
    lat, half, _, _ = _widths(model)
    tok = V * S * n_rays
    return (2 * (2 * tok * (lat + POINT) + tok * LC + weight_elems(model))
            + 4 * n_rays * (half + V * S))


def k6_calls(model: Dict, n_rays: int, chunk: int) -> List[int]:
    """The rays of each ``render_core`` call of one image in ``chunk``-ray
    renders; none where the render has two stages (K6 serves one)."""
    if len(stages(model)) != 1:
        return []
    return [min(chunk, n_rays - a) for a in range(0, n_rays, chunk)]


def k6_bound_s(model: Dict, n_rays: int, chunk: int, peaks: Dict[str, float]) -> float:
    """The least time the card could take for one image's K6 calls: for
    each, the larger of its operations over the bf16 peak and its bytes
    over the HBM rate."""
    S = model["npoints"]
    return sum(max(k6_flops(model, n, S) / peaks["bf16_flops_per_s"], k6_bytes(model, n, S) / peaks["hbm_bytes_per_s"])
               for n in k6_calls(model, n_rays, chunk))
