"""K6: the post-sampling render core, fused per ray.

Wrapper around ``csrc/render_core.cu``, which replaces
``coponerf_tpu/ops/pallas/experimental/render_core.py:render_core``.  From
the two sample sets of the fast render (p: the latents sampled in each
view's own image, s: those sampled in the other view's, whose view rows
come FLIPPED: row ``b*V + v`` of the s set pairs with view ``V-1-v``), it
computes what the render does between sampling and the light-field decoder:

    pre_x = relu([levels_x || tanh(pt_x / 5)] @ W1 + b1)            (832, bf16)
    kpre  = pre_p @ fka + flip(pre_s) @ fkb + fk_bias
    w1    = softmax over the ray's V*S tokens of round1(kpre, lc)    -> at_wt
    z1    = sum(w1 pre_p) @ flva + sum(w1 flip(pre_s)) @ flvb + flv_bias
    ze    = z1 @ wenc + benc
    w2    = softmax over the V*S tokens of round2(ze, lc)
    z_sum = sum(w2 pre_p) @ flva + sum(w2 flip(pre_s)) @ flvb + flv_bias + V * z1

(round1/round2 as in ``ops/attn_embed.py``), with bf16 operands and f32
sums, the weighted sums rounded to bf16 before the value products, as the
TPU kernel.  Tokens are sample-major (token ``s*N + n`` of row ``b*V + v``).
Returns ``z_sum`` (B, N, 416) and ``at_wt`` (B, N, V*S) f32, ``at_wt``'s
last axis ordered ``v*S + s``.  Forward only.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  The kernel takes each block's rays in
groups of ``group_rays(V*S)`` and runs the value products (``z1``, ``ze``,
``ze @ wra``, ``z_sum``) once a group on the tensor cores; it holds a
group's W1 outputs in a device scratch slot a ray (``scratch_bytes``:
3.67 GB at S 64 on 132 SMs), which the wrapper allocates for each call.
Each launch adds its rays and its groups' row slots to ``trace.counters``
(``k6_value_rows``, ``k6_value_slots``; ``value_counts``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from coponerf_tpu_torch import trace
from coponerf_tpu_torch.ops import _build
from coponerf_tpu_torch.ops.attn_embed import INV_SCALE, _bf, _check_weights, _device, _embed, _f32

SPLITS = (256, 256, 256, 64)   # three UFC levels and the conv_map channels
H = 128
L = 16
NZ = 416


RAY_BLOCK = 4096
GROUP_ROWS = 64   # rows of the kernel's value product: one wgmma tile
K = sum(SPLITS)
# the weights after the token tensors, in argument order, with their shapes
WEIGHT_SHAPES = (("w1", (K + 3, K)), ("w1b", (K,)), ("fka", (K, H)), ("fkb", (K, H)), ("fk_bias", (H,)),
                 ("wk2", (H, H)), ("bk2", (H,)), ("wq", (L, H)), ("bq", (H,)), ("wq2", (H, H)), ("bq2", (H,)),
                 ("wra", (H, H)), ("wrb", (L, H)), ("brr", (H,)), ("wr2", (H, H)), ("br2", (H,)),
                 ("wenc", (NZ, H)), ("benc", (H,)), ("flva", (K, NZ)), ("flvb", (K, NZ)), ("flv_bias", (NZ,)))


def _wt(w: torch.Tensor) -> torch.Tensor:
    """(in, out) weight -> the kernel's transposed (out, in) bf16 layout."""
    return w.t().to(torch.bfloat16).contiguous()


def render_core_plain(samples_p, pt_p, samples_s, pt_s, lc, *weights, S: int, V: int, n_rays: int):
    """Plain PyTorch version of ``render_core``.  It takes the rays in blocks
    of ``RAY_BLOCK``, which bounds its f32 temporaries (~5 GB a block at
    S 64, V 2) whatever the chunk."""
    R = samples_p[0].shape[0]

    def rays(x, n0, n1):
        return x.reshape(R, S, n_rays, x.shape[-1])[:, :, n0:n1].reshape(R, S * (n1 - n0), x.shape[-1])

    outs = []
    for n0 in range(0, n_rays, RAY_BLOCK):
        n1 = min(n0 + RAY_BLOCK, n_rays)
        outs.append(_plain_block([rays(x, n0, n1) for x in samples_p], rays(pt_p, n0, n1),
                                 [rays(x, n0, n1) for x in samples_s], rays(pt_s, n0, n1), rays(lc, n0, n1),
                                 *weights, S=S, V=V, N=n1 - n0))
    return tuple(torch.cat(o, dim=1) for o in zip(*outs))


def _plain_block(samples_p, pt_p, samples_s, pt_s, lc, w1, w1b, fka, fkb, fk_bias, wk2, bk2, wq, bq, wq2, bq2,
                 wra, wrb, brr, wr2, br2, wenc, benc, flva, flvb, flv_bias, S: int, V: int, N: int):
    R = samples_p[0].shape[0]
    B = R // V
    K = sum(SPLITS)

    def bvsn(x):
        return x.reshape(B, V, S, N, x.shape[-1])

    def pre(samples, pt):
        acc = torch.cat([_bf(s) for s in samples], dim=-1) @ _bf(w1[:K])
        t = torch.tanh(_bf(pt) / 5.0)
        wt = _bf(w1[K:K + 3])
        for j in range(3):
            acc = acc + t[..., j:j + 1] * wt[j]
        return _bf(torch.relu(acc + w1b.float()))

    pp = bvsn(pre(samples_p, pt_p))
    ps = bvsn(pre(samples_s, pt_s)).flip(1)            # natural view order
    kpre = pp @ _bf(fka) + ps @ _bf(fkb) + fk_bias.float()
    kv = _bf(torch.relu(kpre)) @ _bf(wk2) + bk2.float()
    lc5 = bvsn(lc)
    ce = _embed(lc5, wq, bq, wq2, bq2)

    def softmax_vs(d):                                  # (B, V, S, N) -> (B, N, V*S)
        return torch.softmax(d.permute(0, 3, 1, 2).reshape(B, N, V * S), dim=-1)

    def z_of(at):
        w = at.reshape(B, N, V, S).permute(0, 2, 3, 1)[..., None]
        ua, ub = (pp * w).sum(dim=(1, 2)), (ps * w).sum(dim=(1, 2))
        return _bf(ua) @ _bf(flva) + _bf(ub) @ _bf(flvb) + flv_bias.float()

    at1 = softmax_vs(torch.sum(kv * ce, dim=-1) * INV_SCALE)
    z1 = z_of(at1)
    ze = _bf(z1) @ _bf(wenc) + benc.float()
    zw = (_bf(ze) @ _bf(wra))[:, None, None]            # once per ray
    qre = _bf(torch.relu(zw + _bf(lc5) @ _bf(wrb) + brr.float())) @ _bf(wr2) + br2.float()
    at2 = softmax_vs(torch.sum(qre * ce, dim=-1) * INV_SCALE)
    return z_of(at2) + V * z1, at1


def render_core(samples_p, pt_p, samples_s, pt_s, lc, w1, w1b, fka, fkb, fk_bias, wk2, bk2, wq, bq, wq2, bq2,
                wra, wrb, brr, wr2, br2, wenc, benc, flva, flvb, flv_bias, S: int, V: int, n_rays: int):
    """samples_p/s: lists of 4 level tensors (R, S*N, C_l) bf16, sample-major,
    the s rows view-flipped; pt_p/s: (R, S*N, 3); lc: (R, S*N, 16); R = B*V.
    Weights as the JAX package reads them ((in, out) kernels).  Returns
    (z_sum (B, N, 416) f32, at_wt (B, N, V*S) f32)."""
    R = samples_p[0].shape[0]
    B, N, T = R // V, n_rays, S * n_rays
    if R != B * V or len(samples_p) != 4 or len(samples_s) != 4:
        raise ValueError(f"bad sample sets: {len(samples_p)} / {len(samples_s)} levels, {R} rows, V={V}")
    for x, c in [*zip(samples_p, SPLITS), *zip(samples_s, SPLITS), (pt_p, 3), (pt_s, 3), (lc, L)]:
        if tuple(x.shape) != (R, T, c):
            raise ValueError(f"token tensor of shape {tuple(x.shape)}, expected {(R, T, c)}")
    ws = [w1, w1b, fka, fkb, fk_bias, wk2, bk2, wq, bq, wq2, bq2, wra, wrb, brr, wr2, br2, wenc, benc, flva, flvb,
          flv_bias]
    _check_weights([(name, w, shape) for (name, shape), w in zip(WEIGHT_SHAPES, ws)])
    device = _device((*samples_p, *samples_s, pt_p, pt_s, lc, *ws))
    if device.type == "cpu":
        return render_core_plain(samples_p, pt_p, samples_s, pt_s, lc, *ws, S=S, V=V, n_rays=n_rays)
    for x in (*samples_p, *samples_s):
        if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError("samples must be contiguous, 16-byte aligned bf16")
    if V * S > max_tokens():
        raise ValueError(f"the kernel takes at most {max_tokens()} tokens a ray (V*S), got {V * S}")

    def bf(x):
        return x.to(torch.bfloat16).contiguous()

    # the converted operands stay referenced until the launch is enqueued;
    # W1's matmul rows, fka and fkb go K-major (transposed) for wgmma
    ops = (*samples_p, bf(pt_p), *samples_s, bf(pt_s), bf(lc),
           _wt(w1[:K]), _f32(_bf(w1[K:K + 3])), _f32(w1b), _wt(fka), _wt(fkb), _f32(fk_bias), _wt(wk2), _f32(bk2),
           _wt(wq), _f32(bq), _wt(wq2), _f32(bq2), _wt(wra), _wt(wrb), _f32(brr), _wt(wr2), _f32(br2), _wt(wenc),
           _f32(benc), _wt(torch.cat([flva, flvb])), _f32(flv_bias))
    z_sum = torch.empty((B, N, NZ), dtype=torch.float32, device=device)
    at_wt = torch.empty((B, N, V * S), dtype=torch.float32, device=device)
    G = group_rays(V * S)
    with torch.cuda.device(device):
        nbytes = scratch_bytes(B, V, S, N)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=device)
        code = _build.lib().k6_render_core(*(t.data_ptr() for t in ops), z_sum.data_ptr(), at_wt.data_ptr(),
                                           scratch.data_ptr(), nbytes, B, V, S, N, G, _build.stream_of(z_sum))
    _build.check(code, "k6_render_core")
    render_core.launches += 1
    grid = min(torch.cuda.get_device_properties(device).multi_processor_count, B * N)
    rows, slots = value_counts(B, N, grid, G)
    trace.count("k6_value_rows", rows)
    trace.count("k6_value_slots", slots)
    return z_sum, at_wt


def max_tokens() -> int:
    """The most tokens a ray (V*S) the kernel takes: it keeps a ray's logits
    in shared memory."""
    return _build.lib().k6_max_tokens()


def group_rays(vs: int) -> int:
    """G, the rays a block takes through one value product: 64 (the
    product's row tile) at V*S <= 128, ``64 // ceil(V*S / 128)`` above, so
    that a block's G slots stay ~27 MB."""
    return GROUP_ROWS // -(-vs // 128)


def value_counts(B: int, N: int, grid: int, G: int) -> Tuple[int, int]:
    """(rays, row slots) of one launch's value products: block ``i`` of
    ``grid`` takes rays ``[i*R // grid, (i+1)*R // grid)`` of the R = B*N,
    in groups of G, and each group has G row slots, its last one padded."""
    rays = B * N
    slots = sum(-(-((i + 1) * rays // grid - i * rays // grid) // G) for i in range(grid)) * G
    return rays, slots


def scratch_bytes(B: int, V: int, S: int, N: int) -> int:
    """Device scratch of one ``render_core`` launch on the current card, per
    block (one per SM, at most one per ray): the group's table of weighted
    sums, a slot a ray of the group holding its rounded pre-activations,
    one ray's key partials and the group's value-path rows."""
    n = _build.lib().k6_scratch_bytes(B, V, S, N, group_rays(V * S))
    if n < 0:
        raise RuntimeError("k6_scratch_bytes: no CUDA device")
    return n


render_core.launches = 0
