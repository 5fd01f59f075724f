"""K7: the two epipolar attention rounds' embed chains and logits, fused.

Wrappers around ``csrc/attn_embed.cu``, which replaces
``coponerf_tpu/ops/pallas/experimental/attn_embed.py`` (``round1_logits``
and ``round2_logits``):

    round 1:  dot1 = sum(kv * ce) / 11.31
              kv = relu(ka + kbs + fk_bias) @ wk2 + bk2      (key_map_2)
              ce = relu(lc @ wq + bq) @ wq2 + bq2            (query_embed chain)
    round 2:  dot2 = sum(qre * ce) / 11.31
              qre = relu(ze @ wra + lc @ wrb + br) @ wr2 + br2   (query_repeat_embed chain)

Every product takes bf16 operands with f32 sums; the logits are f32.
``lc`` is the 16-wide local coordinate vector of each token; round 2's
tokens are sample-major (token ``s*N + n`` of view row ``b*V + v`` reads
ray ``(b, n)``'s ``ze``), as on the fast render path.  Forward only.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch.ops import _build

INV_SCALE = 1.0 / 11.31
H = 128
L = 16


def _bf(x: torch.Tensor) -> torch.Tensor:
    """The bf16 value of ``x`` as f32 (products of two such are exact in f32)."""
    return x.to(torch.bfloat16).float()


def _embed(lc: torch.Tensor, wq, bq, wq2, bq2) -> torch.Tensor:
    h = torch.relu(_bf(lc) @ _bf(wq) + bq.float())
    return _bf(h) @ _bf(wq2) + bq2.float()


def round1_logits_plain(ka, kbs, lc, fk_bias, wk2, bk2, wq, bq, wq2, bq2) -> torch.Tensor:
    """Plain PyTorch version of ``round1_logits``."""
    kpre = ka.float() + kbs.float() + fk_bias.float()
    kv = _bf(torch.relu(kpre)) @ _bf(wk2) + bk2.float()
    ce = _embed(lc, wq, bq, wq2, bq2)
    return torch.sum(kv * ce, dim=-1) * INV_SCALE


def round2_logits_plain(ze, lc, wq, bq, wq2, bq2, wra, wrb, br, wr2, br2, S: int, V: int) -> torch.Tensor:
    """Plain PyTorch version of ``round2_logits``."""
    B, N, _ = ze.shape
    R, T, Lc = lc.shape
    zw = (_bf(ze) @ _bf(wra)).repeat_interleave(V, dim=0)          # (R, N, H), once per ray
    lc4 = lc.reshape(R, S, N, Lc)
    h = torch.relu(zw[:, None] + _bf(lc4) @ _bf(wrb) + br.float())
    qre = _bf(h) @ _bf(wr2) + br2.float()
    ce = _embed(lc4, wq, bq, wq2, bq2)
    return (torch.sum(qre * ce, dim=-1) * INV_SCALE).reshape(R, T)


def _wt(w: torch.Tensor) -> torch.Tensor:
    """(in, out) weight -> the kernel's transposed (out, in) bf16 layout."""
    return w.t().to(torch.bfloat16).contiguous()


def _f32(b: torch.Tensor) -> torch.Tensor:
    return b.float().contiguous()


def _check_weights(pairs) -> None:
    for name, w, shape in pairs:
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(w.shape)}, expected {shape}")


def _device(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return device


def round1_logits(ka, kbs, lc, fk_bias, wk2, bk2, wq, bq, wq2, bq2) -> torch.Tensor:
    """ka, kbs: (R, T, 128) folded key products (kbs in the key's own cross
    order); lc: (R, T, 16).  Returns the round-1 logits (R, T) f32."""
    R, T, _ = ka.shape
    if ka.shape != (R, T, H) or kbs.shape != ka.shape or lc.shape != (R, T, L):
        raise ValueError(f"bad shapes: ka {tuple(ka.shape)}, kbs {tuple(kbs.shape)}, lc {tuple(lc.shape)}")
    _check_weights([("fk_bias", fk_bias, (H,)), ("wk2", wk2, (H, H)), ("bk2", bk2, (H,)),
                    ("wq", wq, (L, H)), ("bq", bq, (H,)), ("wq2", wq2, (H, H)), ("bq2", bq2, (H,))])
    args = (ka, kbs, lc, fk_bias, wk2, bk2, wq, bq, wq2, bq2)
    device = _device(args)
    if device.type == "cpu":
        return round1_logits_plain(*args)
    if ka.dtype != torch.bfloat16 or kbs.dtype != torch.bfloat16:
        raise TypeError(f"ka and kbs must be bf16, got {ka.dtype} and {kbs.dtype}")
    if not (ka.is_contiguous() and kbs.is_contiguous()) or ka.data_ptr() % 16 or kbs.data_ptr() % 16:
        raise ValueError("ka and kbs must be contiguous and 16-byte aligned")
    # the converted operands stay referenced until the launch is enqueued
    ops = (ka, kbs, lc.to(torch.bfloat16).contiguous(), _f32(fk_bias), _wt(wk2), _f32(bk2), _wt(wq), _f32(bq),
           _wt(wq2), _f32(bq2))
    out = torch.empty((R, T), dtype=torch.float32, device=device)
    code = _build.lib().k7_round1_logits(*(t.data_ptr() for t in ops), out.data_ptr(), R * T,
                                         _build.stream_of(ka))
    _build.check(code, "k7_round1_logits")
    round1_logits.launches += 1
    return out


def round2_logits(ze, lc, wq, bq, wq2, bq2, wra, wrb, br, wr2, br2, S: int, V: int) -> torch.Tensor:
    """ze: (B, N, 128) per-ray round-1 latent embedding; lc: (B*V, S*N, 16)
    sample-major.  Returns the round-2 logits (B*V, S*N) f32."""
    B, N, _ = ze.shape
    if ze.shape != (B, N, H) or lc.shape != (B * V, S * N, L):
        raise ValueError(f"bad shapes: ze {tuple(ze.shape)}, lc {tuple(lc.shape)}, S={S}, V={V}")
    _check_weights([("wq", wq, (L, H)), ("bq", bq, (H,)), ("wq2", wq2, (H, H)), ("bq2", bq2, (H,)),
                    ("wra", wra, (H, H)), ("wrb", wrb, (L, H)), ("br", br, (H,)), ("wr2", wr2, (H, H)),
                    ("br2", br2, (H,))])
    args = (ze, lc, wq, bq, wq2, bq2, wra, wrb, br, wr2, br2)
    device = _device(args)
    if device.type == "cpu":
        return round2_logits_plain(*args, S, V)
    # the kernel rounds the (in, out) f32 weights to bf16 as it stages them
    ops = (ze.float().contiguous(), lc.to(torch.bfloat16).contiguous(),
           *(_f32(t) for t in (wq, bq, wq2, bq2, wra, wrb, br, wr2, br2)))
    out = torch.empty((B * V, S * N), dtype=torch.float32, device=device)
    code = _build.lib().k7_round2_logits(*(t.data_ptr() for t in ops), out.data_ptr(), B, V, S, N,
                                         _build.stream_of(ze))
    _build.check(code, "k7_round2_logits")
    round2_logits.launches += 1
    return out


round1_logits.launches = 0
round2_logits.launches = 0
