"""K2: fused split-input W1 + bias + relu with the folded key head.

Wrapper around ``csrc/split_matmul.cu``, which replaces
``coponerf_tpu/ops/pallas/split_matmul.py:split_dense_relu``:

    out = relu(concat(p0, p1, p2, pc, pt) @ kernel + bias)   (in the part dtype)
    k   = out @ fk                                           (from the rounded out)

without materializing the concat.  Parts are (R, T, K_i) in one dtype (bf16
on the fast path, f32 on the exact path); p0, p1 and p2 share a width, pt
is 3 wide.  ``kernel`` (sum K_i, N) and ``fk`` (N, NK) are cast to the part
dtype; ``bias`` stays f32.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.

Under autograd the forward is the same K2 launch and the backward follows
``split_matmul.py:131-158``: f32 products, the key cotangent routed into
``out``'s through ``fk``, and the relu mask from the saved ``out``.  These
products stay ``torch.matmul``/``einsum``, as the JAX package computes them
outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from coponerf_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_dense_relu_plain(parts, kernel, bias, fk):
    """Plain PyTorch version: the part products in the part dtype's values
    with f32 sums, the tanh part as f32 products, f32 bias, relu, rounding to
    the part dtype, then the key product from the rounded output."""
    kd = parts[0].dtype
    acc = None
    off = 0
    for p in parts[:4]:
        w = kernel[off: off + p.shape[-1]].to(kd).float()
        prod = p.float() @ w
        acc = prod if acc is None else acc + prod
        off += p.shape[-1]
    t = parts[4].float()
    wt = kernel[off: off + 3].to(kd).float()
    for j in range(3):
        acc = acc + t[..., j: j + 1] * wt[j]
    acc = acc + bias.float()
    out = torch.relu(acc).to(kd)
    k = (out.float() @ fk.to(kd).float()).to(kd)
    return out, k


def split_dense_relu(parts, kernel: torch.Tensor, bias: torch.Tensor, fk: torch.Tensor):
    """parts: (p0, p1, p2, pc, pt), each (R, T, K_i).  Returns (out (R, T, N),
    k (R, T, NK)) in the part dtype, differentiable in every argument."""
    return _SplitDenseRelu.apply(kernel, bias, fk, *parts)


class _SplitDenseRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, bias, fk, *parts):
        out, k = _split_dense_relu_fwd(parts, kernel, bias, fk)
        ctx.save_for_backward(kernel, bias, fk, out, *parts)
        return out, k

    @staticmethod
    def backward(ctx, g_out, g_k):
        kernel, bias, fk, out, *parts = ctx.saved_tensors
        out_f, g_k = out.float(), g_k.float()
        g = g_out.float() + g_k @ fk.float().t()
        dfk = torch.einsum("btn,btm->nm", out_f, g_k).to(fk.dtype)
        g = g * (out_f > 0)
        dparts, off = [], 0
        for p in parts:
            w = kernel[off: off + p.shape[-1]].float()
            dparts.append((g @ w.t()).to(p.dtype))
            off += p.shape[-1]
        x = torch.cat([p.float() for p in parts], dim=-1)
        dk = torch.einsum("btk,btn->kn", x, g).to(kernel.dtype)
        db = g.sum(dim=(0, 1)).to(bias.dtype)
        return (dk, db, dfk, *dparts)


def _split_dense_relu_fwd(parts, kernel, bias, fk):
    if len(parts) != 5 or parts[4].shape[-1] != 3:
        raise ValueError("expected five parts, the last 3 wide")
    p0, p1, p2, pc, pt = parts
    kd = p0.dtype
    lead = p0.shape[:-1]
    if any(p.dtype != kd or p.shape[:-1] != lead for p in parts):
        raise ValueError("parts must share dtype and leading shape")
    if p1.shape[-1] != p0.shape[-1] or p2.shape[-1] != p0.shape[-1]:
        raise ValueError("p0, p1 and p2 must share a width")
    K = sum(p.shape[-1] for p in parts)
    N, NK = kernel.shape[1], fk.shape[1]
    if kernel.shape[0] != K or bias.shape != (N,) or fk.shape[0] != N:
        raise ValueError(f"bad weights: kernel {tuple(kernel.shape)}, bias {tuple(bias.shape)}, fk {tuple(fk.shape)}")
    devices = {t.device for t in (*parts, kernel, bias, fk)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    device = p0.device
    if device.type == "cpu":
        return split_dense_relu_plain(parts, kernel, bias, fk)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if kd not in _DTYPES:
        raise TypeError(f"unsupported part dtype {kd}")
    K0, Kc = p0.shape[-1], pc.shape[-1]
    Kmm = K - 3
    # the bf16 kernel walks N in chunks of 208 and K in 64-wide TMA boxes;
    # the f32 kernel N in chunks of 64 and K in slices of 16
    n_step, k_step = (208, 64) if kd == torch.bfloat16 else (64, 16)
    if NK != 128 or N % n_step or K0 % k_step or Kc % k_step:
        raise ValueError(f"unsupported widths for {kd}: K0={K0} Kc={Kc} N={N} NK={NK}")
    if not all(p.is_contiguous() and p.data_ptr() % 16 == 0 for p in parts[:4]):
        raise ValueError("p0, p1, p2 and pc must be contiguous and 16-byte aligned")
    if not pt.is_contiguous():
        raise ValueError("pt must be contiguous")
    w = kernel[:Kmm].to(kd)
    f = fk.to(kd)
    if kd == torch.bfloat16:       # wgmma reads both operands K-major
        w, f = w.t(), f.t()
    w, f = w.contiguous(), f.contiguous()
    wt = kernel[Kmm:].to(kd).float().contiguous()
    b = bias.float().contiguous()
    M = p0.numel() // K0
    out = torch.empty((*lead, N), dtype=kd, device=device)
    k = torch.empty((*lead, NK), dtype=kd, device=device)
    lib = _build.lib()
    code = lib.k2_split_dense_relu(
        p0.data_ptr(), p1.data_ptr(), p2.data_ptr(), pc.data_ptr(), pt.data_ptr(),
        w.data_ptr(), wt.data_ptr(), b.data_ptr(), f.data_ptr(), out.data_ptr(), k.data_ptr(),
        M, K0, Kc, N, NK, _DTYPES[kd], _build.stream_of(p0),
    )
    _build.check(code, "k2_split_dense_relu")
    split_dense_relu.launches += 1
    if kd == torch.float32:
        split_dense_relu.f32_launches += 1
    return out, k


split_dense_relu.launches = 0          # every launch
split_dense_relu.f32_launches = 0      # of those, the exact path's f32 kernel
