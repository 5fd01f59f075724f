"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
result line:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off;
  2. build: compiles coponerf_tpu_torch/csrc/*.cu (one nvcc per source, all
     started together, sm_90a) into the git-ignored build directory and
     prints the build seconds;
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes: K1 on all four latent levels in both padding modes
     (inference) and its corner-id entry, K2 at 524288 tokens in bf16 plus
     one f32 case, K3 at N=32768, S=16, V=2, and K4 on the three small
     levels in both padding modes (training: 12 rows x 12288 points, C=256),
     and K5's forward statistics and backward on cosine-like correlation
     volumes at the train shape (B 6, Q = S = 4096) and the inference shape
     (B 1).  Each prints its error against a stated bound and CUDA-event
     times of the kernel and, where one PyTorch call computes the same
     function, of that call (median of 5 windows of 10 back-to-back calls,
     per call) and of its plain version (median of 3 single calls), beside
     the least time the card could take (bytes over 3.35 TB/s or operations
     over the peak);
  4. the inference path: full-width model (ResNet-34, UFC (2, 2, 1), latent
     832) with seeded random weights, the same 256^2 request twice (the
     first warms up, the second is timed): encode() and render(val=True)
     over two 32768-ray chunks in the fast config (bf16, coarse-to-fine
     cf[16, 4]), under torch.no_grad(); checks shapes, finiteness, the
     joint softmax and every kernel's launch count; then the same request's
     encode with fused_argmax (K5), warm-up then timed, its launch counts
     (K5 forward 1, backward 0) and its flows against the unfused encode's;
  5. one 1024-ray chunk rendered on the card and on the CPU (where the plain
     versions run) from the same SceneState and weights, rgb compared at
     the fast-config bound;
  6. the training path: the same widths, fast config (fast_sampling, bf16,
     remat_ufc, convmap_direct_grad, train_onehot_small), pose + cycle +
     SSIM losses, batches of 6 synthetic 256^2 pairs with 192 rays, unfused
     and with fused_argmax, two train states from the same seeded weights
     taking their steps in turns (two warm-up and three timed Adam steps
     each); checks finite losses, a positive grad norm, moved parameters,
     the launch counts of every step (K1 6, K2 2, K4 6, and with
     fused_argmax K5 forward 1 and backward 1) and the fused first step's
     losses and grad norm against the unfused first step's (same weights,
     same batch); prints step ms, pairs/s and each configuration's peak
     memory, and profiles one step of each;
  7. one train step on the card and on the CPU from the same weights and
     batch (64^2, batch 1), unfused and fused, losses and grad norm
     compared at the fast config's bound.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  The script imports only coponerf_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
F32_FLOPS = 67e12              # f32 outside the tensor cores

REPLACES = {
    "bilinear_sample": "coponerf_tpu/ops/pallas/bilinear_sample.py:177",
    "corner_sample": "coponerf_tpu/ops/pallas/bilinear_sample.py:346",
    "split_dense_relu": "coponerf_tpu/ops/pallas/split_matmul.py:46",
    "weighted_sum_smaj": "coponerf_tpu/ops/pallas/weighted_sum.py:68",
    "onehot_transpose_matmul": "coponerf_tpu/ops/pallas/bilinear_sample.py:458",
    "soft_argmax_stats": "coponerf_tpu/ops/pallas/soft_argmax.py:132",
    "soft_argmax_bwd": "coponerf_tpu/ops/pallas/soft_argmax.py:178",
}
SOURCES = {
    "bilinear_sample": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
    "corner_sample": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
    "split_dense_relu": "coponerf_tpu_torch/csrc/split_matmul.cu",
    "weighted_sum_smaj": "coponerf_tpu_torch/csrc/weighted_sum.cu",
    "onehot_transpose_matmul": "coponerf_tpu_torch/csrc/transpose_sample.cu",
    "soft_argmax_stats": "coponerf_tpu_torch/csrc/soft_argmax.cu",
    "soft_argmax_bwd": "coponerf_tpu_torch/csrc/soft_argmax.cu",
}
KERNELS = tuple(REPLACES)
CHUNK = 32768
IMAGE = 256
TRAIN_BATCH = 6
TRAIN_RAYS = 192


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median milliseconds per call of ``fn`` on the current stream: CUDA
    events around ``inner`` back-to-back calls, so that the host's time to
    enqueue a call hides behind the device's work on the one before, in
    ``reps`` such windows."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    """(least ms, what bounds it): bytes over HBM rate vs operations over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    return d.max().item(), (d.mean() / (ref.abs().mean() + 1e-6)).item(), (d.max() / (ref.abs().max() + 1e-6)).item()


def epipolar_grid(n_rays: int, S: int, shift: float, gen: torch.Generator, dev) -> torch.Tensor:
    """Sample-major (2, S*n_rays, 2) [-1, 1] points laid out as the render
    lays them: token s*N + n on ray n's segment, rays in raster order, so
    neighbouring tokens sample neighbouring pixels.  ``shift`` moves part of
    every segment off the image (zeros padding reads outside it)."""
    n = torch.arange(n_rays, device=dev, dtype=torch.float32)
    u = (n % IMAGE) / (IMAGE - 1) * 2 - 1
    v = (n // IMAGE) / (IMAGE - 1) * 2 - 1
    start = torch.stack([(u + 1) / 2 - 0.95 - shift, v * 0.9], -1)
    direction = torch.randn(2, 1, 2, device=dev, generator=gen) * 0.2 + torch.tensor([0.9, 0.1], device=dev)
    t = torch.linspace(0, 1, S, device=dev)
    pts = start[None, None] + t[None, :, None, None] * direction[:, :, None, :]
    return pts.reshape(2, S * n_rays, 2).contiguous()


def train_grid(rows: int, n_rays: int, S: int, shift: float, gen: torch.Generator, dev) -> torch.Tensor:
    """Ray-major (rows, n_rays*S, 2) points as training lays them: token
    n*S + s, random rays, each a segment across the image."""
    start = torch.rand(rows, n_rays, 1, 2, device=dev, generator=gen) * 0.4 - 1.0 - shift
    end = torch.rand(rows, n_rays, 1, 2, device=dev, generator=gen) * 0.4 + 0.6
    t = torch.linspace(0, 1, S, device=dev)[None, None, :, None]
    return (start + (end - start) * t).reshape(rows, n_rays * S, 2).contiguous()


def phase_kernels(dev, summary):
    import torch.nn.functional as F

    from coponerf_tpu_torch.ops import bilinear_sample as bs
    from coponerf_tpu_torch.ops.split_matmul import split_dense_relu, split_dense_relu_plain
    from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_plain, weighted_sum_smaj

    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True

    # K1: every level of inference stage A (S=16 samples x 32768 rays per view row)
    acc = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    for hw, C in ((16, 256), (32, 256), (64, 256), (IMAGE, 64)):
        table = torch.randn(2, hw, hw, C, device=dev, generator=gen).bfloat16()
        for mode, shift in (("border", 0.0), ("zeros", 0.4)):
            grid = epipolar_grid(CHUNK, 16, shift, gen, dev)
            tab = table
            if mode == "zeros":  # secondary samples read the view-row-swapped table
                tab = table.flip(0).contiguous()
            got = bs.bilinear_sample(tab, grid, mode)
            ref = bs.bilinear_sample_plain(tab, grid, mode)
            mx, mrel, _ = errors(got, ref)
            good = mx <= 2e-2 and mrel < 5e-3
            ok &= good
            ms = cuda_ms(lambda: bs.bilinear_sample(tab, grid, mode))
            pms = cuda_ms(lambda: bs.bilinear_sample_plain(tab, grid, mode), reps=3, inner=1)
            nchw = tab.float().permute(0, 3, 1, 2).contiguous()
            g4 = grid[:, None]
            lms = cuda_ms(lambda: F.grid_sample(nchw, g4, mode="bilinear", padding_mode=mode, align_corners=False))
            P = grid.shape[1]
            bms, _ = bound(tab.numel() * 2 + grid.numel() * 4 + 2 * P * C * 2, 0, BF16_FLOPS)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
                acc[k] += v
            acc["max_abs_err"] = max(acc["max_abs_err"], mx)
            log(f"[kernels] K1 bilinear_sample {hw}x{hw}x{C} {mode:6s} P={P}: max_abs {mx:.3e} "
                f"mean_rel {mrel:.3e} (bound 2e-2 / 5e-3) {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms, "
                f"plain {pms:.3f} ms, F.grid_sample (f32 NCHW) {lms:.3f} ms, bound {bms:.3f} ms (bytes)")
    summary["bilinear_sample"] = dict(acc, bound_by="bytes")

    # K1's corner-id entry, at the 64^2 training level's shape
    B, HW, C, P = 12, 4096, 256, TRAIN_RAYS * 64
    table = torch.randn(B, HW, C, device=dev, generator=gen).bfloat16()
    x, y = bs.pixel_xy(train_grid(B, TRAIN_RAYS, 64, 0.2, gen, dev), 64, 64, "zeros")
    idx, w = bs.corners_from_pixel_xy(x, y, 64, True)
    idx, w = idx.contiguous(), w.contiguous()
    got = bs.corner_sample(table, idx, w, torch.bfloat16)
    ref = bs.corner_sample_plain(table, idx, w, torch.bfloat16)
    mx, _, _ = errors(got, ref)
    good = mx == 0.0
    ok &= good
    ms = cuda_ms(lambda: bs.corner_sample(table, idx, w, torch.bfloat16))
    pms = cuda_ms(lambda: bs.corner_sample_plain(table, idx, w, torch.bfloat16), reps=3, inner=1)
    # one library call: embedding_bag's weighted sum over the 4 corner rows
    flat = table.reshape(B * HW, C)
    valid = (idx >= 0) & (idx < HW)
    rows = (idx.clamp(0, HW - 1) + torch.arange(B, device=dev)[:, None, None] * HW).reshape(-1, 4).long()
    psw = torch.where(valid, w, torch.zeros_like(w)).reshape(-1, 4).bfloat16()
    lms = cuda_ms(lambda: F.embedding_bag(rows, flat, per_sample_weights=psw, mode="sum"))
    bms, bby = bound(table.numel() * 2 + idx.numel() * 4 + w.numel() * 4 + B * P * C * 2, 0, BF16_FLOPS)
    log(f"[kernels] K1 corner_sample 64x64x{C} zeros B={B} P={P}: max_abs {mx:.3e} (bound 0: same f32 "
        f"arithmetic) {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
        f"F.embedding_bag {lms:.3f} ms, bound {bms:.3f} ms ({bby})")
    summary["corner_sample"] = dict(max_abs_err=mx, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=bby)
    del table, flat, rows, psw

    # K2: stage A's W1 (T = 16 x 32768 tokens per view row) in bf16, and f32
    W = torch.randn(835, 832, device=dev, generator=gen) / 835 ** 0.5
    bias = torch.randn(832, device=dev, generator=gen) * 0.1
    fk = torch.randn(832, 128, device=dev, generator=gen) / 832 ** 0.5
    for dtype, T in ((torch.bfloat16, 16 * CHUNK), (torch.float32, 4 * CHUNK)):
        parts = [torch.randn(2, T, w_, device=dev, generator=gen).to(dtype) for w_ in (256, 256, 256, 64)]
        parts.append(torch.tanh(torch.randn(2, T, 3, device=dev, generator=gen)).to(dtype))
        with torch.no_grad():
            out, k = split_dense_relu(parts, W, bias, fk)
            pout, pk = split_dense_relu_plain(parts, W, bias, fk)
        tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
        e_out, e_k = errors(out, pout), errors(k, pk)
        good = e_out[2] < tol and e_k[2] < tol
        ok &= good
        with torch.no_grad():
            ms = cuda_ms(lambda: split_dense_relu(parts, W, bias, fk))
            pms = cuda_ms(lambda: split_dense_relu_plain(parts, W, bias, fk), reps=3, inner=1)
            x = torch.cat(parts, dim=-1).reshape(-1, 835)
            Wd, bd, fkd = W.to(dtype), bias.to(dtype), fk.to(dtype)
            lms = cuda_ms(lambda: torch.matmul(torch.relu(torch.addmm(bd, x, Wd)), fkd))
        M = 2 * T
        flops = 2 * M * (835 * 832 + 832 * 128)
        esz = 2 if dtype == torch.bfloat16 else 4
        nbytes = M * 835 * esz + (835 * 832 + 832 * 128) * esz + 832 * 4 + M * (832 + 128) * esz
        bms, bby = bound(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        tflops = flops / (ms * 1e-3) / 1e12
        log(f"[kernels] K2 split_dense_relu {str(dtype)[6:]} T={T}: out max_abs {e_out[0]:.3e} rel {e_out[2]:.3e}, "
            f"k max_abs {e_k[0]:.3e} rel {e_k[2]:.3e} (bound max-rel {tol:g}) {'ok' if good else 'FAIL'}; "
            f"kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain {pms:.3f} ms, addmm+relu+matmul {lms:.3f} ms, "
            f"bound {bms:.3f} ms ({bby})")
        if dtype == torch.bfloat16:
            summary["split_dense_relu"] = dict(max_abs_err=max(e_out[0], e_k[0]), ms=ms, plain_ms=pms,
                                               library_ms=lms, bound_ms=bms, bound_by=bby)
        del parts, out, k, pout, pk, x

    # K3: one stage-A weighted sum with the view fold
    S, N = 16, CHUNK
    pre = torch.randn(2, S * N, 832, device=dev, generator=gen).bfloat16()
    wts = torch.softmax(torch.randn(2, N, S, device=dev, generator=gen), -1)
    got = weighted_sum_smaj(pre, wts, S, vsum=2)
    ref = weighted_sum_plain(pre, wts, S, vsum=2)
    mx, mrel, _ = errors(got, ref)
    good = mx < 1e-2
    ok &= good
    ms = cuda_ms(lambda: weighted_sum_smaj(pre, wts, S, vsum=2))
    pms = cuda_ms(lambda: weighted_sum_plain(pre, wts, S, vsum=2), reps=3, inner=1)
    pre4 = pre.reshape(1, 2, S, N, 832)
    w4 = wts.reshape(1, 2, N, S)
    lms = cuda_ms(lambda: torch.einsum("bvsnc,bvns->bnc", pre4, w4.to(pre4.dtype)))
    bms, bby = bound(pre.numel() * 2 + wts.numel() * 4 + N * 832 * 4, 2 * pre.numel(), F32_FLOPS)
    gbs = pre.numel() * 2 / (ms * 1e-3) / 1e9
    log(f"[kernels] K3 weighted_sum_smaj N={N} S={S} V=2: max_abs {mx:.3e} mean_rel {mrel:.3e} (bound 1e-2) "
        f"{'ok' if good else 'FAIL'}; kernel {ms:.3f} ms ({gbs:.0f} GB/s of pre), plain {pms:.3f} ms, "
        f"einsum {lms:.3f} ms, bound {bms:.3f} ms ({bby})")
    summary["weighted_sum_smaj"] = dict(max_abs_err=mx, ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                                        bound_by=bby)
    del pre, pre4

    # K4: the training backward of each small level (12 rows x 12288 points,
    # C = 256, bf16 cotangents), both padding modes
    acc = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    B, P, C = 12, TRAIN_RAYS * 64, 256
    g = torch.randn(B, P, C, device=dev, generator=gen).bfloat16()
    for hw in (16, 32, 64):
        for mode, shift in (("border", 0.0), ("zeros", 0.3)):
            x, y = bs.pixel_xy(train_grid(B, TRAIN_RAYS, 64, shift, gen, dev), hw, hw, mode)
            idx, w = bs.corners_from_pixel_xy(x, y, hw, mode != "border")
            idx, w = idx.contiguous(), w.contiguous()
            HW = hw * hw
            got = bs.onehot_transpose_matmul(g, idx, w, HW)
            ref = bs.onehot_transpose_matmul_plain(g, idx, w, HW)
            mx, _, rel = errors(got, ref)
            good = rel < 1e-4          # f32 sums in the atomics' order
            ok &= good
            ms = cuda_ms(lambda: bs.onehot_transpose_matmul(g, idx, w, HW))
            pms = cuda_ms(lambda: bs.onehot_transpose_matmul_plain(g, idx, w, HW), reps=3, inner=1)
            valid = (idx >= 0) & (idx < HW) & (w != 0)
            rows = (idx.clamp(0, HW - 1).long() + torch.arange(B, device=dev)[:, None, None] * HW).reshape(-1)
            contrib = (g.float()[:, :, None, :] * torch.where(valid, w, torch.zeros_like(w))[..., None]).reshape(-1, C)
            dst = torch.zeros(B * HW, C, device=dev)
            lms = cuda_ms(lambda: dst.index_add_(0, rows, contrib))
            n_valid = int(valid.sum())
            bms, bby = bound(g.numel() * 2 + idx.numel() * 4 + w.numel() * 4 + B * HW * C * 4,
                             2 * n_valid * C, F32_FLOPS)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
                acc[k] += v
            acc["max_abs_err"] = max(acc["max_abs_err"], mx)
            log(f"[kernels] K4 onehot_transpose_matmul {hw}x{hw}x{C} {mode:6s} B={B} P={P} "
                f"({n_valid / (B * P):.2f} valid corners/point): max_abs {mx:.3e} max-rel {rel:.3e} (bound 1e-4) "
                f"{'ok' if good else 'FAIL'}; kernel {ms:.3f} ms, plain {pms:.3f} ms, index_add_ {lms:.3f} ms, "
                f"bound {bms:.4f} ms ({bby})")
            del contrib, dst, rows
    summary["onehot_transpose_matmul"] = dict(acc, bound_by="bytes")
    del g

    ok &= phase_soft_argmax(dev, summary, gen)
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")


def cosine_volume(B: int, n: int, gen: torch.Generator, dev) -> torch.Tensor:
    """(B, n, n) f32 cosine correlations of unit features where target token
    s resembles source token s - 97: one sharp peak per row and column, as
    a trained UFC gives."""
    import torch.nn.functional as F

    src = F.normalize(torch.randn(B, n, 64, device=dev, generator=gen), dim=-1)
    trg = F.normalize(src.roll(97, dims=1) + 0.7 * torch.randn(B, n, 64, device=dev, generator=gen), dim=-1)
    return torch.bmm(src, trg.transpose(1, 2)).contiguous()


def phase_soft_argmax(dev, summary, gen) -> bool:
    """K5's two kernels against their plain versions at the fine UFC
    volume's shape: B 6 (the train step) and B 1 (one encode).  Bounds: the
    mappings (expectations in [-1, 1]) 1e-4 max-abs and dc 1e-4 of its
    largest value; the kernels sum in tiles and merge with a rescale and
    take exp2 with 1/beta folded into the scale, the plain versions sum
    whole rows and take exp(x / beta): f32 round-off either way."""
    from coponerf_tpu_torch.ops import soft_argmax as sa

    ok = True
    n = (IMAGE // 4) ** 2
    for B in (TRAIN_BATCH, 1):
        c = cosine_volume(B, n, gen, dev)
        got = sa.soft_argmax_stats(c)
        ref = sa.soft_argmax_stats_plain(c, 0.02)
        mx = max(errors(g[:, 2:] / g[:, 1:2], r[:, 2:] / r[:, 1:2])[0] for g, r in zip(got, ref))
        zrel = max(errors(g[:, 1], r[:, 1])[2] for g, r in zip(got, ref))
        good = mx <= 1e-4
        ok &= good
        ms = cuda_ms(lambda: sa.soft_argmax_stats(c))
        pms = cuda_ms(lambda: sa.soft_argmax_stats_plain(c, 0.02), reps=3, inner=1)
        # c read once, the statistics and coordinates read/written once; per
        # element and direction: subtract, scale, exp, three multiply-adds
        bms, bby = bound(c.numel() * 4 + B * 4 * 2 * n * 4 + 4 * n * 4, 16 * c.numel(), F32_FLOPS)
        log(f"[kernels] K5 soft_argmax_stats B={B} Q=S={n}: mappings max_abs {mx:.3e} (bound 1e-4), partition "
            f"max-rel {zrel:.3e} {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms "
            f"({c.numel() * 4 / (ms * 1e-3) / 1e12:.2f} TB/s of c), plain {pms:.3f} ms, library none (no one "
            f"PyTorch call computes both softmax expectations), bound {bms:.3f} ms ({bby})")
        stats_entry = dict(max_abs_err=mx, ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby)

        rowf = torch.cat([ref[0][:, :2], ref[0][:, 2:] / ref[0][:, 1:2]], dim=1)
        colf = torch.cat([ref[1][:, :2], ref[1][:, 2:] / ref[1][:, 1:2]], dim=1)
        dr = torch.randn(B, 2, n, device=dev, generator=gen)
        dcol = torch.randn(B, 2, n, device=dev, generator=gen)
        del got, ref
        dc = sa.soft_argmax_bwd(c, rowf, colf, dr, dcol)
        dref = sa.soft_argmax_bwd_plain(c, rowf, colf, dr, dcol, 0.02)
        bmx, _, brel = errors(dc, dref)
        good = brel <= 1e-4
        ok &= good
        del dc, dref
        ms = cuda_ms(lambda: sa.soft_argmax_bwd(c, rowf, colf, dr, dcol))
        pms = cuda_ms(lambda: sa.soft_argmax_bwd_plain(c, rowf, colf, dr, dcol, 0.02), reps=3, inner=1)
        # c read and dc written once; per element two exps and ~12 operations
        bms, bby = bound(2 * c.numel() * 4 + B * 6 * 2 * n * 4 + 4 * n * 4, 14 * c.numel(), F32_FLOPS)
        log(f"[kernels] K5 soft_argmax_bwd B={B} Q=S={n}: dc max_abs {bmx:.3e} max-rel {brel:.3e} (bound 1e-4) "
            f"{'ok' if good else 'FAIL'}; kernel {ms:.3f} ms ({2 * c.numel() * 4 / (ms * 1e-3) / 1e12:.2f} TB/s), "
            f"plain {pms:.3f} ms, library none (no one PyTorch call computes this gradient), "
            f"bound {bms:.3f} ms ({bby})")
        if B == TRAIN_BATCH:       # the JSON line carries the train shape
            summary["soft_argmax_stats"] = stats_entry
            summary["soft_argmax_bwd"] = dict(max_abs_err=bmx, ms=ms, plain_ms=pms, library_ms=None,
                                              bound_ms=bms, bound_by=bby)
        else:
            for k, e in (("soft_argmax_stats", mx), ("soft_argmax_bwd", bmx)):
                summary[k]["max_abs_err"] = max(summary[k]["max_abs_err"], e)
        del c, rowf, colf, dr, dcol
        torch.cuda.empty_cache()
    return ok


def profile_step(step, card: str, label: str) -> None:
    """One train step under torch.profiler: wall time, device busy share
    (kernel time over wall) and device time by kernel, largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[profile] {label}, one step: wall {wall_ms:.1f} ms under the profiler, device kernel time {total:.1f} ms "
        f"(busy {total / wall_ms:.2f}), {sum(e.count for e in kernels)} kernel launches [{card}]")
    mine = ("bilinear_sample_kernel", "transpose_sample_kernel", "split_dense_relu", "weighted_sum_kernel",
            "soft_argmax_partials_kernel", "soft_argmax_combine_kernel", "soft_argmax_bwd_kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        tag = " (port kernel)" if any(m in e.key for m in mine) else ""
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x  {e.key[:90]}{tag}")
    for m in mine:
        t = sum(e.self_device_time_total for e in kernels if m in e.key) / 1e3
        n = sum(e.count for e in kernels if m in e.key)
        log(f"[profile]   port kernel {m}: {t:.2f} ms in {n} launches ({t / max(total, 1e-9):.3f} of kernel time)")


def resident_bytes(state) -> int:
    """Device bytes a train state holds between steps: parameters, buffers
    and the optimizer's moments (gradients are freed after each step)."""
    ts = [*state.model.parameters(), *state.model.buffers()]
    ts += [v for s in state.optimizer.state.values() for v in s.values() if torch.is_tensor(v)]
    return sum(t.numel() * t.element_size() for t in ts if t.is_cuda)


def slice_chunk(batch, lo: int, hi: int):
    q = dict(batch["query"])
    q["uv"] = q["uv"][:, :, lo:hi]
    q["rgb"] = q["rgb"][:, :, lo:hi]
    return {"context": batch["context"], "query": q}


def check_render(out, n_rays: int, SE: int):
    if out["rgb"].shape != (1, 1, n_rays, 3) or out["at_wt"].shape != (2, n_rays, SE):
        raise RuntimeError(f"bad shapes: rgb {tuple(out['rgb'].shape)}, at_wt {tuple(out['at_wt'].shape)}")
    for k in ("rgb", "at_wt", "depth_ray"):
        if not torch.isfinite(out[k]).all():
            raise RuntimeError(f"non-finite {k}")
    wsum = out["at_wt"].reshape(1, 2, n_rays, SE).sum(dim=(1, 3))
    if (wsum - 1).abs().max().item() > 1e-3:
        raise RuntimeError("attention weights do not sum to 1 over views x samples")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
        from coponerf_tpu_torch.data.synthetic import make_batch
        from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
        from coponerf_tpu_torch.ops import _build
        from coponerf_tpu_torch.ops.bilinear_sample import bilinear_sample, corner_sample, onehot_transpose_matmul
        from coponerf_tpu_torch.ops.soft_argmax import soft_argmax_bwd, soft_argmax_stats
        from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
        from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj
        from coponerf_tpu_torch.training import trainer
        from coponerf_tpu_torch.utils.init import init_weights
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    if smi.returncode != 0 or not lines or "," not in lines[0]:
        raise RuntimeError(f"nvidia-smi gave no name and power limit (rc {smi.returncode}): {smi.stderr.strip()}")
    card = lines[0].strip()
    log(card)
    log(f"[device] {name}, torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds or 0:.1f} s; {_build.library_path()})")

    summary = {}
    phase_kernels(dev, summary)
    torch.cuda.empty_cache()
    counters = {"bilinear_sample": bilinear_sample, "corner_sample": corner_sample,
                "split_dense_relu": split_dense_relu, "weighted_sum_smaj": weighted_sum_smaj,
                "onehot_transpose_matmul": onehot_transpose_matmul, "soft_argmax_stats": soft_argmax_stats,
                "soft_argmax_bwd": soft_argmax_bwd}
    assert set(counters) == set(KERNELS)
    launches = {}

    def count(path: str, fn):
        """Run ``fn`` with every launch count set to 0 and keep the counts."""
        for c in counters.values():
            c.launches = 0
        result = fn()
        launches[path] = {k: c.launches for k, c in counters.items()}
        return result

    # 4. the inference path
    cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4)
    SE = cfg.coarse_samples + cfg.fine_samples
    t0 = time.perf_counter()
    model = init_weights(CoPoNeRF(cfg, image_size=IMAGE).eval(), seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    model = model.to(dev)
    log(f"[infer] model ready: {n_params / 1e6:.1f} M parameters, seeded init {time.perf_counter() - t0:.1f} s")
    batch_np, _ = make_batch(batch_size=1, image_size=IMAGE, n_rays=2 * CHUNK, full_query_image=True, seed=0)
    batch = batch_to_torch(batch_np, dev)
    n_rays = batch["query"]["uv"].shape[2]

    def infer():
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = model.encode(batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for lo in range(0, n_rays, CHUNK):
                check_render(model.render(slice_chunk(batch, lo, lo + CHUNK), state, val=True), CHUNK, SE)
            torch.cuda.synchronize()
            return state, t1 - t0, time.perf_counter() - t1

    _, enc_cold, ren_cold = count("infer", infer)
    state, enc_s, ren_s = count("infer", infer)
    n_chunks = n_rays // CHUNK
    log(f"[infer] first request (warm-up included): encode {enc_cold * 1e3:.1f} ms, render {ren_cold * 1e3:.1f} ms")
    log(f"[infer] second request: encode {enc_s * 1e3:.1f} ms, render {ren_s * 1e3:.1f} ms/image "
        f"({n_rays / ren_s:.0f} rays/s), {n_rays} rays in {n_chunks} chunks of "
        f"{CHUNK}, rel_pose finite {bool(torch.isfinite(state.rel_pose).all())} [{card}]")
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(bilinear_sample=16 * n_chunks, split_dense_relu=4 * n_chunks, weighted_sum_smaj=8 * n_chunks)
    log(f"[infer] kernel launches: {launches['infer']} (expected {expected})")
    if launches["infer"] != expected:
        raise RuntimeError("a kernel of the inference path was not launched as expected")

    # 4b. the same request's encode with fused_argmax: K5 extracts the flows
    fmodel = CoPoNeRF(dataclasses.replace(cfg, fused_argmax=True), image_size=IMAGE).eval()
    fmodel.load_state_dict(model.state_dict())
    fmodel = fmodel.to(dev)
    seen = {}
    hooks = [m_.feature_cost_aggregation.register_forward_hook(lambda mod, args, out, tag=tag: seen.update({tag: out[2]}))
             for m_, tag in ((model, "unfused"), (fmodel, "fused"))]

    def encode_fused():
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fstate = fmodel.encode(batch)
            torch.cuda.synchronize()
            return fstate, time.perf_counter() - t0

    _, fenc_cold = count("encode_fused", encode_fused)
    fstate, fenc_s = count("encode_fused", encode_fused)
    with torch.no_grad():          # the unfused encode once more: its c, and a time taken beside the fused
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ustate = model.encode(batch)
        torch.cuda.synchronize()
        uenc_s = time.perf_counter() - t0
    dflow = max((a - b).abs().max().item() for a, b in zip(fstate.flows[:2], ustate.flows[:2]))
    dmap = max((a - b).abs().max().item() for a, b in zip(fstate.flows[2:], ustate.flows[2:]))
    dcorr = (seen["fused"] - seen["unfused"]).abs().max().item()
    dpose = (fstate.rel_pose - ustate.rel_pose).abs().max().item()
    for h in hooks:
        h.remove()
    log(f"[infer] fused_argmax encode: first {fenc_cold * 1e3:.1f} ms (warm-up), second {fenc_s * 1e3:.1f} ms; "
        f"unfused encodes of the same request {enc_s * 1e3:.1f} ms and, right after, {uenc_s * 1e3:.1f} ms [{card}]")
    good = dflow <= 1e-2 and np.isfinite(dflow)
    log(f"[infer] fused vs unfused encode: flows max_abs {dflow:.3e} px, mappings {dmap:.3e} (bound 1e-2 px: "
        f"f32 sums in another order at beta 0.02 over 4096 tokens, 31.5 px per mapping unit), c max_abs "
        f"{dcorr:.3e}, rel_pose max_abs {dpose:.3e} "
        f"{'ok' if good else 'FAIL'}")
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(soft_argmax_stats=1)
    log(f"[infer] fused encode kernel launches: {launches['encode_fused']} (expected {expected})")
    if not good:
        raise RuntimeError("the fused and unfused encodes disagree")
    if launches["encode_fused"] != expected:
        raise RuntimeError("a kernel of the fused encode was not launched as expected")
    del fmodel, fstate, ustate, seen

    # 5. the same chunk on the card and on the CPU (plain versions)
    small = slice_chunk(batch, 20000, 21024)
    with torch.no_grad():
        out_gpu = model.render(small, state, val=True)
        torch.cuda.synchronize()
        model_cpu = model.to("cpu")
        cpu_small = {k: {kk: vv.cpu() for kk, vv in v.items()} for k, v in small.items()}
        t0 = time.perf_counter()
        out_cpu = model_cpu.render(cpu_small, state.to("cpu"), val=True)
    a, b = out_gpu["rgb"].float().cpu(), out_cpu["rgb"].float()
    mrel = ((a - b).abs().mean() / (b.abs().mean() + 1e-6)).item()
    wdiff = (out_gpu["at_wt"].cpu() - out_cpu["at_wt"]).abs().mean().item()
    good = mrel < 2e-2 and wdiff < 2e-2
    log(f"[compare] 1024-ray chunk, card vs CPU plain versions: rgb mean_rel {mrel:.3e}, at_wt mean abs {wdiff:.3e} "
        f"(bound 2e-2 each) {'ok' if good else 'FAIL'} (CPU render {time.perf_counter() - t0:.1f} s)")
    if not good:
        raise RuntimeError("card and CPU renders disagree")
    del model, model_cpu, state, out_gpu, batch
    torch.cuda.empty_cache()

    # 6. the training path, unfused and with fused_argmax (K5), from the
    # same seeded weights, both states resident, taking steps in turns
    tcfg = Config(model=ModelConfig(fast_sampling=True, compute_dtype="bfloat16"),
                  loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig())
    m = tcfg.model
    assert m.remat_ufc and m.convmap_direct_grad and m.train_onehot_small
    batches = [batch_to_torch(make_batch(batch_size=TRAIN_BATCH, image_size=IMAGE, n_rays=TRAIN_RAYS,
                                         seed=s)[0], dev) for s in (1, 2)]
    runs = {}
    for path, fused in (("train", False), ("train_fused", True)):
        tc = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, fused_argmax=fused))
        st = trainer.create_train_state(tc, IMAGE, dev, model=init_weights(CoPoNeRF(tc.model, image_size=IMAGE), seed=0))
        per_step = dict.fromkeys(KERNELS, 0)
        per_step.update(bilinear_sample=6, split_dense_relu=2, onehot_transpose_matmul=6)
        if fused:
            per_step.update(soft_argmax_stats=1, soft_argmax_bwd=1)
        watch = {k: p.detach().clone() for k, p in st.model.named_parameters()
                 if k in ("query_encode_latent.Dense_0.weight", "encoder.stem.conv.weight", "conv_map.weight",
                          "feature_cost_aggregation.proj_feat_0.Dense_0.weight")}
        runs[path] = dict(cfg=tc, state=st, per_step=per_step, watch=watch, times=[], metrics=[], peak=0,
                          total=dict.fromkeys(KERNELS, 0))
    n_steps, n_warm = 5, 2

    def step(path: str, i: int) -> None:
        """One train step of ``path``; its peak memory is the step's peak
        less the other state's resident tensors, i.e. what it takes alone."""
        r = runs[path]
        other = next(o["state"] for p, o in runs.items() if p != path)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mt = trainer.train_step(r["state"], batches[i % 2], r["cfg"])
        torch.cuda.synchronize()
        r["times"].append(time.perf_counter() - t0)
        r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated() - resident_bytes(other))
        r["metrics"].append({k: float(v) for k, v in mt.items()})

    for i in range(n_steps):
        for path in (("train", "train_fused") if i % 2 == 0 else ("train_fused", "train")):
            count(path, lambda: step(path, i))
            if launches[path] != runs[path]["per_step"]:
                raise RuntimeError(f"{path} step {i}: launches {launches[path]}, expected {runs[path]['per_step']}")
            for k in KERNELS:
                runs[path]["total"][k] += launches[path][k]
    for path, r in runs.items():
        launches[path] = r["total"]
        times, st = r["times"], r["state"]
        step_s = statistics.median(times[n_warm:])
        for i, (t, mt) in enumerate(zip(times, r["metrics"])):
            log(f"[{path}] step {i} ({'warm-up' if i < n_warm else 'timed'}): {t * 1e3:.1f} ms, "
                + ", ".join(f"{k} {v:.5g}" for k, v in mt.items()))
        log(f"[{path}] fast config{' + fused_argmax' if r['cfg'].model.fused_argmax else ''}, batch {TRAIN_BATCH} "
            f"x 256^2 pairs, {TRAIN_RAYS} rays, 64 samples, steps in turns with the other configuration: step "
            f"{step_s * 1e3:.1f} ms (median of {n_steps - n_warm}: " + ", ".join(f"{t * 1e3:.1f}" for t in times[n_warm:])
            + f"), {TRAIN_BATCH / step_s:.2f} pairs/s, peak device memory {r['peak'] / 2 ** 30:.2f} GiB [{card}]")
        for mt in r["metrics"]:
            if not all(np.isfinite(v) for v in mt.values()) or not mt["grad_norm"] > 0:
                raise RuntimeError(f"bad train metrics: {mt}")
        if st.updates != n_steps:
            raise RuntimeError(f"{n_steps - st.updates} steps applied no update")
        named = dict(st.model.named_parameters())
        moved = {k: bool((named[k].detach() != v).any()) for k, v in r["watch"].items()}
        log(f"[{path}] parameters moved: {moved}")
        if not all(moved.values()):
            raise RuntimeError("a parameter did not move")
        log(f"[{path}] kernel launches over {n_steps} steps: {launches[path]} (per step {r['per_step']}, "
            f"checked at every step)")
    # both first steps start from the same weights on the same batch.  The
    # forward differs only by the soft-argmax's f32 sum order: losses 1e-4
    # relative.  In the backward that f32 difference in the volume's
    # gradient rounds to another bf16 value in some elements of the bf16 UFC
    # (2^-8 apart), and K4's atomics reorder f32 sums: grad norm 1e-2, the
    # bound of the card-vs-CPU step below
    first = {p: r["metrics"][0] for p, r in runs.items()}
    rel = {k: abs(first["train_fused"][k] - v) / (abs(v) + 1e-12) for k, v in first["train"].items()}
    worst = max(v for k, v in rel.items() if k != "grad_norm")
    good = worst < 1e-4 and rel["grad_norm"] < 1e-2
    log("[train_fused] first step, fused vs unfused: relative " + ", ".join(f"{k} {rel[k]:.2e}" for k in rel)
        + f"; losses max {worst:.3e} (bound 1e-4), grad_norm {rel['grad_norm']:.3e} (bound 1e-2) "
        + ("ok" if good else "FAIL"))
    if not good:
        raise RuntimeError("the fused and unfused train steps disagree")
    for path, r in runs.items():
        profile_step(lambda: trainer.train_step(r["state"], batches[0], r["cfg"]), card, path)
    del runs, batches
    torch.cuda.empty_cache()

    # 7. one train step on the card and on the CPU, same weights and batch.
    # The pose term is off: at random weights the pose head amplifies the
    # bf16-level differences of its input tokens into gradients that differ
    # by factors; tests/test_torch_train_pose.py compares that term's
    # gradient from one shared cotangent instead
    cbatch = make_batch(batch_size=1, image_size=64, n_rays=TRAIN_RAYS, seed=3)[0]
    for fused in (False, True):
        ccfg = Config(model=ModelConfig(fast_sampling=True, compute_dtype="bfloat16", mask_upsample=64,
                                        fused_argmax=fused),
                      loss=LossConfig(cycle=True, ssim=True), train=TrainConfig())
        weights = init_weights(CoPoNeRF(ccfg.model, image_size=64), seed=1).state_dict()
        res = {}
        for where in ("cuda", "cpu"):
            model = CoPoNeRF(ccfg.model, image_size=64)
            model.load_state_dict(weights)
            st = trainer.create_train_state(ccfg, 64, torch.device(where), model=model)
            t0 = time.perf_counter()
            res[where] = {k: float(v) for k, v in trainer.train_step(st, batch_to_torch(cbatch, where), ccfg).items()}
            res[where + "_s"] = time.perf_counter() - t0
        rel = {k: abs(res["cuda"][k] - res["cpu"][k]) / (abs(res["cpu"][k]) + 1e-12) for k in res["cpu"]}
        good = max(rel.values()) < 2e-2
        log(f"[compare] one train step (64^2, batch 1, cycle + ssim{', fused_argmax' if fused else ''}), card vs "
            f"CPU plain versions: " + ", ".join(f"{k} {res['cuda'][k]:.6g}/{res['cpu'][k]:.6g}" for k in res["cpu"])
            + f"; max rel {max(rel.values()):.3e} (bound 2e-2) {'ok' if good else 'FAIL'} "
              f"(CPU step {res['cpu_s']:.1f} s)")
        if not good:
            raise RuntimeError("card and CPU train steps disagree")

    kernels = []
    for k in KERNELS:
        by_path = {p: launches[p][k] for p in launches}
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
                        "launches": sum(by_path.values()), "launches_by_path": by_path, **summary[k]})
    log(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report the failing phase, then fail
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
