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
     paths' shapes: K1 (bilinear_sample, the multi-level entry with one
     level) on the three small levels in both padding modes at the
     training shape (12 rows x 12288 points), where training samples with
     it (its device time under torch.profiler printed beside), and its
     corner-id entry; K8a (multilevel_sample) on the four render levels at
     stage A's 16 x 32768 points of both sample sets, bit for bit against its plain version and the four one-level launches it
     replaces and timed in turns with them; K8b (grid_sample_window) on the
     256^2 level in f32; K2 at every row count the paths launch (bf16:
     1048576, 262144, 4194304, 147456 and a ragged 1048539; f32, the
     exact path: 524288), its library call also timed on an input
     zero-padded to K = 840; K3 at N=32768, S=16, V=2, and K4 on the three small
     levels in both padding modes (training: 12 rows x 12288 points, C=256),
     and K5's forward statistics and backward on cosine-like correlation
     volumes at the train shape (B 6, Q = S = 4096) and the inference shape
     (B 1), the forward also one device launch a call under torch.profiler
     and the same bits on a second call; K7's round-1 and round-2 logits
     at the stage-A and stage-B shapes (2 view rows x 16 or 4 x 32768
     tokens) and K6 on a whole
     single-stage chunk (32768 rays, V 2, S 64; its plain version takes the rays in blocks; with its
     device scratch) and on 4096 rays at V*S 160.  Each prints its error against a stated bound and CUDA-event
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
     joint softmax and every kernel's launch count (K8a once per sample set
     and stage, K1 never); then the same request's
     encode with fused_argmax (K5), warm-up then timed, its launch counts
     (K5 forward 1, backward 0) and its flows against the unfused encode's;
     then the same request rendered by a model of the same weights built
     with fusion="attn_embed" (K7) in cf[16, 4], and in the single-stage
     fast config (S 64) unfused and with fusion="render_core" (K6) in
     turns, each warm-up then timed, with
     launch counts, ms/image, rays/s and peak memory, and each fused
     render's rgb and at_wt against the unfused render of its config;
     the four renders are then profiled once each; then the camera path
     (eval/trajectory.py): 8 frames of the request between its context
     cameras from one encode through render_trajectory, cf[16, 4],
     32768-ray chunks, ms/frame and frames/s, launch counts per frame (K8a
     8, K2 8, K3 16) and one frame against a direct chunked render at its
     pose, bit for bit; then the evaluation
     harness (eval/harness.py evaluate) in the entry's fast config (single
     stage, S 64) on two synthetic 256^2 pairs (seeds 0 and 1) with full
     query images, 32768-ray chunks, batch 1: ms per image, rays/s, PSNR,
     SSIM and pose errors, finite metrics, prune_invalid=True against
     unpruned (PSNR and SSIM to 1e-6), the launch counts (K8a, no K1), a
     pair with a turned query camera whose pruned render skips a chunk and
     scatters back (rgb against the unpruned render to 1e-5, metrics to
     1e-6), and the harness's assembled rgb against a direct chunked render,
     bit for bit; one pair's evaluation is profiled and timed with the
     test entry's MetricLogger (its ten panels, PNGs where TensorBoard does
     not import) against none, in turns; then one pair through
     evaluate in the test entry's default exact config (f32, fast_sampling
     off, S 64, 4096-ray chunks): ms/image, metrics, and K2's f32 kernel
     twice a chunk, no other kernel; between the two, LPIPS-VGG on random
     weights on the card against the CPU (1e-4 relative, ms/image) and one
     pair through evaluate with the LPIPS column; then the native scene
     cache (runtime/scenecache.cpp built by g++ into the build directory):
     frames written and read back, its fused crop + resize against the
     numpy bilinear path (1e-5);
  5. one 1024-ray chunk rendered on the card and on the CPU (where the plain
     versions run) from the same SceneState and weights, unfused and by
     models built with fusion="attn_embed" (cf[16, 4]) and with
     fusion="render_core" (single stage), rgb and at_wt compared at the
     fast-config bound;
  6. the training path (its synthetic batches' host generation timed
     against the step, the cost --synthetic_pool saves the train entry):
     the same widths, fast config (fast_sampling, bf16,
     remat_ufc, convmap_direct_grad, train_onehot_small), pose + cycle +
     SSIM losses, batches of 6 synthetic 256^2 pairs with 192 rays, unfused
     and with fused_argmax, two train states from the same seeded weights
     taking their steps in turns (two warm-up and three timed Adam steps
     each); checks finite losses, a positive grad norm, moved parameters,
     the launch counts of every step (K1 6, K2 2, K4 6, and with
     fused_argmax K5 forward 1 and backward 1) and the fused first step's
     losses and grad norm against the unfused first step's (same weights,
     same batch); prints step ms, pairs/s and each configuration's peak
     memory, and profiles one step of each; then in-training validation
     (training/validation.py make_val_fn, its default 512-ray chunks) on
     the unfused state over one full 256^2 pair: every val_* term finite,
     ms, the panels captured by a recording logger, launch counts (K8a 2,
     K2 2, K3 4 a chunk); then the JAX package's checkpoint
     (utils/jax_checkpoint.py): the unfused state written as a JAX .npz and
     read back into a fresh state, and through the port's .pt, each bit for
     bit the source (weights, BatchNorm statistics, Adam's moments and
     steps, counters, learning rate), write and read seconds and the file
     sizes, one step of each restored state on the same batch (losses bit
     for bit, grad norm 1e-2; K1 6, K2 2, K4 6) and a 32768-ray cf[16, 4]
     chunk of the npz's weights bit for bit the source's (K8a 4, K2 4, K3 8);
  7. one train step on the card and on the CPU from the same weights and
     batch (64^2, batch 1), unfused and fused, losses and grad norm
     compared at the fast config's bound;
  8. the multi-rank paths (coponerf_tpu_torch/parallel): (a) NCCL over one
     rank in this process, the data-parallel train step against the plain
     one from the same weights on the same batch (fast config, batch 6),
     losses bit for bit, grad norm 1e-2, steps in turns and the gradient
     all-reduce timed; (b) two gloo ranks spawned on this card, each
     taking data-parallel steps on its pair of a global batch of 2 (fast
     config, cycle + SSIM), against this process's step on the whole batch
     (losses at bf16 level, 1e-2, grad norm 1e-2); (c) in the same ranks the 65536-ray cf[16, 4]
     request ray-sharded, one 32768-ray chunk a rank, bit for bit this
     process's chunked render on every rank; (d) with two cards or more,
     (b) and (c) over NCCL, one card a rank (otherwise one line says it did
     not run).  Each rank counts its own launches, checked per step and
     per render, and reported under paths of their own;
  9. the train step's formulations in phase 6's config, each pair of
     states from the same seeded weights taking steps on one batch in
     turns: (a) the last UFC layer with and without its dead second
     refinement (the features bit for bit), (b) conv4d_impl 2d and 3d,
     (c) remat_policy full and dots (first-step losses at 2e-2), (d) the
     per-leaf and the flat optimizer over three steps beside a second
     per-leaf state, (e) both under a one-rank NCCL mesh; each with its
     median step ms, busy share and launches of a profiled step, peak
     memory, and phase 6's launch counts checked at every step.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  The script imports only coponerf_tpu_torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
    "split_dense_relu_f32": "coponerf_tpu/ops/pallas/split_matmul.py:46",
    "weighted_sum_smaj": "coponerf_tpu/ops/pallas/weighted_sum.py:68",
    "onehot_transpose_matmul": "coponerf_tpu/ops/pallas/bilinear_sample.py:458",
    "soft_argmax_stats": "coponerf_tpu/ops/pallas/soft_argmax.py:132",
    "soft_argmax_bwd": "coponerf_tpu/ops/pallas/soft_argmax.py:178",
    "round1_logits": "coponerf_tpu/ops/pallas/experimental/attn_embed.py:57",
    "round2_logits": "coponerf_tpu/ops/pallas/experimental/attn_embed.py:120",
    "render_core": "coponerf_tpu/ops/pallas/experimental/render_core.py:165",
    "multilevel_sample": "coponerf_tpu/ops/pallas/experimental/multilevel_sample.py:80",
    "grid_sample_window": "coponerf_tpu/ops/pallas/experimental/windowed_sample.py:98",
}
SOURCES = {
    "bilinear_sample": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
    "corner_sample": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
    "split_dense_relu": "coponerf_tpu_torch/csrc/split_matmul.cu",
    "split_dense_relu_f32": "coponerf_tpu_torch/csrc/split_matmul.cu",
    "weighted_sum_smaj": "coponerf_tpu_torch/csrc/weighted_sum.cu",
    "onehot_transpose_matmul": "coponerf_tpu_torch/csrc/transpose_sample.cu",
    "soft_argmax_stats": "coponerf_tpu_torch/csrc/soft_argmax.cu",
    "soft_argmax_bwd": "coponerf_tpu_torch/csrc/soft_argmax.cu",
    "round1_logits": "coponerf_tpu_torch/csrc/attn_embed.cu",
    "round2_logits": "coponerf_tpu_torch/csrc/attn_embed.cu",
    "render_core": "coponerf_tpu_torch/csrc/render_core.cu",
    "multilevel_sample": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
    "grid_sample_window": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
}
KERNELS = tuple(REPLACES)
CHUNK = 32768
IMAGE = 256
TRAIN_BATCH = 6
TRAIN_RAYS = 192


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_counters():
    """{kernel name: its wrapper}; each wrapper counts its launches in
    ``.launches`` (K2's counts its f32 kernel's apart as well)."""
    from coponerf_tpu_torch.ops.attn_embed import round1_logits, round2_logits
    from coponerf_tpu_torch.ops.bilinear_sample import (bilinear_sample, corner_sample, grid_sample_window,
                                                        multilevel_sample, onehot_transpose_matmul)
    from coponerf_tpu_torch.ops.render_core import render_core
    from coponerf_tpu_torch.ops.soft_argmax import soft_argmax_bwd, soft_argmax_stats
    from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
    from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj

    counters = {"bilinear_sample": bilinear_sample, "corner_sample": corner_sample,
                "split_dense_relu": split_dense_relu, "weighted_sum_smaj": weighted_sum_smaj,
                "onehot_transpose_matmul": onehot_transpose_matmul, "soft_argmax_stats": soft_argmax_stats,
                "soft_argmax_bwd": soft_argmax_bwd, "round1_logits": round1_logits,
                "round2_logits": round2_logits, "render_core": render_core,
                "multilevel_sample": multilevel_sample, "grid_sample_window": grid_sample_window}
    assert set(counters) | {"split_dense_relu_f32"} == set(KERNELS)
    return counters


def reset_launches() -> None:
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    counters["split_dense_relu"].f32_launches = 0


def read_launches() -> dict:
    """Every kernel's launches since ``reset_launches``, K2's bf16 and f32
    kernels apart."""
    counters = kernel_counters()
    got = {k: c.launches for k, c in counters.items()}
    got["split_dense_relu_f32"] = counters["split_dense_relu"].f32_launches
    got["split_dense_relu"] -= got["split_dense_relu_f32"]
    return {k: got[k] for k in KERNELS}


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


def cuda_ms_in_turns(fns, reps: int = 5, inner: int = 10):
    """``cuda_ms`` of each of ``fns`` in turns (the order reversed every
    other window): the median ms per call of each."""
    times = [[] for _ in fns]
    for r in range(reps):
        order = list(range(len(fns)))[::1 if r % 2 == 0 else -1]
        for i in order:
            times[i].append(cuda_ms(fns[i], reps=1, inner=inner))
    return [statistics.median(t) for t in times]


def warm_clocks(dev, seconds: float = 0.5) -> None:
    """Back-to-back bf16 matmuls for ``seconds``, so that the first kernel
    timed runs at the clocks the later ones see (an idle card ramps up)."""
    a = torch.randn(4096, 4096, device=dev).bfloat16()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float, peak_flops: float):
    """(least ms, what bounds it): bytes over HBM rate vs operations over peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def errors(got: torch.Tensor, ref: torch.Tensor):
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    return d.max().item(), (d.mean() / (ref.abs().mean() + 1e-6)).item(), (d.max() / (ref.abs().max() + 1e-6)).item()


def errors_by_rows(got: torch.Tensor, ref: torch.Tensor, rows: int = 1 << 20):
    """``errors`` of (..., C) tensors taken over blocks of rows, so that the
    f32 copies of a multi-GB output stay small."""
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    mx = total = ref_sum = ref_max = 0.0
    for lo in range(0, got.shape[0], rows):
        g, r = got[lo: lo + rows].float(), ref[lo: lo + rows].float()
        d = (g - r).abs()
        mx, total = max(mx, d.max().item()), total + d.sum().item()
        ref_sum, ref_max = ref_sum + r.abs().sum().item(), max(ref_max, r.abs().max().item())
    n = got.numel()
    return mx, (total / n) / (ref_sum / n + 1e-6), mx / (ref_max + 1e-6)


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


def phase_kernels(dev, summary, card: str):
    import torch.nn.functional as F

    from coponerf_tpu_torch.bench_kernels import device_ms
    from coponerf_tpu_torch.ops import bilinear_sample as bs
    from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_plain, weighted_sum_smaj

    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    warm_clocks(dev)

    # K1: the training path's sampler, each small level at the training
    # shape (12 rows x 192 rays x 64 samples, C = 256), both padding modes
    acc = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    B, C = 12, 256
    for hw in (16, 32, 64):
        table = torch.randn(B, hw, hw, C, device=dev, generator=gen).bfloat16()
        for mode, shift in (("border", 0.0), ("zeros", 0.3)):
            grid = train_grid(B, TRAIN_RAYS, 64, shift, gen, dev)
            got = bs.bilinear_sample(table, grid, mode)
            mx = errors(got, bs.bilinear_sample_plain(table, grid, mode))[0]
            good = mx == 0.0
            ok &= good
            ms = cuda_ms(lambda: bs.bilinear_sample(table, grid, mode))
            # diagnostic: the kernel alone, without the wrapper's host time
            dms = device_ms(lambda: bs.bilinear_sample(table, grid, mode), "multilevel_sample_kernel", launches=1)
            pms = cuda_ms(lambda: bs.bilinear_sample_plain(table, grid, mode), reps=3, inner=1)
            nchw = table.float().permute(0, 3, 1, 2).contiguous()
            g4 = grid[:, None]
            lms = cuda_ms(lambda: F.grid_sample(nchw, g4, mode="bilinear", padding_mode=mode, align_corners=False))
            P = grid.shape[1]
            bms, _ = bound(table.numel() * 2 + grid.numel() * 4 + B * P * C * 2, 0, BF16_FLOPS)
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
                acc[k] += v
            acc["max_abs_err"] = max(acc["max_abs_err"], mx)
            log(f"[kernels] K1 bilinear_sample {hw}x{hw}x{C} {mode:6s} B={B} P={P}: max_abs {mx:.3e} (bound 0: "
                f"the same f32 arithmetic) {'ok' if good else 'FAIL'}; kernel {ms:.4f} ms (device time under the "
                f"profiler {dms:.4f} ms), plain {pms:.3f} ms, F.grid_sample (f32 NCHW) {lms:.3f} ms, "
                f"bound {bms:.4f} ms (bytes)")
            del nchw
    summary["bilinear_sample"] = dict(acc, bound_by="bytes")
    ok &= phase_multilevel(dev, summary, gen)

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

    ok &= phase_split_dense(dev, summary, gen, card)

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
    ok &= phase_fusion_kernels(dev, summary, gen)
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")


# K2's row counts: every shape the paths launch (bf16: cf[16,4] stage A and
# B, single stage and evaluation, the train step, and stage A less 37 rows,
# a ragged last tile), and the exact path's f32 call (the test entry's
# default: chunk 4096, S 64, 2 view rows)
K2_CASES = (("stage A", torch.bfloat16, 1048576), ("stage B", torch.bfloat16, 262144),
            ("single stage / eval", torch.bfloat16, 4194304), ("train step", torch.bfloat16, 147456),
            ("stage A - 37 (ragged)", torch.bfloat16, 1048576 - 37), ("exact eval", torch.float32, 524288))


def phase_split_dense(dev, summary, gen, card: str) -> bool:
    """K2 at every row count in K2_CASES against its plain version (bf16
    max-rel 1e-2, f32 1e-4), timed beside its plain version, the library
    call that computes the same function (addmm + relu + matmul on the
    concatenated input) and, for information, that call on the input
    zero-padded to K = 840 (16-byte rows).  Stage A goes to the summary as
    split_dense_relu, the f32 case as split_dense_relu_f32."""
    from coponerf_tpu_torch.ops.split_matmul import split_dense_relu, split_dense_relu_plain

    ok = True
    W = torch.randn(835, 832, device=dev, generator=gen) / 835 ** 0.5
    bias = torch.randn(832, device=dev, generator=gen) * 0.1
    fk = torch.randn(832, 128, device=dev, generator=gen) / 832 ** 0.5
    for label, dtype, M in K2_CASES:
        parts = [torch.randn(1, M, w_, device=dev, generator=gen).to(dtype) for w_ in (256, 256, 256, 64)]
        parts.append(torch.tanh(torch.randn(1, M, 3, device=dev, generator=gen)).to(dtype))
        with torch.no_grad():
            out, k = split_dense_relu(parts, W, bias, fk)
            pout, pk = split_dense_relu_plain(parts, W, bias, fk)
            tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
            e_out, e_k = errors_by_rows(out, pout), errors_by_rows(k, pk)
            del out, k, pout, pk
            good = e_out[2] < tol and e_k[2] < tol
            ok &= good
            ms = cuda_ms(lambda: split_dense_relu(parts, W, bias, fk))
            pms = cuda_ms(lambda: split_dense_relu_plain(parts, W, bias, fk), reps=3, inner=1)
            Wd, bd, fkd = W.to(dtype), bias.to(dtype), fk.to(dtype)
            x = torch.cat(parts, dim=-1).reshape(-1, 835)
            lms = cuda_ms(lambda: torch.matmul(torch.relu(torch.addmm(bd, x, Wd)), fkd))
            x = torch.nn.functional.pad(x, (0, 5))
            Wp = torch.nn.functional.pad(Wd, (0, 0, 0, 5))
            lms_pad = cuda_ms(lambda: torch.matmul(torch.relu(torch.addmm(bd, x, Wp)), fkd))
            del x, Wp
        flops = 2 * M * (835 * 832 + 832 * 128)
        esz = 2 if dtype == torch.bfloat16 else 4
        nbytes = M * 835 * esz + (835 * 832 + 832 * 128) * esz + 832 * 4 + M * (832 + 128) * esz
        bms, bby = bound(nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
        tflops = flops / (ms * 1e-3) / 1e12
        log(f"[kernels] K2 split_dense_relu {str(dtype)[6:]} {label} M={M}: out max_abs {e_out[0]:.3e} rel "
            f"{e_out[2]:.3e}, k max_abs {e_k[0]:.3e} rel {e_k[2]:.3e} (bound max-rel {tol:g}) "
            f"{'ok' if good else 'FAIL'}; kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s, {bms / ms:.3f} of the bound), "
            f"plain {pms:.3f} ms, addmm+relu+matmul {lms:.3f} ms, bound {bms:.3f} ms ({bby}) [{card}]")
        log(f"[kernels] K2 {str(dtype)[6:]} {label}: for information, addmm+relu+matmul on the input zero-padded "
            f"to K = 840: {lms_pad:.3f} ms (unpadded {lms:.3f} ms)")
        entry = dict(max_abs_err=max(e_out[0], e_k[0]), ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bms,
                     bound_by=bby)
        if label == "stage A":
            summary["split_dense_relu"] = entry
        elif dtype == torch.float32:
            summary["split_dense_relu_f32"] = entry
        del parts
        torch.cuda.empty_cache()
    return ok



def phase_multilevel(dev, summary, gen) -> bool:
    """K8a on the render's four levels at stage A's points (16 x 32768 per
    view row) for both sample sets, against its plain version and against
    the four one-level launches (K1, ``bilinear_sample``) it replaces, bit
    for bit; timed in turns with those four launches.  K8b on the 256^2
    level at the same points, f32 output, bit for bit against its plain
    version (the same f32 arithmetic, no rounding to bf16)."""
    import torch.nn.functional as F

    from coponerf_tpu_torch.ops import bilinear_sample as bs

    ok = True
    levels = ((16, 256), (32, 256), (64, 256), (IMAGE, 64))
    tables = [torch.randn(2, hw, hw, C, device=dev, generator=gen).bfloat16() for hw, C in levels]
    acc = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    k1_ms = 0.0
    for mode, shift in (("border", 0.0), ("zeros", 0.4)):
        grid = epipolar_grid(CHUNK, 16, shift, gen, dev)
        tabs = tables if mode == "border" else [t.flip(0).contiguous() for t in tables]
        got = bs.multilevel_sample(tabs, grid, mode)
        mx_plain = max(errors(o, r)[0] for o, r in zip(got, bs.multilevel_sample_plain(tabs, grid, mode)))
        mx_k1 = max(errors(o, bs.bilinear_sample(t, grid, mode))[0] for o, t in zip(got, tabs))
        good = mx_plain == 0.0 and mx_k1 == 0.0
        ok &= good
        del got
        ms, kms = cuda_ms_in_turns([lambda: bs.multilevel_sample(tabs, grid, mode),
                                    lambda: [bs.bilinear_sample(t, grid, mode) for t in tabs]])
        pms = cuda_ms(lambda: bs.multilevel_sample_plain(tabs, grid, mode), reps=3, inner=1)
        nchw = [t.float().permute(0, 3, 1, 2).contiguous() for t in tabs]
        g4 = grid[:, None]
        lms = cuda_ms(lambda: [F.grid_sample(x, g4, mode="bilinear", padding_mode=mode, align_corners=False)
                               for x in nchw])
        P = grid.shape[1]
        bms, _ = bound(sum(t.numel() * 2 + 2 * P * t.shape[-1] * 2 for t in tabs) + grid.numel() * 4, 0, BF16_FLOPS)
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
            acc[k] += v
        k1_ms += kms
        acc["max_abs_err"] = max(acc["max_abs_err"], mx_plain, mx_k1)
        log(f"[kernels] K8a multilevel_sample 4 levels {mode:6s} P={P}: max_abs vs plain {mx_plain:.3e}, vs four "
            f"one-level K1 launches {mx_k1:.3e} (bound 0: the same arithmetic) {'ok' if good else 'FAIL'}; kernel "
            f"{ms:.3f} ms, the four K1 launches in turns {kms:.3f} ms, plain {pms:.3f} ms, four F.grid_sample "
            f"(f32 NCHW) {lms:.3f} ms, bound {bms:.3f} ms (bytes)")
        del nchw
    log(f"[kernels] K8a both sample sets of stage A: kernel {acc['ms']:.3f} ms (2 launches) against K1 "
        f"{k1_ms:.3f} ms (8 launches), bound {acc['bound_ms']:.3f} ms")
    summary["multilevel_sample"] = dict(acc, bound_by="bytes")

    acc = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    table = tables[-1]
    for mode, shift in (("border", 0.0), ("zeros", 0.4)):
        grid = epipolar_grid(CHUNK, 16, shift, gen, dev)
        got = bs.grid_sample_window(table, grid, mode)
        mx = errors(got, bs.grid_sample_window_plain(table, grid, mode))[0]
        good = mx == 0.0
        ok &= good
        del got
        ms = cuda_ms(lambda: bs.grid_sample_window(table, grid, mode))
        pms = cuda_ms(lambda: bs.grid_sample_window_plain(table, grid, mode), reps=3, inner=1)
        nchw = table.float().permute(0, 3, 1, 2).contiguous()
        g4 = grid[:, None]
        lms = cuda_ms(lambda: F.grid_sample(nchw, g4, mode="bilinear", padding_mode=mode, align_corners=False))
        P, C = grid.shape[1], table.shape[-1]
        bms, _ = bound(table.numel() * 2 + grid.numel() * 4 + 2 * P * C * 4, 0, BF16_FLOPS)
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms)):
            acc[k] += v
        acc["max_abs_err"] = max(acc["max_abs_err"], mx)
        log(f"[kernels] K8b grid_sample_window {IMAGE}x{IMAGE}x{C} {mode:6s} P={P} f32 out: max_abs {mx:.3e} "
            f"(bound 0: the same f32 arithmetic) {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms, plain "
            f"{pms:.3f} ms, F.grid_sample (f32 NCHW) {lms:.3f} ms, bound {bms:.3f} ms (bytes)")
        del nchw
    summary["grid_sample_window"] = dict(acc, bound_by="bytes")
    del tables, table
    torch.cuda.empty_cache()
    return ok


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
    largest value; the kernels sum in strips and merge with a rescale and
    take exp2 with 1/beta folded into the scale, the plain versions sum
    whole rows and take exp(x / beta): f32 round-off either way.  The
    forward must be one device launch a call (under the profiler) and give
    the same bits on a second call."""
    from coponerf_tpu_torch.bench_kernels import kernel_profile
    from coponerf_tpu_torch.ops import soft_argmax as sa

    ok = True
    n = (IMAGE // 4) ** 2
    for B in (TRAIN_BATCH, 1):
        c = cosine_volume(B, n, gen, dev)
        got = sa.soft_argmax_stats(c)
        ref = sa.soft_argmax_stats_plain(c, 0.02)
        again = sa.soft_argmax_stats(c)
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        mx = max(errors(g[:, 2:] / g[:, 1:2], r[:, 2:] / r[:, 1:2])[0] for g, r in zip(got, ref))
        zrel = max(errors(g[:, 1], r[:, 1])[2] for g, r in zip(got, ref))
        # device launches a call (a profile that dropped records is taken again)
        prof = kernel_profile(lambda: sa.soft_argmax_stats(c), "soft_argmax")
        per_call = sum(v[1] for v in prof.values()) if prof else float("nan")
        dms = sum(v[0] for v in prof.values()) if prof else float("nan")
        good = mx <= 1e-4 and same and per_call == 1
        ok &= good
        ms = cuda_ms(lambda: sa.soft_argmax_stats(c))
        pms = cuda_ms(lambda: sa.soft_argmax_stats_plain(c, 0.02), reps=3, inner=1)
        # c read once, the statistics and coordinates read/written once; per
        # element and direction: subtract, scale, exp, three multiply-adds
        bms, bby = bound(c.numel() * 4 + B * 4 * 2 * n * 4 + 4 * n * 4, 16 * c.numel(), F32_FLOPS)
        log(f"[kernels] K5 soft_argmax_stats B={B} Q=S={n}: mappings max_abs {mx:.3e} (bound 1e-4), partition "
            f"max-rel {zrel:.3e}, a second call bit for bit {same}, device launches a call {per_call:g} "
            f"(expected 1: {sorted(prof)}) {'ok' if good else 'FAIL'}; kernel {ms:.4f} ms "
            f"({c.numel() * 4 / (ms * 1e-3) / 1e12:.2f} TB/s of c, {bms / ms:.2f} of the bound; device time "
            f"under the profiler {dms:.4f} ms), plain {pms:.3f} ms, library none (no one PyTorch call computes "
            f"both softmax expectations), bound {bms:.4f} ms ({bby})")
        stats_entry = dict(max_abs_err=mx, ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby)

        rowf = torch.cat([ref[0][:, :2], ref[0][:, 2:] / ref[0][:, 1:2]], dim=1)
        colf = torch.cat([ref[1][:, :2], ref[1][:, 2:] / ref[1][:, 1:2]], dim=1)
        dr = torch.randn(B, 2, n, device=dev, generator=gen)
        dcol = torch.randn(B, 2, n, device=dev, generator=gen)
        del got, ref, again
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


def scaled_weights(shapes, gen, dev):
    """Seeded f32 weights: matrices scaled by 1/sqrt(fan-in), biases 0.1."""
    return {k: torch.randn(*shp, device=dev, generator=gen) * (0.1 if len(shp) == 1 else shp[0] ** -0.5)
            for k, shp in shapes}


def close_at(got: torch.Tensor, ref: torch.Tensor, max_rel: float, mean_rel: float):
    """(max error, mean error, largest |ref|, within the bounds): errors
    relative to the reference's largest magnitude."""
    d = (got.float() - ref.float()).abs()
    top = ref.abs().max().item()
    mx, mn = d.max().item(), d.mean().item()
    return mx, mn, top, mx <= max_rel * top and mn <= mean_rel * top


K7_WEIGHTS = (("fk_bias", (128,)), ("wk2", (128, 128)), ("bk2", (128,)), ("wq", (16, 128)), ("bq", (128,)),
              ("wq2", (128, 128)), ("bq2", (128,)), ("wra", (128, 128)), ("wrb", (16, 128)), ("br", (128,)),
              ("wr2", (128, 128)), ("br2", (128,)))


def phase_fusion_kernels(dev, summary, gen) -> bool:
    """K7's two kernels at the stage-A and stage-B shapes (R 2, T = 16 or
    4 x 32768; the JSON line carries stage A) and K6
    on a single-stage chunk (B 1, V 2, S 64, N 32768) and on 4096 rays at
    S 80 (V*S 160), each against its plain version.  Bounds (tests/test_torch_attn_embed.py and
    tests/test_torch_render_core.py): the same bf16 operands with f32 sums
    in another order, where a hidden activation next to a bf16 rounding
    boundary may round the other way: K7 logits 1e-3 of the largest
    magnitude elementwise and 1e-5 in the mean; K6 z_sum 3e-3 and 1e-4 of
    its largest magnitude, at_wt 1e-3 and 1e-5 absolute."""
    from coponerf_tpu_torch.ops import attn_embed as ae
    from coponerf_tpu_torch.ops import render_core as rc

    ok = True
    N, R = CHUNK, 2
    w = scaled_weights(K7_WEIGHTS, gen, dev)
    # cf[16, 4]'s two stages: S 16 (stage A, the JSON line's shape) and S 4
    for stage, S in (("A", 16), ("B", 4)):
        T = S * N
        ka = torch.randn(R, T, 128, device=dev, generator=gen).bfloat16()
        kbs = torch.randn(R, T, 128, device=dev, generator=gen).bfloat16()
        lc = torch.randn(R, T, 16, device=dev, generator=gen).bfloat16()
        args1 = (ka, kbs, lc, *(w[k] for k in ("fk_bias", "wk2", "bk2", "wq", "bq", "wq2", "bq2")))
        mx, mn, top, good = close_at(ae.round1_logits(*args1), ae.round1_logits_plain(*args1), 1e-3, 1e-5)
        ok &= good
        ms = cuda_ms(lambda: ae.round1_logits(*args1))
        pms = cuda_ms(lambda: ae.round1_logits_plain(*args1), reps=3, inner=1)
        M = R * T
        flops = 2 * M * (128 * 128 + 16 * 128 + 128 * 128)
        bms, bby = bound(2 * M * 128 * 2 + M * 16 * 2 + M * 4, flops, BF16_FLOPS)
        log(f"[kernels] K7 round1_logits stage {stage} R={R} T={T}: max_abs {mx:.3e} mean_abs {mn:.3e} of largest "
            f"{top:.3g} (bound 1e-3 / 1e-5 of it) {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms "
            f"({(2 * M * 128 * 2) / (ms * 1e-3) / 1e12:.2f} TB/s of keys), plain {pms:.3f} ms, library none (no one "
            f"PyTorch call computes the chain), bound {bms:.3f} ms ({bby})")
        if stage == "A":
            summary["round1_logits"] = dict(max_abs_err=mx, ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
                                            bound_by=bby)
        else:
            summary["round1_logits"]["max_abs_err"] = max(summary["round1_logits"]["max_abs_err"], mx)
        del ka, kbs, args1

        ze = torch.randn(1, N, 128, device=dev, generator=gen)
        args2 = (ze, lc, *(w[k] for k in ("wq", "bq", "wq2", "bq2", "wra", "wrb", "br", "wr2", "br2")))
        mx, mn, top, good = close_at(ae.round2_logits(*args2, S, R), ae.round2_logits_plain(*args2, S, R),
                                     1e-3, 1e-5)
        ok &= good
        ms = cuda_ms(lambda: ae.round2_logits(*args2, S, R))
        pms = cuda_ms(lambda: ae.round2_logits_plain(*args2, S, R), reps=3, inner=1)
        # the least work: ze @ wra once per ray, the two chains per token
        flops = 2 * M * (2 * 16 * 128 + 2 * 128 * 128) + 2 * N * 128 * 128
        bms, bby = bound(ze.numel() * 4 + lc.numel() * 2 + M * 4, flops, BF16_FLOPS)
        log(f"[kernels] K7 round2_logits stage {stage} B=1 V={R} S={S} N={N}: max_abs {mx:.3e} mean_abs {mn:.3e} of "
            f"largest {top:.3g} (bound 1e-3 / 1e-5 of it) {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms "
            f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {pms:.3f} ms, library none, bound {bms:.3f} ms "
            f"({bby})")
        if stage == "A":
            summary["round2_logits"] = dict(max_abs_err=mx, ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
                                            bound_by=bby)
        else:
            summary["round2_logits"]["max_abs_err"] = max(summary["round2_logits"]["max_abs_err"], mx)
        del ze, lc, args2
        torch.cuda.empty_cache()

    # K6: one single-stage chunk, samples as K1 gives them (relu'd latents),
    # then a chunk of V*S 160 (two 128-token tiles a sample set, the second
    # ragged) against the plain version only
    from coponerf_tpu_torch.bench_kernels import render_core_inputs

    V = 2

    def k6_check(args, S, N):
        with torch.no_grad():
            z, at = rc.render_core(*args)
            pz, pat = rc.render_core_plain(*args[:-3], S=S, V=V, n_rays=N)
        zmx, zmn, ztop, zgood = close_at(z, pz, 3e-3, 1e-4)
        da = (at - pat).abs()
        amx, amn = da.max().item(), da.mean().item()
        good = zgood and amx <= 1e-3 and amn <= 1e-5
        return (f"z_sum max_abs {zmx:.3e} mean_abs {zmn:.3e} of largest {ztop:.3g} (bound 3e-3 / 1e-4 of it), at_wt "
                f"max_abs {amx:.3e} mean_abs {amn:.3e} (bound 1e-3 / 1e-5) {'ok' if good else 'FAIL'}",
                good, max(zmx, amx))

    S = 64
    args = render_core_inputs(dev, S, V, N)
    msg, good, err = k6_check(args, S, N)
    ok &= good
    ms = cuda_ms(lambda: rc.render_core(*args), reps=3, inner=1)
    pms = cuda_ms(lambda: rc.render_core_plain(*args[:-3], S=S, V=V, n_rays=N), reps=1, inner=1)
    tok = V * S * N
    flops = (2 * tok * 2 * 835 * 832 + 2 * tok * 2 * 832 * 128           # W1 on both sets, the key folds
             + tok * 2 * (3 * 128 * 128 + 2 * 16 * 128)                 # kv, ce, qre chains
             + 2 * 2 * tok * 2 * 832                                    # both rounds' weighted sums
             + N * 2 * (2 * 2 * 832 * 416 + 416 * 128 + 128 * 128))     # value, ze, ze @ wra per ray
    nbytes = (2 * tok * 832 * 2 + 2 * tok * 3 * 2 + tok * 16 * 2 + N * (416 + V * S) * 4
              + sum(x.numel() for x in args[5:-3]) * 2)
    bms, bby = bound(nbytes, flops, BF16_FLOPS)
    log(f"[kernels] K6 render_core B=1 V={V} S={S} N={N}: {msg}; kernel {ms:.3f} ms "
        f"({flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s of the {flops:.3g} the function needs), plain {pms:.3f} ms, "
        f"library none (no one PyTorch call computes it), bound {bms:.3f} ms ({bby}; bytes {nbytes / 1e9:.2f} GB); "
        f"device scratch {rc.scratch_bytes(1, V, S, N) / 1e6:.1f} MB (a slot a ray of a block's group of "
        f"{rc.group_rays(V * S)})")
    summary["render_core"] = dict(max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms, bound_by=bby)
    del args
    torch.cuda.empty_cache()
    S, N2 = 80, 4096
    msg, good, _ = k6_check(render_core_inputs(dev, S, V, N2, seed=1), S, N2)
    ok &= good
    log(f"[kernels] K6 render_core B=1 V={V} S={S} N={N2} (V*S 160: two tiles a sample set): {msg}")
    torch.cuda.empty_cache()
    return ok


def profile_step(step, card: str, label: str) -> None:
    """One train step (or render request) under torch.profiler: wall time,
    device busy share (kernel time over wall) and device time by kernel,
    largest first."""
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
    log(f"[profile] {label}, one call: wall {wall_ms:.1f} ms under the profiler, device kernel time {total:.1f} ms "
        f"(busy {total / wall_ms:.2f}), {sum(e.count for e in kernels)} kernel launches [{card}]")
    mine = ("multilevel_sample_kernel", "k4::order_kernel", "k4::merge_kernel", "split_dense_relu",
            "weighted_sum_kernel", "soft_argmax_stats_kernel", "soft_argmax_bwd_kernel", "round1_kernel",
            "round2_kernel", "render_core_kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        tag = " (port kernel)" if any(m in e.key for m in mine) else ""
        log(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms {e.count:5d}x  {e.key[:90]}{tag}")
    for m in mine:
        t = sum(e.self_device_time_total for e in kernels if m in e.key) / 1e3
        n = sum(e.count for e in kernels if m in e.key)
        log(f"[profile]   port kernel {m}: {t:.2f} ms in {n} launches ({t / max(total, 1e-9):.3f} of kernel time)")


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


class PairSet:
    """In-memory evaluation dataset: synthetic 256^2 stereo pairs with full
    query images, one (batch, gt, overlap) item per seed.  ``turn_deg``
    turns each query camera about its up axis, so that many rays leave both
    context frusta (a sparse valid mask)."""

    def __init__(self, seeds, turn_deg: float = 0.0):
        from coponerf_tpu_torch.data.synthetic import make_batch

        th = np.deg2rad(turn_deg)
        turn = np.eye(4, dtype=np.float32)
        turn[0, 0], turn[0, 2], turn[2, 0], turn[2, 2] = np.cos(th), np.sin(th), -np.sin(th), np.cos(th)
        self.items = []
        for seed in seeds:
            b, g = make_batch(batch_size=1, image_size=IMAGE, n_rays=IMAGE * IMAGE, seed=seed,
                              full_query_image=True)
            b = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in b.items()}
            b["query"]["cam2world"] = (b["query"]["cam2world"] @ turn).astype(np.float32)
            self.items.append((b, {k: v[0] for k, v in g.items()}, np.float32(1.0)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def phase_eval(model, dev, card: str, count, launches) -> None:
    """The evaluation harness at full width in the entry's fast config
    (``model``: single stage, S 64) over two synthetic pairs, unpruned and
    with ``prune_invalid``; a pair with a turned query camera, whose pruned
    render skips a chunk and scatters the rendered rays back, against its
    unpruned render; then the harness's assembled rgb of the first pair
    against a direct chunked render from the same encode."""
    import warnings

    from coponerf_tpu_torch.eval.harness import evaluate, make_renderer
    from coponerf_tpu_torch.models import batch_to_torch

    ds = PairSet((0, 1))
    accs = {}
    for path, prune in (("eval", False), ("eval_pruned", True)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # no LPIPS weights: the column is absent
            accs[path] = count(path, lambda: evaluate(model, ds, batch_size=1, chunk=CHUNK, image_size=IMAGE,
                                                      verbose=False, prune_invalid=prune))
    keys = ("psnr", "ssim", "rot", "trans", "angle_trans")
    for path, acc in accs.items():
        m = acc.metrics["all"]
        for i, rps in enumerate(m["rays_per_sec"]):
            log(f"[eval] {path} pair {i}: {IMAGE * IMAGE / rps * 1e3:.1f} ms/image encode + render "
                f"({rps:.0f} rays/s), " + ", ".join(f"{k} {m[k][i]:.6g}" for k in keys) + f" [{card}]")
        log(f"[eval] {path} kernel launches: {launches[path]}")
        if not all(np.isfinite(v) for k in keys + ("rays_per_sec",) for v in m[k]) or len(m["psnr"]) != 2:
            raise RuntimeError(f"{path}: bad metrics {dict(m)}")
        if launches[path]["multilevel_sample"] == 0 or launches[path]["bilinear_sample"] != 0:
            raise RuntimeError(f"{path}: the render did not sample through K8a alone")
    n_chunks = IMAGE * IMAGE // CHUNK
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(multilevel_sample=2 * n_chunks * 2, split_dense_relu=2 * n_chunks * 2,
                    weighted_sum_smaj=4 * n_chunks * 2)
    if launches["eval"] != expected:
        raise RuntimeError(f"eval launches {launches['eval']}, expected {expected}")
    dq = max(abs(a - b) for k in ("psnr", "ssim")
             for a, b in zip(accs["eval"].metrics["all"][k], accs["eval_pruned"].metrics["all"][k]))
    log(f"[eval] prune_invalid vs unpruned: PSNR/SSIM max abs difference {dq:.3e} (bound 1e-6) "
        f"{'ok' if dq <= 1e-6 else 'FAIL'}")
    if dq > 1e-6:
        raise RuntimeError("pruned and unpruned evaluation disagree")
    sparse_pair(model, dev, count, launches)
    one = PairSet((0,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        profile_step(lambda: evaluate(model, one, batch_size=1, chunk=CHUNK, image_size=IMAGE, verbose=False),
                     card, "eval, one pair (loader, encode, render, host metrics)")
    eval_with_summaries(model, one, card)

    encode, render_image = make_renderer(model, CHUNK)
    batch = batch_to_torch(ds[0][0], dev)
    batch = {k: {kk: vv[None] for kk, vv in v.items()} for k, v in batch.items()}
    n_rays = batch["query"]["uv"].shape[2]
    state = encode(batch)
    assembled = render_image(batch, state, n_rays)["rgb"]
    with torch.no_grad():
        direct = torch.cat([model.render(slice_chunk(batch, lo, lo + CHUNK), state, val=True)["rgb"]
                            for lo in range(0, n_rays, CHUNK)], dim=2)
    same = torch.equal(assembled, direct)
    log(f"[eval] harness rgb of pair 0 vs a direct chunked render from the same encode: "
        f"{'bit for bit' if same else 'DIFFERENT'} (max abs {(assembled - direct).abs().max().item():.3e})")
    if not same:
        raise RuntimeError("the harness's assembled image differs from the direct render")


def eval_with_summaries(model, one, card: str) -> None:
    """``evaluate`` of one pair with the test entry's ``MetricLogger``
    (TensorBoard where it imports, else ten PNG panels) against none, in
    turns: what the summaries add to an image, on the host."""
    import shutil
    import tempfile
    import warnings

    from coponerf_tpu_torch.eval.harness import evaluate
    from coponerf_tpu_torch.ops import _build
    from coponerf_tpu_torch.training.trainer import MetricLogger

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    logdir = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    times = {"none": [], "logger": []}
    try:
        logger = MetricLogger(logdir)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                for i in range(4):
                    for key in ("none", "logger") if i % 2 == 0 else ("logger", "none"):
                        t0 = time.perf_counter()
                        evaluate(model, one, batch_size=1, chunk=CHUNK, image_size=IMAGE, verbose=False,
                                 logger=logger if key == "logger" else None)
                        times[key].append(time.perf_counter() - t0)
        finally:
            logger.close()
        pngs = sorted(os.listdir(os.path.join(logdir, "images"))) if logger._tb is None else []
        scalars = [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]
    finally:
        shutil.rmtree(logdir)
    kept = "TensorBoard" if logger._tb is not None else f"{len(pngs)} PNG panels"
    med = {k: statistics.median(v[1:]) * 1e3 for k, v in times.items()}
    log(f"[eval] evaluate of one pair with the entry's MetricLogger ({kept}) against none, in turns: "
        f"{med['logger']:.1f} ms an image against {med['none']:.1f} (medians of 3 after one warm-up each: "
        + "; ".join(f"{k} " + ", ".join(f"{t * 1e3:.1f}" for t in v) for k, v in times.items())
        + f"), the summaries {med['logger'] - med['none']:.1f} ms an image [{card}]")
    if logger._tb is None and len(pngs) != 10:
        raise RuntimeError(f"the logger wrote {pngs}, expected ten panels")
    if len(scalars) != 4 or not all(np.isfinite(v) for row in scalars for v in row.values()):
        raise RuntimeError(f"bad summary scalars {scalars}")


def phase_eval_exact(dev, card: str, count, launches) -> None:
    """One synthetic pair through ``evaluate`` in the test entry's default
    config: exact (f32, fast_sampling off), one stage of S 64, 4096-ray
    chunks, batch 1, from the same seeded weights.  Its W1 is K2's f32
    kernel, two launches a chunk; no other kernel of the port runs."""
    import warnings

    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.eval.harness import evaluate
    from coponerf_tpu_torch.models import CoPoNeRF
    from coponerf_tpu_torch.utils.init import init_weights

    chunk = 4096
    model = init_weights(CoPoNeRF(ModelConfig(fast_sampling=False, compute_dtype="float32"), image_size=IMAGE)
                         .eval(), seed=0).to(dev)
    ds = PairSet((0,))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # no LPIPS weights: the column is absent
        run = lambda: evaluate(model, ds, batch_size=1, chunk=chunk, image_size=IMAGE, verbose=False)
        run()                                # warm-up
        m = count("eval_exact", run).metrics["all"]
    keys = ("psnr", "ssim", "rot", "trans", "angle_trans")
    rps = m["rays_per_sec"][0]
    log(f"[eval] eval_exact (f32, chunk {chunk}, S 64) pair 0: {IMAGE * IMAGE / rps * 1e3:.1f} ms/image encode + "
        f"render ({rps:.0f} rays/s), " + ", ".join(f"{k} {m[k][0]:.6g}" for k in keys) + f" [{card}]")
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(split_dense_relu_f32=2 * IMAGE * IMAGE // chunk)
    log(f"[eval] eval_exact kernel launches: {launches['eval_exact']} (expected {expected})")
    if not all(np.isfinite(v) for k in keys + ("rays_per_sec",) for v in m[k]):
        raise RuntimeError(f"eval_exact: bad metrics {dict(m)}")
    if launches["eval_exact"] != expected:
        raise RuntimeError("the exact evaluation did not run W1 through K2's f32 kernel as expected")


def sparse_pair(model, dev, count, launches) -> None:
    """Seed 0's pair with the query camera turned by the first of 60, 90,
    120, 150 and 180 degrees at which at most 32768 of its 65536 rays are
    valid (the mask depends on the pose the random weights estimate):
    the pruned render then renders one chunk, moves the valid rays to the
    front and scatters them back.  Its rgb must equal the unpruned render's
    (invalid rays white either way) and its metrics the unpruned ones."""
    import warnings

    from coponerf_tpu_torch.eval.harness import evaluate, make_renderer
    from coponerf_tpu_torch.models import batch_to_torch

    n_rays = IMAGE * IMAGE
    encode, render_plain = make_renderer(model, CHUNK, keys=("rgb",))
    _, render_pruned = make_renderer(model, CHUNK, keys=("rgb",), prune_invalid=True)
    for deg in (60, 90, 120, 150, 180):
        ds = PairSet((0,), turn_deg=deg)
        batch = batch_to_torch({k: {kk: vv[None] for kk, vv in v.items()} for k, v in ds[0][0].items()}, dev)
        state = encode(batch)
        n_valid = int(model.valid_ray_mask(batch, state, val=True).sum())
        if n_valid <= n_rays - CHUNK:
            break
    else:
        raise RuntimeError(f"no turned query camera gave a sparse valid mask (last: {n_valid} of {n_rays} valid)")
    plain = render_plain(batch, state, n_rays)["rgb"]
    pruned = count("eval_sparse_pruned", lambda: render_pruned(batch, state, n_rays)["rgb"])
    drgb = (pruned - plain).abs().max().item()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        accs = [evaluate(model, ds, batch_size=1, chunk=CHUNK, image_size=IMAGE, verbose=False, prune_invalid=p)
                for p in (False, True)]
    dq = max(abs(a - b) for k in ("psnr", "ssim")
             for a, b in zip(accs[0].metrics["all"][k], accs[1].metrics["all"][k]))
    got = launches["eval_sparse_pruned"]
    good = (render_pruned.last_n_rendered == CHUNK and drgb <= 1e-5 and dq <= 1e-6
            and got["multilevel_sample"] == 2 and got["bilinear_sample"] == 0)
    log(f"[eval] query turned {deg} deg: {n_valid} of {n_rays} rays valid; pruned render of "
        f"{render_pruned.last_n_rendered} rays (K8a launches {got['multilevel_sample']}, expected 2) vs the "
        f"unpruned render: rgb max abs {drgb:.3e} (bound 1e-5), PSNR/SSIM max abs difference {dq:.3e} (bound "
        f"1e-6); PSNR {accs[1].metrics['all']['psnr'][0]:.6g} {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the pruned render of the sparse pair disagrees with the unpruned one")


def phase_camera_path(model, batch, card: str, count, launches) -> None:
    """The serving path: 8 frames on the path between the request's two
    context cameras from one encode, each a whole 256^2 image in 32768-ray
    chunks in the fast config (cf[16, 4]), through the user's entry
    ``render_trajectory`` (warm-up, then timed with its encode), then the
    frame loop alone from one encode; launch counts per frame (K8a 8, K2 8,
    K3 16) and one frame against a direct chunked render at its pose, bit
    for bit."""
    from coponerf_tpu_torch.eval.trajectory import interpolate_poses, render_poses, render_trajectory

    n_frames, n_rays = 8, IMAGE * IMAGE
    batch_np = {k: {kk: vv.cpu().numpy() for kk, vv in v.items()} for k, v in batch.items()}
    render_trajectory(model, batch_np, n_frames=2, image_size=IMAGE, chunk=CHUNK)      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = count("camera_path", lambda: render_trajectory(model, batch_np, n_frames=n_frames, image_size=IMAGE,
                                                            chunk=CHUNK))
    path_s = time.perf_counter() - t0
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.encode(batch)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
    c2w = batch["context"]["cam2world"][0].cpu().numpy()
    poses = interpolate_poses(c2w[0], c2w[1], n_frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop = render_poses(model, batch, state, poses, CHUNK)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    per_frame = dict.fromkeys(KERNELS, 0)
    n_chunks = n_rays // CHUNK
    per_frame.update(multilevel_sample=4 * n_chunks, split_dense_relu=4 * n_chunks, weighted_sum_smaj=8 * n_chunks)
    expected = {k: v * n_frames for k, v in per_frame.items()}
    log(f"[path] {n_frames} frames of {IMAGE}^2 through render_trajectory (one encode, cf[16, 4], chunks of {CHUNK}): "
        f"{path_s * 1e3:.1f} ms, encode included; the frame loop alone {loop_s * 1e3:.1f} ms from one encode of "
        f"{enc_s * 1e3:.1f} ms: {loop_s / n_frames * 1e3:.1f} ms/frame, {n_frames / loop_s:.2f} frames/s [{card}]")
    log(f"[path] kernel launches: {launches['camera_path']} (expected {expected}: per frame {per_frame})")
    if launches["camera_path"] != expected:
        raise RuntimeError("a kernel of the camera path was not launched as expected")
    if frames.shape != (n_frames, IMAGE, IMAGE, 3) or not np.isfinite(frames).all():
        raise RuntimeError(f"bad camera-path frames: shape {frames.shape}")
    k = 5
    with torch.no_grad():
        q = dict(batch["query"], cam2world=torch.as_tensor(poses[k], device=batch["query"]["uv"].device)[None, None])
        posed = {"context": batch["context"], "query": q}
        direct = torch.cat([model.render(slice_chunk(posed, lo, lo + CHUNK), state, val=True)["rgb"]
                            for lo in range(0, n_rays, CHUNK)], dim=2)[0, 0]
    same = torch.equal(loop[k], direct)
    log(f"[path] frame {k} vs a direct chunked render at its pose from the same encode: "
        f"{'bit for bit' if same else 'DIFFERENT'} (max abs {(loop[k] - direct).abs().max().item():.3e})")
    if not same:
        raise RuntimeError("a camera-path frame differs from the direct render at its pose")


class RecordingLogger:
    """A MetricLogger stand-in that keeps the scalars and the panels."""

    def __init__(self):
        self.scalars, self.images = {}, {}

    def log(self, step, metrics):
        self.scalars.update({k: float(v) for k, v in metrics.items()})

    def log_image(self, step, tag, img):
        self.images[tag] = np.asarray(img)


def phase_validation(state, cfg, card: str, count, launches) -> None:
    """In-training validation (``make_val_fn``, its default 512-ray chunks)
    on the fast train state over one full 256^2 pair: every ``val_*`` term
    finite, the panels captured, the launch counts (single stage: K8a 2,
    K2 2, K3 4 a chunk); then one call under the profiler."""
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.training.validation import make_val_fn

    pair = make_batch(batch_size=1, image_size=IMAGE, n_rays=IMAGE * IMAGE, seed=7, full_query_image=True)
    val_fn = make_val_fn(cfg, [pair], image_size=IMAGE)
    val_fn(state, 0, RecordingLogger())                     # warm-up
    logger = RecordingLogger()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    count("validation", lambda: val_fn(state, 1, logger))
    dt = time.perf_counter() - t0
    n_chunks = IMAGE * IMAGE // 512
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(multilevel_sample=2 * n_chunks, split_dense_relu=2 * n_chunks, weighted_sum_smaj=4 * n_chunks)
    terms = {k: v for k, v in logger.scalars.items() if k.startswith("val_")}
    panels = sorted(logger.images)
    log(f"[validation] one {IMAGE}^2 pair in {n_chunks} chunks of 512: {dt * 1e3:.1f} ms (render, losses and "
        f"panels) [{card}]; " + ", ".join(f"{k} {v:.5g}" for k, v in sorted(terms.items())))
    log(f"[validation] panels: {panels}")
    log(f"[validation] kernel launches: {launches['validation']} (expected {expected})")
    want = {"val_img_loss", "val_ssim_loss", "val_cycle_loss", "val_pose_loss", "val_ent"}
    if not want <= set(terms) or not all(np.isfinite(v) for v in terms.values()):
        raise RuntimeError(f"bad validation terms: {terms}")
    if not {"val_predictions", "val_depth_images", "val_warped_img", "val_epipolar_pred"} <= set(panels):
        raise RuntimeError(f"validation panels missing: {panels}")
    if launches["validation"] != expected:
        raise RuntimeError("a kernel of the validation render was not launched as expected")
    profile_step(lambda: val_fn(state, 2, RecordingLogger()), card, "validation, one 256^2 pair (render, losses, "
                 "panels)")


def phase_checkpoint(state, cfg, batch, card: str, count, launches) -> None:
    """The JAX package's checkpoint (``.npz``, ``utils/jax_checkpoint.py``)
    at full width: phase 6's trained state written as one, read back into
    a fresh state on the card, and written and read through the port's
    ``.pt`` as well; each restored state bit for bit the source (weights,
    BatchNorm statistics, Adam's moments and steps, counters, learning
    rate); one step of each on the same batch (losses bit for bit, grad
    norm 1e-2: K4's atomics; K1 6, K2 2, K4 6); one 32768-ray cf[16, 4]
    chunk of the npz's weights loaded by ``load_weights``, bit for bit the
    source weights' chunk (K8a 4, K2 4, K3 8).  The files go to a
    temporary directory, deleted at the end."""
    import tempfile

    from coponerf_tpu_torch.config import ModelConfig
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.training import checkpoint as ckpt_lib
    from coponerf_tpu_torch.training import trainer
    from coponerf_tpu_torch.utils import jax_checkpoint

    dev = next(state.model.parameters()).device

    def fresh():
        return trainer.create_train_state(cfg, IMAGE, dev, model=CoPoNeRF(cfg.model, image_size=IMAGE))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    t_phase = time.perf_counter()
    icfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4)
    restored, secs, sizes = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for route, save, restore in (("npz", jax_checkpoint.save, ckpt_lib.restore_into),
                                     ("pt", ckpt_lib.save, ckpt_lib.restore_into)):
            path, secs[route + " write"] = timed(lambda: save(tmp, state, state.step))
            sizes[route] = os.path.getsize(path)
            target = fresh()
            restored[route], secs[route + " read"] = timed(lambda: restore(target, path))
            if route == "npz":
                served, secs["npz weights"] = timed(lambda: ckpt_lib.load_weights(
                    CoPoNeRF(icfg, image_size=IMAGE).eval().to(dev), path))
            os.remove(path)
    log(f"[checkpoint] {IMAGE}^2 fast train state after {state.updates} updates, "
        f"{sum(p.numel() for p in state.model.parameters()) / 1e6:.1f} M parameters: JAX .npz "
        f"{sizes['npz'] / 1e6:.1f} MB written in {secs['npz write'] * 1e3:.1f} ms, restored into a fresh state in "
        f"{secs['npz read'] * 1e3:.1f} ms, its weights into a cf[16, 4] model in {secs['npz weights'] * 1e3:.1f} ms; "
        f".pt {sizes['pt'] / 1e6:.1f} MB written in {secs['pt write'] * 1e3:.1f} ms, restored in "
        f"{secs['pt read'] * 1e3:.1f} ms [{card}]")

    src_sd = state.model.state_dict()
    src_named = dict(state.model.named_parameters())
    for route, r in restored.items():
        bad = [k for k, v in r.model.state_dict().items() if not torch.equal(v, src_sd[k])]
        named = dict(r.model.named_parameters())
        for k, p in src_named.items():
            a, b = state.optimizer.state.get(p, {}), r.optimizer.state.get(named[k], {})
            if a.keys() != b.keys() or not all(torch.equal(a[x].cpu(), b[x].cpu()) for x in a):
                bad.append(f"Adam state of {k}")
        counters = [(getattr(r, c), getattr(state, c)) for c in ("step", "updates", "notfinite_count",
                                                                  "total_notfinite")]
        lr = (trainer.learning_rate(cfg, r.updates), trainer.learning_rate(cfg, state.updates))
        good = not bad and all(a == b for a, b in counters) and lr[0] == lr[1]
        log(f"[checkpoint] {route} route restored bit for bit: {len(src_sd)} weights and buffers, Adam state of "
            f"{len(src_named)} parameters, counters {[a for a, _ in counters]}, lr {lr[0]:.6g} "
            f"{'ok' if good else 'FAIL ' + str(bad[:4])}")
        if not good:
            raise RuntimeError(f"the {route} route did not restore the state bit for bit")

    per_step = dict.fromkeys(KERNELS, 0)
    per_step.update(bilinear_sample=6, split_dense_relu=2, onehot_transpose_matmul=6)
    stepped = {}
    for route, r in restored.items():
        path = f"ckpt_step_{route}"
        stepped[route] = count(path, lambda: trainer.train_step(r, batch, cfg))
        log(f"[checkpoint] one step from the {route} state: " + ", ".join(
            f"{k} {float(v):.7g}" for k, v in stepped[route].items()) + f"; launches {launches[path]}")
        if launches[path] != per_step:
            raise RuntimeError(f"{path}: launches {launches[path]}, expected {per_step}")
    a, b = stepped["npz"], stepped["pt"]
    same = [k for k in a if k != "grad_norm" and torch.equal(a[k], b[k])]
    gn = abs(float(a["grad_norm"]) - float(b["grad_norm"])) / float(b["grad_norm"])
    good = len(same) == len(a) - 1 and gn < 1e-2
    log(f"[checkpoint] the two restored states' steps: losses bit for bit {len(same)} of {len(a) - 1}, grad norm "
        f"{gn:.3e} relative (bound 1e-2: K4's atomics) {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the npz- and pt-restored states' steps disagree")
    del restored, stepped, a, b
    torch.cuda.empty_cache()

    source = CoPoNeRF(icfg, image_size=IMAGE).eval()
    source.load_state_dict(src_sd)
    source = source.to(dev)
    request = batch_to_torch(make_batch(batch_size=1, image_size=IMAGE, n_rays=CHUNK, seed=11)[0], dev)

    def chunk(m):
        with torch.no_grad():
            return m.render(request, m.encode(request), val=True)

    got = count("ckpt_render", lambda: chunk(served))
    want = chunk(source)
    check_render(got, CHUNK, icfg.coarse_samples + icfg.fine_samples)
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(multilevel_sample=4, split_dense_relu=4, weighted_sum_smaj=8)
    good = all(torch.equal(got[k], want[k]) for k in ("rgb", "at_wt", "depth_ray"))
    log(f"[checkpoint] a {CHUNK}-ray cf[16, 4] chunk of the npz's weights against the source weights': bit for bit "
        f"{'ok' if good else 'FAIL'}; launches {launches['ckpt_render']} (expected {expected})")
    if not good:
        raise RuntimeError("the npz-loaded model renders otherwise than the source weights")
    if launches["ckpt_render"] != expected:
        raise RuntimeError("a kernel of the npz-loaded render was not launched as expected")
    log(f"[checkpoint] the phase took {time.perf_counter() - t_phase:.1f} s")


def phase_lpips(model, dev, card: str, count, launches) -> None:
    """LPIPS-VGG on random weights (``make_random_weights``) on the card
    against the CPU, 1e-4 relative, its ms/image; then one pair through
    ``evaluate`` in the entry's fast config with the LPIPS column."""
    import warnings

    from coponerf_tpu_torch.eval.harness import evaluate
    from coponerf_tpu_torch.eval.lpips import LPIPSVGG, make_random_weights
    from coponerf_tpu_torch.ops import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = make_random_weights(os.path.join(_build.BUILD_DIR, "lpips_random_seed0.npz"))
    gen = torch.Generator().manual_seed(11)
    a = torch.rand(IMAGE, IMAGE, 3, generator=gen) * 2 - 1
    b = (a + 0.2 * torch.randn(IMAGE, IMAGE, 3, generator=gen)).clamp(-1, 1)
    t0 = time.perf_counter()
    cpu = LPIPSVGG.get(path, "cpu")(a, b)
    cpu_s = time.perf_counter() - t0
    net = LPIPSVGG.get(path, dev)
    ad, bd = a.to(dev), b.to(dev)
    net(ad, bd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        got = net(ad, bd)
    ms = (time.perf_counter() - t0) / 5 * 1e3
    rel = abs(got - cpu) / abs(cpu)
    log(f"[lpips] {IMAGE}^2 pair, random VGG weights: card {got:.7g}, CPU {cpu:.7g}, relative {rel:.2e} (bound 1e-4) "
        f"{'ok' if rel <= 1e-4 else 'FAIL'}; {ms:.2f} ms/image on the card (host clock, the value read back), "
        f"{cpu_s * 1e3:.0f} ms on the CPU [{card}]")
    if not rel <= 1e-4:
        raise RuntimeError("LPIPS on the card and on the CPU disagree")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = count("eval_lpips", lambda: evaluate(model, PairSet((0,)), batch_size=1, chunk=CHUNK, image_size=IMAGE,
                                                 verbose=False, lpips_weights=path)).metrics["all"]
    rps = m["rays_per_sec"][0]
    log(f"[lpips] evaluate with the LPIPS column, pair 0: lpips {m['lpips'][0]:.6g}, psnr {m['psnr'][0]:.6g}, "
        f"{IMAGE * IMAGE / rps * 1e3:.1f} ms/image encode + render [{card}]")
    if not np.isfinite(m["lpips"][0]):
        raise RuntimeError("evaluate gave no finite LPIPS")


def phase_scene_cache(card: str) -> None:
    """The native scene cache built with g++ on this machine: frames
    written, read back bit for bit, and ``processed`` (crop and bilinear
    resize in C++) against the readers' numpy bilinear resize, 1e-5."""
    from coponerf_tpu_torch.data import fast_loader
    from coponerf_tpu_torch.data.scene_dataset import bilinear_resize, square_crop

    t0 = time.perf_counter()
    fast_loader.get_lib()
    build_s = time.perf_counter() - t0
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 255, (4, 256, 455, 3), np.uint8)
    path = os.path.join(fast_loader.BUILD_DIR, f"smoke_{os.getpid()}.cache")
    try:
        fast_loader.write_cache(path, np.arange(4, dtype=np.int64) * 1000, frames)
        cache = fast_loader.SceneCache(path)
        same = all(np.array_equal(cache.frame(i), frames[i]) for i in range(4))
        worst = 0.0
        t0 = time.perf_counter()
        for i in range(4):
            got = cache.processed(i, IMAGE)
            want = bilinear_resize(square_crop(frames[i]).astype(np.float32), (IMAGE, IMAGE)) / 127.5 - 1
            worst = max(worst, float(np.abs(got - want).max()))
        cache.close()
    finally:
        if os.path.exists(path):
            os.remove(path)
    good = same and worst <= 1e-5
    log(f"[cache] libscenecache built or loaded in {build_s:.2f} s ({fast_loader.library_path()}); 4 frames of "
        f"256 x 455 written and read back {'bit for bit' if same else 'DIFFERENT'}; processed({IMAGE}) vs the numpy "
        f"bilinear path max abs {worst:.2e} (bound 1e-5) {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("the native scene cache disagrees with the numpy path")


PER_TRAIN_STEP = dict(bilinear_sample=6, split_dense_relu=2, onehot_transpose_matmul=6)
# a cf[16, 4] chunk: K8a once per sample set and stage, K2 as often, K3 twice as often
PER_CF_CHUNK = dict(multilevel_sample=4, split_dense_relu=4, weighted_sum_smaj=8)
DP_PAIRS = 2            # the global batch of the multi-rank train step


def dp_configs(pose: bool):
    """(phase 6's fast train config, with or without the pose term, and the
    cf[16, 4] inference config)."""
    from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig

    tcfg = Config(model=ModelConfig(fast_sampling=True, compute_dtype="bfloat16"),
                  loss=LossConfig(pose=pose, cycle=True, ssim=True), train=TrainConfig())
    return tcfg, ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4)


def dp_batches():
    """(the global train batch of ``DP_PAIRS`` pairs, the 65536-ray request), numpy."""
    from coponerf_tpu_torch.data.synthetic import make_batch

    train = make_batch(batch_size=DP_PAIRS, image_size=IMAGE, n_rays=TRAIN_RAYS, seed=1)[0]
    request = make_batch(batch_size=1, image_size=IMAGE, n_rays=2 * CHUNK, full_query_image=True, seed=0)[0]
    return train, request


def parallel_rank(rank: int, world: int, n_steps: int, pose: bool):
    """One rank of phase 8 (b)-(d), in its own process on its card: the
    ray-sharded render of the request (one 32768-ray chunk a rank), then
    ``n_steps`` data-parallel train steps on the rank's pair of the global
    batch, from rank 0's seeded weights.  Returns the render's outputs, the
    steps' metrics, times and launch counts (counted here, in the rank)."""
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch
    from coponerf_tpu_torch.parallel.render import render_ray_sharded
    from coponerf_tpu_torch.training import trainer
    from coponerf_tpu_torch.utils.init import init_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    tcfg, icfg = dp_configs(pose)
    model = CoPoNeRF(icfg, image_size=IMAGE)
    if rank == 0:
        init_weights(model, seed=0)
    model = model.to(dev).eval()
    rays = make_mesh((-1,), ("rays",))
    replicate(rays, model)
    train_np, request_np = dp_batches()
    request = batch_to_torch(request_np, dev)
    out = {"render_ms": [], "steps": []}
    for _ in range(2):               # the first warms up
        with torch.no_grad():
            state = model.encode(request)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        image = render_ray_sharded(model, request, state, rays, chunk=CHUNK)
        torch.cuda.synchronize()
        out["render_ms"].append((time.perf_counter() - t0) * 1e3)
        out["render_launches"] = read_launches()
    out["render"] = {k: v.cpu().numpy() for k, v in image.items()}
    del state, image
    tmodel = CoPoNeRF(tcfg.model, image_size=IMAGE)
    tmodel.load_state_dict(model.state_dict())
    del model
    st = trainer.create_train_state(tcfg, IMAGE, dev, model=tmodel)
    data = make_mesh((-1,), ("data",))
    batch = batch_to_torch(shard_batch(data, train_np), dev)
    for _ in range(n_steps):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        m = trainer.train_step(st, batch, tcfg, mesh=data)
        torch.cuda.synchronize()
        out["steps"].append(dict(ms=(time.perf_counter() - t0) * 1e3, launches=read_launches(),
                                 metrics={k: float(v) for k, v in m.items()}))
    return out


def phase_parallel(dev, card: str, launches, pose: bool = False) -> None:
    """8. the port's multi-rank paths on the card (``parallel/``):
    (a) NCCL over one rank in this process: the data-parallel train step
        and the plain one from the same weights on the same batch (fast
        config, batch 6 x 256^2), losses bit for bit, grad norm within 1e-2
        (K4's atomics), steps in turns, and the gradient all-reduce alone;
    (b) two gloo ranks on this card: a data-parallel step on a global batch
        of 2 pairs against this process's step on the same batch, pose
        term off.  The ranks' encoder convolutions run at batch 1 and the
        BatchNorm statistics are means of the ranks' means: f32 sums in
        another order, which flip single bf16 roundings of the UFC, so the
        losses are held at bf16 level, 1e-2 relative (phase 6's fused
        against unfused 1e-4 does not hold: 7.4e-4 on an H100), the grad
        norm at 1e-2 (1.3e-3).  With the pose term the grad norm differed
        by 70 %: the reason phase 7 gives;
    (c) in the same ranks, the ray-sharded render of the 65536-ray cf[16, 4]
        request, one 32768-ray chunk a rank, against this process's chunked
        render, bit for bit;
    (d) with two cards or more, (b) and (c) over NCCL, one card a rank.
    The ranks count their own launches, per step and per render."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.parallel.launch import run_ranks
    from coponerf_tpu_torch.parallel.mesh import average_gradients, init_distributed, make_mesh
    from coponerf_tpu_torch.training import trainer
    from coponerf_tpu_torch.utils.init import init_weights

    tcfg, icfg = dp_configs(pose)
    pcfg, _ = dp_configs(True)          # phase 6's losses
    batch6 = batch_to_torch(make_batch(batch_size=TRAIN_BATCH, image_size=IMAGE, n_rays=TRAIN_RAYS, seed=1)[0], dev)
    weights = init_weights(CoPoNeRF(pcfg.model, image_size=IMAGE), seed=0).state_dict()
    tmp = tempfile.mkdtemp()
    try:
        # (a) NCCL, world 1, in this process
        init_distributed("nccl", 0, 1, f"file://{tmp}/rendezvous", device=dev)
        try:
            mesh = make_mesh()
            states = {}
            for path in ("train_plain_a", "train_dp_nccl1"):
                model = CoPoNeRF(pcfg.model, image_size=IMAGE)
                model.load_state_dict(weights)
                states[path] = trainer.create_train_state(pcfg, IMAGE, dev, model=model)
            times = {p: [] for p in states}
            first = {}
            total = {p: dict.fromkeys(KERNELS, 0) for p in states}
            expected = dict.fromkeys(KERNELS, 0)
            expected.update(PER_TRAIN_STEP)
            n_steps, n_warm = 5, 2
            for i in range(n_steps):
                for path in (tuple(states) if i % 2 == 0 else tuple(states)[::-1]):
                    torch.cuda.synchronize()
                    reset_launches()
                    t0 = time.perf_counter()
                    m = trainer.train_step(states[path], batch6, pcfg, mesh=mesh if path == "train_dp_nccl1" else None)
                    torch.cuda.synchronize()
                    times[path].append(time.perf_counter() - t0)
                    got = read_launches()
                    if got != expected:
                        raise RuntimeError(f"(a) {path} step {i}: launches {got}, expected {expected}")
                    for k in KERNELS:
                        total[path][k] += got[k]
                    first.setdefault(path, {k: float(v) for k, v in m.items()})
            launches.update(total)
            plain, dp = first["train_plain_a"], first["train_dp_nccl1"]
            same = all(plain[k] == dp[k] for k in plain if k != "grad_norm")
            rel = abs(plain["grad_norm"] - dp["grad_norm"]) / plain["grad_norm"]
            med = {p: statistics.median(t[n_warm:]) * 1e3 for p, t in times.items()}
            params = [p for p in states["train_dp_nccl1"].model.parameters()]
            grads = [torch.randn_like(p) for p in params]
            ar_ms = cuda_ms(lambda: average_gradients(mesh, grads), reps=5, inner=3)
            n_bytes = sum(g.numel() * 4 for g in grads)
            del grads, states
            log(f"[parallel] (a) NCCL world 1, fast config, batch {TRAIN_BATCH} x 256^2: first step dp vs plain "
                f"losses {'bit for bit' if same else 'DIFFER'}: " + ", ".join(f"{k} {dp[k]:.9g}/{plain[k]:.9g}"
                                                                              for k in plain)
                + f"; grad_norm rel {rel:.3e} (bound 1e-2) {'ok' if same and rel < 1e-2 else 'FAIL'}")
            log(f"[parallel] (a) steps in turns, median of {n_steps - n_warm}: plain {med['train_plain_a']:.1f} ms, "
                f"data-parallel {med['train_dp_nccl1']:.1f} ms: the collectives cost "
                f"{med['train_dp_nccl1'] - med['train_plain_a']:.1f} ms a step; the flat gradient all-reduce alone "
                f"{ar_ms:.2f} ms for {n_bytes / 2 ** 20:.0f} MiB ({n_bytes / ar_ms / 1e6:.0f} GB/s as a copy) [{card}]")
            log(f"[parallel] (a) kernel launches over {n_steps} steps each: plain {launches['train_plain_a']}, "
                f"data-parallel {launches['train_dp_nccl1']} (per step {expected}, checked at every step)")
            if not (same and rel < 1e-2):
                raise RuntimeError("the one-rank data-parallel step differs from the plain step")
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # this process's references for (b)-(d): the step on the global batch, the chunked render
        train_np, request_np = dp_batches()
        model = CoPoNeRF(tcfg.model, image_size=IMAGE)
        model.load_state_dict(weights)
        st = trainer.create_train_state(tcfg, IMAGE, dev, model=model)
        ref_step = {k: float(v) for k, v in trainer.train_step(st, batch_to_torch(train_np, dev), tcfg).items()}
        del st, model
        imodel = CoPoNeRF(icfg, image_size=IMAGE)
        imodel.load_state_dict(weights)
        imodel = imodel.to(dev).eval()
        request = batch_to_torch(request_np, dev)
        with torch.no_grad():
            state = imodel.encode(request)
            outs = [imodel.render(slice_chunk(request, lo, lo + CHUNK), state, val=True)
                    for lo in range(0, 2 * CHUNK, CHUNK)]
        ray_axis = {"rgb": 2, "depth_ray": 1, "at_wt": 1}
        ref_image = {k: torch.cat([o[k] for o in outs], dim=ax).cpu().numpy() for k, ax in ray_axis.items()}
        del imodel, state, outs, request, batch6, weights
        torch.cuda.empty_cache()

        n_cards = torch.cuda.device_count()
        runs = [("gloo2", "gloo", ["cuda:0", "cuda:0"], "(b)/(c) gloo, two ranks on one card")]
        if n_cards >= 2:
            runs.append(("nccl2", "nccl", ["cuda:0", "cuda:1"], "(d) NCCL, one card a rank"))
        else:
            log(f"[parallel] (d) NCCL with one card a rank: not run, {n_cards} card on this machine")
        for tag, backend, devices, label in runs:
            t0 = time.perf_counter()
            ranks = run_ranks(parallel_rank, 2, backend, f"file://{tmp}/rendezvous_{tag}", args=(2, pose),
                              devices=devices, deadline_s=400.0)
            log(f"[parallel] {label}: both ranks done in {time.perf_counter() - t0:.1f} s (spawn, CUDA, build "
                f"load, seeded init included)")
            per_chunk = dict.fromkeys(KERNELS, 0)
            per_chunk.update(PER_CF_CHUNK)
            per_step = dict.fromkeys(KERNELS, 0)
            per_step.update(PER_TRAIN_STEP)
            for r, out in enumerate(ranks):
                bitwise = all(np.array_equal(out["render"][k], ref_image[k]) for k in ray_axis)
                log(f"[parallel] {label}, rank {r}: ray-sharded render of {2 * CHUNK} rays (one chunk a rank) "
                    f"{out['render_ms'][1]:.1f} ms (first {out['render_ms'][0]:.1f} ms), the whole image on this "
                    f"rank {'bit for bit' if bitwise else 'DIFFERS from'} this process's chunked render [{card}]")
                if not bitwise:
                    raise RuntimeError(f"{label}: rank {r}'s ray-sharded render differs from the single-process one")
                if out["render_launches"] != per_chunk:
                    raise RuntimeError(f"{label}: rank {r} render launches {out['render_launches']}, "
                                       f"expected {per_chunk}")
                launches[f"render_ray_sharded_{tag}_rank{r}"] = out["render_launches"]
                total = dict.fromkeys(KERNELS, 0)
                for i, s in enumerate(out["steps"]):
                    if s["launches"] != per_step:
                        raise RuntimeError(f"{label}: rank {r} step {i} launches {s['launches']}, expected {per_step}")
                    for k in KERNELS:
                        total[k] += s["launches"][k]
                launches[f"train_dp_{tag}_rank{r}"] = total
                got = out["steps"][0]["metrics"]
                rel = {k: abs(got[k] - v) / (abs(v) + 1e-12) for k, v in ref_step.items()}
                worst = max(v for k, v in rel.items() if k != "grad_norm")
                good = worst < 1e-2 and rel["grad_norm"] < 1e-2
                log(f"[parallel] {label}, rank {r}: first step on its pair of the global batch of {DP_PAIRS} vs "
                    f"this process's step on the whole: " + ", ".join(f"{k} {got[k]:.6g}/{ref_step[k]:.6g}"
                                                                       for k in ref_step)
                    + f"; losses max rel {worst:.3e} (bound 1e-2), grad_norm rel {rel['grad_norm']:.3e} (bound "
                      f"1e-2) {'ok' if good else 'FAIL'}; steps " + ", ".join(f"{s['ms']:.1f}" for s in out["steps"])
                    + f" ms [{card}]")
                if not good:
                    raise RuntimeError(f"{label}: rank {r}'s data-parallel step differs from the single-process step")
                if out["steps"][-1]["metrics"] != ranks[0]["steps"][-1]["metrics"]:
                    raise RuntimeError(f"{label}: the ranks' metrics differ")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def flat_params(state) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])


def phase_formulations(dev, card: str, launches, n_steps: int = 3) -> None:
    """9. the train step's formulations at full width, phase 6's fast
    config (pose + cycle + SSIM, batch 6 x 256^2, 192 rays x 64 samples),
    each pair of states built from the same seeded weights and taking its
    steps on the same batch in turns:
    (a) the last UFC layer (stage 2: 64^2 tokens, the 16^2 x 16^2 volume,
        bf16) on the inputs it gets in an encode of the batch, with
        ``refine_last_corr`` True and False in turns, forward alone and
        forward + backward of a loss of its features: the features bit
        for bit; ms, device launches and peak memory of each;
    (b) ``conv4d_impl`` "2d" and "3d": first-step losses at 2e-2 relative
        (bf16 sums in another order), the pose term's aside (see
        ``first_steps``); then one step of each with the pose term off,
        every loss, the grad norm, the Conv4d weights' gradients and the
        whole gradient as Adam is handed them at 2e-2 (the Conv4d
        weights' at 5e-2), beside the 2d step on context images scaled by
        (1 + 2^-8); and, pose term on, the 2d and 3d first steps on the
        batch and on its context images scaled by (1 +- 2^-8):
        grad norm, pose loss and the pairs' rotation angles, printed;
    (c) ``remat_policy`` "full" and "dots": the same first-step bound, and
        whether the first steps are bit for bit;
    (d) the per-leaf and the flat optimizer, three steps each, the
        per-leaf state first: the flat state's own gradient as Adam is
        handed it at 2e-2 of the per-leaf one's (K4's atomics), then
        replaced by it, so that both Adams take the same gradients and
        the flat state's update after three steps equals the per-leaf
        one's at 1e-5 relative; the first steps' losses bit for bit;
    (e) the flat and the per-leaf step under a one-rank NCCL mesh (the
        flat gradient vector all-reduced in place): first-step losses bit
        for bit, grad norm 1e-2 (K4's atomics).
    Each configuration: median step ms, device busy share and launches of
    one more step under torch.profiler, and peak memory (its step's peak
    less the other states' resident tensors).  Every step launches phase
    6's kernels (K1 6, K2 2, K4 6), checked at every step."""
    import tempfile

    import torch.distributed as dist

    from coponerf_tpu_torch.bench_kernels import profile_summary, resident_bytes
    from coponerf_tpu_torch.data.synthetic import make_batch
    from coponerf_tpu_torch.geometry import geodesic_rotation_distance
    from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
    from coponerf_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from coponerf_tpu_torch.training import trainer
    from coponerf_tpu_torch.utils.init import init_weights

    t_phase = time.perf_counter()
    base, _ = dp_configs(True)
    weights = init_weights(CoPoNeRF(base.model, image_size=IMAGE), seed=0).state_dict()
    batch = batch_to_torch(make_batch(batch_size=TRAIN_BATCH, image_size=IMAGE, n_rays=TRAIN_RAYS, seed=1)[0], dev)
    per_step = dict.fromkeys(KERNELS, 0)
    per_step.update(PER_TRAIN_STEP)
    log(f"[formulations] weights and batch ready in {time.perf_counter() - t_phase:.1f} s")

    # (a) the last UFC layer with and without its second refinement, on the
    # inputs it gets in an encode of the batch
    with torch.device(dev):
        model = CoPoNeRF(base.model, image_size=IMAGE).eval()
    model.load_state_dict(weights)
    last = len(base.model.ufc_layer_nums) - 1
    layer = getattr(model.feature_cost_aggregation, f"layers_{last}_{base.model.ufc_layer_nums[last] - 1}")
    seen = {}
    hook = layer.register_forward_pre_hook(lambda mod, args: seen.update(args=args[:2]))
    with torch.no_grad():
        model.encode(batch)
    hook.remove()
    corr, feat2 = (a.detach() for a in seen["args"])
    del seen

    def fwd(refine):
        with torch.no_grad():
            return layer(corr, feat2, refine)[1]

    def fwd_bwd(refine):
        x = feat2.detach().requires_grad_(True)
        out = layer(corr, x, refine)[1]
        out.float().square().mean().backward()
        layer.zero_grad(set_to_none=True)
        return out.detach()

    outs = [fn(r) for fn in (fwd, fwd_bwd) for r in (True, False)]
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    same = finite and torch.equal(outs[0], outs[1]) and torch.equal(outs[2], outs[3])
    log(f"[formulations] (a) inputs from an encode of the batch: corr {tuple(corr.shape)} {corr.dtype}, features "
        f"{tuple(feat2.shape)}; outputs finite {finite}")
    res = {}
    for what, fn in (("forward", fwd), ("forward+backward", fwd_bwd)):
        ms = dict(zip((True, False), cuda_ms_in_turns([lambda: fn(True), lambda: fn(False)], reps=5, inner=3)))
        for refine in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            fn(refine)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base_mem
            prof = profile_summary(lambda: fn(refine))
            res[(what, refine)] = (ms[refine], prof["launches"], peak)
        (t1, n1, m1), (t0, n0, m0) = res[(what, True)], res[(what, False)]
        log(f"[formulations] (a) last UFC layer {what}, batch {TRAIN_BATCH}: refine_last_corr True {t1:.3f} ms, "
            f"{n1} launches, peak {m1 / 2 ** 30:.2f} GiB; False {t0:.3f} ms, {n0} launches, peak "
            f"{m0 / 2 ** 30:.2f} GiB; saves {t1 - t0:.3f} ms a call [{card}]")
    log(f"[formulations] (a) the layer's features with and without the refinement: "
        f"{'bit for bit ok' if same else 'DIFFER: FAIL'}")
    if not same:
        raise RuntimeError("the last UFC layer's features depend on its dead refinement")
    del model, layer, corr, feat2, outs
    torch.cuda.empty_cache()

    def make_state(cfg):
        with torch.device(dev):         # no fill on the host: the weights come next
            model = CoPoNeRF(cfg.model, image_size=IMAGE)
        model.load_state_dict(weights)
        return trainer.create_train_state(cfg, IMAGE, dev, model=model)

    def states(cfgs: dict) -> dict:
        """{label: dict(cfg, state, times, metrics, peak)}, a fresh state of
        each configuration of ``cfgs`` from the same weights."""
        return {k: dict(cfg=c, state=make_state(c), times=[], metrics=[], peak=0) for k, c in cfgs.items()}

    def run(tag: str, runs: dict, steps: int, mesh=None, turns: bool = True) -> dict:
        """``steps`` steps of each state of ``runs``, in turns (or always in
        the order of ``runs``); returns ``runs``."""
        total = {k: dict.fromkeys(KERNELS, 0) for k in runs}
        for i in range(steps):
            for label in (list(runs)[::-1] if turns and i % 2 else list(runs)):
                r = runs[label]
                others = sum(resident_bytes(o["state"]) for k, o in runs.items() if k != label)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                t0 = time.perf_counter()
                mt = trainer.train_step(r["state"], batch, r["cfg"], mesh=mesh)
                torch.cuda.synchronize()
                r["times"].append((time.perf_counter() - t0) * 1e3)
                got = read_launches()
                if got != per_step:
                    raise RuntimeError(f"({tag}) {label} step {i}: launches {got}, expected {per_step}")
                for k in KERNELS:
                    total[label][k] += got[k]
                r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated() - others)
                r["metrics"].append({k: float(v) for k, v in mt.items()})
        for label in runs:
            launches[f"formulations_{tag}_{label}"] = total[label]
        return runs

    def one_step(tag: str, cfg, batch_, record: bool = True) -> tuple:
        """One step of a fresh state of ``cfg`` on ``batch_``: its metrics,
        the gradient its Adam is handed (after the clip), {name: tensor},
        and the geodesic angles between the estimated and the true
        relative rotations of its pairs (radians).  Its launches are kept
        under path ``formulations_<tag>`` where ``record``."""
        st = make_state(cfg)
        seen, angles = {}, []
        hooks = [st.optimizer.register_step_pre_hook(lambda opt, args, kwargs: seen.update(
                     (k, p.grad.detach().clone()) for k, p in st.model.named_parameters())),
                 st.model.register_forward_hook(lambda mod, args, out: angles.extend(geodesic_rotation_distance(
                     out["rel_pose"][:, :3, :3].detach(), out["gt_rel_pose"][:, :3, :3]).tolist()))]
        reset_launches()
        try:
            mt = trainer.train_step(st, batch_, cfg)
        finally:
            for h in hooks:
                h.remove()
        got = read_launches()
        if record:
            launches[f"formulations_{tag}"] = got
        if got != per_step:
            raise RuntimeError(f"({tag}): launches {got}, expected {per_step}")
        if not seen:
            raise RuntimeError(f"({tag}): the step applied no update")
        return {k: float(v) for k, v in mt.items()}, seen, angles

    def rel_norm(a: dict, b: dict, keys) -> float:
        """|a - b| / |b| over the tensors ``keys`` of two {name: tensor}."""
        num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in keys)
        return (num / sum(float(b[k].double().square().sum()) for k in keys)) ** 0.5

    def report(tag: str, runs, mesh=None) -> None:
        for label, r in runs.items():
            prof = profile_summary(lambda: trainer.train_step(r["state"], batch, r["cfg"], mesh=mesh))
            med = statistics.median(r["times"][1:])         # the first step warms up
            log(f"[formulations] ({tag}) {label}: step {med:.1f} ms (median after the first; steps "
                + ", ".join(f"{t:.1f}" for t in r["times"]) + f"), one more under the profiler: wall "
                f"{prof['wall_ms']:.1f} ms, kernel {prof['kernel_ms']:.1f} ms, busy {prof['busy']:.2f}, "
                f"{prof['launches']} launches; peak {r['peak'] / 2 ** 30:.2f} GiB [{card}]")
            log(f"[formulations] ({tag}) {label} top kernels: " + "; ".join(
                f"{k} {ms:.2f} ms x{n}" for k, ms, n in prof["top"]))

    def first_steps(tag: str, runs, a: str, b: str, bound: float, exact: bool = False) -> None:
        """The first steps' metrics: with ``exact`` (the same forward) the
        losses bit for bit and the grad norm at ``bound`` (K4's atomics);
        otherwise every loss but the pose term's, and the total less it,
        at ``bound``: at random weights the pose head turns bf16-level
        differences of its input tokens into pose losses and gradients
        that differ by far more (phase 7's reason; (b)'s nudged step shows
        it), so the pose loss and the grad norm, which it dominates, are
        printed here and held with the pose term off in (b)."""
        ma, mb = (dict(m, total_less_pose=m["total_train_loss"] - m["pose_loss"])
                  for m in (runs[a]["metrics"][0], runs[b]["metrics"][0]))
        rel = {k: abs(mb[k] - v) / (abs(v) + 1e-12) for k, v in ma.items()}
        bitwise = all(ma[k] == mb[k] for k in ma if k != "grad_norm")
        if exact:
            held = ["grad_norm"]
            good = bitwise and rel["grad_norm"] <= bound
        else:
            held = [k for k in ma if k not in ("pose_loss", "total_train_loss", "grad_norm")]
            good = max(rel[k] for k in held) <= bound
        good = good and all(np.isfinite(list(mb.values())))
        log(f"[formulations] ({tag}) first step, {b} vs {a}: " + ", ".join(f"{k} {mb[k]:.7g}/{ma[k]:.7g}"
                                                                          for k in ma)
            + f"; max rel of {', '.join(held)}: {max(rel[k] for k in held):.3e} (bound {bound:g}), losses bit "
              f"for bit: {bitwise} " + ("ok" if good else "FAIL"))
        if not good:
            raise RuntimeError(f"({tag}) the {b} and {a} steps disagree")

    def with_model(cfg=base, **kw):
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **kw))

    def with_train(**kw):
        return dataclasses.replace(base, train=dataclasses.replace(base.train, **kw))

    log(f"[formulations] (a) took {time.perf_counter() - t_phase:.1f} s")

    # (b) conv4d_impl, (c) remat_policy
    for tag, a, b, key in (("b", "2d", "3d", "conv4d_impl"), ("c", "full", "dots", "remat_policy")):
        t0 = time.perf_counter()
        runs = run(tag, states({a: with_model(**{key: a}), b: with_model(**{key: b})}), n_steps)
        first_steps(tag, runs, a, b, 2e-2)
        report(tag, runs)
        del runs
        torch.cuda.empty_cache()
        log(f"[formulations] ({tag}) took {time.perf_counter() - t0:.1f} s")

    # (b) with the pose term off: every loss, the grad norm, the Conv4d
    # weights' gradients and the whole gradient, as Adam is handed them, of
    # the 3d step against the 2d one: what cuDNN's bf16 conv3d backward
    # (its wgrad and, through the layers below, its dgrad) gives
    t0 = time.perf_counter()
    off, _ = dp_configs(False)
    (m2, g2, _), (m3, g3, _) = (one_step(f"b_pose_off_{impl}", with_model(off, conv4d_impl=impl), batch)
                                for impl in ("2d", "3d"))
    conv = [k for k in g2 if k.endswith(("query_conv.weight", "supp_conv.weight"))]
    rel = {k: abs(m3[k] - v) / (abs(v) + 1e-12) for k, v in m2.items()}
    g_conv, g_all = rel_norm(g3, g2, conv), rel_norm(g3, g2, list(g2))
    n_params = len(g2)
    del g3

    def nudged(scale: float) -> dict:
        return {**batch, "context": {**batch["context"], "rgb": batch["context"]["rgb"] * scale}}

    # the same 2d step on context images scaled by (1 + 2^-8), half a bf16
    # step: how far a bf16-level change of the inputs moves these numbers
    mn, gn, _ = one_step("b_nudged_pose_off_2d", with_model(off, conv4d_impl="2d"), nudged(1 + 2 ** -8), record=False)
    n_rel = max(abs(mn[k] - v) / (abs(v) + 1e-12) for k, v in m2.items())
    n_conv, n_all = rel_norm(gn, g2, conv), rel_norm(gn, g2, list(g2))
    del gn, g2
    good = (max(rel.values()) <= 2e-2 and g_all <= 2e-2 and g_conv <= 5e-2
            and all(np.isfinite(list(m3.values()))))
    log(f"[formulations] (b) pose term off, first step, 3d vs 2d: " + ", ".join(
        f"{k} {m3[k]:.7g}/{v:.7g}" for k, v in m2.items()) + f"; max rel {max(rel.values()):.3e} (bound 2e-2); "
        f"gradients handed to Adam, |3d - 2d| / |2d|: all {n_params} parameters "
        f"{g_all:.3e} (bound 2e-2), the {len(conv)} Conv4d weights {g_conv:.3e} (bound 5e-2) "
        f"{'ok' if good else 'FAIL'}; the 2d step on the context images x (1 + 2^-8) against the 2d step: "
        f"max rel {n_rel:.3e}, all parameters {n_all:.3e}, Conv4d weights {n_conv:.3e}")
    if not good:
        raise RuntimeError("(b) with the pose term off, the 3d and 2d steps disagree")
    # the pose term on, 2d and 3d, the batch and its context images scaled
    # two ways at bf16 level: the spread of the grad norm and the pose
    # loss, and the pairs' rotation angles, whose arccos gradient (1 / sin
    # of the angle) sets the pose term's gradient
    scales = (("x (1 + 2^-8)", 1 + 2 ** -8), ("x (1 - 2^-8)", 1 - 2 ** -8))
    for impl in ("2d", "3d"):
        rows = [("batch", *one_step(f"b_angles_{impl}", with_model(conv4d_impl=impl), batch, record=False)[::2])]
        rows += [(label, *one_step(f"b_nudged_{impl}", with_model(conv4d_impl=impl), nudged(sc), record=False)[::2])
                 for label, sc in scales]
        log(f"[formulations] (b) pose term on, {impl}, first step: " + "; ".join(
            f"{label}: grad_norm {m['grad_norm']:.6g}, pose_loss {m['pose_loss']:.6g}, angles "
            + " ".join(f"{a:.3e}" for a in ang) for label, m, ang in rows))
    log(f"[formulations] (b) pose term off and the nudged steps took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # (d) the per-leaf and the flat optimizer, three steps from the same
    # weights, the per-leaf state first in each.  Two runs of a step differ
    # on the card (K4's atomics, cuDNN's backward), and Adam's first steps
    # turn any sign of a gradient element into a whole step, so the flat
    # state's own gradient is held to the per-leaf one's and then replaced
    # by it (a step pre-hook): both Adams apply the same gradients, and the
    # flat state's update must equal the per-leaf one's
    t0 = time.perf_counter()
    runs = states({"per_leaf": base, "flat": with_train(flat_optimizer=True)})
    leaf_st, flat_st = runs["per_leaf"]["state"], runs["flat"]["state"]
    handed, own = {}, []

    def keep_leaf_grad(opt, args, kwargs):
        handed["grad"] = torch.cat([p.grad.reshape(-1) for p in leaf_st.model.parameters()])

    def hand_leaf_grad(opt, args, kwargs):
        g = handed.pop("grad", None)
        if g is None:
            raise RuntimeError("(d) the per-leaf step applied no update")
        own.append(float((flat_st.flat.grad - g).norm() / g.norm()))
        flat_st.flat.grad.copy_(g)

    hooks = [leaf_st.optimizer.register_step_pre_hook(keep_leaf_grad),
             flat_st.optimizer.register_step_pre_hook(hand_leaf_grad)]
    try:
        run("d", runs, 3, turns=False)
    finally:
        for h in hooks:
            h.remove()
    names = [k for k, _ in leaf_st.model.named_parameters()]
    p0 = torch.cat([weights[k].reshape(-1) for k in names]).to(dev)
    d_leaf, d_flat = flat_params(leaf_st) - p0, flat_params(flat_st) - p0
    upd = float((d_flat - d_leaf).norm() / d_leaf.norm())
    good = upd <= 1e-5 and len(own) == 3 and max(own) <= 2e-2
    log(f"[formulations] (d) the flat state's own gradient, as Adam is handed it, against the per-leaf one's: "
        f"|d| / |g| " + ", ".join(f"{x:.3e}" for x in own) + " in steps 1-3 (bound 2e-2); after 3 steps on the same "
        f"gradients the updates |u_flat - u_leaf| / |u_leaf| {upd:.3e} (bound 1e-5; they moved the parameters "
        f"{float(d_leaf.norm()):.4g} of |p| {float(p0.norm()):.4g}) {'ok' if good else 'FAIL'}")
    if not good:
        raise RuntimeError("(d) the flat optimizer's gradient or update differs from the per-leaf one's")
    del d_leaf, d_flat, p0
    first_steps("d", runs, "per_leaf", "flat", 1e-2, exact=True)
    report("d", runs)
    del runs, leaf_st, flat_st
    torch.cuda.empty_cache()
    log(f"[formulations] (d) took {time.perf_counter() - t0:.1f} s")

    # (e) the flat and the per-leaf step under a one-rank NCCL mesh
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed("nccl", 0, 1, f"file://{tmp}/rendezvous", device=dev)
        try:
            mesh = make_mesh()
            runs = run("e", states({"per_leaf_nccl1": base, "flat_nccl1": with_train(flat_optimizer=True)}),
                       n_steps, mesh)
            first_steps("e", runs, "per_leaf_nccl1", "flat_nccl1", 1e-2, exact=True)
            report("e", runs, mesh)
            del runs
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    log(f"[formulations] the phase took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from coponerf_tpu_torch.bench_kernels import resident_bytes
        from coponerf_tpu_torch.config import Config, LossConfig, ModelConfig, TrainConfig
        from coponerf_tpu_torch.data.synthetic import make_batch
        from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
        from coponerf_tpu_torch.ops import _build
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
    import importlib.util

    # the optional host libraries whose absence the port's numpy/zlib paths cover
    log("[device] host libraries: " + ", ".join(
        f"{m} {'yes' if importlib.util.find_spec(m) is not None else 'no'}"
        for m in ("cv2", "matplotlib", "PIL", "imageio", "tensorboard")))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s (nvcc {_build.build_seconds or 0:.1f} s; {_build.library_path()})")

    summary = {}
    phase_kernels(dev, summary, card)
    torch.cuda.empty_cache()
    launches = {}

    def count(path: str, fn):
        """Run ``fn`` with every launch count set to 0 and keep the counts."""
        reset_launches()
        result = fn()
        launches[path] = read_launches()
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
    expected.update(multilevel_sample=4 * n_chunks, split_dense_relu=4 * n_chunks, weighted_sum_smaj=8 * n_chunks)
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
    torch.cuda.empty_cache()

    # 4c. the same request through the fused renders: K7 in cf[16, 4]; the
    # single-stage config (S 64) unfused and with K6, in turns
    def render_request(m, se):
        """The request's val render over its chunks: (rgb, at_wt, seconds, peak bytes)."""
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs = []
            for lo in range(0, n_rays, CHUNK):
                out = m.render(slice_chunk(batch, lo, lo + CHUNK), state, val=True)
                check_render(out, CHUNK, se)
                outs.append((out["rgb"], out["at_wt"]))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        return (torch.cat([o[0] for o in outs], dim=2), torch.cat([o[1] for o in outs], dim=1), dt,
                torch.cuda.max_memory_allocated())

    def agree(label, fused, unfused) -> None:
        """A fused render against the unfused render of its config, both on the card."""
        mrel = ((fused[0] - unfused[0]).abs().mean() / (unfused[0].abs().mean() + 1e-6)).item()
        wdiff = (fused[1] - unfused[1]).abs().mean().item()
        good = mrel < 2e-2 and wdiff < 2e-2
        log(f"[infer] {label} vs unfused, both on the card: rgb mean_rel {mrel:.3e}, at_wt mean abs {wdiff:.3e} "
            f"(bound 2e-2 each) {'ok' if good else 'FAIL'}")
        if not good:
            raise RuntimeError(f"the {label} render disagrees with the unfused one")

    def report(path, label, r, per_chunk):
        expected = dict.fromkeys(KERNELS, 0)
        expected.update({k: v * n_chunks for k, v in per_chunk.items()})
        log(f"[infer] {label}: {r[2] * 1e3:.1f} ms/image ({n_rays / r[2]:.0f} rays/s), peak device memory "
            f"{r[3] / 2 ** 30:.2f} GiB [{card}]")
        log(f"[infer] {label} kernel launches: {launches[path]} (expected {expected})")
        if launches[path] != expected:
            raise RuntimeError(f"a kernel of the {label} render was not launched as expected")

    amodel = model.with_fusion("attn_embed")
    ucf = render_request(model, SE)
    count("infer_attn_embed", lambda: render_request(amodel, SE))
    acf = count("infer_attn_embed", lambda: render_request(amodel, SE))
    log(f"[infer] cf[16, 4] unfused, the request once more: {ucf[2] * 1e3:.1f} ms/image, peak device memory "
        f"{ucf[3] / 2 ** 30:.2f} GiB [{card}]")
    report("infer_attn_embed", "cf[16, 4] fusion=attn_embed (second request)", acf,
           dict(multilevel_sample=4, split_dense_relu=4, weighted_sum_smaj=8, round1_logits=2, round2_logits=2))
    agree("cf[16, 4] fusion=attn_embed", acf, ucf)
    del ucf, acf

    scfg = dataclasses.replace(cfg, coarse_samples=0, fine_samples=0)
    smodel = CoPoNeRF(scfg, image_size=IMAGE).eval()
    smodel.load_state_dict(model.state_dict())
    smodel = smodel.to(dev)
    rcmodel = smodel.with_fusion("render_core")
    single = {None: [], "render_core": []}
    for i in range(2):               # the first of each warms up; the second is timed
        for fusion in ((None, "render_core") if i == 0 else ("render_core", None)):
            path = "infer_single" if fusion is None else "infer_render_core"
            m = smodel if fusion is None else rcmodel
            single[fusion].append(count(path, lambda: render_request(m, scfg.npoints)))
    for fusion, r in single.items():
        log(f"[infer] single stage (S {scfg.npoints}) fusion={fusion}: first request {r[0][2] * 1e3:.1f} ms/image "
            f"(warm-up)")
    report("infer_single", f"single stage (S {scfg.npoints}) unfused (second request)", single[None][1],
           dict(multilevel_sample=2, split_dense_relu=2, weighted_sum_smaj=4))
    report("infer_render_core", f"single stage (S {scfg.npoints}) fusion=render_core (second request)",
           single["render_core"][1], dict(multilevel_sample=2, render_core=1))
    agree(f"single stage (S {scfg.npoints}) fusion=render_core", single["render_core"][1], single[None][1])
    del single
    for label, m, se in (("infer cf[16, 4] unfused", model, SE),
                         ("infer cf[16, 4] fusion=attn_embed", amodel, SE),
                         ("infer single stage unfused", smodel, scfg.npoints),
                         ("infer single stage fusion=render_core", rcmodel, scfg.npoints)):
        profile_step(lambda: render_request(m, se), card, label)
    del amodel, rcmodel
    torch.cuda.empty_cache()
    phase_camera_path(model, batch, card, count, launches)
    phase_eval(smodel, dev, card, count, launches)
    phase_lpips(smodel, dev, card, count, launches)
    phase_eval_exact(dev, card, count, launches)
    phase_scene_cache(card)

    # 5. the same chunk on the card and on the CPU (plain versions): unfused
    # and fused in cf[16, 4], and K6 in the single-stage config, each fused
    # render by a model of the same weights built with its fusion
    small = slice_chunk(batch, 20000, 21024)
    cases = (("unfused", model, None), ("fusion=attn_embed", model, "attn_embed"),
             ("single stage fusion=render_core", smodel, "render_core"))
    with torch.no_grad():
        out_gpu = [m.with_fusion(f).render(small, state, val=True) for _, m, f in cases]
        torch.cuda.synchronize()
        model_cpu, smodel_cpu = model.to("cpu"), smodel.to("cpu")
        cpu_small = {k: {kk: vv.cpu() for kk, vv in v.items()} for k, v in small.items()}
        cpu_state = state.to("cpu")
        for (label, m, fusion), og in zip(cases, out_gpu):
            t0 = time.perf_counter()
            oc = m.with_fusion(fusion).render(cpu_small, cpu_state, val=True)
            a, b = og["rgb"].float().cpu(), oc["rgb"].float()
            mrel = ((a - b).abs().mean() / (b.abs().mean() + 1e-6)).item()
            wdiff = (og["at_wt"].cpu() - oc["at_wt"]).abs().mean().item()
            good = mrel < 2e-2 and wdiff < 2e-2
            log(f"[compare] 1024-ray chunk {label}, card vs CPU plain versions: rgb mean_rel {mrel:.3e}, at_wt "
                f"mean abs {wdiff:.3e} (bound 2e-2 each) {'ok' if good else 'FAIL'} (CPU render "
                f"{time.perf_counter() - t0:.1f} s)")
            if not good:
                raise RuntimeError(f"card and CPU renders disagree ({label})")
    del model, model_cpu, smodel, smodel_cpu, state, out_gpu, batch
    torch.cuda.empty_cache()

    # 6. the training path, unfused and with fused_argmax (K5), from the
    # same seeded weights, both states resident, taking steps in turns
    tcfg = Config(model=ModelConfig(fast_sampling=True, compute_dtype="bfloat16"),
                  loss=LossConfig(pose=True, cycle=True, ssim=True), train=TrainConfig())
    m = tcfg.model
    assert m.remat_ufc and m.convmap_direct_grad and m.train_onehot_small
    # the host's generation of a synthetic batch, what the train entry's
    # --dataset synthetic stream costs a step without --synthetic_pool
    batches, gen_s = [], []
    for s in (1, 2, 3):
        t0 = time.perf_counter()
        b = make_batch(batch_size=TRAIN_BATCH, image_size=IMAGE, n_rays=TRAIN_RAYS, seed=s)[0]
        gen_s.append(time.perf_counter() - t0)
        if s < 3:
            batches.append(batch_to_torch(b, dev))
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
    step_ms = statistics.median(runs["train"]["times"][n_warm:]) * 1e3
    log(f"[train] synthetic batch generation on the host (data/synthetic.py make_batch, batch {TRAIN_BATCH}): "
        + ", ".join(f"{t * 1e3:.1f}" for t in gen_s) + f" ms a batch against the step's {step_ms:.1f} ms: "
        f"{min(gen_s) * 1e3 / step_ms:.2f} of a step at the least [{card}]")
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
    phase_validation(runs["train"]["state"], runs["train"]["cfg"], card, count, launches)
    del runs["train_fused"]
    torch.cuda.empty_cache()
    phase_checkpoint(runs["train"]["state"], runs["train"]["cfg"], batches[0], card, count, launches)
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

    # 8. the multi-rank paths
    phase_parallel(dev, card, launches)

    # 9. the train step's formulations
    phase_formulations(dev, card, launches)

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
