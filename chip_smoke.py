"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
result line:
  1. device: requires CUDA, prints the card's name and power limit, turns
     TF32 off;
  2. build: compiles coponerf_tpu_torch/csrc/*.cu (nvcc, sm_90a) into the
     git-ignored build directory and prints the build seconds;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (K1 on all four latent levels in both padding modes,
     K2 at 524288 tokens in bf16 plus one f32 case, K3 at N=32768, S=16,
     V=2), with errors, bounds and CUDA-event times (median of 5);
  4. the main path: full-width model (ResNet-34, UFC (2, 2, 1), latent 832)
     with seeded random weights, two 256^2 requests, each one encode() and
     render(val=True) over two 32768-ray chunks in the fast config
     (bf16, coarse-to-fine cf[16, 4]); checks shapes, finiteness, the joint
     softmax, and that every kernel's launch counter rose as expected;
  5. one 1024-ray chunk rendered on the card and on the CPU (where the plain
     versions run) from the same SceneState and weights, rgb compared at
     the fast-config bound.
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPLACES = {
    "bilinear_sample": "coponerf_tpu/ops/pallas/bilinear_sample.py:177",
    "split_dense_relu": "coponerf_tpu/ops/pallas/split_matmul.py:46",
    "weighted_sum_smaj": "coponerf_tpu/ops/pallas/weighted_sum.py:68",
}
SOURCES = {
    "bilinear_sample": "coponerf_tpu_torch/csrc/bilinear_sample.cu",
    "split_dense_relu": "coponerf_tpu_torch/csrc/split_matmul.cu",
    "weighted_sum_smaj": "coponerf_tpu_torch/csrc/weighted_sum.cu",
}
CHUNK = 32768
IMAGE = 256


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def phase_kernels(dev, summary):
    from coponerf_tpu_torch.ops.bilinear_sample import bilinear_sample, bilinear_sample_plain
    from coponerf_tpu_torch.ops.split_matmul import split_dense_relu, split_dense_relu_plain
    from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_plain, weighted_sum_smaj

    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True

    # K1: every level of stage A (S=16 samples x 32768 rays per view row)
    k1_ms = k1_plain_ms = k1_err = 0.0
    for hw, C in ((16, 256), (32, 256), (64, 256), (IMAGE, 64)):
        table = torch.randn(2, hw, hw, C, device=dev, generator=gen).bfloat16()
        for mode, shift in (("border", 0.0), ("zeros", 0.4)):
            grid = epipolar_grid(CHUNK, 16, shift, gen, dev)
            tab = table
            if mode == "zeros":  # secondary samples read the view-row-swapped table
                tab = table.flip(0).contiguous()
            got = bilinear_sample(tab, grid, mode)
            ref = bilinear_sample_plain(tab, grid, mode)
            mx, mrel, _ = errors(got, ref)
            good = mx <= 2e-2 and mrel < 5e-3
            ok &= good
            ms = cuda_ms(lambda: bilinear_sample(tab, grid, mode))
            pms = cuda_ms(lambda: bilinear_sample_plain(tab, grid, mode), reps=3)
            k1_ms += ms
            k1_plain_ms += pms
            k1_err = max(k1_err, mx)
            log(f"[kernels] K1 bilinear_sample {hw}x{hw}x{C} {mode:6s} P={grid.shape[1]}: max_abs {mx:.3e} "
                f"mean_rel {mrel:.3e} (bound 2e-2 / 5e-3) {'ok' if good else 'FAIL'}; kernel {ms:.3f} ms, plain {pms:.3f} ms")
    summary["bilinear_sample"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms)

    # K2: stage A's W1 (T = 16 x 32768 tokens per view row) in bf16, and f32
    W = torch.randn(835, 832, device=dev, generator=gen) / 835 ** 0.5
    bias = torch.randn(832, device=dev, generator=gen) * 0.1
    fk = torch.randn(832, 128, device=dev, generator=gen) / 832 ** 0.5
    for dtype, T in ((torch.bfloat16, 16 * CHUNK), (torch.float32, 4 * CHUNK)):
        parts = [torch.randn(2, T, w, device=dev, generator=gen).to(dtype) for w in (256, 256, 256, 64)]
        parts.append(torch.tanh(torch.randn(2, T, 3, device=dev, generator=gen)).to(dtype))
        out, k = split_dense_relu(parts, W, bias, fk)
        pout, pk = split_dense_relu_plain(parts, W, bias, fk)
        bound = 1e-2 if dtype == torch.bfloat16 else 1e-4
        e_out, e_k = errors(out, pout), errors(k, pk)
        good = e_out[2] < bound and e_k[2] < bound
        ok &= good
        ms = cuda_ms(lambda: split_dense_relu(parts, W, bias, fk))
        pms = cuda_ms(lambda: split_dense_relu_plain(parts, W, bias, fk), reps=3)
        tflops = 2 * 2 * T * (835 * 832 + 832 * 128) / (ms * 1e-3) / 1e12
        log(f"[kernels] K2 split_dense_relu {str(dtype)[6:]} T={T}: out max_abs {e_out[0]:.3e} rel {e_out[2]:.3e}, "
            f"k max_abs {e_k[0]:.3e} rel {e_k[2]:.3e} (bound max-rel {bound:g}) {'ok' if good else 'FAIL'}; "
            f"kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain {pms:.3f} ms")
        if dtype == torch.bfloat16:
            summary["split_dense_relu"] = dict(max_abs_err=max(e_out[0], e_k[0]), ms=ms, plain_ms=pms)
        del parts, out, k, pout, pk

    # K3: one stage-A weighted sum with the view fold
    S, N = 16, CHUNK
    pre = torch.randn(2, S * N, 832, device=dev, generator=gen).bfloat16()
    w = torch.softmax(torch.randn(2, N, S, device=dev, generator=gen), -1)
    got = weighted_sum_smaj(pre, w, S, vsum=2)
    ref = weighted_sum_plain(pre, w, S, vsum=2)
    mx, mrel, _ = errors(got, ref)
    good = mx < 1e-2
    ok &= good
    ms = cuda_ms(lambda: weighted_sum_smaj(pre, w, S, vsum=2))
    pms = cuda_ms(lambda: weighted_sum_plain(pre, w, S, vsum=2), reps=3)
    gbs = pre.numel() * 2 / (ms * 1e-3) / 1e9
    log(f"[kernels] K3 weighted_sum_smaj N={N} S={S} V=2: max_abs {mx:.3e} mean_rel {mrel:.3e} (bound 1e-2) "
        f"{'ok' if good else 'FAIL'}; kernel {ms:.3f} ms ({gbs:.0f} GB/s of pre), plain {pms:.3f} ms")
    summary["weighted_sum_smaj"] = dict(max_abs_err=mx, ms=ms, plain_ms=pms)
    if not ok:
        raise RuntimeError("a kernel disagrees with its plain version")


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
        from coponerf_tpu_torch.config import ModelConfig
        from coponerf_tpu_torch.data.synthetic import make_batch
        from coponerf_tpu_torch.models import CoPoNeRF, batch_to_torch
        from coponerf_tpu_torch.ops import _build
        from coponerf_tpu_torch.ops.bilinear_sample import bilinear_sample
        from coponerf_tpu_torch.ops.split_matmul import split_dense_relu
        from coponerf_tpu_torch.ops.weighted_sum import weighted_sum_smaj
        from coponerf_tpu_torch.utils.init import init_weights
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

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

    # 4. the main path
    cfg = ModelConfig(fast_sampling=True, compute_dtype="bfloat16", coarse_samples=16, fine_samples=4)
    SE = cfg.coarse_samples + cfg.fine_samples
    t0 = time.perf_counter()
    model = init_weights(CoPoNeRF(cfg, image_size=IMAGE).eval(), seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    model = model.to(dev)
    log(f"[slice] model ready: {n_params / 1e6:.1f} M parameters, seeded init {time.perf_counter() - t0:.1f} s")
    counters = (bilinear_sample, split_dense_relu, weighted_sum_smaj)
    for c in counters:
        c.launches = 0
    n_chunks = 0
    states = {}
    for seed in (0, 1):
        batch_np, _ = make_batch(batch_size=1, image_size=IMAGE, n_rays=2 * CHUNK, full_query_image=True, seed=seed)
        batch = batch_to_torch(batch_np, dev)
        n_rays = batch["query"]["uv"].shape[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = model.encode(batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for lo in range(0, n_rays, CHUNK):
            out = model.render(slice_chunk(batch, lo, lo + CHUNK), state, val=True)
            check_render(out, CHUNK, SE)
            n_chunks += 1
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        states[seed] = (batch, state)
        render_ms = (t2 - t1) * 1e3
        log(f"[slice] request seed={seed}: encode {(t1 - t0) * 1e3:.1f} ms, render {render_ms:.1f} ms/image "
            f"({n_rays / (t2 - t1):.0f} rays/s), {n_rays} rays in {n_rays // CHUNK} chunks of {CHUNK}, "
            f"rel_pose finite {bool(torch.isfinite(state.rel_pose).all())} [{card}]")
    launches = {c.__name__: c.launches for c in counters}
    expected = {"bilinear_sample": 16 * n_chunks, "split_dense_relu": 4 * n_chunks, "weighted_sum_smaj": 8 * n_chunks}
    log(f"[slice] kernel launches in the main path: {launches} (expected {expected})")
    if launches != expected:
        raise RuntimeError("a kernel of the main path was not launched as expected")
    log(f"[slice] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")

    # 5. the same chunk on the card and on the CPU (plain versions)
    batch, state = states[0]
    small = slice_chunk(batch, 20000, 21024)
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

    kernels = [
        {"name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
         "launches": launches[k], **summary[k]}
        for k in ("bilinear_sample", "split_dense_relu", "weighted_sum_smaj")
    ]
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
